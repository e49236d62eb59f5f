"""The port's low-rank kernels module (repro_torch.kernels.lowrank) against
the reference's (repro.kernels.lowrank), on the CPU.

Contract asserted here:
  * ``mat_shape`` and ``rank_for`` equal the reference's over a sweep of
    payload sizes, and ``to_mat``/``from_mat`` round-trip;
  * ``matmul_plain`` (and ``matmul`` on CPU tensors, which runs it) agrees
    with ``matmul_ref`` and ``matmul_pallas(interpret=True)`` within
    ``lowrank.error_bound`` (each is a sum of k f32 products), for the three
    product forms the plr codec issues, at ranks 1, 2, 4, 5, 8, 16, 32
    and 64;
  * ``orthonormalize`` agrees with the reference within 1e-6, zeroing the
    same columns of a rank-deficient input;
  * ``uniform_draw`` is ``jax.random.uniform``'s draw bit for bit, and
    ``init_factor``'s Q0 within 1e-5 of the reference's for ncols 128,
    256, 512 and every rank 1-64 (its f64 erfinv differs from JAX's f32
    one by a few ulps; measured at most 9.9e-7);
  * the at_b slab split depends on the row count alone and covers it, and
    ``order_bound``'s at_b depth is the rounding chain of the kernel's sum
    order (counted row by row), at most the 2560 of the order it replaced
    at the training step's 1051352 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank as jlr
from repro_torch.kernels import lowrank as tlr


def test_mat_shape_and_rank_match_reference():
    sizes = [1, 7, 127, 128, 1000, 16383, 16384, 16385, 65536, 100000,
             262144, 262145, 10 ** 6, 538288768]
    for n in sizes:
        assert tlr.mat_shape(n) == jlr.mat_shape(n), n
        for r in (1, 4, 8, 64, 200):
            assert tlr.rank_for(n, r) == jlr.rank_for(n, r), (n, r)


@pytest.mark.parametrize("n", [1, 444, 48000, 65537])
def test_to_mat_round_trip(n):
    x = torch.arange(n, dtype=torch.float32) - n / 2
    mat = tlr.to_mat(x)
    assert tuple(mat.shape) == tlr.mat_shape(n)
    assert torch.equal(tlr.from_mat(mat, n), x)
    assert not mat.reshape(-1)[n:].any()
    np.testing.assert_array_equal(
        mat.numpy(), np.asarray(jlr.to_mat(jnp.asarray(x.numpy()))))


def _forms(rng, r):
    """(a, b) of the three products, as the codec passes them."""
    mat = rng.normal(size=(248, 256)).astype(np.float32)
    q = rng.normal(size=(256, r)).astype(np.float32)
    p = rng.normal(size=(248, r)).astype(np.float32)
    return {"tall": (mat, q), "at_b": (mat.T, p), "small_k": (p, q.T)}


@pytest.mark.parametrize("r", [1, 2, 4, 5, 8, 16, 32, 64])
def test_matmul_plain_matches_reference(r):
    rng = np.random.default_rng(r)
    for kind, (a, b) in _forms(rng, r).items():
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = tlr.matmul(ta, tb).numpy().astype(np.float64)
        assert torch.equal(tlr.matmul(ta, tb), tlr.matmul_plain(ta, tb))
        bound = tlr.error_bound(ta, tb).numpy()
        for want in (jlr.matmul_ref(jnp.asarray(a), jnp.asarray(b)),
                     jlr.matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True)):
            err = np.abs(got - np.asarray(want, np.float64))
            assert (err <= bound).all(), (kind, err.max())


def test_matmul_forms_and_refusals():
    rng = np.random.default_rng(0)
    for kind, (a, b) in _forms(rng, 8).items():
        ta = torch.from_numpy(np.ascontiguousarray(a)) if kind != "at_b" \
            else torch.from_numpy(np.ascontiguousarray(a.T)).T
        tb = torch.from_numpy(np.ascontiguousarray(b))
        assert tlr.form(ta, tb) == kind
    with pytest.raises(ValueError):          # no kernel takes it
        tlr.form(torch.zeros(8, 1024), torch.zeros(1024, 128))
    with pytest.raises(ValueError):
        tlr.matmul(torch.zeros(8, 4), torch.zeros(5, 2))
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        tlr.matmul(torch.zeros(8, 4, device="meta"), torch.zeros(4, 2))
    out = torch.empty(8, 2)
    assert tlr.matmul(torch.ones(8, 4), torch.ones(4, 2), out=out) is out
    assert bool((out == 4).all())


def test_orthonormalize_matches_reference():
    rng = np.random.default_rng(3)
    for shape in ((1000, 8), (248, 64), (512, 1)):
        p = rng.normal(size=shape).astype(np.float32)
        got = tlr.orthonormalize(torch.from_numpy(p)).numpy()
        want = np.asarray(jlr.orthonormalize(jnp.asarray(p)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.T @ got, np.eye(shape[1]), atol=1e-5)
    # rank-deficient: a repeated and a zero column come out zero, as in
    # the reference
    p = rng.normal(size=(500, 6)).astype(np.float32)
    p[:, 3] = 2 * p[:, 1]
    p[:, 5] = 0
    got = tlr.orthonormalize(torch.from_numpy(p)).numpy()
    want = np.asarray(jlr.orthonormalize(jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[:, 3].any() and not got[:, 5].any()
    with pytest.raises(ValueError):
        tlr.orthonormalize(torch.zeros(4, 8))


@pytest.mark.parametrize("shape", [(128, 1), (256, 3), (512, 8), (512, 64)])
def test_uniform_draw_is_jax_bit_for_bit(shape):
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    got = tlr.uniform_draw(shape, lo, 1.0)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape,
                                         jnp.float32, lo, 1.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("ncols", [128, 256, 512])
def test_init_factor_matches_reference(ncols):
    for rank in range(1, 65):
        got = tlr.init_factor(ncols, rank).numpy()
        want = np.asarray(jlr.init_factor(ncols, rank))
        assert got.shape == want.shape == (ncols, rank)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=f"rank {rank}")
    # on any device, the same factor
    assert tuple(tlr.init_factor(ncols, 8, "meta").shape) == (ncols, 8)


def test_at_b_slabs_cover_the_rows():
    for rows in (1, 7, 8, 9, 2047, 2048, 2049, 5001, 1051352, 3 * 10 ** 6):
        slabs, per = tlr.at_b_slabs(rows)
        assert 1 <= slabs <= tlr.AT_B_MAX_SLABS and slabs * per >= rows
        assert (slabs - 1) * per < rows            # no empty slab
        assert per % tlr.AT_B_STAGE_ROWS == 0      # whole pipeline stages
        assert tlr.at_b_slabs(rows) == (slabs, per)
    assert tlr.at_b_slabs(1051352) == (514, 2048)


def _kernel_chain(rows: int, n: int) -> int:
    """Longest rounding chain of the at_b kernel's order, counted row by
    row: row i of slab s goes to group (i // rows per group stage) % groups,
    a group's FMAs run over its rows, group 0 adds the other groups, pass
    2's lane l sums slabs l, l + lanes, ..., and lane 0 adds the others."""
    slabs, per = tlr.at_b_slabs(rows)
    groups = tlr.at_b_groups(n)
    r = np.arange(rows)
    slab, i = r // per, r % per
    group = i // (tlr.AT_B_STAGE_ROWS // groups) % groups
    chain = np.bincount(slab * groups + group).max()
    lane = np.bincount(np.arange(slabs) % tlr.AT_B_LANES).max()
    return int(chain) + groups - 1 + int(lane) + tlr.AT_B_LANES - 1


@pytest.mark.parametrize("n", [2, 8, 64])
@pytest.mark.parametrize("rows", [2049, 5001, 1051352])
def test_at_b_depth_is_the_kernels_order(rows, n):
    """order_bound's at_b depth is the chain the kernel's order gives, and
    at the training step's 1051352 rows no deeper than the 2560 of the
    order it replaced (2046 rows + 514 slabs)."""
    d = tlr.at_b_depth(rows, n)
    assert d == _kernel_chain(rows, n)
    if rows == 1051352:
        assert d <= 2560
        assert d == (1073 if n <= 8 else 2096)        # order_bound's doc
    a = torch.ones(rows, 4).T                          # the at_b form
    b = torch.ones(rows, n)
    assert tlr.form(a, b) == "at_b"
    gamma = d * tlr._U / (1 - d * tlr._U) + 4 * 2.0 ** -53 / (1 - 4 * 2.0 ** -53)
    assert torch.allclose(tlr.order_bound(a, b),
                          torch.full((4, n), gamma * rows, dtype=torch.float64))
