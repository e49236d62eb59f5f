"""The port's bq codec (repro_torch.kernels) against the reference's.

Contract asserted here:
  * the plain PyTorch encode/decode/gather-decode are bit-exact with the
    reference's jitted jnp oracles and its Pallas kernels (interpret mode)
    at rates 4, 8, 16 and 24, including all-zero rows, denormals, values
    near f32 max and mixed-magnitude rows;
  * the block-matrix helpers (padded_rows, to_blocks/from_blocks,
    wire_nbytes) equal the reference's;
  * the fixed-rate error bound holds and equals the reference's;
  * a CPU tensor runs the plain version and launches nothing; a tensor on
    another device raises instead of running on the CPU;
  * the tensor-level ops that the card runs as one fused launch
    (``ops.bq_encode`` from bf16, f16, f32 and int32; ``ops.bq_decode``
    back to the type; ``ops.bq_decode_gathered``, the all-gather's tail)
    equal the reference's ``ops.bq_encode`` / ``ops.bq_decode`` (jnp
    oracles) bit for bit at rates 4, 8, 16 and 24 on ragged n, and the
    gathered decode equals the reference's per-shard decodes joined along
    each axis.

The CUDA kernels themselves are held against the plain versions on the
card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import bq as tbq, ops as tops, ref as tref

BITS = (4, 8, 16, 24)
PLANES = ("q_hi", "q_lo", "scale")


def _rand(shape, dtype=np.float32, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(dtype)


def special_rows() -> np.ndarray:
    """(16, 128) f32 rows that stress the scale and rounding arithmetic.

    Every row's max-abs is zero or large enough that ``scale / qmax`` is
    a normal f32 at every rate; denormals appear only beside such a max,
    where they quantize to 0 either way.  The reference's CPU backend
    flushes denormal operands and results to zero and the port keeps IEEE
    denormals, so rows that make the arithmetic itself denormal are
    :func:`denormal_rows`."""
    rng = np.random.default_rng(7)
    u = lambda: rng.uniform(-1, 1, 128)  # noqa: E731
    rows = [
        np.zeros(128),                                   # all zero -> scale 1
        np.r_[1.0, u()[1:] * 1e-40],                     # denormals, normal max
        u() * 3.4e38,                                    # near f32 max
        np.r_[3.0e38, u()[1:] * 1e-3],                   # one huge, rest tiny
        np.r_[1e-30, u()[1:] * 1e-38],                   # tiny max, denormal rest
        np.full(128, -2.5),                              # constant negative
        np.r_[1.0, np.zeros(126), -0.0],                 # signed zeros
        2.0 ** rng.integers(-20, 20, 128) * np.sign(u()),  # powers of two
        np.arange(-64, 64) / 64.0,                       # even grid
        (np.arange(128) - 63.5) * 0.5,                   # half steps
        u() * 1e20,
        u() * 1e-20,
        np.r_[np.full(64, 7.0), np.full(64, -7.0)],
        u(),
        np.r_[2e-31, u()[1:] * 2e-31],                   # least max whose
        #                                  scale/qmax stays normal at rate 24
        u() * 65504.0,
    ]
    return np.stack(rows).astype(np.float32)


def denormal_rows() -> np.ndarray:
    """(8, 128) rows whose max-abs is a denormal f32."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (8, 128)) * 1e-40
    x[-1] = 1e-45
    return x.astype(np.float32)


def _assert_wire_equal(jw, tw):
    for k in PLANES:
        if jw[k] is None:
            assert tw[k] is None, k
            continue
        np.testing.assert_array_equal(np.asarray(jw[k]), tw[k].numpy(),
                                      err_msg=k)


# --------------------------------------------------------------------------
# plain versions vs the reference, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape,dtype", [((1,), np.float32),
                                         ((129,), np.float32),
                                         ((3, 257), np.float32),
                                         ((5, 4, 33), np.float16),
                                         ((1024,), np.float32)])
def test_encode_decode_match_jnp_oracle(bits, shape, dtype):
    x = _rand(shape, dtype, seed=len(shape) + bits)
    jx2d = jops.to_blocks(jnp.asarray(x))
    tx2d = tops.to_blocks(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jx2d), tx2d.numpy())
    jw = jops.bq_encode_blocks(jx2d, bits, backend="jnp")
    tw = tops.bq_encode_blocks(tx2d, bits)
    _assert_wire_equal(jw, tw)
    jd = jops.bq_decode(jw, bits, shape, backend="jnp")
    td = tops.bq_decode(tw, bits, shape)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
def test_special_rows_match_reference(bits, backend):
    x2d = special_rows()
    jw = jops.bq_encode_blocks(jnp.asarray(x2d), bits, backend=backend)
    tw = tops.bq_encode_blocks(torch.from_numpy(x2d), bits)
    _assert_wire_equal(jw, tw)
    jd = jops.bq_decode_blocks(jw, bits, backend=backend)
    td = tops.bq_decode_blocks(tw, bits)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("bits", BITS)
def test_denormal_max_rows_keep_ieee_denormals(bits):
    """A row whose max-abs is denormal: the reference's XLA CPU backend
    flushes it to zero (scale 1, all mantissas 0), the port keeps IEEE
    denormals (scale = the row max), on the CPU and in the CUDA kernel
    alike.  Pinned so that a change on either side shows."""
    x2d = denormal_rows()
    jw = jops.bq_encode_blocks(jnp.asarray(x2d), bits, backend="jnp")
    tw = tops.bq_encode_blocks(torch.from_numpy(x2d), bits)
    np.testing.assert_array_equal(np.asarray(jw["scale"]), 1.0)
    assert not np.asarray(jops.bq_decode_blocks(jw, bits, backend="jnp")).any()
    np.testing.assert_array_equal(tw["scale"].numpy()[:, 0],
                                  np.abs(x2d).max(-1))
    assert tw["scale"].numpy().max() < np.finfo(np.float32).tiny


@pytest.mark.parametrize("bits", BITS)
def test_gather_decode_matches_pallas(bits):
    rng = np.random.default_rng(1)
    nb, bt, r = 5, 4, 3                          # nb*bt*r % TILE_M != 0
    x = rng.normal(size=(nb * bt * r, tref.BLOCK)).astype(np.float32) * 5
    x[:bt * r] = special_rows()[:bt * r]         # block 0 holds special rows
    jw = jops.bq_encode_blocks(jnp.asarray(x), bits, backend="jnp")
    tw = tops.bq_encode_blocks(torch.from_numpy(x), bits)
    jpool = {k: None if jw[k] is None else jw[k].reshape(nb, bt, r, -1)
             for k in PLANES}
    tpool = {k: None if tw[k] is None else tw[k].reshape(nb, bt, r, -1)
             for k in PLANES}
    idx = rng.integers(0, nb, (2, 3)).astype(np.int32)
    idx[0, 0] = 0
    a = jops.bq_gather_decode(jpool, jnp.asarray(idx), bits,
                              backend="pallas_interpret")
    b = tops.bq_gather_decode(tpool, torch.from_numpy(idx), bits)
    assert tuple(b.shape) == (2, 3, bt, r, tref.BLOCK)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------------
# tensor-level ops (the card's flat encode and decode) vs the reference
# --------------------------------------------------------------------------

FLAT_N = (1, 127, 1023, 1025, 70000)
FLAT_DTYPES = ("bfloat16", "float16", "float32", "int32")


def _flat_pair(n: int, dtype: str, seed: int):
    """The same n values as a jnp array and a torch tensor of ``dtype``:
    f32 normals x 50 with an all-zero, a signed-zero and an f16-max-range
    row, cast by each framework (round to nearest even in both), or
    integers for int32."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-5000, 5000, n).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = (rng.normal(size=n) * 50).astype(np.float32)
    sp = special_rows()[[0, 6, 15]].reshape(-1)
    k = min(n, sp.size)
    x[:k] = sp[:k]
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _bits(a) -> np.ndarray:
    """The raw bits of a decoded array (numpy, ml_dtypes or torch)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.element_size() == 2 else a).numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", FLAT_DTYPES)
@pytest.mark.parametrize("n", FLAT_N)
def test_flat_encode_decode_match_reference(bits, dtype, n):
    jx, tx = _flat_pair(n, dtype, seed=n + bits)
    jw = jops.bq_encode(jx, bits, backend="jnp")
    tw = tops.bq_encode(tx, bits)
    _assert_wire_equal(jw, tw)
    jd = jops.bq_decode(jw, bits, (n,), getattr(jnp, dtype), backend="jnp")
    td = tops.bq_decode(tw, bits, (n,), getattr(torch, dtype))
    assert td.dtype == tx.dtype and tuple(td.shape) == (n,)
    np.testing.assert_array_equal(_bits(jd), _bits(td))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", FLAT_DTYPES[:3])
@pytest.mark.parametrize("axis_dim", [0, 1, 2])
def test_gathered_decode_matches_reference(bits, dtype, axis_dim):
    """Two shards' wires stacked (as the all-gather stacks them) decode to
    the reference's per-shard decodes joined along ``axis_dim``."""
    shape = (2, 8, 64)
    pairs = [_flat_pair(2 * 8 * 64, dtype, seed=s) for s in range(2)]
    jws = [jops.bq_encode(j.reshape(shape), bits, backend="jnp")
           for j, _ in pairs]
    tws = [tops.bq_encode(t.reshape(shape), bits) for _, t in pairs]
    for jw, tw in zip(jws, tws):
        _assert_wire_equal(jw, tw)
    gw = {k: None if tws[0][k] is None else
          torch.stack([w[k] for w in tws]) for k in PLANES}
    td = tops.bq_decode_gathered(gw, bits, shape, getattr(torch, dtype),
                                 axis_dim)
    jd = np.concatenate([np.asarray(jops.bq_decode(
        jw, bits, shape, getattr(jnp, dtype), backend="jnp"))
        for jw in jws], axis=axis_dim)
    assert tuple(td.shape) == jd.shape
    np.testing.assert_array_equal(_bits(jd), _bits(td))
    plain = tops.bq_decode_gathered(gw, bits, shape, getattr(torch, dtype),
                                    axis_dim, backend="torch")
    assert torch.equal(plain, td)


# --------------------------------------------------------------------------
# block-matrix helpers and constants
# --------------------------------------------------------------------------

def test_constants_match_reference():
    assert tref.BLOCK == jref.BLOCK
    assert tref._QMAX == jref._QMAX
    assert tref._INV_QMAX == jref._INV_QMAX


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1023, 1024, 1025, 70000])
def test_padded_rows_matches_reference(n):
    assert tops.padded_rows(n) == jops.padded_rows(n)


@pytest.mark.parametrize("shape", [(1,), (3, 257), (8, 128), (5, 4, 33)])
def test_blocks_roundtrip_and_wire_bytes(shape):
    x = _rand(shape, seed=3)
    t2d = tops.to_blocks(torch.from_numpy(x))
    j2d = jops.to_blocks(jnp.asarray(x))
    assert tuple(t2d.shape) == tuple(j2d.shape)
    np.testing.assert_array_equal(
        tops.from_blocks(t2d, shape).numpy(),
        np.asarray(jops.from_blocks(j2d, shape)))
    for bits in BITS:
        tw = tops.bq_encode_blocks(t2d, bits)
        jw = jops.bq_encode_blocks(j2d, bits, backend="jnp")
        assert tops.wire_nbytes(tw) == jops.wire_nbytes(jw)


@pytest.mark.parametrize("bits", BITS)
def test_error_bound(bits):
    x2d = np.concatenate([_rand((64, 128), seed=bits), special_rows()[:-2]])
    t = torch.from_numpy(x2d)
    hi, lo, scale = tref.bq_encode_ref(t, bits)
    err = (tref.bq_decode_ref(hi, lo, scale, bits) - t).abs().amax(-1)
    bound = tref.max_abs_error_bound(scale, bits)
    assert torch.all(err <= bound)
    np.testing.assert_array_equal(
        bound.numpy(),
        np.asarray(jref.max_abs_error_bound(jnp.asarray(scale.numpy()), bits)))


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def test_cpu_tensors_run_plain_and_launch_nothing():
    tbq.reset_launches()
    x2d = torch.from_numpy(_rand((16, 128)))
    w = tops.bq_encode_blocks(x2d, 8)
    tops.bq_decode_blocks(w, 8)
    pool = {k: None if w[k] is None else w[k].reshape(4, 2, 2, -1)
            for k in PLANES}
    tops.bq_gather_decode(pool, torch.zeros((1, 2), dtype=torch.int32), 8)
    assert set(tbq.LAUNCHES) >= {"bq_encode", "bq_decode",
                                 "bq_gather_decode"}
    assert not any(tbq.LAUNCHES.values())


def test_non_cpu_tensor_never_runs_plain():
    """The dispatch rule: CPU tensors run the plain version, meta tensors
    (a shape-only trace) the plain version's shapes, CUDA tensors the
    kernel; a mix of devices, or an unknown backend, raises."""
    x = torch.empty((8, 128), device="meta")
    hi, lo, scale = tbq.bq_encode(x, 8)
    assert (hi.device.type, hi.shape, hi.dtype, lo, scale.shape) == \
        ("meta", (8, 128), torch.int8, None, (8, 1))
    with pytest.raises(ValueError):
        tbq.bq_decode_add(hi, lo, scale, torch.zeros((8, 128)), 8)
    with pytest.raises(ValueError):
        tops.bq_encode_blocks(x, 8, backend="triton")


def test_flat_ops_on_cpu_run_plain_and_launch_nothing():
    tbq.reset_launches()
    x = torch.from_numpy(_rand((3, 5, 7), seed=4)).to(torch.bfloat16)
    hi, lo, scale = tbq.bq_encode_flat(x, 16)
    want = tbq.encode_plain(tops.to_blocks(x), 16)
    assert lo is None and torch.equal(hi, want[0]) and \
        torch.equal(scale, want[2])
    wire = {"q_hi": torch.stack([hi, hi]), "q_lo": None,
            "scale": torch.stack([scale, scale])}
    got = tbq.bq_decode_flat(wire["q_hi"], None, wire["scale"], 16, 105,
                             torch.bfloat16, shards=2, inner=35)
    assert torch.equal(got.reshape(3, 10, 7), tops.ungather(
        tops.bq_decode_blocks(wire, 16), (3, 5, 7), torch.bfloat16, 1))
    assert not any(tbq.LAUNCHES.values()) and not tbq.LAUNCH_SHAPES
    # meta runs the plain version's shapes; meta beside CPU raises
    assert tbq.bq_encode_flat(torch.empty(8, device="meta"), 8)[0].shape \
        == (8, 128)
    with pytest.raises(ValueError):
        tbq.bq_decode_flat(hi, None, scale.to("meta"), 16, 105)
    with pytest.raises(ValueError):          # inner must divide n
        tbq.bq_decode_flat(hi, None, scale, 16, 105, inner=10)
