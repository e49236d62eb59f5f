"""The port's fused ring hops (repro_torch.kernels) against the reference's.

Pallas #3 ``bq_decode_add_encode`` (with the sum and wire-only) and #4
``bq_decode_add`` compute ``local + decode(wire)`` (and re-encode it).  The
port rounds the decode's multiply before the add, the contract its CUDA
kernels keep bit for bit (``__fmul_rn`` then ``__fadd_rn``).  XLA:CPU
fuses the reference's multiplies and add into fused multiply-adds, in its
jnp oracle and its Pallas kernel in interpret mode alike.  So:

  * against the reference's own decode and encode with the multiply
    rounded before the add (an opaque integer no-op between them keeps
    XLA from contracting), the plain versions are bit-exact at every rate,
    in every form;
  * against the reference as it runs (jnp and pallas_interpret, equal to
    each other bit for bit), the sums differ by at most the rounding of
    the decoded product (one ulp of it, plus one of the sum), on a
    minority of values, and the wires agree on every row whose sum agrees;
  * rows whose sum has a denormal max-abs keep IEEE denormals in the port
    and flush to zero in the reference (pinned, as in
    ``test_torch_kernels_bq.py``);
  * a CPU tensor runs the plain version and launches nothing;
  * the TP reduce-scatter's shard-view forms (``bq.view_rows`` and the
    view encode, wire-only hop and fused decode-add on it) equal
    ``comms._split_for_scatter``'s rows, the block forms on them and
    ``from_blocks`` bit for bit: every chunk of bf16, f16 and f32
    payloads split 2, 3 and 4 ways along each axis, with runs of the
    chunk that are not a multiple of 8 values, chunks whose last tile is
    padded, and the row ranges of ``comms._ring_schedule``.

The CUDA kernels are held against the plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import bq as tbq, ops as tops

BITS = (4, 8, 16, 24)
PLANES = ("q_hi", "q_lo", "scale")


def _rows(m: int, seed: int, scale: float) -> np.ndarray:
    """(m, 128) f32: random rows, with rows that stress the scale and
    rounding arithmetic first (all zero, extremes, mixed magnitudes).  No
    value is denormal: the reference's CPU backend flushes denormals (see
    :func:`test_denormal_sum_rows_keep_ieee_denormals`)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, 128)) * scale
    u = lambda: rng.uniform(-1, 1, 128)  # noqa: E731
    special = [np.zeros(128), u() * 1e30, np.r_[1e30, u()[1:] * 1e-3],
               np.r_[1.0, u()[1:] * 1e-30], np.full(128, -2.5),
               np.r_[1.0, np.zeros(126), -0.0], u() * 1e-20,
               2.0 ** rng.integers(-20, 20, 128) * np.sign(u())]
    x[:len(special)] = special
    return x.astype(np.float32)


def _case(bits: int, m: int = 64, seed: int = 0):
    """(reference wire, port wire, local) for one hop."""
    x, local = _rows(m, seed, 10.0), _rows(m, seed + 1, 3.0)
    local[:2] = local[2:4][::-1]          # the big rows land on small ones
    jw = jops.bq_encode_blocks(jnp.asarray(x), bits, backend="jnp")
    tw = {k: None if v is None else torch.from_numpy(np.array(v))
          for k, v in jw.items()}
    return jw, tw, local


def _assert_wire_equal(jw, tw, rows=None):
    for k in PLANES:
        if jw[k] is None:
            assert tw[k] is None, k
            continue
        a, b = np.asarray(jw[k]), tw[k].numpy()
        if rows is not None:
            a, b = a[rows], b[rows]
        np.testing.assert_array_equal(a, b, err_msg=k)


def _sep_add(a, b):
    """``a + b`` with ``a`` rounded first: an integer no-op (zero unless
    ``b`` is NaN) that XLA cannot see through stands between the multiply
    that made ``a`` and the add."""
    m = (b != b).astype(jnp.uint32)
    a = lax.bitcast_convert_type(lax.bitcast_convert_type(a, jnp.uint32) ^ m,
                                 jnp.float32)
    return a + b


def _dae_sep(q_hi, q_lo, scale, local, *, bits):
    s = _sep_add(jref.bq_decode_ref(q_hi, q_lo, scale, bits),
                 local.astype(jnp.float32))
    return jref.bq_encode_ref(s, bits) + (s,)


@pytest.fixture
def separate_rounding(monkeypatch):
    """The reference's jnp fused-hop oracles with the multiply rounded
    before the add."""
    st = ("bits",)
    monkeypatch.setattr(jops, "_dae_ref", jax.jit(_dae_sep,
                                                  static_argnames=st))
    monkeypatch.setattr(jops, "_daew_ref", jax.jit(
        lambda *a, bits: _dae_sep(*a, bits=bits)[:3], static_argnames=st))
    monkeypatch.setattr(jops, "_da_ref", jax.jit(
        lambda q_hi, q_lo, scale, local, *, bits: _sep_add(
            jref.bq_decode_ref(q_hi, q_lo, scale, bits),
            local.astype(jnp.float32)), static_argnames=st))


# --------------------------------------------------------------------------
# bit for bit against the reference's arithmetic, rounded separately
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m", [8, 64])
def test_fused_hops_bit_exact_with_separate_rounding(bits, m,
                                                     separate_rounding):
    jw, tw, local = _case(bits, m, seed=bits + m)
    jl, tl = jnp.asarray(local), torch.from_numpy(local)
    jw2, js = jops.bq_decode_add_encode_blocks(jw, jl, bits, backend="jnp")
    tw2, ts = tops.bq_decode_add_encode_blocks(tw, tl, bits)
    _assert_wire_equal(jw2, tw2)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jww, jn = jops.bq_decode_add_encode_blocks(jw, jl, bits, backend="jnp",
                                               want_sum=False)
    tww, tn = tops.bq_decode_add_encode_blocks(tw, tl, bits, want_sum=False)
    assert jn is None and tn is None
    _assert_wire_equal(jww, tww)
    np.testing.assert_array_equal(
        np.asarray(jops.bq_decode_add_blocks(jw, jl, bits, backend="jnp")),
        tops.bq_decode_add_blocks(tw, tl, bits).numpy())


# --------------------------------------------------------------------------
# against the reference as it runs: XLA's fused multiply-add, pinned
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
def test_reference_contracts_to_fma(bits, backend):
    jw, tw, local = _case(bits, 64, seed=3 * bits)
    jl, tl = jnp.asarray(local), torch.from_numpy(local)
    jw2, js = jops.bq_decode_add_encode_blocks(jw, jl, bits, backend=backend)
    jda = jops.bq_decode_add_blocks(jw, jl, bits, backend=backend)
    tw2, ts = tops.bq_decode_add_encode_blocks(tw, tl, bits)
    js, ts = np.asarray(js), ts.numpy()
    np.testing.assert_array_equal(np.asarray(jda), js)
    # the port's sum is the multiply rounded, then the add
    dec = tops.bq_decode_blocks(tw, bits).numpy()
    np.testing.assert_array_equal(ts, dec + local)
    # they differ by the rounding of the product alone: at most one ulp of
    # the decoded value plus one of the sum, on a minority of values
    diff = np.abs(js.astype(np.float64) - ts.astype(np.float64))
    assert np.all(diff <= np.spacing(np.abs(dec)) + np.spacing(np.abs(ts)))
    assert (diff > 0).mean() < 0.5
    same = (js == ts).all(axis=1)
    assert same.any()
    _assert_wire_equal(jw2, tw2, rows=same)
    if backend == "pallas_interpret":      # both reference paths contract
        jw3, js3 = jops.bq_decode_add_encode_blocks(jw, jl, bits,
                                                    backend="jnp")
        np.testing.assert_array_equal(np.asarray(js3), js)
        _assert_wire_equal(jw3, {k: None if v is None else
                                 torch.from_numpy(np.array(v))
                                 for k, v in jw2.items()})


@pytest.mark.parametrize("bits", BITS)
def test_denormal_sum_rows_keep_ieee_denormals(bits, separate_rounding):
    """A wire that decodes to zero plus a local row whose max-abs is
    denormal: the reference flushes the sum's row to scale 1 and zero
    mantissas, the port keeps the denormal scale (as its CUDA kernel
    does).  Pinned so that a change on either side shows."""
    rng = np.random.default_rng(bits)
    local = (rng.uniform(-1, 1, (8, 128)) * 1e-40).astype(np.float32)
    zero = np.zeros((8, 128), np.float32)
    jw = jops.bq_encode_blocks(jnp.asarray(zero), bits, backend="jnp")
    tw = tops.bq_encode_blocks(torch.from_numpy(zero), bits)
    jw2, _ = jops.bq_decode_add_encode_blocks(jw, jnp.asarray(local), bits,
                                              backend="jnp")
    tw2, ts = tops.bq_decode_add_encode_blocks(tw, torch.from_numpy(local),
                                               bits)
    np.testing.assert_array_equal(np.asarray(jw2["scale"]), 1.0)
    np.testing.assert_array_equal(ts.numpy(), local)
    np.testing.assert_array_equal(tw2["scale"].numpy()[:, 0],
                                  np.abs(local).max(-1))


# --------------------------------------------------------------------------
# the forms agree with each other; dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_forms_agree(bits):
    _, tw, local = _case(bits, 16, seed=bits)
    tl = torch.from_numpy(local)
    w_sum, s = tops.bq_decode_add_encode_blocks(tw, tl, bits)
    w_only, none = tops.bq_decode_add_encode_blocks(tw, tl, bits,
                                                    want_sum=False)
    assert none is None
    for k in PLANES:
        assert (w_sum[k] is None) == (w_only[k] is None)
        if w_sum[k] is not None:
            assert torch.equal(w_sum[k], w_only[k])
    assert torch.equal(tops.bq_decode_add_blocks(tw, tl, bits), s)
    # the re-encode is the plain encode of the sum
    we = tops.bq_encode_blocks(s, bits)
    for k in PLANES:
        if we[k] is not None:
            assert torch.equal(we[k], w_sum[k])


def test_cpu_tensors_launch_nothing():
    _, tw, local = _case(8, 8)
    tbq.reset_launches()
    tl = torch.from_numpy(local)
    tops.bq_decode_add_encode_blocks(tw, tl, 8)
    tops.bq_decode_add_encode_blocks(tw, tl, 8, want_sum=False)
    tops.bq_decode_add_blocks(tw, tl, 8)
    assert not any(tbq.LAUNCHES.values())
    assert {"bq_decode_add_encode", "bq_decode_add_encode_wire",
            "bq_decode_add"} <= set(tbq.LAUNCHES)


# --------------------------------------------------------------------------
# the reduce-scatter's shard-view forms (plain versions)
# --------------------------------------------------------------------------

# chunk shapes (the split axis multiplied by the shard count): runs of 35
# and 7 values, a chunk of 1260 values (last tile padded), and one of
# 4096 values (32 rows: four ring parts)
VIEW_CHUNKS = ((4, 5, 7), (2, 32, 64))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_view_forms_equal_split_blocks(n, dtype):
    from repro_torch.core import comms as tcomms
    bits = 16
    rng = np.random.default_rng(n)
    for chunk in VIEW_CHUNKS:
        for ax in range(3):
            shape = list(chunk)
            shape[ax] *= n
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                 * 5).to(getattr(torch, dtype))
            xb, cs = tcomms._split_for_scatter(x, ax, n)
            m = xb.shape[1]
            parts = {(lo, hi) for lo, hi, _ in
                     tcomms._ring_schedule(m, True, 2).parts}
            wire = tops.bq_encode_blocks(xb[1 % n] * 0.5, bits)
            for k in range(n):
                outs = {}                    # whole chunk, and by ring part
                for lo, hi in sorted(parts | {(0, m)}):
                    view = tbq.shard_view(x, ax, n, k, lo, hi)
                    assert torch.equal(tbq.view_rows(view), xb[k][lo:hi])
                    _assert_wire_equal(
                        {p: None if v is None else v.numpy() for p, v in
                         tops.bq_encode_blocks(xb[k][lo:hi], bits).items()},
                        tops.bq_encode_view(view, bits))
                    part = {p: None if v is None else v[lo:hi]
                            for p, v in wire.items()}
                    want, _ = tops.bq_decode_add_encode_blocks(
                        part, xb[k][lo:hi], bits, want_sum=False)
                    _assert_wire_equal(
                        {p: None if v is None else v.numpy()
                         for p, v in want.items()},
                        tops.bq_decode_add_encode_view(part, view, bits))
                    for key in ("whole", "parts"):
                        if (lo, hi) in {"whole": {(0, m)},
                                        "parts": parts}[key]:
                            out = outs.setdefault(
                                key, torch.full(cs, 7.0, dtype=x.dtype))
                            tops.bq_decode_add_view(part, view, bits, out)
                # each wrote every value of the chunk
                want = tops.from_blocks(tops.bq_decode_add_blocks(
                    wire, xb[k], bits), cs, x.dtype)
                assert set(outs) == {"whole", "parts"}
                for key, out in outs.items():
                    assert torch.equal(out, want), (chunk, ax, k, key)


def test_shard_view_rejects_bad_layouts():
    x = torch.zeros(2, 6, 5)
    with pytest.raises(ValueError):
        tbq.shard_view(x, 1, 4, 0)           # 6 rows in 4 chunks
    with pytest.raises(ValueError):
        tbq.shard_view(x, 1, 3, 3)           # no chunk 3 of 3
    with pytest.raises(ValueError):
        tbq.shard_view(x, 1, 3, 0, 4, 16)    # rows past the chunk's 8
    v = tbq.shard_view(x.to(torch.int32), 2, 5, 4)
    assert v.x.dtype == torch.float32 and (v.n, v.inner, v.rows) == (12, 1, 8)
