"""The port's CUDA kernels on the card (marker ``cuda``; skips without a
GPU).  Imports neither ``jax`` nor ``repro``, so it also runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Contract asserted here: each bq kernel (encode, decode, gather-decode, the
fused ring hop with the sum and wire-only, decode-add) equals its plain
PyTorch version bit for bit at rates 4/8/16/24 on random, all-zero,
extreme-magnitude and denormal rows; a block id outside the pool decodes to NaN without
disturbing the other rows; each wrapper counts exactly its own launches;
tensors of the wrong dtype, shape or device raise.  The flat encode and
decode (``bq_encode_flat`` from bf16, f16, f32 and int32;
``bq_decode_flat`` to the three float types, of one shard and of 2 or 3
shards joined along every axis) equal their plain versions bit for bit
(NaN by position) at n from 0 to the TP activation's 1179648 values, one
launch each; misaligned and strided inputs are encoded by the kernel.

The TP reduce-scatter's view forms (``bq_encode_view``,
``bq_decode_add_encode_view`` wire-only, ``bq_decode_add_flat`` writing the
payload's type) equal their plain versions (the block forms on
``bq.view_rows``, which equal ``comms._split_for_scatter``'s rows) bit for
bit, NaN by position, for chunk k = 0..n-1 of payloads split n = 2, 3 and
4 ways along each of three axes (runs of the chunk that are and are not a
multiple of 8 values; misaligned payloads), on whole chunks and on the
row ranges of ``comms._ring_schedule``, one launch each.  The fused KV
read (``bq_gather_decode`` with ``dtype``/``width``) equals the plain
gather-decode, slice and cast bit for bit in bf16, f16 and f32 at widths
that are and are not a multiple of 8, an id outside the pool writing NaN;
without them the same kernel decodes whole pool rows in f32.  Bad views,
outputs, widths and types raise.

The lowrank matmul's three forms (``tall``, ``at_b``, ``small_k``) at
small, ragged and the training step's shapes (gemma3-1b's per-rank
gradient at dp 2 x tp 2: 1051352 x 512), at r = 1, 2, 3, 4, 5, 8, 16,
32, 33 and 64 (the plr ladder's ranks 2, 4 and 8, every instance of each
form, and ranks that are no multiple of 4): within
``lowrank.error_bound`` of the plain version (each side a sum of k f32
products, so both within gamma_k |a| @ |b| of the exact product) and
within ``lowrank.order_bound`` of the f64 product (the kernel's own sum
order: at the path's 1051352-row reduction about 400 times tighter),
equal to the plain version bit for bit on integer inputs in [-2, 2] at
every shape (every partial sum is an integer below 2^24, so exact in any
order: a dropped or doubled slab of ``at_b`` shows), bit-identical on a
second call, one launch per call of its own form.  ``small_k`` on a row
slice ``phat[r0:r1]`` that is not 16-byte aligned, written with ``out=``
as ``comms._lowrank_rows`` writes it, ``tall`` on a factor of odd rank,
on a strided factor and on a misaligned ``a``, and ``at_b`` on a column
slice of a wider matrix (base and row stride not 16-byte aligned), equal
the plain version on integers and write nothing past their output.
"""

import pytest
import torch

from repro_torch.kernels import bq, lowrank, ops

BITS = (4, 8, 16, 24)
PLANES = ("q_hi", "q_lo", "scale")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


def _rows(m: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, 128, generator=g) * 10
    u = torch.rand(6, 128, generator=g) * 2 - 1
    x[0] = 0.0                                  # all zero -> scale 1
    x[1] = u[0] * 3.4e38                        # near f32 max
    x[2] = u[1] * 1e-3
    x[2, 0] = 3.0e38                            # one huge, rest tiny
    x[3] = u[2] * 1e-40                         # denormal max
    x[4] = u[3] * 1e-40
    x[4, 0] = 1.0                               # denormals beside 1.0
    x[5] = 1e-45                                # smallest denormal
    return x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
def test_kernels_match_plain(cuda, bits):
    x2d = _rows(48, bits, cuda)
    bq.reset_launches()
    w = ops.bq_encode_blocks(x2d, bits)
    wp = ops.bq_encode_blocks(x2d, bits, backend="torch")
    for k in PLANES:
        assert (w[k] is None) == (wp[k] is None)
        if wp[k] is not None:
            assert torch.equal(w[k], wp[k]), k
    assert torch.equal(ops.bq_decode_blocks(w, bits),
                       ops.bq_decode_blocks(w, bits, backend="torch"))
    pool = {k: None if v is None else v.reshape(6, 4, 2, -1)
            for k, v in w.items()}
    idx = torch.tensor([[3, 0, 5], [1, 1, 4]], dtype=torch.int32, device=cuda)
    assert torch.equal(ops.bq_gather_decode(pool, idx, bits),
                       ops.bq_gather_decode(pool, idx, bits, backend="torch"))
    torch.cuda.synchronize()
    assert bq.LAUNCHES == {"bq_encode": 1, "bq_encode_flat": 0,
                           "bq_encode_view": 0, "bq_decode": 1,
                           "bq_decode_flat": 0, "bq_gather_decode": 1,
                           "bq_decode_add_encode": 0,
                           "bq_decode_add_encode_wire": 0,
                           "bq_decode_add_encode_view": 0,
                           "bq_decode_add": 0, "bq_decode_add_flat": 0}


@pytest.mark.cuda
def test_out_of_range_ids_decode_to_nan(cuda):
    w = ops.bq_encode_blocks(_rows(48, 1, cuda), 8)
    pool = {k: None if v is None else v.reshape(6, 4, 2, -1)
            for k, v in w.items()}
    idx = torch.tensor([[6, 2], [-1, 0]], dtype=torch.int32, device=cuda)
    got = ops.bq_gather_decode(pool, idx, 8)
    torch.cuda.synchronize()
    assert got[0, 0].isnan().all() and got[1, 0].isnan().all()
    want = ops.bq_gather_decode(pool, idx.clamp(0, 5), 8, backend="torch")
    assert torch.equal(got[0, 1], want[0, 1])
    assert torch.equal(got[1, 1], want[1, 1])


@pytest.mark.cuda
def test_wrappers_validate_inputs(cuda):
    with pytest.raises(TypeError):
        bq.bq_encode(torch.zeros(8, 128, dtype=torch.float16, device=cuda), 8)
    with pytest.raises(ValueError):
        bq.bq_encode(torch.zeros(8, 64, device=cuda), 8)
    with pytest.raises(ValueError):
        bq.bq_encode(torch.zeros(128, 8, device=cuda).t(), 8)
    with pytest.raises(ValueError):
        bq.bq_decode(torch.zeros(8, 128, dtype=torch.int8, device=cuda), None,
                     torch.ones(8, 1), 8)
    w = ops.bq_encode_blocks(torch.zeros(8, 128, device=cuda), 24)
    with pytest.raises(ValueError):
        bq.bq_decode(w["q_hi"], None, w["scale"], 24)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m", [8, 48, 65536])
def test_fused_hops_match_plain(cuda, bits, m):
    """Pallas #3 (with the sum and wire-only) and #4 on the card equal
    their plain versions bit for bit; each form counts its own launches."""
    w = ops.bq_encode_blocks(_rows(m, bits, cuda), bits, backend="torch")
    local = _rows(m, bits + 100, cuda) * 0.3
    bq.reset_launches()
    got_w, got_s = ops.bq_decode_add_encode_blocks(w, local, bits)
    want_w, want_s = ops.bq_decode_add_encode_blocks(w, local, bits,
                                                     backend="torch")
    wire_w, none = ops.bq_decode_add_encode_blocks(w, local, bits,
                                                   want_sum=False)
    got_a = ops.bq_decode_add_blocks(w, local, bits)
    want_a = ops.bq_decode_add_blocks(w, local, bits, backend="torch")
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(got_s, want_s) and torch.equal(got_a, want_a)
    for k in PLANES:
        if want_w[k] is not None:
            assert torch.equal(got_w[k], want_w[k]), k
            assert torch.equal(wire_w[k], want_w[k]), k
    assert (bq.LAUNCHES["bq_decode_add_encode"],
            bq.LAUNCHES["bq_decode_add_encode_wire"],
            bq.LAUNCHES["bq_decode_add"]) == (1, 1, 1)


@pytest.mark.cuda
def test_fused_hops_validate_inputs(cuda):
    w = ops.bq_encode_blocks(torch.zeros(16, 128, device=cuda), 8)
    with pytest.raises(TypeError):          # local must be f32
        bq.bq_decode_add(w["q_hi"], None, w["scale"],
                         torch.zeros(16, 128, dtype=torch.bfloat16,
                                     device=cuda), 8)
    with pytest.raises(ValueError):         # and match the wire's rows
        bq.bq_decode_add_encode(w["q_hi"], None, w["scale"],
                                torch.zeros(8, 128, device=cuda), 8)
    with pytest.raises(ValueError):         # and be contiguous
        bq.bq_decode_add(w["q_hi"], None, w["scale"],
                         torch.zeros(128, 16, device=cuda).t(), 8)


# --------------------------------------------------------------------------
# the flat encode and decode (the TP all-gather's, fused with its layout)
# --------------------------------------------------------------------------

FLAT_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
FLAT_N = (0, 1, 127, 1025, 70000, 2 * 512 * 1152)


def _flat(n: int, dtype, seed: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 50
    if n > 512:
        x[:128] = _rows(8, seed, "cpu")[1]      # near f32 max
        x[128:256] = 0.0
        x[256:384] *= 1e4                       # past the f16 range
    return x.to(dtype).to(dev)


def _same_bits(a, b) -> bool:
    """Bit for bit, but NaN only by position (payloads may differ)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", FLAT_DTYPES + (torch.int32,))
def test_flat_forms_match_plain(cuda, bits, dtype):
    """bq_encode_flat equals bq_encode(to_blocks(x)) and bq_decode_flat
    equals from_blocks(decode) cast to the type, bit for bit (NaN by
    position: scales of inf and NaN are planted); one launch each."""
    for n in FLAT_N:
        x = _flat(n, dtype, bits + n, cuda)
        bq.reset_launches()
        got = bq.bq_encode_flat(x, bits)
        want = bq.encode_flat_plain(x, bits)
        assert bq.LAUNCHES["bq_encode_flat"] == 1
        rows = ops.padded_rows(n)
        assert bq.LAUNCH_SHAPES == {("bq_encode_flat", rows, bits): 1}
        for k, a, b in zip(PLANES, got, want):
            assert (a is None) == (b is None), k
            if b is not None:
                assert torch.equal(a, b), (n, k)
        if dtype == torch.int32:
            continue
        w = [t.clone() if t is not None else None for t in want]
        if rows > 8:
            w[2][1], w[2][2] = float("inf"), float("nan")
        d = bq.bq_decode_flat(*w, bits, n, dtype)
        torch.cuda.synchronize()
        assert _same_bits(d, bq.decode_flat_plain(*w, bits, n, dtype)), n
        assert bq.LAUNCHES["bq_decode_flat"] == (1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", FLAT_DTYPES)
def test_gathered_decode_matches_plain(cuda, bits, dtype):
    """The all-gather's tail in one launch: 2 and 3 shards joined along
    every axis equal the plain block decode, strip, cast and movedim."""
    for shape in ((3, 5, 7), (2, 8, 64), (2, 512, 1152)):
        for shards in (2, 3):
            n = 1
            for d in shape:
                n *= d
            ws = [ops.bq_encode(_flat(n, dtype, s, cuda).reshape(shape),
                                bits, backend="torch") for s in range(shards)]
            gw = {k: None if ws[0][k] is None else
                  torch.stack([w[k] for w in ws]) for k in PLANES}
            for ax in range(len(shape)):
                bq.reset_launches()
                got = ops.bq_decode_gathered(gw, bits, shape, dtype, ax)
                want = ops.bq_decode_gathered(gw, bits, shape, dtype, ax,
                                              backend="torch")
                torch.cuda.synchronize()
                assert bq.LAUNCHES["bq_decode_flat"] == 1
                assert _same_bits(got, want), (shape, shards, ax)


def _division_rows(m: int, seed: int, dev) -> torch.Tensor:
    """Rows whose scales span 2^-70 .. 2^110 (both sides of the encode's
    fast-division range) with uniform values, powers of two of the scale,
    and values near the rounding boundaries of every rate."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.exp2(torch.rand(m, 1, generator=g) * 180 - 70)
    u = torch.rand(m, 128, generator=g) * 2 - 1
    x = u * scale
    x[0::5] = torch.exp2(-torch.randint(0, 40, (len(x[0::5]), 128),
                                        generator=g).float()) * \
        torch.sign(u[0::5]) * scale[0::5]
    for i, qmax in enumerate((7, 127, 32767, 8388607)):
        rows = x[1 + i::5]
        k = torch.randint(-qmax, qmax, rows.shape, generator=g).double()
        rows.copy_(((k + 0.5) / qmax * scale[1 + i::5].double()).float())
    x[:, 0] = scale[:, 0]                       # each row reaches its scale
    return x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
def test_encode_division_matches_plain(cuda, bits):
    """The encode kernel's per-row-reciprocal division equals the plain
    version's IEEE division on 65536 rows across and beyond its range."""
    x2d = _division_rows(65536, bits, cuda)
    for got, want in ((bq.bq_encode(x2d, bits), bq.encode_plain(x2d, bits)),
                      (bq.bq_encode_flat(x2d.to(torch.bfloat16), bits),
                       bq.encode_flat_plain(x2d.to(torch.bfloat16), bits))):
        for k, a, b in zip(PLANES, got, want):
            assert (a is None) == (b is None), k
            if b is not None:
                assert torch.equal(a, b), k


@pytest.mark.cuda
def test_flat_wrappers_take_any_layout_and_validate(cuda):
    """A misaligned or strided input is encoded by the kernel (strided:
    made contiguous first), never by the plain version; malformed wires
    raise."""
    x = _flat(70001, torch.bfloat16, 3, cuda)
    for view in (x[1:], x[::3], x[:-1].reshape(2, -1).t()):
        bq.reset_launches()
        got = bq.bq_encode_flat(view, 16)
        assert bq.LAUNCHES["bq_encode_flat"] == 1
        for a, b in zip(got, bq.encode_flat_plain(view, 16)):
            assert (a is None and b is None) or torch.equal(a, b)
    w = bq.bq_encode_flat(x, 8)
    with pytest.raises(ValueError):          # 70001 values > 1 shard's rows
        bq.bq_decode_flat(*w, 8, 70001 + 1024, torch.bfloat16)
    with pytest.raises(ValueError):          # 552 rows in 5 shards
        bq.bq_decode_flat(*w, 8, 100, torch.bfloat16, shards=5)
    with pytest.raises(ValueError):          # inner must divide n
        bq.bq_decode_flat(*w, 8, 100, torch.bfloat16, inner=7)
    with pytest.raises(TypeError):           # the wire's type
        bq.bq_decode_flat(w[0].view(torch.uint8), None, w[2], 8, 100)
    with pytest.raises(ValueError):          # non-contiguous planes
        bq.bq_decode_flat(w[0][::2], None, w[2][::2], 8, 100)


# --------------------------------------------------------------------------
# the reduce-scatter's view forms and the fused KV read (Pallas #4, #5)
# --------------------------------------------------------------------------

# (payload shape before the split, axis) per case: the split axis is
# multiplied by the shard count; runs of 105, 35 and 7 values (scalar
# loads), 1024, 512 and 64 (vector loads)
VIEW_BASES = ((3, 5, 7), (2, 8, 64))


def _views(x, axis_dim: int, n: int):
    """Every (k, lo, hi) of the n chunks: the whole chunk and the parts of
    a bidirectional ring of two stripes."""
    from repro_torch.core import comms
    m = ops.padded_rows(x.numel() // n)
    spans = {(0, m)} | {(lo, hi) for lo, hi, _ in
                        comms._ring_schedule(m, True, 2).parts}
    return [bq.shard_view(x, axis_dim, n, k, lo, hi)
            for k in range(n) for lo, hi in sorted(spans)]


def _check_view_forms(view, bits: int) -> None:
    rows = bq.view_rows(view)
    bq.reset_launches()
    got = bq.bq_encode_view(view, bits)
    for k, a, b in zip(PLANES, got, bq.encode_plain(rows, bits)):
        assert (a is None) == (b is None), k
        if b is not None:
            assert torch.equal(a, b), (view.index, view.lo, k)
    wire = list(bq.encode_plain(rows * 0.5 + 1.0, bits))
    got = bq.bq_decode_add_encode_view(*wire, view, bits)
    want = bq.decode_add_encode_plain(*wire, rows, bits)[:3]
    for k, a, b in zip(PLANES, got, want):     # sums past f32: NaN scales
        if b is not None:
            assert _same_bits(a, b), (view.index, view.lo, k)
    if view.rows > 2:                    # scales of inf and NaN: NaN sums
        wire[2] = wire[2].clone()
        wire[2][1], wire[2][2] = float("inf"), float("nan")
    out = torch.full((view.n,), 7.0, dtype=view.x.dtype, device=view.x.device)
    want = bq.decode_add_flat_plain(*wire, view, bits, out.clone())
    assert bq.bq_decode_add_flat(*wire, view, bits, out) is out
    torch.cuda.synchronize()
    assert _same_bits(out, want), (view.index, view.lo)
    assert (bq.LAUNCHES["bq_encode_view"],
            bq.LAUNCHES["bq_decode_add_encode_view"],
            bq.LAUNCHES["bq_decode_add_flat"]) == (1, 1, int(
                min(view.hi * 128, view.n) > view.lo * 128))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", FLAT_DTYPES)
def test_view_forms_match_plain(cuda, bits, dtype):
    """Every chunk of payloads split 2, 3 and 4 ways along each axis."""
    for base in VIEW_BASES:
        for n in (2, 3, 4):
            for ax in range(3):
                shape = list(base)
                shape[ax] *= n
                numel = 1
                for d in shape:
                    numel *= d
                x = _flat(numel + 1, dtype, bits + n + ax, cuda)
                for payload in (x[:-1], x[1:]):        # aligned, misaligned
                    for view in _views(payload.reshape(shape), ax, n):
                        _check_view_forms(view, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_view_forms_at_the_tp_shape(cuda, bits):
    """The tp@mlp_out reduce-scatter's chunks (bf16 [2, 1024, 1152] along
    axis 1, 9216 rows) and the narrow sites' ([2, 1024, 256], 2048 rows)."""
    for shape in ((2, 1024, 1152), (2, 1024, 256)):
        x = _flat(2 * 1024 * shape[2], torch.bfloat16, bits, cuda)
        for view in _views(x.reshape(shape), 1, 2):
            _check_view_forms(view, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", FLAT_DTYPES)
def test_gather_decode_flat_matches_plain(cuda, bits, dtype):
    """The fused KV read equals gather-decode, slice and cast; an id
    outside the pool writes NaN and leaves the other entries alone."""
    for nb, bt, r in ((6, 4, 2), (296, 16, 2)):
        w = ops.bq_encode_blocks(_rows(nb * bt * r, bits, cuda), bits)
        pool = [None if w[k] is None else w[k].reshape(nb, bt, r, -1)
                for k in PLANES]
        g = torch.Generator().manual_seed(bits)
        idx = torch.randint(0, nb, (8, 5), generator=g,
                            dtype=torch.int32).to(cuda)
        for width in (r * 128, 192, 100, 1):
            bq.reset_launches()
            got = bq.bq_gather_decode(*pool, idx, bits, dtype=dtype,
                                      width=width)
            want = bq.gather_decode_flat_plain(*pool, idx, bits, dtype, width)
            torch.cuda.synchronize()
            assert got.shape == (8, 5, bt, width)
            assert _same_bits(got, want), (nb, width)
            assert bq.LAUNCHES["bq_gather_decode"] == 1
        bad = idx.clone()
        bad[0, 0], bad[3, 2] = nb, -1
        got = bq.bq_gather_decode(*pool, bad, bits, dtype=dtype, width=192)
        torch.cuda.synchronize()
        assert got[0, 0].isnan().all() and got[3, 2].isnan().all()
        ok = torch.ones(bad.shape, dtype=torch.bool, device=cuda)
        ok[0, 0] = ok[3, 2] = False
        want = bq.gather_decode_flat_plain(*pool, idx, bits, dtype, 192)
        assert _same_bits(got[ok], want[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", BITS)
def test_gather_decode_f32_form_matches_plain(cuda, bits):
    """Without ``dtype``/``width`` the same kernel decodes whole pool rows
    in f32, for pools of one to three axes after the block axis."""
    for lead in ((6, 4, 2), (296, 16, 2), (7,), (3, 2, 3, 2)):
        m = 1
        for d in lead:
            m *= d
        w = ops.bq_encode_blocks(_rows(m, bits + len(lead), cuda), bits)
        pool = [None if w[k] is None else w[k].reshape(*lead, -1)
                for k in PLANES]
        g = torch.Generator().manual_seed(bits)
        idx = torch.randint(0, lead[0], (8, 5), generator=g,
                            dtype=torch.int32).to(cuda)
        bq.reset_launches()
        got = bq.bq_gather_decode(*pool, idx, bits)
        want = bq.gather_decode_plain(*pool, idx, bits)
        torch.cuda.synchronize()
        assert got.shape == (8, 5, *lead[1:], 128)
        assert torch.equal(got, want), lead
        assert bq.LAUNCHES["bq_gather_decode"] == 1


@pytest.mark.cuda
def test_view_and_kv_wrappers_validate(cuda):
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):              # 8 rows in 3 chunks
        bq.shard_view(x, 1, 3, 0)
    with pytest.raises(ValueError):              # no chunk 2 of 2
        bq.shard_view(x, 1, 2, 2)
    with pytest.raises(ValueError):              # rows past the chunk
        bq.shard_view(x, 1, 2, 0, 0, 16)
    v = bq.shard_view(x, 1, 2, 0)
    w = bq.bq_encode_view(v, 8)
    with pytest.raises(TypeError):               # out in the view's type
        bq.bq_decode_add_flat(*w, v, 8, torch.empty(512, device=cuda))
    with pytest.raises(ValueError):              # and the chunk's size
        bq.bq_decode_add_flat(*w, v, 8, torch.empty(
            256, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):              # the wire's rows
        bq.bq_decode_add_encode_view(*(t[:4] if t is not None else None
                                       for t in w), v, 8)
    pool = ops.bq_encode_blocks(torch.zeros(32, 128, device=cuda), 8)
    planes = [None if pool[k] is None else pool[k].reshape(4, 4, 2, -1)
              for k in PLANES]
    idx = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):              # the output's type
        bq.bq_gather_decode(*planes, idx, 8, dtype=torch.int32)
    with pytest.raises(ValueError):              # width past the rows
        bq.bq_gather_decode(*planes, idx, 8, width=257)
    with pytest.raises(TypeError):               # the table's type
        bq.bq_gather_decode(*planes, idx.long(), 8, dtype=torch.bfloat16)


# --------------------------------------------------------------------------
# the lowrank matmul (Pallas #6)
# --------------------------------------------------------------------------

PATH_ROWS = 1051352                      # gemma3-1b, dp 2 x tp 2, per rank
# (rows, width) of the matrix view per size: small, ragged, the path's
MM_SHAPES = {"small": (64, 128), "ragged": (5001, 300), "path": (PATH_ROWS,
                                                                 512)}


def _mm_operands(kind: str, size: str, r: int, dev, integer=False):
    """(a, b) of one product form as the plr codec passes them: ``tall``
    M @ Q, ``at_b`` M.T @ P (a view of M), ``small_k`` P @ Q.T (a view)."""
    rows, width = MM_SHAPES[size]
    if kind == "small_k" and size == "ragged":
        width = 260                      # float4 stores with a ragged tail
    g = torch.Generator(device=dev).manual_seed(rows + width + r)

    def draw(*shape):
        if integer:     # |partial sums| <= 4 * 1051352 < 2^24: exact
            return torch.randint(-2, 3, shape, generator=g, device=dev,
                                 dtype=torch.int32).float()
        return torch.randn(*shape, generator=g, device=dev)
    if kind == "tall":
        return draw(rows, width), draw(width, r)
    if kind == "at_b":
        return draw(rows, width).T, draw(rows, r)
    return draw(rows, r), draw(width, r).T


MM_RANKS = [1, 2, 3, 4, 5, 8, 16, 32, 33, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("r", MM_RANKS)
@pytest.mark.parametrize("size", list(MM_SHAPES))
@pytest.mark.parametrize("kind", ["tall", "at_b", "small_k"])
def test_lowrank_matmul_within_bound(cuda, kind, size, r):
    a, b = _mm_operands(kind, size, r, cuda)
    assert lowrank.form(a, b) == kind
    lowrank.reset_launches()
    got = lowrank.matmul(a, b)
    again = lowrank.matmul(a, b)
    want = lowrank.matmul(a, b, backend="torch")
    torch.cuda.synchronize()
    assert lowrank.LAUNCHES == {f"matmul_{k}": 2 if k == kind else 0
                                for k in ("tall", "at_b", "small_k")}
    assert torch.equal(got, again)                   # deterministic
    err = (got.double() - want.double()).abs()
    assert bool((err <= lowrank.error_bound(a, b)).all()), float(err.max())
    with lowrank._no_tf32():
        exact = torch.matmul(a.double(), b.double())
    err = (got.double() - exact).abs()
    assert bool((err <= lowrank.order_bound(a, b)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(MM_SHAPES))
@pytest.mark.parametrize("kind", ["tall", "at_b", "small_k"])
def test_lowrank_matmul_exact_on_integers(cuda, kind, size):
    for r in MM_RANKS:
        a, b = _mm_operands(kind, size, r, cuda, integer=True)
        got = lowrank.matmul(a, b)
        want = lowrank.matmul(a, b, backend="torch")
        assert torch.equal(got, want), (size, r)


@pytest.mark.cuda
def test_lowrank_matmul_writes_out(cuda):
    a, b = _mm_operands("small_k", "ragged", 8, cuda)
    buf = torch.full((a.shape[0] * b.shape[1] + 7,), 5.0, device=cuda)
    out = buf[:a.shape[0] * b.shape[1]].view(a.shape[0], b.shape[1])
    assert lowrank.matmul(a, b, out=out) is out
    assert torch.equal(out, lowrank.matmul(a, b))
    assert bool((buf[out.numel():] == 5.0).all())    # nothing past it


def _ints(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2, 3, shape, generator=g, device=dev,
                         dtype=torch.int32).float()


@pytest.mark.cuda
@pytest.mark.parametrize("r,r0", [(3, 1), (5, 3), (6, 1), (33, 1)])
def test_lowrank_small_k_on_misaligned_row_slice(cuda, r, r0):
    """P^[r0:r1] @ Q^T as comms._lowrank_rows runs it: a starts r0 * r
    floats into its buffer (not 16-byte aligned), b is a view of q."""
    from repro_torch.core import comms

    rows, width = 5001, 256
    phat, q = _ints((rows, r), r, cuda), _ints((width, r), r + 1, cuda)
    r1 = rows - 2
    a = phat[r0:r1]
    assert (a.data_ptr() % 16) != 0
    buf = torch.full(((r1 - r0) * width + 7,), 5.0, device=cuda)
    out = buf[:(r1 - r0) * width].view(r1 - r0, width)
    lowrank.reset_launches()
    assert lowrank.matmul(a, q.T, out=out) is out
    torch.cuda.synchronize()
    assert lowrank.LAUNCHES["matmul_small_k"] == 1
    assert torch.equal(out, lowrank.matmul(a, q.T, backend="torch"))
    assert bool((buf[out.numel():] == 5.0).all())    # nothing past it
    # the path's own call, rows [r0, r1) of the reconstruction
    n = rows * width - 100
    got = comms._lowrank_rows(phat, q, r0 * width, (r1 - r0) * width, n)
    want = lowrank.matmul(phat, q.T, backend="torch").reshape(-1)
    want[n:] = 0
    assert torch.equal(got, want[r0 * width:r1 * width])


@pytest.mark.cuda
@pytest.mark.parametrize("r", [3, 5, 33])
def test_lowrank_tall_odd_rank_and_strides(cuda, r):
    """M @ Q with Q of odd rank (n not a multiple of 4: scalar stores),
    Q a column slice of a wider factor (strided), and M a misaligned row
    view (lda = 301, scalar loads)."""
    rows, width = 5001, 300
    m = _ints((rows, width), r, cuda)
    q = _ints((width, r), r + 1, cuda)
    wide = _ints((width, 64), r + 2, cuda)
    odd = _ints((rows + 1, width + 1), r + 3, cuda)[1:, 1:]
    assert odd.data_ptr() % 16 and odd.stride(0) == width + 1
    lowrank.reset_launches()
    for a, b in ((m, q), (m, wide[:, :r]), (odd, q)):
        assert lowrank.form(a, b) == "tall"
        buf = torch.full((rows * r + 5,), 5.0, device=cuda)
        out = buf[:rows * r].view(rows, r)
        lowrank.matmul(a, b, out=out)
        assert torch.equal(out, lowrank.matmul(a, b, backend="torch"))
        assert bool((buf[out.numel():] == 5.0).all())
    torch.cuda.synchronize()
    assert lowrank.LAUNCHES["matmul_tall"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3, 8, 33])
def test_lowrank_at_b_misaligned_rows(cuda, r):
    """M.T @ P^ with M a column slice of a wider matrix: its base pointer
    and its row stride (301 floats) are not 16-byte aligned, so the kernel
    stages M 4 bytes at a time; equal to the plain version on integers,
    twice alike, nothing written past the output."""
    rows, width = 5001, 300
    mat = _ints((rows, width + 1), r, cuda)[:, 1:]
    p = _ints((rows, r), r + 1, cuda)
    assert mat.data_ptr() % 16 and mat.stride(0) == width + 1
    a = mat.T
    assert lowrank.form(a, p) == "at_b"
    buf = torch.full((width * r + 5,), 5.0, device=cuda)
    out = buf[:width * r].view(width, r)
    lowrank.reset_launches()
    assert lowrank.matmul(a, p, out=out) is out
    again = lowrank.matmul(a, p)
    torch.cuda.synchronize()
    assert lowrank.LAUNCHES["matmul_at_b"] == 2
    assert torch.equal(out, lowrank.matmul(a, p, backend="torch"))
    assert torch.equal(out, again)
    assert bool((buf[out.numel():] == 5.0).all())    # nothing past it


@pytest.mark.cuda
def test_lowrank_matmul_validates_inputs(cuda):
    a = torch.zeros(64, 128, device=cuda)
    with pytest.raises(TypeError):
        lowrank.matmul(a.double(), torch.zeros(128, 8, device=cuda,
                                               dtype=torch.float64))
    with pytest.raises(ValueError):                  # devices mixed
        lowrank.matmul(a, torch.zeros(128, 8))
    with pytest.raises(ValueError):                  # inner dims differ
        lowrank.matmul(a, torch.zeros(64, 8, device=cuda))
    with pytest.raises(ValueError):                  # no form takes it
        lowrank.matmul(torch.zeros(64, 1024, device=cuda),
                       torch.zeros(1024, 128, device=cuda))
    with pytest.raises(ValueError):                  # out of the wrong shape
        lowrank.matmul(a, torch.zeros(128, 8, device=cuda),
                       out=torch.empty(64, 9, device=cuda))
    p = torch.zeros(64, 8, device=cuda)
    with pytest.raises(ValueError):                  # small_k: n % 4 != 0
        lowrank.matmul(p, torch.zeros(8, 130, device=cuda))
    buf = torch.empty(64 * 128 + 1, device=cuda)
    with pytest.raises(ValueError):                  # small_k: out unaligned
        lowrank.matmul(p, torch.zeros(8, 128, device=cuda),
                       out=buf[1:].view(64, 128))
