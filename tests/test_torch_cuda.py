"""The port's CUDA kernels on the card (marker ``cuda``; skips without a
GPU).  Imports neither ``jax`` nor ``repro``, so it also runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Contract asserted here: each kernel (encode, decode, gather-decode, the
fused ring hop with the sum and wire-only, decode-add) equals its plain
PyTorch version bit for bit at rates 4/8/16/24 on random, all-zero,
extreme-magnitude and denormal rows; a block id outside the pool decodes to NaN without
disturbing the other rows; each wrapper counts exactly its own launches;
tensors of the wrong dtype, shape or device raise.
"""

import pytest
import torch

from repro_torch.kernels import bq, ops

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
    assert bq.LAUNCHES == {"bq_encode": 1, "bq_decode": 1,
                           "bq_gather_decode": 1, "bq_decode_add_encode": 0,
                           "bq_decode_add_encode_wire": 0,
                           "bq_decode_add": 0}


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
