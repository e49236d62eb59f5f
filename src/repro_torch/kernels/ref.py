"""Plain PyTorch versions of the block-quantization (bq) codec arithmetic.

Op-for-op transcription of ``repro.kernels.ref``: values are grouped into
rows of ``BLOCK`` consecutive elements, each row is scaled by its max-abs
value, and mantissas are stored as ``bits``-bit two's-complement integers.

These functions are the CPU path of every bq entry point and the yardstick
the hand-written CUDA kernels in :mod:`repro_torch.kernels.bq` are held to
bit for bit.  The arithmetic order matters: quantization is an IEEE divide,
then a multiply by ``qmax``, then round-half-to-even, then clip; decode is
``q * (scale * _INV_QMAX[bits])``; the fused ring hops add ``local`` to
that product as a separate operation.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 128  # elements per row (one f32 scale each)

# mantissa range per supported rate; rate 4 is nibble-packed (two values
# per uint8 byte)
_QMAX = {4: 7, 8: 127, 16: 32767, 24: 8388607}
# f32-exact reciprocal as a Python float, so every path does one multiply
# chain and stays bit-identical
_INV_QMAX = {b: float(np.float32(1.0) / np.float32(q)) for b, q in _QMAX.items()}


def _check_bits(bits: int) -> None:
    if bits not in _QMAX:
        raise ValueError(f"bq codec supports bits in {sorted(_QMAX)}, got {bits}")


def block_scale_ref(x: torch.Tensor) -> torch.Tensor:
    """Per-row scale = max|x| over the last axis, 1.0 for all-zero rows.

    x: (..., BLOCK) float32 -> (..., 1) float32
    """
    amax = x.abs().amax(dim=-1, keepdim=True)
    return torch.where(amax == 0.0, torch.ones_like(amax), amax)


def bq_encode_ref(x: torch.Tensor, bits: int):
    """Quantize (..., BLOCK) into fixed-rate mantissas + per-row scale.

    Returns (q_hi, q_lo, scale):
      bits=4  -> q_hi uint8 (..., BLOCK/2) nibble-packed, q_lo None
      bits=8  -> q_hi int8  (..., BLOCK), q_lo None
      bits=16 -> q_hi int16 (..., BLOCK), q_lo None
      bits=24 -> q_hi int16 (top 16 bits), q_lo uint8 (bottom 8 bits)
      scale   -> float32 (..., 1)
    """
    _check_bits(bits)
    x = x.to(torch.float32)
    scale = block_scale_ref(x)
    qmax = _QMAX[bits]
    # round(x / scale * qmax) clipped; in place after the divide, so a
    # gigabyte-sized payload needs one temporary, not five
    q = (x / scale).mul_(qmax).round_().clamp_(-qmax, qmax)
    if bits == 8:
        return q.to(torch.int8), None, scale
    if bits == 16:
        return q.to(torch.int16), None, scale
    q = q.to(torch.int32)
    if bits == 4:
        qq = (q + 8).reshape(*q.shape[:-1], q.shape[-1] // 2, 2)
        packed = (qq[..., 0] << 4) | qq[..., 1]
        return packed.to(torch.uint8), None, scale
    # bits == 24: arithmetic shift for the high plane, low byte unsigned
    return (q >> 8).to(torch.int16), (q & 0xFF).to(torch.uint8), scale


def bq_decode_ref(q_hi: torch.Tensor, q_lo, scale: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Inverse of :func:`bq_encode_ref` -> float32 (..., BLOCK)."""
    _check_bits(bits)
    if bits == 4:
        p = q_hi.to(torch.int32)
        q = torch.stack([(p >> 4) - 8, (p & 0xF) - 8], dim=-1)
        q = q.reshape(*p.shape[:-1], p.shape[-1] * 2).to(torch.float32)
    elif bits == 24:
        q = (q_hi.to(torch.int32) * 256 + q_lo.to(torch.int32)) \
            .to(torch.float32)
    else:                                  # int8 / int16 -> f32 is exact
        q = q_hi.to(torch.float32)
    return q.mul_(scale * _INV_QMAX[bits])


def bq_decode_add_encode_ref(q_hi, q_lo, scale, local: torch.Tensor,
                             bits: int):
    """Fused ring hop: ``encode(local + decode(wire))``, the inner step of
    the compressed ring reduce-scatter.  Returns ``(q_hi', q_lo', scale',
    sum_f32)``."""
    s = bq_decode_ref(q_hi, q_lo, scale, bits) + local.to(torch.float32)
    hi, lo, sc = bq_encode_ref(s, bits)
    return hi, lo, sc, s


def bq_decode_add_ref(q_hi, q_lo, scale, local: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """Last reduce-scatter hop: ``local + decode(wire)``, no re-encode;
    bit-identical to the ``sum_f32`` of :func:`bq_decode_add_encode_ref`."""
    return bq_decode_ref(q_hi, q_lo, scale, bits) + local.to(torch.float32)


def bq_gather_decode_ref(q_hi, q_lo, scale, idx: torch.Tensor, bits: int):
    """Paged decode-read: gather pool rows by a leading block index, then
    dequantize.  Returns f32 of shape ``idx.shape + pool.shape[1:-1] +
    (BLOCK,)``."""
    _check_bits(bits)
    idx = idx.long()
    take = lambda a: None if a is None else a[idx]  # noqa: E731
    return bq_decode_ref(take(q_hi), take(q_lo), take(scale), bits)


def max_abs_error_bound(scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Worst-case |x - D(E(x))| per row: half a quantization step plus a
    few f32 ulps of the row max for the scale/rescale arithmetic."""
    _check_bits(bits)
    return scale[..., 0] * (0.5 / _QMAX[bits] + 1e-6)
