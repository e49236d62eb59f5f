"""Public entry points for the bq codec kernels.

Dispatch is by the tensor's device (see :mod:`repro_torch.kernels.bq`): a
CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
Hopper kernel.  ``backend="torch"`` forces the plain version on any device;
it exists for the tests and ``chip_smoke.py``, which hold the kernels
against it on the card.

Shape handling follows ``repro.kernels.ops``: tensors of any shape are
flattened, zero-padded to whole ``(TILE_M, BLOCK)`` tiles and viewed as an
``(M, 128)`` block matrix.  The padding fixes the wire bytes, so it is kept
exactly.  On the card the tensor-level ops (:func:`bq_encode`,
:func:`bq_decode`, :func:`bq_decode_gathered`) do that layout work inside
one kernel launch (``bq.bq_encode_flat``, ``bq.bq_decode_flat``), the
shard-view ops (:func:`bq_encode_view`, :func:`bq_decode_add_encode_view`,
:func:`bq_decode_add_view`) read a reduce-scatter's chunk in place and
write its sum in the payload's type, and :func:`bq_gather_decode` with
``dtype``/``width`` writes the paged KV read's tokens itself;
``backend="torch"`` runs the plain sequence of block ops.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import bq, ref
from repro_torch.kernels.ref import BLOCK

_BACKENDS = (None, "torch")
_DEFAULT_BACKEND = None


def set_default_backend(name) -> None:
    """Backend taken when a call passes none: ``None`` dispatches by device
    (the kernels on the card), ``"torch"`` forces the plain versions.
    ``launch.train.run`` and ``launch.ring_check`` set it for a whole run
    from their ``backend`` argument, so that ``chip_smoke.py`` can hold the
    kernels against their plain versions end to end; a single call passes
    ``backend`` itself."""
    global _DEFAULT_BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {name!r}")
    _DEFAULT_BACKEND = name


def _plain(backend) -> bool:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    return (backend or _DEFAULT_BACKEND) == "torch"


def on_kernels(x: torch.Tensor) -> bool:
    """Whether an op on ``x`` without a backend runs the kernels: a CUDA
    tensor, the default backend not forced to the plain versions."""
    return x.device.type == "cuda" and not _plain(None)


padded_rows = bq.padded_rows
to_blocks = bq.to_blocks
ungather = bq.ungather
gathered_shape = bq.gathered_shape
shard_view = bq.shard_view


def from_blocks(x2d: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`to_blocks`."""
    n = 1
    for d in shape:
        n *= d
    return x2d.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def wire_nbytes(wire) -> int:
    """Bytes of every tensor leaf of a wire dict (nested dicts and lists
    are walked, ``None`` planes count zero)."""
    if wire is None:
        return 0
    if isinstance(wire, torch.Tensor):
        return wire.numel() * wire.element_size()
    if isinstance(wire, dict):
        return sum(wire_nbytes(v) for v in wire.values())
    return sum(wire_nbytes(v) for v in wire)


# --------------------------------------------------------------------------
# block-matrix level ops
# --------------------------------------------------------------------------

def _rows(t):
    """``(..., w)`` -> ``(rows, w)``: the kernels take 2-D row matrices."""
    return None if t is None else t.reshape(-1, t.shape[-1])


def _unrows(wire: dict, lead: tuple) -> dict:
    return {k: None if v is None else v.reshape(*lead, v.shape[-1])
            for k, v in wire.items()}


def bq_encode_blocks(x2d: torch.Tensor, bits: int, backend=None) -> dict:
    """(..., M, 128) f32 -> wire dict {q_hi, q_lo|None, scale}."""
    enc = ref.bq_encode_ref if _plain(backend) else bq.bq_encode
    hi, lo, scale = enc(_rows(x2d), bits)
    return _unrows({"q_hi": hi, "q_lo": lo, "scale": scale},
                   tuple(x2d.shape[:-1]))


def bq_decode_blocks(wire: dict, bits: int, backend=None) -> torch.Tensor:
    """wire dict -> (..., M, 128) f32."""
    dec = ref.bq_decode_ref if _plain(backend) else bq.bq_decode
    lead = tuple(wire["scale"].shape[:-1])
    out = dec(_rows(wire["q_hi"]), _rows(wire["q_lo"]), _rows(wire["scale"]),
              bits)
    return out.reshape(*lead, BLOCK)


def bq_decode_add_encode_blocks(wire: dict, local2d: torch.Tensor, bits: int,
                                backend=None, want_sum: bool = True):
    """Fused ring hop: returns ``(wire', sum_f32 (M, 128) | None)``.
    ``want_sum=False`` is the wire-only form of the intermediate hops."""
    if _plain(backend):
        hi, lo, scale, s = ref.bq_decode_add_encode_ref(
            wire["q_hi"], wire["q_lo"], wire["scale"], local2d, bits)
        s = s if want_sum else None
    else:
        hi, lo, scale, s = bq.bq_decode_add_encode(
            wire["q_hi"], wire["q_lo"], wire["scale"], local2d, bits,
            want_sum=want_sum)
    return {"q_hi": hi, "q_lo": lo, "scale": scale}, s


def bq_decode_add_blocks(wire: dict, local2d: torch.Tensor, bits: int,
                         backend=None) -> torch.Tensor:
    """Last reduce-scatter hop: local + decode(wire) -> (M, 128) f32."""
    da = ref.bq_decode_add_ref if _plain(backend) else bq.bq_decode_add
    return da(wire["q_hi"], wire["q_lo"], wire["scale"], local2d, bits)


def bq_gather_decode(wire: dict, idx: torch.Tensor, bits: int,
                     backend=None, dtype=None,
                     width: int | None = None) -> torch.Tensor:
    """Paged decode-read: decode the pool rows named by the block table
    ``idx`` (int32, any shape).  ``wire`` holds pool planes with a leading
    block axis (``q_hi (n_blocks, ..., w)``, ``scale (n_blocks, ..., 1)``).
    Returns f32 of shape ``idx.shape + pool.shape[1:-1] + (128,)``; with
    ``dtype`` or ``width``, each token's (R pool rows') first ``width``
    values in ``dtype``: ``idx.shape + pool.shape[1:-2] + (width,)`` (see
    ``bq.bq_gather_decode``)."""
    planes = (wire["q_hi"], wire["q_lo"], wire["scale"], idx, bits)
    if not _plain(backend):
        return bq.bq_gather_decode(*planes, dtype=dtype, width=width)
    if dtype is None and width is None:
        return ref.bq_gather_decode_ref(*planes)
    return bq.gather_decode_flat_plain(*planes, dtype or torch.float32, width)


# --------------------------------------------------------------------------
# shard-view ops (the ring reduce-scatter's chunks, read in place)
# --------------------------------------------------------------------------

def bq_encode_view(view: bq.ShardView, bits: int, backend=None) -> dict:
    """Wire dict of the view's rows (the first ring hop); the plain version
    encodes ``bq.view_rows(view)``."""
    if _plain(backend):
        return bq_encode_blocks(bq.view_rows(view), bits, backend)
    hi, lo, scale = bq.bq_encode_view(view, bits)
    return {"q_hi": hi, "q_lo": lo, "scale": scale}


def bq_decode_add_encode_view(wire: dict, view: bq.ShardView, bits: int,
                              backend=None) -> dict:
    """Wire-only fused ring hop onto the view's rows (a middle hop)."""
    if _plain(backend):
        return bq_decode_add_encode_blocks(wire, bq.view_rows(view), bits,
                                           backend, want_sum=False)[0]
    hi, lo, scale = bq.bq_decode_add_encode_view(
        wire["q_hi"], wire["q_lo"], wire["scale"], view, bits)
    return {"q_hi": hi, "q_lo": lo, "scale": scale}


def bq_decode_add_view(wire: dict, view: bq.ShardView, bits: int,
                       out: torch.Tensor, backend=None) -> torch.Tensor:
    """Last ring hop onto the view's rows, the chunk's sums written in
    ``out``'s type to their places in ``out`` (see
    ``bq.bq_decode_add_flat``); returns ``out``."""
    da = bq.decode_add_flat_plain if _plain(backend) else \
        bq.bq_decode_add_flat
    return da(wire["q_hi"], wire["q_lo"], wire["scale"], view, bits, out)


# --------------------------------------------------------------------------
# tensor-level ops (arbitrary shape)
# --------------------------------------------------------------------------

def bq_encode(x: torch.Tensor, bits: int, backend=None) -> dict:
    """Any-shape tensor -> the wire dict of ``to_blocks(x)``."""
    if _plain(backend):
        return bq_encode_blocks(to_blocks(x), bits, backend)
    hi, lo, scale = bq.bq_encode_flat(x, bits)
    return {"q_hi": hi, "q_lo": lo, "scale": scale}


def bq_decode(wire: dict, bits: int, shape, dtype=torch.float32,
              backend=None) -> torch.Tensor:
    """Wire dict -> the tensor of ``shape`` in ``dtype``."""
    if _plain(backend):
        return from_blocks(bq_decode_blocks(wire, bits, backend), shape,
                           dtype)
    return bq.bq_decode_flat(wire["q_hi"], wire["q_lo"], wire["scale"], bits,
                             math.prod(shape), dtype).reshape(tuple(shape))


def bq_decode_gathered(wire: dict, bits: int, shape, dtype, axis_dim: int,
                       backend=None) -> torch.Tensor:
    """Wire dict of S shards' encodes stacked on a leading axis (planes
    ``[S, M, w]``) -> the S decoded tensors of ``shape`` joined along
    ``axis_dim``, in ``dtype``: the compressed all-gather's tail.  On the
    card one launch of ``bq.bq_decode_flat``; ``backend="torch"`` the plain
    :func:`ungather` of the decoded blocks."""
    if _plain(backend):
        return ungather(bq_decode_blocks(wire, bits, backend), shape, dtype,
                        axis_dim)
    s = wire["scale"].shape[0]
    out = bq.bq_decode_flat(wire["q_hi"], wire["q_lo"], wire["scale"], bits,
                            math.prod(shape), dtype, shards=s,
                            inner=math.prod(shape[axis_dim:]))
    return out.reshape(gathered_shape(shape, s, axis_dim))
