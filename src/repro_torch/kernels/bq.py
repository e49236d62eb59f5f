"""Hopper kernels for the block-quantization (bq) codec, with their plain
PyTorch versions beside them.

The ports of five Pallas kernels, hand-written in CUDA C++ for ``sm_90a``
(``csrc/bq.cu``):

* :func:`bq_encode` replaces ``repro/kernels/bq.py::bq_encode_pallas``
  (``_encode_kernel``/``_encode24_kernel``): ``(M, 128)`` f32 -> wire planes.
  :func:`bq_encode_flat` is the same kernel on a tensor of any shape in
  bf16, f16 or f32: the cast to f32 and the zero padding of the last tile
  happen in the kernel, so ``bq_encode_flat(x) == bq_encode(to_blocks(x))``
  in one launch.
* :func:`bq_decode` replaces ``bq_decode_pallas``
  (``_decode_kernel``/``_decode24_kernel``): wire planes -> ``(M, 128)`` f32.
  :func:`bq_decode_flat` is the same kernel writing the payload itself in
  bf16, f16 or f32, the padding stripped and, for the wires of several
  shards, the shards joined along an axis (the compressed all-gather's
  tail) in one launch.
* :func:`bq_gather_decode` replaces ``bq_gather_decode_pallas``: decodes the
  pool rows named by a block table, reading the table inside the kernel.
  With ``dtype`` and ``width`` it writes each token's first ``width``
  values in bf16, f16 or f32 (the paged KV read's slice and cast) in the
  same launch.
* :func:`bq_decode_add_encode` replaces ``bq_decode_add_encode_pallas``,
  the fused ring hop ``encode(local + decode(wire))``: with the f32 sum
  (``_dae_kernel``/``_dae24_kernel``, the all-reduce tail) or wire-only
  (``_daew_kernel``/``_daew24_kernel``, intermediate reduce-scatter hops).
* :func:`bq_decode_add` replaces ``bq_decode_add_pallas``
  (``_da_kernel``/``_da24_kernel``), the last reduce-scatter hop
  ``local + decode(wire)``.  :func:`bq_decode_add_flat` is its form for
  the TP reduce-scatter: the local chunk read in place through a
  :class:`ShardView` of the payload, the sum written in the payload's
  type to its place in the chunk.

The reduce-scatter's first and middle hops read their chunk through the
same view: :func:`bq_encode_view` (the encode kernel) and
:func:`bq_decode_add_encode_view` (the wire-only fused hop), so no f32
copy of the split payload is written.

All five move a few bytes per flop, so on an H100 they are bound by bytes
moved over 3.35 TB/s.  The kernels read and write every byte once with
coalesced vector accesses and keep intermediates (the f32 copy of a bf16
payload, its padded blocks, the gathered planes) out of device memory
(see the source note in ``csrc/bq.cu``).

Dispatch is by the tensor's device: a CPU tensor goes to the plain version
(:mod:`repro_torch.kernels.ref`), a CUDA tensor launches the kernel or
raises.  There is no fallback from the card to the plain version.  The
library is built with ``nvcc`` on first use, from ``csrc/`` only (this
file's kernels and those of :mod:`repro_torch.kernels.lowrank`), into
``_build/<hash of the sources>/`` beside this file.

``LAUNCHES`` counts kernel launches per wrapper; it is incremented right
where the kernel launches and nowhere else, beside ``LAUNCH_SHAPES``, the
launches of each (wrapper, rows, rate), and ``LAUNCH_LEVELS``, those of
each (wrapper, link level): the level a hierarchical collective's stage
sets with :func:`set_launch_level` ("flat" outside one).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import BLOCK, _INV_QMAX, _QMAX

TILE_M = 8  # rows of one tile: padding unit of the block-matrix layout

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_COMPILE_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v")
_LINK_FLAGS = (*_ARCH, "-shared")

LAUNCHES = {"bq_encode": 0, "bq_encode_flat": 0, "bq_encode_view": 0,
            "bq_decode": 0, "bq_decode_flat": 0, "bq_gather_decode": 0,
            "bq_decode_add_encode": 0,
            "bq_decode_add_encode_wire": 0, "bq_decode_add_encode_view": 0,
            "bq_decode_add": 0, "bq_decode_add_flat": 0}
# launches by (wrapper, wire rows, rate) and by (wrapper, link level)
LAUNCH_SHAPES: collections.Counter = collections.Counter()
LAUNCH_LEVELS: collections.Counter = collections.Counter()
_level = "flat"     # process-wide, like the comms ledger

# value types the encode and decode kernels read and write themselves
# (codes of csrc/bq.cu's bq_encode / bq_decode)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# plain PyTorch versions of the kernels: the CPU path, and the yardstick
# the kernels are compared with on the card.  On meta tensors (a trace on
# shapes alone, the dry-run's) they give their results' shapes and types
# without the arithmetic, which could only propagate shapes there.

def _meta(*ts) -> bool:
    return any(t is not None and t.device.type == "meta" for t in ts)


def _meta_wire(lead: tuple, bits: int, like):
    """Empty meta wire planes ``(q_hi, q_lo | None, scale)`` of rows
    ``lead``."""
    q_hi = like.new_empty(lead + (hi_width(bits),), dtype=hi_dtype(bits))
    q_lo = like.new_empty(lead + (BLOCK,), dtype=torch.uint8) \
        if bits == 24 else None
    return q_hi, q_lo, like.new_empty(lead + (1,), dtype=torch.float32)


def encode_plain(x: torch.Tensor, bits: int):
    if _meta(x):
        ref._check_bits(bits)
        return _meta_wire(tuple(x.shape[:-1]), bits, x)
    return ref.bq_encode_ref(x, bits)


def decode_plain(q_hi, q_lo, scale, bits: int) -> torch.Tensor:
    if _meta(q_hi, scale):
        ref._check_bits(bits)
        return scale.new_empty(tuple(scale.shape[:-1]) + (BLOCK,))
    return ref.bq_decode_ref(q_hi, q_lo, scale, bits)


def gather_decode_plain(q_hi, q_lo, scale, idx, bits: int) -> torch.Tensor:
    if _meta(q_hi, scale, idx):
        ref._check_bits(bits)
        return scale.new_empty(tuple(idx.shape) + tuple(scale.shape[1:-1])
                               + (BLOCK,))
    return ref.bq_gather_decode_ref(q_hi, q_lo, scale, idx, bits)


def decode_add_encode_plain(q_hi, q_lo, scale, local, bits: int):
    if _meta(q_hi, scale, local):
        ref._check_bits(bits)
        return (*_meta_wire(tuple(local.shape[:-1]), bits, local),
                local.new_empty(local.shape, dtype=torch.float32))
    return ref.bq_decode_add_encode_ref(q_hi, q_lo, scale, local, bits)


def decode_add_plain(q_hi, q_lo, scale, local, bits: int) -> torch.Tensor:
    if _meta(q_hi, scale, local):
        ref._check_bits(bits)
        return local.new_empty(local.shape, dtype=torch.float32)
    return ref.bq_decode_add_ref(q_hi, q_lo, scale, local, bits)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()
    LAUNCH_LEVELS.clear()


def set_launch_level(level: str) -> str:
    """Count the launches that follow under ``level`` ("flat", "inner" or
    "outer"); returns the level it replaces."""
    global _level
    prev, _level = _level, level
    return prev


def launch_shapes() -> list:
    """``[(wrapper, rows, rate, launches), ...]`` since the last reset."""
    return sorted((*k, v) for k, v in LAUNCH_SHAPES.items())


def padded_rows(n: int) -> int:
    """Number of BLOCK-wide rows after padding n elements to whole tiles."""
    tile = TILE_M * BLOCK
    return max(-(-n // tile), 1) * tile // BLOCK


def to_blocks(x: torch.Tensor) -> torch.Tensor:
    """Flatten + zero-pad to an (M, 128) f32 block matrix."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    m = padded_rows(n)
    flat = torch.nn.functional.pad(flat, (0, m * BLOCK - n))
    return flat.reshape(m, BLOCK)


def gathered_shape(shape, shards: int, axis_dim: int) -> tuple:
    out = list(shape)
    out[axis_dim] *= shards
    return tuple(out)


def ungather(blocks: torch.Tensor, shape, dtype, axis_dim: int):
    """``[S, M, 128]`` decoded blocks of S shards of ``shape`` -> the shards
    joined along ``axis_dim`` in ``dtype``: each shard's tile padding
    stripped before the shards are joined."""
    s, n = blocks.shape[0], math.prod(shape)
    parts = blocks.reshape(s, -1)[:, :n].reshape((s,) + tuple(shape)) \
        .to(dtype)
    return torch.movedim(parts, 0, axis_dim).reshape(
        gathered_shape(shape, s, axis_dim))


def encode_flat_plain(x: torch.Tensor, bits: int):
    """:func:`bq_encode_flat`'s plain version: cast, pad, encode."""
    return encode_plain(to_blocks(x), bits)


def decode_flat_plain(q_hi, q_lo, scale, bits: int, n: int,
                      dtype=torch.float32, shards: int = 1,
                      inner: int | None = None) -> torch.Tensor:
    """:func:`bq_decode_flat`'s plain version: decode the blocks, then
    :func:`ungather`."""
    rows = lambda t: None if t is None else t.reshape(-1, t.shape[-1])  # noqa: E731
    blocks = decode_plain(rows(q_hi), rows(q_lo), rows(scale), bits)
    inner = (n or 1) if inner is None else inner
    return ungather(blocks.reshape(shards, -1, BLOCK), (n // inner, inner),
                    dtype, 1).reshape(-1)


class ShardView(collections.namedtuple(
        "ShardView", "x shards index inner lo hi")):
    """Chunk ``index`` of a payload split ``shards`` ways along an axis,
    read in place: ``x`` is the payload flat (contiguous, f32, bf16 or
    f16), ``inner`` the chunk's trailing size from that axis on, so the
    chunk's value f is ``x[(f // inner) * shards * inner + index * inner +
    f % inner]`` (the layout ``bq_decode_flat`` writes).  ``[lo, hi)`` is a
    range of the chunk's tile-padded 128-value rows; values past the chunk
    read as 0."""

    @property
    def n(self) -> int:
        """Values of the chunk."""
        return self.x.numel() // self.shards

    @property
    def rows(self) -> int:
        return self.hi - self.lo


def shard_view(x: torch.Tensor, axis_dim: int, shards: int, index: int,
               lo: int = 0, hi: int | None = None) -> ShardView:
    """Chunk ``index`` of ``x`` split ``shards`` ways along ``axis_dim``,
    rows ``[lo, hi)`` (all of them by default).  Types other than f32,
    bf16 and f16 are cast to f32 by torch; a non-contiguous x is copied."""
    s = x.shape[axis_dim]
    if s % shards or not 0 <= index < shards:
        raise ValueError(f"dim {axis_dim} of size {s} has no chunk {index} "
                         f"of {shards}")
    flat = x.reshape(-1)
    if flat.dtype not in _DTYPE_CODE:
        flat = flat.to(torch.float32)
    m = padded_rows(flat.numel() // shards)
    hi = m if hi is None else hi
    if not 0 <= lo <= hi <= m:
        raise ValueError(f"rows [{lo}, {hi}) outside the chunk's {m}")
    inner = (s // shards) * math.prod(x.shape[axis_dim + 1:])
    return ShardView(flat.contiguous(), shards, index, max(inner, 1), lo, hi)


def view_rows(view: ShardView) -> torch.Tensor:
    """The view's rows as ``(hi - lo, 128)`` f32 blocks, values past the
    chunk 0: the plain read, equal to rows ``[lo, hi)`` of the chunk's
    ``to_blocks``."""
    n = view.n
    chunk = view.x.reshape(-1, view.shards, view.inner)[:, view.index]
    a, b = view.lo * BLOCK, min(view.hi * BLOCK, n)
    out = torch.zeros(view.rows * BLOCK, dtype=torch.float32,
                      device=view.x.device)
    if b > a:
        out[:b - a] = chunk.reshape(-1)[a:b]
    return out.reshape(-1, BLOCK)


def decode_add_flat_plain(q_hi, q_lo, scale, view: ShardView, bits: int,
                          out: torch.Tensor) -> torch.Tensor:
    """:func:`bq_decode_add_flat`'s plain version: decode-add onto the
    view's rows, then write the chunk's values of them into ``out`` in its
    type."""
    acc = decode_add_plain(q_hi, q_lo, scale, view_rows(view), bits)
    a, b = view.lo * BLOCK, min(view.hi * BLOCK, view.n)
    if b > a:
        out.view(-1)[a:b] = acc.reshape(-1)[:b - a].to(out.dtype)
    return out


def gather_decode_flat_plain(q_hi, q_lo, scale, idx, bits: int,
                             dtype=torch.float32, width: int | None = None):
    """:func:`bq_gather_decode`'s plain version with ``dtype`` and
    ``width``: gather-decode, join each token's rows, keep its first
    ``width`` values, cast."""
    dec = gather_decode_plain(q_hi, q_lo, scale, idx, bits).flatten(-2)
    return dec[..., :dec.shape[-1] if width is None else width].to(dtype)


def hi_dtype(bits: int) -> torch.dtype:
    return {4: torch.uint8, 8: torch.int8, 16: torch.int16, 24: torch.int16}[bits]


def hi_width(bits: int) -> int:
    """Lane width of the q_hi plane (rate 4 nibble-packs 2 values/byte)."""
    return BLOCK // 2 if bits == 4 else BLOCK


# --------------------------------------------------------------------------
# build + binding
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): "
                       "the kernels are built from source at first use")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` per source, all started
    together) and link them into one shared library keyed by a hash of the
    sources and flags; reuse it only when the hash matches."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(_COMPILE_FLAGS + _LINK_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = _BUILD / h.hexdigest()[:16]
    so = out_dir / "libbq.so"
    if so.exists():
        if build_info.get("path") != str(so):    # keep this process's build
            build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    cus = [p for p in srcs if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in cus]
    cmds = [[nvcc, *_COMPILE_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(cus, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    log = "".join(o + e for o, e in outs)
    failed = [(c, p.returncode, e) for c, p, (_, e) in zip(cmds, procs, outs)
              if p.returncode != 0]
    tmp = out_dir / f"libbq.{tag}.so"
    if not failed:
        link = [nvcc, *_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append((link, proc.returncode, proc.stderr))
    secs = time.perf_counter() - t0
    (out_dir / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        cmd, rc, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}")
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=secs, cached=False, log=log)
    return so


def _load():
    lib = _lib
    if lib is not None:                 # loaded: no lock per call
        return lib
    return _load_locked()


def _load_locked():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
            lib.bq_encode.argtypes = [vp, i, ll, i, vp, vp, vp, ll, i, f, vp]
            lib.bq_decode.argtypes = [vp, vp, vp, vp, i, ll, ll, ll, ll, i,
                                      f, vp]
            lib.bq_decode_add_encode.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                 vp, ll, i, f, f, vp]
            lib.bq_decode_add.argtypes = [vp, vp, vp, vp, vp, ll, i, f, vp]
            lib.bq_encode_view.argtypes = [vp, i, ll, ll, ll, ll, ll, vp, vp,
                                           vp, ll, i, f, vp]
            lib.bq_decode_add_encode_view.argtypes = [
                vp, vp, vp, vp, i, ll, ll, ll, ll, ll, vp, vp, vp, ll, i, f,
                f, vp]
            lib.bq_decode_add_view.argtypes = [vp, vp, vp, vp, i, ll, ll, ll,
                                               ll, ll, ll, vp, i, f, vp]
            lib.bq_gather_decode.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll,
                                             ll, vp, i, i, f, vp]
            for fn in (lib.bq_encode, lib.bq_decode, lib.bq_gather_decode,
                       lib.bq_decode_add_encode, lib.bq_decode_add,
                       lib.bq_encode_view, lib.bq_decode_add_encode_view,
                       lib.bq_decode_add_view):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _stream(index: int) -> int:
    """Handle of the current stream of CUDA device ``index``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:                 # no Stream object built per call
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(name: str, rows: int, bits: int, t: torch.Tensor, fn,
            *args) -> None:
    """Call C entry ``fn`` on ``t``'s device and current stream (the stream
    is appended to ``args``); raise on a CUDA error, count the launch and
    its (rows, rate)."""
    index = t.device.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(t.device):
            return _launch(name, rows, bits, t, fn, *args)
    rc = fn(*args, _stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, rows, bits)] += 1
    LAUNCH_LEVELS[(name, _level)] += 1


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check(t, name: str, dtype, shape=None, align: int = 4) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _on_cpu(*ts) -> bool:
    """Whether the plain version runs: on CPU tensors, or on meta tensors
    (a shape-only trace, where it propagates shapes alone).  CUDA tensors
    run the kernel; a mix of devices raises."""
    devs = {t.device.type for t in ts if t is not None}
    if devs in ({"cpu"}, {"meta"}):
        return True
    if devs != {"cuda"}:
        raise ValueError(f"bq kernels take all-CPU, all-meta or all-CUDA "
                         f"tensors, got devices {sorted(devs)}")
    return False


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _wire_empty(m: int, bits: int, dev):
    """Fresh ``(q_hi, q_lo | None, scale)`` planes of ``m`` rows."""
    q_hi = torch.empty((m, hi_width(bits)), dtype=hi_dtype(bits), device=dev)
    q_lo = (torch.empty((m, BLOCK), dtype=torch.uint8, device=dev)
            if bits == 24 else None)
    return q_hi, q_lo, torch.empty((m, 1), dtype=torch.float32, device=dev)


def _encode(name: str, flat: torch.Tensor, m: int, bits: int):
    """Launch the encode kernel on the 1-D contiguous ``flat`` (f32, bf16
    or f16) into ``m`` fresh wire rows."""
    q_hi, q_lo, scale = _wire_empty(m, bits, flat.device)
    ptr = flat.data_ptr()
    _launch(name, m, bits, flat, _load().bq_encode, ptr,
            _DTYPE_CODE[flat.dtype], flat.shape[0], ptr % 16 == 0,
            q_hi.data_ptr(), _ptr(q_lo), scale.data_ptr(), m, bits,
            float(_QMAX[bits]))
    return q_hi, q_lo, scale


def bq_encode(x2d: torch.Tensor, bits: int):
    """``(M, 128)`` f32 -> ``(q_hi, q_lo | None, scale)``."""
    ref._check_bits(bits)
    if _on_cpu(x2d):
        return encode_plain(x2d, bits)
    if x2d.dim() != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"x2d must be (M, {BLOCK}), got {tuple(x2d.shape)}")
    _check(x2d, "x2d", torch.float32, align=16)
    m = x2d.shape[0]
    if not m:
        return _wire_empty(0, bits, x2d.device)
    return _encode("bq_encode", x2d.reshape(-1), m, bits)


def bq_encode_flat(x: torch.Tensor, bits: int):
    """Tensor of any shape holding n values -> ``(q_hi, q_lo | None,
    scale)`` of ``padded_rows(n)`` rows, equal to ``bq_encode(to_blocks(x),
    bits)``, in one launch.  bf16, f16 and f32 are read as they are and
    converted in registers (exact); values past n encode as the zero
    padding.  Other types (the int32 positions of ``tp@attn_pos``) are cast
    to f32 by torch first.  A non-contiguous x is copied to a contiguous
    one first; a base that is not 16-byte aligned is read value by
    value."""
    ref._check_bits(bits)
    if _on_cpu(x):
        return encode_flat_plain(x, bits)
    flat = x.reshape(-1)
    if flat.dtype not in _DTYPE_CODE:
        flat = flat.to(torch.float32)
    return _encode("bq_encode_flat", flat.contiguous(),
                   padded_rows(flat.shape[0]), bits)


def _view_args(view: ShardView) -> tuple:
    """The C entries' view arguments: payload pointer, type code, chunk
    values, shards, chunk index, inner size, first chunk value."""
    return (view.x.data_ptr(), _DTYPE_CODE[view.x.dtype], view.n,
            view.shards, view.index, view.inner, view.lo * BLOCK)


def bq_encode_view(view: ShardView, bits: int):
    """The view's rows encoded -> ``(q_hi, q_lo | None, scale)`` of
    ``view.rows`` rows, equal to ``bq_encode(view_rows(view), bits)``, in
    one launch: the reduce-scatter's first hop, reading its chunk in place
    (values converted in registers, the padding read as 0)."""
    ref._check_bits(bits)
    if _on_cpu(view.x):
        return encode_plain(view_rows(view), bits)
    m = view.rows
    q_hi, q_lo, scale = _wire_empty(m, bits, view.x.device)
    if m:
        _launch("bq_encode_view", m, bits, view.x, _load().bq_encode_view,
                *_view_args(view), q_hi.data_ptr(), _ptr(q_lo),
                scale.data_ptr(), m, bits, float(_QMAX[bits]))
    return q_hi, q_lo, scale


def _check_planes(q_hi, q_lo, scale, bits: int, lead: tuple) -> None:
    _check(q_hi, "q_hi", hi_dtype(bits), lead + (hi_width(bits),), align=8)
    if bits == 24:
        if q_lo is None:
            raise ValueError("rate 24 needs the q_lo plane")
        _check(q_lo, "q_lo", torch.uint8, lead + (BLOCK,), align=4)
    elif q_lo is not None:
        raise ValueError(f"rate {bits} has no q_lo plane")
    _check(scale, "scale", torch.float32, lead + (1,))


def _decode(name: str, q_hi, q_lo, scale, bits: int, out: torch.Tensor,
            m: int, n: int, shards: int, inner: int) -> torch.Tensor:
    """Launch the decode kernel from checked planes of ``shards * m`` rows
    into the fresh ``out`` (f32, bf16 or f16)."""
    if out.numel():
        _launch(name, shards * m, bits, q_hi, _load().bq_decode,
                q_hi.data_ptr(), _ptr(q_lo), scale.data_ptr(), out.data_ptr(),
                _DTYPE_CODE[out.dtype], m, n, shards, inner, bits,
                _INV_QMAX[bits])
    return out


def bq_decode(q_hi, q_lo, scale, bits: int) -> torch.Tensor:
    """Wire planes ``(M, w)`` + scale ``(M, 1)`` -> ``(M, 128)`` f32."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale):
        return decode_plain(q_hi, q_lo, scale, bits)
    m = q_hi.shape[0]
    _check_planes(q_hi, q_lo, scale, bits, (m,))
    out = torch.empty((m, BLOCK), dtype=torch.float32, device=q_hi.device)
    return _decode("bq_decode", q_hi, q_lo, scale, bits, out, m, m * BLOCK, 1,
                   m * BLOCK)


def bq_decode_flat(q_hi, q_lo, scale, bits: int, n: int,
                   dtype=torch.float32, shards: int = 1,
                   inner: int | None = None) -> torch.Tensor:
    """Wire planes of ``shards`` encodes of n values each, stacked on a
    leading axis (``(S, M, w)``; ``(M, w)`` for one) -> the ``S * n``
    values, 1-D, in ``dtype``, in one launch: shard s's value f goes to
    ``(f // inner) * S * inner + s * inner + f % inner``.  That is
    ``decode(planes).reshape(S, -1)[:, :n].reshape((S,) + shape).to(dtype)``
    moved to put the shard axis before the axis whose trailing size is
    ``inner = prod(shape[axis_dim:])`` and flattened: the compressed
    all-gather's tail (with one shard, ``from_blocks``).  bf16, f16 and f32
    are written by the kernel (rounded to nearest even, as ``.to()``);
    other types are decoded to f32 and cast by torch.  At most 65535
    shards (the kernel's grid has one row of blocks per shard)."""
    ref._check_bits(bits)
    inner = (n or 1) if inner is None else inner
    if n < 0 or inner <= 0 or n % inner or not 1 <= shards <= 65535:
        raise ValueError(f"bad layout: n={n}, inner={inner}, shards={shards}")
    if _on_cpu(q_hi, q_lo, scale):
        return decode_flat_plain(q_hi, q_lo, scale, bits, n, dtype, shards,
                                 inner)
    lead = tuple(scale.shape[:-1])
    _check_planes(q_hi, q_lo, scale, bits, lead)
    rows = scale.numel()
    m = rows // shards
    if rows != m * shards or n > m * BLOCK:
        raise ValueError(f"{rows} wire rows do not hold {shards} shards of "
                         f"{n} values")
    kind = dtype if dtype in _DTYPE_CODE else torch.float32
    out = torch.empty(shards * n, dtype=kind, device=q_hi.device)
    out = _decode("bq_decode_flat", q_hi, q_lo, scale, bits, out, m, n,
                  shards, inner)
    return out if kind == dtype else out.to(dtype)


def bq_gather_decode(q_hi, q_lo, scale, idx: torch.Tensor, bits: int,
                     dtype=None, width: int | None = None) -> torch.Tensor:
    """Pool planes ``(n_blocks, ..., w)`` gathered by the int32 block table
    ``idx`` (any shape) and decoded -> f32 ``idx.shape + pool.shape[1:-1] +
    (128,)``.  With ``dtype`` or ``width`` (the paged KV read): pool planes
    ``(n_blocks, ..., R, w)`` of R rows per token -> ``idx.shape +
    pool.shape[1:-2] + (width,)`` in ``dtype`` (f32, bf16 or f16; f32 by
    default), each token's first ``width`` values (all ``R * 128`` by
    default), in one launch.  On the card an id outside ``[0, n_blocks)``
    decodes to NaN without reading the pool."""
    ref._check_bits(bits)
    flat = dtype is not None or width is not None
    if flat:
        dtype = torch.float32 if dtype is None else dtype
        width = scale.shape[-2] * BLOCK if width is None else width
    if _on_cpu(q_hi, q_lo, scale, idx):
        if flat:
            return gather_decode_flat_plain(q_hi, q_lo, scale, idx, bits,
                                            dtype, width)
        return gather_decode_plain(q_hi, q_lo, scale, idx, bits)
    lead = tuple(scale.shape[:-1])
    _check_planes(q_hi, q_lo, scale, bits, lead)
    _check(idx, "idx", torch.int32)
    n_blocks, n_idx = lead[0], idx.numel()
    rows_per_block = math.prod(lead[1:])
    if flat:
        if dtype not in _DTYPE_CODE or len(lead) < 2 or \
                not 0 <= width <= lead[-1] * BLOCK:
            raise ValueError(f"bad KV read: dtype {dtype}, width {width} "
                             f"of pool rows {lead}")
        tokens, rows, shape = math.prod(lead[1:-1]), lead[-1], lead[1:-1]
    else:               # whole pool rows in f32: one row a token
        dtype, width, tokens, rows, shape = (torch.float32, BLOCK,
                                             rows_per_block, 1, lead[1:])
    out = torch.empty(tuple(idx.shape) + shape + (width,), dtype=dtype,
                      device=q_hi.device)
    if out.numel():
        _launch("bq_gather_decode", n_idx * rows_per_block, bits, q_hi,
                _load().bq_gather_decode, q_hi.data_ptr(), _ptr(q_lo),
                scale.data_ptr(), idx.data_ptr(), out.numel(), n_blocks,
                tokens, rows, width, out.data_ptr(), _DTYPE_CODE[dtype],
                bits, _INV_QMAX[bits])
    return out


def _check_local(local, m: int) -> None:
    _check(local, "local", torch.float32, (m, BLOCK), align=16)


def bq_decode_add_encode(q_hi, q_lo, scale, local, bits: int,
                         want_sum: bool = True):
    """Fused ring hop: wire planes ``(M, w)`` + local ``(M, 128)`` f32 ->
    ``(q_hi', q_lo' | None, scale', sum | None)``; ``want_sum=False`` is the
    wire-only form, which never writes the f32 sum."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale, local):
        hi, lo, sc, s = decode_add_encode_plain(q_hi, q_lo, scale, local, bits)
        return hi, lo, sc, s if want_sum else None
    m = q_hi.shape[0]
    _check_planes(q_hi, q_lo, scale, bits, (m,))
    _check_local(local, m)
    dev = q_hi.device
    o_hi, o_lo, o_scale = _wire_empty(m, bits, dev)
    s = (torch.empty((m, BLOCK), dtype=torch.float32, device=dev)
         if want_sum else None)
    if m:
        _launch("bq_decode_add_encode" if want_sum
                else "bq_decode_add_encode_wire", m, bits, q_hi,
                _load().bq_decode_add_encode, q_hi.data_ptr(), _ptr(q_lo),
                scale.data_ptr(), local.data_ptr(), o_hi.data_ptr(),
                _ptr(o_lo), o_scale.data_ptr(), _ptr(s), m, bits,
                float(_QMAX[bits]), _INV_QMAX[bits])
    return o_hi, o_lo, o_scale, s


def bq_decode_add_encode_view(q_hi, q_lo, scale, view: ShardView,
                              bits: int):
    """Wire-only fused ring hop with the local rows read through ``view``:
    wire planes ``(view.rows, w)`` -> ``(q_hi', q_lo' | None, scale')``,
    equal to ``bq_decode_add_encode(..., view_rows(view), bits,
    want_sum=False)`` (a middle reduce-scatter hop)."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale, view.x):
        return decode_add_encode_plain(q_hi, q_lo, scale, view_rows(view),
                                       bits)[:3]
    m = view.rows
    _check_planes(q_hi, q_lo, scale, bits, (m,))
    o_hi, o_lo, o_scale = _wire_empty(m, bits, q_hi.device)
    if m:
        _launch("bq_decode_add_encode_view", m, bits, q_hi,
                _load().bq_decode_add_encode_view, q_hi.data_ptr(),
                _ptr(q_lo), scale.data_ptr(), *_view_args(view),
                o_hi.data_ptr(), _ptr(o_lo), o_scale.data_ptr(), m, bits,
                float(_QMAX[bits]), _INV_QMAX[bits])
    return o_hi, o_lo, o_scale


def bq_decode_add(q_hi, q_lo, scale, local, bits: int) -> torch.Tensor:
    """Last reduce-scatter hop: ``local + decode(wire)`` -> ``(M, 128)`` f32."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale, local):
        return decode_add_plain(q_hi, q_lo, scale, local, bits)
    m = q_hi.shape[0]
    _check_planes(q_hi, q_lo, scale, bits, (m,))
    _check_local(local, m)
    out = torch.empty((m, BLOCK), dtype=torch.float32, device=q_hi.device)
    if m:
        _launch("bq_decode_add", m, bits, q_hi, _load().bq_decode_add,
                q_hi.data_ptr(), _ptr(q_lo), scale.data_ptr(),
                local.data_ptr(), out.data_ptr(), m, bits, _INV_QMAX[bits])
    return out


def bq_decode_add_flat(q_hi, q_lo, scale, view: ShardView, bits: int,
                       out: torch.Tensor) -> torch.Tensor:
    """The last reduce-scatter hop fused with its layout: wire planes
    ``(view.rows, w)`` decoded and added to the view's rows (read in
    place), the sums of the chunk's values ``[128 lo, min(128 hi, n))``
    written in ``out``'s type (rounded to nearest even, as ``.to()``) to
    their places in ``out``, the chunk-shaped output (contiguous, n
    values, the view's type).  Equal to ``from_blocks(bq_decode_add(...,
    view_rows(view), bits), ...)`` on those values, in one launch; returns
    ``out``."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale, view.x, out):
        return decode_add_flat_plain(q_hi, q_lo, scale, view, bits, out)
    m = view.rows
    _check_planes(q_hi, q_lo, scale, bits, (m,))
    _check(out, "out", view.x.dtype, align=16)
    if out.numel() != view.n:
        raise ValueError(f"out holds {out.numel()} values, the chunk "
                         f"{view.n}")
    f_lo, f_hi = view.lo * BLOCK, min(view.hi * BLOCK, view.n)
    if f_hi > f_lo:
        _launch("bq_decode_add_flat", m, bits, q_hi,
                _load().bq_decode_add_view, q_hi.data_ptr(), _ptr(q_lo),
                scale.data_ptr(), *_view_args(view), f_hi, out.data_ptr(),
                bits, _INV_QMAX[bits])
    return out
