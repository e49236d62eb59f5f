"""Hopper kernels for the block-quantization (bq) codec, with their plain
PyTorch versions beside them.

Five kernels, hand-written in CUDA C++ for ``sm_90a`` (``csrc/bq.cu``):

* :func:`bq_encode` replaces ``repro/kernels/bq.py::bq_encode_pallas``
  (``_encode_kernel``/``_encode24_kernel``): ``(M, 128)`` f32 -> wire planes.
* :func:`bq_decode` replaces ``bq_decode_pallas``
  (``_decode_kernel``/``_decode24_kernel``): wire planes -> ``(M, 128)`` f32.
* :func:`bq_gather_decode` replaces ``bq_gather_decode_pallas``: decodes the
  pool rows named by a block table, reading the table inside the kernel.
* :func:`bq_decode_add_encode` replaces ``bq_decode_add_encode_pallas``,
  the fused ring hop ``encode(local + decode(wire))``: with the f32 sum
  (``_dae_kernel``/``_dae24_kernel``, the all-reduce tail) or wire-only
  (``_daew_kernel``/``_daew24_kernel``, intermediate reduce-scatter hops).
* :func:`bq_decode_add` replaces ``bq_decode_add_pallas``
  (``_da_kernel``/``_da24_kernel``), the last reduce-scatter hop
  ``local + decode(wire)``.

All five move a few bytes per flop, so on an H100 they are bound by bytes
moved over 3.35 TB/s.  The kernels give each 128-value row to one warp,
read and write every byte once with coalesced vector accesses, and keep
the gathered planes out of device memory (see the source note in
``csrc/bq.cu``).

Dispatch is by the tensor's device: a CPU tensor goes to the plain version
(:mod:`repro_torch.kernels.ref`), a CUDA tensor launches the kernel or
raises.  There is no fallback from the card to the plain version.  The
library is built with ``nvcc`` on first use, from ``csrc/`` only (this
file's kernels and those of :mod:`repro_torch.kernels.lowrank`), into
``_build/<hash of the sources>/`` beside this file.

``LAUNCHES`` counts kernel launches per wrapper; it is incremented right
where the kernel launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
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

LAUNCHES = {"bq_encode": 0, "bq_decode": 0, "bq_gather_decode": 0,
            "bq_decode_add_encode": 0, "bq_decode_add_encode_wire": 0,
            "bq_decode_add": 0}

# plain PyTorch versions of the three kernels: the CPU path, and the
# yardstick the kernels are compared with on the card
encode_plain = ref.bq_encode_ref
decode_plain = ref.bq_decode_ref
gather_decode_plain = ref.bq_gather_decode_ref
decode_add_encode_plain = ref.bq_decode_add_encode_ref
decode_add_plain = ref.bq_decode_add_ref


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
            lib.bq_encode.argtypes = [vp, vp, vp, vp, ll, i, f, vp]
            lib.bq_decode.argtypes = [vp, vp, vp, vp, ll, i, f, vp]
            lib.bq_gather_decode.argtypes = [vp, vp, vp, vp, ll, ll, ll, vp,
                                             i, f, vp]
            lib.bq_decode_add_encode.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                 vp, ll, i, f, f, vp]
            lib.bq_decode_add.argtypes = [vp, vp, vp, vp, vp, ll, i, f, vp]
            for fn in (lib.bq_encode, lib.bq_decode, lib.bq_gather_decode,
                       lib.bq_decode_add_encode, lib.bq_decode_add):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _launch(name: str, t: torch.Tensor, fn, *args) -> None:
    """Call C entry ``fn`` on ``t``'s device and current stream (the stream
    is appended to ``args``); raise on a CUDA error, count the launch."""
    if torch.cuda.current_device() != t.device.index:
        with torch.cuda.device(t.device):
            return _launch(name, t, fn, *args)
    rc = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


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
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"}:
        raise ValueError(f"bq kernels take all-CPU or all-CUDA tensors, "
                         f"got devices {sorted(devs)}")
    return False


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def bq_encode(x2d: torch.Tensor, bits: int):
    """``(M, 128)`` f32 -> ``(q_hi, q_lo | None, scale)``."""
    ref._check_bits(bits)
    if _on_cpu(x2d):
        return encode_plain(x2d, bits)
    if x2d.dim() != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"x2d must be (M, {BLOCK}), got {tuple(x2d.shape)}")
    _check(x2d, "x2d", torch.float32, align=16)
    m, dev = x2d.shape[0], x2d.device
    q_hi = torch.empty((m, hi_width(bits)), dtype=hi_dtype(bits), device=dev)
    q_lo = (torch.empty((m, BLOCK), dtype=torch.uint8, device=dev)
            if bits == 24 else None)
    scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    if m:
        _launch("bq_encode", x2d, _load().bq_encode, x2d.data_ptr(),
                q_hi.data_ptr(), _ptr(q_lo), scale.data_ptr(), m, bits,
                float(_QMAX[bits]))
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


def bq_decode(q_hi, q_lo, scale, bits: int) -> torch.Tensor:
    """Wire planes ``(M, w)`` + scale ``(M, 1)`` -> ``(M, 128)`` f32."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale):
        return decode_plain(q_hi, q_lo, scale, bits)
    m = q_hi.shape[0]
    _check_planes(q_hi, q_lo, scale, bits, (m,))
    out = torch.empty((m, BLOCK), dtype=torch.float32, device=q_hi.device)
    if m:
        _launch("bq_decode", q_hi, _load().bq_decode, q_hi.data_ptr(),
                _ptr(q_lo), scale.data_ptr(), out.data_ptr(), m, bits,
                _INV_QMAX[bits])
    return out


def bq_gather_decode(q_hi, q_lo, scale, idx: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """Pool planes ``(n_blocks, ..., w)`` gathered by the int32 block table
    ``idx`` (any shape) and decoded -> f32 ``idx.shape + pool.shape[1:-1] +
    (128,)``.  On the card an id outside ``[0, n_blocks)`` decodes to NaN
    without reading the pool."""
    ref._check_bits(bits)
    if _on_cpu(q_hi, q_lo, scale, idx):
        return gather_decode_plain(q_hi, q_lo, scale, idx, bits)
    lead = tuple(scale.shape[:-1])
    _check_planes(q_hi, q_lo, scale, bits, lead)
    _check(idx, "idx", torch.int32)
    n_blocks = lead[0]
    rows_per_block = 1
    for d in lead[1:]:
        rows_per_block *= d
    out = torch.empty(tuple(idx.shape) + lead[1:] + (BLOCK,),
                      dtype=torch.float32, device=q_hi.device)
    n_idx = idx.numel()
    if n_idx and rows_per_block:
        _launch("bq_gather_decode", q_hi, _load().bq_gather_decode,
                q_hi.data_ptr(), _ptr(q_lo), scale.data_ptr(),
                idx.data_ptr(), n_idx, n_blocks, rows_per_block,
                out.data_ptr(), bits, _INV_QMAX[bits])
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
    o_hi = torch.empty((m, hi_width(bits)), dtype=hi_dtype(bits), device=dev)
    o_lo = (torch.empty((m, BLOCK), dtype=torch.uint8, device=dev)
            if bits == 24 else None)
    o_scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    s = (torch.empty((m, BLOCK), dtype=torch.float32, device=dev)
         if want_sum else None)
    if m:
        _launch("bq_decode_add_encode" if want_sum
                else "bq_decode_add_encode_wire", q_hi,
                _load().bq_decode_add_encode, q_hi.data_ptr(), _ptr(q_lo),
                scale.data_ptr(), local.data_ptr(), o_hi.data_ptr(),
                _ptr(o_lo), o_scale.data_ptr(), _ptr(s), m, bits,
                float(_QMAX[bits]), _INV_QMAX[bits])
    return o_hi, o_lo, o_scale, s


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
        _launch("bq_decode_add", q_hi, _load().bq_decode_add,
                q_hi.data_ptr(), _ptr(q_lo), scale.data_ptr(),
                local.data_ptr(), out.data_ptr(), m, bits, _INV_QMAX[bits])
    return out
