"""Low-rank projection kernels for the ``plr`` codec family (port of
``repro.kernels.lowrank``).

PowerSGD-style gradient compression (arXiv:1905.13727) factors a gradient
matrix ``M (m, n)`` through a warm-started orthonormal factor ``Q (n, r)``::

    P  = M @ Q          (a) project onto the carried subspace
    P^ = orth(P)        modified Gram-Schmidt, r columns
    Q' = M^T @ P^       (b) back-project: the second wire factor
    M~ = P^ @ Q'^T      (c) reconstruction, rank <= r

The wire is ``r * (m + n)`` floats instead of ``m * n``.  ``Q`` is the
carried codec state.

:func:`matmul` replaces ``repro/kernels/lowrank.py::matmul_pallas``: on a
CUDA tensor it launches one of three hand-written Hopper kernels
(``csrc/lowrank.cu``), one per product form above, chosen from the
operands' shapes and layout:

* ``tall`` (a): ``a`` row-major with ``k <= 512``, ``n <= 64``;
* ``at_b`` (b): ``a`` the transpose of a row-major matrix (``mat.T``, a
  view: the kernel reads ``mat`` in its own layout, never a transposed
  copy), ``a.shape[0] <= 512``, ``n <= 64``; a deterministic two-pass
  reduction over the long dimension through scratch the wrapper allocates
  (fixed slabs of rows, each summed by row groups that stream ``mat`` and
  their rows of ``b`` through a cp.async ring, then a wide fixed-order sum
  over the slabs: :func:`at_b_slabs`, :func:`at_b_depth`);
* ``small_k`` (c): ``a`` row-major with ``k <= 64``, ``n <= 512`` a
  multiple of 4, and a 16-byte aligned output (float4 stores).

All three are f32 with an f32 accumulator on the CUDA cores (no TF32).  A
CPU tensor runs :func:`matmul_plain`; a CUDA tensor launches a kernel or
raises; ``backend="torch"`` (or ``ops.set_default_backend("torch")``)
forces the plain version.  The kernels sum in another order than the plain
version, so they are held to it within :func:`error_bound`, not bit for
bit; each repeats bit for bit from call to call.

``tall`` and ``small_k`` are one register-tiled f32 GEMM for a tall ``a``
times a small ``b``: each block keeps its columns of ``b`` in shared
memory (read from any strides, so ``q`` and ``q.T`` go in as they are),
streams row panels of ``a`` through shared memory by ``cp.async``, and
each thread keeps an up to 8 x 8 block of the output in registers.  At
r = 8 both are bound by device memory (about 2.2 GB at the training step's
view), and the design keeps the loads and the stores 16 bytes wide and
coalesced; at r = 64 both are bound by f32 FMA throughput (69 GFLOP), and
the register tile does 16 FMAs per 16-byte shared-memory load.  A row
slice of ``a`` that is not 16-byte aligned (``phat[r0:r1]`` at an odd
rank) loads 4 bytes at a time instead; nothing is refused for it.  Each
output is one serial chain of ``k`` FMAs in ``k`` order (no split-k), the
depth :func:`order_bound` counts.

``LAUNCHES`` counts kernel launches per form, incremented right where the
kernel launches and nowhere else.

:func:`init_factor` computes the reference's warm start ``Q0`` without
JAX: the same threefry2x32 bits and uniform draw as
``jax.random.normal(PRNGKey(0), ...)``, bit for bit, then an f64 inverse
error function (JAX's f32 one differs by a few ulps).
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from repro_torch.kernels import bq, ops

TILE_M = 8          # rows of the matrix view pad to a multiple of this
NCOLS_MIN = 128     # narrowest matrix view
NCOLS_MAX = 512     # widest matrix view of a flattened payload
MAX_RANK = 64       # widest factor the kernels take

_F32 = torch.float32
_U = 2.0 ** -24     # unit roundoff of f32

LAUNCHES = {"matmul_tall": 0, "matmul_at_b": 0, "matmul_small_k": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# matrix view of a flat payload (verbatim from the reference: these fix the
# wire bytes and the codec state's shape)
# --------------------------------------------------------------------------

def mat_shape(n: int) -> tuple[int, int]:
    """(rows, cols) of the near-square matrix view of ``n`` flat elements:
    cols is the power of two nearest sqrt(n) clamped to [NCOLS_MIN,
    NCOLS_MAX], rows pad up to a multiple of TILE_M."""
    ncols = NCOLS_MIN
    while ncols * ncols < n and ncols < NCOLS_MAX:
        ncols *= 2
    m = max(-(-n // ncols), 1)
    m = -(-m // TILE_M) * TILE_M
    return m, ncols


def rank_for(n: int, rank: int) -> int:
    """Requested rank clamped to the matrix view of ``n`` elements."""
    m, ncols = mat_shape(n)
    return max(1, min(rank, m, ncols))


def to_mat(flat: torch.Tensor) -> torch.Tensor:
    """1-D payload -> (m, ncols) f32 matrix view, zero-padded (a copy)."""
    n = flat.shape[0]
    m, ncols = mat_shape(n)
    return torch.nn.functional.pad(flat.to(_F32), (0, m * ncols - n)) \
        .reshape(m, ncols)


def from_mat(mat: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`to_mat` (strips the zero padding)."""
    return mat.reshape(-1)[:n]


# --------------------------------------------------------------------------
# the plain version and the bound the kernels are held to
# --------------------------------------------------------------------------

class _no_tf32:
    """Full f32 products on the card for the duration of a block."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev
        return False


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """f32 ``a @ b`` with an f32 accumulator, TF32 off (the reference's
    ``matmul_ref``); writes into ``out`` when given."""
    with _no_tf32():
        if out is None:
            return torch.matmul(a.to(_F32), b.to(_F32))
        return torch.matmul(a.to(_F32), b.to(_F32), out=out)


def error_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element bound on ``|kernel - plain|``: each side is a sum of
    ``k`` f32 products with at most ``k`` roundings in any order, so each
    is within ``gamma_k (|a| @ |b|)`` of the exact product, ``gamma_k = k u
    / (1 - k u)``, and the two within twice that."""
    k = a.shape[1]
    gamma = k * _U / (1 - k * _U)
    with _no_tf32():
        return 2 * gamma * torch.matmul(a.abs().double(), b.abs().double())


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _load():
    """The shared library ``bq.build`` compiles from every ``csrc`` source,
    with this module's entry points bound."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(bq.build()))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.lowrank_mm_tall.argtypes = [vp, ll, i, ll, vp, ll, ll, i, vp,
                                            ll, vp]
            lib.lowrank_mm_at_b.argtypes = [vp, ll, i, ll, vp, ll, i, vp, ll,
                                            vp, i, ll, vp]
            lib.lowrank_mm_small_k.argtypes = [vp, ll, i, ll, vp, ll, ll, i,
                                               vp, vp]
            for fn in (lib.lowrank_mm_tall, lib.lowrank_mm_at_b,
                       lib.lowrank_mm_small_k):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _launch(name: str, t: torch.Tensor, fn, *args) -> None:
    """Call C entry ``fn`` on ``t``'s device and current stream; raise on a
    CUDA error, count the launch."""
    if torch.cuda.current_device() != t.device.index:
        with torch.cuda.device(t.device):
            return _launch(name, t, fn, *args)
    rc = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _row_major(t: torch.Tensor) -> bool:
    return t.stride(1) == 1 and t.stride(0) >= max(t.shape[1], 1)


def _transposed(t: torch.Tensor) -> bool:
    """``t`` is the transpose of a row-major matrix (``mat.T``)."""
    return t.stride(0) == 1 and t.stride(1) >= max(t.shape[0], 1)


def form(a: torch.Tensor, b: torch.Tensor) -> str:
    """Which kernel takes ``a @ b`` on the card (see the module docstring);
    raises ``ValueError`` for shapes or layouts none of them takes."""
    m, k = a.shape
    n = b.shape[1]
    if _row_major(a) and k <= NCOLS_MAX and n <= MAX_RANK:
        return "tall"
    if _row_major(a) and k <= MAX_RANK and n <= NCOLS_MAX:
        return "small_k"
    if _transposed(a) and m <= NCOLS_MAX and n <= MAX_RANK:
        return "at_b"
    raise ValueError(
        f"lowrank kernels take a row-major (m, k<=512) @ (k, n<=64), a "
        f"row-major (m, k<=64) @ (k, n<=512) or a transposed row-major "
        f"(m<=512, K) @ (K, n<=64); got {tuple(a.shape)} with strides "
        f"{a.stride()} @ {tuple(b.shape)}")


# the at_b kernel's sum order (csrc/lowrank.cu, lowrank_mm_at_b): slabs of
# rows, one block each, summed by row groups (2 for the ladder's ranks n <=
# 8, one for wider n), then by pass 2's lanes
AT_B_SLAB_ROWS = 2048   # target rows per slab
AT_B_MAX_SLABS = 1024
AT_B_STAGE_ROWS = 8     # a block's rows per pipeline stage, either instance
AT_B_LANES = 16         # pass 2's lanes per output (AT_B_LANES in the .cu)


def at_b_slabs(rows: int) -> tuple[int, int]:
    """(slabs, rows per slab) of the ``at_b`` reduction over ``rows``: a
    function of the shape alone, so the sum order never depends on the
    card.  Rows per slab are a multiple of a pipeline stage; only the last
    slab is short, and none is empty."""
    slabs = max(1, min(AT_B_MAX_SLABS, -(-rows // AT_B_SLAB_ROWS)))
    per = -(-max(rows, 1) // slabs)
    per = -(-per // AT_B_STAGE_ROWS) * AT_B_STAGE_ROWS
    return -(-max(rows, 1) // per), per


def at_b_groups(n: int) -> int:
    """Row groups per slab of the ``at_b`` instance that takes ``n``
    columns of ``b``."""
    return 2 if n <= 8 else 1


def at_b_depth(rows: int, n: int) -> int:
    """Longest chain of f32 roundings into one ``at_b`` output: a group's
    FMAs over its share of a slab, the adds of the other groups' sums, a
    pass-2 lane's adds over its slabs, the adds of the other lanes."""
    slabs, per = at_b_slabs(rows)
    groups = at_b_groups(n)
    return per // groups + groups - 1 + -(-slabs // AT_B_LANES) \
        + AT_B_LANES - 1


def order_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element bound on ``|kernel - exact|`` for the kernel that takes
    ``a @ b`` (:func:`form`), from its own sum order: ``gamma_d (|a| @
    |b|)`` with ``d`` the longest chain of f32 roundings into one output
    (``tall`` and ``small_k``: ``k`` FMAs in one thread, in ``k`` order;
    ``at_b``: :func:`at_b_depth`), plus the f64 roundoff of the exact
    product it is held against.  Far tighter than :func:`error_bound` on a
    long reduction: ``at_b`` at the training step's 1051352 rows has ``d``
    = 1073 for ``n <= 8`` (1024 rows per group, 1 group add, 33 slabs per
    lane, 15 lane adds) and 2096 for wider ``n``, not 1051352."""
    kind, k = form(a, b), a.shape[1]
    d = k if kind in ("tall", "small_k") else at_b_depth(k, b.shape[1])
    gamma = d * _U / (1 - d * _U) + k * 2.0 ** -53 / (1 - k * 2.0 ** -53)
    with _no_tf32():
        return gamma * torch.matmul(a.abs().double(), b.abs().double())


def _check(t, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != _F32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")


def _matmul_kernel(a, b, out):
    m, k = a.shape
    n = b.shape[1]
    for t, nm in ((a, "a"), (b, "b")):
        _check(t, nm)
    if a.device != b.device:
        raise ValueError(f"a and b on different cards: {a.device}, {b.device}")
    if out is None:
        out = torch.empty((m, n), dtype=_F32, device=a.device)
    else:
        _check(out, "out")
        if tuple(out.shape) != (m, n) or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous ({m}, {n}) tensor, "
                             f"got {tuple(out.shape)}")
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    kind = form(a, b)
    lib = _load()
    if kind == "tall":
        _launch("matmul_tall", a, lib.lowrank_mm_tall, a.data_ptr(), m, k,
                a.stride(0), b.data_ptr(), b.stride(0), b.stride(1), n,
                out.data_ptr(), n)
    elif kind == "small_k":
        if n % 4 or out.data_ptr() % 16:
            raise ValueError(f"small_k stores float4: n must be a multiple "
                             f"of 4 and out 16-byte aligned, got n={n}, out "
                             f"at {out.data_ptr() % 16} bytes past 16")
        _launch("matmul_small_k", a, lib.lowrank_mm_small_k, a.data_ptr(),
                m, k, a.stride(0), b.data_ptr(), b.stride(0), b.stride(1), n,
                out.data_ptr())
    else:
        if not _row_major(b):
            raise ValueError("at_b: b must be row-major")
        slabs, per = at_b_slabs(k)
        kp = -(-m // 4) * 4
        part = torch.empty(slabs * n * kp, dtype=_F32, device=a.device)
        # a = mat.T: the kernel reads mat (k rows of m) in its own layout
        _launch("matmul_at_b", a, lib.lowrank_mm_at_b, a.data_ptr(), k, m,
                a.stride(1), b.data_ptr(), b.stride(0), n, out.data_ptr(), n,
                part.data_ptr(), slabs, per)
    return out


def _on_cpu(*ts) -> bool:
    """Whether the plain version runs: on CPU tensors, or on meta tensors
    (a shape-only trace, where it propagates shapes alone).  CUDA tensors
    run the kernel; a mix of devices raises."""
    devs = {t.device.type for t in ts if t is not None}
    if devs in ({"cpu"}, {"meta"}):
        return True
    if devs != {"cuda"}:
        raise ValueError(f"lowrank kernels take all-CPU, all-meta or all-CUDA "
                         f"tensors, got devices {sorted(devs)}")
    return False


def matmul(a: torch.Tensor, b: torch.Tensor, backend=None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """f32 ``(m, k) @ (k, n)``: the plain version on the CPU or under
    ``backend="torch"``, else one of the three kernels (see
    :func:`form`).  ``out`` receives the product when given."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul wants (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if _on_cpu(a, b, out) or ops._plain(backend):
        return matmul_plain(a, b, out)
    return _matmul_kernel(a, b, out)


# --------------------------------------------------------------------------
# orthonormalization + deterministic warm start
# --------------------------------------------------------------------------

def orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the (few) columns of ``p``, each column
    projected twice ("twice is enough").

    Rank-deficient inputs give zero columns instead of an arbitrary basis,
    so every rank's factors stay bit-identical (plain PyTorch reductions,
    deterministic on a given device).  The reference projects once: a
    dependent column whose f32 remainder lands just above its relative
    tolerance is then normalized into a direction far from orthogonal to
    the others, and the reconstruction of even an exactly low-rank payload
    goes wrong.  The second pass makes such a column orthogonal; on
    well-conditioned input it moves the factors by f32 roundoff."""
    if p.dim() != 2 or p.shape[0] < p.shape[1]:
        raise ValueError(f"orthonormalize wants a tall matrix, got "
                         f"{tuple(p.shape)}")
    cols = []
    for i in range(p.shape[1]):
        v = p[:, i]
        norm0 = torch.sqrt(torch.sum(v * v))
        for u in cols + cols:
            v = v - torch.sum(u * v) * u
        norm = torch.sqrt(torch.sum(v * v))
        # relative tolerance: a column that projections reduced to f32
        # roundoff of its original scale is linearly dependent; zero it
        # instead of normalizing the noise into a spurious direction
        v = torch.where(norm > 1e-6 * torch.clamp(norm0, min=1e-30),
                        v / torch.clamp(norm, min=1e-30), torch.zeros_like(v))
        cols.append(v)
    return torch.stack(cols, dim=1)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds), as ``jax.random`` computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform_draw(shape, minval, maxval) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(0), shape, float32, minval, maxval)``
    bit for bit (partitionable threefry: the counter is each element's
    flat index as two 32-bit words, the bits ``out0 ^ out1``)."""
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = _threefry2x32((0, 0), hi, lo)
    bits = (a ^ b) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    mn, mx = np.float32(minval), np.float32(maxval)
    return np.maximum(mn, f * (mx - mn) + mn).reshape(shape)


def init_factor(ncols: int, rank: int, device="cpu") -> torch.Tensor:
    """Deterministic warm-start factor Q0 (ncols, rank): the reference's
    orthonormalized standard normals from ``PRNGKey(0)``, so every rank
    (and either package) starts in the same subspace."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = torch.from_numpy(uniform_draw((ncols, rank), lo, 1.0)).double()
    q0 = (math.sqrt(2.0) * torch.special.erfinv(u)).to(_F32)
    return orthonormalize(q0.to(device))
