"""Mesh-independent checkpoints, written by a world of ranks (port of
``repro.train.checkpoint``, in its on-disk format).

Arrays are saved as *logical* (global) values, one ``.npy`` per leaf in
the reference's ``tree_flatten`` order (dict keys sorted, lists in order,
``None`` no leaf), plus a JSON manifest:

    <dir>/step_<k>/manifest.json       {"step", "n_leaves", "meta", "extra"}
    <dir>/step_<k>/leaves/<i>.npy

Writes go to ``step_<k>.tmp``, which is renamed when complete; a
``latest`` symlink is flipped last, so a crash mid-write never corrupts
the restore point.  Either package restores what the other wrote.

Each rank holds only its shards, so a leaf is described to :func:`save`
and :func:`restore` as a :class:`Shard`: the global shape and where this
rank's part lies in it.  Rank 0 creates every leaf file at its global
size; after a barrier each rank writes the parts it owns (one replica of
each part) into the files in place, with no data crossing between ranks,
and leaves a marker file; rank 0 waits for every marker, writes the
manifest, renames and flips ``latest``.  A non-blocking save copies its
parts to the host first (the step updates the tensors in place) and
writes them in a thread, which runs no collective, so the training
step's process groups are never used from two threads.  A restoring rank
reads only its parts, through a memory map.

bf16 has no numpy dtype: as the reference's ``np.save`` of an ml_dtypes
bf16 array does, its bytes are written under the descr ``'<V2'``, and a
``'<V2'`` leaf is read as the target leaf's 2-byte type.  Manifests are
written with the stdlib ``json`` (the reference's bytes when it lacks
``orjson``; hold them equal as parsed JSON).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

_WAIT_S = 3600.0          # rank 0's wait for the other ranks' parts


@dataclasses.dataclass(frozen=True)
class Pv:
    """A leaf with the reference's logical sharding spec (its ``Pv``),
    saved as ``{"pv": true, "spec": [...]}``."""

    v: object
    spec: tuple


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of one global leaf: ``index`` (a slice per dim of
    ``shape``) says where ``value`` lies in the global array.  On a save,
    ``writes`` says whether this rank writes its part (one replica of
    each part does); on a restore, the part comes back as ``dtype`` on
    ``device``."""

    shape: tuple
    index: tuple
    dtype: torch.dtype
    value: torch.Tensor | None = None
    writes: bool = True
    device: object = "cpu"


def whole(shape: tuple) -> tuple:
    return tuple(slice(0, n) for n in shape)


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def flatten(tree) -> list:
    """Leaves in the reference's ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def _unflatten(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def unwrap(tree):
    """``tree`` with every :class:`Pv` replaced by its value."""
    return _unflatten(tree, iter([x.v if isinstance(x, Pv) else x
                                  for x in flatten(tree)]))


# --------------------------------------------------------------------------
# the world
# --------------------------------------------------------------------------

def _rank_world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank (a no-op in a one-rank world).  Call it from
    the training thread only."""
    if _rank_world()[1] > 1:
        dist.barrier()


class Pending:
    """A save running in a thread.  :meth:`join` waits for it and raises
    what it raised; on rank 0 the checkpoint is then complete, on the
    others their parts are written (:func:`join_all` waits for both)."""

    def __init__(self, fn):
        self.error = None
        self.seconds = 0.0

        def run():
            t0 = time.perf_counter()
            try:
                fn()
            except BaseException as e:        # re-raised by join()
                self.error = e
            self.seconds = time.perf_counter() - t0
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self, timeout=None):
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError("checkpoint save still running")
        if self.error is not None:
            raise self.error


def join_all(pending: list) -> None:
    """Join every pending save, then wait for every rank: afterwards each
    of their checkpoints is complete and ``latest`` names the newest."""
    for p in pending:
        p.join()
    barrier()


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------

def _host(x) -> tuple:
    """A host copy of ``x`` for writing, and its ``.npy`` descr: bf16 as
    its int16 bits under ``'<V2'``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "<V2"
        a = t.numpy()
    else:
        a = np.array(x, copy=True)
    descr = np.lib.format.dtype_to_descr(a.dtype)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:   # ml_dtypes bf16
        a = a.view(np.int16)
    return a, descr


@dataclasses.dataclass
class _Part:
    shape: tuple
    descr: str
    index: tuple
    host: np.ndarray | None
    meta: dict


def _part(leaf, leader: bool) -> _Part:
    meta = {"pv": False}
    if isinstance(leaf, Pv):
        meta = {"pv": True, "spec": list(leaf.spec)}
        leaf = leaf.v
    if isinstance(leaf, Shard):
        host, descr = _host(leaf.value) if leaf.writes else (None, None)
        if descr is None:
            descr = "<V2" if leaf.dtype == torch.bfloat16 else \
                np.lib.format.dtype_to_descr(
                    torch.empty((), dtype=leaf.dtype).numpy().dtype)
        return _Part(tuple(leaf.shape), descr, leaf.index, host, meta)
    if not leader:                           # rank 0 writes a whole leaf
        return _Part((), "", (), None, meta)
    host, descr = _host(leaf)
    return _Part(tuple(host.shape), descr, whole(host.shape), host, meta)


def _create(path: pathlib.Path, shape: tuple, descr: str) -> None:
    """An ``.npy`` file of ``shape`` with np.save's header, its data
    unwritten (a sparse file)."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False, "shape": shape})
        f.truncate(f.tell() + math.prod(shape)
                   * np.lib.format.descr_to_dtype(descr).itemsize)


def _write_part(path: pathlib.Path, p: _Part) -> None:
    mm = np.load(path, mmap_mode="r+")
    if mm.dtype.kind == "V":
        mm = mm.view(np.int16)
    mm[p.index] = p.host
    del mm                 # no msync: durable as np.save is, via the cache


def _finish(ckpt_dir: pathlib.Path, step: int, tmp: pathlib.Path,
            manifest: dict, world: int) -> None:
    """Rank 0: wait for every rank's marker, write the manifest, rename,
    flip ``latest``."""
    marks = [tmp / f".done.{r}" for r in range(world)]
    t0 = time.monotonic()
    while not all(m.exists() for m in marks):
        if time.monotonic() - t0 > _WAIT_S:
            missing = [m.name for m in marks if not m.exists()]
            raise TimeoutError(f"checkpoint step {step}: no part from "
                               f"{missing} after {_WAIT_S:.0f}s")
        time.sleep(0.01)
    for m in marks:
        m.unlink()
    (tmp / "manifest.json").write_bytes(json.dumps(manifest).encode("utf-8"))
    final = ckpt_dir / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # as the reference's, ``latest`` names the save that finished last; a
    # link of its own per step keeps two saves finishing together apart
    tmp_link = ckpt_dir / f".latest.{step}.tmp"
    if tmp_link.exists() or tmp_link.is_symlink():
        tmp_link.unlink()
    tmp_link.symlink_to(final.name)
    os.replace(tmp_link, ckpt_dir / "latest")


def save(ckpt_dir, step: int, tree, extra: dict | None = None,
         blocking: bool = True):
    """Save ``tree`` at ``step``; every rank of an initialized process
    group calls it with its own parts.  Leaves are :class:`Shard` parts,
    or whole values (tensors, arrays) that rank 0 writes, either wrapped
    in :class:`Pv`.  Blocking, it returns when the checkpoint is complete
    on every rank; otherwise it returns a :class:`Pending` once the parts
    are on the host."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    rank, world = _rank_world()
    parts = [_part(x, rank == 0) for x in flatten(tree)]
    tmp = ckpt_dir / f"step_{step}.tmp"
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "leaves").mkdir(parents=True)
        for i, p in enumerate(parts):
            _create(tmp / "leaves" / f"{i}.npy", p.shape, p.descr)
    barrier()
    manifest = {"step": step, "n_leaves": len(parts),
                "meta": [p.meta for p in parts], "extra": extra or {}}

    def write():
        for i, p in enumerate(parts):
            if p.host is not None:
                _write_part(tmp / "leaves" / f"{i}.npy", p)
        (tmp / f".done.{rank}").touch()
        if rank == 0:
            _finish(ckpt_dir, step, tmp, manifest, world)

    if blocking:
        write()
        barrier()
        return None
    return Pending(write)


def latest_step(ckpt_dir) -> int | None:
    p = pathlib.Path(ckpt_dir) / "latest"
    if not p.exists():
        return None
    return json.loads((p / "manifest.json").read_bytes())["step"]


def nbytes(ckpt_dir, step: int) -> int:
    """Bytes on disk of one checkpoint."""
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


# --------------------------------------------------------------------------
# elastic stage layouts (the reference's, plain numpy)
# --------------------------------------------------------------------------

def stage_reshape(a: np.ndarray, target_shape: tuple) -> np.ndarray:
    """Elastic-pp reshape: remap a (possibly stage-stacked) group leaf
    saved under one ``--pp`` (x ``--vpp``) onto another.

    Every supported layout linearizes its leading dims in contiguous
    layer order: contiguous stages ``(pp, n, ...)``, interleaved virtual
    stages ``(vpp, pp, n, ...)`` (the v-major index ``v * pp + s`` is the
    round-robin chunk id, and chunks are contiguous layer intervals in
    chunk order) and the pp=1 ``(n, ...)``.  So any layout change is a
    plain reshape whenever the trailing per-layer dims agree and the
    layer count matches; anything else fails loudly with both layouts
    named."""
    ts = tuple(target_shape)
    if tuple(a.shape) == ts:
        return a
    if _merge_compatible(tuple(a.shape), ts):
        return a.reshape(ts)
    raise ValueError(
        f"cannot reshape checkpoint leaf {a.shape} -> {ts}: saved layout "
        f"{_layout_name(tuple(a.shape), ts)} does not remap onto target "
        f"layout {_layout_name(ts, tuple(a.shape))} (leading stage/vpp "
        "dims must factor the same layer count over identical per-layer "
        "shapes)")


def _layout_name(shape: tuple, other: tuple) -> str:
    """Human name of a group leaf's leading-dims layout, judged by how
    many leading dims it has beyond the two shapes' shared per-layer
    tail."""
    tail = 0
    while tail < min(len(shape), len(other)) \
            and shape[len(shape) - 1 - tail] == other[len(other) - 1 - tail]:
        tail += 1
    lead = shape[:len(shape) - tail]
    if len(lead) >= 3:
        return f"interleaved (vpp={lead[0]}, pp={lead[1]}, layers={lead[2]})"
    if len(lead) == 2:
        return f"contiguous (pp={lead[0]}, layers={lead[1]})"
    return f"flat (layers={lead[0] if lead else 1})"


def _merge_compatible(src: tuple, dst: tuple) -> bool:
    """True when src/dst differ only in how up to three leading
    (vpp, stage, layer) dims factor the same layer count over identical
    per-layer shapes."""
    for k in (1, 2, 3):
        if len(src) >= k and len(dst) >= 1:
            for j in (1, 2, 3):
                if len(dst) >= j and src[k:] == dst[j:] and \
                        math.prod(src[:k]) == math.prod(dst[:j]):
                    return True
    return False


# --------------------------------------------------------------------------
# restore
# --------------------------------------------------------------------------

def _target(like) -> tuple:
    """(global shape, index, dtype, device) a restore target asks for."""
    if isinstance(like, Shard):
        return tuple(like.shape), like.index, like.dtype, like.device
    if isinstance(like, torch.Tensor):
        dev = "cpu" if like.device.type == "meta" else like.device
        return tuple(like.shape), whole(like.shape), like.dtype, dev
    raise TypeError(f"restore target must be a Shard or a tensor, got "
                    f"{type(like).__name__}")


def take(a: np.ndarray, like) -> torch.Tensor:
    """The part of the global array ``a`` (already in ``like``'s global
    shape) that ``like`` names, as its dtype on its device; a ``'<V2'``
    (bf16 as the reference writes it) array as ``like``'s 2-byte type."""
    _, index, dtype, dev = _target(like)
    part = np.array(a[index])                 # reads only this part
    if part.dtype.kind == "V":
        if torch.empty((), dtype=dtype).element_size() != 2:
            raise TypeError(f"a {part.dtype} leaf cannot restore into "
                            f"{dtype}")
        t = torch.from_numpy(part.view(np.int16)).view(dtype)
    else:
        t = torch.from_numpy(part).to(dtype)
    return t.to(dev)


def restore(ckpt_dir, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (the latest step by
    default); returns ``(tree, manifest)``.  Each :class:`Shard` target
    gets its part of the global leaf, a tensor target the whole leaf; a
    leaf saved with a spec comes back as :class:`Pv`.  Stage-stacked
    leaves whose stage factoring changed (a restart under another
    ``--pp`` or ``--vpp``) are re-linearized by :func:`stage_reshape`."""
    src = pathlib.Path(ckpt_dir) / ("latest" if step is None
                                    else f"step_{step}")
    manifest = json.loads((src / "manifest.json").read_bytes())
    leaves = flatten(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise AssertionError(f"checkpoint has {manifest['n_leaves']} "
                             f"leaves, tree has {len(leaves)}")
    out = []
    for i, (leaf, m) in enumerate(zip(leaves, manifest["meta"])):
        like = leaf.v if isinstance(leaf, Pv) else leaf
        shape = _target(like)[0]
        a = np.load(src / "leaves" / f"{i}.npy", mmap_mode="r")
        spec = tuple(m["spec"]) if m["pv"] else ()
        if tuple(a.shape) != shape:
            a = stage_reshape(a, shape)
            if m["pv"]:        # the target plan's spec, not the saved one
                spec = leaf.spec
        v = take(a, like)
        out.append(Pv(v, spec) if m["pv"] else v)
    return _unflatten(tree_like, iter(out)), manifest
