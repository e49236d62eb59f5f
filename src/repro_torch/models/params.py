"""Parameter plans: shapes, dtypes and initializers declared together.

A *plan* is a tree of dicts and lists whose leaves are :class:`ParamDef`.
:func:`init_params` materializes it into a same-shaped tree of tensors;
:func:`from_jax_params` fills it from the reference package's parameter
tree instead, so both packages can compute with the same weights.

This package runs on one device: :class:`MeshInfo` is the one-way mesh,
and the sharding tags of the reference's plans are kept only as metadata.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.comms import Axis


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for the card without one raises;
    the CPU runs only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Logical view of the mesh: one device (``tp = dp = 1``)."""

    tp: int = 1
    dp: int = 1
    model_axis: str = "model"

    def __post_init__(self):
        if self.tp != 1 or self.dp != 1:
            raise NotImplementedError(
                f"dp={self.dp} x tp={self.tp}: only one device is ported "
                f"(dp = tp = 1); sharded meshes are not yet ported")

    @property
    def tp_axes(self) -> Axis:
        return Axis(self.model_axis, self.tp)

    @property
    def batch_ways(self) -> int:
        return self.dp


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple           # per-dim sharding tag of the reference (metadata)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"

    def size(self) -> int:
        return math.prod(self.shape)


def D(shape, spec=None, init="normal", scale=0.02, dtype="bfloat16",
      fsdp_ok=True) -> ParamDef:
    """Declare a parameter (``fsdp_ok`` is accepted for plan parity with the
    reference; nothing here shards)."""
    spec = spec if spec is not None else (None,) * len(shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {shape}")
    return ParamDef(tuple(shape), tuple(spec), init, scale, dtype)


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def tree_map_defs(fn, plan):
    if isinstance(plan, ParamDef):
        return fn(plan)
    if isinstance(plan, dict):
        return {k: tree_map_defs(fn, v) for k, v in plan.items()}
    if isinstance(plan, (list, tuple)):
        return [tree_map_defs(fn, v) for v in plan]
    raise TypeError(f"unexpected plan node {type(plan)}")


def _leaves(plan, path=()):
    """(path, ParamDef) pairs in sorted-key order."""
    if isinstance(plan, ParamDef):
        yield path, plan
    elif isinstance(plan, dict):
        for k in sorted(plan):
            yield from _leaves(plan[k], path + (k,))
    else:
        for i, v in enumerate(plan):
            yield from _leaves(v, path + (i,))


def count_params(plan) -> int:
    return sum(d.size() for _, d in _leaves(plan))


def init_params(plan, gen: torch.Generator, device) -> dict:
    """Materialize the plan; normal leaves draw f32 from ``gen`` (a
    generator on ``device``) in sorted-key order, scale, then cast."""
    dev = torch.device(device)
    vals = {}
    for path, d in _leaves(plan):
        dt = torch_dtype(d.dtype)
        if d.init == "zeros":
            v = torch.zeros(d.shape, dtype=dt, device=dev)
        elif d.init == "ones":
            v = torch.ones(d.shape, dtype=dt, device=dev)
        else:
            v = (torch.randn(d.shape, generator=gen, dtype=torch.float32,
                             device=dev) * d.scale).to(dt)
        vals[path] = v
    return _fill(plan, vals)


def _fill(plan, vals, path=()):
    if isinstance(plan, ParamDef):
        return vals[path]
    if isinstance(plan, dict):
        return {k: _fill(v, vals, path + (k,)) for k, v in plan.items()}
    return [_fill(v, vals, path + (i,)) for i, v in enumerate(plan)]


def from_jax_params(tree, cfg, device=None) -> dict:
    """The reference's parameter tree, with each ``Pv`` leaf unwrapped to a
    numpy array, -> this package's parameter tree on ``device``.

    The tree must have exactly the layout of this package's plan for
    ``cfg`` (dicts by key, layer groups as a list of stacked leaves); each
    leaf's shape is checked and its dtype set to the plan's."""
    from repro_torch.models.transformer import model_plan

    dev = resolve_device(device)
    plan = model_plan(cfg, MeshInfo())

    def conv(p, t, path):
        if isinstance(p, ParamDef):
            a = np.asarray(t)
            if a.dtype.kind not in "fiub":     # bfloat16 from ml_dtypes
                a = a.astype(np.float32)
            if tuple(a.shape) != p.shape:
                raise ValueError(f"param {'/'.join(map(str, path))}: shape "
                                 f"{tuple(a.shape)}, plan wants {p.shape}")
            return torch.from_numpy(np.array(a, copy=True)).to(
                device=dev, dtype=torch_dtype(p.dtype))
        if isinstance(p, dict):
            if set(p) != set(t):
                raise ValueError(f"param tree at {'/'.join(map(str, path))}: "
                                 f"keys {sorted(t)}, plan wants {sorted(p)}")
            return {k: conv(v, t[k], path + (k,)) for k, v in p.items()}
        if len(p) != len(t):
            raise ValueError(f"param tree at {'/'.join(map(str, path))}: "
                             f"{len(t)} entries, plan wants {len(p)}")
        return [conv(v, tv, path + (i,)) for i, (v, tv) in
                enumerate(zip(p, t))]

    return conv(plan, tree, ())
