"""Parameter plans: shapes, dtypes and initializers declared together.

A *plan* is a tree of dicts and lists whose leaves are :class:`ParamDef`.
:func:`init_params` materializes it into a same-shaped tree of tensors;
:func:`from_jax_params` fills it from the reference package's parameter
tree instead, so both packages can compute with the same weights.

A leaf's ``spec`` tags each dim as in the reference: ``"model"`` dims are
sharded over the tensor-parallel axis, ``"stage"`` dims (the pipeline's
stage-stacked layer groups) over the stage axis, ``"data"`` dims (ZeRO-3:
:func:`apply_fsdp` gives the largest free, divisible dim of each big leaf
of a ``fsdp_params`` model to the inner data axis) over the data axis,
``None`` dims are replicated.  Parameters are plain tensors holding this
rank's shard; the optimizer reads each leaf's spec from the plan, and the
model bodies see a ZeRO-3 leaf wrapped with its spec (:class:`Pv`,
:func:`bind_fsdp`), which ``layers.use`` re-gathers over data where it is
read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.comms import Axis, AxisPair


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for the card without one raises;
    the CPU runs only when the caller asks for it, and ``meta`` (shapes
    alone, no storage: the dry-run's trace) likewise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Logical view of the ``(pod, node, data, cpnode, cp, ppnode, stage,
    tpnode, model)`` mesh from this rank.

    As in the reference, ``tp`` and ``pp`` are the *joint* tensor-parallel
    and stage counts, while ``dp`` is the *inner* data size: on a mesh
    factored with ``--nodes`` the batch splits ``node * dp`` ways
    (:attr:`batch_ways`), and the ZeRO-1 state shards over the inner data
    axis only, replicated per node.  ``tp_node`` and ``pp_node`` factor the
    model and stage axes into ``(tpnode, model)`` and ``(ppnode, stage)``;
    :attr:`tp_axes` and :attr:`stage_axes` are then
    :class:`~repro_torch.core.comms.AxisPair` s, which the collectives
    route through their two-level forms.  ``cp`` is the joint
    context-parallel count (each cp rank holds one zigzag slice of the
    sequence), factored into ``(cpnode, cp)`` by ``cp_node``;
    :attr:`cp_axes` carries the ring attention's K/V hops and the cp
    gradient fold.

    ``model`` / ``stage`` / ``context`` (an ``Axis`` or a pair),
    ``data``, ``nodes`` (the node axis), ``batch`` (the joint ``(node,
    data)`` axis), ``batch_cp`` (the joint ``(node, data, cpnode, cp)``
    axis the loss sums over) and ``world`` are the bound comms axes
    (:func:`repro_torch.launch.mesh.make_mesh` builds them over process
    groups); left ``None`` they are one-rank axes of the right name and
    size, which is all a one-process run, or a plan that only needs
    shapes, asks for.  A mesh with ``pp == 1`` has no stage axis
    (``stage_axes`` is ``None``), one with ``cp == 1`` no cp axis.

    ``pod`` is the reference's outer data-parallel axis (multi-pod): the
    batch splits over it too, ``(pod, node, data)`` pod-major
    (:attr:`batch_axes`, :attr:`batch_ways`), every leaf and the ZeRO-1
    chunks are replicated over it, and the optimizer all-reduces each
    chunk over it after the data reduce-scatter (``pods``, read through
    :attr:`pod_axes`, is ``None`` on a mesh without one).  As in the
    reference, ``pod`` and ``node`` do not combine.

    ``pool`` counts the disaggregated serving pools (prefill and decode,
    :mod:`repro_torch.serve.disagg`), whose axis (``pools``, read through
    :attr:`pool_axis`) the kv handoff crosses.  It is serving-only and
    outermost, as in the reference: it is never part of :attr:`all_axes`,
    :attr:`batch_axes` or :attr:`batch_ways` (no model collective touches
    it; ``world`` and ``world_size`` are one pool's), and every leaf is
    replicated over it."""

    tp: int = 1
    dp: int = 1
    pp: int = 1
    pod: int = 1
    node: int = 1
    tp_node: int = 1
    pp_node: int = 1
    cp: int = 1
    cp_node: int = 1
    pool: int = 1
    model_axis: str = "model"
    data_axis: str = "data"
    stage_axis: str = "stage"
    node_axis: str = "node"
    tp_node_axis: str = "tpnode"
    pp_node_axis: str = "ppnode"
    cp_axis: str = "cp"
    cp_node_axis: str = "cpnode"
    pool_axis_name: str = "pool"
    pod_axis_name: str = "pod"
    model: Axis | AxisPair | None = None
    data: Axis | None = None
    stage: Axis | AxisPair | None = None
    nodes: Axis | None = None
    batch: Axis | None = None
    context: Axis | AxisPair | None = None
    batch_cp: Axis | None = None
    world: Axis | None = None
    pools: Axis | None = None
    pods: Axis | None = None

    def __post_init__(self):
        for n, f in ((self.tp, self.tp_node), (self.pp, self.pp_node),
                     (self.cp, self.cp_node)):
            if n % f:
                raise ValueError(f"{n} ways do not split over {f} nodes")
        if self.pod > 1 and self.node > 1:
            raise ValueError("pod and nodes are mutually exclusive")
        for ax, n in ((self.model, self.tp), (self.data, self.dp),
                      (self.stage, self.pp), (self.nodes, self.node),
                      (self.batch, self.batch_ways),
                      (self.context, self.cp),
                      (self.batch_cp, self.batch_ways * self.cp),
                      (self.world, self.world_size), (self.pools, self.pool),
                      (self.pods, self.pod)):
            if ax is not None and ax.size != n:
                raise ValueError(f"axis {ax!r} has size {ax.size}, mesh "
                                 f"wants {n}")

    @property
    def world_size(self) -> int:
        return self.tp * self.dp * self.pp * self.node * self.cp * self.pod

    @staticmethod
    def _pair(outer: str, inner: str, n_o: int, n: int) -> AxisPair:
        """A one-rank view of a factored axis (sizes only)."""
        return AxisPair(Axis(outer, n_o), Axis(inner, n // n_o),
                        Axis((outer, inner), n))

    @property
    def tp_axes(self) -> Axis | AxisPair:
        """The axis model code passes to the collectives for TP traffic:
        the model axis, or the ``(tpnode, model)`` pair."""
        if self.model is not None:
            return self.model
        if self.tp_node > 1:
            return self._pair(self.tp_node_axis, self.model_axis,
                              self.tp_node, self.tp)
        return Axis(self.model_axis, self.tp)

    @property
    def dp_axes(self) -> Axis:
        """The (inner) data axis: the ZeRO-1 shards and their sync."""
        return self.data or Axis(self.data_axis, self.dp)

    @property
    def node_axes(self) -> Axis | None:
        """The node axis of a ``--nodes`` mesh (``None`` without one)."""
        if self.node == 1:
            return None
        return self.nodes or Axis(self.node_axis, self.node)

    @property
    def pod_axes(self) -> Axis | None:
        """The pod axis of a multi-pod mesh (``None`` without one)."""
        if self.pod == 1:
            return None
        return self.pods or Axis(self.pod_axis_name, self.pod)

    @property
    def data_pair(self) -> Axis | AxisPair:
        """The logical data axis: the ``(node, data)`` pair of a ``--nodes``
        mesh, else the data axis."""
        if self.node == 1:
            return self.dp_axes
        return AxisPair(self.node_axes, self.dp_axes, self.batch_axes)

    @property
    def batch_axes(self) -> Axis:
        """The joint axis the global batch is sharded over: ``(pod, data)``
        pod-major, ``(node, data)`` node-major, or the data axis."""
        if self.node == 1 and self.pod == 1:
            return self.dp_axes
        outer = self.pod_axis_name if self.pod > 1 else self.node_axis
        return self.batch or Axis((outer, self.data_axis), self.batch_ways)

    @property
    def stage_axes(self) -> Axis | AxisPair | None:
        """The axis the pipeline passes to comms for stage handoffs (the
        stage axis, or the ``(ppnode, stage)`` pair), or ``None`` on a mesh
        without a stage axis."""
        if self.pp == 1:
            return None
        if self.stage is not None:
            return self.stage
        if self.pp_node > 1:
            return self._pair(self.pp_node_axis, self.stage_axis,
                              self.pp_node, self.pp)
        return Axis(self.stage_axis, self.pp)

    @property
    def sp_axes(self) -> Axis | AxisPair | None:
        """The physical axes implementing pipeline stages (uncompressed
        sums over them run on the joint axis)."""
        return self.stage_axes

    @property
    def cp_axes(self) -> Axis | AxisPair | None:
        """The axis the ring attention passes to comms for its K/V hops,
        and the cp gradient fold's: the cp axis, or the ``(cpnode, cp)``
        pair (whose node-crossing hops ride the ``cp_*_outer`` codecs), or
        ``None`` on a mesh without a cp axis."""
        if self.cp == 1:
            return None
        if self.context is not None:
            return self.context
        if self.cp_node > 1:
            return self._pair(self.cp_node_axis, self.cp_axis,
                              self.cp_node, self.cp)
        return Axis(self.cp_axis, self.cp)

    @property
    def cp_phys_axes(self) -> Axis | None:
        """The joint axis the sequence is sharded over (the flat cp axis,
        or the pair's joint axis), which uncompressed exchanges such as the
        ring's positions run on; ``None`` without a cp axis."""
        ax = self.cp_axes
        return ax.joint if isinstance(ax, AxisPair) else ax

    @property
    def batch_cp_axes(self) -> Axis:
        """The joint ``(node, data, cpnode, cp)`` axis, node-major: cp
        ranks hold disjoint token slices, so the loss's token sums run
        over it as over the batch axes (the batch axes without a cp
        axis)."""
        if self.cp == 1:
            return self.batch_axes
        if self.batch_cp is not None:
            return self.batch_cp
        names = tuple(n for n, k in ((self.pod_axis_name, self.pod),
                                     (self.node_axis, self.node),
                                     (self.data_axis, self.dp),
                                     (self.cp_node_axis, self.cp_node),
                                     (self.cp_axis, self.cp // self.cp_node))
                      if k > 1)
        return Axis(names, self.batch_ways * self.cp)

    @property
    def pool_axis(self) -> Axis | None:
        """The serving pool axis the kv handoff crosses, or ``None`` on a
        mesh without one."""
        if self.pool == 1:
            return None
        return self.pools or Axis(self.pool_axis_name, self.pool)

    @property
    def all_axes(self) -> Axis:
        """Every rank, ordered pod, node, data, cp, stage, model: global
        rank ``((((p * node + n) * dp + d) * cp + c) * pp + s) * tp + t``
        (cp, stage and model joint)."""
        return self.world or Axis("world", self.world_size)

    @property
    def batch_ways(self) -> int:
        return self.dp * self.node * self.pod

    @property
    def coords(self) -> dict:
        """This rank's index along each sharded spec tag (the joint index
        of a factored axis), and along the pod, node, cp and pool axes,
        over which every leaf is replicated."""
        return {"model": self.tp_axes.index, "data": self.dp_axes.index,
                "stage": self.stage_axes.index if self.pp > 1 else 0,
                "pod": self.pod_axes.index if self.pod > 1 else 0,
                "node": self.node_axes.index if self.node > 1 else 0,
                "cp": self.cp_axes.index if self.cp > 1 else 0,
                "pool": self.pool_axis.index if self.pool > 1 else 0}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    spec: tuple           # per-dim sharding tag of the reference (metadata)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"
    fsdp_ok: bool = True  # eligible for ZeRO-3 sharding over data

    def size(self) -> int:
        return math.prod(self.shape)


def D(shape, spec=None, init="normal", scale=0.02, dtype="bfloat16",
      fsdp_ok=True) -> ParamDef:
    spec = spec if spec is not None else (None,) * len(shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {shape}")
    return ParamDef(tuple(shape), tuple(spec), init, scale, dtype, fsdp_ok)


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


# --------------------------------------------------------------------------
# ZeRO-3 (FSDP) annotation over the data axis
# --------------------------------------------------------------------------

_FSDP_MIN_SIZE = 1 << 20  # leaves below 1M elements stay replicated


def apply_fsdp(plan, dp: int):
    """Shard the largest free (``None``), divisible dim of each leaf of at
    least ``_FSDP_MIN_SIZE`` elements over ``"data"`` (the first such dim
    on a tie), as the reference does."""

    def annotate(d: ParamDef) -> ParamDef:
        if not d.fsdp_ok or d.size() < _FSDP_MIN_SIZE or dp <= 1:
            return d
        best = None
        for i, (s, sp) in enumerate(zip(d.shape, d.spec)):
            if sp is None and s % dp == 0:
                if best is None or s > d.shape[best]:
                    best = i
        if best is None:
            return d
        spec = list(d.spec)
        spec[best] = "data"
        return dataclasses.replace(d, spec=tuple(spec))

    return tree_map_defs(annotate, plan)


def fsdp_dim(spec: tuple) -> int | None:
    """Which dim (if any) of a leaf must be re-gathered over data."""
    for i, s in enumerate(spec):
        if s == "data":
            return i
    return None


@dataclasses.dataclass(frozen=True)
class Pv:
    """A ZeRO-3 leaf as the model bodies see it: this rank's shard ``v``
    and its spec, whose ``"data"`` entry names the dim ``layers.use``
    re-gathers (the reference's ``Pv``; the slicing helpers of
    :mod:`repro_torch.models.transformer` drop the leading entries as they
    drop the stacked dims)."""

    v: torch.Tensor
    spec: tuple


def bind_fsdp(plan, tree):
    """``tree`` with every leaf whose spec shards over ``"data"`` wrapped
    as :class:`Pv`; ``tree`` itself when the plan has no such leaf."""
    if not any("data" in d.spec for _, d in _leaves(plan)):
        return tree

    def wrap(p, t):
        if isinstance(p, ParamDef):
            return Pv(t, p.spec) if "data" in p.spec else t
        if isinstance(p, dict):
            return {k: wrap(v, t[k]) for k, v in p.items()}
        return [wrap(v, tv) for v, tv in zip(p, t)]
    return wrap(plan, tree)


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


def defs(plan) -> list:
    """The plan's :class:`ParamDef` leaves in the reference's flatten
    order."""
    return [d for _, d in _leaves(plan)]


def leaves(plan, tree) -> list:
    """``(ParamDef, tensor)`` pairs of ``tree`` in the reference's flatten
    order (dict keys sorted, lists in order) — the order the ZeRO-1 flat
    vector concatenates in."""
    out = []
    for path, d in _leaves(plan):
        t = tree
        for k in path:
            t = t[k]
        out.append((d, t))
    return out


def map_leaves(fn, plan, tree=None):
    """A tree of the plan's layout holding ``fn(ParamDef, leaf)`` for each
    leaf, ``leaf`` taken from ``tree`` (``None`` without one)."""
    vals = {}
    for path, d in _leaves(plan):
        t = tree
        for k in path if tree is not None else ():
            t = t[k]
        vals[path] = fn(d, t)
    return _fill(plan, vals)


def _ways(mi: MeshInfo) -> dict:
    return {"model": mi.tp, "data": mi.dp, "stage": mi.pp}


def local_shape(d: ParamDef, mi: MeshInfo) -> tuple:
    """Shape of this rank's shard of ``d``."""
    ways = _ways(mi)
    return tuple(s // ways.get(sp, 1) for s, sp in zip(d.shape, d.spec))


def local_index(shape: tuple, spec: tuple, mi: MeshInfo) -> tuple:
    """Where this rank's shard lies in a global leaf of ``shape`` sharded
    by ``spec``: one slice per dim."""
    ways, coords = _ways(mi), mi.coords
    idx = []
    for s, sp in zip(shape, spec):
        n = s // ways.get(sp, 1)
        c = coords[sp] if sp in ways else 0
        idx.append(slice(c * n, (c + 1) * n))
    return tuple(idx)


def writes_replica(spec: tuple, mi: MeshInfo) -> bool:
    """Whether this rank holds the first replica of a leaf sharded by
    ``spec``: index 0 along every mesh axis the spec does not shard."""
    return all(i == 0 for ax, i in mi.coords.items() if ax not in spec)


def local_slice(t, d: ParamDef, mi: MeshInfo):
    """This rank's shard of a global tensor (or numpy array) ``t``."""
    return t[local_index(d.shape, d.spec, mi)]


def init_params(plan, gen: torch.Generator, device,
                mi: MeshInfo | None = None) -> dict:
    """Materialize this rank's shards of the plan.  Normal leaves draw the
    GLOBAL f32 tensor from ``gen`` (a generator on ``device``) in
    sorted-key order, scale, keep this rank's slice, then cast — so every
    rank draws the same numbers, replicated leaves agree across ranks, and
    the shards of any mesh assemble into the one-device weights."""
    dev = torch.device(device)
    mi = mi or MeshInfo()
    vals = {}
    for path, d in _leaves(plan):
        dt = torch_dtype(d.dtype)
        shape = local_shape(d, mi)
        if d.init == "zeros":
            v = torch.zeros(shape, dtype=dt, device=dev)
        elif d.init == "ones":
            v = torch.ones(shape, dtype=dt, device=dev)
        else:
            g = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=dev)
            v = (local_slice(g, d, mi) * d.scale).to(dt)
            del g
        vals[path] = v.contiguous()
    return _fill(plan, vals)


def meta_params(plan, mi: MeshInfo | None = None) -> dict:
    """This rank's shards of the plan as empty meta tensors (shape and
    dtype, no storage): the parameters of a step traced on shapes alone.
    :func:`init_params` draws global tensors from a generator, which meta
    cannot do."""
    mi = mi or MeshInfo()
    return map_leaves(lambda d, _: torch.empty(
        local_shape(d, mi), dtype=torch_dtype(d.dtype), device="meta"), plan)


def _fill(plan, vals, path=()):
    if isinstance(plan, ParamDef):
        return vals[path]
    if isinstance(plan, dict):
        return {k: _fill(v, vals, path + (k,)) for k, v in plan.items()}
    return [_fill(v, vals, path + (i,)) for i, v in enumerate(plan)]


def from_jax_params(tree, cfg, device=None, mi: MeshInfo | None = None,
                    vpp: int = 1) -> dict:
    """The reference's GLOBAL parameter tree, with each ``Pv`` leaf
    unwrapped to a numpy array, -> this rank's shards on ``device`` (the
    slice of each leaf that ``mi``'s coordinates name, a ZeRO-3 leaf's
    data shard included; the whole tree on a one-rank mesh).

    The tree must have exactly the layout of this package's plan for
    ``cfg`` on ``mi`` with ``vpp`` virtual stages (dicts by key, an
    untied head under ``lm_head``, layer groups as a list of stacked
    leaves; on a stage mesh each group leaf
    stage-stacked ``[pp, n, ...]``, or ``[vpp, pp, n, ...]``); each leaf's
    global shape is checked and its dtype set to the plan's."""
    from repro_torch.models.transformer import model_plan

    dev = resolve_device(device)
    mi = mi or MeshInfo()
    plan = model_plan(cfg, mi, vpp)

    def conv(p, t, path):
        if isinstance(p, ParamDef):
            a = np.asarray(t)
            if a.dtype.kind not in "fiub":     # bfloat16 from ml_dtypes
                a = a.astype(np.float32)
            if tuple(a.shape) != p.shape:
                raise ValueError(f"param {'/'.join(map(str, path))}: shape "
                                 f"{tuple(a.shape)}, plan wants {p.shape}")
            a = local_slice(a, p, mi)
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
