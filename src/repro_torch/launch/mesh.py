"""Mesh definitions over ``torch.distributed`` (port of ``make_mesh``,
``make_hier_mesh``, ``comm_axes`` and ``parse_nodes_spec`` of
``repro.launch.mesh``).

The mesh is ``(node, data, cpnode, cp, ppnode, stage, tpnode, model)``:
``model`` carries TP/SP, ``stage`` the pipeline stages, ``cp`` the
context-parallel ring (each cp rank holds one zigzag slice of the
sequence), ``data`` DP and the ZeRO-1 shards.  ``--nodes``,
``--cp-nodes``, ``--pp-nodes`` and ``--tp-nodes`` factor the data, cp,
stage and model axes into an outer node axis and an inner one, so that
the two-level collectives of :mod:`repro_torch.core.comms` stage their
intra-node (fast links) and inter-node (slow links) hops apart.  Ranks are
laid out as the reference lays out devices, row-major over those eight
axes (an axis of one rank is left out): on the flat mesh global rank ``r
= ((d * cp + c) * pp + s) * tp + t`` sits at data index ``d``, cp index
``c``, stage ``s`` and model ``t``, and a factored axis is the flat one
linearized node-major, so "rank i owns chunk i" names the same shard in
both packages and on flat and factored meshes alike.

Disaggregated serving adds a ``pool`` axis of two (prefill, decode)
outermost (:func:`make_disagg_mesh`): each pool is a whole ``dp x tp``
mesh, global rank ``(p * dp + d) * tp + t``, and only the kv handoff
crosses it.
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from repro_torch.core.comms import Axis, AxisPair
from repro_torch.models.params import MeshInfo

NODE_AXIS = "node"       # outer (inter-node, slow-link) data sub-axis
LOCAL_AXIS = "data"      # inner data sub-axis / flat data axis
CP_NODE_AXIS = "cpnode"  # outer cp sub-axis
CP_AXIS = "cp"           # inner cp sub-axis / flat context-parallel axis
PP_NODE_AXIS = "ppnode"  # outer stage sub-axis
STAGE_AXIS = "stage"     # inner stage sub-axis / flat stage axis
TP_NODE_AXIS = "tpnode"  # outer model sub-axis
MODEL_AXIS = "model"     # inner model sub-axis / flat model axis
POOL_AXIS = "pool"       # serving: prefill (0) / decode (1) pools


def _axis_groups(shape: tuple, dims: tuple) -> dict:
    """Process groups along the mesh dims ``dims`` (adjacent, joined
    row-major) of a row-major rank grid of ``shape``: ``{other coords:
    (ranks along the dims, group)}``.  Every rank creates every group, in
    the same order, as ``new_group`` requires; an axis of one rank needs
    none."""
    size = math.prod(shape[k] for k in dims)
    others = [range(1) if i in dims else range(n)
              for i, n in enumerate(shape)]
    out = {}
    for c in itertools.product(*others):
        ranks = []
        for j in itertools.product(*(range(shape[k]) for k in dims)):
            idx = list(c)
            for k, v in zip(dims, j):
                idx[k] = v
            r = 0
            for i, n in zip(idx, shape):
                r = r * n + i
            ranks.append(r)
        key = tuple(v for i, v in enumerate(c) if i not in dims)
        out[key] = (tuple(ranks), dist.new_group(ranks) if size > 1 else None)
    return out


def make_mesh(dp: int, tp: int, pp: int = 1, nodes: int = 1,
              tp_nodes: int = 1, pp_nodes: int = 1, cp: int = 1,
              cp_nodes: int = 1, pool: int = 1) -> MeshInfo:
    """This rank's view of a ``dp x cp x pp x tp`` mesh whose data, cp,
    stage and model axes split over ``nodes``, ``cp_nodes``, ``pp_nodes``
    and ``tp_nodes`` nodes (``dp``, ``cp``, ``pp`` and ``tp`` are the whole
    degrees, as the reference's ``make_mesh`` takes them), its axes bound
    to process groups of the initialized default group (which must hold
    ``pool * dp * cp * pp * tp`` ranks).  ``pool`` repeats that mesh
    ``pool`` times over an outermost serving pool axis
    (:func:`make_disagg_mesh`); every other axis, ``world`` included,
    stays inside one pool.  A one-rank mesh needs no process group."""
    for ways, n, flag in ((dp, nodes, "--nodes"), (tp, tp_nodes, "--tp-nodes"),
                          (pp, pp_nodes, "--pp-nodes"),
                          (cp, cp_nodes, "--cp-nodes")):
        if n < 1 or ways % n:
            raise ValueError(f"{flag} {n} must divide {ways}")
    if pool < 1:
        raise ValueError(f"pool {pool} must be >= 1")
    world = dp * cp * pp * tp
    if world * pool == 1:
        return MeshInfo()
    if not dist.is_initialized() or dist.get_world_size() != world * pool:
        raise RuntimeError(
            f"a {pool} x {dp} x {cp} x {pp} x {tp} (pool x data x cp x "
            f"stage x model) mesh needs torch.distributed initialized with "
            f"{world * pool} ranks")
    r = dist.get_rank()
    # dim 0 is the pool; the mesh dims below count from 1
    shape = (pool, nodes, dp // nodes, cp_nodes, cp // cp_nodes, pp_nodes,
             pp // pp_nodes, tp_nodes, tp // tp_nodes)
    coord, rest = [], r
    for n in reversed(shape):
        coord.append(rest % n)
        rest //= n
    coord = coord[::-1]

    def axis(name, dims):
        """The axis over ``dims`` through this rank, named ``name``."""
        groups = _axis_groups(shape, dims)
        key = tuple(v for i, v in enumerate(coord) if i not in dims)
        index = 0
        for k in dims:
            index = index * shape[k] + coord[k]
        ranks, group = groups[key]
        return Axis(name, len(ranks), index, group, ranks)

    def factored(outer, inner, k):
        """The flat axis of mesh dims ``(k, k + 1)``, or their pair."""
        if shape[k] == 1:
            return axis(inner, (k + 1,))
        return AxisPair(axis(outer, (k,)), axis(inner, (k + 1,)),
                        axis((outer, inner), (k, k + 1)))

    data = factored(NODE_AXIS, LOCAL_AXIS, 1)
    context = factored(CP_NODE_AXIS, CP_AXIS, 3) if cp > 1 else None
    stage = factored(PP_NODE_AXIS, STAGE_AXIS, 5) if pp > 1 else None
    model = factored(TP_NODE_AXIS, MODEL_AXIS, 7)
    pair = isinstance(data, AxisPair)
    # the loss's token sums: the batch and cp axes are adjacent in the
    # rank order, so one group covers them
    batch_cp = None
    if cp > 1:
        names = tuple(n for n, k in zip(
            (NODE_AXIS, LOCAL_AXIS, CP_NODE_AXIS, CP_AXIS), shape[1:])
            if k > 1)
        batch_cp = axis(names, (1, 2, 3, 4))
    if pool == 1:
        whole = Axis("world", world, r, None, tuple(range(world)))
    else:
        whole = axis("world", tuple(range(1, len(shape))))
    return MeshInfo(
        tp=tp, dp=dp // nodes, pp=pp, node=nodes, tp_node=tp_nodes,
        pp_node=pp_nodes, cp=cp, cp_node=cp_nodes, pool=pool, model=model,
        data=data.inner if pair else data, stage=stage,
        nodes=data.outer if pair else None,
        batch=data.joint if pair else None, context=context,
        batch_cp=batch_cp, world=whole,
        pools=axis(POOL_AXIS, (0,)) if pool > 1 else None)


def make_disagg_mesh(dp: int, tp: int) -> MeshInfo:
    """This rank's view of the disaggregated serving mesh (the reference's
    ``serve.disagg.make_disagg_mesh``): ``(pool=2, data, model)``, the pool
    outermost so that each pool is a whole ``dp x tp`` mesh and the
    handoff one hop; ``2 * dp * tp`` ranks, global rank ``(p * dp + d) *
    tp + t``."""
    return make_mesh(dp, tp, pool=2)


def make_hier_mesh(dp: int, tp: int, nodes: int = 1, tp_nodes: int = 1,
                   pp: int = 1, pp_nodes: int = 1, cp: int = 1,
                   cp_nodes: int = 1) -> MeshInfo:
    """The node-factored mesh (the reference's entry point of that name):
    :func:`make_mesh` with its node counts.  A factored axis is the flat
    one linearized node-major, so flat and two-level collectives over it
    are interchangeable rank for rank."""
    return make_mesh(dp, tp, pp, nodes=nodes, tp_nodes=tp_nodes,
                     pp_nodes=pp_nodes, cp=cp, cp_nodes=cp_nodes)


def comm_axes(mi: MeshInfo, logical: str):
    """Logical parallelism axis (``"data"``, ``"cp"``, ``"stage"`` or
    ``"model"``) -> the comms axis this rank passes to the collectives: the
    flat axis, or the :class:`~repro_torch.core.comms.AxisPair` of a
    node-factored one, which routes the collectives through their
    two-level forms."""
    if logical == MODEL_AXIS:
        return mi.tp_axes
    if logical == LOCAL_AXIS:
        return mi.data_pair
    if logical == STAGE_AXIS:
        if mi.stage_axes is None:
            raise ValueError("mesh has no stage axis")
        return mi.stage_axes
    if logical == CP_AXIS:
        if mi.cp_axes is None:
            raise ValueError("mesh has no cp axis")
        return mi.cp_axes
    raise NotImplementedError(f"mesh axis {logical!r} is not yet ported")


def parse_nodes_spec(spec, ways: int, flag: str = "--nodes") -> int:
    """``--nodes`` / ``--tp-nodes`` / ``--pp-nodes`` / ``--cp-nodes`` ->
    node count: an int, or ``NxD`` (nodes x ranks per node), for the
    ``ways`` ranks of the axis it factors (the reference's rules;
    ``ValueError`` here where the reference asserts)."""
    if isinstance(spec, int):
        nodes = spec
    elif "x" in str(spec).lower():
        n, d = str(spec).lower().split("x")
        nodes = int(n)
        if nodes * int(d) != ways:
            raise ValueError(f"{flag} {spec} inconsistent with degree "
                             f"{ways}")
    else:
        nodes = int(spec)
    if nodes < 1 or ways % nodes:
        raise ValueError(f"{flag} {nodes} must divide {ways}")
    return nodes


def validate_vpp(vpp: int, pp: int, n_micro: int) -> int:
    """``--vpp`` against the knobs it composes with (the reference's
    checks): ``vpp`` is no mesh axis, but the interleaved schedule needs a
    stage axis and walks microbatches in groups of ``pp``."""
    if vpp < 1:
        raise ValueError(f"--vpp {vpp} must be >= 1")
    if vpp > 1 and pp <= 1:
        raise ValueError(f"--vpp {vpp} needs --pp > 1 (no stage axis to "
                         "interleave on)")
    if vpp > 1 and n_micro % pp:
        raise ValueError(f"--vpp {vpp} needs --microbatches divisible by "
                         f"--pp (got {n_micro} over pp={pp})")
    return vpp
