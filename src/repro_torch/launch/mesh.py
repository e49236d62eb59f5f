"""Mesh definitions over ``torch.distributed`` (port of ``make_mesh``,
``make_hier_mesh``, ``comm_axes`` and ``parse_nodes_spec`` of
``repro.launch.mesh``).

The mesh is ``(pod, node, data, cpnode, cp, ppnode, stage, tpnode,
model)``: ``pod`` is the outer data-parallel axis (multi-pod: the batch
splits over it, the ZeRO-1 chunks all-reduce over it), ``model`` carries
TP/SP, ``stage`` the pipeline stages, ``cp`` the
context-parallel ring (each cp rank holds one zigzag slice of the
sequence), ``data`` DP and the ZeRO-1 shards.  ``--nodes``,
``--cp-nodes``, ``--pp-nodes`` and ``--tp-nodes`` factor the data, cp,
stage and model axes into an outer node axis and an inner one, so that
the two-level collectives of :mod:`repro_torch.core.comms` stage their
intra-node (fast links) and inter-node (slow links) hops apart.  Ranks are
laid out as the reference lays out devices, row-major over those nine
axes (an axis of one rank is left out): on the flat mesh global rank ``r
= (((p * dp + d) * cp + c) * pp + s) * tp + t`` sits at pod index ``p``,
data index ``d``, cp index ``c``, stage ``s`` and model ``t``, and a factored axis is the flat one
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
POD_AXIS = "pod"         # outer data-parallel axis (multi-pod)


def _axis_groups(shape: tuple, dims: tuple, bind: bool = True) -> dict:
    """Process groups along the mesh dims ``dims`` (adjacent, joined
    row-major) of a row-major rank grid of ``shape``: ``{other coords:
    (ranks along the dims, group)}``.  Every rank creates every group, in
    the same order, as ``new_group`` requires; an axis of one rank needs
    none, and neither does a stand-in mesh (``bind`` false)."""
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
        out[key] = (tuple(ranks),
                    dist.new_group(ranks) if size > 1 and bind else None)
    return out


def make_mesh(dp: int, tp: int, pp: int = 1, nodes: int = 1,
              tp_nodes: int = 1, pp_nodes: int = 1, cp: int = 1,
              cp_nodes: int = 1, pool: int = 1, pod: int = 1,
              rank: int | None = None) -> MeshInfo:
    """This rank's view of a ``pod x dp x cp x pp x tp`` mesh whose data,
    cp, stage and model axes split over ``nodes``, ``cp_nodes``,
    ``pp_nodes`` and ``tp_nodes`` nodes (``dp``, ``cp``, ``pp`` and ``tp``
    are the whole degrees, as the reference's ``make_mesh`` takes them),
    its axes bound to process groups of the initialized default group
    (which must hold ``pool * pod * dp * cp * pp * tp`` ranks).  ``pod`` is
    the outer data-parallel axis, outermost of the training mesh; as in the
    reference it does not combine with ``nodes``.  ``pool`` repeats that
    mesh ``pool`` times over an outermost serving pool axis
    (:func:`make_disagg_mesh`); every other axis, ``world`` included,
    stays inside one pool.  A one-rank mesh needs no process group.

    With ``rank`` given, the mesh is a stand-in: the view of global rank
    ``rank``, every axis with its size, index and ranks and no process
    group, built without ``torch.distributed``.  It serves a step traced
    on shapes alone (``comms.shape_only``, the dry-run), which moves
    nothing."""
    for ways, n, flag in ((dp, nodes, "--nodes"), (tp, tp_nodes, "--tp-nodes"),
                          (pp, pp_nodes, "--pp-nodes"),
                          (cp, cp_nodes, "--cp-nodes")):
        if n < 1 or ways % n:
            raise ValueError(f"{flag} {n} must divide {ways}")
    if pool < 1 or pod < 1:
        raise ValueError(f"pool {pool} and pod {pod} must be >= 1")
    if pod > 1 and nodes > 1:
        raise ValueError(f"--pod {pod} and --nodes {nodes} are mutually "
                         f"exclusive outer data-parallel axes (the "
                         f"reference asserts the same)")
    world = pod * dp * cp * pp * tp
    stand_in = rank is not None
    if world * pool == 1 and not stand_in:
        return MeshInfo()
    if stand_in:
        if not 0 <= rank < world * pool:
            raise ValueError(f"rank {rank} outside a mesh of "
                             f"{world * pool} ranks")
        r = rank
    else:
        if not dist.is_initialized() or \
                dist.get_world_size() != world * pool:
            raise RuntimeError(
                f"a {pool} x {pod} x {dp} x {cp} x {pp} x {tp} (pool x pod x "
                f"data x cp x stage x model) mesh needs torch.distributed "
                f"initialized with {world * pool} ranks")
        r = dist.get_rank()
    # dim 0 is the pool, dim 1 the pod; the mesh dims below count from 2
    shape = (pool, pod, nodes, dp // nodes, cp_nodes, cp // cp_nodes,
             pp_nodes, pp // pp_nodes, tp_nodes, tp // tp_nodes)
    coord, rest = [], r
    for n in reversed(shape):
        coord.append(rest % n)
        rest //= n
    coord = coord[::-1]

    def axis(name, dims):
        """The axis over ``dims`` through this rank, named ``name``."""
        groups = _axis_groups(shape, dims, bind=not stand_in)
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

    data = factored(NODE_AXIS, LOCAL_AXIS, 2)
    context = factored(CP_NODE_AXIS, CP_AXIS, 4) if cp > 1 else None
    stage = factored(PP_NODE_AXIS, STAGE_AXIS, 6) if pp > 1 else None
    model = factored(TP_NODE_AXIS, MODEL_AXIS, 8)
    pair = isinstance(data, AxisPair)
    batch = data.joint if pair else None
    if pod > 1:      # the batch over (pod, data), pod-major
        batch = axis((POD_AXIS, LOCAL_AXIS), (1, 2, 3))
    # the loss's token sums: the batch and cp axes are adjacent in the
    # rank order, so one group covers them
    batch_cp = None
    if cp > 1:
        names = tuple(n for n, k in zip(
            (POD_AXIS, NODE_AXIS, LOCAL_AXIS, CP_NODE_AXIS, CP_AXIS),
            shape[1:6]) if k > 1)
        batch_cp = axis(names, (1, 2, 3, 4, 5))
    if pool == 1:
        whole = Axis("world", world, r, None, tuple(range(world)))
    else:
        whole = axis("world", tuple(range(1, len(shape))))
    return MeshInfo(
        tp=tp, dp=dp // nodes, pp=pp, pod=pod, node=nodes, tp_node=tp_nodes,
        pp_node=pp_nodes, cp=cp, cp_node=cp_nodes, pool=pool, model=model,
        data=data.inner if pair else data, stage=stage,
        nodes=data.outer if pair else None, batch=batch, context=context,
        batch_cp=batch_cp, world=whole,
        pools=axis(POOL_AXIS, (0,)) if pool > 1 else None,
        pods=axis(POD_AXIS, (1,)) if pod > 1 else None)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> MeshInfo:
    """The stand-in view of rank ``rank`` of the reference's production
    mesh: ``(data 16, model 16)``, 256 ranks, or with ``multi_pod`` ``(pod
    2, data 16, model 16)``, 512.  It is a description for the dry-run,
    which traces one rank and spawns nothing (:func:`make_mesh` with
    ``rank``)."""
    return make_mesh(16, 16, pod=2 if multi_pod else 1, rank=rank)


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
