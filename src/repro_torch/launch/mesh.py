"""Mesh definitions over ``torch.distributed`` (port of the flat
``make_mesh`` and ``comm_axes`` of ``repro.launch.mesh``).

The mesh is ``(data, model)``: ``model`` carries TP/SP, ``data`` DP and the
ZeRO-1 shards.  Ranks are laid out as the reference lays out devices,
row-major over ``(data, model)``: global rank ``r`` sits at data index
``r // tp`` and model index ``r % tp``, so "rank i owns chunk i" names the
same shard in both packages.  Hierarchical (node-factored), pipeline and
context-parallel axes are not yet ported.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.core.comms import Axis
from repro_torch.models.params import MeshInfo

LOCAL_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(dp: int, tp: int) -> MeshInfo:
    """This rank's view of a ``dp x tp`` mesh, its axes bound to process
    groups of the initialized default group (which must hold ``dp * tp``
    ranks).  A one-rank mesh needs no process group."""
    world = dp * tp
    if world == 1:
        return MeshInfo()
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(
            f"a {dp} x {tp} mesh needs torch.distributed initialized with "
            f"{world} ranks")
    r = dist.get_rank()
    d, t = divmod(r, tp)
    # every rank creates every group, in the same order
    model_ranks = [tuple(dd * tp + tt for tt in range(tp)) for dd in range(dp)]
    data_ranks = [tuple(dd * tp + tt for dd in range(dp)) for tt in range(tp)]
    model_groups = [dist.new_group(list(rs)) for rs in model_ranks] \
        if tp > 1 else [None] * dp
    data_groups = [dist.new_group(list(rs)) for rs in data_ranks] \
        if dp > 1 else [None] * tp
    return MeshInfo(
        tp=tp, dp=dp,
        model=Axis(MODEL_AXIS, tp, t, model_groups[d], model_ranks[d]),
        data=Axis(LOCAL_AXIS, dp, d, data_groups[t], data_ranks[t]),
        world=Axis("world", world, r, None, tuple(range(world))))


def comm_axes(mi: MeshInfo, logical: str) -> Axis:
    """Logical parallelism axis (``"data"`` or ``"model"``) -> the comms
    axis this rank passes to the collectives."""
    if logical == MODEL_AXIS:
        return mi.tp_axes
    if logical == LOCAL_AXIS:
        return mi.dp_axes
    raise NotImplementedError(f"mesh axis {logical!r} is not yet ported")
