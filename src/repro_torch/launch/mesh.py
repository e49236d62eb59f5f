"""Mesh definitions over ``torch.distributed`` (port of the flat
``make_mesh`` and ``comm_axes`` of ``repro.launch.mesh``).

The mesh is ``(data, stage, model)``: ``model`` carries TP/SP, ``stage``
the pipeline stages, ``data`` DP and the ZeRO-1 shards.  Ranks are laid
out as the reference lays out devices, row-major over ``(data, stage,
model)``: global rank ``r = (d * pp + s) * tp + t`` sits at data index
``d``, stage index ``s`` and model index ``t``, so "rank i owns chunk i"
names the same shard in both packages.  Hierarchical (node-factored) and
context-parallel axes are not yet ported.
"""

from __future__ import annotations

import itertools

import torch.distributed as dist

from repro_torch.core.comms import Axis
from repro_torch.models.params import MeshInfo

LOCAL_AXIS = "data"
STAGE_AXIS = "stage"
MODEL_AXIS = "model"


def _axis_groups(shape: tuple, k: int) -> dict:
    """Process groups along mesh dim ``k`` of a row-major rank grid of
    ``shape``: ``{other coords: (ranks along dim k, group)}``.  Every rank
    creates every group, in the same order, as ``new_group`` requires; a
    dim of size 1 needs none."""
    others = [range(n) if i != k else range(1) for i, n in enumerate(shape)]
    out = {}
    for c in itertools.product(*others):
        ranks = []
        for j in range(shape[k]):
            idx = list(c)
            idx[k] = j
            r = 0
            for i, n in zip(idx, shape):
                r = r * n + i
            ranks.append(r)
        key = tuple(v for i, v in enumerate(c) if i != k)
        out[key] = (tuple(ranks),
                    dist.new_group(ranks) if shape[k] > 1 else None)
    return out


def make_mesh(dp: int, tp: int, pp: int = 1) -> MeshInfo:
    """This rank's view of a ``dp x pp x tp`` mesh, its axes bound to
    process groups of the initialized default group (which must hold
    ``dp * pp * tp`` ranks).  A one-rank mesh needs no process group."""
    world = dp * pp * tp
    if world == 1:
        return MeshInfo()
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise RuntimeError(
            f"a {dp} x {pp} x {tp} (data x stage x model) mesh needs "
            f"torch.distributed initialized with {world} ranks")
    r = dist.get_rank()
    shape = (dp, pp, tp)
    d, s, t = r // (pp * tp), (r // tp) % pp, r % tp
    data, stage, model = (_axis_groups(shape, k) for k in range(3))

    def axis(name, groups, key, index, size):
        ranks, group = groups[key]
        return Axis(name, size, index, group, ranks)
    return MeshInfo(
        tp=tp, dp=dp, pp=pp,
        model=axis(MODEL_AXIS, model, (d, s), t, tp),
        data=axis(LOCAL_AXIS, data, (s, t), d, dp),
        stage=axis(STAGE_AXIS, stage, (d, t), s, pp) if pp > 1 else None,
        world=Axis("world", world, r, None, tuple(range(world))))


def comm_axes(mi: MeshInfo, logical: str) -> Axis:
    """Logical parallelism axis (``"data"``, ``"stage"`` or ``"model"``)
    -> the comms axis this rank passes to the collectives."""
    if logical == MODEL_AXIS:
        return mi.tp_axes
    if logical == LOCAL_AXIS:
        return mi.dp_axes
    if logical == STAGE_AXIS:
        if mi.stage_axes is None:
            raise ValueError("mesh has no stage axis")
        return mi.stage_axes
    raise NotImplementedError(f"mesh axis {logical!r} is not yet ported")


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
