"""Dense KV cache layouts for the batched server (port of
``repro.serve.kv_cache`` for the ``attn`` and ``moe`` kinds, whose
attention caches are alike).

Every shape here is this rank's LOCAL shape; the spec beside it tags each
dim as the reference's ``PartitionSpec`` does (``"data"`` for the batch
axes, ``"model"`` for the model axes, ``None`` replicated), so a reader
can find the counterpart.  The reference's global layouts:

  decode, attn(ring)  k/v [L, B, S_max, KV, hd]  P(None, bs, seq, None, None)
                      the sequence sharded over ``seq_axes`` (the joint
                      model axes here); flash-decoding merges the shards
  decode, attn(head)  k/v [L, B, S_max, KV, hd]  P(None, bs, None, model, None)
                      the KV heads sharded over the model axes

with ``bs`` the batch axes, or ``None`` for a batch of one (replicated).
Prefill emits its caches in the TRAINING layout (``prefill_cache_specs``):
ring mode this rank's sequence slice of every head, head mode the whole
sequence of this rank's heads;
:meth:`~repro_torch.serve.serve_step.Server.pad_prefill_caches` moves them
into the decode layout.  Recurrent, cross-attention and shared-attention
caches are not yet ported.
"""

from __future__ import annotations

from repro_torch.models.config import ArchConfig, BlockGroup
from repro_torch.models.params import MeshInfo, torch_dtype
from repro_torch.serve.paged_kv import Struct, zero_pool


def _check_kind(g: BlockGroup) -> None:
    if g.kind not in ("attn", "moe"):
        raise NotImplementedError(
            f"dense KV cache of group kind {g.kind!r} is not yet ported")


def batch_local(B: int, mi: MeshInfo) -> int:
    """Rows of a batch of ``B`` on this rank: ``B`` split over the batch
    axes, or one row on every rank."""
    if B == 1:
        return 1
    if B % mi.batch_ways:
        raise ValueError(f"batch {B} does not split over the data ways "
                         f"({mi.batch_ways})")
    return B // mi.batch_ways


def _bs(B: int):
    return None if B == 1 else "data"


def group_cache(cfg: ArchConfig, mi: MeshInfo, g: BlockGroup, B: int,
                s_max: int, mode: str, dtype=None):
    """-> (struct tree, spec tree) of one group's stacked decode caches."""
    _check_kind(g)
    dt = torch_dtype(dtype or cfg.dtype)
    hd, KV, L = cfg.head_dim_, cfg.n_kv_heads, g.n
    b = batch_local(B, mi)
    if mode == "head":
        if KV % mi.tp:
            raise ValueError(f"head-mode cache needs n_kv_heads ({KV}) "
                             f"divisible by tp ({mi.tp})")
        shape = (L, b, s_max, KV // mi.tp, hd)
        spec = (None, _bs(B), None, "model", None)
    else:
        if s_max % mi.tp:
            raise ValueError(f"ring-mode cache needs s_max ({s_max}) "
                             f"divisible by tp ({mi.tp})")
        shape = (L, b, s_max // mi.tp, KV, hd)
        spec = (None, _bs(B), "model", None, None)
    return ({"k": Struct(shape, dt), "v": Struct(shape, dt)},
            {"k": spec, "v": spec})


def cache_structs(cfg: ArchConfig, mi: MeshInfo, B: int, s_max: int):
    """The whole decode cache: (structs, specs), lists aligned with
    ``cfg.layer_groups``."""
    mode = cfg.attn_mode_for(mi.tp)
    structs, specs = [], []
    for g in cfg.layer_groups:
        st, sp = group_cache(cfg, mi, g, B, s_max, mode)
        structs.append(st)
        specs.append(sp)
    return structs, specs


def zero_caches(structs, device):
    """Zeroed tensors for a struct tree on ``device``."""
    return zero_pool(structs, device)


def prefill_cache_specs(cfg: ArchConfig, mi: MeshInfo, B: int):
    """Specs of ``Model.forward(phase="prefill")``'s caches (the training
    layout): ring mode the sequence dim over the model axes (this rank's
    slice), head mode the heads dim."""
    mode = cfg.attn_mode_for(mi.tp)
    kv = (None, _bs(B), None, "model", None) if mode == "head" else \
        (None, _bs(B), "model", None, None)
    out = []
    for g in cfg.layer_groups:
        _check_kind(g)
        out.append({"k": kv, "v": kv})
    return out
