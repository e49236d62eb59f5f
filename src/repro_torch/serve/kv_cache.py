"""Dense cache layouts for the batched server (port of
``repro.serve.kv_cache``: the ``attn``, ``moe`` and ``shared_attn``
kinds, whose attention caches are alike, whisper's ``dec_attn`` with its
cross-attention cache, and the recurrent kinds).

Every shape here is this rank's LOCAL shape; the spec beside it tags each
dim as the reference's ``PartitionSpec`` does (``"data"`` for the batch
axes, ``"model"`` for the model axes, ``None`` replicated), so a reader
can find the counterpart.  The reference's global layouts:

  decode, attn(ring)  k/v [L, B, S_max, KV, hd]  P(None, bs, seq, None, None)
                      the sequence sharded over ``seq_axes`` (the joint
                      model axes here); flash-decoding merges the shards
  decode, attn(head)  k/v [L, B, S_max, KV, hd]  P(None, bs, None, model, None)
                      the KV heads sharded over the model axes

  dec_attn            adds xk/xv [L, B, S_enc, KV, hd], laid out as k/v,
                      and xlen [L] int32, replicated
  enc_attn            no cache (``None``: the encoder runs at prefill)
  shared_attn         k/v [B, S_max, KV, hd]     one insertion point, unstacked
  mamba               conv [L, B, K-1, d_inner]   P(None, bs, None, model)
                      state [L, B, H, P, N] f32  P(None, bs, model, None, None)
  mlstm               C [L, B, H, Pv, hd] f32    P(None, bs, None, model, None)
                      n [L, B, H, hd] f32        replicated over model
  slstm               h/c/n/m [L, B, H, hd] f32  replicated over model

with ``bs`` the batch axes, or ``None`` for a batch of one (replicated).
Prefill emits its attention caches in the TRAINING layout
(``prefill_cache_specs``): ring mode this rank's sequence slice of every
head, head mode the whole sequence of this rank's heads;
:meth:`~repro_torch.serve.serve_step.Server.pad_prefill_caches` moves them
into the decode layout.  A recurrent block's prefill hands over its final
state already in the decode layout.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig, BlockGroup
from repro_torch.models.params import MeshInfo, torch_dtype
from repro_torch.serve.paged_kv import Struct, zero_pool


_STATE_KINDS = ("mamba", "mlstm", "slstm")
_KINDS = ("attn", "moe", "shared_attn", "enc_attn", "dec_attn") + \
    _STATE_KINDS


def _check_kind(g: BlockGroup) -> None:
    if g.kind not in _KINDS:
        raise ValueError(g.kind)


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


def _value_width(cfg) -> int:
    """An mLSTM head's value width ``Pv``."""
    return int(cfg.proj_factor * cfg.d_model) // cfg.n_heads


def _state_specs(cfg, kind: str, bs, tp: int) -> dict:
    """Specs of a recurrent kind's state, which the prefill hands over in
    the decode layout: a mamba layer's conv tail and state sharded on
    their channels and heads, an mLSTM's ``C`` on its value dim where that
    divides by tp (``n`` replicated), an sLSTM's state replicated."""
    if kind == "mamba":
        return {"conv": (None, bs, None, "model"),
                "state": (None, bs, "model", None, None)}
    if kind == "mlstm":
        c = "model" if _value_width(cfg) % tp == 0 and tp > 1 else None
        return {"C": (None, bs, None, c, None), "n": (None, bs, None, None)}
    return {k: (None, bs, None, None) for k in "hcnm"}


def group_cache(cfg: ArchConfig, mi: MeshInfo, g: BlockGroup, B: int,
                s_max: int, mode: str, dtype=None, s_enc: int = 0):
    """-> (struct tree, spec tree) of one group's stacked decode caches
    (a ``dec_attn`` group's cross-attention K/V ``s_enc`` long)."""
    _check_kind(g)
    dt = torch_dtype(dtype or cfg.dtype)
    f32 = torch.float32
    hd, L, tp = cfg.head_dim_, g.n, mi.tp
    b = batch_local(B, mi)
    bs = _bs(B)
    if g.kind in _STATE_KINDS:
        spec = _state_specs(cfg, g.kind, bs, tp)
        if g.kind == "mamba":
            di, P = cfg.d_inner, cfg.ssm_head_dim
            shapes = {"conv": ((L, b, cfg.conv_kernel - 1, di // tp), dt),
                      "state": ((L, b, di // P // tp, P, cfg.ssm_state),
                                f32)}
        elif g.kind == "mlstm":
            Pv = _value_width(cfg)
            if Pv % tp:
                raise ValueError(f"mlstm cache needs its value width per "
                                 f"head ({Pv}) divisible by tp ({tp})")
            shapes = {"C": ((L, b, cfg.n_heads, Pv // tp, hd), f32),
                      "n": ((L, b, cfg.n_heads, hd), f32)}
        else:
            shapes = {k: ((L, b, cfg.n_heads, cfg.d_model // cfg.n_heads),
                          f32) for k in "hcnm"}
        return {k: Struct(*v) for k, v in shapes.items()}, spec
    kv_shape, spec = _kv_layout(cfg, mi, L, b, s_max, mode, bs)
    st = {"k": Struct(kv_shape, dt), "v": Struct(kv_shape, dt)}
    sp = {"k": spec, "v": spec}
    if g.kind == "dec_attn":
        x_shape, _ = _kv_layout(cfg, mi, L, b, s_enc, mode, bs)
        st.update(xk=Struct(x_shape, dt), xv=Struct(x_shape, dt),
                  xlen=Struct((L,), torch.int32))
        sp.update(xk=spec, xv=spec, xlen=(None,))
    if g.kind == "shared_attn":         # one insertion point, unstacked
        st = {k: Struct(v.shape[1:], v.dtype) for k, v in st.items()}
        sp = {k: v[1:] for k, v in sp.items()}
    return st, sp


def _kv_layout(cfg, mi: MeshInfo, L: int, b: int, s: int, mode: str, bs):
    """Local shape and spec of a stacked K/V cache ``s`` long: head mode
    the whole sequence of this rank's KV heads, ring mode this rank's
    sequence shard of every head."""
    hd, KV = cfg.head_dim_, cfg.n_kv_heads
    if mode == "head":
        if KV % mi.tp:
            raise ValueError(f"head-mode cache needs n_kv_heads ({KV}) "
                             f"divisible by tp ({mi.tp})")
        return (L, b, s, KV // mi.tp, hd), (None, bs, None, "model", None)
    if s % mi.tp:
        raise ValueError(f"ring-mode cache needs its length ({s}) "
                         f"divisible by tp ({mi.tp})")
    return (L, b, s // mi.tp, KV, hd), (None, bs, "model", None, None)


def cache_structs(cfg: ArchConfig, mi: MeshInfo, B: int, s_max: int,
                  s_enc: int = 0):
    """The whole decode cache: (structs, specs), lists aligned with
    ``cfg.layer_groups`` (``None`` for an encoder group); ``s_enc`` is the
    length of the cross-attention cache."""
    mode = cfg.attn_mode_for(mi.tp)
    structs, specs = [], []
    for g in cfg.layer_groups:
        if g.kind == "enc_attn":
            structs.append(None)
            specs.append(None)
            continue
        st, sp = group_cache(cfg, mi, g, B, s_max, mode, s_enc=s_enc)
        structs.append(st)
        specs.append(sp)
    return structs, specs


def zero_caches(structs, device):
    """Zeroed tensors for a struct tree on ``device``."""
    return zero_pool(structs, device)


def prefill_cache_specs(cfg: ArchConfig, mi: MeshInfo, B: int):
    """Specs of ``Model.forward(phase="prefill")``'s caches: an attention
    cache in the training layout (ring mode the sequence dim over the
    model axes, this rank's slice; head mode the heads dim), a recurrent
    state in the decode layout (:func:`_state_specs`)."""
    mode = cfg.attn_mode_for(mi.tp)
    bs = _bs(B)
    kv = (None, bs, None, "model", None) if mode == "head" else \
        (None, bs, "model", None, None)
    out = []
    for g in cfg.layer_groups:
        _check_kind(g)
        if g.kind in _STATE_KINDS:
            out.append(_state_specs(cfg, g.kind, bs, mi.tp))
        elif g.kind == "shared_attn":
            out.append({"k": kv[1:], "v": kv[1:]})
        elif g.kind == "enc_attn":
            out.append(None)
        elif g.kind == "dec_attn":
            out.append({"k": kv, "v": kv, "xk": kv, "xv": kv})
        else:
            out.append({"k": kv, "v": kv})
    return out
