"""Dense cache layouts for the batched server (port of
``repro.serve.kv_cache``: the ``attn``, ``moe`` and ``shared_attn``
kinds, whose attention caches are alike, whisper's ``dec_attn`` with its
cross-attention cache, and the recurrent kinds).

Every shape here is this rank's LOCAL shape; the spec beside it tags each
dim as the reference's ``PartitionSpec`` does (``"data"`` for the batch
axes, ``"model"`` for the model axes, ``None`` replicated), so a reader
can find the counterpart.  The reference's global layouts:

  decode, attn(ring)  k/v [L, B, S_max, KV, hd]  P(None, bs, seq, None, None)
                      the sequence sharded over ``seq_axes``: the joint
                      model axes for batched decode (``("model",)``),
                      the data and model axes, data-major, for the
                      long-context decode (``("data", "model")``, a
                      batch of one); flash-decoding merges the shards
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

with ``bs`` the batch axes, or ``None`` for a batch of one or where
``seq_axes`` holds ``"data"`` (the batch replicated).
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


def batch_local(B: int, mi: MeshInfo, seq_axes=("model",)) -> int:
    """Rows of a batch of ``B`` on this rank: ``B`` split over the batch
    axes, or the whole batch on every rank for a batch of one or where the
    cache's sequence shards over ``"data"`` (the reference's
    ``_batch_spec``)."""
    if B == 1 or "data" in seq_axes:
        return B
    if B % mi.batch_ways:
        raise ValueError(f"batch {B} does not split over the data ways "
                         f"({mi.batch_ways})")
    return B // mi.batch_ways


def _bs(B: int, seq_axes=("model",)):
    return None if B == 1 or "data" in seq_axes else "data"


def seq_ways(mi: MeshInfo, seq_axes=("model",)) -> int:
    """Shards of a ring-mode cache's sequence: the product of the sizes of
    ``seq_axes`` (``"model"`` the joint model axes, ``"data"`` the inner
    data axis)."""
    n = 1
    for ax in seq_axes:
        n *= {"model": mi.tp, "data": mi.dp}[ax]
    return n



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
                s_max: int, mode: str, dtype=None, s_enc: int = 0,
                seq_axes=("model",)):
    """-> (struct tree, spec tree) of one group's stacked decode caches
    (a ``dec_attn`` group's cross-attention K/V ``s_enc`` long), a
    ring-mode cache's sequence sharded over ``seq_axes``."""
    _check_kind(g)
    dt = torch_dtype(dtype or cfg.dtype)
    f32 = torch.float32
    hd, L, tp = cfg.head_dim_, g.n, mi.tp
    b = batch_local(B, mi, seq_axes)
    bs = _bs(B, seq_axes)
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
    kv_shape, spec = _kv_layout(cfg, mi, L, b, s_max, mode, bs, seq_axes)
    st = {"k": Struct(kv_shape, dt), "v": Struct(kv_shape, dt)}
    sp = {"k": spec, "v": spec}
    if g.kind == "dec_attn":
        x_shape, _ = _kv_layout(cfg, mi, L, b, s_enc, mode, bs, seq_axes)
        st.update(xk=Struct(x_shape, dt), xv=Struct(x_shape, dt),
                  xlen=Struct((L,), torch.int32))
        sp.update(xk=spec, xv=spec, xlen=(None,))
    if g.kind == "shared_attn":         # one insertion point, unstacked
        st = {k: Struct(v.shape[1:], v.dtype) for k, v in st.items()}
        sp = {k: v[1:] for k, v in sp.items()}
    return st, sp


def _kv_layout(cfg, mi: MeshInfo, L: int, b: int, s: int, mode: str, bs,
               seq_axes=("model",)):
    """Local shape and spec of a stacked K/V cache ``s`` long: head mode
    the whole sequence of this rank's KV heads, ring mode this rank's
    sequence shard (over ``seq_axes``) of every head."""
    hd, KV = cfg.head_dim_, cfg.n_kv_heads
    if mode == "head":
        if KV % mi.tp:
            raise ValueError(f"head-mode cache needs n_kv_heads ({KV}) "
                             f"divisible by tp ({mi.tp})")
        return (L, b, s, KV // mi.tp, hd), (None, bs, None, "model", None)
    n = seq_ways(mi, seq_axes)
    if s % n:
        raise ValueError(f"ring-mode cache needs its length ({s}) "
                         f"divisible by its {n} sequence shards "
                         f"({' x '.join(seq_axes)})")
    # the sequence dim's spec: "model", or the axes it shards over
    seq = "model" if tuple(seq_axes) == ("model",) else tuple(seq_axes)
    return (L, b, s // n, KV, hd), (None, bs, seq, None, None)


def cache_structs(cfg: ArchConfig, mi: MeshInfo, B: int, s_max: int,
                  s_enc: int = 0, seq_axes=("model",)):
    """The whole decode cache: (structs, specs), lists aligned with
    ``cfg.layer_groups`` (``None`` for an encoder group); ``s_enc`` is the
    length of the cross-attention cache, ``seq_axes`` the axes a ring-mode
    cache's sequence shards over (``("model",)`` or ``("data",
    "model")``)."""
    mode = cfg.attn_mode_for(mi.tp)
    structs, specs = [], []
    for g in cfg.layer_groups:
        if g.kind == "enc_attn":
            structs.append(None)
            specs.append(None)
            continue
        st, sp = group_cache(cfg, mi, g, B, s_max, mode, s_enc=s_enc,
                             seq_axes=seq_axes)
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


def _dim_axes(e, mi: MeshInfo) -> list:
    """The comms axes of a spec entry: ``"data"`` the batch axes,
    ``"model"`` the joint model axes, a tuple its axes in order (where
    ``"data"`` is the inner data axis: a sequence sharding)."""
    if e is None:
        return []
    if e == "data":
        return [mi.batch_axes]
    if e == "model":
        return [mi.tp_axes]
    return [{"data": mi.dp_axes, "model": mi.tp_axes}[a] for a in e]


def local_cache(tree, specs, mi: MeshInfo):
    """This rank's shards of a GLOBAL cache tree (numpy arrays or tensors,
    laid out as the reference's ``cache_structs``, ``None`` for an encoder
    group), by the spec tree :func:`cache_structs` gives: each sharded dim
    cut into the product of its axes' sizes, this rank's piece taken at
    its linear index over them (outer axis first).  This carries the
    reference's caches into this package's layout, the long-context
    ``("data", "model")`` one included."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return [local_cache(t, sp, mi) for t, sp in zip(tree, specs)]
    if isinstance(tree, dict):
        return {k: local_cache(v, specs[k], mi) for k, v in tree.items()}
    idx = []
    for size, e in zip(tree.shape, specs):
        axes = _dim_axes(e, mi)
        n, at = 1, 0
        for ax in axes:
            n, at = n * ax.size, at * ax.size + ax.index
        w = size // n
        idx.append(slice(at * w, (at + 1) * w))
    return tree[tuple(idx)]


def fill_caches(structs, specs, index: int, seed: int, mi: MeshInfo,
                device, s_enc: int = 0) -> list:
    """Decode caches filled, in place of a prefill, with seeded standard
    normals at every sequence position before ``index`` (zeros after), as
    a prompt of ``index`` tokens would leave them, each rank drawing its
    own shard (a generator per leaf and shard, so the values follow the
    layout).  A cross-attention cache is filled whole (``xlen`` holds
    ``s_enc``); a recurrent state stays zero (a fresh state).  A
    long-context cache too long to prefill is filled this way."""
    out = []
    for gi, (st, sp) in enumerate(zip(structs, specs)):
        if st is None:
            out.append(None)
            continue
        new = {}
        for li, k in enumerate(sorted(st)):
            s = st[k]
            t = torch.zeros(s.shape, dtype=s.dtype, device=device)
            if k == "xlen":
                t.fill_(s_enc)
            elif k in ("k", "v", "xk", "xv"):
                d = len(s.shape) - 3            # the sequence dim
                at = 0
                for ax in _dim_axes(sp[k][d], mi):
                    at = at * ax.size + ax.index
                lo = at * s.shape[d]
                n = s.shape[d] if k in ("xk", "xv") else \
                    max(0, min(s.shape[d], index - lo))
                gen = torch.Generator(device=device).manual_seed(
                    (seed * 1_000_003 + gi * 1009 + li) * 65_537 + at)
                if n:
                    t.narrow(d, 0, n).copy_(torch.randn(
                        t.narrow(d, 0, n).shape, generator=gen,
                        device=device, dtype=torch.float32))
            new[k] = t
        out.append(new)
    return out
