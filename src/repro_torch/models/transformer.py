"""Block assembly (port of ``repro.models.transformer``): parameter
plans, the training and prefill bodies, and the dense and paged decode
bodies of the attention, Mixture-of-Experts, Mamba2, mLSTM and sLSTM
groups, zamba2's shared attention block, and whisper's encoder
(``enc_attn``: attention without the causal mask) and decoder
(``dec_attn``: self-attention, cross-attention to the encoder's output,
MLP) layers.

Each group's ``n`` identical layers are stacked on a leading axis, as in
the reference; where the reference runs ``lax.scan`` over that axis, a
Python loop walks it here.  On a pipeline mesh the groups describe one
stage's chunk and carry a leading stage dim (``[pp, n, ...]``, or ``[vpp,
pp, n, ...]`` under interleaved virtual stages), as in the reference.
A ``remat`` config (every full-size one) rematerializes its layers in
training, where the reference wraps its scan body in ``jax.checkpoint``:
each layer runs under :func:`~repro_torch.core.comms.checkpointed`, so
only its input stays alive for the backward pass, which runs its forward
again, collectives included; their forward events carry ``remat`` and
are priced twice.  The pipeline's remat policy checkpoints whole stage
bodies around that.

A ``shared_attn`` group holds no weights of its own: it applies the
top-level ``shared`` attention block (one set of weights) at each of its
insertion points, each with one unstacked cache, so the shared block's
gradient sums over its insertions.

A ``fsdp_params`` model annotates its layer-group plans (never the
embedding or head) with :func:`~repro_torch.models.params.apply_fsdp`;
the group trees the bodies walk then hold those leaves as
:class:`~repro_torch.models.params.Pv` (``Model.group_params``), which
the slicing helpers here keep wrapped, dropping the spec entries of the
dims they take, so each layer's ``layers.use`` re-gathers one layer's
shard at a time, as the reference's scan body does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import comms
from repro_torch.models import attention, layers, moe, ssm, xlstm
from repro_torch.models.config import ArchConfig, BlockGroup
from repro_torch.models.params import MeshInfo, Pv, apply_fsdp, tree_map_defs

# kinds the stage-stacked pipeline plan cannot express (the reference's
# list): encoder context and cross-stage weight sharing both couple layers
# that would live on different stages
_PP_UNSUPPORTED = ("enc_attn", "dec_attn", "shared_attn")


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

_KINDS = ("attn", "moe", "mamba", "mlstm", "slstm", "shared_attn",
          "enc_attn", "dec_attn")

# the recurrent kinds: (plan, train/prefill body, decode body)
_RECURRENT = {
    "mamba": (ssm.mamba_plan, ssm.mamba_block, ssm.mamba_decode),
    "mlstm": (xlstm.mlstm_plan, xlstm.mlstm_block, xlstm.mlstm_decode),
    "slstm": (xlstm.slstm_plan, xlstm.slstm_block, xlstm.slstm_decode),
}


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(kind)


def block_plan(cfg: ArchConfig, kind: str, mode: str):
    _check_kind(kind)
    if kind == "shared_attn":
        return {}                   # its weights live at the top level
    p = {"ln1": layers.norm_plan(cfg, cfg.d_model)}
    if kind in _RECURRENT:
        p[kind] = _RECURRENT[kind][0](cfg)
        return p
    p["attn"] = attention.attn_plan(cfg, mode)
    if kind == "dec_attn":          # whisper's decoder: cross-attention
        p.update(lnx=layers.norm_plan(cfg, cfg.d_model),
                 xattn=attention.attn_plan(cfg, mode),
                 ln2=layers.norm_plan(cfg, cfg.d_model),
                 mlp=layers.mlp_plan(cfg))
    elif kind == "moe":
        p.update(ln2=layers.norm_plan(cfg, cfg.d_model),
                 moe=moe.moe_plan(cfg))
    elif cfg.d_ff:
        p.update(ln2=layers.norm_plan(cfg, cfg.d_model),
                 mlp=layers.mlp_plan(cfg))
    return p


def _stack(plan, n: int):
    return tree_map_defs(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      spec=(None,) + d.spec), plan)


def _stage_stack(plan, pp: int, vpp: int = 1):
    """Prepend a leading stage dim sharded over the stage axis; ``vpp > 1``
    prepends ``(vpp, pp)`` instead (dim 0 the rank's round-robin slice,
    replicated; dim 1 the stage shard), whose v-major order ``v * pp + s``
    is the global chunk order."""
    if vpp > 1:
        return tree_map_defs(
            lambda d: dataclasses.replace(d, shape=(vpp, pp) + d.shape,
                                          spec=(None, "stage") + d.spec),
            plan)
    return tree_map_defs(
        lambda d: dataclasses.replace(d, shape=(pp,) + d.shape,
                                      spec=("stage",) + d.spec), plan)


def take_stage(tree, v=None):
    """This rank's stage-stacked group params ``[1, n, ...]`` -> its
    ``[n, ...]`` slice (views); with ``v`` (interleaved layout, local
    ``[vpp, 1, n, ...]``) the rank's ``v``-th round-robin slice."""
    if isinstance(tree, dict):
        return {k: take_stage(t, v) for k, t in tree.items()}
    if isinstance(tree, Pv):
        return Pv(take_stage(tree.v, v), tree.spec[1 if v is None else 2:])
    return tree[0] if v is None else tree[v, 0]


def stage_partition(cfg: ArchConfig, pp: int, vpp: int = 1) -> tuple:
    """Partition the layer stack into ``pp * vpp`` contiguous, identical
    chunks and return the BlockGroup plan of one chunk (every chunk runs
    the same layer sequence: the stages share one stage-stacked plan).
    Chunk ``c`` lives on stage ``c % pp`` as its ``c // pp``-th virtual
    slice.  Raises ValueError, with the reference's messages, when the
    per-layer (kind, window) sequence does not tile."""
    per_layer = [(g.kind, g.window) for g in cfg.layer_groups
                 for _ in range(g.n)]
    bad = sorted({k for k, _ in per_layer if k in _PP_UNSUPPORTED})
    if bad:
        raise ValueError(
            f"pipeline stages cannot hold {bad} layers (encoder context / "
            "cross-stage weight sharing)")
    total = len(per_layer)
    chunks = pp * vpp
    layout = f"pp={pp} x vpp={vpp} virtual" if vpp > 1 else f"pp={pp}"
    if total % chunks:
        raise ValueError(
            f"{total} layers do not split into {layout} stages")
    per = total // chunks
    first = per_layer[:per]
    for s in range(1, chunks):
        if per_layer[s * per:(s + 1) * per] != first:
            raise ValueError(
                f"stages are not identical ({layout}): chunk {s} is "
                f"{per_layer[s * per:(s + 1) * per]}, chunk 0 is {first} — "
                "the SPMD 1F1B schedule needs a uniform per-stage layer "
                "sequence")
    groups = []
    for kind, window in first:
        if groups and groups[-1].kind == kind and groups[-1].window == window:
            groups[-1] = dataclasses.replace(groups[-1], n=groups[-1].n + 1)
        else:
            groups.append(BlockGroup(kind, 1, window=window))
    return tuple(groups)


def chunk_layer_ranges(n_layers: int, pp: int, vpp: int = 1) -> dict:
    """Global layer interval of every ``(stage, v)`` chunk: chunk ``c = v *
    pp + s`` covers ``[c * Lc, (c + 1) * Lc)``, ``Lc = n_layers // (pp *
    vpp)``."""
    chunks = pp * vpp
    if n_layers % chunks:
        raise ValueError(f"{n_layers} layers do not split into {chunks} "
                         "chunks")
    lc = n_layers // chunks
    return {(s, v): ((v * pp + s) * lc, (v * pp + s + 1) * lc)
            for v in range(vpp) for s in range(pp)}


def model_plan(cfg: ArchConfig, mi: MeshInfo, vpp: int = 1):
    """The parameter plan.  On a stage mesh (``mi.pp > 1``) the groups
    describe one stage chunk, stage-stacked; the embedding, the untied
    head and the final norm stay stage-replicated: consumed on the first
    and last stage, their gradients folded over the stage axis by the
    optimizer.  ``cfg.fsdp_params`` shards the big leaves of each layer's
    plan over data (ZeRO-3, before the layers are stacked)."""
    mode = cfg.attn_mode_for(mi.tp)
    plan = {"embed": layers.embed_plan(cfg)}
    plan.update(layers.lm_head_plan(cfg))
    plan["final_norm"] = layers.norm_plan(cfg, cfg.d_model)
    stage_groups = stage_partition(cfg, mi.pp, vpp) if mi.pp > 1 \
        else cfg.layer_groups
    groups = []
    for g in stage_groups:
        gp = block_plan(cfg, g.kind, mode)
        if cfg.fsdp_params:
            gp = apply_fsdp(gp, mi.dp)
        gp = _stack(gp, g.n)
        if mi.pp > 1:
            gp = _stage_stack(gp, mi.pp, vpp)
        groups.append(gp)
    plan["groups"] = groups
    if any(g.kind == "shared_attn" for g in cfg.layer_groups):
        sp = block_plan(cfg, "attn", mode)
        plan["shared"] = apply_fsdp(sp, mi.dp) if cfg.fsdp_params else sp
    if cfg.encoder_layers:
        plan["enc_norm"] = layers.norm_plan(cfg, cfg.d_model)
    return plan


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked group tree (views, no copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Pv):
        return Pv(tree.v[i], tree.spec[1:])
    return tree[i]


def _unstack(tree, n: int) -> list:
    """A stacked group tree -> ``n`` per-layer trees of views.  ``unbind``
    keeps autograd to one stacked gradient per leaf (indexing each layer
    would allocate a full-size gradient per layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, Pv):
        return [Pv(t, tree.spec[1:]) for t in tree.v.unbind(0)]
    return list(tree.unbind(0))


# --------------------------------------------------------------------------
# training bodies
# --------------------------------------------------------------------------

def zero_aux(device) -> dict:
    """The aux of a stack without experts (the reference's ``_zero_aux``)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "drop_frac": z}


def add_aux(acc, aux):
    """Sum two MoE aux dicts ``{lb_loss, drop_frac}``; ``None`` is the
    zero aux of a layer without experts (the reference adds its
    ``_zero_aux``, which changes no bit of the sum)."""
    if aux is None:
        return acc
    if acc is None:
        return aux
    return {k: acc[k] + aux[k] for k in acc}


def run_block(kind, p, x, cfg, mi, mode, g: BlockGroup, pos,
              phase="train", pos3=None, cross=None, cross_pos=None):
    """One training layer: x [B, S_loc, D] -> (x, its cache at
    ``phase="prefill"`` ({k, v}, whisper's decoder also {xk, xv}, the
    cross-attention's K/V; or a recurrent kind's decode-layout state) else
    ``None``, its MoE aux or ``None``).  ``pos3`` are M-RoPE position ids
    (qwen2-vl); ``cross`` / ``cross_pos`` are the encoder's output slice
    and its positions, which a ``dec_attn`` layer attends to.  An
    ``enc_attn`` layer attends without the causal mask."""
    _check_kind(kind)
    want_cache = phase == "prefill"
    cache = aux = None
    if kind in _RECURRENT:
        h = layers.norm(p["ln1"], x, cfg, mi)
        r = _RECURRENT[kind][1](p[kind], h, cfg, mi, sp=True,
                                want_cache=want_cache)
        if want_cache:
            r, cache = r
        return x + r.to(x.dtype), cache, None
    h = layers.norm(p["ln1"], x, cfg, mi)
    r = attention.attn_train(p["attn"], h, pos, cfg, mi, mode,
                             causal=cfg.causal and kind != "enc_attn",
                             window=g.window, want_cache=want_cache,
                             pos3=pos3)
    if want_cache:
        r, (k, v, _) = r
        cache = {"k": k, "v": v}
    x = x + r
    if kind == "dec_attn":
        h = layers.norm(p["lnx"], x, cfg, mi)
        r = attention.attn_train(p["xattn"], h, pos, cfg, mi, mode,
                                 causal=False, window=0,
                                 want_cache=want_cache, cross=cross,
                                 cross_pos=cross_pos)
        if want_cache:
            r, (k, v, _) = r
            cache.update(xk=k, xv=v)
        x = x + r
    if kind == "moe":
        h = layers.norm(p["ln2"], x, cfg, mi)
        r, aux = moe.moe_block(p["moe"], h, cfg, mi, sp=True)
        x = x + r
    elif cfg.d_ff:
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + layers.mlp(p["mlp"], h, cfg, mi, sp=True)
    return x, cache, aux


def run_group(gp, x, g: BlockGroup, cfg, mi, mode, pos, phase="train",
              pos3=None, shared=None, cross=None, cross_pos=None):
    """The group's ``n`` layers in order -> (x, the layers' caches stacked
    [n, ...] at ``phase="prefill"`` else ``None``, the layers' MoE aux
    summed or ``None``).  A ``shared_attn`` group applies ``shared`` (the
    top-level block) at each insertion; its cache is the first one's,
    unstacked, as the reference's.  ``cross`` / ``cross_pos`` go to every
    layer (:func:`run_block`).  Under ``cfg.remat`` at ``phase="train"``
    the layers' ledger events carry ``remat`` and, while autograd
    records, each layer is checkpointed; the shared block never is, as in
    the reference, whose shared branch returns before its checkpoint."""
    if phase not in ("train", "prefill"):
        raise ValueError(f"unknown phase {phase!r}")
    caches, aux = [], None
    if g.kind == "shared_attn":
        for _ in range(g.n):
            x, c, _ = run_block("attn", shared, x, cfg, mi, mode, g, pos,
                                phase, pos3)
            caches.append(c)
        return x, caches[0] if phase == "prefill" else None, None
    remat = cfg.remat and phase == "train"
    block = comms.checkpointed(run_block) \
        if remat and torch.is_grad_enabled() else run_block
    with comms.scope_remat(remat):
        for p in _unstack(gp, g.n):
            x, c, a = block(g.kind, p, x, cfg, mi, mode, g, pos, phase,
                            pos3, cross, cross_pos)
            caches.append(c)
            aux = add_aux(aux, a)
    if phase == "train":
        return x, None, aux
    return x, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}, \
        aux


# --------------------------------------------------------------------------
# dense decode bodies
# --------------------------------------------------------------------------

def decode_block(kind, p, x, cache, index: int, cfg, mi, mode,
                 g: BlockGroup, seq_axes=None, pos3=None):
    """One layer's single-token decode against its dense cache ({k, v},
    whisper's decoder also {xk, xv, xlen}; or a recurrent kind's state),
    written in place (the cross-attention cache never is).  Returns (x,
    cache)."""
    _check_kind(kind)
    if kind in _RECURRENT:
        h = layers.norm(p["ln1"], x, cfg, mi)
        r, new = _RECURRENT[kind][2](p[kind], h, cache, cfg, mi)
        for k, v in new.items():
            cache[k].copy_(v)
        return x + r.to(x.dtype), cache
    h = layers.norm(p["ln1"], x, cfg, mi)
    r, _ = attention.attn_decode(p["attn"], h,
                                 {"k": cache["k"], "v": cache["v"]}, index,
                                 cfg, mi, mode, window=g.window,
                                 seq_axes=seq_axes, pos3=pos3)
    x = x + r
    if kind == "dec_attn":
        h = layers.norm(p["lnx"], x, cfg, mi)
        r, _ = attention.attn_decode(
            p["xattn"], h,
            {"k": cache["xk"], "v": cache["xv"], "len": cache["xlen"]},
            index, cfg, mi, mode, window=0, seq_axes=seq_axes, cross=True)
        x = x + r
    if kind == "moe":
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + moe.moe_block(p["moe"], h, cfg, mi, sp=False)[0]
    elif cfg.d_ff:
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + layers.mlp(p["mlp"], h, cfg, mi, sp=False)
    return x, cache


def decode_group(gp, x, caches, index: int, g: BlockGroup, cfg, mi, mode,
                 seq_axes=None, pos3=None, shared=None):
    """The group's layers in order, each writing its own slice of the
    group's stacked caches in place; a ``shared_attn`` group applies
    ``shared`` at each insertion against its one unstacked cache.
    Returns (x, caches)."""
    if g.kind == "shared_attn":
        for _ in range(g.n):
            x, _ = decode_block("attn", shared, x, caches, index, cfg, mi,
                                mode, g, seq_axes, pos3)
        return x, caches
    for i in range(g.n):
        x, _ = decode_block(g.kind, layer_slice(gp, i), x,
                            layer_slice(caches, i), index, cfg, mi, mode, g,
                            seq_axes, pos3)
    return x, caches


# --------------------------------------------------------------------------
# paged decode bodies
# --------------------------------------------------------------------------

def decode_block_paged(kind, p, x, pool, tables, pos, active, cfg, mi,
                       g: BlockGroup, *, bits, block_tokens, backend=None,
                       pos3=None):
    """Per-slot decode body against one layer's paged KV pool.  Only the
    attention-style kinds page (a recurrent state has no KV cache to page:
    those keep the dense Server)."""
    if kind not in ("attn", "moe"):
        raise NotImplementedError(
            f"paged decode supports attn/moe/shared_attn groups; got "
            f"{kind!r}")
    h = layers.norm(p["ln1"], x, cfg, mi)
    r, pool = attention.attn_decode_paged(
        p["attn"], h, pool, tables, pos, active, cfg, mi, bits=bits,
        block_tokens=block_tokens, window=g.window, backend=backend,
        pos3=pos3)
    x = x + r
    if kind == "moe":
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + moe.moe_block(p["moe"], h, cfg, mi, sp=False)[0]
    elif cfg.d_ff:
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + layers.mlp(p["mlp"], h, cfg, mi, sp=False)
    return x, pool


def decode_group_paged(gp, x, pool, tables, pos, active, g: BlockGroup, cfg,
                       mi, *, bits, block_tokens, backend=None, pos3=None,
                       shared=None):
    """Run the group's layers in order; each writes its own slice of the
    group's stacked pool in place (a ``shared_attn`` group: ``shared``
    at each insertion against its one unstacked pool).  Returns (x,
    pool)."""
    if g.kind == "shared_attn":
        for _ in range(g.n):
            x, _ = decode_block_paged("attn", shared, x, pool, tables, pos,
                                      active, cfg, mi, g, bits=bits,
                                      block_tokens=block_tokens,
                                      backend=backend, pos3=pos3)
        return x, pool
    for i in range(g.n):
        x, _ = decode_block_paged(g.kind, layer_slice(gp, i), x,
                                  layer_slice(pool, i), tables, pos, active,
                                  cfg, mi, g, bits=bits,
                                  block_tokens=block_tokens, backend=backend,
                                  pos3=pos3)
    return x, pool
