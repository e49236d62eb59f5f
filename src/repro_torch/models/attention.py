"""Attention (port of ``repro.models.attention``): training and prefill
attention in head and ring mode (self-attention, and whisper's
cross-attention to the encoder's output), single-token decode against a
dense KV cache in both modes (ring mode's shards merged by the
flash-decoding combine; the cross-attention cache read, never written),
and the head-sharded decode path against a paged KV pool, on the
reference's online-softmax core.

Mode selection (``cfg.attn_mode_for(tp)``):

* ``head`` — Megatron-SP: all-gather the sequence over tp, attend with
  the local heads, reduce-scatter the sequence back.  Needs q and kv
  heads divisible by tp.
* ``ring`` — the sequence stays sharded; with tp > 1 the GQA-small K/V
  are all-gathered over tp once, so the weights stay replicated for any
  head count (gemma3-1b's single kv-head at tp 2).

Context parallelism (the ``cp`` mesh axis) composes with both modes:
each cp rank holds one zigzag (causal load-balanced) slice of the
sequence, and :func:`ring_attention` rotates the K/V blocks around
``mi.cp_axes`` through compressed ppermute hops (the ``cp`` ledger
dimension, ``cp_fwd`` / ``cp_bwd`` codecs, two-level when the ring
crosses nodes), merged by the online-softmax log-sum-exp.  Masking is
position-based throughout, so the zigzag slices need no special case.

All softmax statistics are f32; GQA is grouped natively (no KV
duplication).
"""

from __future__ import annotations

import torch

from repro_torch.core import comms
from repro_torch.models.layers import apply_mrope, apply_rope, rms_norm, use
from repro_torch.models.params import D as Dd, MeshInfo
from repro_torch.serve import paged_kv

_F32 = torch.float32
_NEG = -1e30


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

def attn_plan(cfg, mode: str):
    hd, H, KV, Dm = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    if mode == "head":
        q_spec, o_spec = (None, "model"), ("model", None)
    elif mode == "ring":  # weights replicated: the sequence carries tp
        q_spec, o_spec = (None, None), (None, None)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    p = {
        "wq": Dd((Dm, H * hd), spec=q_spec, dtype=cfg.dtype),
        "wk": Dd((Dm, KV * hd), spec=q_spec, dtype=cfg.dtype),
        "wv": Dd((Dm, KV * hd), spec=q_spec, dtype=cfg.dtype),
        "wo": Dd((H * hd, Dm), spec=o_spec, dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = Dd((H * hd,), spec=q_spec[1:], init="zeros", dtype=cfg.dtype)
        p["bk"] = Dd((KV * hd,), spec=q_spec[1:], init="zeros", dtype=cfg.dtype)
        p["bv"] = Dd((KV * hd,), spec=q_spec[1:], init="zeros", dtype=cfg.dtype)
    if cfg.qk_norm:
        p["qn"] = Dd((hd,), init="zeros", dtype="float32", fsdp_ok=False)
        p["kn"] = Dd((hd,), init="zeros", dtype="float32", fsdp_ok=False)
    return p


# --------------------------------------------------------------------------
# online-softmax core
# --------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal, window, k_valid=None):
    """Additive bias [B, 1, 1, Sq, Sk] from position predicates."""
    qp = q_pos[:, :, None]              # [B,Sq,1]
    kp = k_pos[:, None, :]              # [B,1,Sk]
    ok = torch.ones(qp.shape[0], qp.shape[1], kp.shape[2], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    bias = torch.where(ok, torch.zeros((), dtype=_F32, device=ok.device),
                       torch.full((), _NEG, dtype=_F32, device=ok.device))
    return bias[:, None, None, :, :]


def _attn_part(q, k, v, bias, scale):
    """One KV block of attention, unnormalized.

    q [B,Sq,H,hd], k/v [B,Sk,KV,hd], bias [B,1,1,Sq,Sk]
    -> (o [B,Sq,H,hd] f32, m [B,Sq,H] f32, l [B,Sq,H] f32)
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).to(_F32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(_F32)) * scale
    s = s + bias                                             # [B,KV,G,Sq,Sk]
    m = torch.amax(s, dim=-1)                                # [B,KV,G,Sq]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.to(_F32))
    o = torch.movedim(o, 3, 1).reshape(B, Sq, H, hd)
    m = torch.movedim(m, 3, 1).reshape(B, Sq, H)
    l = torch.movedim(l, 3, 1).reshape(B, Sq, H)
    return o, m, l


def _combine(a, b):
    o1, m1, l1 = a
    o2, m2, l2 = b
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    return (o1 * w1[..., None] + o2 * w2[..., None], m, l1 * w1 + l2 * w2)


def _finish(o, m, l, dtype):
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def _empty_acc(q):
    B, Sq, H, hd = q.shape
    return (torch.zeros((B, Sq, H, hd), dtype=_F32, device=q.device),
            torch.full((B, Sq, H), _NEG, dtype=_F32, device=q.device),
            torch.zeros((B, Sq, H), dtype=_F32, device=q.device))


def full_attention(q, k, v, q_pos, k_pos, causal, window, k_valid=None,
                   kv_chunk: int = 2048):
    """Local attention, walking KV in chunks with an online softmax (the
    reference's ``lax.scan`` over chunks is a Python loop here)."""
    scale = q.shape[-1] ** -0.5
    Sk = k.shape[1]
    if Sk <= kv_chunk:
        bias = _mask_bias(q_pos, k_pos, causal, window, k_valid)
        o, m, l = _attn_part(q, k, v, bias, scale)
        return _finish(o, m, l, q.dtype)
    valid = (torch.ones(k_pos.shape, dtype=torch.bool, device=k_pos.device)
             if k_valid is None else k_valid)
    acc = _empty_acc(q)
    for c0 in range(0, Sk, kv_chunk):
        sl = slice(c0, c0 + kv_chunk)
        bias = _mask_bias(q_pos, k_pos[:, sl], causal, window, valid[:, sl])
        acc = _combine(acc, _attn_part(q, k[:, sl], v[:, sl], bias, scale))
    return _finish(*acc, q.dtype)


def ring_attention(q, k, v, q_pos, k_pos, mi: MeshInfo, causal, window,
                   k_valid=None):
    """K/V blocks rotate around the context-parallel ring; compressed hops.

    q [B, Sq_loc, H, hd] attends to its local K/V block first, then to the
    cp - 1 blocks arriving around ``mi.cp_axes``: the (GQA-small) K/V
    move, the queries stay, and the online-softmax merge makes the result
    independent of the arrival order up to rounding.  The hops ride
    :func:`comms.ppermute` at ``cp@ring_kv`` (``cp_fwd`` forward; the
    backward sends the gradients by the inverse permutation under
    ``cp_bwd``); on a ``(cpnode, cp)`` pair the hops inside a node ride
    the inner codecs and the node-crossing hop the outer ones.
    ``q_pos`` / ``k_pos`` are GLOBAL positions, so the zigzag slices need
    no mask special case; they and ``k_valid`` rotate uncompressed, as in
    the reference.  Without a cp axis the ring has one block."""
    cp = mi.cp
    scale = q.shape[-1] ** -0.5
    if cp == 1:
        bias = _mask_bias(q_pos, k_pos, causal, window, k_valid)
        o, m, l = _attn_part(q, k, v, bias, scale)
        return _finish(o, m, l, q.dtype)
    perm = [(j, (j + 1) % cp) for j in range(cp)]
    acc = _empty_acc(q)
    kb, vb, pb, vlb = k, v, k_pos, k_valid
    for t in range(cp):
        bias = _mask_bias(q_pos, pb, causal, window, vlb)
        acc = _combine(acc, _attn_part(q, kb, vb, bias, scale))
        if t < cp - 1:
            kb = comms.ppermute(kb, mi.cp_axes, perm,
                                comms.site("cp", "ring_kv"))
            vb = comms.ppermute(vb, mi.cp_axes, perm,
                                comms.site("cp", "ring_kv"))
            pb = comms.raw_ppermute(pb, mi.cp_phys_axes, perm)
            if vlb is not None:
                vlb = comms.raw_ppermute(vlb, mi.cp_phys_axes, perm)
    return _finish(*acc, q.dtype)


# --------------------------------------------------------------------------
# projections (+ rope/qk-norm)
# --------------------------------------------------------------------------

def _project_qkv(p, xq, xkv, pos_q, pos_kv, cfg, mi, theta, pos3_q=None):
    """q, k, v [B, S, heads, hd], with qkv bias, qk-norm and rope; M-RoPE
    (qwen2-vl) where the config asks for it and ``pos3_q`` [B, S, 3] is
    given, the plain rope on ``pos_q`` / ``pos_kv`` otherwise."""
    hd = cfg.head_dim_
    wq, wk, wv = use(p["wq"], mi), use(p["wk"], mi), use(p["wv"], mi)
    q = xq @ wq
    k = xkv @ wk
    v = xkv @ wv
    if cfg.qkv_bias:
        q = q + use(p["bq"], mi)
        k = k + use(p["bk"], mi)
        v = v + use(p["bv"], mi)
    q = q.reshape(*q.shape[:2], -1, hd)
    k = k.reshape(*k.shape[:2], -1, hd)
    v = v.reshape(*v.shape[:2], -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, use(p["qn"], mi), cfg.norm_eps)
        k = rms_norm(k, use(p["kn"], mi), cfg.norm_eps)
    if cfg.mrope and pos3_q is not None:
        q = apply_mrope(q, pos3_q, theta)
        k = apply_mrope(k, pos3_q, theta)
    elif theta:
        q = apply_rope(q, pos_q, theta)
        k = apply_rope(k, pos_kv, theta)
    return q, k, v


def _theta(cfg, window):
    """gemma3: global (window=0) layers use the long-context rope base."""
    if cfg.rope_theta_global and window == 0:
        return cfg.rope_theta_global
    return cfg.rope_theta


# --------------------------------------------------------------------------
# training attention
# --------------------------------------------------------------------------

def attn_train(p, x, pos, cfg, mi: MeshInfo, mode: str, causal=True,
               window=0, want_cache=False, pos3=None, cross=None,
               cross_pos=None):
    """Training (and prefill) attention sublayer: x [B, S_loc, D]
    sequence-sharded, pos [B, S_loc] global positions -> [B, S_loc, D],
    and with ``want_cache`` the prefill cache ``(k, v, k_pos)`` too: in
    head mode the full (cp-local) sequence of this rank's KV heads, in
    ring mode this rank's sequence slice of every head.  ``pos3`` [B,
    S_loc, 3] are qwen2-vl's M-RoPE position ids, applied as the reference
    applies them (to the projections of this rank's tokens as given).

    ``cross`` [B, Se_loc, D] (this rank's slice of the encoder output,
    whisper's decoder) and its global positions ``cross_pos`` [B, Se_loc]
    make it cross-attention: the queries come from ``x``, the keys and
    values from ``cross``.  Head mode all-gathers the encoder slices at
    ``tp@attn_cross_kv`` and their positions at ``tp@attn_pos`` (on the
    tp codec, as the reference's positions ride it: C.5); ring mode
    projects K/V from the local encoder slice and gathers them at
    ``tp@attn_kv``, so the cache is that slice's."""
    theta = _theta(cfg, window)
    if mode == "head":
        xg = comms.all_gather(x, mi.tp_axes, 1, comms.site("tp", "attn_in"))
        pos_g = _gather_pos(pos, mi)
        if cross is not None:
            kvg = comms.all_gather(cross, mi.tp_axes, 1,
                                   comms.site("tp", "attn_cross_kv"))
            pos_kv_g = _gather_pos(cross_pos, mi)
        else:
            kvg, pos_kv_g = xg, pos_g
        q, k, v = _project_qkv(p, xg, kvg, pos_g, pos_kv_g, cfg, mi, theta,
                               pos3)
        if mi.cp > 1:   # q/k/v cover this rank's cp slice: ring over cp
            o = ring_attention(q, k, v, pos_g, pos_kv_g, mi, causal, window)
        else:
            o = full_attention(q, k, v, pos_g, pos_kv_g, causal, window)
        y = o.reshape(*o.shape[:2], -1) @ use(p["wo"], mi)
        out = comms.reduce_scatter(y, mi.tp_axes, 1,
                                   comms.site("tp", "attn_out"))
        return (out, (k, v, pos_kv_g)) if want_cache else out
    # ring: the sequence stays sharded, the weights are replicated
    xkv, pos_kv = (x, pos) if cross is None else (cross, cross_pos)
    q, k, v = _project_qkv(p, x, xkv, pos, pos_kv, cfg, mi, theta, pos3)
    cache = (k, v, pos_kv)
    kb, vb, pkv = k, v, pos_kv
    if mi.tp > 1:
        # K/V are GQA-small: gather the tp sub-slices of this rank's cp
        # slice once, so the cp ring rotates whole slices and queries never
        # move
        kb = comms.all_gather(kb, mi.tp_axes, 1, comms.site("tp", "attn_kv"))
        vb = comms.all_gather(vb, mi.tp_axes, 1, comms.site("tp", "attn_kv"))
        pkv = _gather_pos(pos_kv, mi)
    o = ring_attention(q, kb, vb, pos, pkv, mi, causal, window)
    out = o.reshape(*o.shape[:2], -1) @ use(p["wo"], mi)
    return (out, cache) if want_cache else out


def _gather_pos(pos, mi):
    return comms.all_gather(pos, mi.tp_axes, 1,
                            comms.site("tp", "attn_pos")) \
        if mi.tp > 1 else pos


# --------------------------------------------------------------------------
# dense decode
# --------------------------------------------------------------------------

def attn_decode(p, x, cache, index: int, cfg, mi: MeshInfo, mode: str,
                window=0, seq_axes=None, pos3=None, cross: bool = False):
    """Single-token decode against one layer's dense KV cache.

    x [B, 1, D] (replicated over model); ``cache`` {k, v} of this rank,
    written IN PLACE: in head mode [B, S_max, KV_loc, hd] (the whole
    sequence, this rank's heads), in ring mode [B, S_max / n, KV, hd],
    the sequence sharded over ``seq_axes`` (entries are axes or pairs,
    linearized in order, each pair outer-major; default the model axes).
    ``index`` is the current position (the tokens already in the cache).
    Ring mode writes the new token on the shard that owns ``index`` (and,
    as the reference's scatter does, at the end of the next shard, where
    it stays masked: fault C.17) and merges the shards'
    partial softmax with the flash-decoding combine: a max, then two sums
    at ``tp@attn_combine`` over each entry of ``seq_axes`` (a pair's sums
    two-level).  ``pos3`` [B, 1, 3] are M-RoPE position ids (qwen2-vl).

    ``cross`` reads whisper's cross-attention cache {k, v, len} (the
    encoder's K/V, ``len`` its valid length), which prefill filled and
    decode never writes.  Ring mode masks its frames by ``len``.  Head
    mode, as the reference's, ignores ``cross``: it scatters the token's
    own projection at ``index`` and masks by ``index + 1`` (fault C.24).
    Past the encoder's length the scatter drops, as JAX drops an
    out-of-range scatter, and every frame is valid; before it, the token
    overwrites one frame for this step only (the reference's decode
    discards the written cache) and the later frames are masked.
    Returns (out [B, 1, D], cache)."""
    theta = _theta(cfg, window)
    B = x.shape[0]
    pos_q = torch.full((B, 1), index, dtype=torch.long, device=x.device)
    # head mode: the weights are head-sharded, so q/k/v hold this rank's
    # heads; ring mode: the weights are replicated, every head is local
    q, k_new, v_new = _project_qkv(p, x, x, pos_q, pos_q, cfg, mi, theta,
                                   pos3)
    k, v = cache["k"], cache["v"]
    if mode == "head":
        s_max = k.shape[1]
        if index < s_max:       # JAX drops an out-of-range scatter
            if cross:           # written for this step only
                k, v = k.clone(), v.clone()
            k[:, index] = k_new[:, 0].to(k.dtype)
            v[:, index] = v_new[:, 0].to(v.dtype)
        k_pos = torch.arange(s_max, dtype=torch.long,
                             device=x.device)[None].expand(B, s_max)
        o = full_attention(q, k, v, pos_q, k_pos, causal=False,
                           window=window, k_valid=k_pos < index + 1)
        y = o.reshape(B, 1, -1) @ use(p["wo"], mi)
        out = comms.psum(y, mi.tp_axes, comms.site("tp", "attn_out"))
        return out, cache

    seq_axes = (mi.tp_axes,) if seq_axes is None else tuple(seq_axes)
    chunk = k.shape[1]
    off = shard_index(seq_axes) * chunk
    # the reference's dropped scatter wraps a local index in [-chunk, 0)
    # to the shard's end, as numpy indexing does (fault C.17): a masked
    # position that the owner's own write reaches before any read
    if not cross and -chunk <= index - off < chunk:
        k[:, index - off] = k_new[:, 0].to(k.dtype)
        v[:, index - off] = v_new[:, 0].to(v.dtype)
    k_pos = off + torch.arange(chunk, dtype=torch.long,
                               device=x.device)[None].expand(B, chunk)
    valid = k_pos < (cache["len"] if cross else index + 1)
    o, m, l = _attn_part(q, k, v,
                         _mask_bias(pos_q, k_pos, False, window, valid),
                         cfg.head_dim_ ** -0.5)
    # flash-decoding combine across the sequence shards
    for ax in seq_axes:
        mg = comms.pmax(m, ax)
        w = torch.exp(m - mg)
        o = comms.psum(o * w[..., None], ax, comms.site("tp", "attn_combine"))
        l = comms.psum(l * w, ax, comms.site("tp", "attn_combine"))
        m = mg
    o = (o / torch.clamp(l, min=1e-30)[..., None]).to(x.dtype)
    return o.reshape(B, 1, -1) @ use(p["wo"], mi), cache


def shard_index(seq_axes) -> int:
    """This rank's linear shard index over the sequence sharding
    ``seq_axes``, the first entry outermost (an entry may be a pair, whose
    joint index is outer-major), as the reference's ``_shard_index``
    linearizes ``("data", "model")``: ``d * tp + t``."""
    idx = 0
    for ax in seq_axes:
        idx = idx * ax.size + ax.index
    return idx


# --------------------------------------------------------------------------
# paged decode
# --------------------------------------------------------------------------

def attn_decode_paged(p, x, pool, tables, pos, active, cfg, mi: MeshInfo,
                      *, bits, block_tokens, window=0, backend=None,
                      pos3=None):
    """Single-token decode against one layer's paged KV pool (head mode).

    x [N, 1, D], one row per decode slot; ``pool`` is this layer's pool
    (:mod:`repro_torch.serve.paged_kv`), written IN PLACE; tables
    [N, max_blocks] int32 block ids; pos [N] per-slot positions; active [N]
    bool slot mask.  Inactive slots write nowhere (their block id is set
    out of range, and the write drops it) and attend over a fully masked
    sequence.  ``pos3`` [N, 1, 3] are M-RoPE position ids (qwen2-vl).
    Returns (out [N, 1, D], pool).
    """
    theta = _theta(cfg, window)
    N = x.shape[0]
    pos = pos.long()
    pos_q = pos[:, None]
    q, k_new, v_new = _project_qkv(p, x, x, pos_q, pos_q, cfg, mi, theta,
                                   pos3)
    kv_loc, hd = k_new.shape[2], cfg.head_dim_

    nb_loc = (pool["k"] if bits is None else pool["k"]["q_hi"]).shape[0]
    blk = torch.gather(tables.long(), 1, (pos // block_tokens)[:, None])[:, 0]
    blk = torch.where(active, blk, torch.full_like(blk, nb_loc))
    pool = paged_kv.write_token(pool, blk, pos % block_tokens,
                                k_new[:, 0], v_new[:, 0], bits, backend)

    k, v = paged_kv.read_tables(pool, tables, bits, kv_loc, hd, x.dtype,
                                backend)
    s_pad = k.shape[1]
    k_pos = torch.arange(s_pad, dtype=torch.long,
                         device=x.device)[None].expand(N, s_pad)
    valid = (k_pos <= pos[:, None]) & active[:, None]
    o = full_attention(q, k, v, pos_q, k_pos,
                       causal=False, window=window, k_valid=valid)
    y = o.reshape(N, 1, -1) @ use(p["wo"], mi)
    out = comms.psum(y, mi.tp_axes, comms.site("tp", "attn_out"))
    return out, pool
