"""Analytic per-device FLOP and device-memory byte model for the roofline
(port of ``repro.analysis.costmodel``, the same arithmetic).

The dry-run traces one rank's step on meta tensors and counts what it
dispatches (:mod:`repro_torch.launch.dryrun`); this model is the
analytic side beside it, priced from the configuration alone, which the
roofline's compute and memory terms use, as the reference's do.

Conventions, per term:
  * matmul flops = 2 * active-params-touched * tokens; train multiplies by
    (1 fwd + 2 bwd + 1 remat-refwd) = 4x fwd (3x without remat);
  * attention flops = 4 * B * Sq * Sctx * H * hd (QK^T + AV), causal halves
    Sq*Sctx, sliding windows clamp Sctx; divided over the chips
    (tp x dp x pod);
  * weight traffic = every parameter is read once per pass (TP-local or
    ZeRO-3-gathered alike);
  * activation traffic = c_act * tokens_local * d_model * n_layers
    (c_act = 20 covers the norm/attn/mlp intermediate reads and writes);
  * optimizer traffic = read+write of master/m/v (f32) on the ZeRO-1 chunk
    plus gradient read/write.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import MeshInfo

C_ACT = 20.0


@dataclasses.dataclass
class Cost:
    flops: float       # per device
    hbm_bytes: float   # per device


def _itemsize(cfg):
    return 2 if cfg.dtype == "bfloat16" else 4


def _attention_flops(cfg: ArchConfig, B, Sq, Sctx, causal=True):
    total = 0.0
    for g in cfg.layer_groups:
        if g.kind in ("attn", "moe", "dec_attn", "shared_attn"):
            ctx = min(Sctx, g.window) if g.window else Sctx
            f = 4.0 * B * Sq * ctx * cfg.n_heads * cfg.head_dim_
            if causal and Sq == Sctx and not g.window:
                f *= 0.5
            total += f * g.n
            if g.kind == "dec_attn":      # cross-attention (full)
                total += 4.0 * B * Sq * Sctx * cfg.n_heads * cfg.head_dim_ \
                    * g.n
        if g.kind == "enc_attn":
            total += 4.0 * B * Sq * Sctx * cfg.n_heads * cfg.head_dim_ * g.n
    return total


def _recurrent_flops(cfg: ArchConfig, B, S):
    """Chunked-scan state updates (projections live in the param count)."""
    total = 0.0
    for g in cfg.layer_groups:
        if g.kind == "mamba":
            H = cfg.d_inner // cfg.ssm_head_dim
            total += 6.0 * B * S * H * cfg.ssm_head_dim * cfg.ssm_state * g.n
        if g.kind == "mlstm":
            H = cfg.n_heads
            Pv = int(cfg.proj_factor * cfg.d_model) // H
            total += 6.0 * B * S * H * Pv * cfg.head_dim_ * g.n
        if g.kind == "slstm":
            hd = cfg.d_model // cfg.n_heads
            total += 2.0 * B * S * 4 * cfg.n_heads * hd * hd * g.n
    return total


def _chips(mi: MeshInfo) -> int:
    """The chips the reference's cost divides by: tp x dp x pod."""
    return mi.tp * mi.dp * mi.pod


def train_cost(cfg: ArchConfig, mi: MeshInfo, B, S, n_active,
               n_total) -> Cost:
    chips = _chips(mi)
    T = B * S
    mm_fwd = 2.0 * n_active * T
    attn_fwd = _attention_flops(cfg, B, S, S) + _recurrent_flops(cfg, B, S)
    passes = 4.0 if cfg.remat else 3.0
    flops = (mm_fwd + attn_fwd) * passes / chips

    it = _itemsize(cfg)
    dp_ways = mi.dp * mi.pod
    w_read = (n_total / mi.tp) * it * passes
    acts = C_ACT * (T / dp_ways) * cfg.d_model * _depth(cfg) * it
    opt = (n_total / mi.tp) * (3 * 4 * 2 / mi.dp + 2 * 4)
    return Cost(flops=flops, hbm_bytes=(w_read + acts + opt))


def prefill_cost(cfg, mi, B, S, n_active, n_total) -> Cost:
    chips = _chips(mi)
    T = B * S
    flops = (2.0 * n_active * T + _attention_flops(cfg, B, S, S)
             + _recurrent_flops(cfg, B, S)) / chips
    it = _itemsize(cfg)
    dp_ways = mi.dp * mi.pod
    acts = C_ACT * (T / dp_ways) * cfg.d_model * _depth(cfg) * it
    return Cost(flops=flops,
                hbm_bytes=(n_total / mi.tp) * it + acts)


def param_traffic_bytes(cfg, mi: MeshInfo, decode: bool) -> float:
    """Per-chip weight bytes touched per step, from the parameter plan.

    ``model``-sharded dims stay sharded; ``data`` (ZeRO-3) dims are
    re-gathered before use, except the weight-stationary expert leaves in
    decode (``cfg.moe_ws``), which are consumed as local 2-D shards."""
    from repro_torch.models import transformer
    from repro_torch.models.params import defs

    total = 0.0
    for d in defs(transformer.model_plan(cfg, mi)):
        n = 1
        for s, sp in zip(d.shape, d.spec):
            if sp == "model":
                s //= mi.tp
            elif sp == "data" and decode and cfg.moe_ws:
                s //= mi.dp
            n *= s
        total += n * (2 if d.dtype == "bfloat16" else 4)
    return total


def decode_cost(cfg, mi, B, S_ctx, n_active, n_total,
                seq_axes=("model",)) -> Cost:
    chips = _chips(mi)
    flops = (2.0 * n_active * B
             + _attention_flops(cfg, B, 1, S_ctx, causal=False)
             + _recurrent_flops(cfg, B, 1)) / chips
    it = _itemsize(cfg)
    # weights: read once per step, at their post-sharding/post-gather sizes
    w_read = param_traffic_bytes(cfg, mi, decode=True)
    # KV cache read: the full context of the attention layers, divided
    # over the cache's (sequence x batch) sharding
    kv_layers = sum(g.n for g in cfg.layer_groups
                    if g.kind in ("attn", "moe", "dec_attn", "shared_attn"))
    shards = 1
    for ax in seq_axes:
        shards *= {"model": mi.tp, "data": mi.dp}.get(ax, 1)
    if B > 1 and "data" not in seq_axes:
        shards *= mi.dp
    cache = (2.0 * B * S_ctx * cfg.n_kv_heads * cfg.head_dim_ * it
             * kv_layers) / shards
    return Cost(flops=flops, hbm_bytes=w_read + cache)


def _depth(cfg) -> int:
    return sum(g.n for g in cfg.layer_groups)


def cost_for(cfg, mi, shape_kind, B, S, n_active, n_total,
             seq_axes=("model",)) -> Cost:
    if shape_kind == "train":
        return train_cost(cfg, mi, B, S, n_active, n_total)
    if shape_kind == "prefill":
        return prefill_cost(cfg, mi, B, S, n_active, n_total)
    return decode_cost(cfg, mi, B, S, n_active, n_total, seq_axes)
