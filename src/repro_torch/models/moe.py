"""Capacity-routed top-k Mixture-of-Experts with expert parallelism (port
of ``repro.models.moe``).

Experts are sharded over the model axes (``ep`` = tp); token routing
crosses them through the compressed all-to-all
(:func:`repro_torch.core.comms.all_to_all`, two-level on a ``--tp-nodes``
mesh) at the ``ep`` sites, under the scheme's MP-class codec.

Flow on each rank (T = B_loc * S_loc tokens):
  f32 router -> softmax -> top-k (ties to the lower expert) -> each
  (token, choice)'s position in its expert's queue -> capacity-bounded
  scatter-add into the ``[E * C, D]`` send buffer -> all-to-all
  (``ep@moe_dispatch``) -> the gated FFN of the ``E / ep`` local experts
  -> all-to-all back (``ep@moe_combine``) -> the gate-weighted combine
  (+ the shared expert).

Shapes are static: capacity ``C`` is the reference's float arithmetic,
rounded up to 4; (token, choice) pairs past it are dropped (Switch /
GShard semantics) and counted in ``drop_frac``.  The expert FFN, the
dispatch and the combine are PyTorch ops, as they are ``jnp`` in the
reference (no Pallas kernel there); only the all-to-all's codec runs the
bq kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comms
from repro_torch.models import layers
from repro_torch.models.layers import use
from repro_torch.models.params import D as Dd, Pv

_F32 = torch.float32


def moe_plan(cfg):
    E, Dm, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    if cfg.moe_ws:
        # weight-stationary: the expert hidden dim pinned over 'data', so
        # decode moves (small) tokens instead of (huge) expert weights
        in_spec, out_spec = ("model", None, "data"), ("model", "data", None)
        ok = False
    else:
        in_spec, out_spec = ("model", None, None), ("model", None, None)
        ok = True
    p = {
        "router": Dd((Dm, E), dtype="float32", fsdp_ok=False),
        "w_in": Dd((E, Dm, F_), spec=in_spec, dtype=cfg.dtype, fsdp_ok=ok),
        "w_gate": Dd((E, Dm, F_), spec=in_spec, dtype=cfg.dtype, fsdp_ok=ok),
        "w_out": Dd((E, F_, Dm), spec=out_spec, dtype=cfg.dtype, fsdp_ok=ok),
    }
    if cfg.shared_expert:
        p["shared"] = layers.mlp_plan(cfg, d_ff=cfg.moe_d_ff or cfg.d_ff)
    return p


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens: the reference's
    ``int(cf * T * k / E)`` rounded up to a multiple of 4, at least 4."""
    c = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest along the last dim, descending, the
    lower index first among equal values (a stable sort; ``torch.topk``
    promises no order on ties)."""
    val, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def moe_block(p, x, cfg, mi, sp: bool = True):
    """x [B, S_loc, D] -> (y [B, S_loc, D], aux {lb_loss, drop_frac})."""
    if cfg.moe_ws and not sp and mi.dp > 1:
        # weight-stationary decode: the expert weights stay F-sharded over
        # data; the token batch is all-gathered and routed alike on every
        # data shard (the router is replicated), each shard computes its F
        # slice, and the partial outputs reduce-scatter back to their owner
        site = comms.site("ep", "moe_decode_batch")
        xg = comms.all_gather(x, mi.dp_axes, 0, site)
        y, aux = _moe_ffn(p, xg, cfg, mi, f_sliced=True)
        y = comms.reduce_scatter(y, mi.dp_axes, 0, site)
    else:
        y, aux = _moe_ffn(p, x, cfg, mi, f_sliced=False)
    if cfg.shared_expert:
        y = y + layers.mlp(p["shared"], x, cfg.replace(mlp_kind="swiglu"),
                           mi, sp=sp)
    return y, aux


def _local(p):
    """A leaf's raw local shard (the F slice of a weight-stationary
    expert)."""
    return p.v if isinstance(p, Pv) else p


def _moe_ffn(p, x, cfg, mi, f_sliced: bool):
    """Router -> dispatch -> all-to-all -> expert FFN -> return route.

    ``f_sliced`` computes with each expert leaf's local F shard (outputs
    partial over data); otherwise ``use`` re-gathers a ZeRO-3 shard."""
    B, S, Dm = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    ep = mi.tp
    E_loc = E // ep
    C = capacity(cfg, T)

    xt = x.reshape(T, Dm)
    logits = (xt.to(_F32) @ use(p["router"], mi)).to(_F32)        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, k)                                 # [T, k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) in its expert's queue
    onehot = F.one_hot(expert, E).to(torch.int32)                  # [T,k,E]
    flat_oh = onehot.reshape(T * k, E)
    pos_in_e = torch.cumsum(flat_oh, dim=0) - flat_oh              # exclusive
    pos = (pos_in_e * flat_oh).sum(-1).reshape(T, k)
    keep = pos < C
    slot = (expert * C + torch.clamp(pos, max=C - 1)).reshape(T * k)

    # dispatch: scatter-add the tokens into the [E * C, D] send buffer (a
    # dropped pair adds zeros into its expert's last slot)
    src = xt[:, None, :].expand(T, k, Dm).reshape(T * k, Dm)
    w = keep.reshape(T * k, 1).to(x.dtype)
    buf = torch.zeros((E * C, Dm), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, src * w)

    # all-to-all: each rank receives its experts' queues from every rank
    # (two-level on a node-factored model axis, chunks in joint order)
    recv = comms.all_to_all(buf.reshape(ep, E_loc * C, Dm), mi.tp_axes, 0,
                            0, comms.site("ep", "moe_dispatch"))
    recv = recv.reshape(ep, E_loc, C, Dm).movedim(1, 0).reshape(
        E_loc, ep * C, Dm)

    # the gated expert FFN (SwiGLU-family experts)
    if f_sliced:
        w_in, w_gate, w_out = (_local(p[n]) for n in
                               ("w_in", "w_gate", "w_out"))
    else:
        w_in, w_gate, w_out = (use(p[n], mi) for n in
                               ("w_in", "w_gate", "w_out"))
    h = F.silu(torch.bmm(recv, w_in)) * torch.bmm(recv, w_gate)
    out = torch.bmm(h.to(x.dtype), w_out)               # [E_loc, ep*C, D]

    # return route: the inverse rearrangement and the all-to-all back
    out = out.reshape(E_loc, ep, C, Dm).movedim(0, 1).reshape(
        ep, E_loc * C, Dm)
    back = comms.all_to_all(out, mi.tp_axes, 0, 0,
                            comms.site("ep", "moe_combine")).reshape(E * C,
                                                                     Dm)

    # combine: each (token, choice)'s result, weighted by its gate
    got = back.index_select(0, slot).reshape(T, k, Dm)
    y = torch.sum(got * (gate * keep).to(x.dtype)[..., None], dim=1)

    # the load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(0)                                             # [E]
    ce = onehot.sum(1).to(_F32).mean(0) / k
    aux = {"lb_loss": E * torch.sum(me * ce),
           "drop_frac": 1.0 - keep.to(_F32).mean()}
    return y.reshape(B, S, Dm), aux
