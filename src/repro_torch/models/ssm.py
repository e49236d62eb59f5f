"""The linear-recurrence engine and the Mamba2 block (port of
``repro.models.ssm``; zamba2's SSM half).

The core recurrence, shared by Mamba2's SSD and xLSTM's mLSTM:

    S_t = a_t * S_{t-1} + u_t (x) r_t          S in R^{P x N}, a_t in (0,1]
    y_t = S_t . q_t                            contraction over N

runs chunkwise: inside a chunk as a masked quadratic form (no per-step
state is materialized), across chunks as a loop over the chunk states
(the reference's ``lax.scan``), and across sequence shards (the sequence
sharded over the model axes) as a Hillis-Steele exclusive prefix over the
compressed point-to-point exchange at ``pp@ssm_scan``: the
recurrent-state analogue of the paper's pipeline point-to-point
compression.  Within a chunk every decay stays in log space, so every
``exp`` argument is at most 0; the mask is applied before the ``exp``
(above the diagonal the log-decay difference is positive and may
overflow, and a mask after the ``exp`` would put ``inf * 0`` into the
backward).

Casts follow the reference: the scans run in f32 on activations of the
model dtype.  A rank-dependent choice (the first shard's zero halo, the
prefix's ``i >= step`` masking) is a ``torch.where`` on a scalar, as the
reference's ``jnp.where``: every rank's autograd graph keeps the same
nodes, so the backward's exchanges pair up across ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comms
from repro_torch.models.layers import rms_norm, use
from repro_torch.models.params import D as Dd

_F32 = torch.float32


def _where(cond: bool, a, b):
    """``a`` where the host-known ``cond`` holds, else ``b``, through
    ``torch.where`` so both stay in the autograd graph."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def _log_decay(a):
    """``log(max(a, 1e-38))`` in f32.  1e-38 is a denormal in f32; XLA:CPU
    flushes it to 0 (fault C.1), so the two sides part only where a decay
    underflows to 0."""
    return torch.log(torch.clamp(a.to(_F32), min=1e-38))


# --------------------------------------------------------------------------
# chunked linear-recurrence engine
# --------------------------------------------------------------------------

def chunked_outer_scan(a, u, r, q, chunk: int = 128, s0=None):
    """a [B,L,H], u [B,L,H,P], r [B,L,H,N], q [B,L,H,N] -> (y [B,L,H,P],
    the final state [B,H,P,N], the shard's total decay [B,H]), all f32.
    ``s0`` is an initial state [B,H,P,N] (zeros by default)."""
    B, L, H = a.shape
    P, N = u.shape[-1], r.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        u, r, q = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (u, r, q))

    def to_chunks(t):
        return t.reshape(B, nc, chunk, *t.shape[2:]).movedim(1, 0)

    ac, uc, rc, qc = map(to_chunks, (a, u, r, q))          # [nc,B,Q,H,...]
    cum = torch.cumsum(_log_decay(ac), dim=2)              # [nc,B,Q,H]
    S = torch.zeros((B, H, P, N), dtype=_F32, device=a.device) \
        if s0 is None else s0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=a.device))          # s <= t
    ninf = torch.tensor(-torch.inf, dtype=_F32, device=a.device)
    ys = []
    for c in range(nc):
        ab_cum, ub, rb, qb = cum[c], uc[c].to(_F32), rc[c].to(_F32), \
            qc[c].to(_F32)
        # intra-chunk quadratic form
        G = torch.einsum("bthn,bshn->bhts", qb, rb)
        ct = ab_cum.transpose(1, 2)                        # [B,H,Q]
        wlog = ct[:, :, :, None] - ct[:, :, None, :]       # cum_t - cum_s
        W = torch.exp(torch.where(tri, wlog, ninf))        # mask pre-exp
        y = torch.einsum("bhts,bshp->bthp", G * W, ub)
        # carry-in contribution: q_t . (S * decay(start->t])
        d0 = torch.exp(ab_cum)                             # [B,Q,H]
        y = y + torch.einsum("bhpn,bthn->bthp", S, qb) * d0[..., None]
        # chunk state update
        d_end = torch.exp(ab_cum[:, -1:, :] - ab_cum)      # decay s->end
        S = S * torch.exp(ab_cum[:, -1, :])[:, :, None, None] \
            + torch.einsum("bshp,bshn->bhpn", ub * d_end[..., None], rb)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, nc * chunk, H, P)[:, :L]
    # the sum of the chunks' final log-decays is the shard's total
    decay_total = torch.exp(torch.sum(cum[:, :, -1, :], dim=0))
    return y, S, decay_total


def cross_shard_prefix(decay, state, mi, axis):
    """The exclusive prefix of the recurrence across sequence shards:
    decay [B,H] and state [B,H,P,N] are this shard's totals; returns the
    state entering this shard.  Hillis-Steele over the compressed
    ``pp@ssm_scan`` exchange: O(log tp) hops and a final shift."""
    tp = axis.size
    if tp == 1:
        return torch.zeros_like(state)
    i = axis.index
    d, s = decay.to(_F32), state.to(_F32)
    step = 1
    while step < tp:
        perm = [(j, j + step) for j in range(tp - step)]
        d_in = comms.ppermute(d, axis, perm, comms.site("pp", "ssm_scan"))
        s_in = comms.ppermute(s, axis, perm, comms.site("pp", "ssm_scan"))
        has = i >= step
        # the incoming left prefix decays through the local segment
        s = _where(has, s_in * _bexp(d) + s, s)
        d = _where(has, d_in * d, d)
        step *= 2
    # shift right by one for the exclusive prefix
    perm = [(j, j + 1) for j in range(tp - 1)]
    s_prev = comms.ppermute(s, axis, perm, comms.site("pp", "ssm_scan"))
    return _where(i > 0, s_prev, torch.zeros_like(s_prev))


def _bexp(d):
    """Broadcast a decay [B,H] onto a state [B,H,P,N]."""
    return d[:, :, None, None]


def carry_in(y, s_in, q, a):
    """``y`` plus the carried state's contribution q_t . (s_in *
    decay(start->t]) over a whole shard [B,S,H,*]."""
    d0 = torch.exp(torch.cumsum(_log_decay(a), dim=1))    # [B,S,H]
    return y + torch.einsum("bhpn,bshn->bshp", s_in, q) * d0[..., None]


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def mamba_plan(cfg):
    Dm, di = cfg.d_model, cfg.d_inner
    H = di // cfg.ssm_head_dim
    N, K = cfg.ssm_state, cfg.conv_kernel
    return {
        "w_x": Dd((Dm, di), dtype=cfg.dtype),
        "w_z": Dd((Dm, di), dtype=cfg.dtype),
        "w_bc": Dd((Dm, 2 * N), dtype=cfg.dtype),
        "w_dt": Dd((Dm, H), dtype=cfg.dtype),
        "dt_bias": Dd((H,), init="zeros", dtype="float32", fsdp_ok=False),
        "A_log": Dd((H,), init="zeros", dtype="float32", fsdp_ok=False),
        "D_skip": Dd((H,), init="ones", dtype="float32", fsdp_ok=False),
        "conv_w": Dd((K, di), scale=0.1, dtype=cfg.dtype, fsdp_ok=False),
        "conv_b": Dd((di,), init="zeros", dtype=cfg.dtype, fsdp_ok=False),
        "gn": Dd((di,), init="zeros", dtype="float32", fsdp_ok=False),
        "w_out": Dd((di, Dm), dtype=cfg.dtype),
    }


def _causal_conv(xi, w, b, prev):
    """Depthwise causal conv of kernel K, with the halo ``prev`` [B,K-1,di]
    (the previous shard's last inputs)."""
    K = w.shape[0]
    xp = torch.cat([prev, xi], dim=1)
    y = sum(xp[:, j:j + xi.shape[1]] * w[j] for j in range(K))
    return y + b


def mamba_block(p, x, cfg, mi, sp: bool = True, want_cache: bool = False):
    """x [B, S_loc, D] -> [B, S_loc, D], the sequence sharded over the
    model axes when ``sp``.  ``want_cache`` also returns the decode-layout
    cache (this model shard's heads of the final state, its channels of
    the conv tail) for the prefill -> decode handoff."""
    B, S, Dm = x.shape
    di = cfg.d_inner
    H, P, N = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    ax = mi.tp_axes

    xi_raw = x @ use(p["w_x"], mi)
    z = x @ use(p["w_z"], mi)

    # conv halo from the previous sequence shard (zeros on the first)
    K = cfg.conv_kernel
    tail = xi_raw[:, -(K - 1):]
    if sp and mi.tp > 1:
        perm = [(j, j + 1) for j in range(mi.tp - 1)]
        halo = comms.ppermute(tail, ax, perm, comms.site("pp", "conv_halo"))
        halo = _where(ax.index > 0, halo, torch.zeros_like(halo))
    else:
        halo = torch.zeros_like(tail)
    xi = F.silu(_causal_conv(xi_raw, use(p["conv_w"], mi),
                             use(p["conv_b"], mi), halo))

    dt = F.softplus((x @ use(p["w_dt"], mi)).to(_F32)
                    + use(p["dt_bias"], mi))
    a = torch.exp(-dt * torch.exp(use(p["A_log"], mi)))    # [B,S,H]
    bc = (x @ use(p["w_bc"], mi)).to(_F32)
    B_, C_ = bc[..., :N], bc[..., N:]                      # [B,S,N]
    Bh = B_[:, :, None, :].expand(B, S, H, N)
    Ch = C_[:, :, None, :].expand(B, S, H, N)
    xh = xi.reshape(B, S, H, P).to(_F32)
    u = dt[..., None] * xh

    y, S_fin, d_tot = chunked_outer_scan(a, u, Bh, Ch)
    s_in = None
    if sp and mi.tp > 1:
        s_in = cross_shard_prefix(d_tot, S_fin, mi, ax)
        y = carry_in(y, s_in, Ch, a)

    y = y + use(p["D_skip"], mi)[None, None, :, None] * xh
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, use(p["gn"], mi), cfg.norm_eps)
    out = y @ use(p["w_out"], mi)
    if not want_cache:
        return out

    # ---- prefill -> decode handoff (the decode layout shards H and di)
    incl = S_fin if s_in is None else s_in * _bexp(d_tot) + S_fin
    state, conv_tail = broadcast_final(incl, tail, mi, sp)
    i = ax.index
    H_loc, di_loc = H // mi.tp, di // mi.tp
    state = state[:, i * H_loc:(i + 1) * H_loc]
    conv_tail = conv_tail[:, :, i * di_loc:(i + 1) * di_loc]
    return out, {"conv": conv_tail.to(x.dtype).contiguous(),
                 "state": state.contiguous()}


def broadcast_final(incl, tail, mi, sp: bool):
    """The global final recurrent state and conv tail live on the LAST
    sequence shard; a masked sum over the model axes (``tp@ssm_state``)
    gives them to every shard."""
    ax = mi.tp_axes
    if not (sp and mi.tp > 1):
        return incl, tail
    last = ax.index == mi.tp - 1
    state = comms.psum(_where(last, incl, torch.zeros_like(incl)), ax,
                       comms.site("tp", "ssm_state"))
    tf = tail.to(_F32)
    ct = comms.psum(_where(last, tf, torch.zeros_like(tf)), ax,
                    comms.site("tp", "ssm_state"))
    return state, ct


# --------------------------------------------------------------------------
# decode (one token): channels sharded over model by slicing the weights
# --------------------------------------------------------------------------

def mamba_decode(p, x, cache, cfg, mi):
    """x [B, 1, D]; cache {conv [B,K-1,di_loc], state [B,H_loc,P,N]} ->
    (out [B,1,D], the new cache).  Each model shard computes its slice of
    the channels and heads; the out-projection's partial sums add up at
    ``tp@ssm_out``.  The gated RMSNorm normalizes over the shard's
    ``di / tp`` channels, as the reference's does (fault C.19: the
    prefill normalizes over all ``d_inner``)."""
    B = x.shape[0]
    di, P, N = cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_state
    H = di // P
    di_loc, H_loc = di // mi.tp, H // mi.tp
    i = mi.tp_axes.index

    def col(w, width):
        return w[:, i * width:(i + 1) * width]

    def vec(w, width):
        return w[i * width:(i + 1) * width]

    xt = x[:, 0]
    xi = xt @ col(use(p["w_x"], mi), di_loc)
    z = xt @ col(use(p["w_z"], mi), di_loc)
    conv_w = col(use(p["conv_w"], mi), di_loc)
    conv_b = vec(use(p["conv_b"], mi), di_loc)
    win = torch.cat([cache["conv"], xi[:, None, :]], dim=1)
    K = cfg.conv_kernel
    xc = F.silu(sum(win[:, j] * conv_w[j] for j in range(K)) + conv_b)

    dt = F.softplus((xt @ col(use(p["w_dt"], mi), H_loc)).to(_F32)
                    + vec(use(p["dt_bias"], mi), H_loc))
    a = torch.exp(-dt * torch.exp(vec(use(p["A_log"], mi), H_loc)))
    bc = (xt @ use(p["w_bc"], mi)).to(_F32)
    B_, C_ = bc[..., :N], bc[..., N:]                      # [B,N]
    xh = xc.reshape(B, H_loc, P).to(_F32)
    u = dt[..., None] * xh
    S_new = cache["state"] * a[:, :, None, None] \
        + u[..., None] * B_[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", S_new, C_)
    y = y + vec(use(p["D_skip"], mi), H_loc)[None, :, None] * xh
    y = y.reshape(B, di_loc).to(x.dtype) * F.silu(z)
    y = rms_norm(y, vec(use(p["gn"], mi), di_loc), cfg.norm_eps)
    out = y @ use(p["w_out"], mi)[i * di_loc:(i + 1) * di_loc]
    out = comms.psum(out[:, None, :], mi.tp_axes,
                     comms.site("tp", "ssm_out"))
    return out, {"conv": win[:, 1:], "state": S_new}
