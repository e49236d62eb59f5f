"""xLSTM blocks (port of ``repro.models.xlstm``): the mLSTM (matrix
memory, chunkwise-parallel) and the sLSTM (scalar memory with recurrent
mixing, sequential).

The mLSTM reuses the chunked linear-recurrence engine of
:mod:`repro_torch.models.ssm` (the same ``S_t = a_t S + u (x) r`` form)
with its cross-shard prefix over the compressed ``pp@ssm_scan`` exchange,
once for the numerator and once for the denominator.  As in the
reference, its exponential input gate is a sigmoid gate, so no
max-stabilizer scan is needed.

The sLSTM cannot run in parallel over the sequence (its recurrence is
nonlinear through the hidden state), so under sequence sharding it either
  * trades the sequence sharding for batch sharding over the model axes by
    an all-to-all (``ep@slstm_transpose``, compressed under the scheme's
    MP codec; needs ``B_loc % tp == 0``), the default, or
  * all-gathers the sequence (``tp@slstm_seq``) and computes redundantly
    (the fallback).
Its step body is a few fused tensor ops: one batched matmul of the hidden
state against the four gates' recurrent weights, then the max-stabilized
exponential gates.
"""

from __future__ import annotations

import torch

from repro_torch.core import comms
from repro_torch.models.layers import use
from repro_torch.models.params import D as Dd
from repro_torch.models.ssm import (_bexp, broadcast_final, carry_in,
                                    chunked_outer_scan, cross_shard_prefix)

_F32 = torch.float32
_GATES = "ifzo"


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_plan(cfg):
    Dm = cfg.d_model
    di = int(cfg.proj_factor * Dm)          # value width
    H, hd = cfg.n_heads, cfg.head_dim_      # q/k width per head
    return {
        "w_q": Dd((Dm, H * hd), dtype=cfg.dtype),
        "w_k": Dd((Dm, H * hd), dtype=cfg.dtype),
        "w_v": Dd((Dm, di), dtype=cfg.dtype),
        "w_i": Dd((Dm, H), dtype=cfg.dtype),
        "w_f": Dd((Dm, H), dtype=cfg.dtype),
        "b_f": Dd((H,), init="ones", dtype="float32", fsdp_ok=False),
        "w_o": Dd((Dm, di), dtype=cfg.dtype),
        "w_out": Dd((di, Dm), dtype=cfg.dtype),
    }


def mlstm_block(p, x, cfg, mi, sp: bool = True, want_cache: bool = False):
    """x [B, S_loc, D] -> [B, S_loc, D] (and with ``want_cache`` the
    decode-layout state {C, n})."""
    B, S, Dm = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    di = int(cfg.proj_factor * Dm)
    Pv = di // H

    q = (x @ use(p["w_q"], mi)).reshape(B, S, H, hd)
    k = (x @ use(p["w_k"], mi)).reshape(B, S, H, hd)
    v = (x @ use(p["w_v"], mi)).reshape(B, S, H, Pv)
    f = torch.sigmoid((x @ use(p["w_f"], mi)).to(_F32) + use(p["b_f"], mi))
    ig = torch.sigmoid((x @ use(p["w_i"], mi)).to(_F32))
    u_num = ig[..., None] * v.to(_F32)                     # [B,S,H,Pv]
    r = k.to(_F32) * hd ** -0.5
    qf = q.to(_F32)

    num, Sn_fin, d_tot = chunked_outer_scan(f, u_num, r, qf)
    den, Sd_fin, _ = chunked_outer_scan(f, ig[..., None], r, qf)

    sn_in = sd_in = None
    if sp and mi.tp > 1:
        ax = mi.tp_axes
        sn_in = cross_shard_prefix(d_tot, Sn_fin, mi, ax)
        sd_in = cross_shard_prefix(d_tot, Sd_fin, mi, ax)
        num = carry_in(num, sn_in, qf, f)
        den = carry_in(den, sd_in, qf, f)

    y = num / torch.clamp(torch.abs(den), min=1.0)         # [B,S,H,Pv]
    o = torch.sigmoid((x @ use(p["w_o"], mi)).to(_F32))
    y = (y.reshape(B, S, di) * o).to(x.dtype)
    out = y @ use(p["w_out"], mi)
    if not want_cache:
        return out

    # prefill -> decode handoff (decode shards C on the value dim)
    inc_n = Sn_fin if sn_in is None else sn_in * _bexp(d_tot) + Sn_fin
    inc_d = Sd_fin if sd_in is None else sd_in * _bexp(d_tot) + Sd_fin
    none = torch.zeros((B, 1, 1), dtype=_F32, device=x.device)
    C_tot, _ = broadcast_final(inc_n, none, mi, sp)
    n_tot, _ = broadcast_final(inc_d, none, mi, sp)
    tp = mi.tp
    if Pv % tp == 0 and tp > 1:
        i, w = mi.tp_axes.index, Pv // tp
        C_tot = C_tot[:, :, i * w:(i + 1) * w]
    return out, {"C": C_tot.contiguous(), "n": n_tot[:, :, 0, :]}


def mlstm_decode(p, x, cache, cfg, mi):
    """One token; the matrix state sharded over the model axes on the
    value dim when ``Pv % tp == 0`` (the out-projection's partial sums add
    up at ``tp@xlstm_out``).  cache {C [B,H,Pv_loc,hd], n [B,H,hd]} (n
    replicated: small)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim_
    di = int(cfg.proj_factor * cfg.d_model)
    Pv = di // H
    tp = mi.tp
    sharded = Pv % tp == 0 and tp > 1
    w = Pv // tp if sharded else Pv
    i = mi.tp_axes.index
    xt = x[:, 0]

    q = (xt @ use(p["w_q"], mi)).reshape(B, H, hd).to(_F32)
    k = (xt @ use(p["w_k"], mi)).reshape(B, H, hd).to(_F32) * hd ** -0.5
    v = (xt @ use(p["w_v"], mi)).reshape(B, H, Pv).to(_F32)
    if sharded:                     # this shard's value columns, per head
        v = v[:, :, i * w:(i + 1) * w]
    f = torch.sigmoid((xt @ use(p["w_f"], mi)).to(_F32) + use(p["b_f"], mi))
    ig = torch.sigmoid((xt @ use(p["w_i"], mi)).to(_F32))

    C = cache["C"] * f[:, :, None, None] \
        + (ig[..., None] * v)[..., None] * k[:, :, None, :]
    n = cache["n"] * f[..., None] + ig[..., None] * k
    num = torch.einsum("bhpn,bhn->bhp", C, q)              # [B,H,Pv(_loc)]
    den = torch.einsum("bhn,bhn->bh", n, q)[..., None]
    y = num / torch.clamp(torch.abs(den), min=1.0)

    o = torch.sigmoid((xt @ use(p["w_o"], mi)).to(_F32))
    if sharded:
        # the o-gate's slice and the row-sliced out-projection, summed
        og = o.reshape(B, H, Pv)[:, :, i * w:(i + 1) * w]
        y = (y * og).reshape(B, H * w).to(x.dtype)
        w_out = use(p["w_out"], mi).reshape(H, Pv, cfg.d_model)
        out = y @ w_out[:, i * w:(i + 1) * w].reshape(H * w, cfg.d_model)
        out = comms.psum(out[:, None], mi.tp_axes,
                         comms.site("tp", "xlstm_out"))
    else:
        y = (y.reshape(B, di) * o).to(x.dtype)
        out = (y @ use(p["w_out"], mi))[:, None]
    return out, {"C": C, "n": n}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_plan(cfg):
    Dm, H = cfg.d_model, cfg.n_heads
    hd = Dm // H
    p = {"w_out": Dd((Dm, Dm), dtype=cfg.dtype)}
    for g in _GATES:
        p[f"w_{g}"] = Dd((Dm, Dm), dtype=cfg.dtype)
        p[f"r_{g}"] = Dd((H, hd, hd), scale=0.05, dtype=cfg.dtype)
        p[f"b_{g}"] = Dd((Dm,), init="zeros", dtype="float32", fsdp_ok=False)
    return p


def slstm_scan(p, x, cfg, mi, state=None):
    """The sequential sLSTM over the local sequence x [B, S, D] (all
    channels), with exponential gates and the xLSTM max-stabilizer.
    ``state`` is ``(h, c, n, m)`` [B,H,hd] each (zeros, ones for ``n``,
    by default).  Returns (y [B,S,D] f32, the final ``(h, c, n, m)``)."""
    B, S, Dm = x.shape
    H = cfg.n_heads
    hd = Dm // H
    # the four gates' pre-activations [S, H, B, 4 * hd], gate-major per
    # head, and their recurrent weights side by side [H, hd, 4 * hd]
    pre = torch.stack([(x @ use(p[f"w_{g}"], mi)).to(_F32)
                       + use(p[f"b_{g}"], mi) for g in _GATES], 2)
    pre = pre.reshape(B, S, 4, H, hd).permute(1, 3, 0, 2, 4).reshape(
        S, H, B, 4 * hd)
    R = torch.cat([use(p[f"r_{g}"], mi).to(_F32) for g in _GATES], -1)
    if state is None:
        z = torch.zeros((B, H, hd), dtype=_F32, device=x.device)
        state = (z, z, torch.ones_like(z), z)
    # the step runs head-major [H, B, hd]: the recurrent matmul is one bmm
    h, c, n, m = (t.transpose(0, 1) for t in state)
    ys = []
    for t in range(S):
        g = pre[t] + torch.bmm(h, R)                       # [H,B,4hd]
        gi, gf, gz, go = g.split(hd, -1)
        m_new = torch.maximum(gf + m, gi)
        iq = torch.exp(gi - m_new)
        fq = torch.exp(gf + m - m_new)
        c = fq * c + iq * torch.tanh(gz)
        n = fq * n + iq
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(h)
    y = torch.stack(ys, 0).permute(2, 0, 1, 3).reshape(B, S, Dm)
    return y, tuple(t.transpose(0, 1).contiguous() for t in (h, c, n, m))


def slstm_block(p, x, cfg, mi, sp: bool = True, want_cache: bool = False):
    """x [B, S_loc, D] -> [B, S_loc, D] under sequence sharding: by
    default the all-to-all batch <-> sequence transpose, so every model
    shard runs whole sequences of a batch slice; the sequence all-gather
    and redundant compute when ``B_loc`` does not divide by tp."""
    B, S, Dm = x.shape
    tp, ax = mi.tp, mi.tp_axes
    if not sp or tp == 1:
        y, fin = slstm_scan(p, x, cfg, mi)
    elif B % tp == 0:
        xt = comms.all_to_all(x, ax, 0, 1,
                              comms.site("ep", "slstm_transpose"))
        y, fin = slstm_scan(p, xt, cfg, mi)             # [B/tp, S*tp, D]
        y = comms.all_to_all(y, ax, 1, 0,
                             comms.site("ep", "slstm_transpose"))
        if want_cache:                                  # regather the batch
            fin = tuple(comms.all_gather(t, ax, 0,
                                         comms.site("tp", "slstm_state"))
                        for t in fin)
    else:
        xg = comms.all_gather(x, ax, 1, comms.site("tp", "slstm_seq"))
        yg, fin = slstm_scan(p, xg, cfg, mi)
        i = ax.index
        y = yg[:, i * S:(i + 1) * S]
    # the f32 scan output meets the weight in f32 (jnp's promotion)
    out = y @ use(p["w_out"], mi).to(_F32)
    if not want_cache:
        return out
    return out, dict(zip("hcnm", fin))


def slstm_decode(p, x, cache, cfg, mi):
    """One step; the state replicated (the sLSTM's state is small)."""
    y, fin = slstm_scan(p, x, cfg, mi, tuple(cache[k] for k in "hcnm"))
    return y @ use(p["w_out"], mi).to(_F32), dict(zip("hcnm", fin))
