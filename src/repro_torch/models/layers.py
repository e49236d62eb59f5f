"""Shared layer primitives (port of ``repro.models.layers`` for the decode
path on one device).

Cast points follow the reference exactly: norms and rope compute in f32
and return the input dtype, the embedding scale multiplies in the model
dtype, and logits are f32.  Collectives go through
:mod:`repro_torch.core.comms`, where the reference calls them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comms
from repro_torch.models.params import D as Dd

_F32 = torch.float32


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, gain, eps):
    """gemma-style RMSNorm with a ``(1 + gain)`` multiplier."""
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gain.to(_F32))).to(x.dtype)


def norm(p, x, cfg, mi):
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not yet ported")
    return rms_norm(x, p["g"], cfg.norm_eps)


def norm_plan(cfg, D_):
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not yet ported")
    return {"g": Dd((D_,), init="zeros", dtype="float32", fsdp_ok=False)}


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device):
    ar = torch.arange(0, hd // 2, dtype=_F32, device=device)
    return torch.pow(torch.tensor(theta, dtype=_F32, device=device),
                     -ar / (hd // 2))


def apply_rope(x, pos, theta: float):
    """x: [B, S, H, hd]; pos: [B, S] int (global positions)."""
    hd = x.shape[-1]
    ang = pos[..., None].to(_F32) * _rope_freqs(hd, theta, x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], -1).to(x.dtype)


# --------------------------------------------------------------------------
# embedding & head (vocab-parallel in the reference; one shard here)
# --------------------------------------------------------------------------

def embed_plan(cfg):
    return {"table": Dd((cfg.padded_vocab, cfg.d_model), spec=("model", None),
                        dtype=cfg.dtype)}


def embed(p, tokens, cfg, mi):
    """Decode-form embedding: tokens [B, 1] -> [B, 1, D]."""
    table = p["table"]                                    # [V_loc, D]
    v_loc = table.shape[0]
    lo = 0                                                # one vocab shard
    local = tokens.long() - lo
    ok = (local >= 0) & (local < v_loc)
    e = table[local.clamp(0, v_loc - 1)]
    e = e * ok[..., None].to(e.dtype)
    e = comms.psum(e, mi.tp_axes, "tp/embed")
    if cfg.scale_embed:
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype,
                             device=e.device)
    return e


def lm_head_logits(params, x, cfg, mi):
    """x [B, S, D] -> logits [B, S, V] (f32), tied to the embedding."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied lm_head is not yet ported")
    w = params["embed"]["table"]                          # [V_loc, D]
    return torch.einsum("bsd,vd->bsv", x.to(_F32), w.to(_F32))


def lm_head_plan(cfg):
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied lm_head is not yet ported")
    return {}


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

_GATED = {"swiglu", "geglu"}


def mlp_plan(cfg, d_ff=None):
    f = d_ff or cfg.d_ff
    p = {"w1": Dd((cfg.d_model, f), spec=(None, "model"), dtype=cfg.dtype),
         "w2": Dd((f, cfg.d_model), spec=("model", None), dtype=cfg.dtype)}
    if cfg.mlp_kind in _GATED:
        p["w3"] = Dd((cfg.d_model, f), spec=(None, "model"), dtype=cfg.dtype)
    return p


def _act(h, kind):
    if kind == "swiglu":
        return F.silu(h)
    if kind in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    if kind == "relu2":
        r = F.relu(h)
        return r * r
    raise ValueError(kind)


def mlp(p, x, cfg, mi):
    """Decode-form MLP: x [B, 1, D] replicated; row-parallel output psum."""
    h = x @ p["w1"]
    h = _act(h, cfg.mlp_kind)
    if cfg.mlp_kind in _GATED:
        h = h * (x @ p["w3"])
    y = h.to(x.dtype) @ p["w2"]
    return comms.psum(y, mi.tp_axes, "tp/mlp_out")
