"""Shared layer primitives (port of ``repro.models.layers``), written
against this rank's shard shapes.

Training layout ("SP"): activations ``[B_loc, S_loc, D]``, batch over
data, sequence over model.  Decode layout: ``[B, 1, D]`` replicated over
model.  Cast points follow the reference exactly: norms and rope compute
in f32 and return the input dtype, the embedding scale multiplies in the
model dtype, and logits are f32.  Every collective goes through
:mod:`repro_torch.core.comms` at the reference's sites, and every read of
a parameter leaf through :func:`use`, which re-gathers a ZeRO-3 shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comms
from repro_torch.models.params import D as Dd, Pv, fsdp_dim

_F32 = torch.float32


def use(p, mi, name: str | None = None):
    """A parameter leaf as the layer computes with it.  A ZeRO-3 leaf
    (:class:`~repro_torch.models.params.Pv` with a ``"data"`` dim) is
    all-gathered over the inner data axis at ``zero@<name>`` (compressed
    per policy); the backward of that gather is the reduce-scatter of its
    gradient over data, so the DP gradient reduction of such a leaf
    happens here, once, under the ZeRO codec (paper §III C3).  Any other
    leaf is returned as it is."""
    if not isinstance(p, Pv):
        return p
    d = fsdp_dim(p.spec)
    if d is None:
        return p.v
    return comms.all_gather(p.v, mi.dp_axes, d, comms.site("zero", name))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, gain, eps):
    """gemma-style RMSNorm with a ``(1 + gain)`` multiplier."""
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gain.to(_F32))).to(x.dtype)


def layer_norm(x, gain, bias, eps):
    """LayerNorm (xLSTM's ``ln``) in f32, returned in the input dtype."""
    xf = x.to(_F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gain.to(_F32) + bias.to(_F32)).to(x.dtype)


def norm(p, x, cfg, mi):
    if cfg.norm == "ln":
        return layer_norm(x, use(p["g"], mi), use(p["b"], mi), cfg.norm_eps)
    return rms_norm(x, use(p["g"], mi), cfg.norm_eps)


def norm_plan(cfg, D_):
    if cfg.norm == "ln":
        return {"g": Dd((D_,), init="ones", dtype="float32", fsdp_ok=False),
                "b": Dd((D_,), init="zeros", dtype="float32", fsdp_ok=False)}
    return {"g": Dd((D_,), init="zeros", dtype="float32", fsdp_ok=False)}


# --------------------------------------------------------------------------
# rotary position embeddings (qwen2-vl's M-RoPE included)
# --------------------------------------------------------------------------

def _rope_freqs(hd: int, theta: float, device):
    """``theta ** (-i / (hd/2))`` for i < hd/2: the f32 exponent raised in
    f64 and rounded once to f32, which gives the reference's freqs bit for
    bit (an f32 ``pow`` is an ulp off in a few entries, and a position of
    a few thousand turns that ulp into 1e-4 of the rotation)."""
    ar = torch.arange(0, hd // 2, dtype=_F32, device=device)
    return torch.pow(torch.tensor(theta, dtype=torch.float64, device=device),
                     (-ar / (hd // 2)).to(torch.float64)).to(_F32)


def apply_rope(x, pos, theta: float):
    """x: [B, S, H, hd]; pos: [B, S] int (global positions)."""
    hd = x.shape[-1]
    ang = pos[..., None].to(_F32) * _rope_freqs(hd, theta, x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], -1).to(x.dtype)


def mrope_sections(hd: int):
    """qwen2-vl: split the hd/2 rotary freqs into (t, h, w) sections."""
    half = hd // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x, pos3, theta: float):
    """x: [B, S, H, hd]; pos3: [B, S, 3] (t/h/w position ids)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    parts, off = [], 0
    for i, n in enumerate(mrope_sections(hd)):
        parts.append(pos3[..., i:i + 1].to(_F32) * freqs[off:off + n])
        off += n
    ang = torch.cat(parts, -1)                                  # [B,S,hd/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], -1).to(x.dtype)


# --------------------------------------------------------------------------
# vocab-parallel embedding & cross-entropy (Megatron-style)
# --------------------------------------------------------------------------

def embed_plan(cfg):
    return {"table": Dd((cfg.padded_vocab, cfg.d_model), spec=("model", None),
                        dtype=cfg.dtype)}


def embed(p, tokens, cfg, mi, sp: bool = True):
    """Vocab-parallel embedding.  ``sp`` with tp > 1: tokens are the FULL
    sequence [B, S]; each vocab shard contributes its rows and the partial
    embeddings are reduce-scattered over the sequence -> [B, S_loc, D].
    Otherwise (decode, or one model shard) a psum -> [B, S, D]."""
    table = use(p["table"], mi, "embed_table")           # [V_loc, D]
    v_loc = table.shape[0]
    lo = mi.tp_axes.index * v_loc
    local = tokens.long() - lo
    ok = (local >= 0) & (local < v_loc)
    e = table[local.clamp(0, v_loc - 1)]
    e = e * ok[..., None].to(e.dtype)
    if sp and mi.tp > 1:
        e = comms.reduce_scatter(e, mi.tp_axes, 1, comms.site("tp", "embed"))
    else:
        e = comms.psum(e, mi.tp_axes, comms.site("tp", "embed"))
    if cfg.scale_embed:
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype,
                             device=e.device)
    return e


def lm_head_logits(params, x, cfg, mi, sp: bool = True):
    """x [B, S_loc, D] -> vocab-sharded logits [B, S, V_loc] (f32), against
    the embedding table when tied, else the head ``lm_head.w`` [D, V_loc]
    (vocab-sharded over model like the table).  ``sp`` gathers the
    sequence over model first, so every model shard scores the full
    sequence against its vocab slice."""
    if sp and mi.tp > 1:
        x = comms.all_gather(x, mi.tp_axes, 1, comms.site("tp", "lm_head"))
    if cfg.tie_embeddings:
        w = use(params["embed"]["table"], mi, "embed_table")  # [V_loc, D]
        return torch.einsum("bsd,vd->bsv", x.to(_F32), w.to(_F32))
    w = use(params["lm_head"]["w"], mi, "lm_head_w")          # [D, V_loc]
    return torch.einsum("bsd,dv->bsv", x.to(_F32), w.to(_F32))


def lm_head_plan(cfg):
    if cfg.tie_embeddings:
        return {}
    return {"lm_head": {"w": Dd((cfg.d_model, cfg.padded_vocab),
                                spec=(None, "model"), dtype=cfg.dtype)}}


def vocab_parallel_xent(logits, labels, cfg, mi):
    """Vocab-sharded cross-entropy: logits [B, S, V_loc] f32, labels [B, S]
    (-1 = pad) -> per-token loss [B, S] and weight mask [B, S]."""
    v_loc = logits.shape[-1]
    lo = mi.tp_axes.index * v_loc
    # padded vocab columns exist as logits but never as labels: mask them
    # out of the lse
    col = lo + torch.arange(v_loc, device=logits.device)
    logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    # the stabilizer carries no gradient (the lse is shift-invariant)
    m = comms.pmax(logits.detach().amax(dim=-1), mi.tp_axes)       # [B,S]
    z = torch.exp(logits - m[..., None]).sum(dim=-1)
    z = comms.psum(z, mi.tp_axes, comms.site("tp", "xent"))
    lse = m + torch.log(z)
    local = labels.long() - lo
    ok = (local >= 0) & (local < v_loc)
    tl = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    tl = comms.psum(torch.where(ok, tl, 0.0), mi.tp_axes,
                    comms.site("tp", "xent"))
    w = (labels >= 0).to(_F32)
    return (lse - tl) * w, w


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


def mlp(p, x, cfg, mi, sp: bool = True):
    """Column -> row parallel MLP.  ``sp`` (train): all-gather the sequence
    over model -> matmuls -> reduce-scatter it back.  Otherwise (decode,
    x replicated over model): the f/g conjugate pair around the matmuls."""
    if sp:
        xg = comms.all_gather(x, mi.tp_axes, 1, comms.site("tp", "mlp_in"))
    else:
        xg = comms.copy_fwd_psum_bwd(x, mi.tp_axes,
                                     comms.site("tp", "mlp_in"))
    h = _act(xg @ use(p["w1"], mi, "mlp_w1"), cfg.mlp_kind)
    if cfg.mlp_kind in _GATED:
        h = h * (xg @ use(p["w3"], mi, "mlp_w3"))
    y = h.to(x.dtype) @ use(p["w2"], mi, "mlp_w2")
    if sp:
        return comms.reduce_scatter(y, mi.tp_axes, 1,
                                    comms.site("tp", "mlp_out"))
    return comms.psum_fwd_copy_bwd(y, mi.tp_axes, comms.site("tp", "mlp_out"))
