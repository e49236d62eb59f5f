"""Block assembly (port of ``repro.models.transformer`` for attention
groups): parameter plans, the training bodies and the paged decode bodies.

Each group's ``n`` identical layers are stacked on a leading axis, as in
the reference; where the reference runs ``lax.scan`` over that axis, a
Python loop walks it here.  Training runs without rematerialization: the
activations of every layer stay alive for the backward pass.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models import attention, layers
from repro_torch.models.config import ArchConfig, BlockGroup
from repro_torch.models.params import MeshInfo, tree_map_defs


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

def block_plan(cfg: ArchConfig, kind: str, mode: str):
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not yet ported")
    p = {"ln1": layers.norm_plan(cfg, cfg.d_model),
         "attn": attention.attn_plan(cfg, mode)}
    if cfg.d_ff:
        p.update(ln2=layers.norm_plan(cfg, cfg.d_model),
                 mlp=layers.mlp_plan(cfg))
    return p


def _stack(plan, n: int):
    return tree_map_defs(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      spec=(None,) + d.spec), plan)


def model_plan(cfg: ArchConfig, mi: MeshInfo):
    mode = cfg.attn_mode_for(mi.tp)
    plan = {"embed": layers.embed_plan(cfg)}
    plan.update(layers.lm_head_plan(cfg))
    plan["final_norm"] = layers.norm_plan(cfg, cfg.d_model)
    plan["groups"] = [_stack(block_plan(cfg, g.kind, mode), g.n)
                      for g in cfg.layer_groups]
    return plan


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked group tree (views, no copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """A stacked group tree -> ``n`` per-layer trees of views.  ``unbind``
    keeps autograd to one stacked gradient per leaf (indexing each layer
    would allocate a full-size gradient per layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# --------------------------------------------------------------------------
# training bodies
# --------------------------------------------------------------------------

def run_block(kind, p, x, cfg, mi, mode, g: BlockGroup, pos):
    """One training layer: x [B, S_loc, D] -> [B, S_loc, D]."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not yet ported")
    h = layers.norm(p["ln1"], x, cfg, mi)
    x = x + attention.attn_train(p["attn"], h, pos, cfg, mi, mode,
                                 causal=cfg.causal, window=g.window)
    if cfg.d_ff:
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + layers.mlp(p["mlp"], h, cfg, mi, sp=True)
    return x


def run_group(gp, x, g: BlockGroup, cfg, mi, mode, pos):
    """The group's ``n`` layers in order."""
    for p in _unstack(gp, g.n):
        x = run_block(g.kind, p, x, cfg, mi, mode, g, pos)
    return x


# --------------------------------------------------------------------------
# paged decode bodies
# --------------------------------------------------------------------------

def decode_block_paged(kind, p, x, pool, tables, pos, active, cfg, mi,
                       g: BlockGroup, *, bits, block_tokens, backend=None):
    """Per-slot decode body against one layer's paged KV pool."""
    if kind != "attn":
        raise NotImplementedError(
            f"paged decode of layer kind {kind!r} is not yet ported")
    h = layers.norm(p["ln1"], x, cfg, mi)
    r, pool = attention.attn_decode_paged(
        p["attn"], h, pool, tables, pos, active, cfg, mi, bits=bits,
        block_tokens=block_tokens, window=g.window, backend=backend)
    x = x + r
    if cfg.d_ff:
        h = layers.norm(p["ln2"], x, cfg, mi)
        x = x + layers.mlp(p["mlp"], h, cfg, mi, sp=False)
    return x, pool


def decode_group_paged(gp, x, pool, tables, pos, active, g: BlockGroup, cfg,
                       mi, *, bits, block_tokens, backend=None):
    """Run the group's layers in order; each writes its own slice of the
    group's stacked pool in place.  Returns (x, pool)."""
    for i in range(g.n):
        x, _ = decode_block_paged(g.kind, layer_slice(gp, i), x,
                                  layer_slice(pool, i), tables, pos, active,
                                  cfg, mi, g, bits=bits,
                                  block_tokens=block_tokens, backend=backend)
    return x, pool
