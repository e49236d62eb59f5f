"""Serving: the paged, continuous-batching decode step (port of
``repro.serve.serve_step.PagedServer``), with greedy sampling."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.models import layers, transformer
from repro_torch.models.model import Model
from repro_torch.models.params import MeshInfo
from repro_torch.serve import paged_kv

_INT32_MAX = 2**31 - 1


def greedy_token(logits, cfg, mi: MeshInfo):
    """logits [B, 1, V_loc] -> [B] int32 argmax over the real vocab (the
    reference's vocab-shard max/min-index combine, on one shard)."""
    v_loc = logits.shape[-1]
    lo = 0                                               # one vocab shard
    col = lo + torch.arange(v_loc, device=logits.device)
    logits = torch.where(col < cfg.vocab_size, logits[:, 0],
                         torch.full((), -torch.inf, device=logits.device))
    val = torch.amax(logits, dim=-1)                     # [B]
    idx = lo + torch.argmax(logits, dim=-1).to(torch.int32)
    gmax = comms.pmax(val, mi.tp_axes)
    cand = torch.where(val >= gmax, idx,
                       torch.full_like(idx, _INT32_MAX))
    return -comms.pmax(-cand, mi.tp_axes)                # pmin of candidates


class PagedServer:
    """Continuous-batching decode over a paged (optionally quantized at
    rest) KV pool.

    One step advances a fixed set of decode slots: per-slot token,
    position, block table and active mask come from the host scheduler
    (:mod:`repro_torch.serve.scheduler`).  With ``kv_codec="bq8"`` etc. the
    pool stores bq wire planes: every new token is encoded by the bq
    encode kernel and every attention read goes through the gather-decode
    kernel.  ``backend="torch"`` runs their plain versions instead (for
    the tests and ``chip_smoke.py``).
    """

    def __init__(self, model: Model, kv_codec: str = "none",
                 block_tokens: int = paged_kv.DEFAULT_BLOCK_TOKENS,
                 backend=None):
        self.model = model
        self.kv_codec = kv_codec
        self.bits = paged_kv.storage_bits(kv_codec)
        self.block_tokens = block_tokens
        self.backend = backend

    def decode(self, params, token, pool, tables, pos, active):
        """(token [N,1], pool, tables [N,mb] int32, pos [N], active [N]
        bool) -> (next_token [N] int32, pool updated in place)."""
        model, cfg, mi = self.model, self.model.cfg, self.model.mi
        x = layers.embed(params["embed"], token, cfg, mi, sp=False)
        for i, g in enumerate(cfg.layer_groups):
            x, pool[i] = transformer.decode_group_paged(
                params["groups"][i], x, pool[i], tables, pos, active, g, cfg,
                mi, bits=self.bits, block_tokens=self.block_tokens,
                backend=self.backend)
        x = layers.norm(params["final_norm"], x, cfg, mi)
        logits = layers.lm_head_logits(params, x, cfg, mi, sp=False)
        return greedy_token(logits, cfg, mi), pool

    def decode_step(self, n_slots: int, n_blocks: int, max_blocks: int):
        """-> (step, structs).  ``step(params, token, pool, tables, pos,
        active)`` takes the scheduler's numpy arrays (tables
        [n_slots, max_blocks]; ``max_blocks`` bounds a request's context at
        ``max_blocks * block_tokens`` tokens) and returns (next_token [N]
        numpy int32, pool)."""
        model, cfg, mi = self.model, self.model.cfg, self.model.mi
        if n_slots % mi.batch_ways or n_blocks % mi.batch_ways:
            raise ValueError(
                f"n_slots ({n_slots}) and n_blocks ({n_blocks}) must divide "
                f"by the data ways ({mi.batch_ways})")
        structs = paged_kv.pool_structs(cfg, mi, n_blocks, self.block_tokens,
                                        self.kv_codec)
        dev = model.device

        def to_dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        def step(params, token, pool, tables, pos, active):
            with torch.no_grad():
                nxt, pool = self.decode(
                    params, to_dev(token, torch.int64), pool,
                    to_dev(tables, torch.int32), to_dev(pos, torch.int64),
                    to_dev(active, torch.bool))
            return nxt.cpu().numpy(), pool

        return step, structs
