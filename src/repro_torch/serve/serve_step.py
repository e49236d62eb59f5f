"""Serving: the batched prefill and single-token decode steps (``Server``)
and the paged, continuous-batching decode step (``PagedServer``), ports
of ``repro.serve.serve_step``, with greedy sampling by a vocab-shard
parallel argmax.

Each rank runs its own share of the step: its batch rows (or decode
slots) and its model shard.  Every collective inside goes through
:mod:`repro_torch.core.comms` under the server's compiled plan, as in the
reference; moving tokens and caches between the steps (the reference's
host arrays) is uncompressed and outside the ledger.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.core import policy as policy_lib
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import Model
from repro_torch.models.params import MeshInfo
from repro_torch.serve import kv_cache, paged_kv

_INT32_MAX = 2**31 - 1


def greedy_token(logits, cfg, mi: MeshInfo):
    """logits [B, 1, V_loc] vocab-sharded over the (possibly
    node-factored) model axes -> [B] int32 global argmax over the real
    vocab: each shard's max and first index, then the max over shards and
    the least index that reaches it."""
    v_loc = logits.shape[-1]
    lo = mi.tp_axes.index * v_loc
    col = lo + torch.arange(v_loc, device=logits.device)
    logits = torch.where(col < cfg.vocab_size, logits[:, 0],
                         torch.full((), -torch.inf, device=logits.device))
    val = torch.amax(logits, dim=-1)                     # [B]
    idx = lo + torch.argmax(logits, dim=-1).to(torch.int32)
    gmax = comms.pmax(val, mi.tp_axes)
    cand = torch.where(val >= gmax, idx,
                       torch.full_like(idx, _INT32_MAX))
    return -comms.pmax(-cand, mi.tp_axes)                # pmin of candidates


class Server:
    """Batched serving: one prefill of the whole prompt batch, then greedy
    decode one token per step against a dense KV cache
    (:mod:`repro_torch.serve.kv_cache`).

    ``scheme`` (a name or a policy) is compiled against the model's mesh
    once and bound around both steps, with the ring options.  A ring-mode
    cache's sequence shards over ``seq_axes``, as in the reference:
    ``("model",)`` (batched decode) the joint model axes, its combine
    two-level on a ``--tp-nodes`` mesh; ``("data", "model")`` (the
    long-context decode) the inner data axis and the model axes, data
    major, with the batch replicated over data (a batch of one): each rank
    holds ``S_max / (dp x tp)`` positions, and the flash-decoding combine
    runs over data, then over model."""

    def __init__(self, model: Model, scheme="baseline", seq_axes=("model",),
                 ring_bidir: bool = False, ring_chunks: int = 1):
        self.model = model
        self.plan = policy_lib.compile_plan(scheme, model.mi)
        mi = model.mi
        bad = [ax for ax in seq_axes if ax not in ("data", "model")]
        if bad or not seq_axes:
            raise ValueError(f"seq_axes {tuple(seq_axes)}: entries are "
                             f"'data' and 'model'")
        # the logical names (the cache layout's) and the comms axes they
        # resolve to, "model" the joint model axes (a pair on a factored
        # mesh), "data" the inner data axis
        self.seq_names = tuple(seq_axes)
        self.seq_axes = tuple(mi.tp_axes if ax == "model" else mi.dp_axes
                              for ax in seq_axes)
        self.ring_bidir = ring_bidir
        self.ring_chunks = ring_chunks

    def prefill(self, params, batch):
        """batch {tokens [B_loc, S]} (an encoder-decoder's also ``frames``
        [B_loc, S_enc / tp, D], the encoder's input) -> (first tokens
        [B_loc] int32, the caches in the prefill layout)."""
        model = self.model
        with _bound(self.plan, self.ring_bidir, self.ring_chunks):
            logits, caches = model.forward(params, batch, phase="prefill")
            tok = greedy_token(logits[:, -1:], model.cfg, model.mi)
        return tok, caches

    def decode(self, params, token, caches, index: int):
        """(token [B_loc, 1], decode-layout caches, position ``index``) ->
        (next tokens [B_loc] int32, the caches updated in place)."""
        model, cfg, mi = self.model, self.model.cfg, self.model.mi
        with _bound(self.plan, self.ring_bidir, self.ring_chunks):
            x = layers.embed(params["embed"], token, cfg, mi, sp=False)
            # M-RoPE (qwen2-vl): every section of a decoded token sits at
            # its index, as the reference's decode builds pos3
            pos3 = torch.full((token.shape[0], 1, 3), index,
                              dtype=torch.int32, device=token.device) \
                if cfg.mrope else None
            shared = model.shared_params(params)
            for i, g in enumerate(cfg.layer_groups):
                if g.kind == "enc_attn":      # the encoder ran at prefill
                    continue
                x, caches[i] = transformer.decode_group(
                    model.group_params(params, i), x, caches[i], index, g,
                    cfg, mi, model.mode, self.seq_axes, pos3, shared)
            x = layers.norm(params["final_norm"], x, cfg, mi)
            logits = layers.lm_head_logits(params, x, cfg, mi, sp=False)
            tok = greedy_token(logits, cfg, mi)
        return tok, caches

    def cache_structs(self, B: int, s_max: int, s_enc: int = 0):
        return kv_cache.cache_structs(self.model.cfg, self.model.mi, B,
                                      s_max, s_enc, self.seq_names)

    def pad_prefill_caches(self, caches, B: int, s_max: int,
                           s_enc: int = 0):
        """Prefill caches -> zero-padded decode-layout caches (new tensors).

        An attention cache's ``k`` and ``v`` ([L, B, S, KV, hd], or [B, S,
        KV, hd] unstacked for a shared block) are padded on their sequence
        dim.  Head mode: the prefill cache already holds the whole
        sequence of this rank's heads; it is padded to ``s_max``.  Ring
        mode: the decode shard of sequence shard ``t`` (over
        ``seq_axes``) covers ``[t, t + 1) * s_max / n``, not its prefill
        slice ``[t, t + 1) * S / tp``, so the slices are gathered over the
        model axes first, uncompressed and outside the ledger (the
        reference pads on the host).  Where ``seq_axes`` holds ``"data"``
        the batch is replicated over data, so the prefill ran every row on
        every data rank.  A
        ``dec_attn`` group's cross-attention ``xk`` / ``xv`` are laid out
        the same way at length ``s_enc`` (the encoder's, not padded to
        ``s_max``), and its ``xlen`` holds ``s_enc``, as the reference's
        launcher fills it.  A recurrent state has no sequence dim:
        prefill emits it in the decode layout, and it is copied as it
        is.  An encoder group has no cache (``None``)."""
        cfg, mi = self.model.cfg, self.model.mi
        structs, specs = self.cache_structs(B, s_max, s_enc)
        pre_specs = kv_cache.prefill_cache_specs(cfg, mi, B)
        out = []
        for st, sp, psp, pc in zip(structs, specs, pre_specs, caches):
            if st is None:
                out.append(None)
                continue
            new = {}
            for k, s in st.items():
                if k == "xlen":
                    new[k] = torch.full(s.shape, s_enc, dtype=s.dtype,
                                        device=self.model.device)
                    continue
                a = pc[k]
                if k not in ("k", "v", "xk", "xv"):   # recurrent state
                    if tuple(a.shape) != tuple(s.shape):
                        raise ValueError(f"prefill state {k} of shape "
                                         f"{tuple(a.shape)}, decode wants "
                                         f"{tuple(s.shape)}")
                    new[k] = a.to(s.dtype).clone()
                    continue
                d = a.dim() - 3                   # the sequence dim
                length = s_enc if k in ("xk", "xv") else s_max
                if psp[k][d] == "model":          # the prefill's slice
                    a = comms.raw_all_gather(a, mi.tp_axes, d)
                full = torch.zeros(a.shape[:d] + (length,) + a.shape[d + 1:],
                                   dtype=s.dtype, device=a.device)
                full.narrow(d, 0, a.shape[d]).copy_(a)
                if sp[k][d] is not None:          # the decode shard
                    lo = attention.shard_index(self.seq_axes) * s.shape[d]
                    full = full.narrow(d, lo, s.shape[d]).clone()
                new[k] = full
            out.append(new)
        return out


@contextlib.contextmanager
def _bound(plan, bidir: bool, chunks: int):
    """The compiled plan, the ring options and ``torch.no_grad`` for the
    duration of a serving step."""
    with torch.no_grad(), policy_lib.use_plan(plan), \
            comms.ring_options(bidir, chunks):
        yield


class PagedServer:
    """Continuous-batching decode over a paged (optionally quantized at
    rest) KV pool.

    One step advances a fixed set of decode slots: per-slot token,
    position, block table and active mask come from the host scheduler
    (:mod:`repro_torch.serve.scheduler`).  The slots and the pool's blocks
    split over the data ways (slot ``s`` on data rank ``s // (n_slots /
    batch_ways)``, its table holding that rank's local block ids), the
    KV heads over the model ways.  With ``kv_codec="bq8"`` etc. the pool
    stores bq wire planes: every new token is encoded by the bq encode
    kernel and every attention read goes through the gather-decode kernel.
    ``backend="torch"`` runs their plain versions instead (for the tests
    and ``chip_smoke.py``).
    """

    def __init__(self, model: Model, scheme="baseline",
                 kv_codec: str = "none",
                 block_tokens: int = paged_kv.DEFAULT_BLOCK_TOKENS,
                 ring_bidir: bool = False, ring_chunks: int = 1,
                 backend=None):
        self.model = model
        self.plan = policy_lib.compile_plan(scheme, model.mi)
        self.kv_codec = kv_codec
        self.bits = paged_kv.storage_bits(kv_codec)
        self.block_tokens = block_tokens
        self.ring_bidir = ring_bidir
        self.ring_chunks = ring_chunks
        self.backend = backend

    def decode(self, params, token, pool, tables, pos, active):
        """(token [N,1], pool, tables [N,mb] int32, pos [N], active [N]
        bool), this rank's slots -> (next_token [N] int32, pool updated in
        place)."""
        model, cfg, mi = self.model, self.model.cfg, self.model.mi
        with _bound(self.plan, self.ring_bidir, self.ring_chunks):
            x = layers.embed(params["embed"], token, cfg, mi, sp=False)
            # M-RoPE (qwen2-vl): each slot's sections at its position
            pos3 = pos.to(torch.int32)[:, None, None].expand(
                token.shape[0], 1, 3) if cfg.mrope else None
            shared = model.shared_params(params)
            for i, g in enumerate(cfg.layer_groups):
                x, pool[i] = transformer.decode_group_paged(
                    model.group_params(params, i), x, pool[i], tables, pos,
                    active, g, cfg, mi, bits=self.bits,
                    block_tokens=self.block_tokens, backend=self.backend,
                    pos3=pos3, shared=shared)
            x = layers.norm(params["final_norm"], x, cfg, mi)
            logits = layers.lm_head_logits(params, x, cfg, mi, sp=False)
            return greedy_token(logits, cfg, mi), pool

    def decode_step(self, n_slots: int, n_blocks: int, max_blocks: int):
        """-> (step, structs).  ``n_blocks`` is the GLOBAL pool size (each
        data rank owns ``n_blocks / batch_ways`` of them); ``step(params,
        token, pool, tables, pos, active)`` takes the scheduler's numpy
        arrays for all ``n_slots`` slots (tables [n_slots, max_blocks];
        ``max_blocks`` bounds a request's context at ``max_blocks *
        block_tokens`` tokens), runs this rank's slots and returns
        (next_token [n_slots] numpy int32, pool): the data ranks' tokens
        are gathered uncompressed, outside the ledger, as the reference's
        host reads them."""
        model, cfg, mi = self.model, self.model.cfg, self.model.mi
        if n_slots % mi.batch_ways or n_blocks % mi.batch_ways:
            raise ValueError(
                f"n_slots ({n_slots}) and n_blocks ({n_blocks}) must divide "
                f"by the data ways ({mi.batch_ways})")
        structs = paged_kv.pool_structs(cfg, mi, n_blocks, self.block_tokens,
                                        self.kv_codec)
        dev = model.device
        n_loc = n_slots // mi.batch_ways
        rows = slice(mi.batch_axes.index * n_loc,
                     (mi.batch_axes.index + 1) * n_loc)

        def to_dev(a, dtype):
            return torch.as_tensor(np.asarray(a)[rows], dtype=dtype).to(dev)

        def step(params, token, pool, tables, pos, active):
            nxt, pool = self.decode(
                params, to_dev(token, torch.int64), pool,
                to_dev(tables, torch.int32), to_dev(pos, torch.int64),
                to_dev(active, torch.bool))
            nxt = comms.raw_all_gather(nxt, mi.batch_axes, 0)
            return nxt.cpu().numpy(), pool

        return step, structs
