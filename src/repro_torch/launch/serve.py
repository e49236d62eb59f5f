"""Serving entry point: batched, paged-continuous and disaggregated modes
(port of ``repro.launch.serve``), as a world of processes.

    # batched prefill + greedy decode, ring attention over tp 2, bq16 on
    # the TP collectives (on the card: drop --reduced --device cpu)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --reduced --mode batched --dp 2 --tp 2 --scheme zhybrid_16_8 \\
        --batch 4 --prompt-len 16 --gen 8 --device cpu

    # two-level TP collectives on a --tp-nodes mesh
    ... --mode batched --tp 4 --tp-nodes 2 --scheme hier_tpp_8_16

    # continuous batching over a paged KV pool quantized at rest, its
    # slots and blocks split over 2 data ranks
    ... --mode paged --dp 2 --kv-codec bq8 --slots 4 --batch 8

    # long-context decode: the cache's sequence over (data, model), a
    # batch of one, the cache filled to 1016 of 1024 positions in place of
    # a prefill, 8 tokens decoded
    ... --mode batched --dp 2 --tp 2 --seq-axes data,model --batch 1 \
        --max-len 1024 --fill 1016 --gen 9

    # prefill/decode disaggregation: a prefill pool and a decode pool of
    # dp x tp ranks each, the KV handoff compressed under the kv codec
    ... --mode disagg --dp 1 --tp 2 --kv-codec bq8 --batch 4

The flags are those of ``repro.launch.serve``, plus ``--device``.  The
policy flags (``--scheme``, ``--codec-for``, ``--no-compress-below``)
build the policy as the training launcher does
(:func:`repro_torch.launch.train.comm_policy`), and the ``kv`` dimension
routes the disaggregated handoff.  Each rank runs its share of the step
(:func:`serve_rank`) on the card, or on the CPU with ``--device cpu``;
the command spawns ``dp * tp`` processes (``2 * dp * tp`` for
``disagg``).  A flag the chosen mode would not use, and ``--tp-nodes``
with ``--mode disagg`` (which the reference ignores there), are refused,
never ignored.  Paged serving needs head-mode attention, so ``--mode
paged`` at a tp where the architecture runs ring attention, or on a
stack with layers that have no paged cache (the recurrent families,
whisper's encoder-decoder), raises the reference's
``NotImplementedError`` before anything starts.

An encoder-decoder (whisper-base) serves with stub frame embeddings
drawn as the reference's batched launcher draws them
(:func:`make_frames`, the encoder as long as the prompt), in ``--mode
disagg`` too, where the reference's launcher feeds none (fault C.22).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import torch

# flags that only some modes use: (attribute, default, modes)
_MODE_FLAGS = (("kv_codec", "none", ("paged", "disagg")),
               ("block_tokens", 16, ("paged",)),
               ("slots", 4, ("paged",)),
               ("kv_blocks", 0, ("paged",)),
               ("max_len", 0, ("batched", "disagg")),
               ("seq_axes", "model", ("batched",)),
               ("fill", 0, ("batched",)))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=("batched", "paged", "disagg"),
                    default="batched",
                    help="batched: dense prefill + decode; paged: continuous "
                         "batching over a paged KV pool; disagg: prefill/"
                         "decode pools with a compressed KV handoff "
                         "(2 * dp * tp ranks)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4,
                    help="requests (batched/disagg: batch size; paged: "
                         "total submitted requests)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0,
                    help="batched/disagg: cache length (0 = the prompt and "
                         "the generation, rounded up to 2 * tp)")
    ap.add_argument("--scheme", default="baseline")
    ap.add_argument("--kv-codec", default="none",
                    help="paged: at-rest storage codec of the KV pool "
                         "(none | bq4/bq8/bq16/bq24); disagg: wire codec "
                         "of the prefill -> decode handoff")
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="paged: KV block size in tokens")
    ap.add_argument("--slots", type=int, default=4,
                    help="paged: concurrent decode slots")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged: global pool blocks (0 = sized to fit all "
                         "slots at max context)")
    ap.add_argument("--no-compress-below", type=int, default=0,
                    metavar="BYTES")
    ap.add_argument("--codec-for", action="append", default=[],
                    metavar="[DIM@]NAME_GLOB=CODEC")
    ap.add_argument("--ring-bidir", action="store_true")
    ap.add_argument("--ring-chunks", type=int, default=1)
    ap.add_argument("--tp-nodes", default="1",
                    help="factor tp into (tpnode, model); the TP "
                         "collectives run two-level (batched and paged)")
    ap.add_argument("--seq-axes", default="model",
                    choices=("model", "data,model"),
                    help="batched: the axes a ring-mode cache's sequence "
                         "shards over; 'data,model' is the reference's "
                         "long-context decode (dp x tp shards, the batch "
                         "replicated over data)")
    ap.add_argument("--fill", type=int, default=0,
                    help="batched: skip the prefill and decode from a cache "
                         "filled with seeded values up to this index (a "
                         "context too long to prefill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def unported(args) -> list[str]:
    """Messages for every flag the chosen mode cannot honour."""
    out = []
    for attr, default, modes in _MODE_FLAGS:
        val = getattr(args, attr)
        if val != default and args.mode not in modes:
            flag = "--" + attr.replace("_", "-")
            out.append(f"{flag} {val!r} has no effect in --mode "
                       f"{args.mode} (it applies to {', '.join(modes)})")
    if args.mode == "disagg" and str(args.tp_nodes) != "1":
        out.append(f"--tp-nodes {args.tp_nodes} is refused with --mode "
                   f"disagg: the disaggregated mesh is (pool, data, model), "
                   f"not node-factored (the reference ignores the flag "
                   f"there)")
    return out


def world_size(mode: str, dp: int, tp: int) -> int:
    return dp * tp * (2 if mode == "disagg" else 1)


def check(args) -> None:
    """Raise before anything starts for flags the ranks cannot run:
    ``ValueError`` / ``KeyError`` for a bad policy, node spec or shape,
    and the reference's ``NotImplementedError`` for paged serving where
    the architecture runs ring attention."""
    from repro_torch.launch.mesh import parse_nodes_spec
    from repro_torch.launch.train import comm_policy, model_config
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import paged_kv

    comm_policy(args.scheme, args.codec_for, args.no_compress_below)
    parse_nodes_spec(args.tp_nodes, args.tp, flag="--tp-nodes")
    cfg = model_config(args.arch, args.reduced)
    if args.mode == "paged":
        paged_kv.pool_structs(cfg, MeshInfo(tp=args.tp), 1,
                              args.block_tokens, args.kv_codec)
        return
    if args.prompt_len % args.tp:
        raise ValueError(f"--prompt-len {args.prompt_len} does not split "
                         f"over tp {args.tp}")
    if args.batch > 1 and args.batch % args.dp:
        raise ValueError(f"--batch {args.batch} does not split over dp "
                         f"{args.dp}")


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int):
    """The reference launcher's prompts: [batch, prompt_len] int32."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32)


def make_frames(batch: int, length: int, d_model: int, seed: int):
    """The reference batched launcher's stub encoder input for an
    encoder-decoder: [batch, length, d_model] f32 normals from ``seed``."""
    return np.random.default_rng(seed).normal(
        size=(batch, length, d_model)).astype(np.float32)


def serve_requests(model, params, prompts, gen: int, kv_codec: str = "none",
                   block_tokens: int = 16, slots: int = 4, kv_blocks: int = 0,
                   backend=None, scheme="baseline", ring_bidir: bool = False,
                   ring_chunks: int = 1, first_events: list | None = None):
    """Serve every prompt (a list of token lists) for ``gen`` tokens by
    continuous batching over a paged pool on ``model``'s mesh and device
    (every rank runs the same scheduler; ``max(slots, batch_ways)`` slots,
    ``kv_blocks`` or enough for every slot at the longest context).  With
    ``first_events`` (a list), the first step's ledger
    (``comms.record_traffic``'s log) is appended to it.

    Returns (finished {request index: tokens}, pool, steps, seconds)."""
    from repro_torch.core import comms
    from repro_torch.serve import paged_kv
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.serve_step import PagedServer

    mi = model.mi
    max_blocks = paged_kv.blocks_needed(max(map(len, prompts)) + gen,
                                        block_tokens)
    n_slots = max(slots, mi.batch_ways)
    n_blocks = kv_blocks or n_slots * max_blocks
    srv = PagedServer(model, scheme=scheme, kv_codec=kv_codec,
                      block_tokens=block_tokens, ring_bidir=ring_bidir,
                      ring_chunks=ring_chunks, backend=backend)
    step, structs = srv.decode_step(n_slots, n_blocks, max_blocks)
    pool = paged_kv.zero_pool(structs, model.device)
    sched = Scheduler(n_slots, n_blocks, block_tokens, max_blocks,
                      dp=mi.batch_ways)
    for rid, prompt in enumerate(prompts):
        sched.submit(rid, prompt, gen)
    seen = []

    def traced(*a):
        if first_events is None or seen:
            return step(*a)
        seen.append(True)
        with comms.record_traffic() as ev:
            out = step(*a)
        first_events.append(ev)
        return out

    _sync(model.device)
    t0 = time.perf_counter()
    finished, pool, steps = sched.run(traced, params, pool)
    _sync(model.device)
    return finished, pool, steps, time.perf_counter() - t0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes (bit-for-bit comparisons across runs)."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(b.cpu().numpy().tobytes()).hexdigest()


def _leaves(tree, path=""):
    """(path, tensor) pairs of a tree of dicts and lists (None skipped)."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")


def _numpy(tree):
    """f32 numpy copies of a tree's leaves, by path."""
    return {p: t.detach().float().cpu().numpy().copy()
            for p, t in _leaves(tree)}


def _ledger(events) -> dict:
    """Analytic events with their priced bytes per ``dim/level`` (no
    backward: serving) and the measured wire per ``dim/level``."""
    from repro_torch.analysis import roofline
    return {"events": list(events),
            "priced": roofline.ledger_summary(events, train=False)
            ["per_dim_level"],
            "measured": roofline.wire_per_dim_level(events.wire)}


def serve_rank(*, rank: int = 0, world: int = 1, arch: str = "gemma3-1b",
               reduced: bool = False, depth: int = 0, cfg=None,
               mode: str = "batched", dp: int = 1, tp: int = 1,
               tp_nodes: int = 1, batch: int = 4, prompt_len: int = 16,
               gen: int = 8, max_len: int = 0, scheme: str = "baseline",
               codec_for=(), no_compress_below: int = 0,
               kv_codec: str = "none", block_tokens: int = 16,
               slots: int = 4, kv_blocks: int = 0, ring_bidir: bool = False,
               ring_chunks: int = 1, seed: int = 0, device=None,
               backend=None, prompts=None, init_from: str = "",
               keep_state: bool = False, deterministic: bool = False,
               time_staging: bool = False, seq_axes=("model",),
               fill: int = 0, caches_from: str = "") -> dict:
    """Serve as rank ``rank`` of a ``dp x tp`` world (``2 x dp x tp`` in
    ``disagg`` mode, pool outermost) whose process group is initialized,
    or alone.  ``cfg`` serves that config instead of ``arch``'s
    (``reduced``, ``depth`` cut as the training launcher cuts it);
    ``prompts`` (token lists) replace the seeded ``[batch, prompt_len]``
    prompts of the reference's launcher (an encoder-decoder's frames are
    :func:`make_frames`' for the prompts' shape and ``seed``); ``init_from`` names a pickle of a
    global parameter tree (the reference's weights) to serve instead of
    ``seed``'s; ``backend="torch"`` runs every bq op through its plain
    version; ``deterministic`` turns on
    ``torch.use_deterministic_algorithms`` and turns TF32 off;
    ``time_staging`` times every exchange (a device drain before each).
    ``seq_axes`` shards a ring-mode cache's sequence as the reference's
    ``Server`` takes it: ``("model",)``, or ``("data", "model")`` for the
    long-context decode (the batch replicated over data, the combine over
    both axes).  ``fill`` replaces the prefill by a cache filled to that
    index (:func:`~repro_torch.serve.kv_cache.fill_caches`, from
    ``seed``; ``caches_from`` names a pickle of the reference's GLOBAL
    decode caches to start from instead, carried into this rank's layout
    by :func:`~repro_torch.serve.kv_cache.local_cache`); the decode then
    runs ``gen`` steps at positions ``fill`` on, from the prompts' first
    tokens (a context too long to prefill).

    Returns this rank's record: the tokens (all requests; in ``disagg``
    mode meaningful on the decode pool, ``pool`` 1), seconds of the
    prefill and of each decode step, the ledger of the prefill, of the
    first decode step and of the handoff (analytic events, priced and
    measured bytes per ``dim/level``), sha256 digests of every cache leaf
    or pool plane after the prefill (decode layout) and at the end, the
    kernel launches by kernel, by (kernel, wire rows, rate) and by link
    level, the peak device memory,
    the staged bytes and seconds, the wall seconds from the prefill to the
    last token (``wall_s``), and with ``keep_state`` the prefill
    caches (their own layout), the final caches or pool and the paged
    pool's allocated bytes as f32 numpy arrays."""
    import pickle

    from repro_torch.core import comms
    from repro_torch.kernels import bq, ops
    from repro_torch.launch.mesh import make_disagg_mesh, make_mesh
    from repro_torch.launch.train import comm_policy, model_config, \
        rank_device
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_jax_params
    from repro_torch.serve import kv_cache
    from repro_torch.serve.disagg import DECODE, DisaggServer
    from repro_torch.serve.serve_step import Server

    if world != world_size(mode, dp, tp):
        raise ValueError(f"--mode {mode} at dp {dp} x tp {tp} needs "
                         f"{world_size(mode, dp, tp)} ranks, not {world}")
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ops.set_default_backend(backend)
    comms.time_staging(time_staging)
    cfg = cfg or model_config(arch, reduced, depth=depth)
    mi = make_disagg_mesh(dp, tp) if mode == "disagg" else \
        make_mesh(dp, tp, tp_nodes=tp_nodes)
    model = Model(cfg, mi, device=dev)
    if init_from:
        with open(init_from, "rb") as f:
            params = from_jax_params(pickle.load(f), cfg, dev, mi)
    else:
        params = _init_in_turn(model, seed, rank, world, dev)
    pol = comm_policy(scheme, codec_for, no_compress_below)
    if prompts is None:
        prompts = make_prompts(cfg.vocab_size, batch, prompt_len, seed)
    out = {"rank": rank, "mode": mode,
           "pool": mi.pool_axis.index if mi.pool_axis else 0,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "ledger": {}, "digests": {}}
    bq.reset_launches()
    comms.reset_staging()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if mode == "paged":
        prompts = [list(map(int, p)) for p in prompts]
        first = []
        fin, pool, steps, secs = serve_requests(
            model, params, prompts, gen, kv_codec=kv_codec,
            block_tokens=block_tokens, slots=slots, kv_blocks=kv_blocks,
            backend=backend, scheme=pol, ring_bidir=ring_bidir,
            ring_chunks=ring_chunks, first_events=first)
        out["ledger"]["decode"] = _ledger(first[0])
        out["tokens"] = [fin[i] for i in range(len(prompts))]
        out.update(steps=steps, decode_s=[secs / steps] * steps,
                   prefill_s=0.0, wall_s=secs)
        out["digests"]["final"] = {p: _digest(t) for p, t in _leaves(pool)}
        out["pool_bytes"] = sum(t.numel() * t.element_size()
                                for _, t in _leaves(pool))
        if keep_state:
            out["final"] = _numpy(pool)
        return _finish(out, dev)

    prompts = np.asarray(prompts, np.int32)
    B, S = prompts.shape
    if fill:
        S = fill            # decode step i runs at position S + i - 1
    n_seq = kv_cache.seq_ways(mi, seq_axes)
    s_max = max_len or -(-(S + gen) // (2 * n_seq)) * (2 * n_seq)
    b_loc = kv_cache.batch_local(B, mi, seq_axes)
    batched = b_loc < B     # the batch split over the batch axes
    d = mi.batch_axes.index if batched else 0
    batch_t = {"tokens": torch.from_numpy(
        prompts[d * b_loc:(d + 1) * b_loc].copy()).to(dev)}
    s_enc = 0
    if cfg.encoder_layers:
        # this rank's rows and tp slice of the encoder's input (the
        # reference's batch spec P(batch, tp, None)), as long as the prompt
        s_enc, t = S, mi.tp_axes.index
        fr = make_frames(B, S, cfg.d_model, seed)
        batch_t["frames"] = torch.from_numpy(np.ascontiguousarray(
            fr[d * b_loc:(d + 1) * b_loc,
               t * S // tp:(t + 1) * S // tp])).to(dev)

    def gather(tok):
        """This rank's tokens -> all B (uncompressed, outside the
        ledger)."""
        if batched:
            tok = comms.raw_all_gather(tok, mi.batch_axes, 0)
        return tok.cpu().numpy().astype(np.int32)

    if mode == "disagg":
        srv = DisaggServer(model, scheme=pol, kv_codec=kv_codec,
                           ring_bidir=ring_bidir, ring_chunks=ring_chunks)
        batch_t = srv.stage_batch(batch_t)
    else:
        srv = Server(model, scheme=pol, seq_axes=seq_axes,
                     ring_bidir=ring_bidir, ring_chunks=ring_chunks)
    _sync(dev)
    t0 = start = time.perf_counter()
    if fill:
        # no prefill: the caches filled to ``fill`` (or the reference's),
        # decoded from the prompts' first tokens
        structs, cspecs = srv.cache_structs(B, s_max, s_enc)
        if caches_from:
            with open(caches_from, "rb") as f:
                caches = [None if c is None else
                          {k: torch.as_tensor(np.asarray(v)).to(
                              device=dev, dtype=st[k].dtype)
                           for k, v in c.items()} for c, st in
                          zip(kv_cache.local_cache(pickle.load(f), cspecs,
                                                   mi), structs)]
        else:
            caches = kv_cache.fill_caches(structs, cspecs, fill, seed, mi,
                                          dev, s_enc)
        tok = batch_t["tokens"][:, 0]
    else:
        with comms.record_traffic() as ev:
            tok, caches = srv.prefill(params, batch_t)
        out["ledger"]["prefill"] = _ledger(ev)
    _sync(dev)
    out["prefill_s"] = time.perf_counter() - t0
    if keep_state and not fill:
        out["prefill"] = _numpy(caches)
    if not fill:
        caches = srv.pad_prefill_caches(caches, B, s_max, s_enc)
    del batch_t
    out["digests"]["prefill"] = {p: _digest(t) for p, t in _leaves(caches)}
    if mode == "disagg":
        _sync(dev)
        t0 = time.perf_counter()
        with comms.record_traffic() as ev:
            caches = srv.handoff(caches)
        _sync(dev)
        out["handoff_s"] = time.perf_counter() - t0
        out["ledger"]["handoff"] = _ledger(ev)
        out["digests"]["handoff"] = {p: _digest(t)
                                     for p, t in _leaves(caches)}
        if keep_state:
            out["handoff"] = _numpy(caches)
        tok = srv.first_tokens(tok)
    toks = [gather(tok)]
    out["decode_s"] = []
    for i in range(1, gen):
        tok_in = torch.from_numpy(
            toks[-1][d * b_loc:(d + 1) * b_loc, None].astype(np.int64)
        ).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        with comms.record_traffic() as ev:
            tok, caches = srv.decode(params, tok_in, caches, S + i - 1)
        _sync(dev)
        out["decode_s"].append(time.perf_counter() - t0)
        if i == 1:
            out["ledger"]["decode"] = _ledger(ev)
        toks.append(gather(tok))
    out["wall_s"] = time.perf_counter() - start
    out["s_max"] = s_max
    out["tokens"] = np.stack(toks, 1).tolist()
    out["steps"] = gen - 1
    out["meaningful"] = mode != "disagg" or out["pool"] == DECODE
    out["digests"]["final"] = {p: _digest(t) for p, t in _leaves(caches)}
    if keep_state:
        out["final"] = _numpy(caches)
    return _finish(out, dev)


def _init_in_turn(model, seed: int, rank: int, world: int, dev) -> dict:
    """``model.init(seed)``; where the world has more ranks than cards,
    so that ranks share a card, they draw in turn, each giving its cached
    memory back before the next.  The init draws every leaf's GLOBAL f32
    tensor before keeping its shard, and the largest may not fit once per
    rank: an expert leaf of kimi-k2's first MoE layer is 21.0 GiB in f32,
    and four ranks on one H100 80GB drawing at once ran out of memory (a
    rank asked 21.00 GiB with 4.58 GiB free and 70.20 GiB in use).  The
    weights are the same either way."""
    if dev.type != "cuda" or world == 1 or \
            torch.cuda.device_count() >= world:
        return model.init(seed)
    import torch.distributed as dist
    params = None
    for r in range(world):
        if r == rank:
            params = model.init(seed)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def _finish(out: dict, dev) -> dict:
    from repro_torch.core import comms
    from repro_torch.kernels import bq

    out["launches"] = dict(bq.LAUNCHES)
    out["launch_shapes"] = bq.launch_shapes()
    out["launch_levels"] = {f"{k}/{lvl}": v for (k, lvl), v
                            in sorted(bq.LAUNCH_LEVELS.items())}
    out["staging_bytes"] = comms.STAGING["bytes"]
    out["staging_s"] = comms.STAGING["seconds"]
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def rank_kwargs(args, **extra) -> dict:
    """:func:`serve_rank`'s keywords for the parsed flags (plus
    ``extra``); raises before anything starts when the flags ask for a
    card and there is none."""
    from repro_torch.launch.mesh import parse_nodes_spec
    from repro_torch.models.params import resolve_device

    dev = resolve_device(args.device)
    return dict(arch=args.arch, reduced=args.reduced, mode=args.mode,
                dp=args.dp, tp=args.tp,
                tp_nodes=parse_nodes_spec(args.tp_nodes, args.tp,
                                          flag="--tp-nodes"),
                batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                max_len=args.max_len, scheme=args.scheme,
                codec_for=list(args.codec_for),
                no_compress_below=args.no_compress_below,
                kv_codec=args.kv_codec, block_tokens=args.block_tokens,
                slots=args.slots, kv_blocks=args.kv_blocks,
                ring_bidir=args.ring_bidir, ring_chunks=args.ring_chunks,
                seq_axes=tuple(args.seq_axes.split(",")), fill=args.fill,
                seed=args.seed, device=dev.type, **extra)


def run(args, **extra) -> list:
    """Serve the parsed flags as a world of spawned processes; -> the
    per-rank records."""
    from repro_torch.kernels import bq
    from repro_torch.launch.train import spawn_world

    kwargs = rank_kwargs(args, **extra)      # no card: raise before spawning
    world = world_size(args.mode, args.dp, args.tp)
    if kwargs["device"] == "cuda":
        bq.build()                           # once, before the ranks start
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    if world == 1:
        return [serve_rank(**kwargs)]
    return spawn_world("repro_torch.launch.serve:serve_rank", world, kwargs)


def _report(res: list, args) -> None:
    from repro_torch.analysis import roofline

    r = next(x for x in res if x.get("meaningful", True))
    toks = r["tokens"]
    prompts = make_prompts(_vocab(args), args.batch, args.prompt_len,
                           args.seed)
    mb = {k: {dl: round(v / 1e6, 6) for dl, v in led["priced"].items() if v}
          for k, led in r["ledger"].items()}
    if args.mode == "paged":
        n_gen = sum(len(t) for t in toks)
        secs = sum(r["decode_s"])
        print(f"paged[{args.kv_codec}] {args.arch} on {r['device']}: "
              f"{args.batch} requests ({args.prompt_len}+{args.gen} tokens) "
              f"on {max(args.slots, args.dp)} slots, {len(res)} ranks: "
              f"{r['steps']} steps, {secs:.2f}s "
              f"({n_gen / max(secs, 1e-9):.1f} gen tok/s)")
        for b in range(min(args.batch, 4)):
            print(f"  req[{b}]: {prompts[b, -4:].tolist()} -> {toks[b]}")
        print(f"priced wire per rank, MB per dim/level: {mb}")
        return
    B, S = args.batch, args.prompt_len
    first = [t[0] for t in toks]
    dt = sum(r["decode_s"])
    if args.mode == "disagg":
        p0 = next(x for x in res if x["pool"] == 0)
        print(f"prefill pool [{B}x{S}] {p0['prefill_s']:.2f}s -> first "
              f"tokens {first[:4]}")
        led = r["ledger"]["handoff"]
        byt = sum(roofline.event_bytes(e, train=False)["fwd"]
                  for e in led["events"])
        print(f"kv handoff [{args.kv_codec}]: {len(led['events'])} "
              f"transfers, {byt / 1e6:.4f} MB/device wire")
        print(f"decode pool: {args.gen - 1} steps in {dt:.2f}s "
              f"({(args.gen - 1) * B / max(dt, 1e-9):.1f} tok/s) on "
              f"{r['device']}, {len(res)} ranks")
    else:
        if args.fill:
            print(f"cache [{B}x{r['s_max']}] filled to {args.fill} in "
                  f"{r['prefill_s']:.2f}s (no prefill), its sequence over "
                  f"{args.seq_axes.replace(',', ' x ')}")
        else:
            print(f"prefill[{B}x{S}] {r['prefill_s']:.2f}s -> first tokens "
                  f"{first[:4]}")
        print(f"decoded {args.gen - 1} steps in {dt:.2f}s "
              f"({(args.gen - 1) * B / max(dt, 1e-9):.1f} tok/s) on "
              f"{r['device']}, {len(res)} ranks")
    for b in range(min(B, 4)):
        print(f"  seq[{b}]: {prompts[b, -4:].tolist()} -> {toks[b]}")
    print(f"priced wire per rank, MB per dim/level: {mb}")


def _vocab(args) -> int:
    from repro_torch.launch.train import model_config
    return model_config(args.arch, args.reduced).vocab_size


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    bad = unported(args)
    if bad:
        ap.error("; ".join(bad))
    try:
        check(args)
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    _report(run(args), args)


if __name__ == "__main__":
    main()
