"""Serving entry point: continuous batching over a paged KV pool.

    # on the card: gemma3-1b at full width, pool quantized at rest (bq8)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --mode paged --kv-codec bq8 --slots 8 --batch 8 --prompt-len 560 \
        --gen 24

    # on the CPU, reduced width
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --reduced --mode paged --kv-codec bq8 --device cpu

The flags are those of ``repro.launch.serve``.  This package runs the
paged mode on one device; the flags of the batched and disaggregated
modes, of sharded meshes and of the compression policy on collectives are
accepted and refused as not yet ported, never ignored.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.model import Model
from repro_torch.serve import paged_kv
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.serve_step import PagedServer

# flags whose non-default value would change a collective or select an
# unported mode: (attribute, default)
_UNPORTED = (("mode", "paged"), ("dp", 1), ("tp", 1), ("max_len", 0),
             ("scheme", "baseline"), ("no_compress_below", 0),
             ("codec_for", []), ("ring_bidir", False), ("ring_chunks", 1),
             ("tp_nodes", "1"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=("batched", "paged", "disagg"),
                    default="paged",
                    help="paged: continuous batching over a paged KV pool "
                         "(batched and disagg are not yet ported)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4,
                    help="total submitted requests")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--scheme", default="baseline")
    ap.add_argument("--kv-codec", default="none",
                    help="at-rest storage codec of the KV pool "
                         "(none | bq4/bq8/bq16/bq24)")
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="KV block size in tokens")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool blocks (0 = sized to fit all slots at max "
                         "context)")
    ap.add_argument("--no-compress-below", type=int, default=0,
                    metavar="BYTES")
    ap.add_argument("--codec-for", action="append", default=[],
                    metavar="[DIM@]NAME_GLOB=CODEC")
    ap.add_argument("--ring-bidir", action="store_true")
    ap.add_argument("--ring-chunks", type=int, default=1)
    ap.add_argument("--tp-nodes", default="1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def unported(args) -> list[str]:
    """Messages for every flag set to something this package cannot run."""
    out = []
    for attr, default in _UNPORTED:
        val = getattr(args, attr)
        if val != default:
            flag = "--" + attr.replace("_", "-")
            out.append(f"{flag} {val!r} is not yet ported (this package "
                       f"runs --mode paged on one device with no "
                       f"collectives)")
    return out


def serve_requests(model, params, prompts, gen: int, kv_codec: str = "none",
                   block_tokens: int = 16, slots: int = 4, kv_blocks: int = 0,
                   backend=None):
    """Serve every prompt (a list of token lists) for ``gen`` tokens by
    continuous batching over a paged pool on ``model``'s device.

    Returns (finished {request index: tokens}, pool, steps, seconds)."""
    max_blocks = paged_kv.blocks_needed(max(map(len, prompts)) + gen,
                                        block_tokens)
    n_blocks = kv_blocks or slots * max_blocks
    srv = PagedServer(model, kv_codec=kv_codec, block_tokens=block_tokens,
                      backend=backend)
    step, structs = srv.decode_step(slots, n_blocks, max_blocks)
    pool = paged_kv.zero_pool(structs, model.device)
    sched = Scheduler(slots, n_blocks, block_tokens, max_blocks)
    for rid, prompt in enumerate(prompts):
        sched.submit(rid, prompt, gen)
    t0 = time.perf_counter()
    finished, pool, steps = sched.run(step, params, pool)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return finished, pool, steps, time.perf_counter() - t0


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    bad = unported(args)
    if bad:
        ap.error("; ".join(bad))
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    finished, _, steps, secs = serve_requests(
        model, params, [p.tolist() for p in prompts], args.gen,
        kv_codec=args.kv_codec, block_tokens=args.block_tokens,
        slots=args.slots, kv_blocks=args.kv_blocks)
    total = sum(len(v) for v in finished.values())
    print(f"paged[{args.kv_codec}] {args.arch} on {args.device or 'cuda'}: "
          f"{args.batch} requests ({args.prompt_len}+{args.gen} tokens) on "
          f"{args.slots} slots: {steps} steps, {secs:.2f}s "
          f"({total / max(secs, 1e-9):.1f} gen tok/s)")
    for b in range(min(args.batch, 4)):
        print(f"  req[{b}]: {prompts[b, -4:].tolist()} -> {finished[b]}")


if __name__ == "__main__":
    main()
