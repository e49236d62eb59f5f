#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phase 1 builds the bq kernels from src/repro_torch/kernels/csrc with nvcc.
Phase 2 holds each kernel against its plain PyTorch version on the card,
bit for bit, at rates 4/8/16/24 on random, all-zero, extreme-magnitude and
denormal rows, at the shapes the main path gives them and at 65536 rows,
and times both (device time by CUDA-graph replay, and per eager call).
Phase 3 drives the main path: gemma3-1b at full published width (bf16,
random weights from a seed) served by continuous batching over a paged KV
pool quantized at rest (bq8), 8 requests of 560 prompt + 24 generated
tokens on 8 slots, which crosses the 512-token sliding window.  It runs
once through the kernels and once through their plain versions, requires
identical tokens and pool planes, requires the kernels' launch counts to
be non-zero in the first run and zero in the second, and checks the first
layer's quantized pool against a dense-pool run within the bq error bound.

Every line with a number carries the card's name and power limit.  Before
the last line come the kernel JSON (the kernels the main path launches:
device time at the main path's shapes, byte bound, launch counts) and the
card line; the last line is the result JSON.
Any failure exits non-zero; without a card, or outside a checkout, it
fails before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BITS = (4, 8, 16, 24)
MAIN_BITS = 8                 # the main path stores the pool as bq8

# main path: gemma3-1b, 8 slots, 16-token blocks, 560 + 24 tokens
SLOTS, BLOCK_TOKENS, PROMPT, GEN, SEED = 8, 16, 560, 24, 0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def eager_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Per-call time on the stream when called from Python one call after
    another (host wrapper included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times between two events, so no host work falls in
    the timed region."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * iters)


def timings(torch, kernel, plain):
    """(kernel device ms, plain device ms, kernel eager ms, plain eager ms)."""
    return (graph_ms(torch, kernel), graph_ms(torch, plain),
            eager_ms(torch, kernel), eager_ms(torch, plain))


def row_bytes(torch, bits: int) -> int:
    """Stored bytes of one 128-value row: q_hi (+ q_lo at rate 24) + scale."""
    from repro_torch.core import codecs
    return sum(w * torch.empty((), dtype=d).element_size() for w, d in
               codecs.get(f"bq{bits}").storage_row_layout().values())


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def special_rows(torch):
    """Rows that stress the scale and rounding arithmetic, most telling
    first (all-zero, extreme magnitudes, denormals)."""
    g = torch.Generator().manual_seed(7)
    u = lambda: torch.rand(128, generator=g) * 2 - 1  # noqa: E731
    rows = [
        torch.zeros(128),
        u() * 3.4e38,
        torch.cat([torch.tensor([3.0e38]), u()[1:] * 1e-3]),
        u() * 1e-40,
        torch.cat([torch.tensor([1.0]), u()[1:] * 1e-40]),
        torch.full((128,), -2.5),
        torch.cat([torch.tensor([1.0]), torch.zeros(126), torch.tensor([-0.0])]),
        torch.full((128,), 1e-45),
        (torch.arange(128) - 63.5) * 0.5,
        u() * 1e20,
        u() * 1e-20,
        torch.cat([torch.tensor([1e-30]), u()[1:] * 1e-38]),
        torch.cat([torch.full((64,), 7.0), torch.full((64,), -7.0)]),
        u(),
        u() * 65504.0,
        torch.cat([torch.tensor([2e-31]), u()[1:] * 2e-31]),
    ]
    return torch.stack(rows).to(torch.float32)


def test_rows(torch, m: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, 128, generator=g) * 10
    sp = special_rows(torch)
    k = min(m, sp.shape[0])
    x[:k] = sp[:k]
    return x.cuda()


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def drive_main_path(torch, model, params, card) -> dict:
    """Serve SLOTS random prompts through the kernels, through their plain
    versions and with a dense pool; check the three runs against each
    other; return the kernel run's launch counts."""
    from repro_torch.kernels import bq, ref
    from repro_torch.launch import serve
    from repro_torch.serve import paged_kv

    cfg = model.cfg
    prompt_len, gen, slots, bt = PROMPT, GEN, SLOTS, BLOCK_TOKENS
    mb = paged_kv.blocks_needed(prompt_len + gen, bt)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(slots)]
    # warm cuBLAS and the allocator on a short request
    serve.serve_requests(model, params, [prompts[0][:8]], 2, kv_codec="bq8",
                         block_tokens=bt, slots=slots)

    def run(codec, backend):
        torch.cuda.reset_peak_memory_stats()
        bq.reset_launches()
        fin, pool, steps, secs = serve.serve_requests(
            model, params, prompts, gen, kv_codec=codec, block_tokens=bt,
            slots=slots, backend=backend)
        launches = dict(bq.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n_gen = sum(len(v) for v in fin.values())
        print(f"  paged[{codec}] {'plain' if backend else 'kernels'}: "
              f"{len(prompts)} requests ({prompt_len}+{gen}) on {slots} "
              f"slots: {steps} steps, {secs * 1e3 / steps:.2f} ms/step, "
              f"{n_gen / secs:.1f} generated tok/s, peak "
              f"{peak / 2**30:.2f} GiB, launches {launches} [{card}]")
        if sorted(fin) != list(range(len(prompts))) or any(
                len(v) != gen or min(v) < 0 or max(v) >= cfg.vocab_size
                for v in fin.values()):
            fail(f"paged[{codec}]: malformed output tokens")
        return fin, pool, steps, secs, launches

    k_fin, k_pool, k_steps, k_secs, k_launch = run("bq8", None)
    p_fin, p_pool, _, p_secs, p_launch = run("bq8", "torch")
    d_fin, d_pool, _, d_secs, _ = run("none", None)

    for name in ("bq_encode", "bq_gather_decode"):
        if k_launch[name] <= 0:
            fail(f"main path never launched {name}")
    if any(p_launch.values()):
        fail(f"plain run launched kernels: {p_launch}")
    if k_fin != p_fin:
        fail("tokens differ between the kernel run and the plain run")
    for gi, (a, b) in enumerate(zip(k_pool, p_pool)):
        for nm in ("k", "v"):
            for pl in ("q_hi", "q_lo", "scale"):
                if a[nm][pl] is None:
                    continue
                if not torch.equal(a[nm][pl], b[nm][pl]):
                    fail(f"pool group {gi} {nm}.{pl} differs between the "
                         f"kernel run and the plain run")
                if pl == "scale" and not bool(
                        (a[nm][pl].isfinite() & (a[nm][pl] >= 0)).all()):
                    fail(f"pool group {gi} {nm}.scale not finite")
    # layer 0 K/V depend only on the prompt tokens and positions, so the
    # bq8 pool must decode to the dense pool within the bq8 error bound
    # (request i owns blocks [i*mb, (i+1)*mb); its prompt fills the first
    # prompt_len // bt of them)
    pb = prompt_len // bt
    sel = torch.cat([torch.arange(i * mb, i * mb + pb) for i in range(slots)])
    worst = 0.0
    for nm in ("k", "v"):
        planes = {pl: None if v is None else v[0][sel]
                  for pl, v in k_pool[0][nm].items()}
        dense = d_pool[0][nm][0][sel].float().flatten(2)   # [S, bt, KV*hd]
        f = dense.shape[-1]
        dec = ref.bq_decode_ref(planes["q_hi"], planes["q_lo"],
                                planes["scale"], MAIN_BITS).flatten(2)[..., :f]
        lim = ref.max_abs_error_bound(planes["scale"], MAIN_BITS)
        lim = lim.repeat_interleave(ref.BLOCK, dim=-1)[..., :f]
        excess = ((dec - dense).abs() - lim).max().item()
        worst = max(worst, (dec - dense).abs().max().item())
        if excess > 0:
            fail(f"layer 0 {nm}: bq8 pool off the dense pool beyond the "
                 f"error bound by {excess}")
    same = sum(k_fin[i] == d_fin[i] for i in k_fin)
    print(f"phase 3: kernel run == plain run (tokens and every pool plane); "
          f"layer-0 bq8 pool within the error bound of the dense pool (max "
          f"abs diff {worst:.3g}); {same}/{len(k_fin)} requests emit the "
          f"same tokens under bq8 and none; dense run "
          f"{d_secs * 1e3 / k_steps:.2f} ms/step, plain bq8 run "
          f"{p_secs * 1e3 / k_steps:.2f} ms/step [{card}]")
    return k_launch


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repo (src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import bq, ops
    from repro_torch.models.model import Model
    from repro_torch.serve import paged_kv

    card = card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} [{card}]")

    # ---------------------------------------------------------- phase 1
    t0 = time.perf_counter()
    bq._load()
    print(f"phase 1: built {bq.build_info['path']} in "
          f"{bq.build_info['seconds']:.2f}s "
          f"(load {time.perf_counter() - t0:.2f}s) [{card}]")
    for line in bq.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---------------------------------------------------------- phase 2
    nb = SLOTS * paged_kv.blocks_needed(PROMPT + GEN, BLOCK_TOKENS)
    cfg = configs.get("gemma3-1b")
    r = paged_kv.token_rows(cfg.n_kv_heads, cfg.head_dim_)
    rpb = BLOCK_TOKENS * r                       # rows per pool block
    mb = nb // SLOTS
    err = {"bq_encode": 0.0, "bq_decode": 0.0, "bq_gather_decode": 0.0}
    for bits in BITS:
        for m in (8, 16, 65536):
            x = test_rows(torch, m, seed=bits * 7 + m)
            w = ops.bq_encode_blocks(x, bits)
            wp = ops.bq_encode_blocks(x, bits, backend="torch")
            for k in ("q_hi", "q_lo", "scale"):
                if wp[k] is None:
                    continue
                if not torch.equal(w[k], wp[k]):
                    fail(f"bq_encode rate {bits} M={m}: {k} differs")
                err["bq_encode"] = max(err["bq_encode"], max_diff(w[k], wp[k]))
            d = ops.bq_decode_blocks(w, bits)
            dp = ops.bq_decode_blocks(w, bits, backend="torch")
            if not torch.equal(d, dp):
                fail(f"bq_decode rate {bits} M={m} differs")
            err["bq_decode"] = max(err["bq_decode"], max_diff(d, dp))
        # gather-decode at the main path's pool and table shapes
        x = test_rows(torch, nb * rpb, seed=bits)
        w = ops.bq_encode_blocks(x, bits, backend="torch")
        pool = {k: None if v is None else v.reshape(nb, BLOCK_TOKENS, r, -1)
                for k, v in w.items()}
        g = torch.Generator().manual_seed(bits)
        idx = torch.randint(0, nb, (SLOTS, mb), generator=g,
                            dtype=torch.int32).cuda()
        got = ops.bq_gather_decode(pool, idx, bits)
        want = ops.bq_gather_decode(pool, idx, bits, backend="torch")
        if not torch.equal(got, want):
            fail(f"bq_gather_decode rate {bits} differs")
        err["bq_gather_decode"] = max(err["bq_gather_decode"],
                                      max_diff(got, want))
        # ids outside the pool decode to NaN and read nothing
        bad = idx.clone()
        bad[0, 0], bad[1, 1] = nb, -1
        got = ops.bq_gather_decode(pool, bad, bits)
        torch.cuda.synchronize()
        if not (got[0, 0].isnan().all() and got[1, 1].isnan().all()):
            fail(f"bq_gather_decode rate {bits}: out-of-range id not NaN")
        ok = torch.ones(bad.shape, dtype=torch.bool, device=dev)
        ok[0, 0] = ok[1, 1] = False
        if not torch.equal(got[ok], want[ok]):
            fail(f"bq_gather_decode rate {bits}: in-range rows disturbed")
    torch.cuda.synchronize()
    print(f"phase 2: kernels == plain versions bit for bit at rates "
          f"{list(BITS)} (encode/decode M=8,16,65536; gather-decode "
          f"{SLOTS}x{mb} table over {nb} blocks x {BLOCK_TOKENS} tokens x "
          f"{r} rows) [{card}]")

    def time_encode(m, bits):
        x = test_rows(torch, m, seed=1)
        return timings(torch, lambda: ops.bq_encode_blocks(x, bits),
                       lambda: ops.bq_encode_blocks(x, bits, backend="torch")
                       ), bound(m * 128 * 4 + m * row_bytes(torch, bits),
                                m * 128 * 6)

    def time_decode(m, bits):
        w = ops.bq_encode_blocks(test_rows(torch, m, seed=2), bits)
        return timings(torch, lambda: ops.bq_decode_blocks(w, bits),
                       lambda: ops.bq_decode_blocks(w, bits, backend="torch")
                       ), bound(m * row_bytes(torch, bits) + m * 128 * 4,
                                m * 128)

    def time_gather(bits, n_blocks):
        w = ops.bq_encode_blocks(test_rows(torch, n_blocks * rpb, seed=3),
                                 bits)
        pool = {k: None if v is None else
                v.reshape(n_blocks, BLOCK_TOKENS, r, -1)
                for k, v in w.items()}
        idx = torch.arange(n_blocks, dtype=torch.int32,
                           device=dev).reshape(SLOTS, -1)
        rows = idx.numel() * rpb
        uniq = int(torch.unique(idx).numel()) * rpb
        return timings(
            torch, lambda: ops.bq_gather_decode(pool, idx, bits),
            lambda: ops.bq_gather_decode(pool, idx, bits, backend="torch")
        ), bound(idx.numel() * 4 + uniq * row_bytes(torch, bits)
                 + rows * 128 * 4, rows * 128)

    def show(name, bits, shape, t, b):
        (ms, pms, ems, epms), (bms, by) = t, b
        print(f"  {name} rate {bits} {shape}: device {ms * 1e3:.2f} us "
              f"kernel ({bms / ms * 100:.1f}% of bound) vs {pms * 1e3:.2f} "
              f"us plain; per eager call {ems * 1e3:.2f} us kernel vs "
              f"{epms * 1e3:.2f} us plain; bound {bms * 1e3:.3f} us ({by}) "
              f"[{card}]")

    # main-path shapes at rate 8 (the kernel line) and 65536 rows at
    # every rate
    enc_m = -(-SLOTS * r // bq.TILE_M) * bq.TILE_M   # new K (or V) rows/step
    main_shape = {
        "bq_encode": (f"M={enc_m}", *time_encode(enc_m, MAIN_BITS)),
        "bq_decode": (f"M={nb * rpb}", *time_decode(nb * rpb, MAIN_BITS)),
        "bq_gather_decode": (f"idx {SLOTS}x{mb}, {rpb} rows/block",
                             *time_gather(MAIN_BITS, nb)),
    }
    for name, (shape, t, b) in main_shape.items():
        show(name, MAIN_BITS, shape, t, b)
    for bits in BITS:
        show("bq_encode", bits, "65536 rows", *time_encode(65536, bits))
        show("bq_decode", bits, "65536 rows", *time_decode(65536, bits))
        show("bq_gather_decode", bits, "65536 rows",
             *time_gather(bits, 65536 // rpb))

    # ---------------------------------------------------------- phase 3
    model = Model(cfg)                                    # on the card
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    print(f"phase 3: gemma3-1b {model.n_params() / 1e9:.3f}B params bf16, "
          f"init {time.perf_counter() - t0:.2f}s [{card}]")
    k_launch = drive_main_path(torch, model, params, card)

    kernels = []
    # the kernels the main path launches (bq_decode, the same device
    # routine without a table, is checked and timed in phase 2 only)
    for name, line in (("bq_encode", 173), ("bq_gather_decode", 302)):
        _, (ms, pms, _, _), (bms, by) = main_shape[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bq.cu",
            "replaces": f"src/repro/kernels/bq.py:{line}",
            "launches": k_launch[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
