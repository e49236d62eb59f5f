"""The flat collectives alone, over one axis of a world of processes
(``collectives_rank`` is a target for ``launch.train.spawn_world``).

Each rank takes its input, runs the listed collectives under one codec
(every site resolves to it) and the ring options, and reports per case:
the outputs (arrays, or SHA-256 digests of their bytes), the ledger's
analytic and measured wire events, the kernel launches, and the seconds.
Under a carried-state codec (``ef:*``, ``plr*``) the collective runs twice
inside one ``codec_state_io`` region, so the second call sees the state
the first left (outputs ``out`` and ``out2``), and the final state's
leaves are reported as ``state.<slot>.<leaf>``.
``test_torch_comms.py`` holds these against the reference's ring on the
CPU; ``chip_smoke.py`` holds the kernels against their plain versions on
the card with it.
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import numpy as np
import torch

OPS = ("psum", "reduce_scatter", "all_gather", "reduce_scatter_flat",
       "all_gather_flat", "ring", "ppermute")


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1)
                          .view(torch.uint8).numpy()).hexdigest()


def rank_input(payload, rank: int, device) -> torch.Tensor:
    """This rank's input: row ``rank`` of an array, or a tensor file
    rotated by ``rank * 1000003`` elements (so each rank adds a different
    vector)."""
    if isinstance(payload, str):
        x = torch.load(payload, map_location="cpu").reshape(-1)
        x = torch.roll(x, rank * 1000003)
    else:
        x = torch.from_numpy(np.ascontiguousarray(payload[rank]))
    return x.to(device)


def _run_op(op, x, axis, n, axis_dim=0):
    from repro_torch.core import comms
    if op == "psum":
        return {"out": comms.psum(x, axis, "dp")}
    if op == "reduce_scatter":
        return {"out": comms.reduce_scatter(x, axis, axis_dim, "dp")}
    if op == "all_gather":
        return {"out": comms.all_gather(x, axis, axis_dim, "dp")}
    if op in ("reduce_scatter_flat", "all_gather_flat"):
        chunk = comms.reduce_scatter_flat(x.reshape(-1), axis, "dp")
        if op == "reduce_scatter_flat":
            return {"out": chunk}
        return {"out": comms.all_gather_flat(chunk, axis, x.numel(), "zero")}
    if op == "ring":
        from repro_torch.core.policy import current_plan
        codec = current_plan().codec("dp")
        xb = comms._chunked_blocks(x.reshape(-1), n)
        acc, wire = comms._ring_reduce_scatter(xb, axis, codec)
        return {"out": acc, **{f"wire.{k}": v for k, v in wire.items()
                               if v is not None}}
    if op == "ppermute":
        from repro_torch.core import policy
        codec = policy.current_plan().codec("pp", "fwd")
        perm = [(j, (j + 1) % n) for j in range(n)]
        return {"out": comms._ppermute_impl(x, axis, perm, codec)}
    raise ValueError(f"unknown op {op!r}; have {OPS}")


def _report_dtype(dtype):
    """numpy has no bf16: report it as f32 (exact)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _init_states(op: str, codec, x: torch.Tensor, n: int) -> dict:
    """Initial codec state of the sites ``op`` reads: ``dp`` (the payload;
    flat for the flat paths) and, for ``all_gather_flat``, ``zero`` (one
    padded chunk)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import BLOCK
    shapes = {"dp": tuple(x.shape) if op == "psum" else (x.numel(),)}
    if op == "all_gather_flat":
        shapes["zero"] = (ops.padded_rows(-(-x.numel() // n)) * BLOCK,)
    return {k: codec.init_state(sh, torch.float32, x.device)
            for k, sh in shapes.items()}


def _state_leaves(states: dict, prefix: str = "state") -> dict:
    out = {}
    for k, v in states.items():
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{prefix}.{k}"))
        else:
            out[f"{prefix}.{k}"] = v
    return out


def collectives_rank(*, rank: int, world: int, cases: list, payload,
                     device="cpu", backend=None, digest: bool = False):
    """Run ``cases`` (dicts of ``op``, ``codec``, ``bidir``, ``chunks``, and
    optionally ``axis_dim`` for ``all_gather`` and ``reduce_scatter`` and
    the input's ``dtype``)
    on this rank over an axis ``"x"`` of the whole world."""
    from repro_torch.core import codecs, comms, policy
    from repro_torch.kernels import bq, lowrank, ops
    from repro_torch.launch.train import rank_device

    dev = rank_device(device, rank)
    ops.set_default_backend(backend)
    axis = comms.Axis("x", world, rank, None, tuple(range(world)))
    x0 = rank_input(payload, rank, dev)
    out = []
    for case in cases:
        x = x0.to(getattr(torch, case.get("dtype", "float32")))
        plan = policy.CommPolicy(f"rc_{case['codec']}",
                                 rules=(policy.Rule(case["codec"]),)).compile()
        codec = codecs.get(case["codec"])
        states = _init_states(case["op"], codec, x, world) \
            if codec.stateful else None
        bq.reset_launches()
        lowrank.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with policy.use_plan(plan), comms.record_traffic() as events, \
                comms.ring_options(case.get("bidir", False),
                                   case.get("chunks", 1)), \
                (comms.codec_state_io(states) if codec.stateful
                 else contextlib.nullcontext()) as cio:
            res = _run_op(case["op"], x, axis, world,
                          case.get("axis_dim", 0))
            if codec.stateful:
                res["out2"] = _run_op(case["op"], x, axis, world)["out"]
        if codec.stateful:
            res.update(_state_leaves(cio.collect()))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        res = {k: _digest(v) if digest else
               v.detach().cpu().to(_report_dtype(v.dtype)).numpy()
               for k, v in res.items()}
        out.append({"case": case, "result": res, "events": list(events),
                    "wire": list(events.wire),
                    "launches": {**bq.LAUNCHES, **lowrank.LAUNCHES},
                    "seconds": secs})
    return out
