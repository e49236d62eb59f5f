"""Dry-run: trace one rank's step of every (architecture x shape x mesh)
cell on meta tensors (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--scheme zhybrid_16_8]

The reference lowers each cell on 256 or 512 placeholder XLA devices
without running it.  This package has no lowering: it traces the step of
ONE rank (rank 0, or ``--rank``) on ``device="meta"``, shapes alone and no
allocation, against the stand-in of the named mesh
(:func:`~repro_torch.launch.mesh.make_production_mesh`: every axis with
its size, index and ranks, no process group) and the stand-in transport
(:class:`~repro_torch.core.comms.shape_only`: the collectives return
results of the right shape and move nothing).  The parameters are empty
meta tensors of the rank's shards (:func:`~repro_torch.models.params.
meta_params`), and every kernel wrapper takes its plain version on them,
which only propagates shapes.  The comms ledger records exactly what a
real run of that rank records, and prices as the reference's does.

Each cell's record (``<out-dir>/<mesh>-<scheme>-<arch>-<shape>.json``)
holds the reference's keys where they mean the same thing (``arch``,
``shape``, ``mesh``, ``scheme``, ``bidir``, ``overrides``, ``status``,
``chips``, ``params``, ``active_params``, ``tokens``, ``analytic``: the
cost model, ``collective``: the priced ledger, ``n_events`` and
``roofline``), and under keys of its own what has another source:
``traced`` (the FLOPs of the traced step's ops by
``torch.utils.flop_counter``'s formulas, and the bytes of every
dispatched op's operands and results, views left out; the codec's plain
versions only propagate shapes on meta, so its arithmetic is not in
them), ``memory`` (``argument_bytes``: the rank's parameters,
optimizer state, codec state, inputs and caches; ``peak_live_bytes``: the
most bytes alive in storages during the traced step, the arguments
included) and ``collectives`` (calls per op, ``roofline.
collective_counts``), with ``peaks``, the rates the roofline priced at (by
default the H100's), and ``rank``.  XLA's ``cost_analysis``,
``memory_analysis``, ``hlo_collectives`` and ``compile_s`` have no
counterpart and are absent.  The status is ``traced``, ``trace_failed``
or ``skipped`` (the reference's skips).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.analysis import costmodel
from repro_torch.analysis import roofline as rl
from repro_torch.core import comms
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as speclib
from repro_torch.models.model import Model
from repro_torch.models.params import MeshInfo, count_params, meta_params

DEFAULT_OUT = "results/dryrun_torch"

#: The rates the roofline prices at by default: the H100 SXM's published
#: dense bf16 peak, HBM3 rate and NVLink rate per direction.
H100_PEAKS = dict(peak_flops=rl.H100_PEAK_FLOPS,
                  hbm_bytes_per_s=rl.H100_HBM_BW,
                  link_bytes_per_s=rl.H100_NVLINK_BW)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally(TorchDispatchMode):
    """Every dispatched op's FLOPs (``torch.utils.flop_counter``'s formula
    for the op, where it has one: the matmuls, convolutions and attention)
    and its operand and result bytes (view ops left out: they move
    nothing), and the bytes alive in storages: a storage counts from the
    op that made it until it is freed (autograd's saved tensors included),
    so ``peak`` is the most the traced step held at once."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = {}

    def _dead(self, nb: int) -> None:
        self.live -= nb

    def track(self, t) -> None:
        """Count ``t``'s storage as alive until it is freed."""
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        ref = self._seen.get(id(st))
        if ref is not None and ref() is not None:
            return
        nb = st.nbytes()
        self._seen[id(st)] = weakref.ref(st)
        weakref.finalize(st, self._dead, nb)
        self.live += nb
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self._flops.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _inputs(spec: dict, mi: MeshInfo) -> dict:
    """This rank's shards of the cell's inputs, empty meta tensors."""
    return {k: torch.empty(speclib.local_shape(s, spec["specs"][k], mi),
                           dtype=s.dtype, device="meta")
            for k, s in spec["inputs"].items()}


def trace_cell(cfg, mi: MeshInfo, scheme: str, shape_name: str,
               bidir: bool = False, spec: dict | None = None) -> dict:
    """Trace one rank's step of the cell on meta tensors; -> ``dict(
    events, tokens, train, spec, flops, bytes, argument_bytes,
    peak_live_bytes, seconds)``.  ``spec`` replaces the cell's
    :func:`~repro_torch.launch.specs.input_specs` (a training step at
    another size).  Raises where the step cannot be traced."""
    from repro_torch.serve import kv_cache
    from repro_torch.serve.serve_step import Server
    from repro_torch.train.train_step import make_trainer

    spec = spec or speclib.input_specs(cfg, shape_name, mi)
    meta = spec["meta"]
    model = Model(cfg, mi, device="meta")
    params = meta_params(model.plan, mi)
    tally = _Tally()
    t0 = time.perf_counter()
    with comms.shape_only(), comms.record_traffic() as events:
        if spec["kind"] == "train":
            trainer = make_trainer(model, scheme=scheme, ring_bidir=bidir)
            args = (params, trainer.opt.init(params),
                    trainer.init_codec_state(), _inputs(spec, mi))
            run = trainer.step
            tokens, train = meta["seq"] * meta["batch"], True
        elif spec["kind"] == "prefill":
            srv = Server(model, scheme=scheme, ring_bidir=bidir)
            args = (params, _inputs(spec, mi))
            run = srv.prefill
            tokens, train = meta["seq"] * meta["batch"], False
        else:
            srv = Server(model, scheme=scheme, seq_axes=meta["seq_axes"],
                         ring_bidir=bidir)
            B, S = meta["batch"], meta["seq"]
            structs, _ = srv.cache_structs(B, S, meta["s_enc"])
            caches = kv_cache.zero_caches(structs, "meta")
            b = kv_cache.batch_local(B, mi, meta["seq_axes"])
            token = torch.empty((b, 1), dtype=torch.int32, device="meta")
            args = (params, token, caches)

            def run(params, token, caches):
                # one new token at the cache's last position
                return srv.decode(params, token, caches, S - 1)
            tokens, train = B, False
        arg_bytes = _tree_bytes(args)
        for t in tree_leaves(args):
            tally.track(t)
        with tally:
            run(*args)
    return dict(events=events, tokens=tokens, train=train, spec=spec,
                flops=float(tally.flops), bytes=float(tally.bytes),
                argument_bytes=arg_bytes, peak_live_bytes=tally.peak,
                seconds=time.perf_counter() - t0)


def _round(v, nd):
    return round(v, nd) if isinstance(v, float) else v


def run_cell(arch: str, shape_name: str, multi_pod: bool, scheme: str,
             bidir: bool = False, cfg_overrides: dict | None = None,
             mesh_override=None, tag: str = "", rank: int = 0,
             peaks: dict | None = None) -> dict:
    """One cell's record (see the module docstring).  ``mesh_override``
    is the reference's ``(dp, tp[, pod])``; ``peaks`` the roofline's rates
    (:data:`H100_PEAKS` by default)."""
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    ok, why = speclib.cell_supported(cfg, shape_name)
    mesh_name = tag or ("pod2x16x16" if multi_pod else "pod16x16")
    base = dict(arch=arch, shape=shape_name, mesh=mesh_name, scheme=scheme,
                bidir=bidir, overrides=cfg_overrides or {})
    if not ok:
        return {**base, "status": "skipped", "why": why}

    if mesh_override is not None:
        dp, tp, *rest = mesh_override
        mi = meshlib.make_mesh(dp, tp, pod=rest[0] if rest else 1,
                               rank=rank)
    else:
        mi = meshlib.make_production_mesh(multi_pod=multi_pod, rank=rank)
    n_chips = mi.world_size
    try:
        tr = trace_cell(cfg, mi, scheme, shape_name, bidir=bidir)
    except Exception as e:  # noqa: BLE001 - a failed trace is the record
        return {**base, "status": "trace_failed", "error": repr(e),
                "trace": traceback.format_exc()[-2000:]}

    events = tr["events"]
    led = rl.ledger_summary(events, train=tr["train"])
    n_params = count_params(Model(cfg, mi, device="meta").plan)
    n_active = rl.active_params(cfg, n_params)
    mflops = rl.model_flops(cfg, n_active, tr["tokens"])
    if not tr["train"]:
        mflops /= 3.0  # decode/prefill: 2ND (fwd only); 6ND counts fwd+bwd

    sp = tr["spec"]
    ana = costmodel.cost_for(
        cfg, mi, sp["kind"] if sp["kind"] != "decode_long" else "decode",
        sp["meta"]["batch"], sp["meta"]["seq"], n_active, n_params,
        seq_axes=sp["meta"].get("seq_axes", ("model",)))
    peaks = dict(peaks or H100_PEAKS)
    r = rl.roofline({"flops": ana.flops, "bytes accessed": ana.hbm_bytes},
                    led["total_bytes"], n_chips, mflops, **peaks)
    return {**base, "status": "traced", "chips": n_chips, "rank": rank,
            "trace_s": round(tr["seconds"], 3),
            "params": n_params, "active_params": n_active,
            "tokens": tr["tokens"],
            "analytic": {"flops": ana.flops, "hbm_bytes": ana.hbm_bytes},
            "collective": {k: (_round(v, 1) if not isinstance(v, dict) else
                               {kk: round(vv, 1) for kk, vv in v.items()})
                           for k, v in led.items()},
            "n_events": len(events),
            "roofline": {k: _round(v, 6) for k, v in r.to_dict().items()},
            "peaks": peaks,
            "traced": {"flops": tr["flops"], "bytes": tr["bytes"]},
            "memory": {"argument_bytes": tr["argument_bytes"],
                       "peak_live_bytes": tr["peak_live_bytes"]},
            "collectives": rl.collective_counts(events)}


def all_cells():
    for arch in configs.ARCH_IDS:
        for shape in speclib.SHAPES:
            yield arch, shape


def parse_set(values) -> dict:
    """``--set k=v`` overrides, typed as the reference's launcher types
    them (True/False, digits as int, else the string)."""
    overrides = {}
    for kv in values:
        k, v = kv.split("=", 1)
        overrides[k] = {"True": True, "False": False}.get(v) \
            if v in ("True", "False") else (int(v) if v.isdigit() else v)
    return overrides


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(speclib.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--scheme", default="zhybrid_16_8")
    ap.add_argument("--bidir", action="store_true",
                    help="bidirectional compressed rings")
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override, e.g. --set moe_ws=True")
    ap.add_argument("--mesh", default="",
                    help="override mesh 'dp,tp[,pod]'")
    ap.add_argument("--tag", default="",
                    help="result-file tag (replaces the mesh name)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step is traced")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    # the reference's XLA-only flags, refused rather than ignored
    ap.add_argument("--no-compile", action="store_true",
                    help="refused: this dry-run compiles nothing")
    ap.add_argument("--refresh", action="store_true",
                    help="refused: there are no compiled fields to keep")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    for flag, on in (("--no-compile", args.no_compile),
                     ("--refresh", args.refresh)):
        if on:
            ap.error(f"{flag} means something only to XLA's lowering and "
                     f"compiling; this dry-run traces on meta tensors and "
                     f"compiles nothing")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    overrides = parse_set(args.set)
    mesh_override = tuple(int(x) for x in args.mesh.split(",")) \
        if args.mesh else None

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_name = args.tag or ("pod2x16x16" if args.multi_pod else "pod16x16")

    failures = 0
    t_all = time.perf_counter()
    for arch, shape in cells:
        fn = out_dir / f"{mesh_name}-{args.scheme}-{arch}-{shape}.json"
        res = run_cell(arch, shape, args.multi_pod, args.scheme,
                       bidir=args.bidir, cfg_overrides=overrides or None,
                       mesh_override=mesh_override, tag=args.tag,
                       rank=args.rank)
        fn.write_text(json.dumps(res, indent=1))
        status = res["status"]
        if status == "trace_failed":
            failures += 1
            print(f"[FAIL] {arch:22s} {shape:12s} {status}: "
                  f"{res.get('error', '')[:120]}")
        elif status == "skipped":
            print(f"[skip] {arch:22s} {shape:12s} {res['why'][:60]}")
        else:
            r = res["roofline"]
            print(f"[ ok ] {arch:22s} {shape:12s} "
                  f"trace={res['trace_s']:6.1f}s "
                  f"dominant={r['dominant']:10s} mfu={r['mfu']:.3f} "
                  f"peak={res['memory']['peak_live_bytes'] / 2**30:.2f}GiB")
    print(f"{len(cells)} cells in {time.perf_counter() - t_all:.1f} s")
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
