"""Render the dry-run tables from the dry-run's records (port of
``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report \\
        [--dir results/dryrun_torch] [--mesh pod16x16] [--table dryrun]

The roofline table is the reference's.  The dry-run table shows what this
package's trace measures where the reference shows XLA's compiled
figures: the FLOPs and bytes of the traced step's dispatched ops, and the
most bytes alive during it, under headers that say so.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch import configs
from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.specs import SHAPES

SHAPE_ORDER = list(SHAPES)


def load_all(d: pathlib.Path, mesh: str, scheme: str):
    out = {}
    for arch in configs.ARCH_IDS:
        for shape in SHAPE_ORDER:
            fn = d / f"{mesh}-{scheme}-{arch}-{shape}.json"
            if fn.exists():
                out[(arch, shape)] = json.loads(fn.read_text())
    return out


def _fmt_t(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def roofline_table(results) -> str:
    hdr = ("| arch | shape | compute | memory | collective | dominant | "
           "MODEL/HLO flops | MFU@roofline |\n"
           "|---|---|---|---|---|---|---|---|\n")
    rows = []
    for (arch, shape), r in sorted(results.items()):
        if r["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | — | — | — | *skipped* "
                        f"| — | — |")
            continue
        if "roofline" not in r:
            rows.append(f"| {arch} | {shape} | FAILED: {r['status']} "
                        f"| | | | | |")
            continue
        rf = r["roofline"]
        rows.append(
            f"| {arch} | {shape} | {_fmt_t(rf['compute_s'])} "
            f"| {_fmt_t(rf['memory_s'])} | {_fmt_t(rf['collective_s'])} "
            f"| **{rf['dominant']}** | {rf['useful_ratio']:.2f} "
            f"| {rf['mfu'] * 100:.1f}% |")
    return hdr + "\n".join(rows)


def dryrun_table(results) -> str:
    hdr = ("| arch | shape | status | params | traced GFLOPs/dev "
           "| traced op GB/dev | peak live GB/dev | coll. MB/dev "
           "| trace |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for (arch, shape), r in sorted(results.items()):
        if r["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | skipped ({r['why'][:40]}…) "
                        f"| | | | | | |")
            continue
        if "traced" not in r:
            rows.append(f"| {arch} | {shape} | {r['status']} | | | | | | |")
            continue
        tr, mem = r["traced"], r["memory"]
        rows.append(
            f"| {arch} | {shape} | {r['status']} | {r['params'] / 1e9:.1f}B "
            f"| {tr['flops'] / 1e9:.1f} | {tr['bytes'] / 1e9:.2f} "
            f"| {mem['peak_live_bytes'] / 1e9:.2f} "
            f"| {r['collective']['total_bytes'] / 1e6:.1f} "
            f"| {r.get('trace_s', 0):.1f}s |")
    return hdr + "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.report")
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--scheme", default="zhybrid_16_8")
    ap.add_argument("--table", choices=("roofline", "dryrun"),
                    default="roofline")
    args = ap.parse_args(argv)
    results = load_all(pathlib.Path(args.dir), args.mesh, args.scheme)
    if args.table == "roofline":
        print(roofline_table(results))
    else:
        print(dryrun_table(results))


if __name__ == "__main__":
    main()
