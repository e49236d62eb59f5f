"""The reference side of the pod, long-context decode and dry-run parity
tests (``test_torch_pod.py`` and ``test_torch_dryrun.py``): the inputs
both packages share, and ONE reference subprocess that computes
everything those files compare against, started by whichever file asks
first and read by both.

The subprocess runs on 8 XLA host devices:
  * the training step on a ``(pod 2, data 2)`` mesh, 3 steps from shared
    numpy weights: reduced gemma3-1b under ``zhybrid_16_8``, and the same
    at d_model 512, d_ff 2048 with ZeRO-3 (``fsdp_params``: its MLP
    leaves cross the 1M-element threshold) under ``ef_zhybrid_16_4``;
  * the long-context decode: reduced gemma3-1b's ``Server`` with
    ``seq_axes=("data", "model")`` on a ``(data 2, model 2)`` mesh, a
    batch of one, from a cache filled with seeded values;
  * ``run_cell(compile_=False)`` on three small cells, and on three remat
    cells: the training cell with remat on, a MoE cell and a ZeRO-3 cell
    (lowered, never compiled: only the ledger and the analytic numbers
    are compared);
  * the ledger of reduced gemma3-1b's training step with remat on at dp 2
    x tp 2, the world's size, lowered without compiling.

Its result is a pickle in a directory every pytest worker of the session
shares; a lock file makes exactly one worker start it, and the others
wait for the pickle (as ``torch_encdec_reference.py`` does).
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# training: the launcher's batch at the train tests' size
SEQ, GB, STEPS = 32, 4, 3
ZERO3 = dict(fsdp_params=True, d_model=512, d_ff=2048)
TRAIN = {"pod_dp": dict(dp=2, pod=2, scheme="zhybrid_16_8", overrides={}),
         "pod_zero3": dict(dp=2, pod=2, scheme="ef_zhybrid_16_4",
                           overrides=ZERO3)}

# the long-context decode: dp 2 x tp 2, the cache filled to FILL of S_MAX
# positions (each rank holds S_MAX / 4), GEN - 1 tokens decoded
LONG_DP, LONG_TP, S_MAX, FILL, GEN = 2, 2, 64, 56, 6
LONG_SEED, LONG_SCHEME, TOK0 = 3, "zhybrid_16_8", 7

# dry-run cells, small enough to lower in seconds: gemma3-1b with the
# reduced widths, two uniform layers, remat off (the training cell also
# with it on, in REMAT_CELLS)
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
             vocab_size=512, n_layers=2, groups=(), remat=False)
CELLS = {"train_4k": (2, 2, 2), "prefill_32k": (2, 2), "decode_32k": (2, 2)}
CELL_SCHEME = "zhybrid_16_8"
# the training cell with remat on (each layer's forward collectives re-run
# in the backward pass and are priced twice), and two more: qwen3-moe at
# the reduced widths (two MoE layers of 4 experts, top 2: the ep sites)
# and gemma3-1b at ZERO3's widths (its MLP leaves shard over data: the
# zero@mlp_w* re-gathers); (arch, overrides, mesh)
REMAT_CELLS = {
    "train_4k": ("gemma3-1b", dict(SMALL, remat=True), CELLS["train_4k"]),
    "moe": ("qwen3-moe-235b-a22b",
            dict(SMALL, d_ff=0, moe_d_ff=64, n_experts=4, top_k=2,
                 remat=True), (2, 2)),
    "zero3": ("gemma3-1b", dict(SMALL, remat=True, **ZERO3), (2, 2))}
# the world's remat step: reduced gemma3-1b at dp 2 x tp 2, remat on
REMAT_DP, REMAT_TP, REMAT_SCHEME = 2, 2, "zhybrid_16_8"


def remat_overrides(cell: str, moe_groups) -> dict:
    """A remat cell's config overrides, its MoE layer groups built by the
    package's own ``moe_groups``."""
    arch, over, _ = REMAT_CELLS[cell]
    if cell == "moe":
        over = dict(over, groups=moe_groups(over["n_layers"]))
    return over

TIMEOUT = 900


def port_cfg(overrides=None):
    from repro_torch import configs
    return configs.get("gemma3-1b").reduced().replace(**(overrides or {}))


def weights(overrides=None):
    """The global weights both packages start from: each leaf of the
    config's plan drawn as the reference's init does it (normal * scale,
    zeros, ones), from a numpy seed, as a tree of numpy arrays."""
    from repro_torch.models.params import MeshInfo, map_leaves
    from repro_torch.models.transformer import model_plan

    rng = np.random.default_rng(0)

    def draw(d, _):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (rng.standard_normal(d.shape) * d.scale).astype(np.float32)
    return map_leaves(draw, model_plan(port_cfg(overrides), MeshInfo()))


def long_caches():
    """The long-context decode's GLOBAL caches, in the reference's layout
    ([L, 1, S_MAX, KV, hd] per group): seeded normals before FILL, zeros
    after."""
    cfg = port_cfg()
    rng = np.random.default_rng(LONG_SEED)
    out = []
    for g in cfg.layer_groups:
        shape = (g.n, 1, S_MAX, cfg.n_kv_heads, cfg.head_dim_)
        c = {}
        for k in ("k", "v"):
            a = np.zeros(shape, np.float32)
            a[:, :, :FILL] = rng.standard_normal(
                (g.n, 1, FILL) + shape[3:]).astype(np.float32)
            c[k] = a
        out.append(c)
    return out


# --------------------------------------------------------------------------
# the reference subprocess
# --------------------------------------------------------------------------

def _reference(args: dict) -> None:
    import jax
    jax.devices()         # the host-device count is fixed from here on
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch import dryrun
    from repro.launch.mesh import make_mesh
    from repro.models.config import moe_groups
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.serve.serve_step import Server
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import Trainer, batch_specs, make_trainer

    def is_pv(x):
        return isinstance(x, Pv)

    def load(model, mesh, tree):
        structs = model.structs()
        return jax.tree.map(
            lambda st, sh, a: Pv(jax.device_put(a.astype(st.v.dtype), sh.v),
                                 st.spec), structs,
            checkpoint.resharded_specs(structs, mesh), tree, is_leaf=is_pv)

    def pod_events(events):
        return [{k: ev[k] for k in ("op", "tag", "axis", "n", "elems",
                                    "codec_fwd", "codec_bwd")}
                for ev in events if "_pod" in ev["tag"]]

    with open(args["trees"], "rb") as f:
        trees = pickle.load(f)
    out = {"train": {}, "long": {}, "cells": {}}

    # ---- the pod training step ----
    for case, c in TRAIN.items():
        cfg = configs.get("gemma3-1b").reduced().replace(**c["overrides"])
        mesh = make_mesh(c["dp"], 1, pod=c["pod"])
        mi = MeshInfo.from_mesh(mesh)
        tr = make_trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                          opt_cfg=AdamConfig(lr=1e-3))
        params = load(tr.model, mesh, trees[case])
        ostate, cstate = tr.opt_init(params), tr.init_codec_state()
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=GB,
                                          seed=0))
        bspecs = batch_specs(cfg, mi)
        losses, gnorms, first = [], [], None
        for step in range(STEPS):
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in data.batch(step).items()}
            with comms.record_traffic() as events:
                params, ostate, cstate, m = tr.step(params, ostate, cstate,
                                                    batch)
            if first is None:
                first = list(events)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        led = roofline.ledger_summary(first, train=True)
        out["train"][case] = dict(
            losses=losses, gnorms=gnorms,
            per_dim_level=led["per_dim_level"], per_site=led["per_site"],
            pod_events=pod_events(first),
            codec_slots=sorted(tr.codec_state_template()),
            sites=[(s.dim, s.name, s.level, tuple(shape))
                   for s, shape, _ in tr.codec_sites()])
        jax.clear_caches()

    # ---- the long-context decode over (data, model) ----
    cfg = configs.get("gemma3-1b").reduced()
    mesh = make_mesh(LONG_DP, LONG_TP)
    mi = MeshInfo.from_mesh(mesh)
    model = Model(cfg, mi)
    srv = Server(model, mesh, scheme=LONG_SCHEME, seq_axes=("data", "model"))
    dec, structs, cspecs = srv.decode_step(1, S_MAX)
    with open(args["caches"], "rb") as f:
        host = pickle.load(f)
    caches = [{k: jax.device_put(jnp.asarray(v[k]).astype(st[k].dtype),
                                 NamedSharding(mesh, cs[k])) for k in v}
              for v, st, cs in zip(host, structs, cspecs)]
    params = load(model, mesh, trees["long"])
    toks, ev_d = [np.array([TOK0], np.int32)], None
    for i in range(1, GEN):
        tok_in = jax.device_put(jnp.asarray(toks[-1])[:, None],
                                NamedSharding(mesh, P(None, None)))
        with comms.record_traffic() as ev:
            t, caches = dec(params, tok_in, caches, jnp.int32(FILL + i - 1))
        ev_d = ev_d if ev_d is not None else list(ev)
        toks.append(np.asarray(t))
    out["long"] = dict(
        tokens=np.stack(toks, 1),
        final=[{k: np.asarray(v) for k, v in c.items()} for c in caches],
        specs=[{k: tuple(v) for k, v in cs.items()} for cs in cspecs],
        ledger=roofline.ledger_summary(ev_d, train=False)["per_dim_level"])
    jax.clear_caches()

    # ---- dry-run cells, lowered without compiling, remat off and on ----
    for shape, mesh_override in CELLS.items():
        out["cells"][shape] = dryrun.run_cell(
            "gemma3-1b", shape, False, CELL_SCHEME, compile_=False,
            cfg_overrides=dict(SMALL), mesh_override=mesh_override)
        jax.clear_caches()
    out["remat"] = {}
    for cell, (arch, _, mesh_override) in REMAT_CELLS.items():
        out["remat"][cell] = dryrun.run_cell(
            arch, "train_4k", False, CELL_SCHEME, compile_=False,
            cfg_overrides=remat_overrides(cell, moe_groups),
            mesh_override=mesh_override)
        jax.clear_caches()

    # ---- the world's remat step, lowered: its ledger ----
    cfg = configs.get("gemma3-1b").reduced().replace(remat=True)
    mesh = make_mesh(REMAT_DP, REMAT_TP)
    model = Model(cfg, MeshInfo.from_mesh(mesh))
    tok = jax.ShapeDtypeStruct((GB, SEQ), jnp.int32)
    with comms.record_traffic() as events:
        tr = Trainer(model, mesh, scheme=REMAT_SCHEME)
        pstructs = model.structs()
        tr.step.lower(pstructs, jax.eval_shape(tr.opt_init, pstructs),
                      tr.codec_structs(), {"tokens": tok, "labels": tok})
    led = roofline.ledger_summary(events, train=True)
    out["remat_step"] = {k: led[k] for k in ("per_dim", "per_dim_level",
                                             "per_site")}
    tmp = args["out"] + ".part"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, args["out"])


# --------------------------------------------------------------------------
# one subprocess per pytest session
# --------------------------------------------------------------------------

def _shared_dir(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def inputs(tmp_path_factory) -> dict:
    """Paths of the shared inputs (weights per case, the long cache),
    written once per session under the lock."""
    root = _shared_dir(tmp_path_factory)
    return {"trees": str(root / "pod_ref_trees.pkl"),
            "caches": str(root / "pod_ref_caches.pkl")}


def start(tmp_path_factory):
    """Start the reference subprocess unless another worker of this
    session did; returns a function that waits for its result (the
    unpickled dict) and a cleanup function."""
    root = _shared_dir(tmp_path_factory)
    out, err = root / "pod_ref.pkl", root / "pod_ref.err"
    paths = inputs(tmp_path_factory)
    proc = None
    with open(root / "pod_ref.lock", "a+") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        started = root / "pod_ref.started"
        if not started.exists():
            trees = {case: weights(c["overrides"])
                     for case, c in TRAIN.items()}
            trees["long"] = weights()
            with open(paths["trees"], "wb") as f:
                pickle.dump(trees, f)
            with open(paths["caches"], "wb") as f:
                pickle.dump(long_caches(), f)
            env = {**os.environ,
                   "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
                   "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                   "JAX_PLATFORMS": "cpu"}
            errf = open(err, "w")
            proc = subprocess.Popen(
                [sys.executable, __file__, "--reference",
                 json.dumps(dict(paths, out=str(out)))],
                env=env, stdout=subprocess.DEVNULL, stderr=errf, text=True)
            errf.close()
            started.touch()

    def wait() -> dict:
        t0 = time.time()
        failed = Path(str(out)).with_suffix(".failed")
        while not out.exists():
            if proc is not None and proc.poll() not in (None, 0):
                raise RuntimeError("reference failed:\n"
                                   + err.read_text()[-4000:])
            if proc is None and failed.exists():
                raise RuntimeError("reference failed:\n"
                                   + err.read_text()[-4000:])
            if time.time() - t0 > TIMEOUT:
                raise TimeoutError("the reference did not finish")
            time.sleep(0.2)
        with open(out, "rb") as f:
            return pickle.load(f)

    def cleanup() -> None:
        if proc is None:
            return
        if proc.poll() is None:
            try:
                proc.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return wait, cleanup


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    try:
        _reference(json.loads(sys.argv[2]))
    except BaseException:
        a = json.loads(sys.argv[2])
        Path(a["out"]).with_suffix(".failed").touch()
        raise
