"""The port's training step on node-factored meshes (``--nodes``,
``--tp-nodes``, ``--pp-nodes``) against the reference's, on ``gemma3-1b
--reduced`` with the reference's weights (``from_jax_params``).

Contract asserted here, with the tolerances and their reasons (those of
``test_torch_train.py`` and ``test_torch_pipeline.py``: the frameworks and
gloo sum in other orders, and a bq ring can turn an ulp into a
quantization step):
  * ``--dp 4 --nodes 2`` (node 2 x data 2) under ``hier_zpp_8_16`` (the
    two-level DP sync: bq16 reduce-scatter inside the node, bq8
    all-reduce across, bq16 param gather inside) and under
    ``hier_zpp_plr8_16`` (plr8 on the inter-node level, from the
    reference's initial codec state; its final factor within 2e-4 of its
    largest entry), ``--dp 2 --tp 4 --tp-nodes 2`` under
    ``hier_tpp_8_16`` (every TP collective and the class-C fold two-level)
    and ``--pp 4 --pp-nodes 2 --layers 4 --microbatches 4`` under
    ``hier_tpp_8_16`` (handoffs inside and across nodes, the stage fold
    two-level), 3 steps: losses within rtol 1e-5 and grad norms within
    rtol 1e-4 of the reference's, the first step's ledger priced per
    ``dim/level`` equal byte for byte, and the link bytes (fast/slow) too;
  * flat against factored under ``baseline``, port only: ``--dp 4`` and
    ``--dp 4 --nodes 2`` give identical losses and grad norms, bit for
    bit, and ``--dp 2 --tp 4`` and ``--dp 2 --tp 4 --tp-nodes 2``
    identical losses, as ``tp_hier_check.py`` asserts for the reference,
    and grad norms within rtol 1e-6 (the class-C fold's two-level sum adds
    the four tp partials in another order than gloo's flat all-reduce;
    measured 7.8e-8 at the third step);
  * the ``--dp 4 --nodes 2`` run's checkpoint at step 2 has the
    reference's manifests and leaf shapes (the ZeRO-1 state sharded over
    the inner data axis, one replica of the nodes written), and a resume
    onto the flat ``--dp 4`` mesh prints the ``WARNING:`` lines the
    reference's launcher prints restoring it there (the optimizer state
    falls back; ``hier_zpp_8_16`` carries no codec state).

The reference runs in four subprocesses with 8 XLA host devices each,
side by side (this file re-invokes itself with ``--reference``); the
port's cases run afterwards in two spawned worlds, of 4 and 8 ranks,
side by side.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEQ, GB, STEPS = 32, 4, 3
CASES = {
    "nodes_zpp": dict(dp=4, nodes=2, scheme="hier_zpp_8_16"),
    "nodes_plr": dict(dp=4, nodes=2, scheme="hier_zpp_plr8_16"),
    "tp_nodes": dict(dp=2, tp=4, tp_nodes=2, scheme="hier_tpp_8_16"),
    "pp_nodes": dict(pp=4, pp_nodes=2, layers=4, microbatches=4,
                     scheme="hier_tpp_8_16"),
}
# port-only runs from the port's own seed: flat against factored
OWN = {
    "flat_dp": dict(dp=4, scheme="baseline"),
    "nodes_dp": dict(dp=4, nodes=2, scheme="baseline"),
    "flat_tp": dict(dp=2, tp=4, scheme="baseline"),
    "nodes_tp": dict(dp=2, tp=4, tp_nodes=2, scheme="baseline"),
}
LOSS_RTOL, GNORM_RTOL, STATE_TOL = 1e-5, 1e-4, 2e-4
CKPT_STEPS = 2


def _c(c: dict) -> dict:
    return dict(dict(dp=1, tp=1, pp=1, nodes=1, tp_nodes=1, pp_nodes=1,
                     layers=0, microbatches=1), **c)


def _world(c) -> int:
    return c["dp"] * c["tp"] * c["pp"]


def _reference(out_path: str, ckpt: str, cases: list) -> None:
    import jax
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import batch_specs, make_trainer

    out = {}
    for case in cases:
        c = _c(CASES[case])
        cfg = configs.get("gemma3-1b").reduced()
        if c["layers"]:
            cfg = cfg.replace(n_layers=c["layers"], groups=())
        mesh = make_mesh(c["dp"], c["tp"], nodes=c["nodes"],
                         tp_nodes=c["tp_nodes"], pp=c["pp"],
                         pp_nodes=c["pp_nodes"])
        mi = MeshInfo.from_mesh(mesh)
        trainer = make_trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                               opt_cfg=AdamConfig(lr=1e-3),
                               n_micro=c["microbatches"])
        params, ostate, cstate = trainer.init_all(jax.random.key(0))
        tree = jax.tree.map(lambda pv: np.asarray(pv.v), params,
                            is_leaf=lambda x: isinstance(x, Pv))
        cstate0 = jax.tree.map(np.asarray, cstate)
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=GB,
                                          seed=0))
        bspecs = batch_specs(cfg, mi)
        losses, gnorms = [], []
        for step in range(STEPS):
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in data.batch(step).items()}
            with comms.record_traffic() as events:
                params, ostate, cstate, m = trainer.step(params, ostate,
                                                         cstate, batch)
            if step == 0:
                summary = roofline.ledger_summary(events, train=True)
                links = roofline.link_bytes(events, train=True)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if case == "nodes_zpp" and step + 1 == CKPT_STEPS:
                # what the launcher's save at CKPT_STEPS writes
                for sub, t in (("", params), ("opt", ostate),
                               ("codec", cstate)):
                    checkpoint.save(os.path.join(ckpt, sub), CKPT_STEPS, t,
                                    blocking=True)
        out[case] = dict(tree=tree, losses=losses, gnorms=gnorms,
                         per_dim_level=summary["per_dim_level"],
                         links=links, cstate0=cstate0,
                         cstate=jax.tree.map(np.asarray, cstate))
        jax.clear_caches()
    if "nodes_zpp" in cases:
        out["ckpt"] = dict(layout=_layout(ckpt),
                           resume_log=_reference_resume(ckpt))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _reference_resume(ckpt: str) -> list:
    """The lines the reference's launcher prints when it restores the
    optimizer and codec state of ``ckpt`` at step CKPT_STEPS onto the flat
    dp 4 mesh."""
    import contextlib
    import io

    from repro import configs
    from repro.launch import train as launch
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import make_trainer

    mesh = make_mesh(4, 1)
    model = Model(configs.get("gemma3-1b").reduced(),
                  MeshInfo.from_mesh(mesh))
    trainer = make_trainer(model, mesh, scheme="hier_zpp_8_16",
                           opt_cfg=AdamConfig(lr=1e-3))
    params, man = checkpoint.restore(
        ckpt, model.structs(),
        shardings=checkpoint.resharded_specs(model.structs(), mesh))
    assert man["step"] == CKPT_STEPS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch._restore_opt(trainer, params, os.path.join(ckpt, "opt"),
                            CKPT_STEPS, mesh, checkpoint)
        launch._restore_codec(trainer, os.path.join(ckpt, "codec"),
                              CKPT_STEPS, mesh, checkpoint)
    return buf.getvalue().splitlines()


def _layout(ckpt) -> dict:
    """Each sub-checkpoint's step-2 manifest and its leaves' shapes and
    dtypes."""
    out = {}
    for sub in ("", "opt", "codec"):
        d = Path(ckpt, sub, f"step_{CKPT_STEPS}")
        man = json.loads((d / "manifest.json").read_text())
        leaves = [np.load(d / "leaves" / f"{i}.npy", mmap_mode="r")
                  for i in range(man["n_leaves"])]
        out[sub] = dict(manifest=man, leaves=[(tuple(a.shape), a.dtype.str)
                                              for a in leaves])
    return out


# the reference's cases, one subprocess each, all four side by side: each
# compiles its init and step, 13-19 s a case, which in one process would
# take the file past its minute
REF_PARTS = tuple((case,) for case in CASES)


@pytest.fixture(scope="module")
def ref_procs(tmp_path_factory):
    """The reference's subprocesses, started."""
    base = tmp_path_factory.mktemp("ref")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    procs = []
    for i, part in enumerate(REF_PARTS):
        out = base / f"hier_train{i}.pkl"
        procs.append((out, subprocess.Popen(
            [sys.executable, __file__, "--reference", str(out),
             str(base / "ckpt"), ",".join(part)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    yield base, procs
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _spawn(todo: dict) -> dict:
    """``todo``'s runs in a world of each size they need, the worlds side
    by side."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.train import spawn_world

    worlds = {k: _world(v) for k, v in todo.items()}
    groups = {w: {k: v for k, v in todo.items() if worlds[k] == w}
              for w in set(worlds.values())}
    with ThreadPoolExecutor(len(groups)) as pool:
        runs = {w: pool.submit(spawn_world, f"{__name__}:run_cases", w,
                               dict(cases=cases), 900)
                for w, cases in groups.items()}
    return {case: [r[case] for r in runs[w].result()]
            for w, cases in groups.items() for case in cases}


@pytest.fixture(scope="module")
def reference(ref_procs):
    base, procs = ref_procs
    ref = {}
    for out, p in procs:
        err = p.communicate(timeout=900)[1]
        assert p.returncode == 0, err[-4000:]
        with open(out, "rb") as f:
            ref.update(pickle.load(f))
    for case in CASES:
        for key in ("tree", "cstate0"):
            path = base / f"{key}_{case}.pkl"
            with open(path, "wb") as f:
                pickle.dump(ref[case].pop(key), f)
            ref[case][key] = str(path)
    return ref


def _kwargs(c: dict, ref: dict | None = None, **extra) -> dict:
    """``train_rank``'s keywords for case ``c``, from the reference's
    weights and initial codec state when ``ref`` is given."""
    c = _c(c)
    return {**dict(arch="gemma3-1b", reduced=True, layers=c["layers"],
                   dp=c["dp"], tp=c["tp"], pp=c["pp"], nodes=c["nodes"],
                   tp_nodes=c["tp_nodes"], pp_nodes=c["pp_nodes"],
                   microbatches=c["microbatches"], scheme=c["scheme"],
                   steps=STEPS, seq=SEQ, global_batch=GB, lr=1e-3, seed=0,
                   device="cpu", init_from=ref["tree"] if ref else "",
                   codec_state_from=ref["cstate0"] if ref else ""),
            **extra}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port") / "ckpt")


@pytest.fixture(scope="module")
def port(reference, ckpt_dir):
    """The runs held against the reference, and the port's own; ``nodes_zpp``
    checkpoints at step CKPT_STEPS (and, as its last, at STEPS), and
    ``ckpt_resume`` resumes the latest onto the flat dp 4 mesh, 1 step.
    (Run beside the reference's subprocesses, the port's own runs slow
    them more than they save.)"""
    todo = {case: _kwargs(c, reference[case]) for case, c in CASES.items()}
    todo["nodes_zpp"].update(ckpt_dir=ckpt_dir, ckpt_every=CKPT_STEPS)
    todo["ckpt_resume"] = _kwargs(dict(dp=4, scheme="hier_zpp_8_16"),
                                  steps=1, ckpt_dir=ckpt_dir, resume=True)
    todo.update({case: _kwargs(c) for case, c in OWN.items()})
    return _spawn(todo)


def run_cases(*, rank: int, world: int, cases: dict) -> dict:
    """Every case of ``cases`` in turn in this world (each builds its own
    mesh over the world's group), each with its final codec state."""
    from test_torch_train import train_rank_keeping_codec_state
    return {case: train_rank_keeping_codec_state(rank=rank, world=world,
                                                 **kw)
            for case, kw in cases.items()}


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_factored_training_matches_reference(case, reference, port):
    ref = reference[case]
    for r in port[case]:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=case)
        np.testing.assert_allclose(r["grad_norms"], ref["gnorms"],
                                   rtol=GNORM_RTOL, err_msg=case)
        assert r["priced_per_dim_level"] == ref["per_dim_level"], case
        assert r["link_bytes"] == ref["links"], case
        assert all(np.isfinite(r["losses"]))
    # every level of the factored axis carried traffic
    levels = {k.split("/")[1] for k, v in ref["per_dim_level"].items() if v}
    assert {"inner", "outer"} <= levels, ref["per_dim_level"]


def test_plr_outer_level_state_matches_reference(reference, port):
    """plr8 on the DP sync's inter-node level: its factor, stacked over the
    world in rank order, within STATE_TOL of the largest entry."""
    want = reference["nodes_plr"]["cstate"]
    assert sorted(want) == ["dp_outer@zero1_grad"]
    q = want["dp_outer@zero1_grad"]["q"]
    n = q.shape[0] // 4
    for r in port["nodes_plr"]:
        got = r["codec_state_arrays"]["dp_outer@zero1_grad"]["q"]
        rank = r["rank"]
        np.testing.assert_allclose(got, q[rank * n:(rank + 1) * n], rtol=0,
                                   atol=STATE_TOL * np.abs(q).max())


@pytest.mark.parametrize("flat,factored", [("flat_dp", "nodes_dp"),
                                           ("flat_tp", "nodes_tp")])
def test_flat_and_factored_baseline_agree(flat, factored, port):
    for a, b in zip(port[flat], port[factored]):
        assert a["losses"] == b["losses"]
        if flat == "flat_dp":
            assert a["grad_norms"] == b["grad_norms"]
        else:
            # the class-C fold's sum runs in another order over the pair
            np.testing.assert_allclose(a["grad_norms"], b["grad_norms"],
                                       rtol=1e-6)
    levels = port[factored][0]["priced_per_dim_level"]
    assert any(k.endswith("/outer") for k in levels), levels


def test_checkpoint_crosses_as_reference(reference, port, ckpt_dir):
    want = reference["ckpt"]
    assert _layout(ckpt_dir) == want["layout"]
    ref_lines = want["resume_log"]
    assert any(ln.startswith("WARNING: optimizer state not portable")
               for ln in ref_lines), ref_lines
    for r in port["ckpt_resume"]:
        assert r["start"] == STEPS
        assert [ln for ln in r["restore_log"]
                if ln.startswith("WARNING:")] == ref_lines
        assert np.isfinite(r["losses"]).all()


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
