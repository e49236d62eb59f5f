"""The port's context parallelism (``--cp``, ``--cp-nodes``) against the
reference's, on ``gemma3-1b --reduced`` with the reference's weights
(``from_jax_params``), sequence 32, global batch 4, 3 steps.

Contract asserted here, with the tolerances and their reasons:
  * ring attention == full attention: the port's ``ring_attention`` in a
    world of 4 (data 2 x cp 2) on zigzag-permuted numpy q, k, v,
    positions and validity (B 2, S 32, H 4, KV 2, hd 16) against the
    reference's one-device ``full_attention``, causal, window 8,
    ``k_valid`` non-causal and causal with ``k_valid``, within rtol and
    atol 2e-5 (``tests/multidev/cp_check.py``'s: the log-sum-exp merge
    adds the blocks in another order);
  * training against the reference: (a) ``--dp 2 --cp 2`` under
    ``zhybrid_16_8`` (head attention), (b) ``--cp 2 --tp 2`` (ring
    attention after the tp K/V gather), (c) ``--cp 4 --cp-nodes 2`` under
    ``hier_tpp_8_16`` (ring hops inside and across nodes, the two-level
    cp fold) and (d) ``--pp 2 --cp 2 --layers 4 --microbatches 2``
    (1F1B): losses within rtol 1e-5 and grad norms within rtol 1e-4 (the
    train tests' tolerances; for (d) ``test_torch_pipeline.py``'s under
    ``zhybrid_16_8``, which cover its faults C.11 and C.13, since the
    reference's pipelined gradient is pp times the flat one and the port
    mirrors it), the first step's ledger priced per ``dim/level`` equal
    byte for byte with ``cp@ring_kv`` tags and no ``pp`` bytes in
    (a)-(c), the link bytes (fast/slow) equal, ``cp_ring_seconds`` equal
    at two link rates, and in (a) the codec-state sites and slots of a
    carried-state codec on ``cp@grad_seq_rep`` the reference's;
  * cp against cp-free, port only, under ``baseline``: ``--dp 2 --cp 2``
    against ``--dp 2`` and ``--cp 2 --tp 2`` against ``--tp 2`` within
    rtol 1e-4 and atol 1e-5 (``cp_check.py``'s);
  * the checkpoint: a ``--dp 2 --cp 2`` run (``zhybrid_16_8`` with
    ``ef:bq8`` on the cp fold) saved at step 2 has the reference's
    manifests and leaf shapes; the reference's launcher restores it on
    ``--dp 2 --cp 2`` (optimizer and codec state) and the port resumes it
    on the flat ``--dp 2`` mesh from exactly the saved parameters and
    optimizer state, bit for bit, printing the lines the reference's
    launcher prints there;
  * the tuned-policy artifact of a ``--dp 2 --cp 2`` mesh says ``"cp":
    2``, and replaying it on ``--dp 2`` warns as the reference's does.

The reference runs in four subprocesses with 8 XLA host devices each,
side by side (this file re-invokes itself with ``--reference``), while
the port's checkpoint run takes its 2 steps and a fifth reference
subprocess (``--reference-resume``) then restores that checkpoint; the
port's other runs follow in one world of 4 ranks and one of 2, side by
side.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEQ, GB, STEPS = 32, 4, 3
CASES = {
    "dp_cp": dict(dp=2, cp=2, scheme="zhybrid_16_8"),
    "cp_tp": dict(cp=2, tp=2, scheme="zhybrid_16_8"),
    "cp_nodes": dict(cp=4, cp_nodes=2, scheme="hier_tpp_8_16"),
    "pp_cp": dict(pp=2, cp=2, layers=4, microbatches=2,
                  scheme="zhybrid_16_8"),
}
# port-only runs from the port's own seed: cp against cp-free
OWN = {
    "own_dp_cp": dict(dp=2, cp=2, scheme="baseline"),
    "own_dp": dict(dp=2, scheme="baseline"),
    "own_cp_tp": dict(cp=2, tp=2, scheme="baseline"),
    "own_tp": dict(tp=2, scheme="baseline"),
}
LOSS_RTOL, GNORM_RTOL, ATTN_TOL = 1e-5, 1e-4, 2e-5
CP_RTOL, CP_ATOL = 1e-4, 1e-5
# two link rates to price the cp events at (any two: both packages must
# agree at the same rates)
FAST, SLOW = 450e9, 50e9
# the checkpointed run: the cp fold carries error feedback, so the
# checkpoint holds a cp codec-state slot
CKPT_STEPS = 2
CP_EF = "cp@grad_seq_rep=ef:bq8"
# ring attention: shapes and mask configurations of cp_check.py
AB, AS, AH, AKV, AHD, ACP = 2, 32, 4, 2, 16, 2
MASKS = ((True, 0, False), (True, 8, False), (False, 0, True),
         (True, 0, True))


def _c(c: dict) -> dict:
    return dict(dict(dp=1, tp=1, pp=1, cp=1, cp_nodes=1, layers=0,
                     microbatches=1), **c)


def _world(c) -> int:
    c = _c(c)
    return c["dp"] * c["cp"] * c["pp"] * c["tp"]


def _attn_inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((AB, AS, AH, AHD), np.float32)
    k = rng.standard_normal((AB, AS, AKV, AHD), np.float32)
    v = rng.standard_normal((AB, AS, AKV, AHD), np.float32)
    pos = np.broadcast_to(np.arange(AS, dtype=np.int32)[None],
                          (AB, AS)).copy()
    kval = rng.random((AB, AS)) < 0.8
    return q, k, v, pos, kval


# --------------------------------------------------------------------------
# the reference (subprocesses)
# --------------------------------------------------------------------------

def _cfg(c):
    from repro import configs
    cfg = configs.get("gemma3-1b").reduced()
    if c["layers"]:
        cfg = cfg.replace(n_layers=c["layers"], groups=())
    return cfg


def _ef_policy(policy):
    dim, _, rest = CP_EF.partition("@")
    name, _, codec = rest.partition("=")
    return policy.as_policy("zhybrid_16_8").with_rules(
        policy.Rule(codec, dim=dim, name=name), name="zhybrid_16_8+cli")


def _reference(out_path: str, ckpt: str, cases: list) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.analysis import roofline
    from repro.core import comms
    from repro.core import policy as policy_lib
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.attention import full_attention
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import (Trainer, batch_specs, make_trainer,
                                        zigzag_shard_seq)

    out = {}
    for case in cases:
        c = _c(CASES[case])
        cfg = _cfg(c)
        mesh = make_mesh(c["dp"], c["tp"], pp=c["pp"], cp=c["cp"],
                         cp_nodes=c["cp_nodes"])
        mi = MeshInfo.from_mesh(mesh)
        trainer = make_trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                               opt_cfg=AdamConfig(lr=1e-3),
                               n_micro=c["microbatches"])
        params, ostate, cstate = trainer.init_all(jax.random.key(0))
        tree = jax.tree.map(lambda pv: np.asarray(pv.v), params,
                            is_leaf=lambda x: isinstance(x, Pv))
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=GB,
                                          seed=0))
        bspecs = batch_specs(cfg, mi)
        losses, gnorms = [], []
        for step in range(STEPS):
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in zigzag_shard_seq(data.batch(step),
                                                  mi.cp).items()}
            with comms.record_traffic() as events:
                params, ostate, cstate, m = trainer.step(params, ostate,
                                                         cstate, batch)
            if step == 0:
                summary = roofline.ledger_summary(events, train=True)
                links = roofline.link_bytes(events, train=True)
                cp_s = roofline.cp_ring_seconds(events, True, ici_bw=FAST,
                                                dcn_bw=SLOW)
                tags = sorted({ev["tag"] for ev in events})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[case] = dict(tree=tree, losses=losses, gnorms=gnorms,
                         per_dim_level=summary["per_dim_level"],
                         links=links, cp_s=cp_s, tags=tags)
        if case == "dp_cp":
            # a carried-state codec on the cp fold: the step's sites and
            # slots, and the layout of a checkpoint of its state
            ef = Trainer(Model(cfg, mi), mesh, scheme=_ef_policy(policy_lib),
                         opt_cfg=AdamConfig(lr=1e-3))
            out["ef_sites"] = [(s.ledger_tag, tuple(shape))
                               for s, shape, _ in ef.codec_sites()]
            out["ef_slots"] = jax.tree.map(
                lambda l: (tuple(l.shape), str(l.dtype)),
                ef.codec_state_template())
            p, o, cs = ef.init_all(jax.random.key(0))
            for sub, t in (("", p), ("opt", o), ("codec", cs)):
                checkpoint.save(os.path.join(ckpt, sub), CKPT_STEPS, t,
                                blocking=True)
            out["layout"] = _layout(ckpt)
            q, k, v, pos, kval = map(jnp.asarray, _attn_inputs())
            out["attn"] = [np.asarray(full_attention(
                q, k, v, pos, pos, causal, window,
                k_valid=kval if k_valid else None))
                for causal, window, k_valid in MASKS]
        jax.clear_caches()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _reference_resume(out_path: str, ckpt: str) -> None:
    """The reference's launcher restores the port's ``--dp 2 --cp 2``
    checkpoint at step CKPT_STEPS on ``--dp 2 --cp 2`` and on the flat
    ``--dp 2`` mesh; the lines it prints on each, and its restored
    parameters and optimizer state."""
    import contextlib
    import io

    import jax

    from repro import configs
    from repro.core import policy as policy_lib
    from repro.launch import train as launch
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import make_trainer

    out = {}
    for name, cp in (("dp_cp", 2), ("dp", 1)):
        mesh = make_mesh(2, 1, cp=cp)
        model = Model(configs.get("gemma3-1b").reduced(),
                      MeshInfo.from_mesh(mesh))
        trainer = make_trainer(model, mesh, scheme=_ef_policy(policy_lib),
                               opt_cfg=AdamConfig(lr=1e-3))
        params, man = checkpoint.restore(
            ckpt, model.structs(), step=CKPT_STEPS,
            shardings=checkpoint.resharded_specs(model.structs(), mesh))
        assert man["step"] == CKPT_STEPS
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ostate = launch._restore_opt(trainer, params,
                                         os.path.join(ckpt, "opt"),
                                         CKPT_STEPS, mesh, checkpoint)
            cstate = launch._restore_codec(trainer,
                                           os.path.join(ckpt, "codec"),
                                           CKPT_STEPS, mesh, checkpoint)
        out[name] = dict(
            lines=buf.getvalue().splitlines(),
            params=[np.asarray(l.v) for l in jax.tree.leaves(
                params, is_leaf=lambda x: isinstance(x, Pv))],
            master=np.asarray(ostate["master"]),
            cstate=jax.tree.map(np.asarray, cstate))
        jax.clear_caches()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


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


def _ref_env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "JAX_PLATFORMS": "cpu"}


def _start(args: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, *args],
                            env=_ref_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _finish(p: subprocess.Popen, out: Path) -> dict:
    """Wait for a reference subprocess and load what it wrote."""
    err = p.communicate(timeout=900)[1]
    assert p.returncode == 0, err[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's cases, one subprocess each, started side by side;
    meanwhile the port's ``--dp 2 --cp 2`` checkpoint run (its own seed),
    then the reference's restore of that checkpoint, started too.  Yields
    ``(base, checkpoint dir, {name: (output, process)}, the run's
    results)``."""
    base = tmp_path_factory.mktemp("ref")
    ckpt = str(base / "port_ckpt")
    procs = {}
    try:
        for case in CASES:
            out = base / f"cp_{case}.pkl"
            procs[case] = (out, _start(["--reference", str(out),
                                        str(base / "ckpt"), case]))
        run = _spawn({"ckpt": (4, ("train", _kwargs(
            dict(dp=2, cp=2, scheme="zhybrid_16_8"), steps=CKPT_STEPS,
            codec_for=[CP_EF], ckpt_dir=ckpt, ckpt_every=CKPT_STEPS)))})
        out = base / "ref_resume.pkl"
        procs["ref_resume"] = (out, _start(["--reference-resume", str(out),
                                            ckpt]))
        yield base, ckpt, procs, run
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def reference(started):
    """The reference's cases; each case's weights pickled for the port."""
    base, _, procs, _ = started
    ref = {}
    for case in CASES:
        ref.update(_finish(*procs[case][::-1]))
    for case in CASES:
        path = base / f"tree_{case}.pkl"
        with open(path, "wb") as f:
            pickle.dump(ref[case].pop("tree"), f)
        ref[case]["tree"] = str(path)
    return ref


def _kwargs(c: dict, tree: str = "", **extra) -> dict:
    """``train_rank``'s keywords for case ``c``, from the reference's
    weights when ``tree`` names them."""
    c = _c(c)
    return {**dict(arch="gemma3-1b", reduced=True, layers=c["layers"],
                   dp=c["dp"], tp=c["tp"], pp=c["pp"], cp=c["cp"],
                   cp_nodes=c["cp_nodes"], microbatches=c["microbatches"],
                   scheme=c["scheme"], steps=STEPS, seq=SEQ, global_batch=GB,
                   lr=1e-3, seed=0, device="cpu", init_from=tree),
            **extra}


def _spawn(todo: dict) -> dict:
    """``todo``'s jobs (``(kind, keywords)``) in a world of each size they
    need, the worlds side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.train import spawn_world

    groups = {}
    for k, (w, job) in todo.items():
        groups.setdefault(w, {})[k] = job
    with ThreadPoolExecutor(len(groups)) as pool:
        runs = {w: pool.submit(spawn_world, f"{__name__}:run_jobs", w,
                               dict(jobs=jobs), 900)
                for w, jobs in groups.items()}
    return {k: [r[k] for r in runs[w].result()]
            for w, jobs in groups.items() for k in jobs}


@pytest.fixture(scope="module")
def ckpt_dir(started):
    return started[1]


@pytest.fixture(scope="module")
def port(reference, started):
    """Every port run: the cases from the reference's weights, the port's
    own cp and cp-free runs, ring attention, and the resume of a copy of
    the checkpoint on ``--dp 2`` (1 step), in a world of 4 and one of 2
    side by side; with the checkpoint run and the reference's restore of
    its checkpoint."""
    _, ckpt, procs, res = started
    copy = ckpt + "_resume"
    shutil.copytree(ckpt, copy, symlinks=True)
    todo = {case: (_world(c), ("train", _kwargs(c, reference[case]["tree"])))
            for case, c in CASES.items()}
    todo.update({case: (_world(c), ("train", _kwargs(c)))
                 for case, c in OWN.items()})
    todo["ring"] = (4, ("ring", {}))
    todo["resume"] = (2, ("resume", _kwargs(
        dict(dp=2, scheme="zhybrid_16_8"), steps=1, codec_for=[CP_EF],
        ckpt_dir=copy, resume=True)))
    res = {**res, **_spawn(todo)}
    res["ref_resume"] = _finish(*procs["ref_resume"][::-1])
    return res


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------

def run_jobs(*, rank: int, world: int, jobs: dict) -> dict:
    """Every job of ``jobs`` in turn in this world (each builds its own
    mesh over the world's group)."""
    run = {"train": _train, "ring": _ring, "resume": _resume}
    return {k: run[kind](rank=rank, world=world, **kw)
            for k, (kind, kw) in jobs.items()}


def _train(**kw) -> dict:
    from repro_torch.launch.train import train_rank
    return train_rank(**kw)


def _resume(**kw) -> dict:
    """``train_rank`` resuming, plus the parameters (in the plan's leaf
    order) and optimizer state its first step starts from."""
    from repro_torch.launch.train import train_rank
    from repro_torch.models.params import leaves
    from repro_torch.train.train_step import Trainer

    seen, step = {}, Trainer.step

    def first(self, params, opt_state, codec_state, batch):
        if not seen:
            seen["params"] = [t.detach().float().numpy().copy() for _, t in
                              leaves(self.model.plan, params)]
            seen["master"] = opt_state["master"].numpy().copy()
            seen["codec_slots"] = sorted(codec_state)
        return step(self, params, opt_state, codec_state, batch)
    Trainer.step = first
    try:
        res = train_rank(**kw)
    finally:
        Trainer.step = step
    return {**res, "restored": seen}


def _ring(*, rank: int, world: int) -> list:
    """The port's ring attention on this rank's rows and zigzag slice of
    the inputs, for each mask configuration, on a data 2 x cp 2 mesh."""
    import torch

    from repro_torch.core import policy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import ring_attention
    from repro_torch.train.train_step import zigzag_seq_indices

    mi = make_mesh(2, 1, cp=ACP)
    idx = zigzag_seq_indices(ACP, AS)
    d, c, s = mi.batch_axes.index, mi.coords["cp"], AS // ACP
    rows = slice(d * AB // 2, (d + 1) * AB // 2)
    q, k, v, pos, kval = (torch.from_numpy(np.ascontiguousarray(
        a[rows][:, idx][:, c * s:(c + 1) * s])) for a in _attn_inputs())
    out = []
    with policy.use_plan(policy.as_policy("baseline").compile(mi)):
        for causal, window, k_valid in MASKS:
            out.append(ring_attention(q, k, v, pos, pos, mi, causal, window,
                                      k_valid=kval if k_valid else None)
                       .numpy())
    return out


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mask", range(len(MASKS)))
def test_ring_attention_matches_full_attention(mask, reference, port):
    from repro_torch.train.train_step import zigzag_seq_indices

    want = reference["attn"][mask][:, zigzag_seq_indices(ACP, AS)]
    got = np.zeros_like(want)
    s = AS // ACP
    for rank, r in enumerate(port["ring"]):
        # rank = d * cp + c on the data 2 x cp 2 mesh
        d, c = divmod(rank, ACP)
        got[d * AB // 2:(d + 1) * AB // 2, c * s:(c + 1) * s] = r[mask]
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL,
                               err_msg=str(MASKS[mask]))


@pytest.mark.parametrize("case", list(CASES))
def test_cp_training_matches_reference(case, reference, port):
    from repro_torch.analysis import roofline

    ref = reference[case]
    for r in port[case]:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=case)
        np.testing.assert_allclose(r["grad_norms"], ref["gnorms"],
                                   rtol=GNORM_RTOL, err_msg=case)
        assert r["priced_per_dim_level"] == ref["per_dim_level"], case
        assert r["link_bytes"] == ref["links"], case
        assert roofline.cp_ring_seconds(r["events0"], True, FAST, SLOW) \
            == pytest.approx(ref["cp_s"], rel=1e-12), case
        assert sorted({ev["tag"] for ev in r["events0"]}) == ref["tags"]
        assert all(np.isfinite(r["losses"])), r["losses"]
    assert any(t.startswith("cp@ring_kv") for t in ref["tags"]), ref["tags"]
    levels = {k: v for k, v in ref["per_dim_level"].items() if v}
    assert any(k.startswith("cp/") for k in levels), levels
    if case != "pp_cp":
        assert not any(k.startswith("pp/") for k in levels), levels
    if case == "cp_nodes":
        assert {"cp/inner", "cp/outer"} <= set(levels), levels


def test_cp_fold_codec_sites_match_reference(reference):
    import torch

    from repro_torch.core import policy
    from repro_torch.launch.train import model_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import MeshInfo
    from repro_torch.train.train_step import Trainer

    tr = Trainer(Model(model_config("gemma3-1b", True), MeshInfo(dp=2, cp=2),
                       device="cpu"), scheme=_ef_policy(policy))
    assert [(s.ledger_tag, tuple(sh)) for s, sh, _ in tr.codec_sites()] \
        == reference["ef_sites"]
    assert reference["ef_sites"][0][0] == "cp_bwd@grad_seq_rep"

    def named(t):
        if isinstance(t, dict):
            return {k: named(v) for k, v in t.items()}
        shape, dtype = t
        return (tuple(shape), str(dtype).replace("torch.", ""))
    assert named(tr.codec_state_template()) == reference["ef_slots"]
    assert dict(tr.init_codec_state())["cp_bwd@grad_seq_rep"][
        "residual"].dtype == torch.float32


@pytest.mark.parametrize("cp,flat", [("own_dp_cp", "own_dp"),
                                     ("own_cp_tp", "own_tp")])
def test_cp_and_cp_free_baseline_agree(cp, flat, port):
    for a in port[cp]:
        np.testing.assert_allclose(a["losses"], port[flat][0]["losses"],
                                   rtol=CP_RTOL, atol=CP_ATOL)
    assert port[cp][0]["priced_per_dim_level"]["cp/flat"] > 0


def test_checkpoint_crosses_both_ways(reference, port, ckpt_dir):
    assert _layout(ckpt_dir) == reference["layout"]
    ref = port["ref_resume"]
    assert ref["dp_cp"]["lines"] == [f"restored optimizer state at step "
                                     f"{CKPT_STEPS}",
                                     f"restored codec state at step "
                                     f"{CKPT_STEPS}"]
    # the reference's restore reads back what the port wrote: its cp rank
    # 0's parameters and optimizer state, whole on every mesh
    d = Path(ckpt_dir, f"step_{CKPT_STEPS}", "leaves")
    saved = [np.load(d / f"{i}.npy") for i in range(len(ref["dp"]["params"]))]
    for got in (ref["dp_cp"]["params"], ref["dp"]["params"]):
        for a, b in zip(got, saved):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
    master = np.load(Path(ckpt_dir, "opt", f"step_{CKPT_STEPS}", "leaves",
                          "1.npy"))
    np.testing.assert_array_equal(ref["dp_cp"]["master"], master)
    # the port resumes it on the flat --dp 2 mesh from exactly what was
    # saved, and says what the reference's launcher says there
    for r in port["resume"]:
        assert r["start"] == CKPT_STEPS
        lines = [ln for ln in r["restore_log"]
                 if ln.startswith(("restored", "WARNING:"))]
        assert lines == ref["dp"]["lines"]
        got = r["restored"]
        for a, b in zip(got["params"], saved):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
        n = got["master"].shape[0]
        rank = r["rank"]
        np.testing.assert_array_equal(got["master"],
                                      master[rank * n:(rank + 1) * n])
        assert got["codec_slots"] == []
        assert np.isfinite(r["losses"]).all()


def test_policy_artifact_records_cp(tmp_path):
    from repro.core import policy as jpolicy
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.train import fault as jfault
    from repro.tune import controller as jcontroller
    from repro.tune import policy_artifact as jart
    from repro_torch.core import policy as tpolicy
    from repro_torch.models.params import MeshInfo as TMeshInfo
    from repro_torch.train import fault as tfault
    from repro_torch.tune import controller as tcontroller
    from repro_torch.tune import policy_artifact as tart

    st, sj = tpolicy.Site("dp", "zero1_grad"), jpolicy.Site("dp", "zero1_grad")
    t_ctrl = tcontroller.CompressionController(
        "zhybrid_16_8", {st.ledger_tag: (st, 1 << 16)})
    j_ctrl = jcontroller.CompressionController(
        "zhybrid_16_8", {sj.ledger_tag: (sj, 1 << 16)})
    art_t = tart.emit(str(tmp_path / "t.json"), t_ctrl,
                      mesh_info=TMeshInfo(dp=2, cp=2))
    art_j = jart.emit(str(tmp_path / "j.json"), j_ctrl,
                      mesh_info=JMeshInfo(dp=2, cp=2, cp_axis="cp"))
    assert art_t["topology"] == art_j["topology"]
    assert art_t["topology"]["cp"] == 2
    warn_t = tfault.tune_restart_warnings(art_t, TMeshInfo(dp=2))
    warn_j = jfault.tune_restart_warnings(art_j, JMeshInfo(dp=2))
    assert warn_t == warn_j and any("cp" in w for w in warn_t), warn_t
    assert tfault.tune_restart_warnings(art_t, TMeshInfo(dp=2, cp=2)) == []


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
elif __name__ == "__main__" and sys.argv[1:2] == ["--reference-resume"]:
    _reference_resume(sys.argv[2], sys.argv[3])
