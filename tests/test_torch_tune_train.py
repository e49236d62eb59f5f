"""The port's self-tuning compression on the training step (the tunable
comms sites, ``Trainer.step_tuned``, the launcher's controller loop, the
tune state in checkpoints) against the reference's, on ``gemma3-1b
--reduced`` with the reference's weights and codec state.

Contract asserted here, with the tolerances and their reasons (those of
``test_torch_hier_comms.py`` and ``test_torch_hier_train.py``: the
frameworks and gloo sum in other orders, and plr's matmuls and
orthonormalization round differently):
  * ``comms._tuned_collective`` through ``reduce_scatter_flat`` and
    ``psum`` on a world of (node 2, data 2): over the inner data axis
    (site ``dp_inner@``), the node axis (``dp_outer@``) and the data axis
    as a flat site (``dp@``), for each rung index 0-5 and each kind, from
    numpy-seeded payloads, residuals and factors: the bq rungs' outputs
    bit for bit (the reference's ring and decode oracles rounding first,
    ROADMAP C.3), ``ef:bq4``'s output and new residual bit for bit, the
    plr outputs and every new factor within ``PLR_TOL`` of the largest
    entry, the untouched union parts passed through exactly, the signal
    vectors within rtol 1e-5 (count, payload) and 1e-4 (err, spec); one
    analytic ledger event at the plan's codec with ``tunable=1``, equal to
    the reference's; and the measured wire that of the rung taken (the
    static call's under its codec, plus the two factor all-reduces of the
    full-width probe on the ``ef:bq4`` and ``plr`` rungs);
  * a tuned ``--dp 4 --nodes 2`` run from ``hier_zpp_16_16``,
    ``--tune-interval 2``, 8 steps (4 decision rounds): the decision
    histories (site, step, action, from, to) and final codecs equal the
    reference's, every err_ratio within rtol 1e-3 of the reference's (the
    margin of each to its nearest tolerance is printed), the losses within
    rtol 1e-5 up to the first live plr rung and 1e-4 after, every rank's
    history equal; ``tune_policy.json``'s ``rules`` and ``plan_hash``
    equal the reference's; a ``--policy-from`` replay compiles to the same
    ``table_hash`` and prices ``dp/outer`` below the start's;
  * a run checkpointed at step 4 (a round boundary) and resumed continues
    to the uninterrupted run's decisions and losses bit for bit;
  * the checkpoint crosses packages: the port resumes the reference's
    step-4 checkpoint (params, optimizer, codec state with its union
    slots, ``<ckpt>/tune/`` and ``controller.json``) and continues to the
    reference's decisions, and the reference reads the port's
    ``<ckpt>/tune/`` arrays and ``controller.json``;
  * a flat ``--dp 2 --tp 2`` run under ``zhybrid_16_8`` with ``--tune``:
    its single ``dp@zero1_grad`` site walks as the reference's does.

The reference runs in three subprocesses with 8 XLA host devices each,
side by side (this file re-invokes itself with ``--reference``); the
port's runs follow in one spawned world of 4 ranks, then a fourth
reference subprocess reads the port's checkpoint.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEQ, GB, STEPS, INTERVAL, CKPT_AT = 32, 4, 8, 2, 4
START = "hier_zpp_16_16"
CASES = {"hier": dict(dp=4, tp=1, nodes=2, scheme=START),
         "flat": dict(dp=2, tp=2, nodes=1, scheme="zhybrid_16_8")}
LOSS_RTOL, LOSS_RTOL_PLR, ERR_RTOL = 1e-5, 1e-4, 1e-3
# plr against the reference, relative to the largest entry (as
# test_torch_hier_comms.py)
PLR_TOL = 2e-5
# the collective cases: (combo, kind); combo names the axis and the site
# level ("inner": the data axis at dp_inner@, "outer": the node axis at
# dp_outer@, "flat": the data axis at dp@)
COMBOS = ("inner", "outer", "flat")
KINDS = ("rs", "ar")
N_RUNGS = 6
ELEMS, R = 12003, 8          # mat_shape(12003) = (96, 128)
NCOLS = 128


def _coll_inputs() -> tuple:
    """Every rank's payload and residual, and the factor (the same on
    every rank, as the step keeps it)."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4, ELEMS)) * 3.0).astype(np.float32)
    res = (rng.normal(size=(4, ELEMS)) * 0.2).astype(np.float32)
    q = rng.normal(size=(NCOLS, R)).astype(np.float32)
    return x, res, q


def _site_of(policy, combo):
    level = None if combo == "flat" else combo
    return policy.Site("dp", "zero1_grad", level=level)


# --------------------------------------------------------------------------
# the reference, in subprocesses with 8 host devices
# --------------------------------------------------------------------------

def _ref_collectives() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import comms, compat, policy

    mesh = compat.make_mesh((2, 2), ("node", "data"))
    spec = P(("node", "data"))
    plan = policy.compile_plan(START)
    x, res, q = _coll_inputs()
    out = {}
    for combo in COMBOS:
        axis = "node" if combo == "outer" else "data"
        s = _site_of(policy, combo)
        key = s.ledger_tag
        for kind in KINDS:
            def body(xl, rl, ql, sel, s=s, key=key, kind=kind, axis=axis):
                st = {key: {"residual": rl[0], "q": ql[0]}}
                sig0 = {key: jnp.zeros((12,), jnp.float32)}
                with policy.use_plan(plan), comms.vma_mode(False), \
                        comms.codec_state_io(st) as cio, \
                        comms.tune_io({key: sel}, sig0,
                                      axes=("node", "data")) as tio:
                    if kind == "rs":
                        o = comms.reduce_scatter_flat(xl[0], axis, s)
                    else:
                        o = comms.psum(xl[0], axis, s)
                    sig = tio.collect()[key]
                new = cio.collect()[key]
                return (o[None], new["residual"][None], new["q"][None],
                        sig[None])
            f = jax.jit(compat.shard_map(
                body, mesh=mesh, in_specs=(spec, spec, spec, P()),
                out_specs=(spec,) * 4, check_vma=False))
            qs = np.broadcast_to(q, (4,) + q.shape).copy()
            for sel in range(N_RUNGS):
                with comms.record_traffic() as events:
                    o, r, qn, sig = f(jnp.asarray(x), jnp.asarray(res),
                                      jnp.asarray(qs), jnp.int32(sel))
                rec = dict(out=np.asarray(o), residual=np.asarray(r),
                           q=np.asarray(qn), sig=np.asarray(sig))
                if sel == 0:            # traced once: the one event
                    rec["events"] = list(events)
                out[(combo, kind, sel)] = rec
    return out


def _ref_train(case: str, ckpt: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import Trainer, batch_specs
    from repro.tune import policy_artifact, tracker
    from repro.tune.controller import CompressionController, ControllerConfig

    c = CASES[case]
    cfg = configs.get("gemma3-1b").reduced()
    mesh = make_mesh(c["dp"], c["tp"], nodes=c["nodes"])
    mi = MeshInfo.from_mesh(mesh)
    tr = Trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                 opt_cfg=AdamConfig(lr=1e-3), tune=True)
    params, ostate, cstate = tr.init_all(jax.random.key(0))
    tree = jax.tree.map(lambda pv: np.asarray(pv.v), params,
                        is_leaf=lambda v: isinstance(v, Pv))
    cstate0 = jax.tree.map(np.asarray, cstate)
    ctrl = CompressionController(tr.policy, tr.tune_sites(), mesh_info=mi,
                                 cfg=ControllerConfig(interval=INTERVAL,
                                                      guard=0.05))
    trk = tracker.SignalTracker()
    tstate = tr.init_tune_state()
    rep = NamedSharding(mesh, P())
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=GB, seed=0))
    bspecs = batch_specs(cfg, mi)
    losses, gnorms, rounds = [], [], []
    for step in range(STEPS):
        batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                 for k, v in data.batch(step).items()}
        with comms.record_traffic() as events:
            params, ostate, cstate, tstate, m = tr.step_tuned(
                params, ostate, cstate, tstate, batch)
        if step == 0:
            per_dim_level = roofline.ledger_summary(
                events, train=True)["per_dim_level"]
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ctrl.observe_loss(step, losses[-1])
        if (step + 1) % INTERVAL == 0:
            sigs, zeroed = trk.drain(tstate["sig"])
            ctrl.decide(step, sigs)
            tstate = {"select": {k: jax.device_put(jnp.int32(v), rep)
                                 for k, v in ctrl.select_indices().items()},
                      "sig": {k: jax.device_put(jnp.asarray(z), rep)
                              for k, z in zeroed.items()}}
            rounds.append(dict(step=step, select=ctrl.select_indices(),
                               signals={k: dataclasses.asdict(v)
                                        for k, v in sigs.items()}))
        if ckpt and step + 1 == CKPT_AT:
            # what the reference's launcher saves at a step (save_all)
            for sub, t in (("", params), ("opt", ostate), ("codec", cstate),
                           ("tune", tstate)):
                checkpoint.save(os.path.join(ckpt, sub), CKPT_AT, t,
                                blocking=True)
            with open(os.path.join(ckpt, "tune", "controller.json"),
                      "w") as f:
                json.dump(ctrl.state_dict(), f)
    art = policy_artifact.emit(os.path.join(ckpt, "tune_policy.json"),
                               ctrl) if ckpt else None
    jax.clear_caches()
    return dict(tree=tree, cstate0=cstate0, losses=losses, gnorms=gnorms,
                history=list(ctrl.history), codecs=dict(ctrl.codec),
                rounds=rounds, plan_hash=ctrl.plan().table_hash(), art=art,
                per_dim_level=per_dim_level,
                sites={k: [s.dim, s.name, s.level, e]
                       for k, (s, e) in tr.tune_sites().items()})


def _reference(out_path: str, ckpt: str, part: str) -> None:
    from test_torch_comms import round_first_oracles
    round_first_oracles()
    if part == "coll":
        res = {"coll": _ref_collectives()}
    else:
        res = {part: _ref_train(part, ckpt if part == "hier" else "")}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _read_port(out_path: str, ckpt: str, sites: str) -> None:
    """The reference reading the port's step-CKPT_AT tune state and
    controller.json."""
    import jax
    import jax.numpy as jnp

    from repro.core import policy
    from repro.train import checkpoint
    from repro.tune.controller import CompressionController

    with open(sites) as f:
        sites = json.load(f)
    structs = {"select": {k: jax.ShapeDtypeStruct((), jnp.int32)
                          for k in sites},
               "sig": {k: jax.ShapeDtypeStruct((12,), jnp.float32)
                       for k in sites}}
    tstate, man = checkpoint.restore(os.path.join(ckpt, "tune"), structs,
                                     step=CKPT_AT)
    ctrl = CompressionController(
        START, {k: (policy.Site(d, n, level=lvl), e)
                for k, (d, n, lvl, e) in sites.items()})
    with open(os.path.join(ckpt, "tune", "controller.json")) as f:
        ctrl.load_state_dict(json.load(f))
    with open(out_path, "wb") as f:
        pickle.dump(dict(tstate=jax.tree.map(np.asarray, tstate),
                         step=man["step"], state=ctrl.state_dict(),
                         select=ctrl.select_indices()), f)


def _env():
    return {**os.environ,
            "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tmp_path_factory.mktemp("tune")


@pytest.fixture(scope="module")
def reference(base):
    procs = []
    for part in ("hier", "coll", "flat"):
        out = base / f"ref_{part}.pkl"
        procs.append((out, subprocess.Popen(
            [sys.executable, __file__, "--reference", str(out),
             str(base / "ref_ckpt"), part], env=_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
    ref = {}
    try:
        for out, p in procs:
            err = p.communicate(timeout=900)[1]
            assert p.returncode == 0, err[-4000:]
            with open(out, "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for case in CASES:
        for key in ("tree", "cstate0"):
            path = base / f"{key}_{case}.pkl"
            with open(path, "wb") as f:
                pickle.dump(ref[case].pop(key), f)
            ref[case][key] = str(path)
    return ref


# --------------------------------------------------------------------------
# the port, in one world of 4 ranks
# --------------------------------------------------------------------------

def _kwargs(case: str, ref=None, **extra) -> dict:
    c = CASES[case]
    return {**dict(arch="gemma3-1b", reduced=True, dp=c["dp"], tp=c["tp"],
                   nodes=c["nodes"], scheme=c["scheme"], steps=STEPS,
                   seq=SEQ, global_batch=GB, lr=1e-3, seed=0, device="cpu",
                   tune=True, tune_interval=INTERVAL,
                   init_from=ref[case]["tree"] if ref else "",
                   codec_state_from=ref[case]["cstate0"] if ref else ""),
            **extra}


@pytest.fixture(scope="module")
def port(reference, base):
    from repro_torch.launch.train import spawn_world

    runs = {
        "hier": _kwargs("hier", reference, ckpt_dir=str(base / "a"),
                        ckpt_every=100),
        # 4 steps saved at the round boundary, then resumed for 4
        "first": _kwargs("hier", reference, steps=CKPT_AT,
                         ckpt_dir=str(base / "b"), ckpt_every=CKPT_AT),
        "resumed": _kwargs("hier", steps=STEPS - CKPT_AT,
                           ckpt_dir=str(base / "b"), resume=True),
        # the reference's checkpoint, resumed by the port
        "from_ref": _kwargs("hier", steps=STEPS - CKPT_AT,
                            ckpt_dir=str(base / "ref_ckpt"), resume=True),
        # the tuned plan replayed as a static policy
        "replay": _kwargs("hier", reference, steps=1, tune=False,
                          policy_from=str(base / "a" / "tune_policy.json")),
        "flat": _kwargs("flat", reference),
    }
    return spawn_world(f"{__name__}:run_world", 4,
                       dict(runs=runs, inputs=_coll_inputs()), 900)


@pytest.fixture(scope="module")
def ref_reads_port(port, base):
    sites = base / "sites.json"
    sites.write_text(json.dumps(port[0]["hier"]["tune"]["sites"]))
    out = base / "ref_read.pkl"
    proc = subprocess.run([sys.executable, __file__, "--read-port", str(out),
                           str(base / "b"), str(sites)], env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def run_world(*, rank: int, world: int, runs: dict, inputs) -> dict:
    """The collective cases, then each training run in turn, in this
    world."""
    from repro_torch.launch.train import train_rank

    out = {"coll": _port_collectives(rank, inputs)}
    for name, kw in runs.items():
        out[name] = train_rank(rank=rank, world=world, **kw)
    return out


def _port_collectives(rank: int, inputs) -> dict:
    import torch

    from repro_torch.core import comms, policy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tune import ladder

    torch.set_num_threads(1)
    mi = make_mesh(4, 1, 1, nodes=2)
    axes = {"inner": mi.dp_axes, "outer": mi.node_axes, "flat": mi.dp_axes}
    plan = policy.compile_plan(START)
    x, res, q = inputs
    out = {}
    for combo in COMBOS:
        axis, s = axes[combo], _site_of(policy, combo)
        key = s.ledger_tag
        for kind in KINDS:
            for sel in range(N_RUNGS):
                xt = torch.from_numpy(x[rank].copy())
                st = {key: {"residual": torch.from_numpy(res[rank].copy()),
                            "q": torch.from_numpy(q.copy())}}
                with policy.use_plan(plan), \
                        comms.codec_state_io(st) as cio, \
                        comms.tune_io({key: sel}, {key: torch.zeros(12)},
                                      axis=mi.all_axes) as tio, \
                        comms.record_traffic() as events:
                    if kind == "rs":
                        o = comms.reduce_scatter_flat(xt, axis, s,
                                                      donate=True)
                    else:
                        o = comms.psum(xt, axis, s)
                new = cio.collect()[key]
                # the static call of the rung's transport codec: its wire
                rung = ladder.RUNGS[sel]
                transport = rung.split(":")[-1]
                static = []
                if not rung.startswith("plr"):
                    rule = policy.CommPolicy("s", rules=(
                        policy.Rule(transport, dim="dp"),)).compile()
                    xs = torch.from_numpy(x[rank].copy())
                    with policy.use_plan(rule), \
                            comms.record_traffic() as ev2:
                        if kind == "rs":
                            comms.reduce_scatter_flat(xs, axis, s)
                        else:
                            comms.psum(xs, axis, s)
                    static = list(ev2.wire)
                out[(combo, kind, sel)] = dict(
                    out=o.numpy(), residual=new["residual"].numpy(),
                    q=new["q"].numpy(), sig=tio.collect()[key].numpy(),
                    events=list(events), wire=list(events.wire),
                    static_wire=static)
    return out


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def _coll_ids():
    return [(c, k, s) for c in COMBOS for k in KINDS for s in range(N_RUNGS)]


@pytest.mark.parametrize("combo,kind,sel", _coll_ids(),
                         ids=[f"{c}-{k}-rung{s}" for c, k, s in _coll_ids()])
def test_tuned_collective_matches_reference(combo, kind, sel, reference,
                                            port):
    from repro_torch.tune import ladder

    ref = reference["coll"]
    want = ref[(combo, kind, sel)]
    events = ref[(combo, kind, 0)]["events"]
    x, res, q = _coll_inputs()
    rung = ladder.RUNGS[sel]
    for rank, r in enumerate(port):
        got = r["coll"][(combo, kind, sel)]
        tag = f"{combo} {kind} {rung} rank {rank}"
        if rung.startswith("plr"):
            w = want["out"][rank]
            np.testing.assert_allclose(got["out"], w, rtol=0,
                                       atol=PLR_TOL * np.abs(w).max(),
                                       err_msg=tag)
        else:
            np.testing.assert_array_equal(got["out"], want["out"][rank],
                                          err_msg=tag)
        np.testing.assert_array_equal(got["residual"], want["residual"][rank],
                                      err_msg=tag)
        if rung.startswith("bq"):
            np.testing.assert_array_equal(got["q"], q, err_msg=tag)
            np.testing.assert_array_equal(got["residual"], res[rank])
        else:
            wq = want["q"][rank]
            np.testing.assert_allclose(got["q"], wq, rtol=0,
                                       atol=PLR_TOL * np.abs(wq).max(),
                                       err_msg=tag)
        if rung != "ef:bq4":
            np.testing.assert_array_equal(got["residual"], res[rank])
        sig, wsig = got["sig"], want["sig"][rank]
        np.testing.assert_allclose(sig[:2], wsig[:2], rtol=1e-5, err_msg=tag)
        np.testing.assert_allclose(sig[2:], wsig[2:], rtol=1e-4, atol=0,
                                   err_msg=tag)
        assert sig[3] == (0.0 if rung.startswith("bq") else 1.0)
        # one analytic event, at the plan's codec, as the reference's
        assert got["events"] == events, tag
        assert len(events) == 1 and events[0]["tunable"] == 1
        # the measured wire: the rung taken (and the probe's factors)
        factors = [w for w in got["wire"] if w["codec"] == "none"]
        rest = [w for w in got["wire"] if w["codec"] != "none"]
        assert rest == got["static_wire"], tag
        if rung.startswith("bq"):
            assert not factors, tag
        else:
            assert [w["payload_bytes"] for w in factors] == \
                [2 * 96 * R * 4, 2 * NCOLS * R * 4], tag


def _rounds_of(history) -> list:
    return [(h["site"], h["step"], h["action"], h["from_codec"],
             h["to_codec"]) for h in history]


def _first_plr_step(res) -> int:
    """The first step that ran a plr rung (STEPS when none did)."""
    for i, sel in enumerate(res["tune"]["select_per_step"]):
        if any(v >= 3 for v in sel.values()):
            return i
    return STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_tuned_run_matches_reference(case, reference, port):
    ref = reference[case]
    ranks = [r[case] for r in port]
    t0 = ranks[0]["tune"]
    assert _rounds_of(t0["history"]) == _rounds_of(ref["history"])
    assert t0["codecs"] == ref["codecs"]
    assert [rd["select"] for rd in t0["rounds"]] == \
        [rd["select"] for rd in ref["rounds"]]
    assert any(h["to_codec"] != h["from_codec"] for h in t0["history"])
    margins = []
    for h, w in zip(t0["history"], ref["history"]):
        if w["err_ratio"] < 0:
            assert h["err_ratio"] == w["err_ratio"]
            continue
        np.testing.assert_allclose(h["err_ratio"], w["err_ratio"],
                                   rtol=ERR_RTOL)
        margins.append(min(abs(h["err_ratio"] - 0.15),
                           abs(h["err_ratio"] - 0.60)))
    print(f"{case}: err_ratio margins to the nearest tolerance "
          f"{[round(m, 4) for m in margins]}")
    k = _first_plr_step(ranks[0])
    for r in ranks:
        assert r["tune"]["history"] == t0["history"]       # every rank
        assert r["tune"]["select_per_step"] == t0["select_per_step"]
        np.testing.assert_allclose(r["losses"][:k], ref["losses"][:k],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"][k:], ref["losses"][k:],
                                   rtol=LOSS_RTOL_PLR)
    if case == "hier":
        # the rungs swapped on the measured wire: the inter-node DP sync's
        # bytes fell from bq16's
        wire = t0["wire_per_step"]
        assert wire[-1]["dp/outer"] < wire[0]["dp/outer"], wire


def test_policy_artifact_replays(reference, port, base):
    ref = reference["hier"]
    art = json.loads((base / "a" / "tune_policy.json").read_text())
    assert art["rules"] == ref["art"]["rules"]
    assert art["plan_hash"] == ref["art"]["plan_hash"] == ref["plan_hash"]
    assert _rounds_of(art["history"]) == _rounds_of(ref["art"]["history"])
    for r in port:
        assert r["hier"]["tune"]["plan_hash"] == art["plan_hash"]
        assert r["replay"]["plan_hash"] == art["plan_hash"]
        assert r["replay"]["restore_log"][-1].startswith(
            "applied tuned policy")
        assert not [ln for ln in r["replay"]["restore_log"]
                    if ln.startswith("WARNING:")]
    start = port[0]["hier"]["priced_per_dim_level"]["dp/outer"]
    assert start == ref["per_dim_level"]["dp/outer"]
    assert port[0]["replay"]["priced_per_dim_level"]["dp/outer"] < start


def test_resume_at_round_boundary_continues_bit_for_bit(port):
    for r in port:
        full, first, resumed = r["hier"], r["first"], r["resumed"]
        assert resumed["start"] == CKPT_AT
        log = resumed["restore_log"]
        assert f"restored tune state at step {CKPT_AT}" in log
        assert f"restored tune controller (last decision step " \
               f"{CKPT_AT - 1})" in log
        assert first["losses"] + resumed["losses"] == full["losses"]
        assert first["grad_norms"] + resumed["grad_norms"] == \
            full["grad_norms"]
        assert resumed["tune"]["history"] == full["tune"]["history"]
        assert resumed["tune"]["codecs"] == full["tune"]["codecs"]
        assert resumed["tune"]["select_per_step"] == \
            full["tune"]["select_per_step"][CKPT_AT:]


def test_checkpoint_crosses_packages(reference, port, ref_reads_port):
    ref = reference["hier"]
    # the port resumes the reference's checkpoint and walks on as it did
    for r in port:
        res = r["from_ref"]
        assert res["start"] == CKPT_AT
        log = res["restore_log"]
        assert not [ln for ln in log if ln.startswith("WARNING:")], log
        assert f"restored codec state at step {CKPT_AT}" in log
        assert f"restored tune state at step {CKPT_AT}" in log
        assert _rounds_of(res["tune"]["history"]) == \
            _rounds_of(ref["history"])
        np.testing.assert_allclose(res["losses"], ref["losses"][CKPT_AT:],
                                   rtol=LOSS_RTOL_PLR)
    # the reference reads the port's tune state at step CKPT_AT and its
    # controller.json (one file, the last save's: the resumed run's)
    first = port[0]["first"]["tune"]
    last = port[0]["resumed"]["tune"]
    got = ref_reads_port
    assert got["step"] == CKPT_AT
    for k, v in got["tstate"]["select"].items():
        assert int(v) == first["rounds"][-1]["select"][k]
    for v in got["tstate"]["sig"].values():
        np.testing.assert_array_equal(v, np.zeros(12, np.float32))
    assert got["state"]["history"] == last["history"]
    assert got["state"]["codec"] == last["codecs"]
    assert got["select"] == last["rounds"][-1]["select"]


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2], sys.argv[3], sys.argv[4])
elif __name__ == "__main__" and sys.argv[1:2] == ["--read-port"]:
    _read_port(sys.argv[2], sys.argv[3], sys.argv[4])
