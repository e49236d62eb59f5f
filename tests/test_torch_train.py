"""The port's training step (repro_torch.train) against the reference's, on
``gemma3-1b --reduced`` with the reference's weights (``from_jax_params``).

Contract asserted here, with the tolerances and their reasons:
  * tp = dp = 1, one process: the loss within rtol 1e-6 and every
    parameter's gradient within rtol 2e-4 of its largest entry (f32
    throughout; the two frameworks order the matmul and softmax sums
    differently, an ulp or so per op);
  * dp 2 x tp 2, a gloo world of 4 CPU processes against the reference on
    4 XLA host devices, 4 steps: under ``baseline`` every loss within
    rtol 1e-6 and every grad norm within rtol 1e-5 (the same ulp-level
    sum-order differences, and gloo sums ranks in another order than XLA);
    under ``zhybrid_16_8`` the losses within rtol 1e-5 and the grad norms
    within rtol 1e-4: a bq8/bq16 ring can turn an ulp into one quantization
    step, and XLA:CPU fuses the ring hop's multiply into its add where the
    port rounds twice (``test_torch_kernels_ring.py``).  Measured on these
    inputs: baseline losses equal, grad norms 7e-7 apart; zhybrid_16_8
    losses 3e-7 and grad norms 7e-7 apart.  The same tolerances hold the
    optimizer's two options under zhybrid_16_8: ``grad_buckets=2``
    (measured 8e-8 / 7e-7) and, for its first three steps,
    ``state_bits=8`` (see ``TIGHT_STEPS`` for why not the fourth);
  * the optimizer with bq8 m and v, one process, identical parameters,
    gradients and state for 4 steps: the m and v planes equal but for at
    most 4 entries one quantization step apart, their scales within 2 ulp,
    the parameters within 1e-5 (XLA contracts the moment updates into
    FMAs; measured 1 entry, 2.3e-7 relative, 3.4e-6);
  * carried-state codecs, each run starting from the reference's initial
    codec state (``codec_state_from``; the port's own Q0 is 1e-6 from it):
    ``zhybrid_16_8`` with ``plr8`` or ``ef:plr8`` on the DP gradient sync,
    and ``ef_zhybrid_16_4`` (``ef:bq4``).  Losses, grad norms and the
    final codec state within ``STATEFUL_TOL`` of the reference's (see
    there for the measured values); the ranks of a dp group (one tp
    shard of the gradient) hold the same factor Q, bit for bit;
  * ``minitron-4b --reduced`` (relu² MLP, untied head, head attention
    at tp 2) at dp 2 x tp 2 under ``zhybrid_16_8``, 2 steps, from the
    reference's weights of that architecture: losses within rtol 1e-5
    and grad norms within rtol 1e-4, zhybrid_16_8's tolerances above;
  * the first step's ledger, priced per dimension and per ``dim/level``,
    equals the reference's under every case, byte for byte;
  * the launcher refuses unported flags (``--host-devices``), accepts
    ``--pod`` and the checkpoints' (and
    checkpoints and resumes on the CPU), accepts the pipeline's and
    refuses a schedule it cannot run, trains pp 2 (and pp 2 x vpp 2) on
    the CPU when asked, builds ``--codec-for`` policies, runs on the CPU
    only when asked, refuses a stateful codec at an
    autodiff site with the reference's message, and its ranks import
    neither ``jax`` nor ``repro``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEQ, GB, STEPS = 32, 4, 4
# trajectory cases: the two schemes at the default optimizer, and the
# zhybrid_16_8 step with the optimizer's two options (bucketed DP sync with
# the clip after it; bq8 m and v)
CASES = {
    "baseline": dict(scheme="baseline"),
    "zhybrid_16_8": dict(scheme="zhybrid_16_8"),
    "zhybrid_16_8_buckets2": dict(scheme="zhybrid_16_8", grad_buckets=2),
    "zhybrid_16_8_state8": dict(scheme="zhybrid_16_8", opt_state_bits=8),
    # carried-state codecs: low rank and error feedback on the DP sync
    "zhybrid_16_8_plr8": dict(scheme="zhybrid_16_8",
                              codec_for=["dp@zero1_grad*=plr8"]),
    "ef_zhybrid_16_4": dict(scheme="ef_zhybrid_16_4"),
    "zhybrid_16_8_efplr8": dict(scheme="zhybrid_16_8",
                                codec_for=["dp@zero1_grad*=ef:plr8"]),
    # another dense decoder: minitron-4b's relu² MLP, untied head and
    # 4 q over 2 kv heads (reduced), head attention at tp 2, 2 steps
    "minitron_zhybrid_16_8": dict(scheme="zhybrid_16_8", arch="minitron-4b",
                                  steps=2),
}
STATEFUL = ("zhybrid_16_8_plr8", "ef_zhybrid_16_4", "zhybrid_16_8_efplr8")
# (loss rtol, grad-norm rtol, final-state tol) against the reference: the
# factor Q within tol of its largest entry, the ef residual's norm within
# rtol (a bq4 rounding flip moves single entries by a quantization step).
# Measured on these inputs, losses / grad norms / state: plr8 1.5e-7 /
# 6.7e-7 / 4.5e-5; ef:bq4 1.5e-7 / 6.7e-7 / 1.1e-5; ef:plr8 1.5e-7 /
# 6.7e-7 / 2.6e-5.
STATEFUL_TOL = {"zhybrid_16_8_plr8": (1e-5, 1e-4, 2e-4),
                "ef_zhybrid_16_4": (1e-5, 1e-4, 1e-4),
                "zhybrid_16_8_efplr8": (1e-5, 1e-4, 2e-4)}
# bq8 m and v amplify an ulp: most of a row's v quantizes to 0, so where an
# ulp moves m across a rounding boundary the update m/(sqrt(v) + eps) jumps
# by a quantization step of m over eps.  Only the leading steps hold at the
# tight tolerance; later ones within 1e-2 (loss) and 0.1 (grad norm).
# Measured: steps 0-2 3.7e-6 / 7.5e-6, step 3 3.1e-3 / 4.3e-2.  On
# identical inputs the optimizer itself agrees to an ulp
# (test_state8_optimizer_matches_reference).
TIGHT_STEPS = {"zhybrid_16_8_state8": 3}


def _arch(kw: dict) -> str:
    return kw.get("arch", "gemma3-1b")


def _reference(out_path: str) -> None:
    import jax
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms, policy
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import Trainer, batch_specs

    mesh = make_mesh(2, 2)
    mi = MeshInfo.from_mesh(mesh)
    out = {"trees": {}}
    for case, kw in CASES.items():
        cfg = configs.get(_arch(kw)).reduced()
        pol = policy.as_policy(kw["scheme"])
        for spec in kw.get("codec_for", ()):       # DIM@NAME_GLOB=CODEC
            pat, _, codec = spec.partition("=")
            dim, _, name = pat.partition("@")
            pol = pol.with_rules(policy.Rule(codec, dim=dim, name=name))
        trainer = Trainer(Model(cfg, mi), mesh, scheme=pol,
                          opt_cfg=AdamConfig(
                              lr=1e-3, grad_buckets=kw.get("grad_buckets", 1),
                              state_bits=kw.get("opt_state_bits", 32)))
        params, ostate, cstate = trainer.init_all(jax.random.key(0))
        out["trees"][_arch(kw)] = jax.tree.map(
            lambda pv: np.asarray(pv.v), params,
            is_leaf=lambda x: isinstance(x, Pv))
        cstate0 = jax.tree.map(np.asarray, cstate)
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=GB,
                                          seed=0))
        bspecs = batch_specs(cfg, mi)
        losses, gnorms = [], []
        for step in range(kw.get("steps", STEPS)):
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in data.batch(step).items()}
            with comms.record_traffic() as events:
                params, ostate, cstate, m = trainer.step(params, ostate,
                                                         cstate, batch)
            if step == 0:
                summary = roofline.ledger_summary(events, train=True)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[case] = dict(losses=losses, gnorms=gnorms,
                         per_dim=summary["per_dim"],
                         per_dim_level=summary["per_dim_level"],
                         cstate0=cstate0,
                         cstate=jax.tree.map(np.asarray, cstate))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "train.pkl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--reference", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    ref["weights"] = {}
    for arch, tree in ref.pop("trees").items():
        ref["weights"][arch] = str(out.parent / f"weights_{arch}.pkl")
        with open(ref["weights"][arch], "wb") as f:
            pickle.dump(tree, f)
    for case in STATEFUL:
        path = out.parent / f"cstate_{case}.pkl"
        with open(path, "wb") as f:
            pickle.dump(ref[case]["cstate0"], f)
        ref[case]["cstate0_path"] = str(path)
    return ref


def train_rank_keeping_codec_state(**kw) -> dict:
    """``train_rank`` in a spawned rank, plus the codec state after its
    last step as numpy (``codec_state_arrays``), kept by wrapping
    ``Trainer.step`` in this rank's process."""
    from repro_torch.launch.train import train_rank
    from repro_torch.train.train_step import Trainer

    kept, step = {}, Trainer.step

    def keep(self, *args):
        out = step(self, *args)
        kept["cstate"] = out[2]
        return out

    def host(t):
        return {k: host(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.cpu().numpy()
    Trainer.step = keep
    try:
        res = train_rank(**kw)
    finally:
        Trainer.step = step
    res["codec_state_arrays"] = host(kept["cstate"])
    return res


@pytest.fixture(scope="module")
def port(reference):
    from repro_torch.launch.train import spawn_world
    res = {}
    for case, kw in CASES.items():
        target = "repro_torch.launch.train:train_rank"
        if case in STATEFUL:
            kw = dict(kw, codec_state_from=reference[case]["cstate0_path"])
            target = f"{__name__}:train_rank_keeping_codec_state"
        kw = dict(kw, arch=_arch(kw), steps=kw.get("steps", STEPS))
        res[case] = spawn_world(
            target, 4,
            dict(reduced=True, dp=2, tp=2, seq=SEQ, global_batch=GB,
                 lr=1e-3, seed=0, device="cpu",
                 init_from=reference["weights"][kw["arch"]], **kw),
            timeout=600)
    return res


# --------------------------------------------------------------------------
# one process, tp = dp = 1: loss and gradients
# --------------------------------------------------------------------------

def test_tp1_loss_and_grads_match_reference():
    import jax
    import torch
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.core import comms as jcomms, compat
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo, Pv
    from repro.train.train_step import batch_specs
    from repro_torch import configs as tconfigs
    from repro_torch.models.model import Model as TModel
    from repro_torch.models.params import from_jax_params, leaves

    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jcfg = jconfigs.get("gemma3-1b").reduced()
    jmodel = JModel(jcfg, JMeshInfo.from_mesh(mesh))
    jparams = jmodel.init(jax.random.key(0))
    batch = SyntheticCorpus(DataConfig(vocab_size=jcfg.vocab_size,
                                       seq_len=SEQ, global_batch=2,
                                       seed=0)).batch(0)

    def f(params, b):
        with jcomms.vma_mode(False):          # as the reference's step runs
            (loss, _), grads = jax.value_and_grad(jmodel.loss_fn,
                                                  has_aux=True)(params, b)
        return loss, grads
    specs = jmodel.specs()
    jloss, jgrads = jax.jit(compat.shard_map(
        f, mesh=mesh, in_specs=(specs, batch_specs(jcfg, jmodel.mi)),
        out_specs=(P(), specs), check_vma=False))(jparams, batch)

    tcfg = tconfigs.get("gemma3-1b").reduced()
    tmodel = TModel(tcfg, device="cpu")
    tree = jax.tree.map(lambda pv: np.asarray(pv.v), jparams,
                        is_leaf=lambda x: isinstance(x, Pv))
    tparams = from_jax_params(tree, tcfg, device="cpu")
    ts = [t.requires_grad_(True) for _, t in leaves(tmodel.plan, tparams)]
    tloss, _ = tmodel.loss_fn(tparams, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, ts)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    jg = [np.asarray(pv.v) for pv in jax.tree_util.tree_leaves(
        jgrads, is_leaf=lambda x: isinstance(x, Pv))]
    assert len(jg) == len(tgrads)
    for a, b in zip(jg, tgrads):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=2e-4 * np.abs(a).max())


def test_state8_optimizer_matches_reference():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.core import comms as jcomms, compat
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo, Pv
    from repro.train.optimizer import AdamConfig as JAdamConfig
    from repro.train.train_step import Trainer as JTrainer
    from repro_torch import configs as tconfigs
    from repro_torch.models.model import Model as TModel
    from repro_torch.models.params import from_jax_params, leaves
    from repro_torch.train.optimizer import Adam, AdamConfig

    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jcfg = jconfigs.get("gemma3-1b").reduced()
    jmodel = JModel(jcfg, JMeshInfo.from_mesh(mesh))
    jtrainer = JTrainer(jmodel, mesh, scheme="baseline",
                        opt_cfg=JAdamConfig(lr=1e-3, state_bits=8))

    def apply(p, g, s):
        with jcomms.vma_mode(False):           # as the reference's step runs
            return jtrainer.opt.apply(p, g, s)
    pspecs = jmodel.specs()
    ospecs = jtrainer.opt_state_specs()
    japply = jax.jit(compat.shard_map(
        apply, mesh=mesh, in_specs=(pspecs, pspecs, ospecs),
        out_specs=(pspecs, ospecs, P()), check_vma=False))
    is_pv = lambda x: isinstance(x, Pv)            # noqa: E731
    jparams = jmodel.init(jax.random.key(0))
    jstate = jtrainer.opt_init(jparams)

    tcfg = tconfigs.get("gemma3-1b").reduced()
    tmodel = TModel(tcfg, device="cpu")
    tparams = from_jax_params(
        jax.tree.map(lambda pv: np.asarray(pv.v), jparams, is_leaf=is_pv),
        tcfg, device="cpu")
    opt = Adam(AdamConfig(lr=1e-3, state_bits=8), tmodel.mi, tmodel.plan)
    tstate = opt.init(tparams)

    rng = np.random.default_rng(0)
    for step in range(4):
        g = jax.tree.map(lambda pv: (rng.standard_normal(pv.v.shape) * 1e-3)
                         .astype(pv.v.dtype), jparams, is_leaf=is_pv)
        jparams, jstate, jstats = japply(
            jparams, jax.tree.map(lambda pv, a: Pv(jnp.asarray(a), pv.spec),
                                  jparams, g, is_leaf=is_pv), jstate)
        tg = [t for _, t in leaves(tmodel.plan,
                                   from_jax_params(g, tcfg, device="cpu"))]
        tstate, tstats = opt.apply(tparams, tg, tstate)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        for k in ("m", "v"):
            jq = np.asarray(jstate[k]["q_hi"]).astype(np.int32)
            tq = tstate[k]["q_hi"].numpy().astype(np.int32)
            assert np.abs(jq - tq).max() <= 1 and (jq != tq).sum() <= 4
            np.testing.assert_allclose(tstate[k]["scale"].numpy(),
                                       np.asarray(jstate[k]["scale"]),
                                       rtol=2.4e-7, atol=0)
        jl = [np.asarray(pv.v, np.float32) for pv in
              jax.tree_util.tree_leaves(jparams, is_leaf=is_pv)]
        for a, (_, b) in zip(jl, leaves(tmodel.plan, tparams)):
            np.testing.assert_allclose(b.float().numpy(), a, rtol=0,
                                       atol=1e-5)


# --------------------------------------------------------------------------
# dp 2 x tp 2: trajectories and the ledger
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,rtol_loss,rtol_gnorm",
                         [("baseline", 1e-6, 1e-5),
                          ("zhybrid_16_8", 1e-5, 1e-4),
                          ("zhybrid_16_8_buckets2", 1e-5, 1e-4),
                          ("zhybrid_16_8_state8", 1e-5, 1e-4)])
def test_trajectory_matches_reference(case, rtol_loss, rtol_gnorm,
                                      reference, port):
    want = reference[case]
    k = TIGHT_STEPS.get(case, STEPS)
    for r in port[case]:                       # every rank reports the same
        np.testing.assert_allclose(r["losses"][:k], want["losses"][:k],
                                   rtol=rtol_loss)
        np.testing.assert_allclose(r["grad_norms"][:k], want["gnorms"][:k],
                                   rtol=rtol_gnorm)
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-2)
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"], rtol=0.1)
        assert r["losses"] == port[case][0]["losses"]
    assert want["losses"][-1] < want["losses"][0]


def test_minitron_trajectory_matches_reference(reference, port):
    """minitron-4b's two steps at zhybrid_16_8's tolerances; two batches
    of the synthetic corpus need not lower the loss (measured 6.2598 ->
    6.2793 in both packages), so no fall is asserted."""
    case = "minitron_zhybrid_16_8"
    want = reference[case]
    assert len(want["losses"]) == CASES[case]["steps"]
    for r in port[case]:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"],
                                   rtol=1e-4)
        assert r["losses"] == port[case][0]["losses"]
        assert np.isfinite(r["losses"]).all()


def _leaves(st, prefix=""):
    out = {}
    for k, v in st.items():
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


@pytest.mark.parametrize("case", STATEFUL)
def test_stateful_trajectory_matches_reference(case, reference, port):
    want = reference[case]
    rtol_loss, rtol_gnorm, tol_state = STATEFUL_TOL[case]
    ref_state = _leaves(want["cstate"])
    for rank, r in enumerate(port[case]):
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=rtol_loss)
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"],
                                   rtol=rtol_gnorm)
        assert r["losses"] == port[case][0]["losses"]
        got_state = _leaves(r["codec_state_arrays"])
        assert set(got_state) == set(ref_state)
        for k, glob in ref_state.items():
            per = glob.shape[0] // 4                # stacked in rank order
            ref_k = glob[rank * per:(rank + 1) * per]
            got = got_state[k]
            assert got.shape == ref_k.shape, k
            if k.endswith("residual"):              # quantization flips
                np.testing.assert_allclose(np.linalg.norm(got),
                                           np.linalg.norm(ref_k),
                                           rtol=tol_state, err_msg=k)
            else:
                np.testing.assert_allclose(
                    got, ref_k, rtol=0, atol=tol_state * np.abs(ref_k).max(),
                    err_msg=k)
            if k.endswith("q"):     # the same Q across each dp group
                peer = port[case][rank % 2]          # data index 0, same tp
                assert got.tobytes() == \
                    _leaves(peer["codec_state_arrays"])[k].tobytes()
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_bytes_per_dim_match_reference(case, reference, port):
    want = reference[case]["per_dim"]
    for r in port[case]:
        assert r["priced_per_dim"] == pytest.approx(want, rel=1e-12)
    got = port[case][0]["priced_per_dim"]
    if CASES[case]["scheme"] == "zhybrid_16_8" and \
            _arch(CASES[case]) == "gemma3-1b":
        base = reference["baseline"]["per_dim"]
        assert got["dp"] < 0.3 * base["dp"] and got["tp"] < base["tp"]


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_bytes_per_dim_level_match_reference(case, reference, port):
    want = {k: v for k, v in reference[case]["per_dim_level"].items() if v}
    for r in port[case]:
        got = {k: v for k, v in r["priced_per_dim_level"].items() if v}
        assert got == pytest.approx(want, rel=1e-12)


def test_ranks_import_no_reference(port):
    for case in CASES:
        for r in port[case]:
            assert r["foreign_modules"] == []


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_refuses_unported_flags():
    from repro_torch.launch import train as tlaunch
    ap = tlaunch.parser()
    ok = ap.parse_args(["--arch", "gemma3-1b", "--dp", "2", "--tp", "2",
                        "--scheme", "zhybrid_16_8", "--ring-bidir"])
    assert tlaunch.unported(ok) == []
    for extra in (["--host-devices", "8"],):
        args = ap.parse_args(["--arch", "gemma3-1b", *extra])
        msgs = tlaunch.unported(args)
        assert len(msgs) == 1 and "is not ported" in msgs[0], extra
    # the outer data-parallel pod axis is ported: --pod is accepted
    pod = ap.parse_args(["--arch", "gemma3-1b", "--pod", "2", "--dp", "2"])
    assert tlaunch.unported(pod) == [] and pod.pod == 2
    # context parallelism is ported: --cp and --cp-nodes are accepted
    cp = ap.parse_args(["--arch", "gemma3-1b", "--cp", "2"])
    assert tlaunch.unported(cp) == [] and cp.cp == 2
    cpn = ap.parse_args(["--arch", "gemma3-1b", "--cp", "4", "--cp-nodes",
                         "2"])
    assert tlaunch.unported(cpn) == []
    assert tlaunch.node_counts(cpn)["cp_nodes"] == 2
    # self-tuning is ported: its flags parse and are accepted
    tune = ap.parse_args(["--arch", "gemma3-1b", "--tune", "--tune-interval",
                          "5", "--tune-guard", "0.1", "--policy-from", "x"])
    assert tlaunch.unported(tune) == []
    assert (tune.tune, tune.tune_interval, tune.tune_guard,
            tune.policy_from) == (True, 5, 0.1, "x")
    kw = tlaunch.rank_kwargs(ap.parse_args(
        ["--arch", "gemma3-1b", "--tune", "--tune-interval", "5",
         "--device", "cpu"]))
    assert (kw["tune"], kw["tune_interval"], kw["tune_guard"],
            kw["policy_from"]) == (True, 5, 0.05, "")
    # checkpoints are ported: their flags are accepted
    ck = ap.parse_args(["--arch", "gemma3-1b", "--ckpt-dir", "x",
                        "--ckpt-every", "5", "--resume"])
    assert tlaunch.unported(ck) == []
    assert (ck.ckpt_dir, ck.ckpt_every, ck.resume) == ("x", 5, True)
    # so are the node-factored meshes, as an int or NxD
    hier = ap.parse_args(["--arch", "gemma3-1b", "--dp", "4", "--nodes",
                          "2x2", "--tp", "4", "--tp-nodes", "2", "--pp", "2",
                          "--pp-nodes", "2"])
    assert tlaunch.unported(hier) == []
    assert tlaunch.node_counts(hier) == dict(nodes=2, tp_nodes=2, pp_nodes=2,
                                             cp_nodes=1)
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "gemma3-1b", "--cp-nodes", "2", "--device",
                      "cpu"])
    for bad in (["--nodes", "3", "--dp", "4"], ["--pp-nodes", "2"],
                ["--dp", "4", "--nodes", "2x3"]):
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "gemma3-1b", *bad, "--device", "cpu"])


def test_launcher_builds_codec_for_policies():
    from repro_torch.core import policy
    from repro_torch.launch import train as tlaunch
    pol = tlaunch.comm_policy("zhybrid_16_8", ["dp@zero1_grad*=plr8",
                                               "zero=ef:bq8", "embed*=bq16"],
                              no_compress_below=4096)
    plan = pol.compile()
    assert pol.name == "zhybrid_16_8+cli"
    assert plan.codec_pair(policy.Site("dp", "zero1_grad"), 1 << 20)[0].name \
        == "plr8"
    assert plan.codec_pair(policy.Site("dp", "zero1_grad"), 100)[0].name \
        == "none"
    assert plan.codec("zero").name == "ef:bq8"
    assert plan.codec_pair(policy.Site("tp", "embed"), 1 << 20)[0].name \
        == "bq16"
    assert plan.codec("dp").name == "bq8"
    for bad in (["dp@zero1_grad*"], ["dp=ef:bq9"], ["xx@a=bq8"]):
        with pytest.raises((KeyError, ValueError)):
            tlaunch.comm_policy("zhybrid_16_8", bad)
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "gemma3-1b", "--codec-for", "dp=plr0",
                      "--device", "cpu"])


def test_launcher_refuses_stateful_codec_at_autodiff_site():
    from repro_torch.launch import train as tlaunch
    with pytest.raises(RuntimeError, match="never autodiff traffic"):
        tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--dp", "2",
                      "--tp", "2", "--steps", "1", "--seq", "16",
                      "--global-batch", "2", "--codec-for", "tp=ef:bq8",
                      "--device", "cpu"])


def test_launcher_trains_plr8_on_cpu(capsys):
    from repro_torch.launch import train as tlaunch
    tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--dp", "2", "--tp",
                  "2", "--steps", "2", "--seq", "16", "--global-batch", "2",
                  "--scheme", "zhybrid_16_8", "--codec-for",
                  "dp@zero1_grad*=plr8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: final loss" in out
    assert "codec state dp@zero1_grad (rank 0)" in out and "rank 8" in out


def test_launcher_accepts_pipeline_flags():
    from repro_torch.launch import train as tlaunch
    ap = tlaunch.parser()
    args = ap.parse_args(["--arch", "gemma3-1b", "--layers", "8", "--pp", "2",
                          "--vpp", "2", "--microbatches", "4",
                          "--remat-policy", "per_stage:0+offload"])
    assert tlaunch.unported(args) == []
    tlaunch.check_schedule(args)
    # gemma3-1b's 5:1 local:global stack does not tile into stages, nor
    # does an interleaved schedule over microbatches not divisible by pp
    for bad, msg in ((["--pp", "2"], "not identical"),
                     (["--layers", "8", "--pp", "2", "--vpp", "2",
                       "--microbatches", "3"], "divisible by --pp"),
                     (["--layers", "8", "--pp", "2", "--remat-policy",
                       "per_stage:3"], "out of range")):
        with pytest.raises(ValueError, match=msg):
            tlaunch.check_schedule(ap.parse_args(["--arch", "gemma3-1b",
                                                  *bad]))
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "gemma3-1b", *bad, "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--vpp", "2", "--layers", "8",
                                        "--remat-policy", "per_stage:0"]])
def test_launcher_trains_pipeline_on_cpu(extra, capsys):
    from repro_torch.launch import train as tlaunch
    tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--layers", "4",
                  "--pp", "2", "--microbatches", "2", "--steps", "2",
                  "--seq", "16", "--global-batch", "2", "--scheme",
                  "zhybrid_16_8", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert "done: final loss" in out and "bubble fraction" in out
    assert ("5 ticks" if extra else "3 ticks") in out


def test_launcher_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as tlaunch
    base = ["--arch", "gemma3-1b", "--reduced", "--seq", "16",
            "--global-batch", "2", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    tlaunch.main([*base, "--steps", "2", "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "checkpointed at step 2" in out and "steps [1, 2]" in out
    tlaunch.main([*base, "--steps", "1", "--resume"])
    out = capsys.readouterr().out
    assert "restored optimizer state at step 2" in out
    assert "resumed from step 2 (elastic onto dp=1 tp=1 pp=1)" in out
    assert "step     2 loss=" in out and "checkpointed at step 3" in out
    assert "stragglers 0/1" in out or "stragglers 1/1" in out
    assert (tmp_path / "heartbeat.json").exists()


def test_launcher_trains_on_cpu(capsys):
    from repro_torch.launch import train as tlaunch
    tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--steps", "2",
                  "--seq", "16", "--global-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and "done: final loss" in out


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
