"""The port's pipeline-parallel training (repro_torch.train.pipeline) against
the reference's, on ``gemma3-1b --reduced`` with the reference's weights
(``from_jax_params``), plus the schedule's bookkeeping.

Contract asserted here, with the tolerances and their reasons:
  * bookkeeping equal to the reference's over a grid of (layers, pp, vpp):
    ``stage_partition`` (its refusals and messages included: gemma3-1b's
    5:1 local:global pattern at pp 2, pp 2 x vpp 2 and pp 4, full size
    and reduced), ``chunk_layer_ranges``, ``pipeline_ticks``,
    ``bubble_fraction`` and ``parse_remat_policy``; the stage-stacked plan
    and the mesh's stage axis;
  * dp 2 x pp 2 x tp 2 (``--layers 4``, 2 microbatches, 3 steps), a gloo
    world of 8 CPU processes against the reference on 8 XLA host devices:
    under ``baseline`` the losses within rtol 1e-6 and the grad norms
    within rtol 1e-5; under ``zhybrid_16_8`` within 1e-5 and 1e-4
    (``test_torch_train.py``'s tolerances, for its reasons: frameworks
    and gloo sum in other orders, and a bq ring can turn an ulp into a
    quantization step);
  * pp 2 x vpp 2 x tp 2 (``--layers 8``, 2 microbatches, ``zhybrid_16_8``)
    under the remat policies ``none``, ``full`` and ``per_stage:0``, and
    gradient accumulation (pp 1, dp 2 x tp 2, 4 microbatches,
    ``zhybrid_16_8``) against the reference with the same tolerances;
  * every case's first-step ledger, priced per dimension, equal to the
    reference's byte for byte, ``pp`` included;
  * port-internal: pp 2 against the port's own flat microbatched step
    (pp 1, same seed, same weights) under ``baseline`` within rtol 1e-6
    (the reference's own pipelined run is 7.7e-8 from its flat one), the
    grad norms times pp (the reference's gradient scale on a stage mesh);
    remat ``full`` gives the same gradients as no remat, bit for bit.

The reference runs in a subprocess with 8 XLA host devices (this file
re-invokes itself with ``--reference``); the port's cases run in two
spawned worlds, 8 and 4 ranks, several cases each, to bound the cost.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEQ, STEPS = 32, 3
# case -> (mesh and schedule, the reference's too); gb is the global batch
CASES = {
    "pp_baseline": dict(dp=2, tp=2, pp=2, layers=4, microbatches=2,
                        scheme="baseline", gb=4),
    "pp_zhybrid": dict(dp=2, tp=2, pp=2, layers=4, microbatches=2,
                       scheme="zhybrid_16_8", gb=4),
    "vpp_none": dict(dp=1, tp=2, pp=2, vpp=2, layers=8, microbatches=2,
                     scheme="zhybrid_16_8", gb=4),
    "vpp_full": dict(dp=1, tp=2, pp=2, vpp=2, layers=8, microbatches=2,
                     scheme="zhybrid_16_8", gb=4, remat_policy="full"),
    "vpp_per_stage0": dict(dp=1, tp=2, pp=2, vpp=2, layers=8,
                           microbatches=2, scheme="zhybrid_16_8", gb=4,
                           remat_policy="per_stage:0"),
    "accum": dict(dp=2, tp=2, pp=1, layers=0, microbatches=4,
                  scheme="zhybrid_16_8", gb=8),
    # error feedback on the DP sync: its residuals, stacked by the
    # reference in (data, stage, model) order, hold each rank's slot
    "pp_ef": dict(dp=2, tp=2, pp=2, layers=4, microbatches=2,
                  scheme="ef_zhybrid_16_4", gb=4),
}
# port-internal runs from the port's own seed (no reference)
OWN = {
    "pp_seed": dict(dp=2, tp=2, pp=2, layers=4, microbatches=2,
                    scheme="baseline", gb=4),
    "flat_seed": dict(dp=2, tp=2, pp=1, layers=4, microbatches=2,
                      scheme="baseline", gb=4),
}
TOL = {"baseline": (1e-6, 1e-5), "zhybrid_16_8": (1e-5, 1e-4),
       "ef_zhybrid_16_4": (1e-5, 1e-4)}
# an ef residual's norm: a bq4 rounding flip moves single entries by a
# quantization step (test_torch_train.py's STATEFUL_TOL)
RESIDUAL_RTOL = 1e-4


def _world(c) -> int:
    return c["dp"] * c["pp"] * c["tp"]


def _reference(out_path: str) -> None:
    import jax
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import batch_specs, make_trainer

    out = {}
    for case, c in CASES.items():
        cfg = configs.get("gemma3-1b").reduced()
        if c["layers"]:
            cfg = cfg.replace(n_layers=c["layers"], groups=())
        mesh = make_mesh(c["dp"], c["tp"], pp=c["pp"])
        mi = MeshInfo.from_mesh(mesh)
        trainer = make_trainer(Model(cfg, mi, vpp=c.get("vpp", 1)), mesh,
                               scheme=c["scheme"],
                               opt_cfg=AdamConfig(lr=1e-3),
                               n_micro=c["microbatches"],
                               remat_policy=c.get("remat_policy"))
        params, ostate, cstate = trainer.init_all(jax.random.key(0))
        tree = jax.tree.map(lambda pv: np.asarray(pv.v), params,
                            is_leaf=lambda x: isinstance(x, Pv))
        cstate0 = jax.tree.map(np.asarray, cstate)
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=c["gb"],
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
                per_dim = roofline.ledger_summary(events,
                                                  train=True)["per_dim"]
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[case] = dict(tree=tree, losses=losses, gnorms=gnorms,
                         per_dim=per_dim, cstate0=cstate0,
                         cstate=jax.tree.map(np.asarray, cstate))
        jax.clear_caches()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "pipeline.pkl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--reference", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    for case, r in ref.items():
        for key in ("tree", "cstate0"):
            path = out.parent / f"{key}_{case}.pkl"
            with open(path, "wb") as f:
                pickle.dump(r.pop(key), f)
            r[key] = str(path)
    return ref


def run_cases(*, rank: int, world: int, cases: dict) -> dict:
    """Every case of ``cases`` in turn in this world (each ``train_rank``
    builds its own mesh over the world's group); each result also holds
    the first step's pre-sync gradients, bit for bit, as bytes."""
    import torch

    from repro_torch.launch.train import train_rank
    from repro_torch.train.optimizer import Adam

    out, apply = {}, Adam.apply
    for case, kw in cases.items():
        kept = []

        def keep(self, params, grads, state):
            if not kept:
                kept.append(b"".join(g.detach().to(torch.float32).numpy()
                                     .tobytes() for g in grads))
            return apply(self, params, grads, state)
        Adam.apply = keep
        try:
            out[case] = train_rank(rank=rank, world=world, **kw)
        finally:
            Adam.apply = apply
        out[case]["grads0"] = kept[0]
    return out


def _kwargs(c: dict, ref: dict | None = None) -> dict:
    """``train_rank``'s keywords for case ``c``, from the reference's
    weights and initial codec state when ``ref`` is given."""
    return dict(arch="gemma3-1b", reduced=True, layers=c["layers"],
                dp=c["dp"], tp=c["tp"], pp=c["pp"], vpp=c.get("vpp", 1),
                microbatches=c["microbatches"],
                remat_policy=c.get("remat_policy", "none"),
                scheme=c["scheme"], steps=STEPS, seq=SEQ,
                global_batch=c["gb"], lr=1e-3, seed=0, device="cpu",
                init_from=ref["tree"] if ref else "",
                codec_state_from=ref["cstate0"] if ref else "")


@pytest.fixture(scope="module")
def port(reference):
    from repro_torch.launch.train import spawn_world
    todo = {case: _kwargs(c, reference[case]) for case, c in CASES.items()}
    todo.update({case: _kwargs(c) for case, c in OWN.items()})
    allc = {**CASES, **OWN}
    res = {}
    for world in (8, 4):
        cases = {k: v for k, v in todo.items() if _world(allc[k]) == world}
        per_rank = spawn_world(f"{__name__}:run_cases", world,
                               dict(cases=cases), timeout=900)
        for case in cases:
            res[case] = [r[case] for r in per_rank]
    return res


# --------------------------------------------------------------------------
# bookkeeping
# --------------------------------------------------------------------------

GRID = [(layers, pp, vpp) for layers in (2, 4, 6, 8, 12, 24, 26)
        for pp in (1, 2, 3, 4) for vpp in (1, 2, 3)]


def _partition(mod, cfg, pp, vpp):
    try:
        return [(g.kind, g.n, g.window)
                for g in mod.stage_partition(cfg, pp, vpp)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("layers,pp,vpp", GRID)
def test_stage_bookkeeping_matches_reference(layers, pp, vpp):
    from repro.analysis import roofline as jroof
    from repro.models import transformer as jtr
    from repro_torch.analysis import roofline as troof
    from repro_torch.models import transformer as ttr
    from repro_torch.launch.train import model_config
    from repro import configs as jconfigs

    for base in ("gemma3-1b",):
        jcfg = jconfigs.get(base).replace(n_layers=layers, groups=())
        tcfg = model_config(base, layers=layers)
        assert _partition(ttr, tcfg, pp, vpp) == \
            _partition(jtr, jcfg, pp, vpp)
    if layers % (pp * vpp) == 0:
        assert ttr.chunk_layer_ranges(layers, pp, vpp) == \
            jtr.chunk_layer_ranges(layers, pp, vpp)
    for micro in (1, 2, 4, 8):
        assert troof.pipeline_ticks(pp, micro, vpp) == \
            jroof.pipeline_ticks(pp, micro, vpp)
        assert troof.bubble_fraction(pp, micro, vpp) == \
            jroof.bubble_fraction(pp, micro, vpp)
        assert troof.pipelined_step_time(2.5, pp, micro, vpp) == \
            jroof.pipelined_step_time(2.5, pp, micro, vpp)


def test_stage_handoff_seconds_prices_pp_events_alone():
    """The pp events' bytes over the caller's link rate: the reference's
    price on one flat link of that rate."""
    from repro.analysis import roofline as jroof
    from repro_torch.analysis import roofline as troof

    ev = dict(op="ppermute", tag="pp@stage_handoff", axis="stage", n=2,
              elems=294912, dtype="bfloat16", nbytes=1179648,
              codec_fwd="bq16", codec_bwd="bq16", bwd_op="ppermute", mult=5,
              remat=False, bidir=False, level="flat")
    tp = {**ev, "op": "all_gather", "tag": "tp@mlp_in", "axis": "model",
          "bwd_op": "reduce_scatter"}
    rate = 25e9
    got = troof.stage_handoff_seconds([ev, tp], True, rate)
    assert got == pytest.approx(
        jroof.stage_handoff_seconds([ev, tp], True, ici_bw=rate), rel=1e-12)
    assert got == pytest.approx(
        troof.ledger_summary([ev], True)["total_bytes"] / rate, rel=1e-12)


@pytest.mark.parametrize("reduced", [False, True])
def test_gemma3_pattern_refused_as_reference(reduced):
    """gemma3-1b's 5:1 local:global stack does not tile into stages (the
    reason ``--layers`` makes it uniform); both packages refuse it alike."""
    from repro import configs as jconfigs
    from repro.models import transformer as jtr
    from repro_torch.launch.train import model_config
    from repro_torch.models import transformer as ttr

    jcfg = jconfigs.get("gemma3-1b")
    jcfg = jcfg.reduced() if reduced else jcfg
    tcfg = model_config("gemma3-1b", reduced)
    for pp, vpp in ((2, 1), (2, 2), (4, 1)):
        got, want = _partition(ttr, tcfg, pp, vpp), _partition(jtr, jcfg, pp,
                                                               vpp)
        assert got == want and got[0] == "ValueError", (pp, vpp, got)


@pytest.mark.parametrize("spec", [None, "none", "full", "per_stage:0",
                                  "per_stage:1", "per_stage:0,1",
                                  "per_stage:", "full+offload",
                                  "per_stage:0+offload", "none+offload",
                                  "per_stage:5", "per_stage:x", "bogus"])
@pytest.mark.parametrize("vpp", [1, 2, 3])
def test_parse_remat_policy_matches_reference(spec, vpp):
    from repro.train.pipeline import parse_remat_policy as jparse
    from repro_torch.train.pipeline import parse_remat_policy as tparse

    def call(f):
        try:
            return f(spec, vpp)
        except ValueError as e:
            return ("ValueError", str(e))
    assert call(tparse) == call(jparse)


def test_stage_stacked_plan_and_mesh_axis():
    import jax

    from repro import configs as jconfigs
    from repro.models import transformer as jtr
    from repro.models.params import (MeshInfo as JMeshInfo, ParamDef,
                                     local_shape as jlocal_shape)
    from repro_torch.core import policy
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import model_config
    from repro_torch.models import transformer as ttr
    from repro_torch.models.params import MeshInfo, defs, local_shape

    for vpp, layers in ((1, 4), (2, 8)):
        jcfg = jconfigs.get("gemma3-1b").reduced().replace(n_layers=layers,
                                                           groups=())
        jmi = JMeshInfo(tp=2, dp=2, pp=2, stage_axis="stage")
        jplan = jax.tree_util.tree_leaves(
            jtr.model_plan(jcfg, jmi, vpp),
            is_leaf=lambda x: isinstance(x, ParamDef))
        mi = MeshInfo(tp=2, dp=2, pp=2)
        tplan = defs(ttr.model_plan(model_config("gemma3-1b", True, layers),
                                    mi, vpp))
        assert [(d.shape, d.spec) for d in tplan] == \
            [(d.shape, d.spec) for d in jplan]
        assert [local_shape(d, mi) for d in tplan] == \
            [jlocal_shape(d, jmi) for d in jplan]
        assert sum("stage" in d.spec for d in tplan) > 0
    plan = policy.compile_plan("zhybrid_16_8", MeshInfo(tp=2, dp=2, pp=2))
    assert plan.axis("pp").name == "stage" and plan.axis("pp").size == 2
    assert plan.codec_pair(policy.Site("pp", "stage_handoff", "fwd"),
                           1 << 20)[0].name == "bq16"
    assert tmesh.comm_axes(MeshInfo(tp=2, dp=2, pp=2), "stage").size == 2
    with pytest.raises(ValueError, match="no stage axis"):
        tmesh.comm_axes(MeshInfo(tp=2, dp=2), "stage")
    for args, msg in (((2, 1, 2), "needs --pp > 1"),
                      ((2, 2, 3), "divisible by --pp"),
                      ((0, 2, 2), "must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            tmesh.validate_vpp(*args)


def stage_sends(*, rank: int, world: int) -> dict:
    """``stage_send``, ``stage_recv`` and ``stage_ring_send`` over a stage
    axis of ``world`` ranks, forward and backward, under ``none`` and
    ``bq16``: each rank's output, input gradient and ledger events."""
    import torch

    from repro_torch.core import comms, policy
    from repro_torch.launch.mesh import make_mesh

    ax = make_mesh(1, 1, world).stage_axes
    out = {}
    for scheme in ("baseline", "zhybrid_16_8"):
        for fn in ("stage_send", "stage_recv", "stage_ring_send"):
            x = torch.arange(2 * 128, dtype=torch.float32).reshape(2, 128)
            x = (x / 7 + rank).requires_grad_(True)
            with policy.use_plan(scheme), comms.record_traffic() as ev:
                y = getattr(comms, fn)(x, ax, comms.site("pp", "handoff"))
                g, = torch.autograd.grad(y, x, torch.full_like(y, rank + 1.0))
            out[(scheme, fn)] = (y.detach().numpy(), g.numpy(), list(ev))
    return out


def test_stage_sends_shift_forward_and_back():
    """Stage ``s`` sends to ``s + 1`` (``stage_send``; the first stage gets
    zeros), ``s - 1`` (``stage_recv``) or ``(s + 1) % n`` (the ring); the
    gradient takes the inverse way, zeros where nothing was sent; a
    partial shift is pro-rated in the ledger; ``bq16`` equals the codec's
    own round trip."""
    import torch

    from repro_torch.core import codecs
    from repro_torch.launch.train import spawn_world

    n = 3
    res = spawn_world(f"{__name__}:stage_sends", n, {}, timeout=300)
    base = np.arange(256, dtype=np.float32).reshape(2, 128) / 7
    bq16 = codecs.get("bq16")

    def sent(r, scheme):
        x = torch.from_numpy(base + r)
        if scheme == "zhybrid_16_8":
            x = bq16.decode(bq16.encode(x)[0], x.shape, x.dtype)
        return x.numpy()
    perms = {"stage_send": [(s, s + 1) for s in range(n - 1)],
             "stage_recv": [(s + 1, s) for s in range(n - 1)],
             "stage_ring_send": [(s, (s + 1) % n) for s in range(n)]}
    for (scheme, fn), perm in ((k, perms[k[1]]) for k in res[0]):
        for r in range(n):
            y, g, ev = res[r][(scheme, fn)]
            src = [s for s, d in perm if d == r]
            dst = [d for s, d in perm if s == r]
            want_y = sent(src[0], scheme) if src else np.zeros_like(base)
            gy = np.full_like(base, dst[0] + 1.0) if dst else \
                np.zeros_like(base)
            want_g = gy if scheme == "baseline" else \
                bq16.decode(bq16.encode(torch.from_numpy(gy))[0], gy.shape,
                            torch.float32).numpy()
            np.testing.assert_array_equal(y, want_y)
            np.testing.assert_array_equal(g, want_g)
            assert [(e["op"], e["elems"], e["codec_fwd"]) for e in ev] == \
                [("ppermute", 256 * len(perm) // n,
                  "none" if scheme == "baseline" else "bq16")]


def test_remat_recompute_keeps_the_plan_off_thread():
    """A checkpointed body's recompute runs where the backward runs
    (autograd's own thread for CUDA tensors, where a thread-local plan is
    unbound): it sees the forward's plan, and its analytic ledger events
    are muted."""
    import threading

    import torch

    from repro_torch.core import comms, policy
    from repro_torch.train.pipeline import _remat_wrap

    seen = []

    def body(x):
        seen.append(policy.current_plan().name)
        comms._account("none", "tp@x", x, comms.Axis("model", 2),
                       *comms._codec_pair("tp"))
        return torch.sin(x) * x
    x = torch.linspace(-1, 1, 64, requires_grad=True)
    with policy.use_plan("zhybrid_16_8"), comms.record_traffic() as ev:
        y = _remat_wrap(body, offload=False)(x)
        out = {}
        t = threading.Thread(target=lambda: out.update(
            g=torch.autograd.grad(y.sum(), x)[0]))
        t.start()
        t.join()
    assert seen == ["zhybrid_16_8", "zhybrid_16_8"]
    assert len(ev) == 1
    want = torch.autograd.grad((torch.sin(x) * x).sum(), x)[0]
    assert torch.equal(out["g"], want)


# --------------------------------------------------------------------------
# trajectories and the ledger against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_reference(case, reference, port):
    want = reference[case]
    rtol_loss, rtol_gnorm = TOL[CASES[case]["scheme"]]
    for r in port[case]:                    # every rank reports the same
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=rtol_loss)
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"],
                                   rtol=rtol_gnorm)
        assert r["losses"] == port[case][0]["losses"]
        assert np.all(np.isfinite(r["losses"]))


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_bytes_per_dim_match_reference(case, reference, port):
    want = reference[case]["per_dim"]
    for r in port[case]:
        assert r["priced_per_dim"] == pytest.approx(want, rel=1e-12)
    if CASES[case]["pp"] > 1:
        assert want["pp"] > 0


def test_codec_state_order_matches_reference(reference, port):
    """Each rank's ef residual after the last step is the reference's
    slot at its global rank ``(d * pp + s) * tp + t``: the stages'
    residuals differ, so a wrong order shows."""
    want = reference["pp_ef"]["cstate"]
    runs = port["pp_ef"]
    assert set(runs[0]["codec_state"]) == set(want)
    for key, st in want.items():
        glob = np.asarray(st["residual"], np.float64)
        per = glob.shape[0] // len(runs)
        norms = [float((glob[r * per:(r + 1) * per] ** 2).sum())
                 for r in range(len(runs))]
        assert len({round(n, 3) for n in norms}) > 1
        for rank, r in enumerate(runs):
            assert r["coords"] == [rank // 4, rank // 2 % 2, rank % 2]
            np.testing.assert_allclose(r["codec_state"][key]["residual_sq"],
                                       norms[rank], rtol=RESIDUAL_RTOL)


def test_ranks_import_no_reference(port):
    for runs in port.values():
        for r in runs:
            assert r["foreign_modules"] == []


# --------------------------------------------------------------------------
# port-internal
# --------------------------------------------------------------------------

def test_pipeline_matches_flat_microbatched_step(port):
    """The losses agree; the grad norms by a factor of pp, as in the
    reference: its stage fold of the loss is a psum, whose transpose (a
    psum of the replicated cotangent) counts the loss once per stage.
    With the clip binding (every norm here is above 1) the updates agree
    all the same."""
    pp, flat = port["pp_seed"], port["flat_seed"]
    for r in pp:
        np.testing.assert_allclose(r["losses"], flat[0]["losses"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["grad_norms"],
                                   2 * np.asarray(flat[0]["grad_norms"]),
                                   rtol=1e-6)
        assert min(flat[0]["grad_norms"]) > 1.0
    assert pp[0]["bubble"] == pytest.approx(1 / 3)
    assert pp[0]["ticks"] == 3 and flat[0]["ticks"] == 2


def test_remat_full_gradients_bit_equal(port):
    for a, b in zip(port["vpp_full"], port["vpp_none"]):
        assert a["grads0"] == b["grads0"]
        assert a["losses"] == b["losses"]
        assert a["grad_norms"] == b["grad_norms"]
        # the recompute's collectives stay out of the analytic ledger
        assert a["priced_per_dim"] == b["priced_per_dim"]


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
