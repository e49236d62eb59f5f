"""The port's ZeRO-3 (``fsdp_params``) against the reference's, on
``qwen2-72b --reduced`` with ``fsdp_params=True, d_model=512, d_ff=2048``
(``tests/multidev/ef_check.py``'s config: each layer's MLP weights cross
the 1M-element threshold, so three leaves per layer shard over data).

Contract asserted here, with the tolerances and their reasons:
  * ``apply_fsdp`` gives every leaf the reference's spec, of that config
    and of the full qwen2-72b plan, on dp x tp meshes (plans only, nothing
    allocated);
  * a world of 4 gloo ranks at ``--dp 2 --tp 2`` under ``zhybrid_16_8``,
    3 steps from the reference's weights, against the reference on 4 XLA
    host devices: losses within rtol 1e-5 and grad norms within rtol 1e-4
    (``test_torch_train.py``'s tolerances for this scheme: the frameworks
    and gloo sum in other orders, and a bq ring turns an ulp into a
    quantization step), and the first step's ledger equal per
    ``dim/level`` and per site, byte for byte, the ``zero`` dim's
    re-gathers (``zero@mlp_w1`` ...) included;
  * the optimizer's two options on the same mesh (bq8 m and v,
    ``grad_buckets=2``), which touch classes B and C only, as in the
    reference: losses and grad norms within the same tolerances for the
    first 2 steps, the third within ``test_torch_train.py``'s bounds for
    bq8 state after its tight steps (1e-2 loss, 0.1 grad norm): bq8 m and
    v turn an ulp into a jump (fault C.6).  Measured on these inputs: the
    first two steps 1e-7 / 3e-7 apart, the third 1.9e-4 / 3.6e-3; the
    same config without ZeRO-3 3.5e-4 / 4.0e-3 at the third, and
    ``grad_buckets=2`` alone 3e-8 / 8e-7 at every step;
  * ``ef:bq4`` on the whole dp dim at ``--dp 4 --nodes 2`` carries one
    ``dp_outer@grad_fsdp{i}`` residual per class-A leaf beside the flat
    slots, the reference's slots exactly, each residual engaged after the
    steps (``ef_check.py``'s assertion), and the losses and grad norms
    within the same tolerances;
  * a ZeRO-3 checkpoint crosses between the packages both ways: the
    reference restores the port's step-2 checkpoint (the ``fsdp`` state
    leaves included) and its next loss and grad norm agree with the
    port's own third step, and the port resumes the reference's step-2
    checkpoint ("restored optimizer state", no fallback) and its next
    loss and grad norm agree with the reference's third step, within the
    same tolerances; the port's checkpoint resumed at ``--dp 4 --tp 1``
    restores the parameters (their ZeRO-3 split changes, their global
    shapes do not) and re-initializes the optimizer state with the
    reference's ``WARNING:`` line.

The reference runs in one subprocess (this file re-invokes itself with
``--reference``), the port's worlds beside it.
"""

import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-72b"
OVERRIDES = dict(fsdp_params=True, d_model=512, d_ff=2048)
SEQ, GB, STEPS = 32, 4, 3
TOL = (1e-5, 1e-4)
EF_RULE = "dp=ef:bq4"                   # the whole dp dim, as ef_check's
TIGHT = 2                   # bq8 optimizer state: steps held at TOL (C.6)


def _jcfg():
    from repro import configs
    return configs.get(ARCH).reduced().replace(**OVERRIDES)


# --------------------------------------------------------------------------
# the reference, in a subprocess on 4 XLA host devices
# --------------------------------------------------------------------------

def _reference(args: dict, group: str) -> None:
    """``main``: the dp 2 x tp 2 trajectory, its checkpoint, and the
    port's checkpoint continued; ``more``: the optimizer's options and the
    ef run on the node mesh.  The two run side by side."""
    import jax
    from jax.sharding import NamedSharding

    from repro.analysis import roofline
    from repro.core import comms, policy
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import Trainer, batch_specs

    cfg = _jcfg()
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=GB, seed=0))
    out = {}

    def trainer(mesh, scheme, **opt):
        return Trainer(Model(cfg, MeshInfo.from_mesh(mesh)), mesh,
                       scheme=scheme, opt_cfg=AdamConfig(lr=1e-3, **opt))

    def run(tr, mesh, params, ostate, cstate, steps, ledger=None):
        bspecs = batch_specs(cfg, tr.model.mi)
        losses, gnorms = [], []
        for step in steps:
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in data.batch(step).items()}
            with comms.record_traffic() as ev:
                params, ostate, cstate, m = tr.step(params, ostate, cstate,
                                                    batch)
            if ledger is not None and not ledger:
                s = roofline.ledger_summary(ev, train=True)
                ledger.update(per_dim_level=s["per_dim_level"],
                              per_site=s["per_site"])
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        return params, ostate, cstate, losses, gnorms

    mesh = make_mesh(2, 2)
    if group == "more":
        # the optimizer's options: bq8 m and v, two grad-sync buckets
        tr = trainer(mesh, "zhybrid_16_8", state_bits=8, grad_buckets=2)
        p, o, c = tr.init_all(jax.random.key(0))
        *_, lo, go = run(tr, mesh, p, o, c, range(STEPS))
        out["options"] = dict(losses=lo, gnorms=go)
        # ef:bq4 on the dp dim at dp 4 over 2 nodes
        nmesh = make_mesh(4, 1, nodes=2)
        tr = trainer(nmesh, policy.as_policy("zhybrid_16_8").with_rules(
            policy.Rule("ef:bq4", dim="dp")))
        p, o, c = tr.init_all(jax.random.key(0))
        p, o, c, ln, gn = run(tr, nmesh, p, o, c, range(STEPS))
        out["ef_nodes"] = dict(
            losses=ln, gnorms=gn, slots=sorted(tr.codec_state_template()),
            residual_max={k: float(np.abs(np.asarray(v["residual"])).max())
                          for k, v in c.items()})
    else:
        # dp 2 x tp 2: 2 steps, the checkpoint, the third step
        tr = trainer(mesh, "zhybrid_16_8")
        params, ostate, cstate = tr.init_all(jax.random.key(0))
        ledger = {}
        params, ostate, cstate, l01, g01 = run(tr, mesh, params, ostate,
                                               cstate, (0, 1), ledger)
        checkpoint.save(args["ref_ckpt"], 2, params)
        checkpoint.save(os.path.join(args["ref_ckpt"], "opt"), 2, ostate)
        *_, l2, g2 = run(tr, mesh, params, ostate, cstate, (2,))
        out["dp_tp"] = dict(losses=l01 + l2, gnorms=g01 + g2, **ledger)
        # the port's step-2 checkpoint: restore, then its third step
        port = Path(args["port_ckpt"])
        t0 = time.monotonic()
        while not (port / "opt" / "step_2" / "manifest.json").exists():
            if time.monotonic() - t0 > 600:
                raise TimeoutError("no checkpoint from the port")
            time.sleep(0.2)
        structs = tr.model.structs()
        params, _ = checkpoint.restore(
            port, structs, step=2,
            shardings=checkpoint.resharded_specs(structs, mesh))
        osh = jax.tree_util.tree_map(
            lambda sp: NamedSharding(mesh, sp), tr.opt_state_specs(),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        ostate, _ = checkpoint.restore(
            port / "opt", jax.eval_shape(tr.opt_init, params), step=2,
            shardings=osh)
        m_abs = [float(np.abs(np.asarray(st["m"])).max())
                 for st in ostate["fsdp"] if st is not None]
        *_, lp, gp = run(tr, mesh, params, ostate, {}, (2,))  # donates them
        out["from_port"] = dict(losses=lp, gnorms=gp, m_abs=m_abs)
    with open(f"{args['out']}.{group}", "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port's worlds
# --------------------------------------------------------------------------

def _train(world: int, **kw) -> list:
    from repro_torch.launch.train import spawn_world
    return spawn_world("repro_torch.launch.train:train_rank", world, dict(
        arch=ARCH, reduced=True, overrides=OVERRIDES, seq=SEQ,
        global_batch=GB, lr=1e-3, seed=0, device="cpu", **kw), timeout=600)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from repro.core import compat
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv

    base = tmp_path_factory.mktemp("zero3")
    args = dict(out=str(base / "ref.pkl"), ref_ckpt=str(base / "ref_ck"),
                port_ckpt=str(base / "port_ck"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--reference", repr(args), group],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for group in ("main", "more")]
    proc = procs[0]
    try:
        # the reference's global weights (the same on every mesh)
        mi = MeshInfo.from_mesh(compat.make_mesh((1, 1), ("data", "model")))
        params = Model(_jcfg(), mi).init(jax.random.key(0))
        tree = str(base / "tree.pkl")
        with open(tree, "wb") as f:
            pickle.dump(jax.tree.map(lambda pv: np.asarray(pv.v), params,
                                     is_leaf=lambda x: isinstance(x, Pv)), f)
        with ThreadPoolExecutor(3) as pool:
            dp_tp = pool.submit(_train, 4, dp=2, tp=2, steps=STEPS,
                                scheme="zhybrid_16_8", init_from=tree,
                                ckpt_dir=args["port_ckpt"], ckpt_every=2)
            ef = pool.submit(_train, 4, dp=4, nodes=2, steps=STEPS,
                             scheme="zhybrid_16_8", codec_for=[EF_RULE],
                             init_from=tree)
            opts = pool.submit(_train, 4, dp=2, tp=2, steps=STEPS,
                               scheme="zhybrid_16_8", init_from=tree,
                               opt_state_bits=8, grad_buckets=2)
            port = {"dp_tp": dp_tp.result(), "ef_nodes": ef.result(),
                    "options": opts.result()}
            # the port's checkpoint, elastically onto dp 4 x tp 1
            elastic = pool.submit(_train, 4, dp=4, tp=1, steps=1,
                                  scheme="zhybrid_16_8",
                                  ckpt_dir=args["port_ckpt"], resume=True)
            # the port resumes the reference's checkpoint once complete
            ref_opt = Path(args["ref_ckpt"]) / "opt" / "latest" / \
                "manifest.json"
            t0 = time.monotonic()
            while not ref_opt.exists():
                assert proc.poll() is None, proc.stderr.read()[-4000:]
                assert time.monotonic() - t0 < 600, "no reference checkpoint"
                time.sleep(0.2)
            port["resume"] = _train(4, dp=2, tp=2, steps=1,
                                    scheme="zhybrid_16_8",
                                    ckpt_dir=args["ref_ckpt"], resume=True)
            port["elastic"] = elastic.result()
        for p in procs:
            err = p.communicate(timeout=600)[1]
            assert p.returncode == 0, err[-4000:]
        ref = {}
        for path in (args["out"] + ".main", args["out"] + ".more"):
            with open(path, "rb") as f:
                ref.update(pickle.load(f))
        yield ref, port
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (4, 2), (8, 1), (3, 2)])
@pytest.mark.parametrize("full", [False, True])
def test_apply_fsdp_specs_match_reference(mesh, full):
    """Every leaf's spec (and shape) of the ZeRO-3 plan equals the
    reference's: the reduced fsdp config, and the full qwen2-72b plan as it
    ships (``fsdp_params=True``), built without allocating."""
    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.models.transformer import model_plan as jplan
    from repro_torch import configs as tconfigs
    from repro_torch.models.params import MeshInfo, defs
    from repro_torch.models.transformer import model_plan as tplan

    import jax

    dp, tp = mesh
    if full:
        jcfg, tcfg = jconfigs.get(ARCH), tconfigs.get(ARCH)
    else:
        jcfg = _jcfg()
        tcfg = tconfigs.get(ARCH).reduced().replace(**OVERRIDES)
    want = [(d.shape, d.spec) for d in jax.tree_util.tree_leaves(
        jplan(jcfg, JMeshInfo(tp=tp, dp=dp)),
        is_leaf=lambda x: hasattr(x, "spec"))]
    got = [(d.shape, d.spec) for d in defs(tplan(tcfg, MeshInfo(tp=tp,
                                                                dp=dp)))]
    assert got == want
    # a dp that divides no free dim of a big leaf shards nothing
    assert any("data" in s for _, s in got) == (dp != 3)


# --------------------------------------------------------------------------
# training against the reference
# --------------------------------------------------------------------------

def _close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL[0],
                               err_msg=f"{what} losses")
    np.testing.assert_allclose(got["grad_norms"], want["gnorms"],
                               rtol=TOL[1], err_msg=f"{what} grad norms")


def test_dp2_tp2_zhybrid_matches_reference(results):
    ref, port = results
    want, got = ref["dp_tp"], port["dp_tp"]
    for r in got:
        assert r["foreign_modules"] == []
        _close(r, want, "dp 2 x tp 2")
    priced = {k: v for k, v in got[0]["priced_per_dim_level"].items() if v}
    assert priced == {k: v for k, v in want["per_dim_level"].items() if v}
    assert priced["zero/flat"] > 0
    sites = {k: v for k, v in got[0]["priced_per_site"].items() if v}
    assert sites == {k: v for k, v in want["per_site"].items() if v}
    # the re-gathers of the three class-A leaves ride the zero dim
    assert {k for k in sites if k.startswith("zero@")} >= {
        "zero@mlp_w1", "zero@mlp_w2", "zero@mlp_w3"}


def test_optimizer_options_match_reference(results):
    """bq8 m and v and two grad-sync buckets: class A keeps its f32 state
    and its own update, as the reference's does."""
    ref, port = results
    want = ref["options"]
    for r in port["options"]:
        _close({"losses": r["losses"][:TIGHT], "grad_norms":
                r["grad_norms"][:TIGHT]},
               {"losses": want["losses"][:TIGHT],
                "gnorms": want["gnorms"][:TIGHT]},
               "state_bits 8, grad_buckets 2")
        np.testing.assert_allclose(r["losses"][TIGHT:],
                                   want["losses"][TIGHT:], rtol=1e-2)
        np.testing.assert_allclose(r["grad_norms"][TIGHT:],
                                   want["gnorms"][TIGHT:], rtol=0.1)


def test_ef_bq4_nodes_carries_one_slot_per_fsdp_leaf(results):
    from repro_torch.launch.train import model_config
    from repro_torch.models.params import MeshInfo, defs
    from repro_torch.models.transformer import model_plan

    ref, port = results
    want, got = ref["ef_nodes"], port["ef_nodes"]
    plan = model_plan(model_config(ARCH, True).replace(**OVERRIDES),
                      MeshInfo(dp=2, node=2))
    n_a = sum("data" in d.spec for d in defs(plan))
    assert n_a == 3
    for r in got:
        _close(r, want, "ef:bq4 dp 4 nodes 2")
        assert sorted(r["codec_state"]) == want["slots"]
        fsdp = [k for k in r["codec_state"] if "grad_fsdp" in k]
        assert len(fsdp) == n_a and all(k.startswith("dp_outer@grad_fsdp")
                                        for k in fsdp)
        for k in fsdp:
            assert r["codec_state"][k]["residual_sq"] > 0, k
    assert all(want["residual_max"][k] > 0 for k in want["slots"]
               if "grad_fsdp" in k)


def test_zero3_checkpoint_crosses_both_ways(results):
    ref, port = results
    # the reference continued the port's checkpoint, the fsdp state leaves
    # restored, and its step agrees with the port's own third step
    fp = ref["from_port"]
    assert len(fp["m_abs"]) == 3 and min(fp["m_abs"]) > 0
    own = port["dp_tp"][0]
    np.testing.assert_allclose(fp["losses"], own["losses"][2:], rtol=TOL[0])
    np.testing.assert_allclose(fp["gnorms"], own["grad_norms"][2:],
                               rtol=TOL[1])
    # the port resumed the reference's checkpoint without a fallback, and
    # its step agrees with the reference's third step
    for r in port["resume"]:
        assert r["start"] == 2
        assert not any(m.startswith("WARNING") for m in r["restore_log"])
        assert "restored optimizer state at step 2" in r["restore_log"]
        np.testing.assert_allclose(r["losses"], ref["dp_tp"]["losses"][2:],
                                   rtol=TOL[0])
        np.testing.assert_allclose(r["grad_norms"],
                                   ref["dp_tp"]["gnorms"][2:], rtol=TOL[1])


def test_zero3_checkpoint_resumes_on_another_dp(results):
    """At dp 4 x tp 1 the class-A leaves split over four data ranks (the
    largest free dim divisible by 4), their global shapes unchanged: the
    parameters restore; the ZeRO-1 chunks change shape, so the optimizer
    state falls back with the reference's line."""
    _, port = results
    last = port["dp_tp"][0]["losses"][-1]
    for r in port["elastic"]:
        assert r["start"] == STEPS
        assert any(m.startswith("WARNING: optimizer state not portable to "
                                "this topology") for m in r["restore_log"])
        assert "resumed from step 3 (elastic onto dp=4 tp=1 pp=1)" in \
            r["restore_log"]
        # the restored parameters on the next batch: near the last loss
        assert np.isfinite(r["losses"]).all()
        assert abs(r["losses"][0] - last) < 0.05 * last


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        import ast
        _reference(ast.literal_eval(sys.argv[2]), sys.argv[3])
