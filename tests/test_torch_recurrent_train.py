"""The port's recurrent families in training against the reference's, on
``zamba2-1.2b --reduced`` (two mamba layers and the shared attention block)
and ``xlstm-1.3b --reduced`` (an mLSTM and an sLSTM layer), from the
same weights (numpy normals from a seed, in the plan's layout, loaded by
both packages), 2 steps, sequence 32, global batch 4, and the port's
zamba2 checkpoint restored by the reference.

Contract asserted here, with the tolerances and their reasons:
  * both archs at ``--tp 2``, ``--tp 4`` and ``--dp 2 --tp 2``, under
    ``baseline`` and ``zhybrid_16_8``, and xLSTM at ``--tp 4 --tp-nodes
    2`` under ``hier_tpp_8_16`` (the prefix and the transpose two-level:
    ``pp`` and ``ep`` at the inner and outer levels), each a gloo world
    against the reference on as many XLA host devices: losses
    within rtol 1e-5 and grad norms within rtol 1e-5 under ``baseline``
    and 1e-4 under the compressed schemes (the frameworks and gloo sum in
    other orders, and a bq codec can turn an ulp into a quantization
    step), and the first
    step's ledger priced per ``dim/level`` and per site equal byte for
    byte: the state prefix (``pp@ssm_scan``) at every tp, the conv halo
    (``pp@conv_halo``, zamba2), the sLSTM transpose
    (``ep@slstm_transpose``, xLSTM), the class-C tp fold
    (``tp@grad_rep``) and the DP sync (``dp``, ``zero``) where dp > 1.
    tp 4 takes the prefix's two doubling steps and its ``i >= step``
    masking;
  * the sLSTM's fallback (``B_loc % tp != 0``: ``--tp 4``, global batch
    2) all-gathers the sequence at ``tp@slstm_seq`` and sends nothing at
    ``ep@slstm_transpose``, against the reference as above;
  * under ``zhybrid_16_8`` the recurrent sites' priced bytes equal
    ``chip_smoke.rec_reckoned``'s hand count (rtol 1e-12: sums of the
    same products), the reckoning the card run checks its ledger with;
  * checkpoints: zamba2 at ``--dp 2 --tp 2`` under ``zhybrid_16_8``, 2
    steps, a save (the ``shared`` leaves in the params, the class-C
    recurrent leaves in the ZeRO-1 state), a resume and 2 more steps give
    losses and grad norms bit-equal to 4 uninterrupted steps; the
    reference restores the port's step-2 checkpoint, every rank's part of
    the params and the optimizer state bit for bit, says the reference's
    "restored optimizer state at step 2", and its next two losses and
    grad norms agree with the port's within 1e-5 and 1e-4.

The reference runs in four subprocesses side by side (this file
re-invokes itself with ``--reference``), the port's two worlds beside
them; the subprocess that runs zamba2 under ``zhybrid_16_8`` then waits
for the port's checkpoint and restores it with its compiled step.
"""

import json
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
ARCHS = ("zamba2-1.2b", "xlstm-1.3b")
SCHEMES = ("baseline", "zhybrid_16_8")
MESHES = {"tp2": dict(tp=2), "tp4": dict(tp=4), "dp2_tp2": dict(dp=2, tp=2)}
SEQ, GB, STEPS = 32, 4, 2
TOL = {"baseline": (1e-5, 1e-5), "zhybrid_16_8": (1e-5, 1e-4)}
CASES = {f"{a}/{m}/{s}": dict(arch=a, scheme=s, **mesh)
         for a in ARCHS for m, mesh in MESHES.items() for s in SCHEMES}
CASES["xlstm-1.3b/tp4_fallback/zhybrid_16_8"] = dict(
    arch="xlstm-1.3b", scheme="zhybrid_16_8", tp=4, global_batch=2)
# the two-level prefix and transpose (inner and outer codecs)
CASES["xlstm-1.3b/tp4_nodes2/hier_tpp_8_16"] = dict(
    arch="xlstm-1.3b", scheme="hier_tpp_8_16", tp=4, tp_nodes=2)
CKPT = dict(arch="zamba2-1.2b", scheme="zhybrid_16_8", dp=2, tp=2)
REF_PROCS = 4


def _c(c: dict) -> dict:
    return dict(dict(dp=1, tp=1, tp_nodes=1, global_batch=GB), **c)


def weights(arch: str):
    """The global weights both packages start from: each leaf of the
    reduced plan drawn as the reference's init does it (normal * scale,
    zeros, ones), from a numpy seed, as a tree of numpy arrays."""
    from repro_torch import configs
    from repro_torch.models.params import MeshInfo, map_leaves
    from repro_torch.models.transformer import model_plan

    rng = np.random.default_rng(0)

    def draw(d, _):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (rng.standard_normal(d.shape) * d.scale).astype(np.float32)
    return map_leaves(draw, model_plan(configs.get(arch).reduced(),
                                       MeshInfo()))


# --------------------------------------------------------------------------
# the reference, one subprocess per (arch, scheme)
# --------------------------------------------------------------------------

def _reference(args: dict) -> None:
    import jax
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.launch.train import _restore_opt
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import batch_specs, make_trainer

    def is_pv(x):
        return isinstance(x, Pv)

    def host(tree):
        return jax.tree.map(lambda x: np.asarray(x.v if is_pv(x) else x),
                            tree, is_leaf=is_pv)

    out, kept = {}, {}
    for case in args["cases"]:
        c = _c(CASES[case])
        cfg = configs.get(c["arch"]).reduced()
        mesh = make_mesh(c["dp"], c["tp"], tp_nodes=c["tp_nodes"])
        mi = MeshInfo.from_mesh(mesh)
        tr = make_trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                          opt_cfg=AdamConfig(lr=1e-3))
        with open(args["trees"][c["arch"]], "rb") as f:
            tree = pickle.load(f)
        structs = tr.model.structs()
        shard = checkpoint.resharded_specs(structs, mesh)
        params = jax.tree.map(
            lambda st, sh, a: Pv(jax.device_put(a.astype(st.v.dtype), sh.v),
                                 st.spec), structs, shard, tree,
            is_leaf=is_pv)
        ostate, cstate = tr.opt_init(params), tr.init_codec_state()
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ,
                                          global_batch=c["global_batch"],
                                          seed=0))
        bspecs = batch_specs(cfg, mi)

        def run(params, ostate, cstate, steps, tr=tr, mesh=mesh, data=data,
                bspecs=bspecs):
            losses, gnorms, ledger = [], [], None
            for step in steps:
                batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                         for k, v in data.batch(step).items()}
                with comms.record_traffic() as events:
                    params, ostate, cstate, m = tr.step(params, ostate,
                                                        cstate, batch)
                if ledger is None:
                    ledger = roofline.ledger_summary(events, train=True)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            return losses, gnorms, ledger
        losses, gnorms, ledger = run(params, ostate, cstate, range(STEPS))
        out[case] = dict(losses=losses, gnorms=gnorms,
                         per_dim_level=ledger["per_dim_level"],
                         per_site=ledger["per_site"])
        if case == args.get("ckpt_case"):
            kept = dict(tr=tr, mesh=mesh, model=tr.model, run=run)
    if kept:
        # the port's step-2 checkpoint, once its world has written it
        ready = Path(args["ckpt_ready"])
        t0 = time.time()
        while not ready.exists():
            if time.time() - t0 > 600:
                raise TimeoutError("the port's checkpoint did not come")
            time.sleep(0.2)
        tr, mesh, model = kept["tr"], kept["mesh"], kept["model"]
        src = args["ckpt_dir"]
        params, man = checkpoint.restore(
            src, model.structs(), step=2,
            shardings=checkpoint.resharded_specs(model.structs(), mesh))
        import contextlib
        import io
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            ostate = _restore_opt(tr, params, os.path.join(src, "opt"), 2,
                                  mesh, checkpoint)
        out["from_port"] = dict(params=host(params), opt=host(ostate),
                                log=log.getvalue(), step=man["step"])
        losses, gnorms, _ = kept["run"](params, ostate, tr.init_codec_state(),
                                        (2, 3))
        out["from_port"].update(losses=losses, gnorms=gnorms)
    with open(args["out"], "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port's worlds
# --------------------------------------------------------------------------

def host(tree):
    """A tree of tensors (and ints) -> the same tree of numpy arrays."""
    import torch
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def run_cases(*, rank: int, world: int, cases: dict, keep: str = "") -> dict:
    """Each case's ``train_rank`` in turn in this world; the case named
    ``keep`` also returns this rank's params and optimizer state after its
    last step (numpy)."""
    from repro_torch.launch.train import train_rank
    from repro_torch.train.train_step import Trainer

    out, step = {}, Trainer.step
    for case, kw in cases.items():
        kept = {}

        def keep_last(self, *args):
            res = step(self, *args)
            kept["state"] = [host(res[0]), host(res[1])]
            return res
        Trainer.step = keep_last
        try:
            out[case] = train_rank(rank=rank, world=world, **kw)
        finally:
            Trainer.step = step
        if case == keep:
            out[case]["state"] = kept["state"]
    return out


def _kw(c: dict, tree: str, **kw) -> dict:
    c = _c(c)
    return {**dict(arch=c["arch"], reduced=True, dp=c["dp"], tp=c["tp"],
                   tp_nodes=c["tp_nodes"],
                   seq=SEQ, global_batch=c["global_batch"], steps=STEPS,
                   scheme=c["scheme"], lr=1e-3, seed=0, device="cpu",
                   init_from=tree), **kw}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import spawn_world

    base = tmp_path_factory.mktemp("recurrent_train")
    trees = {a: str(base / f"{a}.tree") for a in ARCHS}
    for a in ARCHS:
        with open(trees[a], "wb") as f:
            pickle.dump(weights(a), f)
    ckpt, ckpt_ref = base / "ckpt", base / "ckpt_ref"
    ready = base / "ckpt_ready"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    ckpt_case = "zamba2-1.2b/dp2_tp2/zhybrid_16_8"
    procs = {}
    for i in range(REF_PROCS):
        group = list(CASES)[i::REF_PROCS]
        args = dict(cases=group, out=str(base / f"ref{i}.pkl"), trees=trees)
        if ckpt_case in group:
            args.update(ckpt_case=ckpt_case, ckpt_dir=str(ckpt_ref),
                        ckpt_ready=str(ready))
        procs[i] = (args["out"], subprocess.Popen(
            [sys.executable, __file__, "--reference", json.dumps(args)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    try:
        worlds = {2: {}, 4: {}}
        for k, c in CASES.items():
            worlds[_c(c)["dp"] * c["tp"]][k] = _kw(c, trees[c["arch"]])
        tree = trees[CKPT["arch"]]
        worlds[4].update(
            ck_full=_kw(CKPT, tree, steps=4),
            ck_first=_kw(CKPT, tree, ckpt_dir=str(ckpt), ckpt_every=2),
            ck_resume=_kw(CKPT, tree, ckpt_dir=str(ckpt), ckpt_every=2,
                          resume=True),
            # the reference restores this one (no later step lands there)
            ck_ref=_kw(CKPT, tree, ckpt_dir=str(ckpt_ref)))
        with ThreadPoolExecutor(2) as pool:
            futs = {n: pool.submit(spawn_world, f"{__name__}:run_cases", n,
                                   dict(cases=cases, keep="ck_ref"), 600)
                    for n, cases in worlds.items()}
            per_rank = {n: f.result() for n, f in futs.items()}
        ready.touch()
        port = {k: [r[k] for r in per_rank[n]]
                for n in per_rank for k in worlds[n]}
        ref = {}
        for out, p in procs.values():
            err = p.communicate(timeout=600)[1]
            assert p.returncode == 0, err[-4000:]
            with open(out, "rb") as f:
                ref.update(pickle.load(f))
        yield ref, port
    finally:
        ready.touch()
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_and_ledger_match_reference(case, results):
    ref, port = results
    c, want = _c(CASES[case]), ref[case]
    rl, rg = TOL.get(c["scheme"], TOL["zhybrid_16_8"])
    for r in port[case]:
        assert r["foreign_modules"] == []
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=rl,
                                   err_msg=f"{case} losses")
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"],
                                   rtol=rg, err_msg=f"{case} grad norms")
    got = port[case][0]
    assert _nonzero(got["priced_per_dim_level"]) == \
        _nonzero(want["per_dim_level"])
    sites = _nonzero(got["priced_per_site"])
    assert sites == _nonzero(want["per_site"])
    assert sites["pp@ssm_scan"] > 0 and sites["tp@grad_rep"] > 0
    assert (sites.get("pp@conv_halo", 0) > 0) == (c["arch"] ==
                                                  "zamba2-1.2b")
    fallback = c["global_batch"] // c["dp"] % c["tp"] != 0
    slstm = c["arch"] == "xlstm-1.3b"
    assert (sites.get("ep@slstm_transpose", 0) > 0) == (slstm
                                                        and not fallback)
    assert (sites.get("tp@slstm_seq", 0) > 0) == fallback
    assert (sites.get("dp@zero1_grad", 0) > 0) == (c["dp"] > 1)
    levels = {k.split("/")[1] for k, v in got["priced_per_dim_level"].items()
              if v and k.split("/")[0] in ("pp", "ep")}
    assert levels == ({"inner", "outer"} if c["tp_nodes"] > 1 else {"flat"})


@pytest.mark.parametrize("case", [k for k, c in CASES.items()
                                  if c["scheme"] == "zhybrid_16_8"])
def test_recurrent_sites_priced_as_reckoned(case, results):
    """``chip_smoke.rec_reckoned``, the hand count the card run holds its
    ledger to, prices these runs' recurrent sites as the ledger does."""
    from repro_torch import configs
    from repro_torch.core import codecs
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _, port = results
    c = _c(CASES[case])
    want = chip_smoke.rec_reckoned(
        configs.get(c["arch"]).reduced(),
        c["global_batch"] // c["dp"],
        SEQ // c["tp"], c["tp"], codecs.get("bq16").wire_nbytes_for)
    got = port[case][0]["priced_per_site"]
    for site, v in want.items():
        np.testing.assert_allclose(got.get(site, 0.0), v, rtol=1e-12,
                                   err_msg=site)


def test_resume_continues_bit_for_bit(results):
    _, port = results
    for rf, ra, rb in zip(port["ck_full"], port["ck_first"],
                          port["ck_resume"]):
        assert rb["start"] == 2
        assert ra["losses"] + rb["losses"] == rf["losses"]
        assert ra["grad_norms"] + rb["grad_norms"] == rf["grad_norms"]
        # a stateless scheme: no codec state to restore
        assert rb["restore_log"][:2] == [
            "restored optimizer state at step 2",
            "resumed from step 2 (elastic onto dp=2 tp=2 pp=1)"]


def test_port_checkpoint_restores_into_reference(results):
    """The port's step-2 zamba2 checkpoint in the reference: every rank's
    part of the params (the ``shared`` block's leaves and the recurrent
    ones included) and of the ZeRO-1 optimizer state bit for bit, and the
    trajectory continued within tolerance."""
    from repro_torch.core.comms import Axis
    from repro_torch.launch.train import comm_policy, model_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import (MeshInfo, defs, local_index,
                                           writes_replica)
    from repro_torch.models.transformer import model_plan
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import AdamConfig
    from repro_torch.train.train_step import make_trainer

    ref, port = results
    got = ref["from_port"]
    assert got["step"] == 2
    assert got["log"].splitlines() == ["restored optimizer state at step 2"]
    cfg = model_config(CKPT["arch"], True)
    assert "shared" in got["params"]
    for r, res in enumerate(port["ck_ref"]):
        # rank r's view of the dp 2 x tp 2 mesh (no process groups)
        mi = MeshInfo(tp=2, dp=2, model=Axis("model", 2, r % 2),
                      data=Axis("data", 2, r // 2), world=Axis("world", 4, r))
        params, ostate = res["state"]
        plan = model_plan(cfg, mi)
        for d, a, mine in zip(defs(plan), ck.flatten(got["params"]),
                              ck.flatten(params)):
            if writes_replica(d.spec, mi):
                np.testing.assert_array_equal(
                    np.asarray(a)[local_index(d.shape, d.spec, mi)], mine)
        tr = make_trainer(Model(cfg, mi, device="cpu"),
                          scheme=comm_policy(CKPT["scheme"]),
                          opt_cfg=AdamConfig(lr=1e-3))
        for s, a, mine in zip(ck.flatten(tr.opt_state_shards()),
                              ck.flatten(got["opt"]),
                              ck.flatten({**ostate, "step": np.int32(
                                  ostate["step"])})):
            np.testing.assert_array_equal(np.asarray(a)[s.index], mine)
    want = port["ck_full"][0]
    np.testing.assert_allclose(got["losses"], want["losses"][2:],
                               rtol=TOL["zhybrid_16_8"][0])
    np.testing.assert_allclose(got["gnorms"], want["grad_norms"][2:],
                               rtol=TOL["zhybrid_16_8"][1])


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(json.loads(sys.argv[2]))
