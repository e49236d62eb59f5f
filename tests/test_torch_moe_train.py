"""The port's Mixture-of-Experts training against the reference's, on
``qwen3-moe-235b-a22b --reduced`` (4 experts, top-2) with the reference's
weights (``from_jax_params``), 3 steps, sequence 32, global batch 4.

Contract asserted here, with the tolerances and their reasons:
  * four meshes, each a gloo world of 4 CPU processes against the
    reference on 4 XLA host devices:
      - ``--dp 2 --tp 2`` under ``zhybrid_16_8`` with ZeRO-3
        (``fsdp_params=True`` at ``d_model`` 512 and ``moe_d_ff`` 512, so
        each expert leaf holds 1M elements and shards over data, as
        ``tests/test_torch_zero3.py`` widens qwen2-72b's);
      - ``--tp 4 --tp-nodes 2`` under ``hier_tpp_8_16`` (the two-level
        all-to-all: ``ep`` inner on bq16, outer on bq8; ring attention,
        the reduced config's 2 kv heads at tp 4);
      - ``--cp 2 --tp 2`` under ``zhybrid_16_8`` (head attention);
      - ``--dp 2 --pp 2`` with 2 microbatches (1F1B) under
        ``zhybrid_16_8`` with ZeRO-3 as above: ZeRO-3 on a pipeline mesh,
        and the load-balance term's division by the microbatch count;
    losses within rtol 1e-5 and grad norms within rtol 1e-4
    (``test_torch_train.py``'s and ``test_torch_pipeline.py``'s
    tolerances for this scheme: the frameworks and gloo sum in other
    orders, and a bq ring can turn an ulp into a quantization step; the
    pipelined gradient is ``pp`` times the flat one in both, fault C.13),
    and the first step's ledger priced per ``dim/level`` equal byte for
    byte, its ``ep`` bytes (and on the node mesh ``ep/inner`` and
    ``ep/outer``, and under ZeRO-3 the ``zero`` re-gathers) nonzero;
  * every rank reports a finite, positive ``lb_loss`` and a
    ``drop_frac`` in [0, 1) at every step.

The reference runs in four subprocesses side by side (this file
re-invokes itself with ``--reference``), the port's worlds beside them.
"""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-235b-a22b"
SEQ, GB, STEPS = 32, 4, 3
TOL = (1e-5, 1e-4)
Z3 = dict(fsdp_params=True, d_model=512, moe_d_ff=512)
CASES = {
    "dp_tp_z3": dict(dp=2, tp=2, scheme="zhybrid_16_8", overrides=Z3),
    "tp_nodes": dict(tp=4, tp_nodes=2, scheme="hier_tpp_8_16"),
    "cp_tp": dict(cp=2, tp=2, scheme="zhybrid_16_8"),
    "dp_pp_z3": dict(dp=2, pp=2, microbatches=2, scheme="zhybrid_16_8",
                     overrides=Z3),
}


def _c(c: dict) -> dict:
    return dict(dict(dp=1, tp=1, pp=1, cp=1, tp_nodes=1, microbatches=1,
                     overrides={}), **c)


def _jcfg(c: dict):
    from repro import configs
    return configs.get(ARCH).reduced().replace(**c["overrides"])


# --------------------------------------------------------------------------
# the reference, one subprocess per case on 4 XLA host devices
# --------------------------------------------------------------------------

def _reference(out_path: str, case: str) -> None:
    import jax
    from jax.sharding import NamedSharding

    from repro.analysis import roofline
    from repro.core import comms
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import (batch_specs, make_trainer,
                                        zigzag_shard_seq)

    c = _c(CASES[case])
    cfg = _jcfg(c)
    mesh = make_mesh(c["dp"], c["tp"], tp_nodes=c["tp_nodes"], pp=c["pp"],
                     cp=c["cp"])
    mi = MeshInfo.from_mesh(mesh)
    trainer = make_trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                           opt_cfg=AdamConfig(lr=1e-3),
                           n_micro=c["microbatches"])
    params, ostate, cstate = trainer.init_all(jax.random.key(0))
    tree = jax.tree.map(lambda pv: np.asarray(pv.v), params,
                        is_leaf=lambda x: isinstance(x, Pv))
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=GB, seed=0))
    bspecs = batch_specs(cfg, mi)
    losses, gnorms = [], []
    for step in range(STEPS):
        batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                 for k, v in zigzag_shard_seq(data.batch(step),
                                              c["cp"]).items()}
        with comms.record_traffic() as events:
            params, ostate, cstate, m = trainer.step(params, ostate, cstate,
                                                     batch)
        if step == 0:
            per_dim_level = roofline.ledger_summary(
                events, train=True)["per_dim_level"]
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    with open(out_path, "wb") as f:
        pickle.dump(dict(tree=tree, losses=losses, gnorms=gnorms,
                         per_dim_level=per_dim_level), f)


def _train(case: str, tree: str) -> list:
    from repro_torch.launch.train import spawn_world
    c = _c(CASES[case])
    return spawn_world("repro_torch.launch.train:train_rank", 4, dict(
        arch=ARCH, reduced=True, overrides=c["overrides"], dp=c["dp"],
        tp=c["tp"], pp=c["pp"], cp=c["cp"], tp_nodes=c["tp_nodes"],
        microbatches=c["microbatches"], seq=SEQ, global_batch=GB,
        steps=STEPS, scheme=c["scheme"], lr=1e-3, seed=0, device="cpu",
        init_from=tree), timeout=600)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    base = tmp_path_factory.mktemp("moe_train")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    procs = {case: subprocess.Popen(
        [sys.executable, __file__, "--reference", str(base / case), case],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for case in CASES}
    try:
        ref = {}
        for case, p in procs.items():
            err = p.communicate(timeout=600)[1]
            assert p.returncode == 0, err[-4000:]
            with open(base / case, "rb") as f:
                ref[case] = pickle.load(f)
            with open(base / f"{case}.tree", "wb") as f:
                pickle.dump(ref[case].pop("tree"), f)
        with ThreadPoolExecutor(2) as pool:
            futs = {case: pool.submit(_train, case, str(base / f"{case}.tree"))
                    for case in CASES}
            port = {case: f.result() for case, f in futs.items()}
        yield ref, port
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_reference(case, results):
    ref, port = results
    want, got = ref[case], port[case]
    for r in got:
        assert r["foreign_modules"] == []
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=TOL[0],
                                   err_msg=f"{case} losses")
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"],
                                   rtol=TOL[1], err_msg=f"{case} grad norms")
        assert np.isfinite(r["lb_loss"]).all() and min(r["lb_loss"]) > 0
        assert all(0 <= d < 1 for d in r["drop_frac"])
    priced = {k: v for k, v in got[0]["priced_per_dim_level"].items() if v}
    assert priced == {k: v for k, v in want["per_dim_level"].items() if v}
    c = _c(CASES[case])
    want_ep = ("ep/inner", "ep/outer") if c["tp_nodes"] > 1 else \
        ("ep/flat",) if c["tp"] > 1 else ()
    for k in want_ep:
        assert priced.get(k, 0) > 0, (case, k)
    if c["overrides"].get("fsdp_params"):
        assert priced.get("zero/flat", 0) > 0


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(sys.argv[2], sys.argv[3])
