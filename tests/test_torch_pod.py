"""The port's outer data-parallel ``pod`` axis (``--pod``) against the
reference's, on reduced gemma3-1b.

Contract asserted here, with the tolerances of the existing train tests
(``test_torch_train.py``: the frameworks and gloo sum in other orders, and
a bq ring can turn an ulp into one quantization step):
  * ``--pod 2 --dp 2`` under ``zhybrid_16_8``, 3 steps from the shared
    weights: losses within rtol 1e-5, grad norms within rtol 1e-4 of the
    reference's; the first step's ledger priced per ``dim/level`` and per
    site equal byte for byte, and its pod events (``dp@zero1_grad_pod``:
    the all-reduce of the ZeRO-1 chunk over the pods, under the dp codec)
    equal field for field;
  * ``--pod 2 --dp 2`` with ZeRO-3 on (``fsdp_params``, d_model 512, d_ff
    2048: the MLP leaves cross the 1M-element threshold) under
    ``ef_zhybrid_16_4``: the same, and the codec-state slots (one
    ``ef:bq4`` residual at ``dp@zero1_grad_pod`` and one per class-A leaf
    at ``dp@grad_fsdp{i}_pod``) and their payload shapes the reference's.
    ZeRO-3 needs a data axis to shard over, so this mesh has dp 2 beside
    the pods;
  * ``plr8`` on the pod hop (port only): its own factor slot, finite
    losses;
  * ``--pod 2 --dp 2`` against ``--dp 4`` under ``baseline``, port only:
    the same batch split the same four ways, losses within 1e-6;
  * a resume at ``--pod 2 --dp 2`` continues bit for bit: 2 steps and a
    checkpoint, then ``--resume`` for 1 step, equal to the third step of
    the uninterrupted run (loss and grad norm), the pod replicas of every
    leaf written once;
  * ``chip_smoke.pod_reckoned`` (the card's hand count) equals the
    ledger;
  * the launcher accepts ``--pod``, refuses ``--pod 2 --nodes 2`` (the
    reference asserts the two outer data axes exclusive) and still refuses
    ``--host-devices``; the mesh lays the pod outermost.

The reference runs in the subprocess ``torch_pod_reference.py`` starts
(shared with ``test_torch_dryrun.py``); the port's runs in one world of 4
ranks beside it.
"""

import os
import pickle

import numpy as np
import pytest

import torch_pod_reference as R

LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4


def _kwargs(case: str, **extra) -> dict:
    c = R.TRAIN[case]
    return {**dict(arch="gemma3-1b", reduced=True, overrides=c["overrides"],
                   dp=c["dp"], pod=c["pod"], scheme=c["scheme"],
                   steps=R.STEPS, seq=R.SEQ, global_batch=R.GB, lr=1e-3,
                   seed=0, device="cpu"), **extra}


def run_cases(*, rank: int, world: int, cases: dict) -> dict:
    """Every case of ``cases`` in turn in this world, each with the codec
    sites its trainer reads."""
    from repro_torch.launch.train import train_rank
    from repro_torch.train.train_step import Trainer

    sites, slots, init = [], [], Trainer.init_codec_state

    def keep(self):
        sites[:] = [(s.dim, s.name, s.level, tuple(shape))
                    for s, shape, _ in self.codec_sites()]
        slots[:] = sorted(self.codec_state_template())
        return init(self)
    Trainer.init_codec_state = keep
    out = {}
    try:
        for case, kw in cases.items():
            out[case] = train_rank(rank=rank, world=world, **kw)
            out[case]["sites"], out[case]["slots"] = list(sites), list(slots)
    finally:
        Trainer.init_codec_state = init
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import spawn_world

    wait, cleanup = R.start(tmp_path_factory)
    base = tmp_path_factory.mktemp("pod")
    trees = {}
    for case, c in R.TRAIN.items():
        trees[case] = str(base / f"{case}.pkl")
        with open(trees[case], "wb") as f:
            pickle.dump(R.weights(c["overrides"]), f)
    ck = str(base / "ckpt")
    cases = {case: _kwargs(case, init_from=trees[case]) for case in R.TRAIN}
    own = dict(arch="gemma3-1b", reduced=True, scheme="baseline",
               steps=R.STEPS, seq=R.SEQ, global_batch=R.GB, seed=0,
               device="cpu")
    cases["own_pod"] = dict(own, dp=2, pod=2)
    cases["own_dp4"] = dict(own, dp=4)
    cases["own_plr"] = dict(own, dp=2, pod=2, scheme="zhybrid_16_8",
                            codec_for=["dp@zero1_grad*=plr8"])
    cases["half"] = _kwargs("pod_dp", init_from=trees["pod_dp"], steps=2,
                            ckpt_dir=ck, ckpt_every=2)
    cases["resume"] = _kwargs("pod_dp", steps=1, ckpt_dir=ck, resume=True)
    try:
        port = spawn_world(f"{__name__}:run_cases", 4, dict(cases=cases),
                           600)
        yield wait(), {k: [r[k] for r in port] for k in cases}, ck
    finally:
        cleanup()


@pytest.mark.parametrize("case", list(R.TRAIN))
def test_pod_training_matches_reference(case, results):
    ref, port, _ = results
    want = ref["train"][case]
    for r in port[case]:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL, err_msg=case)
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"],
                                   rtol=GNORM_RTOL, err_msg=case)
        assert r["priced_per_dim_level"] == want["per_dim_level"], case
        assert r["priced_per_site"] == want["per_site"], case
        pod = [{k: ev[k] for k in ("op", "tag", "axis", "n", "elems",
                                   "codec_fwd", "codec_bwd")}
               for ev in r["events0"] if "_pod" in ev["tag"]]
        assert pod == want["pod_events"], case
        assert all(np.isfinite(r["losses"]))
    assert want["pod_events"], "the step made no pod hop"


def test_pod_codec_sites_and_slots_match_reference(results):
    """Under ``ef_zhybrid_16_4`` on ZeRO-3 the pod hops carry ef state: the
    chunk's all-reduce and every class-A leaf's pod fold, each its own
    slot, as the reference's trainer enumerates them."""
    ref, port, _ = results
    want = ref["train"]["pod_zero3"]
    for r in port["pod_zero3"]:
        assert r["sites"] == want["sites"]
        assert r["slots"] == want["codec_slots"]
    assert "dp@zero1_grad_pod" in want["codec_slots"]
    assert any(s.startswith("dp@grad_fsdp") and s.endswith("_pod")
               for s in want["codec_slots"])
    # every slot's residual was engaged by the steps
    for k, st in port["pod_zero3"][0]["codec_state"].items():
        assert st["residual_sq"] > 0, k


def test_plr_rides_the_pod_hop(results):
    """``plr8`` on the pod all-reduce (the ``dp@zero1_grad*`` glob names
    it): its own warm factor slot, the low-rank matmul's plain version on
    the path, finite losses."""
    _, port, _ = results
    for r in port["own_plr"]:
        assert "dp@zero1_grad_pod" in r["slots"]
        st = r["codec_state"]["dp@zero1_grad_pod"]
        assert st["rank"] > 0
        assert np.isfinite(r["losses"]).all()
        pod = [ev for ev in r["events0"] if ev["tag"] == "dp@zero1_grad_pod"]
        assert [ev["codec_fwd"] for ev in pod] == ["plr8"]


def test_pod_equals_flat_data_axis_under_baseline(results):
    _, port, _ = results
    for a, b in zip(port["own_pod"], port["own_dp4"]):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
        assert np.isfinite(a["losses"]).all()
    # the pod run's rows: rank r at pod r // 2, data r % 2, batch index r
    assert [r["coords"][0] for r in port["own_pod"]] == [0, 1, 2, 3]


def test_pod_resume_continues_bit_for_bit(results):
    _, port, ck = results
    for full, res in zip(port["pod_dp"], port["resume"]):
        assert res["start"] == 2
        assert res["losses"][0] == full["losses"][2]
        assert res["grad_norms"][0] == full["grad_norms"][2]
    import json
    man = json.load(open(os.path.join(ck, "step_2", "manifest.json")))
    assert man["step"] == 2
    # the pods replicate every leaf and the ZeRO-1 chunks: pod 0 writes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import writes_replica
    for r in range(4):
        mi = make_mesh(2, 1, pod=2, rank=r)
        assert writes_replica((None, "model"), mi) == (r % 2 == 0 and r < 2)


def test_pod_reckoning_holds_on_the_ledger(results):
    """``chip_smoke.pod_reckoned``, the hand count the card run holds its
    priced pod-run bytes to, equals the ledger of the zhybrid_16_8 case
    (its gradient the reduced model's, every leaf whole at tp 1)."""
    import chip_smoke
    from repro_torch.core import codecs
    from repro_torch.models.params import MeshInfo, count_params
    from repro_torch.models.transformer import model_plan

    _, port, _ = results
    n = count_params(model_plan(R.port_cfg(), MeshInfo()))
    want = chip_smoke.pod_reckoned(n, R.TRAIN["pod_dp"]["dp"],
                                   R.TRAIN["pod_dp"]["pod"],
                                   codecs.get("bq8").wire_nbytes_for,
                                   codecs.get("bq16").wire_nbytes_for)
    got = port["pod_dp"][0]["priced_per_site"]
    for site, v in want.items():
        assert got[site] == pytest.approx(v, rel=1e-12), site


def test_launcher_pod_flags():
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_mesh

    ap = tlaunch.parser()
    ok = ap.parse_args(["--arch", "gemma3-1b", "--pod", "2", "--dp", "2"])
    assert tlaunch.unported(ok) == []
    assert tlaunch.node_counts(ok)["nodes"] == 1
    both = ap.parse_args(["--arch", "gemma3-1b", "--pod", "2", "--dp", "4",
                          "--nodes", "2"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        tlaunch.node_counts(both)
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--pod", "2",
                      "--dp", "4", "--nodes", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_mesh(4, 1, nodes=2, pod=2, rank=0)
    hd = ap.parse_args(["--arch", "gemma3-1b", "--host-devices", "8"])
    assert len(tlaunch.unported(hd)) == 1
    # the pod is the outermost axis: rank r of (pod 2, data 2, model 2)
    for r in range(8):
        mi = make_mesh(2, 2, pod=2, rank=r)
        assert (mi.pod_axes.index, mi.dp_axes.index, mi.tp_axes.index) == \
            (r // 4, r // 2 % 2, r % 2)
        assert mi.batch_axes.index == r // 2 and mi.batch_ways == 4
        assert mi.coords["pod"] == r // 4 and mi.world_size == 8
