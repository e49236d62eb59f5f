"""The port's encoder-decoder (whisper-base's backbone) trained and served
against the reference, on the small whisper of ``test_torch_encdec.py``
(the reduced config with ``encdec_groups(2, 2)``) from the same weights.

Contract asserted here, with the tolerances and their reasons:
  * training through ``train_rank`` (the launcher's rank function, which
    feeds ``SyntheticCorpus.frames``) at ``--tp 2`` (head mode), ``--tp
    4`` (ring mode) and ``--dp 2 --tp 2``, under ``baseline`` and
    ``zhybrid_16_8``, 2 steps, sequence 32, global batch 4, each a gloo
    world against the reference's trainer on as many XLA host devices fed
    the same frames: losses within rtol 1e-5 and grad norms within rtol
    1e-5 under ``baseline`` and 1e-4 under ``zhybrid_16_8`` (as
    ``test_torch_recurrent_train.py``: the frameworks and gloo sum in other
    orders, and a bq codec can turn an ulp into a quantization step); the
    first step's ledger priced per ``dim/level`` and per site equal byte
    for byte, ``tp@attn_cross_kv`` (the encoder's gather, head mode) among
    the sites, ``tp@attn_kv`` in its place in ring mode;
  * under ``zhybrid_16_8`` in head mode ``tp@attn_cross_kv``'s priced bytes
    equal ``chip_smoke.encdec_reckoned``'s hand count (rtol 1e-12), the
    reckoning the card run checks its ledger with;
  * serving under ``zhybrid_16_8``, 4 prompts of 8 tokens, 4 generated,
    the frames of the reference's batched launcher: the batched ``Server``
    at tp 2 (head mode) and tp 4 (ring mode) gives the reference's tokens,
    every cache leaf after the prefill (its ``xk`` / ``xv``) and at the end
    (``xk`` / ``xv`` / ``xlen`` too) within 1e-4 of its largest value
    (``test_torch_recurrent_serve.py``'s bound for a bq codec on the TP
    collectives), ``xlen`` exactly, and the prefill's and first decode
    step's ledgers per ``dim/level`` byte for byte; ``DisaggServer`` at
    dp 1 x tp 2 with the handoff under ``bq8`` gives the reference's
    decode-pool tokens, its handoff ledger byte for byte (``xlen`` rides
    uncompressed, outside it) and the decode pool's ``xk`` / ``xv`` within
    one bq8 step (1/127 of the largest value) and ``xlen`` exactly.

The reference runs in the subprocess that ``torch_encdec_reference.py``
shares with ``test_torch_encdec.py``.
"""

import pickle
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_encdec_reference as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"baseline": (1e-5, 1e-5), "zhybrid_16_8": (1e-5, 1e-4)}
BQ_TOL = 1e-4


def jobs(*, rank: int, world: int, train: dict, serve: dict) -> dict:
    from repro_torch.launch.serve import serve_rank
    from repro_torch.launch.train import train_rank

    out = {k: train_rank(rank=rank, world=world, **kw)
           for k, kw in train.items()}
    out.update({k: serve_rank(rank=rank, world=world, **kw)
                for k, kw in serve.items()})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import spawn_world

    wait, cleanup = R.start(tmp_path_factory)
    base = tmp_path_factory.mktemp("encdec_train")
    tree = str(base / "tree.pkl")
    with open(tree, "wb") as f:
        pickle.dump(R.weights(), f)
    worlds = {2: ({}, {}), 4: ({}, {})}
    for case, c in R.TRAIN.items():
        worlds[c["dp"] * c["tp"]][0][case] = dict(
            arch="whisper-base", reduced=True, overrides=R.overrides(),
            dp=c["dp"], tp=c["tp"], seq=R.SEQ, global_batch=R.GB,
            steps=R.STEPS, scheme=c["scheme"], lr=1e-3, seed=0,
            device="cpu", init_from=tree)
    for case, c in R.SERVE.items():
        world = c["tp"] * (2 if c["mode"] == "disagg" else 1)
        worlds[world][1][case] = dict(
            cfg=R.port_cfg(), mode=c["mode"], tp=c["tp"], gen=R.GEN,
            scheme=R.SERVE_SCHEME, seed=R.SERVE_SEED, device="cpu",
            kv_codec=R.KV_CODEC if c["mode"] == "disagg" else "none",
            init_from=tree, prompts=R.serve_prompts(), keep_state=True)
    try:
        with ThreadPoolExecutor(2) as pool:
            futs = {n: pool.submit(spawn_world, f"{__name__}:jobs", n,
                                   dict(train=t, serve=s), 600)
                    for n, (t, s) in worlds.items()}
            port = {}
            for n, (t, s) in worlds.items():
                res = futs[n].result()
                for k in list(t) + list(s):
                    port[k] = [r[k] for r in res]
        yield wait(), port
    finally:
        cleanup()


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


@pytest.mark.parametrize("case", list(R.TRAIN))
def test_trajectory_and_ledger_match_reference(case, results):
    ref, port = results
    c, want = R.TRAIN[case], ref["train"][case]
    rl, rg = TOL[c["scheme"]]
    for r in port[case]:
        assert r["foreign_modules"] == []
        assert all(np.isfinite(r["losses"]))
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=rl,
                                   err_msg=f"{case} losses")
        np.testing.assert_allclose(r["grad_norms"], want["gnorms"], rtol=rg,
                                   err_msg=f"{case} grad norms")
    got = port[case][0]
    assert _nonzero(got["priced_per_dim_level"]) == \
        _nonzero(want["per_dim_level"])
    sites = _nonzero(got["priced_per_site"])
    assert sites == _nonzero(want["per_site"])
    head = c["tp"] == 2
    assert (sites.get("tp@attn_cross_kv", 0) > 0) == head
    assert (sites.get("tp@attn_kv", 0) > 0) == (not head)
    assert (sites.get("dp@zero1_grad", 0) > 0) == (c["dp"] > 1)


@pytest.mark.parametrize("case", [k for k, c in R.TRAIN.items()
                                  if c["scheme"] == "zhybrid_16_8"])
def test_cross_kv_priced_as_reckoned(case, results):
    """``chip_smoke.encdec_reckoned``, the hand count the card run holds its
    ledger to, prices these runs' ``tp@attn_cross_kv`` as the ledger
    does."""
    from repro_torch.core import codecs
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _, port = results
    c = R.TRAIN[case]
    want = chip_smoke.encdec_reckoned(
        R.port_cfg(), R.GB // c["dp"], R.SEQ // c["tp"], c["tp"],
        codecs.get("bq16").wire_nbytes_for)
    got = port[case][0]["priced_per_site"]
    for site, v in want.items():
        np.testing.assert_allclose(got.get(site, 0.0), v, rtol=1e-12,
                                   err_msg=site)
    assert (want["tp@attn_cross_kv"] > 0) == (c["tp"] == 2)


def _part(want, spec, t: int, tp: int):
    """Model rank ``t``'s part of a global array sharded by the port's spec
    tags (one data rank)."""
    idx = []
    for n, s in zip(want.shape, spec):
        k, i = (tp, t) if s == "model" else (1, 0)
        idx.append(slice(i * n // k, (i + 1) * n // k))
    return want[tuple(idx)]


def _check(mine, want, what, tol):
    assert mine.shape == want.shape, what
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(mine, want, err_msg=str(what))
        return
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(mine - want).max())
    assert err <= lim, (what, err, lim)


@pytest.mark.parametrize("case", [k for k, c in R.SERVE.items()
                                  if c["mode"] == "batched"])
def test_batched_server_matches_reference(case, results):
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import kv_cache

    ref, port = results
    c, want, got = R.SERVE[case], ref["serve"][case], port[case]
    cfg, tp = R.port_cfg(), c["tp"]
    mi = MeshInfo(tp=tp)
    specs = {"prefill": kv_cache.prefill_cache_specs(cfg, mi, R.B_SRV),
             "final": kv_cache.cache_structs(cfg, mi, R.B_SRV, R.s_max(tp),
                                             R.S_SRV)[1]}
    for t, res in enumerate(got):
        assert res["foreign_modules"] == []
        np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                      want["tokens"])
        for key in ("prefill", "final"):
            assert want[key][0] is None          # the encoder's group
            g = want[key][1]
            assert set(g) == ({"k", "v", "xk", "xv"} if key == "prefill"
                              else {"k", "v", "xk", "xv", "xlen"})
            for k, w in g.items():
                w = _part(np.asarray(w), specs[key][1][k], t, tp)
                mine = res[key][f"/1/{k}"]
                if k == "xlen":
                    mine = mine.astype(np.int32)
                _check(mine, w, (t, key, k), BQ_TOL)
        assert "/0/k" not in res["final"]
    for phase in ("prefill", "decode"):
        led = got[0]["ledger"][phase]
        assert _nonzero(led["priced"]) == _nonzero(want[f"ledger_{phase}"]), \
            phase


def test_disagg_handoff_matches_reference(results):
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import kv_cache

    ref, port = results
    case = "disagg/tp2"
    want, got = ref["serve"][case], port[case]
    tp = R.SERVE[case]["tp"]
    cfg = R.port_cfg()
    specs = kv_cache.cache_structs(cfg, MeshInfo(tp=tp), R.B_SRV,
                                   R.s_max(tp), R.S_SRV)[1]
    assert want["handoff"][0] is None
    for r, res in enumerate(got):
        assert res["foreign_modules"] == []
        pool, t = r // tp, r % tp
        assert res["pool"] == pool
        led = res["ledger"]["handoff"]
        assert _nonzero(led["priced"]) == _nonzero(want["ledger_handoff"])
        assert {e["tag"].split("@")[0] for e in led["events"]} == {"kv"}
        if pool != 1:
            continue
        np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                      want["tokens"])
        for k, w in want["handoff"][1].items():
            w = _part(np.asarray(w), specs[1][k], t, tp)
            mine = res["handoff"][f"/1/{k}"]
            if k == "xlen":
                mine = mine.astype(np.int32)
                assert (w == R.S_SRV).all()
            _check(mine, w, (r, k), 1 / 127)
