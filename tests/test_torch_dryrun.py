"""The long-context decode (the cache's sequence over ``("data",
"model")``) and the dry-run on meta tensors (``repro_torch.launch.
dryrun``) against the reference's.

Contract asserted here:
  * reduced gemma3-1b's ``Server(seq_axes=("data", "model"))`` at dp 2 x
    tp 2 (ring mode: each rank holds a quarter of the sequence, the batch
    of one replicated over data), from the reference's global cache
    filled to 56 of 64 positions and carried into each rank's layout
    (``kv_cache.local_cache``), 5 tokens decoded under ``zhybrid_16_8``:
    the tokens equal the reference's ``Server.decode_step``'s, every
    rank's final caches within 1e-4 of the leaf's largest value of its
    shard of the reference's (about three bq16 steps, as
    ``test_torch_serve_mesh.py`` holds a compressed decode), and one
    decode step's ledger priced per ``dim/level`` equal byte for byte
    (the flash-decoding combine over data, then model);
  * ``chip_smoke.long_reckoned`` (the card's hand count) equals the
    ledger;
  * ``run_cell`` on three small cells (gemma3-1b at the reduced widths, 2
    uniform layers): ``train_4k`` on the ``(pod 2, data 2, model 2)``
    mesh, ``prefill_32k`` and ``decode_32k`` on ``(data 2, model 2)``:
    ``params``, ``active_params``, ``tokens``, ``analytic``,
    ``collective`` and ``roofline`` (priced at the reference's peaks)
    equal to the reference's ``run_cell(compile_=False)``, which lowers
    without compiling;
  * the meta trace's ledger equals, event for event, rank 0's ledger of a
    real 4-rank CPU world running the same step (dp 2 x tp 2, and pod 2 x
    dp 2, under ``zhybrid_16_8``);
  * with remat on, ``run_cell`` on the training cell, a MoE cell
    (qwen3-moe at the reduced widths) and a ZeRO-3 cell (gemma3-1b at d
    512, d_ff 2048) equals the reference's, site by site: each layer's
    forward collectives priced twice (the re-run in the backward pass),
    the ep all-to-alls and the zero@ re-gathers among them (C.25,
    repaired);
  * the world's dp 2 x tp 2 step with remat on gives losses and grad
    norms bit-equal to the same step with it off, and its ledger prices
    every dim and site as the reference's lowered remat step does;
  * a meta tensor never reaches a CUDA kernel: the wrappers take the plain
    version on meta (a mix of devices raises), and a traced step with
    ``plr8`` on its DP sync launches nothing even with every launcher made
    to raise;
  * the CLI writes a record the report reads, and refuses the reference's
    XLA-only flags.

The reference runs in the subprocess ``torch_pod_reference.py`` starts
(shared with ``test_torch_pod.py``); the port's world of 4 beside it.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_pod_reference as R

BQ_TOL = 1e-4          # of a cache leaf's largest |value|
TRACE_MESHES = {"dp_tp": dict(dp=2, tp=2), "pod_dp": dict(dp=2, pod=2)}
TRACE_SCHEME = "zhybrid_16_8"
REMAT_STEPS = 2         # the world's steps, remat on and off


def world_jobs(*, rank: int, world: int, tree: str, caches: str) -> dict:
    """This rank's long-context decode from the reference's weights and
    cache, then one real training step on each trace mesh."""
    from repro_torch.launch.serve import serve_rank
    from repro_torch.launch.train import train_rank

    out = {"long": serve_rank(
        rank=rank, world=world, arch="gemma3-1b", reduced=True,
        mode="batched", dp=R.LONG_DP, tp=R.LONG_TP, prompts=[[R.TOK0]],
        gen=R.GEN, max_len=R.S_MAX, fill=R.FILL, caches_from=caches,
        seq_axes=("data", "model"), scheme=R.LONG_SCHEME, init_from=tree,
        device="cpu", keep_state=True)}
    for name, m in TRACE_MESHES.items():
        out[name] = train_rank(rank=rank, world=world, arch="gemma3-1b",
                               reduced=True, steps=REMAT_STEPS, seq=R.SEQ,
                               global_batch=R.GB, scheme=TRACE_SCHEME,
                               device="cpu", **m)
    # the dp_tp step again with remat on (the reduced config's is off)
    out["remat"] = train_rank(
        rank=rank, world=world, arch="gemma3-1b", reduced=True,
        steps=REMAT_STEPS, seq=R.SEQ, global_batch=R.GB,
        scheme=R.REMAT_SCHEME, device="cpu", dp=R.REMAT_DP, tp=R.REMAT_TP,
        overrides={"remat": True})
    return {k: v if k == "long" else {
        key: v[key] for key in ("events0", "losses", "grad_norms",
                                "priced_per_dim", "priced_per_dim_level",
                                "priced_per_site")}
        for k, v in out.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import spawn_world

    wait, cleanup = R.start(tmp_path_factory)
    base = tmp_path_factory.mktemp("dryrun")
    tree, caches = str(base / "tree.pkl"), str(base / "caches.pkl")
    with open(tree, "wb") as f:
        pickle.dump(R.weights(), f)
    with open(caches, "wb") as f:
        pickle.dump(R.long_caches(), f)
    try:
        port = spawn_world(f"{__name__}:world_jobs", 4,
                           dict(tree=tree, caches=caches), 600)
        yield wait(), port
    finally:
        cleanup()


def test_long_context_decode_matches_reference(results):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import kv_cache

    ref, port = results
    want = ref["long"]
    cfg = R.port_cfg()
    for r, res in enumerate(port):
        got = res["long"]
        assert got["foreign_modules"] == []
        np.testing.assert_array_equal(np.asarray(got["tokens"]),
                                      want["tokens"])
        assert got["ledger"]["decode"]["priced"] == want["ledger"]
        mi = make_mesh(R.LONG_DP, R.LONG_TP, rank=r)
        _, specs = kv_cache.cache_structs(cfg, mi, 1, R.S_MAX,
                                          seq_axes=("data", "model"))
        local = kv_cache.local_cache(want["final"], specs, mi)
        for gi, c in enumerate(local):
            for k, w in c.items():
                g = got["final"][f"/{gi}/{k}"]
                assert g.shape == w.shape == (
                    w.shape[0], 1, R.S_MAX // 4, cfg.n_kv_heads,
                    cfg.head_dim_), (gi, k)
                lim = BQ_TOL * float(np.abs(w).max())
                assert np.abs(g - w).max() <= lim, (r, gi, k)
    # the combine ran over both axes: tp@attn_combine priced on both
    assert want["ledger"]["tp/flat"] > 0
    assert want["specs"][0]["k"][2] == ("data", "model")


def test_long_reckoning_holds_on_the_ledger(results):
    """``chip_smoke.long_reckoned``, the hand count the card run holds the
    combine's priced bytes to, equals a decode step's ledger."""
    import chip_smoke
    from repro_torch.analysis import roofline
    from repro_torch.core import codecs

    _, port = results
    want = chip_smoke.long_reckoned(R.port_cfg(), R.LONG_DP, R.LONG_TP,
                                    codecs.get("bq16").wire_nbytes_for)
    ev = port[0]["long"]["ledger"]["decode"]["events"]
    got = roofline.ledger_summary(ev, train=False)["per_site"]
    assert got["tp@attn_combine"] == pytest.approx(
        want["tp@attn_combine"], rel=1e-12)


def test_local_cache_carries_the_long_layout():
    """Each rank's shard of a (data, model) cache is positions ``[(d * tp
    + t) * S / 4, ...)``, the reference's linearization."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import shard_index
    from repro_torch.serve import kv_cache

    cfg = R.port_cfg()
    glob = R.long_caches()
    for r in range(4):
        mi = make_mesh(2, 2, rank=r)
        _, specs = kv_cache.cache_structs(cfg, mi, 1, R.S_MAX,
                                          seq_axes=("data", "model"))
        loc = kv_cache.local_cache(glob, specs, mi)
        idx = shard_index((mi.dp_axes, mi.tp_axes))
        assert idx == (r // 2) * 2 + r % 2
        w = R.S_MAX // 4
        np.testing.assert_array_equal(loc[0]["k"],
                                      glob[0]["k"][:, :, idx * w:(idx + 1) * w])


@pytest.mark.parametrize("shape", list(R.CELLS))
def test_run_cell_matches_reference(shape, results):
    from repro.analysis import roofline as jrl
    from repro_torch.launch import dryrun

    ref, _ = results
    want = ref["cells"][shape]
    assert want["status"] == "lowered"
    got = dryrun.run_cell("gemma3-1b", shape, False, R.CELL_SCHEME,
                          cfg_overrides=dict(R.SMALL),
                          mesh_override=R.CELLS[shape],
                          peaks=dict(peak_flops=jrl.PEAK_FLOPS,
                                     hbm_bytes_per_s=jrl.HBM_BW,
                                     link_bytes_per_s=jrl.ICI_BW))
    assert got["status"] == "traced", got.get("trace")
    for key in ("params", "active_params", "tokens", "analytic",
                "collective", "roofline", "chips"):
        assert got[key] == want[key], key
    assert got["traced"]["flops"] > 0 and got["traced"]["bytes"] > 0
    assert got["memory"]["peak_live_bytes"] >= \
        got["memory"]["argument_bytes"] > 0
    assert sum(got["collectives"].values()) == got["n_events"]


def test_remat_prices_the_forward_twice_in_the_reference_c25(results):
    """ROADMAP C.25, repaired: the port's training cell with remat on
    rematerializes its layers as the reference's layer scan does, so its
    ledger marks their forward collectives and prices each twice, site
    for site as the reference's; with remat off the layers' sites price
    less and the ZeRO-1 sync, outside the layers, the same."""
    from repro_torch.launch import dryrun

    ref, _ = results
    cells = {r: dryrun.run_cell("gemma3-1b", "train_4k", False,
                                R.CELL_SCHEME,
                                cfg_overrides=dict(R.SMALL, remat=r),
                                mesh_override=R.CELLS["train_4k"])
             for r in (False, True)}
    want = ref["remat"]["train_4k"]
    for key in ("params", "active_params", "tokens", "analytic",
                "collective"):
        assert cells[True][key] == want[key], key
    on = cells[True]["collective"]["per_site"]
    off = cells[False]["collective"]["per_site"]
    # a TP gather priced forward, re-run forward and backward, against
    # forward and backward
    assert on["tp@attn_kv"] == pytest.approx(1.5 * off["tp@attn_kv"])
    assert on["dp@zero1_grad"] == off["dp@zero1_grad"]


@pytest.mark.parametrize("cell", ["moe", "zero3"])
def test_remat_cell_matches_reference(cell, results):
    from repro_torch.launch import dryrun
    from repro_torch.models.config import moe_groups

    ref, _ = results
    arch, _, mesh = R.REMAT_CELLS[cell]
    got = dryrun.run_cell(arch, "train_4k", False, R.CELL_SCHEME,
                          cfg_overrides=R.remat_overrides(cell, moe_groups),
                          mesh_override=mesh)
    assert got["status"] == "traced", got.get("trace")
    want = ref["remat"][cell]
    for key in ("params", "active_params", "tokens", "analytic",
                "collective"):
        assert got[key] == want[key], key
    sites = got["collective"]["per_site"]
    inner = ("ep@moe_dispatch", "ep@moe_combine") if cell == "moe" \
        else ("zero@mlp_w1", "zero@mlp_w2", "zero@mlp_w3")
    assert all(sites[s] > 0 for s in inner)


def test_remat_step_bit_equal_and_priced_as_reference(results):
    """The world's dp 2 x tp 2 step with remat on: losses and grad norms
    bit-equal to the step without it on every rank, and rank 0's ledger
    priced per dim, ``dim/level`` and site as the reference's remat
    step."""
    ref, port = results
    for res in port:
        on, off = res["remat"], res["dp_tp"]
        assert on["losses"] == off["losses"]
        assert on["grad_norms"] == off["grad_norms"]
    want, got = ref["remat_step"], port[0]["remat"]
    assert got["priced_per_dim"] == want["per_dim"]
    assert got["priced_per_dim_level"] == want["per_dim_level"]
    assert got["priced_per_site"] == want["per_site"]
    off = port[0]["dp_tp"]["priced_per_site"]
    assert got["priced_per_site"]["tp@mlp_in"] == pytest.approx(
        1.5 * off["tp@mlp_in"])


@pytest.mark.parametrize("mesh", list(TRACE_MESHES))
def test_meta_ledger_equals_real_rank0(mesh, results):
    from repro_torch.launch import dryrun, specs as speclib
    from repro_torch.launch.mesh import make_mesh

    _, port = results
    m = TRACE_MESHES[mesh]
    mi = make_mesh(m["dp"], m.get("tp", 1), pod=m.get("pod", 1), rank=0)
    batch = speclib.axis_names(mi.batch_axes)
    tok = speclib.Spec((R.GB, R.SEQ), torch.int32)
    spec = dict(kind="train", inputs={"tokens": tok, "labels": tok},
                specs={"tokens": (batch, None), "labels": (batch, None)},
                meta=dict(seq=R.SEQ, batch=R.GB))
    tr = dryrun.trace_cell(R.port_cfg(), mi, TRACE_SCHEME, "train_4k",
                           spec=spec)
    real = port[0][mesh]["events0"]
    assert len(tr["events"]) == len(real) > 0
    for a, b in zip(tr["events"], real):
        assert a == b


def test_meta_never_reaches_a_cuda_kernel(monkeypatch):
    from repro_torch.kernels import bq, lowrank
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import comm_policy

    meta = torch.empty((8, 128), device="meta")
    hi, lo, sc = bq.bq_encode(meta, 8)
    assert hi.device.type == "meta" and hi.shape == (8, 128)
    assert bq.bq_decode(hi, lo, sc, 8).shape == (8, 128)
    assert lowrank.matmul(meta, torch.empty((128, 4), device="meta")) \
        .shape == (8, 4)
    with pytest.raises(ValueError, match="all-meta"):
        bq.bq_decode_add(hi, lo, sc, torch.zeros((8, 128)), 8)
    with pytest.raises(ValueError, match="all-meta"):
        lowrank.matmul(meta, torch.zeros((128, 4)))

    def no_launch(*a, **k):
        raise AssertionError("a kernel was launched")
    monkeypatch.setattr(bq, "_launch", no_launch)
    monkeypatch.setattr(lowrank, "_launch", no_launch)
    monkeypatch.setattr(bq, "_load", no_launch)
    bq.reset_launches()
    lowrank.reset_launches()
    mi = make_mesh(2, 2, rank=1)
    tok = dryrun.speclib.Spec((R.GB, R.SEQ), torch.int32)
    batch = dryrun.speclib.axis_names(mi.batch_axes)
    spec = dict(kind="train", inputs={"tokens": tok, "labels": tok},
                specs={"tokens": (batch, None), "labels": (batch, None)},
                meta=dict(seq=R.SEQ, batch=R.GB))
    pol = comm_policy("zhybrid_16_8", ["dp@zero1_grad*=plr8"])
    tr = dryrun.trace_cell(R.port_cfg(), mi, pol, "train_4k", spec=spec)
    assert any(ev["codec_fwd"] == "plr8" for ev in tr["events"])
    assert not any(bq.LAUNCHES.values()) and \
        not any(lowrank.LAUNCHES.values())


def test_dryrun_cli_and_report(tmp_path, capsys):
    from repro_torch.analysis import report
    from repro_torch.launch import dryrun

    for flag in ("--no-compile", "--refresh"):
        with pytest.raises(SystemExit):
            dryrun.main(["--all", flag, "--out-dir", str(tmp_path)])
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
                 "2,2", "--tag", "t", "--out-dir", str(tmp_path)])
    dryrun.main(["--arch", "qwen2-72b", "--shape", "long_500k", "--tag",
                 "t", "--out-dir", str(tmp_path)])
    recs = report.load_all(tmp_path, "t", "zhybrid_16_8")
    assert recs[("gemma3-1b", "decode_32k")]["status"] == "traced"
    assert recs[("qwen2-72b", "long_500k")]["status"] == "skipped"
    assert "| gemma3-1b | decode_32k | traced |" in report.dryrun_table(recs)
    assert "*skipped*" in report.roofline_table(recs)
    assert "[skip] qwen2-72b" in capsys.readouterr().out
