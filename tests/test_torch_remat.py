"""The rematerialized layer groups (``cfg.remat``: the reference's
``jax.checkpoint`` around its layer scan) on one process, against the
reference's pricing and the port's own step without remat.

Contract asserted here:
  * ``roofline.event_bytes`` prices hand-built events (all-gather,
    reduce-scatter, all-reduce, ppermute, all-to-all) as the reference's
    does, with ``remat`` on and off, in training and not: a remat event's
    forward twice in training;
  * on one rank, reduced gemma3-1b, zamba2, qwen3-moe, xLSTM and whisper
    train a step with remat on and off to bit-equal losses, grad norms
    and parameters, and with remat autograd saves fewer bytes for the
    backward (``torch.autograd.graph.saved_tensors_hooks`` outside the
    checkpoints: what stays alive between the forward and the backward);
  * zamba2's shared block is never checkpointed and its events carry no
    ``remat``, as the reference's shared branch returns before its
    ``jax.checkpoint``; the mamba layers' are checkpointed and marked;
  * the pipeline's tick-level checkpoint (``--remat-policy full``) nests
    the per-layer checkpoints: gradient accumulation over two
    microbatches gives the same gradients with ``cfg.remat`` on and off;
  * ``chip_smoke``'s hand counts of the in-layer sites (``rec_reckoned``,
    ``encdec_reckoned`` and ``moe_ep_reckoned``, which the card run holds
    its ledger to) price remat as the ledger of a step traced on meta
    tensors does: reduced zamba2, xLSTM and whisper at dp 2 x tp 2 with
    remat on, and phase 14's qwen3-moe at its own size.

Everything runs in this process (no world, no reference subprocess).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import roofline as jrl

from repro_torch import configs
from repro_torch.analysis import roofline as rl
from repro_torch.core import codecs, comms
from repro_torch.models.model import Model
from repro_torch.models.params import MeshInfo, leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma3-1b", "zamba2-1.2b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
         "whisper-base")
SEQ, GB = 16, 2


def _events(remat: bool) -> list:
    mk = dict(mult=1, remat=remat, bidir=False, level="flat",
              dtype="bfloat16")
    return [dict(mk, op="all_gather", tag="tp@mlp_in", axis="model", n=2,
                 elems=1 << 18, codec_fwd="bq16", codec_bwd="bq16",
                 bwd_op="reduce_scatter"),
            dict(mk, op="reduce_scatter", tag="tp@mlp_out", axis="model",
                 n=4, elems=(1 << 19) + 37, codec_fwd="bq16",
                 codec_bwd="bq8", bwd_op="all_gather"),
            dict(mk, op="all_gather", tag="zero@mlp_w1", axis="data", n=2,
                 elems=5 << 16, codec_fwd="bq16", codec_bwd="none",
                 bwd_op="reduce_scatter", mult=3),
            dict(mk, op="ppermute", tag="pp@ssm_scan", axis="model", n=4,
                 elems=4096, codec_fwd="bq16", codec_bwd="bq16",
                 bwd_op="ppermute"),
            dict(mk, op="all_to_all", tag="ep@moe_dispatch", axis="model",
                 n=2, elems=1 << 16, codec_fwd="bq16", codec_bwd="bq16",
                 bwd_op="all_to_all"),
            dict(mk, op="all_reduce", tag="tp@attn_combine", axis="model",
                 n=2, elems=999, codec_fwd="none", codec_bwd="none",
                 bwd_op="all_reduce", dtype="float32")]


@pytest.mark.parametrize("remat", [False, True])
def test_event_bytes_prices_remat_as_reference(remat):
    for ev in _events(remat):
        for train in (True, False):
            got, want = rl.event_bytes(ev, train), jrl.event_bytes(ev, train)
            assert got == want, (ev["tag"], train)
        plain = rl.event_bytes(dict(ev, remat=False), True)
        twice = 2 if remat else 1
        assert rl.event_bytes(ev, True)["fwd"] == twice * plain["fwd"] > 0
    assert rl.ledger_summary(_events(remat), train=True) == \
        jrl.ledger_summary(_events(remat), train=True)


def _step(arch: str, remat: bool) -> dict:
    """One baseline step of reduced ``arch`` on one rank from seed 0:
    loss, grad norm, the parameters after it, the bytes autograd saved
    for the backward outside the checkpoints."""
    from repro_torch.train.train_step import make_trainer

    cfg = configs.get(arch).reduced().replace(remat=remat)
    model = Model(cfg, MeshInfo(), device="cpu")
    params = model.init(0)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (GB, SEQ), generator=g)
    batch = {"tokens": toks, "labels": toks}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(GB, SEQ, cfg.d_model, generator=g)
    tr = make_trainer(model, scheme="baseline")
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        params, _, _, m = tr.step(params, tr.opt.init(params),
                                  tr.init_codec_state(), batch)
    return {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": [t.clone() for _, t in leaves(model.plan, params)],
            "saved": sum(saved.values())}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_bit_equal_and_saves_fewer_bytes(arch):
    on, off = _step(arch, True), _step(arch, False)
    assert on["loss"] == off["loss"] and on["gnorm"] == off["gnorm"]
    assert all(torch.equal(a, b) for a, b in zip(on["params"],
                                                 off["params"]))
    assert 0 < on["saved"] < off["saved"]


def test_shared_block_is_not_checkpointed(monkeypatch):
    from repro_torch.launch import dryrun, specs as speclib
    from repro_torch.launch.mesh import make_mesh

    real, kinds = comms.checkpointed, []

    def counting(fn):
        ck = real(fn)

        def run(*args):
            kinds.append(args[0])
            return ck(*args)
        return run
    monkeypatch.setattr(comms, "checkpointed", counting)
    cfg = configs.get("zamba2-1.2b").reduced().replace(remat=True)
    mi = make_mesh(1, 2, rank=0)
    tok = speclib.Spec((GB, SEQ), torch.int32)
    spec = dict(kind="train", inputs={"tokens": tok, "labels": tok},
                specs={"tokens": (None, None), "labels": (None, None)},
                meta=dict(seq=SEQ, batch=GB))
    ev = dryrun.trace_cell(cfg, mi, "zhybrid_16_8", "train_4k",
                           spec=spec)["events"]
    n_mamba = sum(g.n for g in cfg.layer_groups if g.kind == "mamba")
    assert kinds == ["mamba"] * n_mamba
    shared = [e for e in ev if e["tag"].startswith("tp@attn")]
    mamba = [e for e in ev if e["tag"] in ("pp@ssm_scan", "pp@conv_halo")]
    assert shared and mamba
    assert not any(e["remat"] for e in shared)
    assert all(e["remat"] for e in mamba)


def test_pipeline_remat_policy_nests_the_layer_checkpoints(monkeypatch):
    from repro_torch.train.train_step import make_trainer

    real, bodies = comms.checkpointed, []

    def counting(fn):
        ck = real(fn)

        def run(*args):
            bodies.append(getattr(fn, "__name__", ""))
            return ck(*args)
        return run
    monkeypatch.setattr(comms, "checkpointed", counting)
    out = {}
    for remat in (False, True):
        cfg = configs.get("gemma3-1b").reduced().replace(remat=remat)
        model = Model(cfg, MeshInfo(), device="cpu")
        params = model.init(0)
        toks = torch.randint(0, cfg.vocab_size, (4, SEQ),
                             generator=torch.Generator().manual_seed(2))
        tr = make_trainer(model, scheme="baseline", n_micro=2,
                          remat_policy="full")
        ts = [t.requires_grad_(True) for _, t in leaves(model.plan, params)]
        bodies.clear()
        loss, _, grads = tr._loss_and_grads(
            params, {"tokens": toks, "labels": toks}, ts)
        out[remat] = (loss.detach(), grads, sorted(set(bodies)),
                      bodies.count("run_block"))
    # the tick-level checkpoint both ways; the layers' inside it, in the
    # forward and again in its recompute, with remat alone
    assert out[False][2:] == (["run"], 0)
    n = cfg.n_layers * 2
    assert out[True][2:] == (["run", "run_block"], 2 * n)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))


def _trace_sites(cfg, dp: int, tp: int, seq: int, gb: int, scheme: str):
    """Rank 0's priced bytes per site of a training step of ``cfg`` at
    ``dp x tp``, traced on meta tensors."""
    from repro_torch.launch import dryrun, specs as speclib
    from repro_torch.launch.mesh import make_mesh

    mi = make_mesh(dp, tp, rank=0)
    batch = speclib.axis_names(mi.batch_axes)
    tok = speclib.Spec((gb, seq), torch.int32)
    inputs = {"tokens": tok, "labels": tok}
    specs = {"tokens": (batch, None), "labels": (batch, None)}
    if cfg.encoder_layers:
        inputs["frames"] = speclib.Spec((gb, seq, cfg.d_model),
                                        torch.float32)
        specs["frames"] = (batch, speclib.axis_names(mi.tp_axes), None)
    spec = dict(kind="train", inputs=inputs, specs=specs,
                meta=dict(seq=seq, batch=gb))
    tr = dryrun.trace_cell(cfg, mi, scheme, "train_4k", spec=spec)
    return rl.ledger_summary(tr["events"], train=True)["per_site"]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b",
                                  "whisper-base", "qwen3-moe-235b-a22b"])
def test_chip_reckonings_price_remat(arch):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.launch.train import model_config

    wire = codecs.get("bq16").wire_nbytes_for
    if arch == C.MOE_ARCH:
        # phase 14a itself: full width, its depth and expert count
        cfg = model_config(arch, depth=C.MOE_DEPTH).replace(
            n_experts=C.MOE_EXPERTS)
        assert cfg.remat
        got = _trace_sites(cfg, 2, 2, C.SEQ, C.GLOBAL_BATCH, C.MOE_SCHEME)
        want = {"ep": C.moe_ep_reckoned()}
        got = {"ep": got["ep@moe_dispatch"] + got["ep@moe_combine"]}
    else:
        cfg = configs.get(arch).reduced().replace(remat=True)
        dp = tp = 2
        got = _trace_sites(cfg, dp, tp, SEQ, 4, "zhybrid_16_8")
        reckon = C.encdec_reckoned if cfg.encoder_layers else C.rec_reckoned
        want = reckon(cfg, 4 // dp, SEQ // tp, tp, wire)
        off = reckon(cfg.replace(remat=False), 4 // dp, SEQ // tp, tp, wire)
        assert {k: 1.5 * v for k, v in off.items()} == pytest.approx(want)
    assert any(want.values())
    for site, v in want.items():
        np.testing.assert_allclose(got.get(site, 0.0), v, rtol=1e-12,
                                   err_msg=site)
