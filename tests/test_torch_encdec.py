"""The port's encoder-decoder modules (whisper-base's backbone) against the
reference, on a small whisper that keeps its encoder (the reduced config,
d 64, 4 q / 2 kv heads of 16, f32, with ``encdec_groups(2, 2)``: the
reference's own reduced plan drops the encoder, fault C.21), from the same
weights (numpy normals from a seed, in the plan's layout, loaded by both
packages) and numpy inputs from a seed.

Contract asserted here, with the tolerances and their reasons:
  * at tp 2 (head mode) and tp 4 (ring mode: 2 kv heads do not split over
    4), each rank of a gloo world against the reference on as many XLA
    host devices under ``baseline``: the encoder stack and ``enc_norm``
    over the frames, and their positions; cross-attention in training and
    prefill (the output, the prefill cache ``(k, v, k_pos)``, and the
    gradients of a weighted sum with respect to the queries' input and the
    encoder's slice: the backward of ``tp@attn_cross_kv``); the cross
    decode inside the encoder's length and past it (where the head-mode
    scatter drops, as JAX drops it, and a torch index would raise): within
    1e-5 of the largest value (f32; the frameworks order the matmul,
    softmax and gloo sums differently), the positions exactly; the cross
    cache unchanged by the decode;
  * fault C.24: the reference's head-mode cross decode differs from its
    ring mode inside the encoder's length (it scatters the token's own
    projection over one frame and masks the later ones) by more than 1e-2
    of the largest value, and agrees within 1e-5 past it; the port
    mirrors both modes;
  * ``from_jax_params`` carries the reference's whole tree (``enc_norm``,
    ``lnx``, ``xattn``) bit for bit; the full whisper-base plan has the
    reference's leaves, specs and 70,680,576 parameters at tp 1, 2 and 16,
    and ZeRO-3 shards the same leaves over data (``xattn`` as ``attn``);
    its decode and prefill cache layouts are the reference's, ``xk`` /
    ``xv`` / ``xlen`` included;
  * fault C.21: both packages' reduced whisper keeps only ``dec_attn``,
    and its encoder is ``enc_norm`` alone;
  * gradient accumulation (pp 1) encodes each microbatch's frames: two
    microbatches' loss within rtol 1e-6 of the flat loss; a stage mesh
    refuses the encoder;
  * faults C.22 and C.23 and the launchers' refusals: the reference's
    launchers fail for want of ``frames`` (its training launcher with the
    pytree error naming ``frames``, its disaggregated mode with
    ``KeyError: 'frames'``) where the port's feed them; the reference at
    cp 2 gives the encoder's frames zigzag positions that are not theirs
    and another loss (beyond 1e-6), where the port refuses ``--cp``; both
    packages refuse ``--pp`` with the reference's message and paged
    serving with the reference's ``NotImplementedError``.

The reference runs in the subprocess that ``torch_encdec_reference.py``
shares with ``test_torch_encdec_train.py``.
"""

import pickle
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_encdec_reference as R  # noqa: E402

TOL = 1e-5


def _close(got, want, what, tol=TOL):
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= lim, (what, err, lim)


def _part(a, dim: int, t: int, n: int):
    """Shard ``t`` of ``n`` of ``a`` (numpy or torch) along ``dim``."""
    k = a.shape[dim] // n
    if isinstance(a, np.ndarray):
        return np.take(a, range(t * k, (t + 1) * k), axis=dim)
    return a.narrow(dim, t * k, k)


# --------------------------------------------------------------------------
# the port's worlds
# --------------------------------------------------------------------------

def module_rank(*, rank: int, world: int, tree: str) -> dict:
    """Rank ``rank`` of a tp-``world`` mesh: the encoder, the
    cross-attention sublayer of the first decoder layer (forward, prefill
    cache, input gradients) and its decode, on this rank's slices."""
    import torch

    from repro_torch.core import policy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_jax_params
    from repro_torch.models.transformer import layer_slice

    cfg = R.port_cfg()
    mi = make_mesh(1, world)
    model = Model(cfg, mi, device="cpu")
    with open(tree, "rb") as f:
        params = from_jax_params(pickle.load(f), cfg, "cpu", mi)
    inp = {k: torch.from_numpy(v) for k, v in R.module_inputs(
        cfg.d_model, cfg.n_kv_heads, cfg.head_dim_).items()}
    mode = model.mode
    xp = layer_slice(params["groups"][1]["xattn"], 0)
    out = {"mode": mode}
    with policy.use_plan(policy.compile_plan("baseline", mi)):
        with torch.no_grad():
            x, pos = model.encode(params, _part(inp["frames"], 1, rank,
                                                world))
        out.update(encode=x.numpy(), encode_pos=pos.numpy())
        h = _part(inp["h"], 1, rank, world).clone().requires_grad_(True)
        c = _part(inp["cross"], 1, rank, world).clone().requires_grad_(True)
        pos = model._positions(h.shape[0], h.shape[1])
        cpos = model._positions(c.shape[0], c.shape[1])
        o, (k, v, pk) = attention.attn_train(
            xp, h, pos, cfg, mi, mode, causal=False, window=0,
            want_cache=True, cross=c, cross_pos=cpos)
        gh, gc = torch.autograd.grad((o * _part(inp["w"], 1, rank,
                                                world)).sum(), (h, c))
        out.update(xattn_out=o.detach().numpy(), xattn_k=k.detach().numpy(),
                   xattn_v=v.detach().numpy(), xattn_pos=pk.numpy(),
                   xattn_dh=gh.numpy(), xattn_dcross=gc.numpy())
        dim = 2 if mode == "head" else 1      # heads, or the sequence
        ck = _part(inp["xk"], dim, rank, world).contiguous()
        cv = _part(inp["xv"], dim, rank, world).contiguous()
        ln = torch.tensor(R.S_ENC, dtype=torch.int32)
        with torch.no_grad():
            for idx in (R.IDX_LO, R.IDX_HI):
                k0, v0 = ck.clone(), cv.clone()
                y, _ = attention.attn_decode(
                    xp, inp["x1"], {"k": ck, "v": cv, "len": ln}, idx, cfg,
                    mi, mode, cross=True)
                out[f"decode_{idx}"] = y.numpy()
                out[f"kept_{idx}"] = bool(torch.equal(ck, k0)
                                          and torch.equal(cv, v0))
    out["foreign"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "repro"))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import spawn_world

    wait, cleanup = R.start(tmp_path_factory)
    base = tmp_path_factory.mktemp("encdec")
    tree = str(base / "tree.pkl")
    with open(tree, "wb") as f:
        pickle.dump(R.weights(), f)
    try:
        with ThreadPoolExecutor(2) as pool:
            futs = {n: pool.submit(spawn_world, f"{__name__}:module_rank", n,
                                   dict(tree=tree), 600) for n in (2, 4)}
            port = {n: f.result() for n, f in futs.items()}
        yield wait(), port
    finally:
        cleanup()


# --------------------------------------------------------------------------
# modules against the reference
# --------------------------------------------------------------------------

# the reference's global layout of each output: its sharded dim, or None
# (replicated); ring mode's cache is sequence-sharded, head mode's
# head-sharded with its positions replicated
_LAYOUT = {
    "head": {"encode": 1, "encode_pos": 1, "xattn_out": 1, "xattn_dh": 1,
             "xattn_dcross": 1, "xattn_k": 2, "xattn_v": 2,
             "xattn_pos": None},
    "ring": {"encode": 1, "encode_pos": 1, "xattn_out": 1, "xattn_dh": 1,
             "xattn_dcross": 1, "xattn_k": 1, "xattn_v": 1,
             "xattn_pos": 1}}


@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("what", ("encoder", "cross_train_prefill"))
def test_modules_match_reference(what, tp, results):
    ref, port = results
    want = ref["modules"][tp]
    assert want["mode"] == ("head" if tp == 2 else "ring")
    keys = ["encode", "encode_pos"] if what == "encoder" else \
        [k for k in _LAYOUT["head"] if k.startswith("xattn")]
    for r, got in enumerate(port[tp]):
        assert got["mode"] == want["mode"]
        assert got["foreign"] == []
        for k in keys:
            d = _LAYOUT[want["mode"]][k]
            w = want[k] if d is None else _part(want[k], d, r, tp)
            if k.endswith("pos"):
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                _close(got[k], w, (tp, r, k))


@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("idx", (R.IDX_LO, R.IDX_HI))
def test_cross_decode_matches_reference(idx, tp, results):
    ref, port = results
    want = ref["modules"][tp][f"decode_{idx}"]
    for got in port[tp]:
        _close(got[f"decode_{idx}"], want, (tp, idx))
        assert got[f"kept_{idx}"], "the decode wrote the cross cache"


def test_head_mode_cross_decode_differs_inside_encoder_c24(results):
    ref, _ = results
    head, ring = ref["modules"][2], ref["modules"][4]
    lo, hi = f"decode_{R.IDX_LO}", f"decode_{R.IDX_HI}"
    err = np.abs(head[lo] - ring[lo]).max() / np.abs(ring[lo]).max()
    assert err > 1e-2, err
    _close(head[hi], ring[hi], "past the encoder's length")


# --------------------------------------------------------------------------
# plans and weights (in this process, one device)
# --------------------------------------------------------------------------

def test_from_jax_params_carries_the_whole_tree():
    import jax
    import torch

    from repro import configs as jconfigs
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo, Pv
    from repro_torch.models.params import from_jax_params, leaves
    from repro_torch.models.model import Model

    jcfg = R.small(jconfigs.get("whisper-base").reduced())
    jp = JModel(jcfg, JMeshInfo()).init(jax.random.key(3))
    tree = jax.tree.map(lambda pv: np.asarray(pv.v), jp,
                        is_leaf=lambda x: isinstance(x, Pv))
    cfg = R.port_cfg()
    got = from_jax_params(tree, cfg, "cpu")
    assert set(got) >= {"enc_norm", "embed", "final_norm", "groups"}
    assert set(got["groups"][1]) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                     "mlp"}
    want = jax.tree_util.tree_leaves(tree)
    mine = leaves(Model(cfg, device="cpu").plan, got)
    assert len(want) == len(mine)
    for a, (_, t) in zip(want, mine):
        assert torch.equal(t, torch.from_numpy(np.array(a)))


@pytest.mark.parametrize("tp", (1, 2, 16))
def test_full_plan_matches_reference(tp):
    """whisper-base at full width: the reference's leaves, shapes and specs
    (head mode at tp 1 and 2, ring mode at 16), its 70,680,576
    parameters, and ZeRO-3 at dp 2 sharding the same leaves (``xattn``'s
    with ``attn``'s)."""
    from repro import configs as jconfigs
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo, count_params
    import jax

    from repro.models.params import ParamDef
    from repro_torch import configs
    from repro_torch.models.params import MeshInfo, _leaves
    from repro_torch.models.transformer import model_plan

    for fsdp, dp in ((False, 1), (True, 2)):
        jcfg = jconfigs.get("whisper-base").replace(fsdp_params=fsdp)
        cfg = configs.get("whisper-base").replace(fsdp_params=fsdp)
        jplan = JModel(jcfg, JMeshInfo(tp=tp, dp=dp)).plan
        plan = model_plan(cfg, MeshInfo(tp=tp, dp=dp))
        want = [(d.shape, tuple(d.spec)) for d in jax.tree_util.tree_leaves(
            jplan, is_leaf=lambda x: isinstance(x, ParamDef))]
        got = [(d.shape, tuple(d.spec)) for _, d in _leaves(plan)]
        assert got == want, (tp, fsdp)
        assert sum(d.size() for _, d in _leaves(plan)) == \
            count_params(jplan) == 70_680_576
        specs = {"/".join(map(str, p)): tuple(d.spec)
                 for p, d in _leaves(plan)}
        assert {"enc_norm/b", "enc_norm/g"} <= set(specs)
        # ZeRO-3 annotates the cross-attention leaves as it annotates the
        # self-attention's (whisper's are below its size floor: neither
        # shards), and the MLP's over data
        for p, sp in specs.items():
            if "/xattn/" in p:
                assert sp == specs[p.replace("/xattn/", "/attn/")], p
        assert any("data" in sp for sp in specs.values()) == fsdp


@pytest.mark.parametrize("tp", (2, 16))
def test_cache_layouts_match_reference(tp):
    """whisper-base's local decode and prefill layouts (head mode at tp 2,
    ring mode at tp 16; dp 2, batch 4, s_max 64, 32 frames) are the
    reference's global ones divided by their specs: ``None`` for the
    encoder's group, ``xk`` / ``xv`` laid out as ``k`` / ``v`` at the
    frames' length, ``xlen`` [L] int32 replicated."""
    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.serve import kv_cache as jkv
    from repro_torch import configs as tconfigs
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import kv_cache as tkv

    jcfg, tcfg = jconfigs.get("whisper-base"), tconfigs.get("whisper-base")
    jmi, mi = JMeshInfo(tp=tp, dp=2), MeshInfo(tp=tp, dp=2)
    jst, _ = jkv.cache_structs(jcfg, jmi, 4, 64, s_enc=32)
    tst, tsp = tkv.cache_structs(tcfg, mi, 4, 64, s_enc=32)
    assert jst[0] is None and tst[0] is None and tsp[0] is None
    ways = {"data": 2, "model": tp, None: 1}
    jg, tg, sg = jst[1], tst[1], tsp[1]
    assert sorted(jg) == sorted(tg) == ["k", "v", "xk", "xlen", "xv"]
    for k in jg:
        assert tuple(n // ways[s] for n, s in zip(jg[k].shape, sg[k])) \
            == tg[k].shape, (k, jg[k].shape, tg[k].shape)
        assert str(jg[k].dtype) == str(tg[k].dtype).replace("torch.", "")

    def tag(e):
        names = e if isinstance(e, tuple) else (e,)
        return "model" if "model" in names else \
            "data" if "data" in names else None
    want = jkv.prefill_cache_specs(jcfg, jmi, 4)
    got = tkv.prefill_cache_specs(tcfg, mi, 4)
    assert want[0] is None and got[0] is None
    assert got[1] == {k: tuple(tag(e) for e in v) for k, v in
                      want[1].items()}


def test_reduced_whisper_has_no_encoder_layers_c21():
    """The reference's ``reduced()`` keeps only ``dec_attn`` (its
    ``_reduced_groups`` drops ``enc_attn``) while ``encoder_layers`` stays
    2: the port mirrors it, and its encoder is ``enc_norm`` alone."""
    import torch

    from repro import configs as jconfigs
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models.model import Model

    for c in (jconfigs.get("whisper-base").reduced(),
              configs.get("whisper-base").reduced()):
        assert [(g.kind, g.n) for g in c.layer_groups] == [("dec_attn", 2)]
        assert c.encoder_layers == 2
    cfg = configs.get("whisper-base").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(0)
    fr = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        x, pos = model.encode(params, fr)
        assert torch.equal(x, layers.norm(params["enc_norm"], fr, cfg,
                                          model.mi))
    assert torch.equal(pos[0], torch.arange(8, dtype=pos.dtype))


def test_microbatched_loss_encodes_each_microbatch():
    """Gradient accumulation (pp 1) encodes each microbatch's frames, as
    the reference's pipeline does: two microbatches' loss equals the flat
    loss within rtol 1e-6; a stage mesh refuses the encoder with the
    reference's message."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.models.params import MeshInfo
    from repro_torch.train.pipeline import pipeline_loss_fn

    cfg = R.port_cfg()
    model = Model(cfg, device="cpu")
    params = model.init(1)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 8)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 8)),
             "frames": rng.normal(size=(4, 8, cfg.d_model))}
    batch = {k: torch.from_numpy(v.astype(np.float32 if k == "frames"
                                          else np.int32))
             for k, v in batch.items()}
    with torch.no_grad():
        want, _ = model.loss_fn(params, batch)
        got, _, _ = pipeline_loss_fn(model, 2)(params, batch)
        # the frames are read: other frames give another loss
        other = dict(batch, frames=batch["frames"].flip(0))
        moved, _ = model.loss_fn(params, other)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    assert moved.item() != want.item()
    with pytest.raises(ValueError, match="pipeline stages cannot hold"):
        Model(cfg, MeshInfo(pp=2), device="cpu")


def test_truncated_keeps_the_encoder_whole():
    from repro_torch import configs
    cut = configs.get("whisper-base").truncated(2)
    assert [(g.kind, g.n) for g in cut.layer_groups] == [("enc_attn", 6),
                                                          ("dec_attn", 2)]


# --------------------------------------------------------------------------
# launchers: faults C.22 and C.23, refusals
# --------------------------------------------------------------------------

def test_reference_launchers_feed_no_frames_c22(results):
    ref, _ = results
    kind, msg = ref["faults"]["train"]
    assert kind == "ValueError" and "frames" in msg
    assert ref["faults"]["disagg"] == ("KeyError", "'frames'")
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    data = SyntheticCorpus(DataConfig(vocab_size=512, seq_len=8,
                                      global_batch=2, seed=0))
    assert set(data.batch(0)) == {"tokens", "labels"}
    fr = data.frames(3, 64)
    assert fr.shape == (2, 8, 64) and fr.dtype == np.float32
    np.testing.assert_array_equal(fr, np.random.default_rng((0, 3)).normal(
        size=(2, 8, 64)).astype(np.float32))


def test_reference_cp_on_whisper_is_silently_wrong_c23(results):
    ref, _ = results
    f = ref["faults"]
    seq = np.arange(R.SEQ)
    np.testing.assert_array_equal(f[("cp_pos", 1)][0], seq)
    pos2 = f[("cp_pos", 2)][0]          # both cp ranks' positions
    assert pos2.shape == (2 * R.SEQ,)
    assert not np.array_equal(pos2[:R.SEQ], seq)
    assert pos2.max() >= R.SEQ          # positions past the sequence
    a, b = f[("cp", 1)], f[("cp", 2)]
    assert abs(a - b) > 1e-6 * abs(a), (a, b)


def test_train_launcher_refuses_cp_and_pp_on_whisper():
    from repro import configs as jconfigs
    from repro.models import transformer as jtransformer
    from repro_torch.launch import train as tlaunch

    args = tlaunch.parser().parse_args(["--arch", "whisper-base",
                                        "--reduced", "--cp", "2", "--seq",
                                        "32"])
    with pytest.raises(ValueError, match="--cp 2 is refused"):
        tlaunch.check_schedule(args)
    with pytest.raises(ValueError, match="--cp 2 is refused"):
        tlaunch.train_rank(arch="whisper-base", reduced=True, cp=2, world=2,
                           device="cpu", steps=1)
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "whisper-base", "--reduced", "--cp", "2",
                      "--device", "cpu"])
    with pytest.raises(ValueError) as want:
        jtransformer.stage_partition(jconfigs.get("whisper-base"), 2)
    args = tlaunch.parser().parse_args(["--arch", "whisper-base", "--pp",
                                        "2", "--microbatches", "2"])
    with pytest.raises(ValueError) as got:
        tlaunch.check_schedule(args)
    assert str(got.value) == str(want.value)
    assert "pipeline stages cannot hold ['dec_attn', 'enc_attn']" in \
        str(got.value)


def test_paged_serving_refused_as_reference():
    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.serve import paged_kv as jpaged
    from repro_torch import configs as tconfigs
    from repro_torch.launch import serve as tserve
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import paged_kv as tpaged

    for arch_cfg in ("reduced", "full"):
        for tp in (1, 2):
            j = jconfigs.get("whisper-base")
            t = tconfigs.get("whisper-base")
            if arch_cfg == "reduced":
                j, t = j.reduced(), t.reduced()
            with pytest.raises(NotImplementedError) as want:
                jpaged.pool_structs(j, JMeshInfo(tp=tp), 8, 4, "bq8")
            with pytest.raises(NotImplementedError) as got:
                tpaged.pool_structs(t, MeshInfo(tp=tp), 8, 4, "bq8")
            assert str(got.value) == str(want.value)
    args = tserve.parser().parse_args(["--arch", "whisper-base", "--mode",
                                       "paged", "--tp", "2"])
    with pytest.raises(NotImplementedError) as got:
        tserve.check(args)
    assert "needs the dense-cache Server" in str(got.value)
