"""The port's checkpoints (repro_torch.train.checkpoint and the launcher's
``--ckpt-dir`` / ``--ckpt-every`` / ``--resume``) against the reference's,
on ``gemma3-1b --reduced``.

Contract asserted here:
  * ``stage_reshape`` gives the reference's array, or raises its
    ``ValueError`` with the same text, on the reference's own cases;
  * one process: ``save`` / ``restore`` / ``latest_step``, the async save,
    the ``.tmp`` rename and ``latest`` flip and the leaf-count assert, as
    the reference's tests hold them; the same tree saved by either package
    gives byte-equal leaf files and manifests equal as parsed JSON, and
    each package restores the other's bit for bit; a bf16 leaf written by
    the reference (under the descr ``'<V2'``) restores into the port bit
    for bit and the port writes the same bytes, while the reference cannot
    restore its own (ROADMAP C.14);
  * the launcher's resume fallbacks (``_restore_opt``, ``_restore_codec``)
    print the reference's lines, word for word, in the reference's cases;
  * the global layout of every state (parameters, the ZeRO-1 optimizer
    state at 32 and 8 bits, the codec state) equals the reference's,
    leaf for leaf, on dp x tp, dp x pp x tp and interleaved meshes;
  * a world of 4 gloo ranks at dp 2 x tp 2: 2 steps, a save, a resume and
    2 more steps give losses and grad norms bit-equal to 4 uninterrupted
    steps (``ef_zhybrid_16_4``; and ``plr8`` with bq8 m and v); the
    checkpoint the port wrote restores into the reference (one subprocess
    on 4 XLA host devices) bit for bit, rank by rank, and its next two
    losses and grad norms agree with the port's within
    ``test_torch_train.py``'s tolerances for ``zhybrid_16_8`` (1e-5,
    1e-4: frameworks and gloo sum in other orders, a bq ring turns an ulp
    into a quantization step); the reference's checkpoint (and a bq8
    optimizer state it wrote) restores into the port bit for bit against
    ``from_jax_params``, ``opt_state_from_jax`` and
    ``codec_state_from_jax``, and the port continues its trajectory
    within the same tolerances; a pp 1 checkpoint (``--layers 4``)
    restores at dp 1 x pp 2 x tp 2 through ``stage_reshape``, its first
    loss within rtol 1e-6 of the flat run's on the same params (sum
    order), the optimizer state re-initialized exactly where the
    reference's layouts differ.
"""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SEQ, GB = 32, 4
# the trajectory cases' tolerances against the reference (loss, grad norm)
TOL = (1e-5, 1e-4)
PLR8 = ["dp@zero1_grad*=plr8"]
# global layouts held against the reference's (all within 4 devices)
LAYOUTS = {
    "dp2_tp2_ef": dict(dp=2, tp=2, scheme="ef_zhybrid_16_4"),
    "dp2_tp2_plr8_bits8": dict(dp=2, tp=2, scheme="zhybrid_16_8",
                               codec_for=PLR8, bits=8),
    "dp4_tp1_plr8": dict(dp=4, tp=1, scheme="zhybrid_16_8", codec_for=PLR8),
    "l4_dp2_tp2": dict(dp=2, tp=2, layers=4, scheme="baseline"),
    "l4_pp2_tp2": dict(dp=1, tp=2, pp=2, layers=4, microbatches=2,
                       scheme="baseline"),
    "l4_dp2_pp2_ef_bits8_buckets2": dict(dp=2, tp=1, pp=2, layers=4,
                                         microbatches=2,
                                         scheme="ef_zhybrid_16_4", bits=8,
                                         buckets=2),
    "l8_pp2_vpp2_tp2": dict(dp=1, tp=2, pp=2, vpp=2, layers=8,
                            microbatches=2, scheme="zhybrid_16_8"),
}


# --------------------------------------------------------------------------
# the reference, in a subprocess on 4 XLA host devices
# --------------------------------------------------------------------------

def _reference(args: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.core import policy
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.launch.train import _restore_codec, _restore_opt
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

    def trainer_for(c):
        cfg = configs.get("gemma3-1b").reduced()
        if c.get("layers"):
            cfg = cfg.replace(n_layers=c["layers"], groups=())
        mesh = make_mesh(c["dp"], c["tp"], pp=c.get("pp", 1))
        pol = policy.as_policy(c["scheme"])
        for spec in c.get("codec_for", ()):
            pat, _, codec = spec.partition("=")
            dim, _, name = pat.partition("@")
            pol = pol.with_rules(policy.Rule(codec, dim=dim, name=name))
        model = Model(cfg, MeshInfo.from_mesh(mesh), vpp=c.get("vpp", 1))
        tr = make_trainer(model, mesh, scheme=pol, opt_cfg=AdamConfig(
            lr=1e-3, state_bits=c.get("bits", 32),
            grad_buckets=c.get("buckets", 1)),
            n_micro=c.get("microbatches", 1))
        return tr, model, mesh

    def shapes(tree):
        return [(tuple(x.shape), str(x.dtype))
                for x in jax.tree_util.tree_leaves(tree)]

    out = {"layouts": {}}
    for name, c in LAYOUTS.items():
        tr, model, mesh = trainer_for(c)
        structs = model.structs()
        out["layouts"][name] = {
            "params": [(tuple(p.v.shape), str(p.v.dtype), list(p.spec))
                       for p in jax.tree_util.tree_leaves(structs,
                                                          is_leaf=is_pv)],
            "opt": shapes(jax.eval_shape(tr.opt_init, structs)),
            "codec": shapes(tr.codec_structs())}

    ef = dict(dp=2, tp=2, scheme="ef_zhybrid_16_4")
    tr, model, mesh = trainer_for(ef)
    mi = model.mi
    data = SyntheticCorpus(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=SEQ, global_batch=GB, seed=0))
    bspecs = batch_specs(model.cfg, mi)

    def run(params, ostate, cstate, steps):
        losses, gnorms = [], []
        for step in steps:
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in data.batch(step).items()}
            params, ostate, cstate, m = tr.step(params, ostate, cstate, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        return params, ostate, cstate, losses, gnorms

    def save_all(d, step, params, ostate, cstate):
        checkpoint.save(d, step, params)
        checkpoint.save(os.path.join(d, "opt"), step, ostate)
        checkpoint.save(os.path.join(d, "codec"), step, cstate)

    # the port's checkpoint: restore, keep, save again, continue
    src = args["port_ckpt"]
    params, man = checkpoint.restore(
        src, model.structs(),
        shardings=checkpoint.resharded_specs(model.structs(), mesh))
    step = man["step"]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        ostate = _restore_opt(tr, params, os.path.join(src, "opt"), step,
                              mesh, checkpoint)
        cstate = _restore_codec(tr, os.path.join(src, "codec"), step, mesh,
                                checkpoint)
    out["from_port"] = dict(params=host(params), opt=host(ostate),
                            codec=host(cstate), log=log.getvalue())
    save_all(args["resave"], step, params, ostate, cstate)
    *_, losses, gnorms = run(params, ostate, cstate, (step, step + 1))
    out["from_port"].update(losses=losses, gnorms=gnorms)

    # its own run: 2 steps, a checkpoint, 2 more steps
    params, ostate, cstate = tr.init_all(jax.random.key(0))
    params, ostate, cstate, _, _ = run(params, ostate, cstate, (0, 1))
    save_all(args["ref_ckpt"], 2, params, ostate, cstate)
    out["own"] = dict(params=host(params), opt=host(ostate),
                      codec=host(cstate))
    *_, losses, gnorms = run(params, ostate, cstate, (2, 3))
    out["own"].update(losses=losses, gnorms=gnorms)

    # a bq8 optimizer state of every rank (random planes in the global
    # layout) at step 5
    tr8, model8, _ = trainer_for(LAYOUTS["dp2_tp2_plr8_bits8"])
    rng = np.random.default_rng(0)

    def fill(s):
        if s.dtype == jnp.int8:
            return rng.integers(-127, 128, s.shape).astype(np.int8)
        if s.dtype == jnp.int32:
            return np.asarray(7, np.int32)
        return rng.standard_normal(s.shape).astype(np.float32)
    o8 = jax.tree.map(fill, jax.eval_shape(tr8.opt_init, model8.structs()))
    checkpoint.save(args["state8_ckpt"], 5, o8)
    out["state8"] = o8
    with open(args["out"], "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def rank_mesh(dp: int, tp: int, pp: int, r: int):
    """Rank ``r``'s view of a dp x pp x tp mesh, without process groups
    (enough for plans, layouts and restores)."""
    from repro_torch.core.comms import Axis
    from repro_torch.models.params import MeshInfo
    d, s, t = r // (pp * tp), (r // tp) % pp, r % tp
    return MeshInfo(tp=tp, dp=dp, pp=pp, model=Axis("model", tp, t),
                    data=Axis("data", dp, d),
                    stage=Axis("stage", pp, s) if pp > 1 else None,
                    world=Axis("world", dp * pp * tp, r))


def port_trainer(c: dict, mi, cfg=None):
    from repro_torch.launch.train import comm_policy, model_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamConfig
    from repro_torch.train.train_step import make_trainer
    cfg = cfg or model_config("gemma3-1b", True, c.get("layers", 0))
    return make_trainer(
        Model(cfg, mi, device="cpu", vpp=c.get("vpp", 1)),
        scheme=comm_policy(c["scheme"], c.get("codec_for", ())),
        opt_cfg=AdamConfig(lr=1e-3, state_bits=c.get("bits", 32),
                           grad_buckets=c.get("buckets", 1)),
        n_micro=c.get("microbatches", 1))


def _dtype(t) -> str:
    return str(t).replace("torch.", "")


def host(tree):
    """A state tree's tensors as numpy (bf16 as f32), ``None`` kept."""
    import torch
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(torch.float32 if tree.dtype == torch.bfloat16
                                else tree.dtype).numpy().copy()
    return tree


def assert_trees_equal(a, b):
    """Equal structure and bit-equal leaves."""
    import torch
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    else:
        assert a == b


def _files(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*.npy"))}


def _manifest(d: Path) -> dict:
    return json.loads((d / "manifest.json").read_text())


# --------------------------------------------------------------------------
# stage_reshape: the reference's own cases
# --------------------------------------------------------------------------

def _a(shape):
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


RESHAPES = [((2, 3, 4, 5), (6, 4, 5)), ((2, 3, 4, 5), (3, 2, 4, 5)),
            ((6, 4, 5), (2, 3, 4, 5)), ((2, 3, 4, 5), (5, 4, 5)),
            ((2, 3, 4, 5), (2, 3, 5, 4)), ((2, 2, 3, 4), (4, 3, 4)),
            ((2, 2, 3, 4), (12, 4)), ((12, 4), (2, 2, 3, 4)),
            ((2, 2, 3, 4), (2, 6, 4)), ((2, 2, 3, 4), (5, 4)),
            ((2, 2, 2, 3), (4, 2, 3)), ((4, 2, 3), (2, 2, 2, 3)),
            ((2, 2, 2, 3), (5, 3)), ((2, 3, 4), (6, 4)),
            ((2, 3, 4), (2, 3, 4))]


@pytest.mark.parametrize("src,dst", RESHAPES)
def test_stage_reshape_matches_reference(src, dst):
    from repro.train import checkpoint as jck
    from repro_torch.train import checkpoint as tck

    def outcome(mod):
        try:
            return mod.stage_reshape(_a(src), dst)
        except ValueError as e:
            return str(e)
    want, got = outcome(jck), outcome(tck)
    if isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
        assert got.shape == tuple(dst)


# --------------------------------------------------------------------------
# one process: the reference's cases on the port
# --------------------------------------------------------------------------

def test_roundtrip_latest_and_extra(tmp_path):
    import torch
    from repro_torch.train import checkpoint as ck
    tree = {"a": ck.Pv(torch.arange(6.0).reshape(2, 3), (None, "model")),
            "b": torch.ones(4, dtype=torch.int32)}
    ck.save(tmp_path, 3, tree, extra={"note": "x"})
    ck.save(tmp_path, 7, tree)
    assert ck.latest_step(tmp_path) == 7
    like = {"a": ck.Pv(torch.empty(2, 3, device="meta"), (None, "model")),
            "b": torch.empty(4, dtype=torch.int32, device="meta")}
    restored, man = ck.restore(tmp_path, like, step=3)
    assert man["extra"]["note"] == "x"
    assert torch.equal(restored["a"].v, torch.arange(6.0).reshape(2, 3))
    assert restored["a"].spec == (None, "model")
    assert restored["b"].dtype == torch.int32
    assert ck.latest_step(tmp_path / "missing") is None


def test_async_save_renames_and_flips_latest(tmp_path):
    import torch
    from repro_torch.train import checkpoint as ck
    t = ck.save(tmp_path, 1, {"w": ck.Pv(torch.zeros(8), (None,))},
                blocking=False)
    t.join(timeout=30)
    assert not t.thread.is_alive()
    assert ck.latest_step(tmp_path) == 1
    assert not list(tmp_path.glob("*.tmp"))
    assert sorted(p.name for p in (tmp_path / "step_1").iterdir()) == \
        ["leaves", "manifest.json"]
    assert os.readlink(tmp_path / "latest") == "step_1"


def test_leaf_count_mismatch_asserts(tmp_path):
    import torch
    from repro_torch.train import checkpoint as ck
    ck.save(tmp_path, 1, {"w": ck.Pv(torch.zeros(8), (None,))})
    bad = {"w": ck.Pv(torch.empty(8, device="meta"), (None,)),
           "extra": torch.empty(2, device="meta")}
    with pytest.raises(AssertionError, match="checkpoint has 1 leaves, tree "
                                             "has 2"):
        ck.restore(tmp_path, bad)


def test_restore_reshapes_with_the_target_spec(tmp_path):
    import torch
    from repro_torch.train import checkpoint as ck
    vals = torch.arange(24.0).reshape(2, 2, 2, 3)
    ck.save(tmp_path / "p", 1,
            {"g": ck.Pv(vals, (None, "stage", None, None)),
             "e": ck.Pv(torch.ones(4, 4), (None, None))})
    like = {"g": ck.Pv(torch.empty(4, 2, 3, device="meta"),
                       ("stage", None, None)),
            "e": ck.Pv(torch.empty(4, 4, device="meta"), (None, None))}
    out, man = ck.restore(tmp_path / "p", like)
    assert man["step"] == 1
    assert torch.equal(out["g"].v, vals.reshape(4, 2, 3))
    assert out["g"].spec == ("stage", None, None)
    assert out["e"].spec == (None, None)
    with pytest.raises(ValueError) as ei:
        ck.restore(tmp_path / "p", {
            "g": ck.Pv(torch.empty(5, 3, device="meta"), (None, None)),
            "e": ck.Pv(torch.empty(4, 4, device="meta"), (None, None))})
    assert "interleaved (vpp=2, pp=2" in str(ei.value)
    assert "flat (layers=5)" in str(ei.value)


def test_shard_parts_restore_their_slice(tmp_path):
    """A global leaf comes back part by part, each as its target's
    dtype."""
    import torch
    from repro_torch.train import checkpoint as ck
    g = torch.arange(24.0).reshape(4, 6)
    ck.save(tmp_path, 2, {"g": g})
    for r in range(2):
        idx = (slice(0, 4), slice(3 * r, 3 * r + 3))
        out, _ = ck.restore(tmp_path, {"g": ck.Shard((4, 6), idx,
                                                     torch.float64)})
        assert out["g"].dtype == torch.float64
        assert torch.equal(out["g"], g[idx].double())


# --------------------------------------------------------------------------
# one process: the on-disk format, both ways
# --------------------------------------------------------------------------

def _trees():
    """The same tree for each package: a spec'd f32 leaf, an int32 leaf,
    int8 planes, a 0-d int32 and a list with a None."""
    import jax.numpy as jnp
    import torch
    from repro.models.params import Pv as JPv
    from repro_torch.train import checkpoint as ck
    rng = np.random.default_rng(1)
    f = rng.standard_normal((3, 4)).astype(np.float32)
    i = rng.integers(-9, 9, (5,)).astype(np.int32)
    q = rng.integers(-127, 128, (2, 128)).astype(np.int8)
    j = {"w": JPv(jnp.asarray(f), (None, "model")), "i": jnp.asarray(i),
         "m": {"q_hi": jnp.asarray(q), "q_lo": None},
         "step": jnp.asarray(np.int32(4)), "fsdp": [None, None]}
    t = {"w": ck.Pv(torch.from_numpy(f), (None, "model")),
         "i": torch.from_numpy(i), "m": {"q_hi": torch.from_numpy(q),
                                         "q_lo": None},
         "step": torch.tensor(4, dtype=torch.int32), "fsdp": [None, None]}
    return j, t


def test_same_tree_same_files_both_ways(tmp_path):
    import jax
    import torch
    from repro.models.params import Pv as JPv
    from repro.train import checkpoint as jck
    from repro_torch.train import checkpoint as tck
    j, t = _trees()
    jck.save(tmp_path / "ref", 4, j, extra={"k": 1})
    tck.save(tmp_path / "port", 4, t, extra={"k": 1})
    ref, port = tmp_path / "ref" / "step_4", tmp_path / "port" / "step_4"
    assert _files(ref) == _files(port)
    assert _manifest(ref) == _manifest(port)
    # the reference restores the port's files, the port the reference's
    like_j = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          j)
    got_j, _ = jck.restore(tmp_path / "port", like_j)
    np.testing.assert_array_equal(np.asarray(got_j["w"].v),
                                  t["w"].v.numpy())
    np.testing.assert_array_equal(np.asarray(got_j["m"]["q_hi"]),
                                  t["m"]["q_hi"].numpy())
    assert got_j["w"].spec == (None, "model")
    got_t, man = tck.restore(tmp_path / "ref", t)
    assert man["extra"] == {"k": 1}
    assert_trees_equal(tck.unwrap(got_t), tck.unwrap(t))
    assert got_t["w"].spec == (None, "model")
    assert int(got_t["step"]) == 4 and got_t["step"].dtype == torch.int32


def test_bf16_leaf_both_ways_and_reference_fault_c14(tmp_path):
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models.params import Pv as JPv
    from repro.train import checkpoint as jck
    from repro_torch.train import checkpoint as tck
    vals = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    jb = jnp.asarray(vals, jnp.bfloat16)
    tb = torch.from_numpy(vals).to(torch.bfloat16)
    jck.save(tmp_path / "ref", 1, {"w": JPv(jb, (None, "model")), "b": jb})
    tck.save(tmp_path / "port", 1, {"w": tck.Pv(tb, (None, "model")),
                                    "b": tb})
    ref, port = tmp_path / "ref" / "step_1", tmp_path / "port" / "step_1"
    assert b"'descr': '<V2'" in (ref / "leaves" / "1.npy").read_bytes()
    assert _files(ref) == _files(port)
    assert _manifest(ref) == _manifest(port)
    like = {"w": tck.Pv(torch.empty(3, 5, dtype=torch.bfloat16,
                                    device="meta"), (None, "model")),
            "b": torch.empty(3, 5, dtype=torch.bfloat16, device="meta")}
    got, _ = tck.restore(tmp_path / "ref", like)
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"].view(torch.int16), tb.view(torch.int16))
    assert torch.equal(got["w"].v.view(torch.int16), tb.view(torch.int16))
    with pytest.raises(TypeError, match="cannot restore into"):
        tck.restore(tmp_path / "ref",
                    {"w": tck.Pv(torch.empty(3, 5, device="meta"),
                                 (None, "model")),
                     "b": torch.empty(3, 5, device="meta")})
    # C.14: the reference cannot restore its own bf16 leaves
    jlike = {"w": JPv(jax.ShapeDtypeStruct((3, 5), jnp.bfloat16),
                      (None, "model")),
             "b": jax.ShapeDtypeStruct((3, 5), jnp.bfloat16)}
    with pytest.raises(TypeError, match="V2"):
        jck.restore(tmp_path / "ref", jlike)


# --------------------------------------------------------------------------
# one process: the launcher's resume fallbacks, line for line
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fallback():
    """Both packages' trainers on a one-device mesh (the reference's
    test_checkpoint_fallback.py setup: reduced gemma3-1b, vocab 64, ef:bq4
    on the ZeRO-1 grad sync) and their initial states."""
    import jax
    from repro import configs as jconfigs
    from repro.core import policy as jpolicy, schemes as jschemes
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.train.train_step import Trainer as JTrainer
    from repro_torch import configs as tconfigs
    from repro_torch.core import policy as tpolicy, schemes as tschemes
    from repro_torch.models.model import Model as TModel
    from repro_torch.models.params import MeshInfo
    from repro_torch.train.train_step import Trainer as TTrainer

    mesh = make_mesh(1, 1)
    jcfg = jconfigs.get("gemma3-1b").reduced().replace(vocab_size=64)
    tcfg = tconfigs.get("gemma3-1b").reduced().replace(vocab_size=64)
    jef = jschemes.get("zhybrid_16_8").as_policy().with_rules(
        jpolicy.Rule("ef:bq4", dim="dp", name="zero1_grad*"), name="ef_unit")
    tef = tschemes.get("zhybrid_16_8").as_policy().with_rules(
        tpolicy.Rule("ef:bq4", dim="dp", name="zero1_grad*"), name="ef_unit")

    def pair(jc, tc, scheme_j, scheme_t, seed):
        jt = JTrainer(JModel(jc, JMeshInfo.from_mesh(mesh)), mesh,
                      scheme=scheme_j)
        tt = TTrainer(TModel(tc, MeshInfo(), device="cpu"), scheme=scheme_t)
        return {"j": jt, "t": tt, "js": jt.init_all(jax.random.key(seed)),
                "ts": tt.init_all(seed)}
    wide = dict(d_model=128, d_ff=256)
    return {"mesh": mesh,
            "ef": pair(jcfg, tcfg, jef, tef, 0),
            "other": pair(jcfg.replace(**wide), tcfg.replace(**wide), jef,
                          tef, 1),
            "baseline": pair(jcfg, tcfg, "baseline", "baseline", 0)}


def _fallback_case(fb, case, kind, tmp_path):
    """Run the reference's and the port's helper on the same case;
    returns (reference's lines, port's lines, port's result, port's
    trainer and states)."""
    from repro.launch import train as jlaunch
    from repro.train import checkpoint as jck
    from repro_torch.launch import train as tlaunch
    from repro_torch.train import checkpoint as tck
    src = fb["other"] if case == "topology" else \
        fb["baseline"] if case == "stateless" else fb["ef"]
    tgt = fb["baseline"] if case == "stateless" else fb["ef"]
    save_step, want_step = {"nodir": (None, 3), "step": (5, 7),
                            "topology": (4, 4), "happy": (9, 9),
                            "stateless": (None, 3)}[case]
    pick = 1 if kind == "opt" else 2
    outs = {}
    for pkg, ck, launch in (("j", jck, jlaunch), ("t", tck, tlaunch)):
        d = str(tmp_path / pkg / kind) if save_step is not None else ""
        if save_step is not None:
            state = src[f"{pkg}s"][pick]
            if pkg == "t":
                state = (src["t"].opt_state_shards(state) if kind == "opt"
                         else src["t"].codec_state_shards(state))
            ck.save(d, save_step, state)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if pkg == "j" and kind == "opt":
                res = launch._restore_opt(tgt["j"], tgt["js"][0], d,
                                          want_step, fb["mesh"], ck)
            elif pkg == "j":
                res = launch._restore_codec(tgt["j"], d, want_step,
                                            fb["mesh"], ck)
            elif kind == "opt":
                res = launch._restore_opt(tgt["t"], tgt["ts"][0], d,
                                          want_step, ck)
            else:
                res = launch._restore_codec(tgt["t"], d, want_step, ck)
        outs[pkg] = (buf.getvalue().splitlines(), res)
    return outs["j"][0], outs["t"][0], outs["t"][1], tgt


@pytest.mark.parametrize("kind", ["opt", "codec"])
@pytest.mark.parametrize("case", ["nodir", "step", "topology", "happy",
                                  "stateless"])
def test_restore_fallbacks_print_the_reference_lines(fallback, case, kind,
                                                     tmp_path):
    jlines, tlines, got, tgt = _fallback_case(fallback, case, kind, tmp_path)
    assert tlines == jlines
    fresh = tgt["t"].opt.init(tgt["ts"][0]) if kind == "opt" else \
        tgt["t"].init_codec_state()
    saved = tgt["ts"][1] if kind == "opt" else tgt["ts"][2]
    if case == "stateless" and kind == "codec":
        assert got == {} and tlines == []
    elif case in ("happy",):
        assert tlines == [f"restored {'optimizer' if kind == 'opt' else 'codec'}"
                          f" state at step 9"]
        assert_trees_equal(got, saved)
    elif case == "stateless":
        assert tlines[0].startswith("WARNING: no optimizer checkpoint")
        assert_trees_equal(got, fresh)
    else:
        assert len(tlines) == 1 and tlines[0].startswith("WARNING: ")
        assert_trees_equal(got, fresh)


# --------------------------------------------------------------------------
# global layouts against the reference's
# --------------------------------------------------------------------------

def _port_layout(c: dict) -> dict:
    from repro_torch.train import checkpoint as ck
    tr = port_trainer(c, rank_mesh(c["dp"], c["tp"], c.get("pp", 1), 0))
    params = [(tuple(p.v.shape), _dtype(p.v.dtype), list(p.spec))
              for p in ck.flatten(tr.param_shards())]
    opt = [(tuple(s.shape), _dtype(s.dtype))
           for s in ck.flatten(tr.opt_state_shards())]
    codec = [(tuple(s.shape), _dtype(s.dtype))
             for s in ck.flatten(tr.codec_state_shards())]
    return {"params": params, "opt": opt, "codec": codec}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_global_layouts_match_reference(layout, reference):
    assert _port_layout(LAYOUTS[layout]) == reference["layouts"][layout]


def test_every_rank_holds_its_part_once():
    """Over the ranks of a dp x pp x tp mesh the written parts of every
    global leaf tile it exactly once."""
    from repro_torch.train import checkpoint as ck
    c = LAYOUTS["l4_dp2_pp2_ef_bits8_buckets2"]
    cover = None
    for r in range(4):
        tr = port_trainer(c, rank_mesh(2, 1, 2, r))
        leaves = ck.flatten(tr.param_shards()) + [
            ck.Pv(s, ()) for s in ck.flatten(tr.opt_state_shards())
            + ck.flatten(tr.codec_state_shards())]
        if cover is None:
            cover = [np.zeros(p.v.shape, np.int32) for p in leaves]
        for acc, p in zip(cover, leaves):
            if p.v.writes:
                acc[p.v.index] += 1
    for acc in cover:
        assert (acc == 1).all()


# --------------------------------------------------------------------------
# worlds of ranks
# --------------------------------------------------------------------------

def run_cases(*, rank: int, world: int, cases: dict, keep: str = "") -> dict:
    """Each case's ``train_rank`` in turn in this world; the case named
    ``keep`` also returns this rank's state after its last step (numpy)."""
    from repro_torch.launch.train import train_rank
    from repro_torch.train.train_step import Trainer

    out, step = {}, Trainer.step
    for case, kw in cases.items():
        kept = {}

        def keep_last(self, *args):
            res = step(self, *args)
            kept["state"] = [host(res[0]), host(res[1]), host(res[2])]
            return res
        Trainer.step = keep_last
        try:
            out[case] = train_rank(rank=rank, world=world, **kw)
        finally:
            Trainer.step = step
        if case == keep:
            out[case]["state"] = kept["state"]
    return out


def _kw(**kw) -> dict:
    return dict(arch="gemma3-1b", reduced=True, seq=SEQ, global_batch=GB,
                lr=1e-3, seed=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ckpt")
    return {k: base / k for k in ("ef", "ef_ref", "s8", "l4", "resave",
                                  "ref", "state8")}


@pytest.fixture(scope="module")
def port(dirs):
    """The port's runs, in one world of 4 ranks."""
    from repro_torch.launch.train import spawn_world
    ef = dict(dp=2, tp=2, scheme="ef_zhybrid_16_4")
    s8 = dict(dp=2, tp=2, scheme="zhybrid_16_8", codec_for=PLR8,
              opt_state_bits=8)
    l4 = dict(dp=2, tp=2, layers=4, scheme="baseline")
    cases = {
        "ef_full": _kw(**ef, steps=4),
        "ef_first": _kw(**ef, steps=2, ckpt_dir=str(dirs["ef"]),
                        ckpt_every=2),
        "ef_resume": _kw(**ef, steps=2, ckpt_dir=str(dirs["ef"]),
                         ckpt_every=2, resume=True),
        # the reference restores this one (no later step lands there)
        "ef_ref": _kw(**ef, steps=2, ckpt_dir=str(dirs["ef_ref"])),
        "s8_full": _kw(**s8, steps=4),
        "s8_first": _kw(**s8, steps=2, ckpt_dir=str(dirs["s8"])),
        "s8_resume": _kw(**s8, steps=2, ckpt_dir=str(dirs["s8"]),
                         resume=True),
        "l4_full": _kw(**l4, steps=3),
        "l4_first": _kw(**l4, steps=2, ckpt_dir=str(dirs["l4"])),
        "pp2_resume": _kw(dp=1, tp=2, pp=2, layers=4, microbatches=2,
                          scheme="baseline", steps=1,
                          ckpt_dir=str(dirs["l4"]), resume=True),
    }
    per_rank = spawn_world(f"{__name__}:run_cases", 4,
                           dict(cases=cases, keep="ef_ref"), timeout=600)
    return {case: [r[case] for r in per_rank] for case in cases}


@pytest.fixture(scope="module")
def reference(port, dirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    args = {"port_ckpt": str(dirs["ef_ref"]),
            "resave": str(dirs["resave"]),
            "ref_ckpt": str(dirs["ref"]),
            "state8_ckpt": str(dirs["state8"]), "out": str(out)}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--reference",
                           json.dumps(args)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    for key in ("own", "state8"):
        path = out.parent / f"{key}.pkl"
        with open(path, "wb") as f:
            pickle.dump(ref[key], f)
        ref[f"{key}_path"] = str(path)
    return ref


def restore_reference(*, rank: int, world: int, dirs: dict, own: str,
                      state8: str) -> dict:
    """One rank of a 4-rank world: restore the reference's checkpoints and
    hold them against this package's conversions of its global trees,
    then resume its run for 2 steps."""
    import torch
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import from_jax_params
    from repro_torch.train import checkpoint as ck

    mi = make_mesh(2, 2)
    log = []
    tr = port_trainer(LAYOUTS["dp2_tp2_ef"], mi)
    tree, man = ck.restore(dirs["ref"], tr.param_shards())
    params = ck.unwrap(tree)
    ostate = tlaunch._restore_opt(tr, params, os.path.join(dirs["ref"], "opt"),
                                  man["step"], ck, log.append)
    cstate = tlaunch._restore_codec(tr, os.path.join(dirs["ref"], "codec"),
                                    man["step"], ck, log.append)
    with open(own, "rb") as f:
        ref = pickle.load(f)
    assert_trees_equal(params, from_jax_params(ref["params"], tr.model.cfg,
                                               "cpu", mi))
    assert_trees_equal(ostate, tr.opt_state_from_jax(ref["opt"]))
    assert_trees_equal(cstate, tr.codec_state_from_jax(ref["codec"]))
    tr8 = port_trainer(LAYOUTS["dp2_tp2_plr8_bits8"], mi)
    o8 = tlaunch._restore_opt(tr8, params, dirs["state8"], 5, ck, log.append)
    with open(state8, "rb") as f:
        want8 = pickle.load(f)
    assert_trees_equal(o8, tr8.opt_state_from_jax(want8))
    d, t = mi.dp_axes.index, mi.tp_axes.index
    g = t * 2 + d                       # the joint (model, data) chunk
    n = want8["master"].shape[0] // 4
    assert torch.equal(o8["master"], torch.from_numpy(
        want8["master"][g * n:(g + 1) * n]))
    res = tlaunch.train_rank(rank=rank, world=world, **_kw(
        **dict(dp=2, tp=2, scheme="ef_zhybrid_16_4"), steps=2,
        ckpt_dir=dirs["ref"], resume=True))
    return {"log": log, "losses": res["losses"],
            "grad_norms": res["grad_norms"], "start": res["start"]}


@pytest.fixture(scope="module")
def port_from_reference(reference, dirs):
    from repro_torch.launch.train import spawn_world
    return spawn_world(f"{__name__}:restore_reference", 4,
                       dict(dirs={k: str(v) for k, v in dirs.items()},
                            own=reference["own_path"],
                            state8=reference["state8_path"]), timeout=600)


@pytest.mark.parametrize("run", ["ef", "s8"])
def test_resume_continues_bit_for_bit(port, run):
    for rf, ra, rb in zip(port[f"{run}_full"], port[f"{run}_first"],
                          port[f"{run}_resume"]):
        assert rb["start"] == 2
        assert ra["losses"] + rb["losses"] == rf["losses"]
        assert ra["grad_norms"] + rb["grad_norms"] == rf["grad_norms"]
        assert rb["restore_log"][:2] == ["restored optimizer state at step 2",
                                         "restored codec state at step 2"]
        assert ra["ckpt"]["steps"] == [2] and rb["ckpt"]["steps"] == [4]
        assert ra["ckpt"]["bytes"] > 0


def test_heartbeat_and_latest(port, dirs):
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import fault
    hb = json.loads((dirs["ef"] / "heartbeat.json").read_text())
    assert hb["step"] == 3 and sorted(hb) == ["dt", "ema", "step",
                                              "straggler", "t"]
    assert not fault.heartbeat_stale(dirs["ef"] / "heartbeat.json", 3600)
    for sub in ("", "opt", "codec"):
        assert ck.latest_step(dirs["ef"] / sub) == 4
        assert not list((dirs["ef"] / sub).glob("*.tmp"))
    for r in port["ef_resume"]:
        assert len(r["straggler"]) == 2
        assert r["stragglers"] == sum(r["straggler"])


def test_elastic_pp_restore_runs_through_stage_reshape(port, reference):
    """pp 1 -> dp 1 x pp 2 x tp 2 (--layers 4): the stacked layer group
    reshapes onto the stages, the first loss is the flat run's on the same
    params and batch, and the optimizer state restores or falls back
    exactly where the reference's layouts allow."""
    layouts = reference["layouts"]
    same = layouts["l4_dp2_tp2"]["opt"] == layouts["l4_pp2_tp2"]["opt"]
    for r in port["pp2_resume"]:
        assert r["start"] == 2
        np.testing.assert_allclose(r["losses"][0],
                                   port["l4_full"][0]["losses"][2], rtol=1e-6)
        want = "restored optimizer state at step 2" if same else \
            "WARNING: optimizer state not portable to this topology"
        assert r["restore_log"][0].startswith(want)
        assert "resumed from step 2 (elastic onto dp=1 tp=2 pp=2)" in \
            r["restore_log"]


def test_port_checkpoint_restores_into_reference(port, reference, dirs):
    """The port's step-2 checkpoint in the reference: each rank's part bit
    for bit (a replicated leaf as its first replica wrote it), the same
    files when the reference saves what it restored, the manifests its own
    run writes, and the trajectory continued within tolerance."""
    from repro_torch.models.params import (defs, local_index,
                                           writes_replica)
    from repro_torch.models.transformer import model_plan
    from repro_torch.launch.train import model_config
    from repro_torch.train import checkpoint as ck
    got = reference["from_port"]
    assert got["log"].splitlines() == ["restored optimizer state at step 2",
                                       "restored codec state at step 2"]
    cfg = model_config("gemma3-1b", True)
    for r, res in enumerate(port["ef_ref"]):
        mi = rank_mesh(2, 2, 1, r)
        params, ostate, cstate = res["state"]
        plan = model_plan(cfg, mi)
        gl = ck.flatten(got["params"])
        for d, a, mine in zip(defs(plan), gl, ck.flatten(params)):
            if writes_replica(d.spec, mi):
                np.testing.assert_array_equal(
                    np.asarray(a)[local_index(d.shape, d.spec, mi)], mine)
        tr = port_trainer(LAYOUTS["dp2_tp2_ef"], mi)
        for s, a, mine in zip(ck.flatten(tr.opt_state_shards()),
                              ck.flatten(got["opt"]),
                              ck.flatten({**ostate, "step": np.int32(
                                  ostate["step"])})):
            np.testing.assert_array_equal(np.asarray(a)[s.index], mine)
        for s, a, mine in zip(ck.flatten(tr.codec_state_shards()),
                              ck.flatten(got["codec"]), ck.flatten(cstate)):
            np.testing.assert_array_equal(np.asarray(a)[s.index], mine)
    for sub in ("", "opt", "codec"):
        mine = dirs["ef_ref"] / sub / "step_2"
        assert _files(mine) == _files(dirs["resave"] / sub / "step_2")
        assert _manifest(mine) == _manifest(dirs["ref"] / sub / "step_2")
    want = port["ef_full"][0]
    np.testing.assert_allclose(got["losses"], want["losses"][2:],
                               rtol=TOL[0])
    np.testing.assert_allclose(got["gnorms"], want["grad_norms"][2:],
                               rtol=TOL[1])


def test_reference_checkpoint_restores_into_port(port_from_reference,
                                                 reference):
    """Every rank restored the reference's params, optimizer state (32 and
    8 bits) and ef:bq4 codec state bit for bit (asserted in the ranks),
    and continued its trajectory within tolerance."""
    for r in port_from_reference:
        assert r["start"] == 2
        assert r["log"][:2] == ["restored optimizer state at step 2",
                                "restored codec state at step 2"]
        assert r["log"][2] == "restored optimizer state at step 5"
        np.testing.assert_allclose(r["losses"], reference["own"]["losses"],
                                   rtol=TOL[0])
        np.testing.assert_allclose(r["grad_norms"],
                                   reference["own"]["gnorms"], rtol=TOL[1])


def test_ranks_import_no_reference(port):
    for runs in port.values():
        for r in runs:
            assert r["foreign_modules"] == []


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(json.loads(sys.argv[2]))
