"""The port's recurrent families (``models/ssm.py``, ``models/xlstm.py``:
zamba2's Mamba2 blocks and xLSTM's mLSTM and sLSTM blocks) against the
reference, on one rank, with their plans, cache layouts and refusals, and
the two reference faults this slice found.

Contract asserted here, with the tolerances and their reasons:
  * ``chunked_outer_scan`` with chunk 16 at lengths 48 and 45 (a whole
    and a padded last chunk), with and without an initial state ``s0``,
    on the same numpy inputs: ``y``, the final state and the total decay
    within 1e-5 of each one's largest entry, and the gradients of a
    weighted sum of all three (``a``, ``u``, ``r``, ``q``, ``s0``) within
    1e-4 of each one's largest entry (f32; the frameworks order the
    einsum sums differently).  The decays ``a`` lie in [0.3, 1), so no
    log-decay reaches the f32 denormal clamp of ``log(max(a, 1e-38))``
    where XLA:CPU flushes to zero (fault C.1);
  * ``mamba_block`` (reduced zamba2), ``mlstm_block`` and ``slstm_block``
    (reduced xLSTM) on one rank from the reference's weights, 160 tokens
    (a whole and a partial chunk of 128): the output within 1e-5 of its
    largest entry and the input's and every weight's gradient within 1e-4
    of each one's largest entry; the prefill's decode-layout cache within
    1e-5, and one decode step from the reference's cache (its output and
    new cache) within 1e-5.  The blocks' decays stay above 0.4 (``dt``
    about 0.7 from zero-init biases), so no decay underflows either;
  * both full configs' plans (``shared`` included) equal the reference's
    leaf for leaf in shape and spec on several meshes, with and without
    ZeRO-3, built without allocating; ``stage_partition`` accepts and
    refuses xLSTM's and zamba2's stacks as the reference does, with its
    messages; ``ArchConfig.truncated`` keeps zamba2's whole
    ``[6 x mamba, shared_attn]`` blocks and counts mamba layers
    (``hybrid_groups`` of the cut), and the decode cache layouts hold
    the shapes the bodies write;
  * paged serving of either arch raises the reference's
    ``NotImplementedError`` with its text, and the port's training
    launcher refuses ``--cp`` on a recurrent stack;
  * fault C.19 (reference): at tp 2 the reference's ``mamba_decode`` of
    token S after a prefill of S tokens is more than 1 % off the last
    position of a one-rank prefill of S + 1 tokens, at tp 1 it is within
    1e-5; the port at tp 2 (a gloo world of 2) gives the reference's tp-2
    decode within 1e-5 (mirrored);
  * fault C.20 (reference): the reference's loss at ``--cp 2``
    differs from its ``--cp 1`` loss on the same weights and batch for
    both recurrent stacks (by more than 1e-4), where gemma3-1b's agree
    within 1e-6.

The reference's two-device cases run in one subprocess (this file
re-invokes itself with ``--reference``), the port's world of 2 beside it.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FWD, GRAD = 1e-5, 1e-4
S_DEC = 16


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= lim, (what, err, lim)


def _ref_env(n: int = 2):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
            "JAX_PLATFORMS": "cpu"}


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", (48, 45))
@pytest.mark.parametrize("with_s0", (False, True))
def test_chunked_outer_scan_matches_reference(L, with_s0):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import comms as jcomms
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm

    B, H, P, N, Q = 2, 3, 4, 5, 16
    rng = np.random.default_rng(L + 100 * with_s0)
    ins = dict(a=rng.uniform(0.3, 1.0, (B, L, H)),
               u=rng.normal(size=(B, L, H, P)),
               r=rng.normal(size=(B, L, H, N)),
               q=rng.normal(size=(B, L, H, N)))
    if with_s0:
        ins["s0"] = rng.normal(size=(B, H, P, N))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((B, L, H, P), (B, H, P, N), (B, H))]

    def jloss(args):
        with jcomms.vma_mode(False):
            y, s, d = jssm.chunked_outer_scan(
                args["a"], args["u"], args["r"], args["q"], chunk=Q,
                s0=args.get("s0"))
        return sum(jnp.sum(o * wi) for o, wi in zip((y, s, d), w)), (y, s, d)
    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in ins.items()})

    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ins.items()}
    got = tssm.chunked_outer_scan(t["a"], t["u"], t["r"], t["q"], chunk=Q,
                                  s0=t.get("s0"))
    sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(got, w)).backward()
    for name, g, wv in zip(("y", "state", "decay"), got, want):
        _close(g.detach().numpy(), wv, FWD, name)
    for k in ins:
        _close(t[k].grad.numpy(), jg[k], GRAD, f"grad {k}")


# --------------------------------------------------------------------------
# the blocks on one rank
# --------------------------------------------------------------------------

BLOCKS = {"mamba": "zamba2-1.2b", "mlstm": "xlstm-1.3b",
          "slstm": "xlstm-1.3b"}


def _jblock(kind):
    from repro.models import ssm as jssm, xlstm as jxlstm
    return {"mamba": (jssm.mamba_plan, jssm.mamba_block, jssm.mamba_decode),
            "mlstm": (jxlstm.mlstm_plan, jxlstm.mlstm_block,
                      jxlstm.mlstm_decode),
            "slstm": (jxlstm.slstm_plan, jxlstm.slstm_block,
                      jxlstm.slstm_decode)}[kind]


def _tblock(kind):
    from repro_torch.models import ssm as tssm, xlstm as txlstm
    return {"mamba": (tssm.mamba_block, tssm.mamba_decode),
            "mlstm": (txlstm.mlstm_block, txlstm.mlstm_decode),
            "slstm": (txlstm.slstm_block, txlstm.slstm_decode)}[kind]


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_and_decode_match_reference(kind):
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.core import comms as jcomms, compat
    from repro.models.params import (MeshInfo as JMeshInfo, Pv,
                                     init_params, param_specs)
    from repro_torch import configs as tconfigs
    from repro_torch.models.params import MeshInfo

    jcfg = jconfigs.get(BLOCKS[kind]).reduced()
    tcfg = tconfigs.get(BLOCKS[kind]).reduced()
    jplan, jblock, jdecode = _jblock(kind)
    tblock, tdecode = _tblock(kind)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    mi = JMeshInfo.from_mesh(mesh)
    plan = jplan(jcfg)
    params = init_params(plan, jax.random.key(5))
    specs = param_specs(plan, mi)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 160, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    xt1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)

    def f(p, xa, wa, x1):
        def loss(p, xa):
            return jnp.sum(jblock(p, xa, jcfg, mi, sp=True) * wa)
        with jcomms.vma_mode(False):
            _, grads = jax.value_and_grad(loss, argnums=(0, 1))(p, xa)
            y, cache = jblock(p, xa, jcfg, mi, sp=True, want_cache=True)
            dec = jdecode(p, x1, cache, jcfg, mi)
        return y, cache, grads, dec
    y, cache, (gp, gx), (dout, dcache) = jax.jit(compat.shard_map(
        f, mesh=mesh, in_specs=(specs, P(), P(), P()),
        out_specs=(P(), P(), (specs, P()), P()), check_vma=False))(
        params, jnp.asarray(x), jnp.asarray(w), jnp.asarray(xt1))

    tp = {n: torch.from_numpy(np.array(pv.v)).requires_grad_(True)
          for n, pv in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tblock(tp, xt, tcfg, MeshInfo(), sp=True)
    (ty * torch.from_numpy(w)).sum().backward()
    _close(ty.detach().numpy(), y, FWD, "y")
    _close(xt.grad.numpy(), gx, GRAD, "grad x")
    for n in tp:
        _close(tp[n].grad.numpy(), gp[n].v, GRAD, f"grad {n}")

    with torch.no_grad():
        ty2, tcache = tblock(tp, xt, tcfg, MeshInfo(), sp=True,
                             want_cache=True)
        _close(ty2.numpy(), y, FWD, "y (prefill)")
        assert sorted(tcache) == sorted(cache)
        for k in cache:
            _close(tcache[k].numpy(), cache[k], FWD, f"cache {k}")
        c = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
        tout, tnew = tdecode(tp, torch.from_numpy(xt1), c, tcfg, MeshInfo())
    _close(tout.numpy(), dout, FWD, "decode out")
    for k in dcache:
        _close(tnew[k].numpy(), dcache[k], FWD, f"decode cache {k}")


# --------------------------------------------------------------------------
# plans, stages, truncation, cache layouts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("zamba2-1.2b", "xlstm-1.3b"))
def test_full_plans_match_reference(arch):
    import jax

    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.models.transformer import model_plan as jplan
    from repro_torch import configs as tconfigs
    from repro_torch.models.params import MeshInfo, defs
    from repro_torch.models.transformer import model_plan as tplan

    for fsdp in (False, True):
        jcfg = jconfigs.get(arch).replace(fsdp_params=fsdp)
        tcfg = tconfigs.get(arch).replace(fsdp_params=fsdp)
        for dp, tp in ((1, 1), (2, 2), (1, 4), (4, 8)):
            jp = jplan(jcfg, JMeshInfo(tp=tp, dp=dp))
            tpl = tplan(tcfg, MeshInfo(tp=tp, dp=dp))
            assert sorted(tpl) == sorted(jp)
            assert ("shared" in tpl) == (arch == "zamba2-1.2b")
            want = [(d.shape, d.spec) for d in jax.tree_util.tree_leaves(
                jp, is_leaf=lambda x: hasattr(x, "spec"))]
            got = [(d.shape, d.spec) for d in defs(tpl)]
            assert got == want, (fsdp, dp, tp)
            if fsdp and dp > 1:
                assert any("data" in s for _, s in got)


def test_optimizer_routes_leaves_as_reference():
    """Every leaf's gradient class (A: ZeRO-3, B: model-sharded, C:
    replicated, folded over tp) equals the reference's, leaf for leaf; the
    recurrent leaves are class C, the shared attention block's projections
    class B (head attention at tp 2), and under ZeRO-3 the big recurrent
    leaves class A."""
    import jax

    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.models.transformer import model_plan as jplan
    from repro.train.optimizer import _leaf_class as jclass
    from repro_torch import configs as tconfigs
    from repro_torch.models.params import MeshInfo, _leaves
    from repro_torch.models.transformer import model_plan as tplan
    from repro_torch.train.optimizer import _leaf_class as tclass

    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        for fsdp in (False, True):
            jcfg = jconfigs.get(arch).replace(fsdp_params=fsdp)
            tcfg = tconfigs.get(arch).replace(fsdp_params=fsdp)
            want = [jclass(d.spec) for d in jax.tree_util.tree_leaves(
                jplan(jcfg, JMeshInfo(tp=2, dp=2)),
                is_leaf=lambda x: hasattr(x, "spec"))]
            got = {path: tclass(d.spec) for path, d in _leaves(
                tplan(tcfg, MeshInfo(tp=2, dp=2)))}
            assert list(got.values()) == want, (arch, fsdp)
            for path, c in got.items():
                kind = path[2] if path[0] == "groups" else None
                if kind in ("mamba", "mlstm", "slstm") and not fsdp:
                    assert c == "C", path
                if path[:2] == ("shared", "attn") and not fsdp:
                    assert c == "B", path
            if fsdp:
                assert got[("groups", 0, "mamba" if arch == "zamba2-1.2b"
                            else "mlstm", "w_out")] == "A"


def test_stage_partition_matches_reference():
    from repro import configs as jconfigs
    from repro.models.transformer import stage_partition as jpart
    from repro_torch import configs as tconfigs
    from repro_torch.models.transformer import stage_partition as tpart

    for arch in ("xlstm-1.3b", "zamba2-1.2b"):
        for pp in (2, 3, 4, 6):
            want = got = None
            try:
                want = [(g.kind, g.n) for g in jpart(jconfigs.get(arch), pp)]
            except ValueError as e:
                want = str(e)
            try:
                got = [(g.kind, g.n) for g in tpart(tconfigs.get(arch), pp)]
            except ValueError as e:
                got = str(e)
            assert got == want, (arch, pp)
    assert tpart(tconfigs.get("xlstm-1.3b"), 2) == tuple(
        tconfigs.get("xlstm-1.3b").truncated(24).layer_groups)
    with pytest.raises(ValueError, match="shared_attn"):
        tpart(tconfigs.get("zamba2-1.2b"), 2)


def test_truncated_keeps_whole_hybrid_blocks():
    from repro_torch import configs
    from repro_torch.models.config import hybrid_groups, xlstm_groups

    z = configs.get("zamba2-1.2b")
    assert z.layer_groups == hybrid_groups(38, 6)
    for n in range(1, 39):
        cut = z.truncated(n)
        assert cut.layer_groups == hybrid_groups(n, 6), n
        assert cut.n_layers == sum(g.n for g in cut.layer_groups
                                   if g.kind == "mamba") == n
    assert [(g.kind, g.n) for g in z.truncated(12).layer_groups] == [
        ("mamba", 6), ("shared_attn", 1)] * 2
    x = configs.get("xlstm-1.3b")
    for n in (1, 7, 8, 9, 24, 48):
        assert x.truncated(n).layer_groups == xlstm_groups(n, 8), n
    assert [(g.kind, g.n) for g in x.truncated(8).layer_groups] == [
        ("mlstm", 7), ("slstm", 1)]


@pytest.mark.parametrize("arch", ("zamba2-1.2b", "xlstm-1.3b"))
def test_cache_layouts_match_reference(arch):
    """The port's local decode and prefill layouts are the reference's
    global ones divided by their specs (tp 2, dp 2, batch 4)."""
    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.serve import kv_cache as jkv
    from repro_torch import configs as tconfigs
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import kv_cache as tkv

    jcfg, tcfg = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    jst, _ = jkv.cache_structs(jcfg, JMeshInfo(tp=2, dp=2), 4, 24)
    tst, tsp = tkv.cache_structs(tcfg, MeshInfo(tp=2, dp=2), 4, 24)
    ways = {"data": 2, "model": 2, None: 1}
    for jg, tg, sg in zip(jst, tst, tsp):
        assert sorted(jg) == sorted(tg)
        for k in jg:
            assert tuple(n // ways[s] for n, s in zip(jg[k].shape, sg[k])) \
                == tg[k].shape, (k, jg[k].shape, tg[k].shape)
            assert str(jg[k].dtype) == str(tg[k].dtype).replace("torch.", "")
    def tag(e):
        names = e if isinstance(e, tuple) else (e,)
        return "model" if "model" in names else \
            "data" if "data" in names else None
    want = [{k: tuple(tag(e) for e in v) for k, v in g.items()}
            for g in jkv.prefill_cache_specs(jcfg, JMeshInfo(tp=2, dp=2), 4)]
    got = tkv.prefill_cache_specs(tcfg, MeshInfo(tp=2, dp=2), 4)
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        for k in g:
            assert g[k] == w[k], (k, g[k], w[k])


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("zamba2-1.2b", "xlstm-1.3b"))
def test_paged_serving_refused_as_reference(arch):
    from repro import configs as jconfigs
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.serve import paged_kv as jpaged
    from repro_torch import configs as tconfigs
    from repro_torch.launch.serve import serve_rank
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import paged_kv as tpaged

    for tp in (1, 2):
        with pytest.raises(NotImplementedError) as want:
            jpaged.pool_structs(jconfigs.get(arch).reduced(),
                                JMeshInfo(tp=tp), 8, 4, "bq8")
        with pytest.raises(NotImplementedError) as got:
            tpaged.pool_structs(tconfigs.get(arch).reduced(),
                                MeshInfo(tp=tp), 8, 4, "bq8")
        assert str(got.value) == str(want.value)
        assert "needs the dense-cache Server" in str(got.value)
    with pytest.raises(NotImplementedError) as got:
        serve_rank(arch=arch, reduced=True, mode="paged", device="cpu",
                   gen=2, prompt_len=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ("zamba2-1.2b", "xlstm-1.3b"))
def test_train_launcher_refuses_cp_on_recurrent_stacks(arch):
    from repro_torch.launch import train as tlaunch
    args = tlaunch.parser().parse_args(["--arch", arch, "--reduced", "--cp",
                                        "2", "--seq", "32"])
    with pytest.raises(ValueError, match="--cp 2 is refused"):
        tlaunch.check_schedule(args)
    with pytest.raises(ValueError, match="--cp 2 is refused"):
        tlaunch.train_rank(arch=arch, reduced=True, cp=2, world=2,
                           device="cpu", steps=1)
    ok = tlaunch.parser().parse_args(["--arch", "gemma3-1b", "--reduced",
                                      "--cp", "2", "--seq", "32"])
    tlaunch.check_schedule(ok)


# --------------------------------------------------------------------------
# reference faults C.19 and C.20 (a reference subprocess, a port world)
# --------------------------------------------------------------------------

def _decode_inputs(d_model: int):
    rng = np.random.default_rng(3)
    return rng.normal(size=(2, S_DEC + 1, d_model)).astype(np.float32)


def _reference(out_path: str, tree_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.core import comms, compat
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.launch.mesh import make_mesh
    from repro.models import ssm
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv, param_specs
    from repro.train.train_step import batch_specs, zigzag_shard_seq

    out = {}
    # C.19: mamba decode after a prefill, tp 1 and tp 2
    cfg = configs.get("zamba2-1.2b").reduced()
    plan = ssm.mamba_plan(cfg)
    with open(tree_path, "rb") as f:
        tree = pickle.load(f)
    params = {k: Pv(jnp.asarray(v), plan[k].spec) for k, v in tree.items()}
    x = _decode_inputs(cfg.d_model)
    cspec = {"conv": P(None, None, "model"),
             "state": P(None, "model", None, None)}
    for tp in (1, 2):
        mesh = compat.make_mesh((1, tp), ("data", "model"))
        mi = MeshInfo.from_mesh(mesh)
        specs = param_specs(plan, mi)

        def pre(p, xa, mi=mi):
            with comms.vma_mode(False):
                return ssm.mamba_block(p, xa, cfg, mi, sp=True,
                                       want_cache=True)

        def dec(p, xa, c, mi=mi):
            with comms.vma_mode(False):
                return ssm.mamba_decode(p, xa, c, cfg, mi)
        _, cache = jax.jit(compat.shard_map(
            pre, mesh=mesh, in_specs=(specs, P(None, "model", None)),
            out_specs=(P(None, "model", None), cspec), check_vma=False))(
            params, jnp.asarray(x[:, :S_DEC]))
        o, _ = jax.jit(compat.shard_map(
            dec, mesh=mesh, in_specs=(specs, P(), cspec),
            out_specs=(P(), cspec), check_vma=False))(
            params, jnp.asarray(x[:, S_DEC:]), cache)
        out[f"decode_tp{tp}"] = np.asarray(o)
        if tp == 1:
            full = jax.jit(compat.shard_map(
                lambda p, xa, mi=mi: ssm.mamba_block(p, xa, cfg, mi),
                mesh=mesh, in_specs=(specs, P()), out_specs=P(),
                check_vma=False))(params, jnp.asarray(x))
            out["prefill_last"] = np.asarray(full)[:, S_DEC:]
        jax.clear_caches()
    # C.20: the loss at cp 1 and cp 2 on the same weights and batch
    for arch in ("zamba2-1.2b", "xlstm-1.3b", "gemma3-1b"):
        acfg = configs.get(arch).reduced()
        data = SyntheticCorpus(DataConfig(vocab_size=acfg.vocab_size,
                                          seq_len=32, global_batch=4,
                                          seed=0))
        params = None
        for cp in (1, 2):
            mesh = make_mesh(1, 1, cp=cp)
            model = Model(acfg, MeshInfo.from_mesh(mesh))
            # the weights do not depend on the mesh: drawn once
            params = params or model.init(jax.random.key(0))
            bs = batch_specs(acfg, model.mi)

            def loss(p, b, model=model):
                with comms.vma_mode(False):
                    return model.loss_fn(p, b)[0]
            batch = {k: jax.device_put(v, NamedSharding(mesh, bs[k]))
                     for k, v in zigzag_shard_seq(data.batch(0), cp).items()}
            out[("cp", arch, cp)] = float(jax.jit(compat.shard_map(
                loss, mesh=mesh, in_specs=(model.specs(), bs),
                out_specs=P(), check_vma=False))(params, batch))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def decode_rank(*, rank: int, world: int, tree: str) -> dict:
    """Rank ``rank`` of a tp-``world`` mesh: the mamba prefill of the first
    ``S_DEC`` tokens (this rank's sequence slice), then the decode of the
    next token; returns the decode's output."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ssm

    cfg = configs.get("zamba2-1.2b").reduced()
    mi = make_mesh(1, world)
    with open(tree, "rb") as f:
        params = {k: torch.from_numpy(v) for k, v in pickle.load(f).items()}
    x = torch.from_numpy(_decode_inputs(cfg.d_model))
    s = S_DEC // world
    with torch.no_grad():
        _, cache = ssm.mamba_block(params, x[:, rank * s:(rank + 1) * s],
                                   cfg, mi, sp=True, want_cache=True)
        out, _ = ssm.mamba_decode(params, x[:, S_DEC:], cache, cfg, mi)
    return {"out": out.numpy(), "foreign": sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))}


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    import jax

    from repro import configs
    from repro.models import ssm
    from repro.models.params import init_params
    from repro_torch.launch.train import spawn_world

    base = tmp_path_factory.mktemp("recurrent")
    plan = ssm.mamba_plan(configs.get("zamba2-1.2b").reduced())
    tree = {k: np.asarray(pv.v) for k, pv in
            init_params(plan, jax.random.key(9)).items()}
    with open(base / "tree.pkl", "wb") as f:
        pickle.dump(tree, f)
    proc = subprocess.Popen(
        [sys.executable, __file__, "--reference", str(base / "ref.pkl"),
         str(base / "tree.pkl")], env=_ref_env(2),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_world(f"{__name__}:decode_rank", 2,
                           dict(tree=str(base / "tree.pkl")), timeout=600)
        err = proc.communicate(timeout=600)[1]
        assert proc.returncode == 0, err[-4000:]
        with open(base / "ref.pkl", "rb") as f:
            ref = pickle.load(f)
        yield ref, port
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_mamba_decode_normalizes_per_shard_c19(faults):
    ref, port = faults
    want = ref["prefill_last"]
    _close(ref["decode_tp1"], want, FWD, "tp 1 decode vs prefill")
    err = np.abs(ref["decode_tp2"] - want).max() / np.abs(want).max()
    assert err > 1e-2, err
    for r in port:
        assert r["foreign"] == []
        _close(r["out"], ref["decode_tp2"], FWD, "port tp 2 decode")


def test_reference_cp_on_recurrent_stacks_is_silently_wrong_c20(faults):
    ref, _ = faults
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        a, b = ref[("cp", arch, 1)], ref[("cp", arch, 2)]
        assert abs(a - b) > 1e-4 * abs(a), (arch, a, b)
    a, b = ref[("cp", "gemma3-1b", 1)], ref[("cp", "gemma3-1b", 2)]
    np.testing.assert_allclose(b, a, rtol=1e-6)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2], sys.argv[3])
