"""The port's Mixture-of-Experts path against the reference's: the
all-to-alls (``comms.all_to_all`` and its two-level ``hier_all_to_all``),
the expert layer (``models/moe.py``) on one rank, the two MoE configs'
plans, and MoE serving on meshes.

Contract asserted here, with the tolerances and their reasons:
  * ``all_to_all`` over worlds of 2 and 4 gloo ranks against the
    reference over as many XLA host devices, under ``none``, ``bq8`` and
    ``bq16`` (f32, and a bf16 payload under ``bq16``), split and concat
    dims (0, 0), (0, 1) and (1, 0): the forward and the backward (the
    gradient of ``sum(out * w)``, the transpose all-to-all under the bwd
    codec) bit for bit (no sums: every value is moved, and under a bq
    codec encoded and decoded, alone), and every analytic ledger event
    and measured wire event equal (the backward's wire site tag aside:
    the port tags it with its forward's), as
    ``tests/multidev/ledger_check.py``'s all-to-all case prices them;
  * ``hier_all_to_all`` at 2 nodes x 2 ranks (``(tpnode, model)``) under
    ``baseline`` and ``hier_tpp_8_16`` (bq16 inner, bq8 outer), forward
    and backward bit for bit against the reference, one ``inner`` and one
    ``outer`` event of the whole payload in both ledgers; under
    ``baseline`` the port's two-level form equals its flat all-to-all
    over the joint axis bit for bit (``tests/multidev/tp_hier_check.py``);
  * ``moe_block`` of reduced qwen3-moe and of reduced kimi-k2 (its shared
    expert) on one rank from the reference's weights and the same numpy
    inputs: ``y`` within 1e-5 of its largest entry and the gradients of
    ``sum(y * w) + lb_loss`` (input, router and experts) within 1e-4 of
    each one's largest entry (f32; the frameworks order the matmul sums
    differently), ``lb_loss`` within rtol 1e-6, ``drop_frac`` and the
    chosen experts exact; a zero router (every probability 1/E: ties,
    the reference's ``lax.top_k`` takes experts 0..k-1) and a capacity
    factor of 0.5 both drop tokens; every case's inputs keep the k-th and
    (k+1)-th probabilities 1e-6 apart or tied exactly, so a routing flip
    would be a fault, not an ulp;
  * ``capacity`` equals the reference's over a sweep of token counts and
    capacity factors; qwen3-moe's and kimi-k2's full plans (``fsdp_params``
    on, as shipped) equal the reference's leaf for leaf in shape and spec
    on several meshes, and so do their ``moe_ws`` plans, kimi's
    ``moe_groups(61, first_dense=1)`` included, built without allocating;
  * serving reduced qwen3-moe from the reference's weights (seed 7,
    prompts of 16 tokens, batch 4, 4 generated): the dense ``Server`` at
    ``--tp 2`` under ``zhybrid_16_8`` (the all-to-alls on bq16) with equal
    tokens, the prefill and final caches within ``BQ_TOL`` of each
    cache's largest value (``test_torch_serve_mesh.py``'s bound for a bq
    codec on the TP collectives) and the ledger per ``dim/level`` equal
    byte for byte; the weight-stationary decode (``moe_ws=True``) at
    ``--dp 2 --tp 2`` under ``baseline``, equal tokens, caches within
    rtol 1e-5 / atol 1e-6 and the ledgers equal, the decode's
    ``ep@moe_decode_batch`` gather and reduce-scatter in both; paged
    serving of the ``moe`` groups at ``--tp 2`` under ``--kv-codec bq8``
    (six mixed-length requests on 4 slots), equal tokens and the pool's
    planes as ``test_torch_serve_mesh.py`` holds them (mantissas within
    +-1, the first layer's scales within rtol 1e-6, the later layers'
    within one bq8 step).

The reference runs in two subprocesses on 4 XLA host devices side by
side (this file re-invokes itself with ``--reference``), the port in
worlds of 4 and 2 ranks beside them; the one-rank layer cases run in
this process.
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
A2A_SHAPE = (8, 8, 40)
SEED, B, S, GEN, BT = 7, 4, 16, 4, 4
PLENS = (5, 9, 12, 7, 6, 10)
N_SLOTS = 4
RTOL, ATOL = 1e-5, 1e-6
BQ_TOL = 1e-4


def _a2a_cases() -> list:
    out = []
    for codec in ("none", "bq8", "bq16"):
        for sa, ca in ((0, 0), (0, 1), (1, 0)):
            out.append(dict(codec=codec, sa=sa, ca=ca, dtype="float32",
                            pair=False))
    out.append(dict(codec="bq16", sa=0, ca=0, dtype="bfloat16", pair=False))
    return out


def _hier_cases() -> list:
    out = []
    for scheme in ("baseline", "hier_tpp_8_16"):
        for sa, ca in ((0, 0), (0, 1)):
            out.append(dict(codec=scheme, sa=sa, ca=ca, dtype="float32",
                            pair=True))
    out.append(dict(codec="hier_tpp_8_16", sa=0, ca=0, dtype="bfloat16",
                    pair=True))
    return out


def _a2a_inputs(n: int, i: int, case: dict):
    """Every rank's input ``x`` and loss weights ``w`` (rows by rank)."""
    rng = np.random.default_rng(100 * n + i)
    x = (rng.normal(size=(n,) + A2A_SHAPE) * 3.0).astype(np.float32)
    x[:, :, 0] = 0.0                                  # all-zero rows
    out = list(A2A_SHAPE)
    out[case["sa"]] //= n
    out[case["ca"]] *= n
    w = rng.normal(size=(n,) + tuple(out)).astype(np.float32)
    return x, w


def _ref_env():
    return {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_PLATFORMS": "cpu"}


# --------------------------------------------------------------------------
# the reference (subprocesses)
# --------------------------------------------------------------------------

def _ref_a2a() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import comms, compat, policy
    from test_torch_comms import round_first_oracles

    round_first_oracles()
    res = {}
    runs = [(n, i, c) for n in (2, 4) for i, c in enumerate(_a2a_cases())]
    runs += [(4, ("h", i), c) for i, c in enumerate(_hier_cases())]
    for n, i, case in runs:
        if case["pair"]:
            mesh = compat.make_mesh((2, 2), ("tpnode", "model"))
            axis, spec = compat.AxisPair("tpnode", "model"), \
                P(("tpnode", "model"))
            plan = policy.as_policy(case["codec"]).compile()
        else:
            mesh = compat.make_mesh((n,), ("x",), devices=jax.devices()[:n])
            axis, spec = "x", P("x")
            plan = policy.CommPolicy(
                "rc", rules=(policy.Rule(case["codec"]),)).compile()
        x, w = _a2a_inputs(n, i if not case["pair"] else 50 + i[1], case)

        def f(xl, wl, case=case, axis=axis, plan=plan):
            def loss(a):
                o = comms.all_to_all(a, axis, case["sa"], case["ca"], "ep")
                return jnp.sum(o.astype(jnp.float32) * wl[0]), o
            with policy.use_plan(plan), comms.vma_mode(False):
                (_, o), g = jax.value_and_grad(loss, has_aux=True)(xl[0])
            return o[None].astype(jnp.float32), g[None].astype(jnp.float32)
        fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                      out_specs=(spec, spec),
                                      check_vma=False))
        with comms.record_traffic() as ev:
            o, g = jax.block_until_ready(fn(
                jnp.asarray(x).astype(case["dtype"]), jnp.asarray(w)))
        res[(n, i)] = dict(out=np.asarray(o), grad=np.asarray(g),
                           events=list(ev), wire=list(ev.wire))
        jax.clear_caches()
    return res


def _jcfg(ws: bool = False):
    from repro import configs
    cfg = configs.get(ARCH).reduced()
    return cfg.replace(moe_ws=True) if ws else cfg


SERVE = {
    "dense_tp2": dict(mode="batched", dp=1, tp=2, scheme="zhybrid_16_8"),
    "ws_dp2_tp2": dict(mode="batched", dp=2, tp=2, scheme="baseline",
                       ws=True),
    "paged_tp2_bq8": dict(mode="paged", dp=1, tp=2, scheme="baseline",
                          codec="bq8"),
}


def _sc(c: dict) -> dict:
    return dict(dict(ws=False, codec="none"), **c)


def _prompts():
    return np.random.default_rng(SEED).integers(0, 512, (B, S)).astype(
        np.int32)


def _paged_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32).tolist() for n in PLENS]


def _s_max(tp: int) -> int:
    return -(-(S + GEN) // (2 * tp)) * (2 * tp)


def _mb() -> int:
    return -(-(max(PLENS) + GEN) // BT)


def _ref_serve() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.analysis import roofline
    from repro.core import comms
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo
    from repro.serve import paged_kv
    from repro.serve.scheduler import Scheduler
    from repro.serve.serve_step import PagedServer, Server
    from repro.train.train_step import batch_specs

    key = jax.random.key(SEED)
    prompts = _prompts()
    out = {}

    def np_caches(caches):
        return [{k: np.asarray(v, np.float32) for k, v in c.items()}
                for c in caches]

    def ledger(events):
        return dict(per_dim_level=roofline.ledger_summary(
            events, train=False)["per_dim_level"],
            tags=sorted({e["tag"] for e in events}))

    for case, c in SERVE.items():
        c = _sc(c)
        cfg = _jcfg(c["ws"])
        mesh = make_mesh(c["dp"], c["tp"])
        mi = MeshInfo.from_mesh(mesh)
        model = Model(cfg, mi)
        params = model.init(key)
        if c["mode"] == "paged":
            mb = _mb()
            psrv = PagedServer(model, mesh, kv_codec=c["codec"],
                               block_tokens=BT)
            step, pst, _ = psrv.decode_step(N_SLOTS, N_SLOTS * mb, mb)
            sched = Scheduler(N_SLOTS, N_SLOTS * mb, BT, mb,
                              dp=mi.batch_ways)
            for r, p in enumerate(_paged_prompts()):
                sched.submit(r, p, GEN)
            fin, pool, steps = sched.run(step, params,
                                         paged_kv.zero_pool(pst))
            out[case] = dict(tokens=fin, steps=steps,
                             pool=jax.tree.map(np.asarray, pool))
            jax.clear_caches()
            continue
        srv = Server(model, mesh, scheme=c["scheme"])
        bspecs = batch_specs(cfg, mi)
        batch = {k: jax.device_put(jnp.asarray(prompts),
                                   NamedSharding(mesh, bspecs[k]))
                 for k in ("tokens", "labels")}
        prefill = srv.prefill_step({k: bspecs[k] for k in batch}, B)
        with comms.record_traffic() as ev_p:
            tok, caches = prefill(params, batch)
        pre = np_caches(caches)
        dec, structs, cspecs = srv.decode_step(B, _s_max(c["tp"]))
        padded = []
        for st, cs, pc in zip(structs, cspecs, pre):
            new = {}
            for k, v in st.items():
                a = np.zeros(v.shape, v.dtype)
                a[:, :, :S] = pc[k]
                new[k] = jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, cs[k]))
            padded.append(new)
        toks, ev_d, caches = [np.asarray(tok)], None, padded
        for i in range(1, GEN):
            tok_in = jax.device_put(jnp.asarray(toks[-1])[:, None],
                                    NamedSharding(mesh, P(mi.batch_axes,
                                                          None)))
            with comms.record_traffic() as ev:
                t, caches = dec(params, tok_in, caches, jnp.int32(S + i - 1))
            ev_d = ev_d if ev_d is not None else list(ev)
            toks.append(np.asarray(t))
        out[case] = dict(tokens=np.stack(toks, 1), prefill=pre,
                         final=np_caches(caches),
                         ledger_prefill=ledger(ev_p),
                         ledger_decode=ledger(ev_d))
        jax.clear_caches()
    return out


def _reference(out_path: str, group: str) -> None:
    res = _ref_a2a() if group == "a2a" else _ref_serve()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------

def a2a_rank(*, rank: int, world: int) -> dict:
    """Every all-to-all case of this world on this rank (and, in the world
    of 4, the two-level cases and the identity flat run over the joint
    axis beside each)."""
    import torch

    from repro_torch.core import comms, policy
    from repro_torch.launch.mesh import make_mesh

    flat = comms.Axis("x", world, rank, None, tuple(range(world)))
    pair = make_mesh(1, world, tp_nodes=2).tp_axes if world == 4 else None
    runs = [(i, c, flat) for i, c in enumerate(_a2a_cases())]
    if pair is not None:
        runs += [(("h", i), c, pair) for i, c in enumerate(_hier_cases())]
        runs += [(("j", i), c, pair.joint) for i, c in
                 enumerate(_hier_cases()) if c["codec"] == "baseline"]
    out = {}
    for i, case, axis in runs:
        if case["pair"]:
            plan = policy.compile_plan(case["codec"])
            x, w = _a2a_inputs(world, 50 + i[1], case)
        else:
            plan = policy.CommPolicy(
                "rc", rules=(policy.Rule(case["codec"]),)).compile()
            x, w = _a2a_inputs(world, i, case)
        xt = torch.from_numpy(x[rank]).to(getattr(torch, case["dtype"]))
        xt.requires_grad_(True)
        with policy.use_plan(plan), comms.record_traffic() as ev:
            o = comms.all_to_all(xt, axis, case["sa"], case["ca"], "ep")
            (o.float() * torch.from_numpy(w[rank])).sum().backward()
        out[i] = dict(out=o.detach().float().numpy(),
                      grad=xt.grad.float().numpy(), events=list(ev),
                      wire=list(ev.wire))
    return out


def serve_jobs(*, rank: int, world: int, jobs: dict) -> dict:
    from repro_torch.launch.serve import serve_rank
    return {k: serve_rank(rank=rank, world=world, **kw)
            for k, kw in jobs.items()}


def _tcfg(ws: bool = False):
    from repro_torch import configs
    cfg = configs.get(ARCH).reduced()
    return cfg.replace(moe_ws=True) if ws else cfg


def _serve_kwargs(c: dict, tree: str) -> dict:
    c = _sc(c)
    kw = dict(cfg=_tcfg(c["ws"]), mode=c["mode"], dp=c["dp"], tp=c["tp"],
              gen=GEN, scheme=c["scheme"], kv_codec=c["codec"],
              device="cpu", init_from=tree, keep_state=True)
    if c["mode"] == "paged":
        kw.update(prompts=_paged_prompts(), block_tokens=BT, slots=N_SLOTS)
    else:
        kw.update(prompts=_prompts())
    return kw


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from repro.core import compat
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro_torch.launch.train import spawn_world

    base = tmp_path_factory.mktemp("moe")
    procs = {}
    try:
        for group in ("a2a", "serve"):
            out = base / f"ref_{group}.pkl"
            procs[group] = (out, subprocess.Popen(
                [sys.executable, __file__, "--reference", str(out), group],
                env=_ref_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        # the reference's global weights (the same leaves under moe_ws)
        mi = MeshInfo.from_mesh(compat.make_mesh((1, 1), ("data", "model")))
        trees = {}
        for ws in (False, True):
            params = Model(_jcfg(ws), mi).init(jax.random.key(SEED))
            trees[ws] = str(base / f"tree_{ws}.pkl")
            with open(trees[ws], "wb") as f:
                pickle.dump(jax.tree.map(lambda pv: np.asarray(pv.v), params,
                                         is_leaf=lambda x: isinstance(x, Pv)),
                            f)
        groups = {}
        for case, c in SERVE.items():
            groups.setdefault(c["dp"] * c["tp"], {})[case] = _serve_kwargs(
                c, trees[_sc(c)["ws"]])
        with ThreadPoolExecutor(4) as pool:
            a2a = {n: pool.submit(spawn_world, f"{__name__}:a2a_rank", n, {},
                                  600) for n in (2, 4)}
            serve = {w: pool.submit(spawn_world, f"{__name__}:serve_jobs", w,
                                    dict(jobs=jobs), 600)
                     for w, jobs in groups.items()}
            port = {"a2a": {n: f.result() for n, f in a2a.items()}}
            for w, jobs in groups.items():
                for k in jobs:
                    port[k] = [r[k] for r in serve[w].result()]
        ref = {}
        for group, (out, p) in procs.items():
            err = p.communicate(timeout=600)[1]
            assert p.returncode == 0, err[-4000:]
            with open(out, "rb") as f:
                ref[group] = pickle.load(f)
        yield ref, port
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# --------------------------------------------------------------------------
# the all-to-alls
# --------------------------------------------------------------------------

def _same(got: dict, want: dict, rank: int, what) -> None:
    for k in ("out", "grad"):
        np.testing.assert_array_equal(got[k], want[k][rank],
                                      err_msg=f"{what} {k}")
    assert got["events"] == want["events"], what
    # the reference tags its backward's wire "-" (its backward runs
    # outside the site's scope); the port tags it with its forward's site
    untag = [{k: v for k, v in w.items() if k != "tag"}
             for w in got["wire"]]
    assert untag == [{k: v for k, v in w.items() if k != "tag"}
                     for w in want["wire"]], what
    assert {w["tag"] for w in got["wire"]} == {"ep"}, what


@pytest.mark.parametrize("n", (2, 4))
def test_all_to_all_matches_reference(n, results):
    ref, port = results
    for i, case in enumerate(_a2a_cases()):
        for rank, r in enumerate(port["a2a"][n]):
            _same(r[i], ref["a2a"][(n, i)], rank, (n, case, rank))
        ev = port["a2a"][n][0][i]["events"]
        assert [(e["op"], e["bwd_op"], e["tag"], e["level"]) for e in ev] \
            == [("all_to_all", "all_to_all", "ep", "flat")], case
        wire = port["a2a"][n][0][i]["wire"]
        assert [w["op"] for w in wire] == ["all_to_all"] * 2, case


def test_compressed_all_to_all_moves_fewer_bytes(results):
    _, port = results
    by = {(c["codec"], c["sa"], c["ca"], c["dtype"]): i
          for i, c in enumerate(_a2a_cases())}
    r = port["a2a"][4][0]
    sent = {k: sum(w["payload_bytes"] for w in r[i]["wire"])
            for k, i in by.items()}
    raw = sent[("none", 0, 0, "float32")]
    # (n-1)/n of the payload crosses: 3/4 of 2560 f32 values each way
    assert raw == 2 * (2560 * 4) * 3 // 4
    # each 640-value slice pads to a whole 1024-value tile
    assert sent[("bq8", 0, 0, "float32")] < sent[("bq16", 0, 0, "float32")] \
        < raw


def test_hier_all_to_all_matches_reference(results):
    ref, port = results
    for i, case in enumerate(_hier_cases()):
        for rank, r in enumerate(port["a2a"][4]):
            _same(r[("h", i)], ref["a2a"][(4, ("h", i))], rank,
                  (case, rank))
        ev = port["a2a"][4][0][("h", i)]["events"]
        assert [(e["op"], e["axis"], e["level"], e["elems"]) for e in ev] \
            == [("all_to_all", "model", "inner", 2560),
                ("all_to_all", "tpnode", "outer", 2560)], case
        if case["codec"] == "hier_tpp_8_16":
            assert [(e["codec_fwd"], e["codec_bwd"]) for e in ev] == \
                [("bq16", "bq16"), ("bq8", "bq8")]


def test_hier_identity_equals_flat_over_joint_axis(results):
    _, port = results
    for i, case in enumerate(_hier_cases()):
        if case["codec"] != "baseline":
            continue
        for r in port["a2a"][4]:
            for k in ("out", "grad"):
                np.testing.assert_array_equal(r[("h", i)][k],
                                              r[("j", i)][k])


# --------------------------------------------------------------------------
# the expert layer on one rank
# --------------------------------------------------------------------------

LAYER_CASES = ("qwen3", "kimi", "zero_router", "drops")


def _layer_cfg(case: str, pkg):
    from importlib import import_module
    configs = import_module(f"{pkg}.configs")
    arch = "kimi-k2-1t-a32b" if case == "kimi" else ARCH
    cfg = configs.get(arch).reduced()
    return cfg.replace(capacity_factor=0.5) if case == "drops" else cfg


@pytest.mark.parametrize("case", LAYER_CASES)
def test_moe_block_matches_reference(case):
    import jax
    import jax.numpy as jnp
    import torch
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.core import comms as jcomms, compat
    from repro.models import moe as jmoe
    from repro.models.params import (MeshInfo as JMeshInfo, Pv,
                                     init_params, param_specs)
    from repro_torch.models import moe as tmoe
    from repro_torch.models.params import MeshInfo

    jcfg, tcfg = _layer_cfg(case, "repro"), _layer_cfg(case, "repro_torch")
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    mi = JMeshInfo.from_mesh(mesh)
    plan = jmoe.moe_plan(jcfg)
    params = init_params(plan, jax.random.key(3))
    if case == "zero_router":
        params["router"] = Pv(jnp.zeros_like(params["router"].v),
                              params["router"].spec)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    k = jcfg.top_k

    def f(p, xa, wa):
        def loss(p, xa):
            y, aux = jmoe.moe_block(p, xa, jcfg, mi, sp=True)
            return jnp.sum(y * wa) + aux["lb_loss"], (y, aux)
        with jcomms.vma_mode(False):
            (_, (y, aux)), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(p, xa)
        probs = jax.nn.softmax(xa.reshape(-1, xa.shape[-1])
                               @ p["router"].v, axis=-1)
        _, expert = lax.top_k(probs, k)
        return y, aux, grads, probs, expert
    specs = param_specs(plan, mi)
    y, aux, (gp, gx), probs, expert = jax.jit(compat.shard_map(
        f, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), P(), (specs, P()), P(), P()), check_vma=False))(
        params, jnp.asarray(x), jnp.asarray(w))

    tp = {n: torch.from_numpy(np.array(pv.v)).requires_grad_(True)
          for n, pv in params.items() if isinstance(pv, Pv)}
    if "shared" in params:
        tp["shared"] = {n: torch.from_numpy(np.array(pv.v)).requires_grad_(
            True) for n, pv in params["shared"].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_block(tp, xt, tcfg, MeshInfo(), sp=True)
    (ty * torch.from_numpy(w)).sum().add(taux["lb_loss"]).backward()
    tprobs = torch.softmax(xt.detach().reshape(-1, x.shape[-1])
                           @ tp["router"].detach(), dim=-1)
    _, texp = tmoe.top_k(tprobs, k)

    # the chosen experts: exact, ties to the lower index
    np.testing.assert_array_equal(texp.numpy(), np.asarray(expert))
    srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    gap = srt[:, k - 1] - srt[:, k]
    assert ((gap == 0) | (gap > 1e-6)).all(), gap.min()
    if case == "zero_router":
        assert (texp.numpy() == np.arange(k)).all()
    y = np.asarray(y)
    np.testing.assert_allclose(ty.detach().numpy(), y, rtol=0,
                               atol=1e-5 * np.abs(y).max())
    np.testing.assert_allclose(taux["lb_loss"].item(),
                               float(aux["lb_loss"]), rtol=1e-6)
    assert taux["drop_frac"].item() == float(aux["drop_frac"])
    if case in ("zero_router", "drops"):
        assert taux["drop_frac"].item() > 0
    pairs = [(np.asarray(gx), xt.grad)]
    pairs += [(np.asarray(gp[n].v), tp[n].grad)
              for n in ("router", "w_in", "w_gate", "w_out")]
    if "shared" in params:
        pairs += [(np.asarray(gp["shared"][n].v), tp["shared"][n].grad)
                  for n in params["shared"]]
    for want, got in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(),
                                                   1e-30))


def test_capacity_matches_reference():
    from repro import configs as jconfigs
    from repro.models import moe as jmoe
    from repro_torch import configs as tconfigs
    from repro_torch.models import moe as tmoe

    for arch in (ARCH, "kimi-k2-1t-a32b"):
        for cf in (0.5, 1.0, 1.25, 2.0):
            jc = jconfigs.get(arch).replace(capacity_factor=cf)
            tc = tconfigs.get(arch).replace(capacity_factor=cf)
            for t in (1, 2, 3, 7, 16, 33, 100, 256, 1000, 1024, 4096):
                assert tmoe.capacity(tc, t) == jmoe.capacity(jc, t), \
                    (arch, cf, t)
    # the chip cell's reckoning: 1024 tokens, 16 experts, top-8 -> 640
    assert tmoe.capacity(tconfigs.get(ARCH).replace(n_experts=16), 1024) \
        == 640


def test_top_k_takes_the_lower_index_on_ties():
    import jax.numpy as jnp
    import torch
    from jax import lax

    from repro_torch.models import moe as tmoe

    rng = np.random.default_rng(5)
    p = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4   # many ties
    for k in (1, 2, 8):
        wv, wi = lax.top_k(jnp.asarray(p), k)
        gv, gi = tmoe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", (ARCH, "kimi-k2-1t-a32b"))
@pytest.mark.parametrize("ws", (False, True))
def test_full_plans_match_reference(arch, ws):
    """The full configs as shipped (``fsdp_params=True``), and their
    weight-stationary variants, leaf for leaf on dp x tp meshes (plans
    only, nothing allocated)."""
    import jax

    from repro import configs as jconfigs
    from repro.models.config import moe_groups as jgroups
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.models.transformer import model_plan as jplan
    from repro_torch import configs as tconfigs
    from repro_torch.models.config import moe_groups as tgroups
    from repro_torch.models.params import MeshInfo, defs
    from repro_torch.models.transformer import model_plan as tplan

    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    if ws:
        jcfg, tcfg = jcfg.replace(moe_ws=True), tcfg.replace(moe_ws=True)
    assert tcfg.layer_groups == tgroups(*(
        (94,) if arch == ARCH else (61, 1)))
    assert [(g.kind, g.n) for g in tcfg.layer_groups] == \
        [(g.kind, g.n) for g in jgroups(*((94,) if arch == ARCH
                                          else (61, 1)))]
    for dp, tp in ((1, 1), (2, 2), (4, 8), (8, 16)):
        want = [(d.shape, d.spec) for d in jax.tree_util.tree_leaves(
            jplan(jcfg, JMeshInfo(tp=tp, dp=dp)),
            is_leaf=lambda x: hasattr(x, "spec"))]
        got = [(d.shape, d.spec) for d in defs(tplan(tcfg, MeshInfo(
            tp=tp, dp=dp)))]
        assert got == want, (dp, tp)
        # the experts shard over model, ZeRO-3 over data past one rank
        moe = [s for sh, s in got if len(sh) == 4]
        assert moe and all(s[1] == "model" for s in moe)
        assert all("data" in s for s in moe) == (dp > 1 or ws)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _close(got, want, what, bq_tol=None):
    if bq_tol is None:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        lim = bq_tol * max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= lim, (what,
                                                 np.abs(got - want).max(),
                                                 lim)


def _shard(want, dim: int, t: int, n: int):
    w = want.shape[dim] // n
    idx = [slice(None)] * want.ndim
    idx[dim] = slice(t * w, (t + 1) * w)
    return want[tuple(idx)]


def _rows(want, d: int, dp: int):
    b = want.shape[1] // dp
    return want[:, d * b:(d + 1) * b]


@pytest.mark.parametrize("case", [k for k, c in SERVE.items()
                                  if c["mode"] == "batched"])
def test_batched_matches_reference(case, results):
    ref, port = results
    c, want, got = _sc(SERVE[case]), ref["serve"][case], port[case]
    head = _tcfg().attn_mode_for(c["tp"]) == "head"
    bq_tol = None if c["scheme"] == "baseline" else BQ_TOL
    for r, res in enumerate(got):
        assert res["foreign_modules"] == []
        np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                      want["tokens"])
        d, t = r // c["tp"], r % c["tp"]
        for key in ("prefill", "final"):
            for gi, g in enumerate(want[key]):
                for k in ("k", "v"):
                    w = _shard(_rows(g[k], d, c["dp"]), 3 if head else 2,
                               t, c["tp"])
                    _close(res[key][f"/{gi}/{k}"], w,
                           f"rank {r} {key} {gi} {k}", bq_tol)
    for phase in ("prefill", "decode"):
        led, wled = got[0]["ledger"][phase], want[f"ledger_{phase}"]
        priced = {k: v for k, v in led["priced"].items() if v}
        assert priced == {k: v for k, v in wled["per_dim_level"].items()
                          if v}, phase
        assert priced.get("ep/flat", 0) > 0, phase
        tags = sorted({e["tag"] for e in led["events"]})
        assert tags == wled["tags"], phase
    dec_tags = want["ledger_decode"]["tags"]
    assert ("ep@moe_decode_batch" in dec_tags) == c["ws"]


def test_paged_matches_reference(results):
    ref, port = results
    c, want = _sc(SERVE["paged_tp2_bq8"]), ref["serve"]["paged_tp2_bq8"]
    for r, res in enumerate(port["paged_tp2_bq8"]):
        assert res["tokens"] == [want["tokens"][i] for i in range(len(PLENS))]
        assert res["steps"] == want["steps"]
        for gi, g in enumerate(want["pool"]):
            for nm in ("k", "v"):
                for pl in ("q_hi", "scale"):
                    w = _shard(g[nm][pl].astype(np.float32), 3,
                               r % c["tp"], c["tp"])
                    got_pl = res["final"][f"/{gi}/{nm}/{pl}"]
                    if pl == "scale":
                        np.testing.assert_allclose(
                            got_pl, w, rtol=1e-6 if gi == 0 else 1 / 127,
                            atol=0)
                    else:
                        assert np.abs(got_pl - w).max() <= 1
        assert np.abs(res["final"]["/0/k/q_hi"]).sum() > 0


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(sys.argv[2], sys.argv[3])
