"""The port's serving on meshes (the dense ``Server``, paged serving over
data and model ranks, disaggregated prefill/decode with the ``kv``
handoff) against the reference's, on ``gemma3-1b --reduced`` with the
reference's weights (``from_jax_params``, seed 7 as in
``tests/multidev/serve_check.py``), prompts of 16 tokens, batch 4, 4
generated tokens.

Contract asserted here, with the tolerances and their reasons:
  * batched, (a) ``--dp 2 --tp 2`` (ring attention: the cache's sequence
    sharded over tp, the flash-decoding combine) under ``baseline`` and
    ``zhybrid_16_8``, (b) ``--tp 2`` on the ``n_kv_heads=2`` variant (head
    attention) under ``baseline``, (c) ``--tp 4 --tp-nodes 2`` under
    ``hier_tpp_8_16``: equal tokens; the prefill caches and the final
    decode caches within rtol 1e-5 / atol 1e-6 under ``baseline`` (f32
    matmul order), and under a bq codec on the TP collectives within
    ``BQ_TOL`` of the cache's largest value, about three bq16 steps (a
    value within an f32 ulp of a rounding boundary of the bq16 grid may
    land a step, 2^-15 of its row's max-abs, apart, and the step
    propagates through the layers; measured 5.2e-7 after the prefill,
    1.4e-6 after the decode); the prefill's and one decode step's ledger
    priced per ``dim/level`` equal byte for byte with no ``pp``, ``cp``
    or ``kv`` bytes; under ``zhybrid_16_8`` the prefill's gathered
    positions ride the ``tp`` codec at ``tp@attn_pos`` in both packages
    (fault C.5, mirrored); in (c) the fast and slow link bytes equal;
  * paged at dp 2 (six mixed-length requests on 4 slots: slot and block
    reuse) under ``none`` and ``bq8``: equal tokens, and every local pool
    plane equal to the reference's shard of the pool (``none`` within
    rtol 1e-5 / atol 1e-6; ``bq8`` mantissas within +-1 and the first
    layer's scales within rtol 1e-6, ``test_torch_serve.py``'s, the later
    layers' within one bq8 step, rtol 1/127: a first-layer value read one
    step apart enters the next layer's attention, measured 3.4e-5 in
    layer 1); paged at tp 2 on the
    ``n_kv_heads=2`` variant under ``none`` the same; paged under
    ``none`` token-exact against the dense ``Server`` streamed token by
    token (port only, ``serve_page_check.py``'s part 1); paged under
    ``bq8`` the architectures the card serves in ``chip_smoke.py``'s phase
    18, ``minitron-4b`` and ``qwen2-72b --reduced`` at dp 2 x tp 2 and
    ``kimi-k2 --reduced`` at tp 2 with its published ``head_dim`` of 112
    (a token row's read width, 112, not a multiple of 128; its MoE layers
    and shared expert): tokens and every pool plane the same way, each
    plane sharded over model as the reference's;
  * ``serve_page_check.py``'s own case, paged ``qwen2-72b --reduced`` at
    dp 2 x tp 2 (head attention: 2 kv heads) under ``none``: tokens and
    every pool plane as the reference's (the same tolerances), and the
    tokens exact against the dense ``Server`` streamed token by token on
    the same dp 2 x tp 2 world (the prompt on every one of 4 rows, whose
    tokens agree);
  * batched ``qwen2-vl-72b --reduced`` at dp 2 x tp 2 (head attention)
    under ``baseline``, whose decode builds M-RoPE ids from the index
    (the untied head, qkv bias): tokens, caches and ledger as the
    batched cases above;
  * disaggregated ``--dp 1 --tp 2`` (4 ranks) under ``--kv-codec none``
    and ``bq8``: equal decode-pool tokens; the handoff's events all in the
    ``kv`` dimension with no ``tp`` or ``pp`` bytes in its scope; its
    priced bytes the reference's, bq8's strictly fewer than none's;
    ``kv_handoff_seconds`` the reference's at the same two rates; the
    decode pool's caches after the handoff within the batched tolerance
    under ``none`` and within one bq8 step (max |x| / 127 of the leaf, a
    value near a rounding boundary may land on either side; measured
    3.2e-7) under ``bq8``;
  * ``kv_hbm_bytes`` the reference's for none, bq4, bq8, bq16 and bq24 at
    two shapes; ``pool_handoff`` on an axis of one rank is the identity;
    a ``plr8`` kv codec raises ``NotImplementedError`` in both packages.

The reference runs in two subprocesses with 8 XLA host devices each,
side by side (this file re-invokes itself with ``--reference``), and the
port in a world of 4 ranks and one of 2 beside them.
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
SEED, B, S, GEN, BT = 7, 4, 16, 4, 4
PLENS = (5, 9, 12, 7, 6, 10)            # serve_page_check.py's
N_SLOTS = 4
RTOL, ATOL = 1e-5, 1e-6
BQ_TOL = 1e-4                           # of the leaf's largest |value|
# two link rates to price the handoff at (any two: both packages must
# agree at the same rates)
FAST, SLOW = 450e9, 50e9
BATCHED = {
    "dp_tp": dict(dp=2, tp=2, scheme="baseline"),
    "dp_tp_z": dict(dp=2, tp=2, scheme="zhybrid_16_8"),
    "head": dict(tp=2, scheme="baseline", kv2=True),
    "tp_nodes": dict(tp=4, tp_nodes=2, scheme="hier_tpp_8_16"),
    "vl": dict(dp=2, tp=2, scheme="baseline", arch="qwen2-vl-72b"),
}
PAGED = {
    "paged_none": dict(dp=2, codec="none"),
    "paged_bq8": dict(dp=2, codec="bq8"),
    "paged_tp": dict(tp=2, codec="none", kv2=True),
    "paged_qwen2": dict(dp=2, tp=2, codec="none", arch="qwen2-72b"),
    # the architectures phase 18 serves on the card, each with a bq8 pool:
    # minitron-4b and qwen2-72b at dp 2 x tp 2 (head attention: 1 kv head
    # of 16 a rank), kimi-k2 at tp 2 with its published head_dim of 112
    # (a rank's token row 112 of 128 values: the fused KV read's width is
    # not a multiple of 128), its MoE layers and shared expert
    "paged_minitron_bq8": dict(dp=2, tp=2, codec="bq8", arch="minitron-4b"),
    "paged_qwen2_bq8": dict(dp=2, tp=2, codec="bq8", arch="qwen2-72b"),
    "paged_kimi_bq8": dict(tp=2, codec="bq8", arch="kimi-k2-1t-a32b",
                           hd=112),
}
DISAGG = {"disagg_none": dict(tp=2, codec="none"),
          "disagg_bq8": dict(tp=2, codec="bq8")}


def _c(c: dict) -> dict:
    return dict(dict(dp=1, tp=1, tp_nodes=1, scheme="baseline", kv2=False,
                     codec="none", arch="gemma3-1b", hd=0), **c)


def _key(c: dict) -> tuple:
    """The config a case serves: ``_jcfg``'s and ``_tcfg``'s arguments."""
    c = _c(c)
    return c["kv2"], c["arch"], c["hd"]


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


# --------------------------------------------------------------------------
# the reference (subprocesses)
# --------------------------------------------------------------------------

def _jcfg(kv2: bool, arch: str = "gemma3-1b", hd: int = 0):
    from repro import configs
    cfg = configs.get(arch).reduced()
    cfg = cfg.replace(n_kv_heads=2) if kv2 else cfg
    return cfg.replace(head_dim=hd) if hd else cfg


def _ledger(roofline, events) -> dict:
    return dict(per_dim_level=roofline.ledger_summary(
        events, train=False)["per_dim_level"],
        links=roofline.link_bytes(events, train=False),
        pos_codecs=sorted({e["codec_fwd"] for e in events
                           if e["tag"] == "tp@attn_pos"}))


def _reference(out_path: str, group: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.analysis import roofline
    from repro.core import comms
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo
    from repro.serve import paged_kv
    from repro.serve.disagg import DECODE, DisaggServer, make_disagg_mesh
    from repro.serve.scheduler import Scheduler
    from repro.serve.serve_step import PagedServer, Server
    from repro.train.train_step import batch_specs

    key = jax.random.key(SEED)
    prompts = _prompts()
    out = {}

    def np_caches(caches):
        return [{k: np.asarray(v, np.float32) for k, v in c.items()}
                for c in caches]

    def decode_loop(mesh, mi, dec, params, caches, tok0, lift=False):
        toks, ev_d = [tok0], None
        for i in range(1, GEN):
            if lift:          # disagg: the token stream at pool DECODE
                g = np.zeros((2, B, 1), np.int32)
                g[DECODE] = toks[-1][:, None]
                tok_in = jax.device_put(jnp.asarray(g), NamedSharding(
                    mesh, P("pool", mi.batch_axes, None)))
            else:
                tok_in = jax.device_put(
                    jnp.asarray(toks[-1])[:, None],
                    NamedSharding(mesh, P(mi.batch_axes, None)))
            with comms.record_traffic() as ev:
                t, caches = dec(params, tok_in, caches, jnp.int32(S + i - 1))
            ev_d = ev_d if ev_d is not None else list(ev)
            t = np.asarray(t)
            toks.append(t[DECODE] if lift else t)
        return np.stack(toks, 1), caches, ev_d

    if group == "batched":
        for case, c in BATCHED.items():
            c = _c(c)
            cfg = _jcfg(c["kv2"], c["arch"])
            mesh = make_mesh(c["dp"], c["tp"], tp_nodes=c["tp_nodes"])
            mi = MeshInfo.from_mesh(mesh)
            model = Model(cfg, mi)
            params = model.init(key)
            srv = Server(model, mesh, scheme=c["scheme"])
            bspecs = batch_specs(cfg, mi)
            batch = {k: jax.device_put(jnp.asarray(prompts),
                                       NamedSharding(mesh, bspecs[k]))
                     for k in ("tokens", "labels")}
            prefill = srv.prefill_step({k: bspecs[k] for k in batch}, B)
            with comms.record_traffic() as ev_p:
                tok, caches = prefill(params, batch)
            pre = np_caches(caches)
            s_max = _s_max(c["tp"])
            dec, structs, cspecs = srv.decode_step(B, s_max)
            padded = []
            for st, cs, pc in zip(structs, cspecs, pre):
                new = {}
                for k, v in st.items():
                    a = np.zeros(v.shape, v.dtype)
                    a[:, :, :S] = pc[k]
                    new[k] = jax.device_put(jnp.asarray(a),
                                            NamedSharding(mesh, cs[k]))
                padded.append(new)
            toks, caches, ev_d = decode_loop(mesh, mi, dec, params, padded,
                                             np.asarray(tok))
            out[case] = dict(tokens=toks, prefill=pre,
                             final=np_caches(caches),
                             ledger_prefill=_ledger(roofline, ev_p),
                             ledger_decode=_ledger(roofline, ev_d))
            jax.clear_caches()
    else:
        pprompts = _paged_prompts()
        mb = _mb()
        for case, c in PAGED.items():
            c = _c(c)
            mesh = make_mesh(c["dp"], c["tp"])
            mi = MeshInfo.from_mesh(mesh)
            model = Model(_jcfg(c["kv2"], c["arch"], c["hd"]), mi)
            params = model.init(key)
            psrv = PagedServer(model, mesh, kv_codec=c["codec"],
                               block_tokens=BT)
            step, pst, _ = psrv.decode_step(N_SLOTS, N_SLOTS * mb, mb)
            sched = Scheduler(N_SLOTS, N_SLOTS * mb, BT, mb,
                              dp=mi.batch_ways)
            for r, p in enumerate(pprompts):
                sched.submit(r, p, GEN)
            fin, pool, steps = sched.run(step, params,
                                         paged_kv.zero_pool(pst))
            out[case] = dict(tokens=fin, steps=steps,
                             pool=jax.tree.map(np.asarray, pool))
            jax.clear_caches()
        for case, c in DISAGG.items():
            c = _c(c)
            cfg = _jcfg(False)
            mesh = make_disagg_mesh(c["dp"], c["tp"])
            mi = MeshInfo.from_mesh(mesh)
            model = Model(cfg, mi)
            params = model.init(key)
            srv = DisaggServer(model, mesh, kv_codec=c["codec"])
            bspecs = batch_specs(cfg, mi)
            staged = srv.stage_batch({"tokens": prompts, "labels": prompts},
                                     bspecs)
            prefill = srv.prefill_step({k: bspecs[k] for k in staged}, B)
            tok0, caches = prefill(params, staged)
            s_max = _s_max(c["tp"])
            padded = srv.pad_prefill_caches(
                jax.tree.map(np.asarray, caches), B, s_max)
            hand = srv.handoff_step(B, s_max)
            with comms.record_traffic() as ev_h:
                padded = hand(padded)
                jax.block_until_ready(padded)
            ev_h = list(ev_h)
            handed = [{k: np.asarray(v, np.float32)[DECODE]
                       for k, v in p.items()} for p in padded]
            if c["codec"] == "none":
                try:
                    DisaggServer(model, mesh, kv_codec="plr8").handoff_step(
                        B, s_max)(padded)
                    out["plr8_raises"] = None
                except NotImplementedError as e:
                    out["plr8_raises"] = str(e)
            toks, caches, _ = decode_loop(mesh, mi, srv.decode_step(B, s_max),
                                          params, padded,
                                          np.asarray(tok0)[0], lift=True)
            out[case] = dict(
                tokens=toks, handed=handed,
                handoff=_ledger(roofline, ev_h),
                handoff_dims=sorted({roofline.tag_dim(e["tag"])
                                     for e in ev_h}),
                handoff_s=roofline.kv_handoff_seconds(ev_h, ici_bw=FAST,
                                                      dcn_bw=SLOW))
            jax.clear_caches()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _ref_env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "JAX_PLATFORMS": "cpu"}


# --------------------------------------------------------------------------
# the port's ranks
# --------------------------------------------------------------------------

def run_jobs(*, rank: int, world: int, jobs: dict) -> dict:
    """``serve_rank`` (or, for a ``stream`` job, :func:`dense_stream`) for
    every job of ``jobs`` in turn, in this world."""
    from repro_torch.launch.serve import serve_rank
    return {k: (dense_stream if kw.pop("stream", False) else serve_rank)(
        rank=rank, world=world, **kw) for k, kw in jobs.items()}


def dense_stream(*, rank: int, world: int, cfg, dp: int, tp: int,
                 prompts, init_from: str, **_) -> dict:
    """``serve_page_check.py``'s dense reference on this rank: each prompt
    on all ``N_SLOTS`` rows of the dense ``Server`` (rows split over
    data), fed token by token, keeping the predictions once the prompt is
    exhausted (the paged path's write-then-read order)."""
    import torch

    from repro_torch.core import comms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_jax_params
    from repro_torch.serve import kv_cache
    from repro_torch.serve.serve_step import Server

    mi = make_mesh(dp, tp)
    model = Model(cfg, mi, device="cpu")
    with open(init_from, "rb") as f:
        params = from_jax_params(pickle.load(f), cfg, "cpu", mi)
    srv = Server(model)
    s_max = -(-max(PLENS + (GEN,)) // BT) * BT + GEN
    b_loc = kv_cache.batch_local(N_SLOTS, mi)
    out = {}
    for rid, prompt in enumerate(prompts):
        caches = kv_cache.zero_caches(srv.cache_structs(N_SLOTS, s_max)[0],
                                      "cpu")
        toks, cur = [], prompt[0]
        for i in range(len(prompt) + GEN - 1):
            tok, caches = srv.decode(params, torch.full((b_loc, 1), cur),
                                     caches, i)
            tok = comms.raw_all_gather(tok, mi.batch_axes, 0)
            assert bool((tok == tok[0]).all())    # the rows agree
            if i >= len(prompt) - 1:
                toks.append(int(tok[0]))
            cur = prompt[i + 1] if i + 1 < len(prompt) else int(tok[0])
        out[rid] = toks
    return {"tokens": out}


def _tcfg(kv2: bool, arch: str = "gemma3-1b", hd: int = 0):
    from repro_torch import configs
    cfg = configs.get(arch).reduced()
    cfg = cfg.replace(n_kv_heads=2) if kv2 else cfg
    return cfg.replace(head_dim=hd) if hd else cfg


def _head(c: dict) -> bool:
    """Whether the case runs head-mode attention (its caches shard the
    kv heads over model, not the sequence)."""
    return _tcfg(*_key(c)).attn_mode_for(c["tp"]) == "head"


def _kwargs(c: dict, mode: str, tree: str) -> dict:
    c = _c(c)
    kw = dict(cfg=_tcfg(*_key(c)), mode=mode, dp=c["dp"],
              tp=c["tp"],
              tp_nodes=c["tp_nodes"], gen=GEN, scheme=c["scheme"],
              kv_codec=c["codec"], device="cpu", init_from=tree,
              keep_state=True)
    if mode == "paged":
        kw.update(prompts=_paged_prompts(), block_tokens=BT, slots=N_SLOTS)
    else:
        kw.update(prompts=_prompts())
    return kw


def _world(c: dict, mode: str) -> int:
    c = _c(c)
    return c["dp"] * c["tp"] * (2 if mode == "disagg" else 1)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's two groups of cases, side by side, and beside them
    the port's worlds of 4 and 2 ranks from the reference's weights."""
    import jax

    from repro import configs
    from repro.core import compat
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro_torch.launch.train import spawn_world

    base = tmp_path_factory.mktemp("serve_mesh")
    procs = {}
    try:
        for group in ("batched", "rest"):
            out = base / f"ref_{group}.pkl"
            procs[group] = (out, subprocess.Popen(
                [sys.executable, __file__, "--reference", str(out), group],
                env=_ref_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True))
        # the reference's global weights (the same on every mesh: the init
        # draws each global leaf from its key)
        mi = MeshInfo.from_mesh(compat.make_mesh((1, 1), ("data", "model")))
        trees = {}
        for key in {_key(c) for c in (*BATCHED.values(), *PAGED.values())}:
            params = Model(_jcfg(*key), mi).init(
                jax.random.key(SEED))
            trees[key] = str(base / "tree_{}_{}_{}.pkl".format(*key))
            with open(trees[key], "wb") as f:
                pickle.dump(jax.tree.map(lambda pv: np.asarray(pv.v), params,
                                         is_leaf=lambda x: isinstance(x, Pv)),
                            f)
        groups = {}
        for cases, mode in ((BATCHED, "batched"), (PAGED, "paged"),
                            (DISAGG, "disagg")):
            for case, c in cases.items():
                groups.setdefault(_world(c, mode), {})[case] = _kwargs(
                    c, mode, trees[_key(c)])
        # serve_page_check.py's dense reference on the paged case's world
        c = _c(PAGED["paged_qwen2"])
        groups[_world(c, "paged")]["stream_qwen2"] = dict(
            _kwargs(c, "paged", trees[_key(c)]), stream=True)
        with ThreadPoolExecutor(len(groups)) as pool:
            futs = {w: pool.submit(spawn_world, f"{__name__}:run_jobs", w,
                                   dict(jobs=jobs), 900)
                    for w, jobs in groups.items()}
            port = {k: [r[k] for r in futs[w].result()]
                    for w, jobs in groups.items() for k in jobs}
        ref = {}
        for out, p in procs.values():
            err = p.communicate(timeout=900)[1]
            assert p.returncode == 0, err[-4000:]
            with open(out, "rb") as f:
                ref.update(pickle.load(f))
        yield ref, port, trees
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# --------------------------------------------------------------------------
# comparisons
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


def _shard(want, spec_dim: int, t: int, n: int):
    """Model shard ``t`` of ``n`` of ``want`` along ``spec_dim``."""
    w = want.shape[spec_dim] // n
    idx = [slice(None)] * want.ndim
    idx[spec_dim] = slice(t * w, (t + 1) * w)
    return want[tuple(idx)]


def _rows(want, d: int, dp: int):
    b = want.shape[1] // dp
    return want[:, d * b:(d + 1) * b]


def _check_caches(port_ranks, ref_caches, key, c, head, bq_tol=None):
    """Every rank's ``key`` caches against its shard of the reference's
    global caches: rows by data index, the sequence (ring) or the heads
    (head) by model index."""
    for r, res in enumerate(port_ranks):
        d, t = r // c["tp"], r % c["tp"]
        for gi, g in enumerate(ref_caches):
            for k in ("k", "v"):
                want = _shard(_rows(g[k], d, c["dp"]), 3 if head else 2, t,
                              c["tp"])
                _close(res[key][f"/{gi}/{k}"], want,
                       f"rank {r} {key} group {gi} {k}", bq_tol)


@pytest.mark.parametrize("case", list(BATCHED))
def test_batched_matches_reference(case, results):
    ref, port, _ = results
    c, want, got = _c(BATCHED[case]), ref[case], port[case]
    bq_tol = None if c["scheme"] == "baseline" else BQ_TOL
    for res in got:
        assert res["foreign_modules"] == []
        np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                      want["tokens"])
    _check_caches(got, want["prefill"], "prefill", c, _head(c), bq_tol)
    _check_caches(got, want["final"], "final", c, _head(c), bq_tol)
    for phase in ("prefill", "decode"):
        led, wled = got[0]["ledger"][phase], want[f"ledger_{phase}"]
        priced = {k: v for k, v in led["priced"].items() if v}
        assert priced == {k: v for k, v in wled["per_dim_level"].items()
                          if v}, phase
        assert not any(k.split("/")[0] in ("pp", "cp", "kv")
                       for k in priced), priced
        if case == "tp_nodes":
            from repro_torch.analysis import roofline
            assert roofline.link_bytes(led["events"], train=False) == \
                wled["links"], phase
            assert priced.get("tp/outer", 0) > 0
    if c["scheme"] == "zhybrid_16_8":
        # fault C.5: the gathered positions ride the tp codec
        pos = sorted({e["codec_fwd"] for e in got[0]["ledger"]["prefill"]
                      ["events"] if e["tag"] == "tp@attn_pos"})
        assert pos == want["ledger_prefill"]["pos_codecs"] == ["bq16"]


@pytest.mark.parametrize("case", list(PAGED))
def test_paged_matches_reference(case, results):
    ref, port, _ = results
    c, want, got = _c(PAGED[case]), ref[case], port[case]
    for r, res in enumerate(got):
        assert res["tokens"] == [want["tokens"][i]
                                 for i in range(len(PLENS))]
        assert res["steps"] == want["steps"]
        d, t = r // c["tp"], r % c["tp"]
        for gi, g in enumerate(want["pool"]):
            for nm in ("k", "v"):
                if c["codec"] == "none":
                    w = _shard(_rows(g[nm], d, c["dp"]), 3, t, c["tp"])
                    _close(res["final"][f"/{gi}/{nm}"], w,
                           f"rank {r} pool {gi} {nm}")
                    continue
                for pl in ("q_hi", "scale"):
                    # the pool's token rows shard over model (axis 3)
                    w = _shard(_rows(g[nm][pl], d, c["dp"]), 3, t,
                               c["tp"]).astype(np.float32)
                    got_pl = res["final"][f"/{gi}/{nm}/{pl}"]
                    assert got_pl.shape == w.shape
                    if pl == "scale":
                        # the model's first layer tight, later ones within
                        # a bq8 step (a group holds one layer or several)
                        for li in range(w.shape[0]):
                            np.testing.assert_allclose(
                                got_pl[li], w[li], atol=0,
                                rtol=1e-6 if (gi, li) == (0, 0) else 1 / 127)
                    else:
                        assert np.abs(got_pl - w).max() <= 1
    leaf = got[0]["final"]["/0/k" if c["codec"] == "none" else "/0/k/q_hi"]
    assert np.abs(leaf).sum() > 0            # the pool holds the tokens


def test_paged_matches_dense_server_streamed(results):
    """Part 1 of serve_page_check.py, port only: continuous batching over
    the paged pool under none, the six requests on 4 slots, is
    token-exact against the dense Server fed each prompt token by
    token."""
    import torch

    from repro_torch.launch.serve import serve_requests
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_jax_params
    from repro_torch.serve import kv_cache
    from repro_torch.serve.serve_step import Server

    _, _, trees = results
    cfg = _tcfg(False)
    model = Model(cfg, device="cpu")
    with open(trees[_key({})], "rb") as f:
        params = from_jax_params(pickle.load(f), cfg, "cpu")
    prompts = _paged_prompts()
    fin, _, _, _ = serve_requests(model, params, prompts, GEN, kv_codec="none",
                                  block_tokens=BT, slots=N_SLOTS)
    srv = Server(model)
    s_max = -(-max(PLENS + (GEN,)) // BT) * BT + GEN
    for rid, prompt in enumerate(prompts):
        caches = kv_cache.zero_caches(srv.cache_structs(1, s_max)[0], "cpu")
        out, cur = [], prompt[0]
        for i in range(len(prompt) + GEN - 1):
            tok, caches = srv.decode(params, torch.tensor([[cur]]), caches, i)
            if i >= len(prompt) - 1:
                out.append(int(tok[0]))
            cur = prompt[i + 1] if i + 1 < len(prompt) else int(tok[0])
        assert fin[rid] == out, rid


def test_paged_qwen2_exact_against_dense_server(results):
    """serve_page_check.py's part 1 on its own case: paged serving of
    ``qwen2-72b --reduced`` at dp 2 x tp 2 (head attention at tp 2) is
    token-exact against the dense Server streamed on the same world."""
    _, port, _ = results
    dense = port["stream_qwen2"]
    for r, res in enumerate(port["paged_qwen2"]):
        assert dense[r]["tokens"] == dense[0]["tokens"]
        assert res["tokens"] == [dense[0]["tokens"][i]
                                 for i in range(len(PLENS))], r


@pytest.mark.parametrize("case", list(DISAGG))
def test_disagg_matches_reference(case, results):
    from repro_torch.analysis import roofline

    ref, port, _ = results
    c, want, got = _c(DISAGG[case]), ref[case], port[case]
    per_pool = c["dp"] * c["tp"]
    for r, res in enumerate(got):
        pool, t = r // per_pool, r % c["tp"]
        assert res["pool"] == pool
        led = res["ledger"]["handoff"]
        dims = sorted({roofline.tag_dim(e["tag"]) for e in led["events"]})
        assert dims == want["handoff_dims"] == ["kv"]
        assert {k: v for k, v in led["priced"].items() if v} == \
            {k: v for k, v in want["handoff"]["per_dim_level"].items() if v}
        assert roofline.kv_handoff_seconds(led["events"], FAST, SLOW) == \
            want["handoff_s"]
        if pool != 1:
            continue
        np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                      want["tokens"])
        for gi, g in enumerate(want["handed"]):
            for k in ("k", "v"):
                w = _shard(g[k], 2, t, c["tp"])
                if c["codec"] == "none":
                    _close(res["handoff"][f"/{gi}/{k}"], w, f"{gi} {k}")
                else:
                    _close(res["handoff"][f"/{gi}/{k}"], w, f"{gi} {k}",
                           1 / 127)


def test_disagg_bq8_moves_fewer_bytes(results):
    _, port, _ = results
    byt = {case: port[case][0]["ledger"]["handoff"]["priced"]["kv/flat"]
           for case in DISAGG}
    assert 0 < byt["disagg_bq8"] < byt["disagg_none"], byt


def test_plr8_kv_codec_raises_in_both(results):
    import torch

    from repro_torch.core import comms, policy
    from repro_torch.core.comms import Axis

    ref, _, _ = results
    assert ref["plr8_raises"] and "plr8" in ref["plr8_raises"]
    plan = policy.compile_plan(policy.as_policy("baseline").with_rules(
        policy.Rule("plr8", dim="kv")))
    with policy.use_plan(plan), pytest.raises(NotImplementedError,
                                              match="plr8"):
        comms.pool_handoff(torch.ones(4, 128), Axis("pool", 2))


def test_pool_handoff_on_one_rank_is_identity():
    import torch

    from repro_torch.core import comms
    from repro_torch.core.comms import Axis

    x = torch.arange(12.0).reshape(3, 4)
    with comms.record_traffic() as ev:
        assert comms.pool_handoff(x, Axis("pool", 1)) is x
        assert comms.pool_handoff(x, None) is x
    assert list(ev) == []


@pytest.mark.parametrize("shape", [(64, 16, 2, 1, 16), (37, 4, 26, 1, 256)])
def test_kv_hbm_bytes_matches_reference(shape):
    from repro.analysis import roofline as jroof
    from repro_torch.analysis import roofline as troof

    for codec in ("none", "bq4", "bq8", "bq16", "bq24"):
        for dtype in ("bfloat16", "float32"):
            assert troof.kv_hbm_bytes(*shape, codec, dtype) == \
                jroof.kv_hbm_bytes(*shape, codec, dtype), (codec, dtype)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(sys.argv[2], sys.argv[3])
