"""Serving the port's recurrent families against the reference: the dense
``Server`` (batched prefill, then greedy decode against the recurrent
state and zamba2's shared-attention cache) on ``zamba2-1.2b --reduced``
and ``xlstm-1.3b --reduced``.

Contract asserted here, with the tolerances and their reasons:
  * both archs at ``--tp 2`` and ``--dp 2 --tp 2`` under ``zhybrid_16_8``
    from the same weights (numpy normals from a seed, in the plan's
    layout, loaded by both packages), prompts of 16 tokens, batch 4, 4
    tokens generated: equal tokens; every cache leaf after the prefill
    (the shared block's ``k``/``v`` in the training layout, each recurrent
    state in the decode layout: ``conv``/``state``, ``C``/``n``,
    ``h``/``c``/``n``/``m``) and at the end within 1e-4 of its largest
    value (``test_torch_serve_mesh.py``'s bound for a bq codec on the TP
    collectives: the final states ride ``tp@ssm_state``,
    ``tp@slstm_state`` and the decode's ``tp@ssm_out`` /
    ``tp@xlstm_out`` sums); the ledgers of the prefill and of the first
    decode step priced per ``dim/level`` equal byte for byte, with their
    tags, the prefill's ``pp@ssm_scan`` and (zamba2) ``pp@conv_halo`` or
    (xLSTM) ``ep@slstm_transpose`` among them.

The reference runs in two subprocesses on 4 XLA host devices side by
side (this file re-invokes itself with ``--reference``), the port in
worlds of 2 and 4 ranks beside them.
"""

import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from test_torch_recurrent_train import weights

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("zamba2-1.2b", "xlstm-1.3b")
SEED, B, S, GEN = 7, 4, 16, 4
BQ_TOL = 1e-4
SCHEME = "zhybrid_16_8"
CASES = {f"{a}/{m}": dict(arch=a, dp=dp, tp=2)
         for a in ARCHS for m, dp in (("tp2", 1), ("dp2_tp2", 2))}


def _prompts():
    return np.random.default_rng(SEED).integers(0, 512, (B, S)).astype(
        np.int32)


def _s_max(tp: int) -> int:
    return -(-(S + GEN) // (2 * tp)) * (2 * tp)


# --------------------------------------------------------------------------
# the reference, one subprocess per arch
# --------------------------------------------------------------------------

def _reference(args: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.serve.serve_step import Server
    from repro.train import checkpoint
    from repro.train.train_step import batch_specs

    def is_pv(x):
        return isinstance(x, Pv)

    def np_caches(caches):
        return [{k: np.asarray(v, np.float32) for k, v in c.items()}
                for c in caches]

    def ledger(events):
        return dict(per_dim_level=roofline.ledger_summary(
            events, train=False)["per_dim_level"],
            tags=sorted({e["tag"] for e in events}))

    prompts = _prompts()
    out = {}
    for case in args["cases"]:
        c = CASES[case]
        cfg = configs.get(c["arch"]).reduced()
        mesh = make_mesh(c["dp"], c["tp"])
        mi = MeshInfo.from_mesh(mesh)
        model = Model(cfg, mi)
        with open(args["tree"], "rb") as f:
            tree = pickle.load(f)
        structs = model.structs()
        params = jax.tree.map(
            lambda st, sh, a: Pv(jax.device_put(a.astype(st.v.dtype), sh.v),
                                 st.spec), structs,
            checkpoint.resharded_specs(structs, mesh), tree, is_leaf=is_pv)
        srv = Server(model, mesh, scheme=SCHEME)
        bspecs = batch_specs(cfg, mi)
        batch = {k: jax.device_put(jnp.asarray(prompts),
                                   NamedSharding(mesh, bspecs[k]))
                 for k in ("tokens", "labels")}
        prefill = srv.prefill_step({k: bspecs[k] for k in batch}, B)
        with comms.record_traffic() as ev_p:
            tok, caches = prefill(params, batch)
        pre = np_caches(caches)
        dec, dstructs, cspecs = srv.decode_step(B, _s_max(c["tp"]))
        padded = []                 # the reference launcher's host pad
        for st, cs, pc in zip(dstructs, cspecs, pre):
            new = {}
            for k, v in st.items():
                a = np.zeros(v.shape, v.dtype)
                a[tuple(slice(0, d) for d in pc[k].shape)] = pc[k]
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
    with open(args["out"], "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port's worlds
# --------------------------------------------------------------------------

def serve_jobs(*, rank: int, world: int, jobs: dict) -> dict:
    from repro_torch.launch.serve import serve_rank
    return {k: serve_rank(rank=rank, world=world, **kw)
            for k, kw in jobs.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.train import spawn_world

    base = tmp_path_factory.mktemp("recurrent_serve")
    trees = {a: str(base / f"{a}.tree") for a in ARCHS}
    for a in ARCHS:
        with open(trees[a], "wb") as f:
            pickle.dump(weights(a), f)
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    procs = {}
    for a in ARCHS:
        args = dict(cases=[k for k, c in CASES.items() if c["arch"] == a],
                    tree=trees[a], out=str(base / f"{a}.pkl"))
        procs[a] = (args["out"], subprocess.Popen(
            [sys.executable, __file__, "--reference", json.dumps(args)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    try:
        groups = {}
        for case, c in CASES.items():
            groups.setdefault(c["dp"] * c["tp"], {})[case] = dict(
                arch=c["arch"], reduced=True, mode="batched", dp=c["dp"],
                tp=c["tp"], gen=GEN, scheme=SCHEME, device="cpu",
                init_from=trees[c["arch"]], prompts=_prompts(),
                keep_state=True)
        with ThreadPoolExecutor(2) as pool:
            futs = {w: pool.submit(spawn_world, f"{__name__}:serve_jobs", w,
                                   dict(jobs=jobs), 600)
                    for w, jobs in groups.items()}
            port = {}
            for w, jobs in groups.items():
                res = futs[w].result()
                for k in jobs:
                    port[k] = [r[k] for r in res]
        ref = {}
        for out, p in procs.values():
            err = p.communicate(timeout=600)[1]
            assert p.returncode == 0, err[-4000:]
            with open(out, "rb") as f:
                ref.update(pickle.load(f))
        yield ref, port
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _part(want, spec, d: int, t: int, dp: int, tp: int):
    """Rank (data d, model t)'s part of a global array sharded by the
    port's spec tags."""
    idx = []
    for n, s in zip(want.shape, spec):
        k = {"data": dp, "model": tp}.get(s, 1)
        i = {"data": d, "model": t}.get(s, 0)
        idx.append(slice(i * n // k, (i + 1) * n // k))
    return want[tuple(idx)]


@pytest.mark.parametrize("case", list(CASES))
def test_batched_matches_reference(case, results):
    from repro_torch import configs
    from repro_torch.models.params import MeshInfo
    from repro_torch.serve import kv_cache

    ref, port = results
    c, want, got = CASES[case], ref[case], port[case]
    cfg = configs.get(c["arch"]).reduced()
    mi = MeshInfo(tp=c["tp"], dp=c["dp"])
    specs = {"prefill": kv_cache.prefill_cache_specs(cfg, mi, B),
             "final": kv_cache.cache_structs(cfg, mi, B, _s_max(c["tp"]))[1]}
    for r, res in enumerate(got):
        assert res["foreign_modules"] == []
        np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                      want["tokens"])
        d, t = r // c["tp"], r % c["tp"]
        for key in ("prefill", "final"):
            assert len(want[key]) == len(cfg.layer_groups)
            for gi, g in enumerate(want[key]):
                for k, w in g.items():
                    w = _part(w, specs[key][gi][k], d, t, c["dp"], c["tp"])
                    mine = res[key][f"/{gi}/{k}"]
                    assert mine.shape == w.shape, (key, gi, k)
                    lim = BQ_TOL * max(float(np.abs(w).max()), 1e-30)
                    err = float(np.abs(mine - w).max())
                    assert err <= lim, (r, key, gi, k, err, lim)
    for phase in ("prefill", "decode"):
        led, wled = got[0]["ledger"][phase], want[f"ledger_{phase}"]
        priced = {k: v for k, v in led["priced"].items() if v}
        assert priced == {k: v for k, v in wled["per_dim_level"].items()
                          if v}, phase
        tags = sorted({e["tag"] for e in led["events"]})
        assert tags == wled["tags"], phase
    tags = want["ledger_prefill"]["tags"]
    assert "pp@ssm_scan" in tags
    assert ("pp@conv_halo" in tags) == (c["arch"] == "zamba2-1.2b")
    assert ("ep@slstm_transpose" in tags) == (c["arch"] == "xlstm-1.3b")


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(json.loads(sys.argv[2]))
