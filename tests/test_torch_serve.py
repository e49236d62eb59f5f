"""The port's paged server (repro_torch.serve.serve_step) against the
reference's, on reduced gemma3-1b with the reference's weights.

Contract asserted here:
  * ``from_jax_params`` carries the reference's parameters over;
  * one layer's ``attn_decode_paged`` matches the reference's output
    (atol 1e-5, f32) and leaves the same pool;
  * both ``PagedServer``s, driven by their schedulers with the same
    prompts (longer than the reduced window of 8, more requests than
    slots), emit the same tokens and leave close final pools: under
    ``none`` within rtol 1e-5 / atol 1e-6; under ``bq8`` with scales
    within rtol 1e-6 and mantissas within +-1, since f32 matmul order may
    tip a value across a rounding boundary.  The pools are the real check:
    with random weights the greedy output tends to echo the last prompt
    token, so equal tokens alone prove little about the KV path;
  * the launcher accepts the serving flags, defaults to ``--mode
    batched``, refuses a flag its mode would not use and ``--mode disagg
    --tp-nodes`` (C.16), raises the reference's ``NotImplementedError``
    for paged serving under ring attention before any spawn, and serves
    on the CPU when asked (paged on one rank, batched on four).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import compat
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.models.params import MeshInfo as JMeshInfo, Pv
from repro.serve import paged_kv as jpkv
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.serve_step import PagedServer as JPagedServer
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model as TModel
from repro_torch.models.params import from_jax_params
from repro_torch.models.transformer import layer_slice
from repro_torch.serve import paged_kv as tpkv
from repro_torch.serve.scheduler import Scheduler as TScheduler
from repro_torch.serve.serve_step import PagedServer as TPagedServer

BT, GEN, N_SLOTS = 4, 4, 2
PLENS = (11, 14, 9)                      # all longer than the window of 8


@pytest.fixture(scope="module")
def models():
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jcfg = jconfigs.get("gemma3-1b").reduced()
    jmodel = JModel(jcfg, JMeshInfo.from_mesh(mesh))
    jparams = jmodel.init(jax.random.key(0))
    tree = jax.tree.map(lambda pv: np.asarray(pv.v), jparams,
                        is_leaf=lambda x: isinstance(x, Pv))
    tcfg = tconfigs.get("gemma3-1b").reduced()
    tparams = from_jax_params(tree, tcfg, device="cpu")
    tmodel = TModel(tcfg, device="cpu")
    return mesh, jmodel, jparams, tmodel, tparams


def _to_np(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_np(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def test_from_jax_params_carries_weights(models):
    _, _, jparams, tmodel, tparams = models
    w = tparams["groups"][0]["attn"]["wq"]
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jparams["groups"][0]["attn"]["wq"].v))
    assert tmodel.n_params() == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("bits", [None, 8])
def test_attn_decode_paged_single_layer(models, bits):
    _, jmodel, jparams, tmodel, tparams = models
    cfg_j, cfg_t = jmodel.cfg, tmodel.cfg
    rng = np.random.default_rng(5)
    n, nb, mb = 3, 6, 2
    codec = "none" if bits is None else f"bq{bits}"
    jst, _ = jpkv.pool_structs(cfg_j, jmodel.mi, nb, BT, codec)
    tst = tpkv.pool_structs(cfg_t, tmodel.mi, nb, BT, codec)
    # a pool with earlier tokens already in it, written through both
    prior = (rng.normal(size=(nb * BT, cfg_t.n_kv_heads, cfg_t.head_dim_))
             .astype(np.float32))
    # layer 0 of group 0's pool
    jpool = jax.tree.map(lambda a: a[0], jpkv.zero_pool(jst)[0])
    tpool = layer_slice(tpkv.zero_pool(tst, "cpu")[0], 0)
    blk_all = np.repeat(np.arange(nb, dtype=np.int32), BT)
    off_all = np.tile(np.arange(BT, dtype=np.int32), nb)
    jwrite = jax.jit(jpkv.write_token, static_argnames=("bits", "backend"))
    jpool = jwrite(jpool, jnp.asarray(blk_all), jnp.asarray(off_all),
                   jnp.asarray(prior), jnp.asarray(prior * 0.5), bits=bits,
                   backend="jnp")
    tpkv.write_token(tpool, torch.from_numpy(blk_all),
                     torch.from_numpy(off_all), torch.from_numpy(prior),
                     torch.from_numpy(prior * 0.5), bits)
    tables = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
    pos = np.asarray([5, 2, 7], np.int32)
    active = np.asarray([True, True, False])
    x = (rng.normal(size=(n, 1, cfg_t.d_model))).astype(np.float32)
    g = cfg_t.layer_groups[0]                   # the sliding-window layer
    jp = jax.tree.map(lambda pv: Pv(pv.v[0], pv.spec[1:]),
                      jparams["groups"][0]["attn"],
                      is_leaf=lambda v: isinstance(v, Pv))

    def jrun(p, x, pool, tables, pos, active):
        return jattn.attn_decode_paged(p, x, pool, tables, pos, active,
                                       cfg_j, jmodel.mi, bits=bits,
                                       block_tokens=BT, window=g.window,
                                       backend="jnp")

    fn = jax.jit(compat.shard_map(jrun, mesh=models[0],
                                  in_specs=(jax.sharding.PartitionSpec(),) * 6,
                                  out_specs=jax.sharding.PartitionSpec(),
                                  check_vma=False))
    jy, jpool = fn(jp, jnp.asarray(x), jpool, jnp.asarray(tables),
                   jnp.asarray(pos), jnp.asarray(active))
    tp = {k: v[0] for k, v in tparams["groups"][0]["attn"].items()}
    ty, tpool = tattn.attn_decode_paged(
        tp, torch.from_numpy(x), tpool, torch.from_numpy(tables),
        torch.from_numpy(pos), torch.from_numpy(active), cfg_t, tmodel.mi,
        bits=bits, block_tokens=BT, window=g.window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)
    _assert_pool_close(_to_np(jpool), _to_np(tpool), bits)


@pytest.mark.parametrize("window,kv_chunk", [(0, 4), (5, 4), (5, 64)])
def test_full_attention_chunked_matches_reference(window, kv_chunk):
    """The online softmax over KV chunks (a Python loop here, lax.scan in
    the reference) agrees with the reference's, chunked or not."""
    rng = np.random.default_rng(9)
    B, Sq, Sk, H, KV, hd = 2, 3, 13, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    q_pos = np.asarray([[9, 10, 11], [4, 5, 12]], np.int32)
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    k_valid = k_pos <= np.asarray([[11], [12]])
    want = jattn.full_attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                                causal=True, window=window,
                                k_valid=jnp.asarray(k_valid),
                                kv_chunk=kv_chunk)
    got = tattn.full_attention(
        *map(torch.from_numpy, (q, k, v, q_pos, np.ascontiguousarray(k_pos))),
        causal=True, window=window, k_valid=torch.from_numpy(k_valid),
        kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _assert_pool_close(jp, tp, bits):
    if isinstance(jp, list):
        assert len(jp) == len(tp)
        for a, b in zip(jp, tp):
            _assert_pool_close(a, b, bits)
        return
    for nm in ("k", "v"):
        if bits is None:
            np.testing.assert_allclose(tp[nm], jp[nm], rtol=1e-5, atol=1e-6)
            continue
        np.testing.assert_allclose(tp[nm]["scale"], jp[nm]["scale"],
                                   rtol=1e-6, atol=0)
        d = np.abs(tp[nm]["q_hi"].astype(np.int32)
                   - jp[nm]["q_hi"].astype(np.int32))
        assert d.max() <= 1, d.max()


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).tolist() for n in PLENS]


@pytest.mark.parametrize("codec", ["none", "bq8"])
def test_paged_server_matches_reference(models, codec):
    mesh, jmodel, jparams, tmodel, tparams = models
    prompts = _prompts(tmodel.cfg.vocab_size)
    mb = tpkv.blocks_needed(max(PLENS) + GEN, BT)
    n_blocks = N_SLOTS * mb

    jsrv = JPagedServer(jmodel, mesh, kv_codec=codec, block_tokens=BT)
    jstep, jst, _ = jsrv.decode_step(N_SLOTS, n_blocks, mb)
    jsched = JScheduler(N_SLOTS, n_blocks, BT, mb)
    tsrv = TPagedServer(tmodel, kv_codec=codec, block_tokens=BT)
    tstep, tst = tsrv.decode_step(N_SLOTS, n_blocks, mb)
    tsched = TScheduler(N_SLOTS, n_blocks, BT, mb)
    for rid, p in enumerate(prompts):
        jsched.submit(rid, p, GEN)
        tsched.submit(rid, p, GEN)
    jfin, jpool, jsteps = jsched.run(jstep, jparams, jpkv.zero_pool(jst))
    tfin, tpool, tsteps = tsched.run(tstep, tparams,
                                     tpkv.zero_pool(tst, "cpu"))
    assert jsteps == tsteps
    assert jfin == tfin
    assert all(len(v) == GEN for v in tfin.values())
    _assert_pool_close(_to_np(jpool), _to_np(tpool),
                       None if codec == "none" else 8)
    # the pool really holds the streamed tokens (not an all-zero pass)
    leaf = tpool[0]["k"] if codec == "none" else tpool[0]["k"]["q_hi"]
    assert leaf.abs().sum() > 0


def test_launcher_refuses_unported_flags(monkeypatch):
    """The flags of the batched and disaggregated modes, of sharded meshes
    and of the compression policy are accepted; ``--mode`` defaults to
    ``batched`` as in the reference; ``--tp-nodes`` with ``--mode
    disagg`` (which the reference ignores there) is refused, never
    ignored (fault C.16), as is a flag the mode would not use; paged
    serving where gemma3-1b runs ring attention (tp 2) raises the
    reference's ``NotImplementedError`` before any rank is spawned."""
    import repro_torch.launch.train as ttrain

    ap = tlaunch.parser()
    assert ap.parse_args(["--arch", "gemma3-1b"]).mode == "batched"
    for extra in (["--mode", "batched"], ["--mode", "disagg"],
                  ["--mode", "paged"], ["--dp", "2"], ["--tp", "2"],
                  ["--tp", "4", "--tp-nodes", "2"], ["--max-len", "64"],
                  ["--scheme", "zhybrid_16_8"], ["--codec-for", "kv=bq16"],
                  ["--ring-bidir"], ["--ring-chunks", "2"],
                  ["--no-compress-below", "64"],
                  ["--mode", "disagg", "--kv-codec", "bq8"]):
        args = ap.parse_args(["--arch", "gemma3-1b", *extra])
        assert tlaunch.unported(args) == [], extra
    for extra, what in ((["--mode", "disagg", "--tp-nodes", "2"],
                         "--tp-nodes 2 is refused"),
                        (["--mode", "batched", "--kv-codec", "bq8"],
                         "--kv-codec 'bq8' has no effect")):
        msgs = tlaunch.unported(ap.parse_args(["--arch", "gemma3-1b",
                                               *extra]))
        assert len(msgs) == 1 and what in msgs[0], (extra, msgs)
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "gemma3-1b", "--reduced", *extra,
                          "--device", "cpu"])

    def no_spawn(*a, **k):
        raise AssertionError("spawned ranks")
    monkeypatch.setattr(ttrain, "spawn_world", no_spawn)
    with pytest.raises(NotImplementedError) as want:
        jpkv.pool_structs(jconfigs.get("gemma3-1b"),
                          JMeshInfo(tp=2, model_axis="model"), 1, BT)
    with pytest.raises(NotImplementedError) as got:
        tlaunch.main(["--arch", "gemma3-1b", "--mode", "paged", "--tp", "2",
                      "--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_launcher_serves_on_cpu(capsys):
    tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--mode", "paged",
                  "--kv-codec", "bq8", "--device", "cpu", "--batch", "3",
                  "--slots", "2", "--prompt-len", "10", "--gen", "3"])
    out = capsys.readouterr().out
    assert "paged[bq8] gemma3-1b on cpu: 3 requests" in out


def test_launcher_serves_batched_on_a_mesh_on_cpu(capsys):
    """``--mode batched --dp 2 --tp 2`` serves on 4 ranks and prints the
    reference's lines and the priced wire per dim/level."""
    tlaunch.main(["--arch", "gemma3-1b", "--reduced", "--mode", "batched",
                  "--dp", "2", "--tp", "2", "--scheme", "zhybrid_16_8",
                  "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill[4x16]" in out and "-> first tokens" in out
    assert "decoded 2 steps in" in out and "on cpu, 4 ranks" in out
    assert "'tp/flat'" in out
