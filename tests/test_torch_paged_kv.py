"""The port's paged KV pool and scheduler (repro_torch.serve) against the
reference's.

Contract asserted here:
  * the block allocator never aliases a live block, reuses freed blocks,
    and raises on OOM and double free;
  * pool shapes and dtypes equal the reference's ``pool_structs`` for
    reduced and full-width gemma3-1b under every storage codec (shapes
    only: nothing is allocated at full width);
  * ``write_token`` leaves the same pool planes as the reference's (bit
    for bit), including a dropped write from an inactive slot, and
    ``read_tables`` returns the same K/V in f32 and in bf16;
  * the scheduler hands the device step the same arrays as the
    reference's, step by step, for the same submissions.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import compat
from repro.models.params import MeshInfo as JMeshInfo
from repro.serve import paged_kv as jpkv
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import configs as tconfigs
from repro_torch.models.params import MeshInfo
from repro_torch.serve import paged_kv as tpkv
from repro_torch.serve.scheduler import Scheduler as TScheduler

CODECS = ("none", "bq4", "bq8", "bq16", "bq24")


def _jmi():
    return JMeshInfo.from_mesh(compat.make_mesh((1, 1), ("data", "model")))


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


# --------------------------------------------------------------------------
# allocator
# --------------------------------------------------------------------------

def test_allocator_no_aliasing_and_reuse():
    a = tpkv.BlockAllocator(8)
    got = [a.alloc(f"r{i}") for i in range(8)]
    assert sorted(got) == list(range(8))
    assert got[0] == 0
    with pytest.raises(tpkv.OutOfBlocks):
        a.alloc("overflow")
    a.free([got[3], got[5]])
    assert a.n_free == 2
    b = a.alloc("r_new")
    assert b in (got[3], got[5]) and a.owner(b) == "r_new"


def test_allocator_double_free_and_atomic_alloc_many():
    a = tpkv.BlockAllocator(4)
    b = a.alloc("r")
    a.free([b])
    with pytest.raises(KeyError):
        a.free([b])
    a.alloc("x")
    with pytest.raises(tpkv.OutOfBlocks):
        a.alloc_many("big", 4)
    assert a.n_free == 3


# --------------------------------------------------------------------------
# pool layouts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("codec", CODECS)
def test_pool_structs_match_reference(reduced, codec):
    jcfg, tcfg = jconfigs.get("gemma3-1b"), tconfigs.get("gemma3-1b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert tcfg.layer_groups == tuple(
        type(tcfg.layer_groups[0])(g.kind, g.n, g.window)
        for g in jcfg.layer_groups)
    nb, bt = 40, 16
    jst, _ = jpkv.pool_structs(jcfg, _jmi(), nb, bt, codec)
    tst = tpkv.pool_structs(tcfg, MeshInfo(), nb, bt, codec)
    assert len(jst) == len(tst) == len(tcfg.layer_groups)
    for jg, tg in zip(jst, tst):
        for nm in ("k", "v"):
            if codec == "none":
                pairs = [(jg[nm], tg[nm])]
            else:
                assert set(jg[nm]) == set(tg[nm])
                pairs = [(jg[nm][pl], tg[nm][pl]) for pl in jg[nm]]
            for j, t in pairs:
                if j is None:
                    assert t is None
                    continue
                assert tuple(j.shape) == t.shape
                assert _dtype_name(j.dtype) == _dtype_name(t.dtype)


def test_storage_bits_validation():
    assert tpkv.storage_bits("none") is None
    assert tpkv.storage_bits("bq8") == 8
    for stateful in ("plr8", "ef:bq8"):      # as the reference refuses
        with pytest.raises(ValueError):
            tpkv.storage_bits(stateful)
        with pytest.raises(ValueError):
            jpkv.storage_bits(stateful)
    with pytest.raises(KeyError):
        tpkv.storage_bits("nope")


# --------------------------------------------------------------------------
# write_token / read_tables
# --------------------------------------------------------------------------

def _pools(nb, bt, kv, hd, bits):
    if bits is None:
        z = np.zeros((nb, bt, kv, hd), np.float32)
        planes = {"k": z, "v": z}
    else:
        r = tpkv.token_rows(kv, hd)
        from repro_torch.core import codecs
        lay = codecs.get(f"bq{bits}").storage_row_layout()
        pl = {p: np.zeros((nb, bt, r, w), _dtype_name(d))
              for p, (w, d) in lay.items()}
        pl.setdefault("q_lo", None)
        planes = {"k": pl, "v": dict(pl)}

    def conv(tree, fn):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: conv(v, fn) for k, v in tree.items()}
        return fn(tree)
    return (conv(planes, jnp.asarray),
            conv(planes, lambda a: torch.from_numpy(a.copy())))


def _assert_pools_equal(jp, tp):
    if jp is None:
        assert tp is None
        return
    if isinstance(jp, dict):
        assert set(jp) == set(tp)
        for k in jp:
            _assert_pools_equal(jp[k], tp[k])
        return
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [None, 4, 8, 16, 24])
def test_write_read_match_reference(bits, out_dtype):
    nb, bt, kv, hd, n = 6, 4, 2, 96, 4          # kv*hd = 192: R = 2, padded
    rng = np.random.default_rng(0)
    jpool, tpool = _pools(nb, bt, kv, hd, bits)
    tables = np.asarray([[1, 3], [4, 0], [2, 5], [0, 0]], np.int32)
    for step in range(3):
        k_tok = (rng.normal(size=(n, kv, hd)) * 3).astype(np.float32)
        v_tok = (rng.normal(size=(n, kv, hd)) * 3).astype(np.float32)
        # slot 3 is inactive: its block id is out of range -> dropped write
        blk = np.asarray([1, 4, 5, nb], np.int32)
        off = np.asarray([step, step + 1, step, 0], np.int32)
        jpool = jpkv.write_token(jpool, jnp.asarray(blk), jnp.asarray(off),
                                 jnp.asarray(k_tok), jnp.asarray(v_tok),
                                 bits, backend="jnp")
        tpool = tpkv.write_token(tpool, torch.from_numpy(blk),
                                 torch.from_numpy(off),
                                 torch.from_numpy(k_tok),
                                 torch.from_numpy(v_tok), bits)
        _assert_pools_equal(jpool, tpool)
    jk, jv = jpkv.read_tables(jpool, jnp.asarray(tables), bits, kv, hd,
                              getattr(jnp, out_dtype), backend="jnp")
    tk, tv = tpkv.read_tables(tpool, torch.from_numpy(tables), bits, kv, hd,
                              getattr(torch, out_dtype))
    assert tuple(tk.shape) == (4, 2 * bt, kv, hd)
    if bits is not None:                 # the read's type (dense: the pool's)
        assert tk.dtype == tv.dtype == getattr(torch, out_dtype)
    for j, t in ((jk, tk), (jv, tv)):    # bf16 compared as f32 (exact)
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy())


@pytest.mark.parametrize("bits", [None, 8])
def test_out_of_range_write_is_dropped(bits):
    nb, bt, kv, hd = 4, 2, 1, 128
    _, tpool = _pools(nb, bt, kv, hd, bits)
    before = {k: (v if bits is None else v["q_hi"]).clone()
              for k, v in tpool.items()}
    tok = torch.ones((2, kv, hd))
    tpkv.write_token(tpool, torch.tensor([nb, -1]), torch.tensor([0, 1]),
                     tok, tok, bits)
    for k, v in tpool.items():
        assert torch.equal(before[k], v if bits is None else v["q_hi"])


# --------------------------------------------------------------------------
# scheduler
# --------------------------------------------------------------------------

def _drive(sched_cls, vocab=512):
    """Run a fake step (next token = token + 1) and record every array the
    scheduler hands the device step."""
    rng = np.random.default_rng(3)
    sched = sched_cls(n_slots=3, n_blocks=12, block_tokens=4, max_blocks=4)
    for rid, n in enumerate((5, 9, 3, 7, 11)):
        sched.submit(rid, rng.integers(0, vocab, n).tolist(), 3 + rid % 2)
    seen = []

    def step(params, tok, pool, tables, pos, active):
        seen.append((tok.copy(), tables.copy(), pos.copy(), active.copy()))
        return (tok[:, 0] + 1) % vocab, pool

    finished, _, steps = sched.run(step, None, None)
    return seen, finished, steps


def test_scheduler_step_arrays_match_reference():
    jseen, jfin, jsteps = _drive(JScheduler)
    tseen, tfin, tsteps = _drive(TScheduler)
    assert jsteps == tsteps and jfin == tfin
    assert len(jseen) == len(tseen)
    for a, b in zip(jseen, tseen):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
