"""The port's hierarchical two-level collectives (repro_torch.core.comms'
``AxisPair`` dispatch and hier_* family) against the reference's, in one
gloo world of 8 CPU processes and one reference subprocess on 8 XLA host
devices.

Two node-factored axes, each 2 nodes x 4 ranks: the data axis ``(node,
data)`` (the shapes of ``tests/multidev/hier_check.py``) and the model axis
``(tpnode, model)`` (``tp_hier_check.py``).  Contract asserted here, per
rank:
  * under ``baseline`` on integer payloads (sums exact in any order), the
    forward and the backward (the gradient of ``sum(op(x) * w)``) of
    ``psum`` (hier_all_reduce), ``reduce_scatter``, ``all_gather`` along
    axis 1, ``ppermute`` over a full ring (edges inside and across nodes)
    and a partial shift, and the Megatron f/g pair over the model pair
    equal the reference's bit for bit;
  * under ``hier_zpp_8_16`` (data pair) and ``hier_tpp_8_16`` (model pair;
    bq16 inner, bq8 outer) on normal payloads, forward and backward bit
    for bit, the reference's ring and decode oracles rounding first
    (ROADMAP C.3); the bf16 reduce-scatter and all-gather also through
    the shard-view ring the card runs (forced on the CPU);
  * every case's analytic ledger events equal the reference's event for
    event (op, axis, level, elems, codecs, ring schedule, payload bytes),
    and its measured wire events too (their site tag aside: the port
    tags backward wires with their forward's site);
  * ``_stateful_hier_psum``: ``ef:bq8`` inner with ``plr4`` outer, called
    twice in one codec-state region from the reference's initial state:
    both levels' final state within ``PLR_TOL`` of the largest entry (plr
    sums in another order), the outputs too but for at most 0.1 % of the
    entries, which may sit one bq8 step away (the reduced chunks are
    gathered under bq8, and plr's 1e-6 differences can cross a rounding
    boundary; measured: 8 of 192000), the ledger equal; ``plr4`` at the
    inner level raises the reference's message;
  * the roofline's ``link_bytes``, ``dim_level_bytes``,
    ``collective_seconds`` and ``_two_level_ar_events`` equal the
    reference's on the same ledger.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
PAIRS = {"data": dict(dp=8, nodes=2), "model": dict(tp=8, tp_nodes=2)}
JAX_AXES = {"data": ("node", "data"), "model": ("tpnode", "model")}
RING = tuple((j, (j + 1) % WORLD) for j in range(WORLD))
SHIFT = tuple((j, j + 3) for j in range(5))     # edges inside and across
# plr against the reference, relative to the largest entry (as
# test_torch_comms.py)
PLR_TOL = 2e-5


def _cases() -> list:
    out = []
    for pair, scheme, tags in (
            ("data", "baseline", dict(psum="dp", rs="dp", ag="zero")),
            ("model", "baseline", dict(psum="tp", rs="tp", ag="tp")),
            ("data", "hier_zpp_8_16", dict(psum="dp", rs="dp", ag="zero")),
            ("model", "hier_tpp_8_16", dict(psum="tp", rs="tp", ag="tp"))):
        base = dict(pair=pair, scheme=scheme, dtype="float32", view=False)
        out += [dict(base, op="psum", tag=tags["psum"], shape=(4, 256)),
                dict(base, op="reduce_scatter", tag=tags["rs"],
                     shape=(2, 32, 64)),
                dict(base, op="all_gather", tag=tags["ag"], shape=(2, 4, 64)),
                dict(base, op="ppermute", tag="pp", shape=(4, 256),
                     perm=RING),
                dict(base, op="ppermute", tag="pp", shape=(4, 256),
                     perm=SHIFT)]
        if pair == "model":
            out += [dict(base, op="g", tag="tp", shape=(8, 16)),
                    dict(base, op="f", tag="tp", shape=(8, 16))]
        if scheme != "baseline":
            # bf16 activations through the flat forms, and the
            # reduce-scatter also through the shard-view ring
            for view in (False, True):
                out.append(dict(base, op="reduce_scatter", tag=tags["rs"],
                                shape=(2, 32, 64), dtype="bfloat16",
                                view=view))
            out.append(dict(base, op="all_gather", tag=tags["ag"],
                            shape=(2, 4, 64), dtype="bfloat16"))
    return out


def _out_shape(case) -> tuple:
    shape = list(case["shape"])
    if case["op"] == "reduce_scatter":
        shape[1] //= WORLD
    elif case["op"] == "all_gather":
        shape[1] *= WORLD
    return tuple(shape)


def _inputs(i: int, case) -> tuple:
    """(x, w): every rank's payload and cotangent, ``[WORLD, ...]``;
    integers under ``baseline``, normals otherwise."""
    rng = np.random.default_rng(100 + i)
    if case["scheme"] == "baseline":
        x = rng.integers(-8, 9, (WORLD,) + case["shape"])
        w = rng.integers(-4, 5, (WORLD,) + _out_shape(case))
    else:
        x = rng.normal(size=(WORLD,) + case["shape"]) * 3.0
        w = rng.normal(size=(WORLD,) + _out_shape(case))
    return x.astype(np.float32), w.astype(np.float32)


STATEFUL_SHAPE = (40, 300)
STATEFUL_RULES = {"ok": (("ef:bq8", "inner"), ("plr4", "outer")),
                  "raises": (("plr4", "inner"), ("bq8", "outer"))}


def _stateful_slots(n: int) -> dict:
    """Slot -> (codec, payload length) of the stateful case: the inner
    level's whole payload, the outer level's padded 1/4 chunk."""
    from repro_torch.kernels import ops
    cl = ops.padded_rows(-(-n // 4)) * 128
    return {"dp_inner@hs": ("ef:bq8", n), "dp_outer@hs": ("plr4", cl)}


def _stateful_input() -> np.ndarray:
    rng = np.random.default_rng(7)
    return (rng.normal(size=(WORLD,) + STATEFUL_SHAPE) * 2.0) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# the reference, in a subprocess with 8 host devices
# --------------------------------------------------------------------------

def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import codecs, comms, compat, policy
    from test_torch_comms import round_first_oracles

    round_first_oracles()
    res = {"cases": [], "stateful": {}}
    meshes = {p: compat.make_mesh((2, 4), ax) for p, ax in JAX_AXES.items()}

    def op_fn(case, axis):
        op, tag = case["op"], case["tag"]
        if op == "psum":
            return lambda a: comms.psum(a, axis, tag)
        if op == "reduce_scatter":
            return lambda a: comms.reduce_scatter(a, axis, 1, tag)
        if op == "all_gather":
            return lambda a: comms.all_gather(a, axis, 1, tag)
        if op == "ppermute":
            return lambda a: comms.ppermute(a, axis, list(case["perm"]), tag)
        if op == "g":
            return lambda a: comms.copy_fwd_psum_bwd(a, axis, tag)
        return lambda a: comms.psum_fwd_copy_bwd(a, axis, tag)

    for i, case in enumerate(_cases()):
        axis = compat.AxisPair(*JAX_AXES[case["pair"]])
        mesh, spec = meshes[case["pair"]], P(JAX_AXES[case["pair"]])
        fn = op_fn(case, axis)
        plan = policy.compile_plan(case["scheme"])
        dt = jnp.dtype(case["dtype"])

        def body(xl, wl, fn=fn, plan=plan):
            with policy.use_plan(plan), comms.vma_mode(False):
                out, vjp = jax.vjp(fn, xl[0])
                (g,) = vjp(wl[0].astype(out.dtype))
            return out[None].astype(jnp.float32), g[None].astype(jnp.float32)
        f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                     out_specs=(spec, spec),
                                     check_vma=False))
        x, w = _inputs(i, case)
        with comms.record_traffic() as events:
            out, g = f(jnp.asarray(x).astype(dt), jnp.asarray(w))
        res["cases"].append(dict(out=np.asarray(out), grad=np.asarray(g),
                                 events=list(events),
                                 wire=list(events.wire)))

    axis = compat.AxisPair("node", "data")
    x = _stateful_input()
    n = int(np.prod(STATEFUL_SHAPE))
    slots = _stateful_slots(n)
    for kind, rules in STATEFUL_RULES.items():
        plan = policy.CommPolicy("hs", rules=tuple(
            policy.Rule(c, dim="dp", level=lvl) for c, lvl in rules)) \
            .compile()
        states = {k: codecs.get(c).init_state((m,), jnp.float32)
                  for k, (c, m) in slots.items()}
        init = jax.tree.map(np.asarray, states)

        def body(xl, plan=plan, states=states):
            with policy.use_plan(plan), \
                    comms.codec_state_io(states) as cio:
                a = comms.psum(xl[0], axis, policy.Site("dp", "hs"))
                b = comms.psum(xl[0], axis, policy.Site("dp", "hs"))
            return (a[None], b[None],
                    jax.tree.map(lambda v: v[None], cio.collect()))
        spec = P(("node", "data"))
        f = jax.jit(compat.shard_map(body, mesh=meshes["data"],
                                     in_specs=(spec,),
                                     out_specs=(spec, spec, spec),
                                     check_vma=False))
        try:
            with comms.record_traffic() as events:
                a, b, st = f(jnp.asarray(x))
        except NotImplementedError as e:
            res["stateful"][kind] = dict(error=str(e))
            continue
        res["stateful"][kind] = dict(
            out=np.asarray(a), out2=np.asarray(b),
            state=jax.tree.map(np.asarray, st), init=init,
            events=list(events), wire=list(events.wire))
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "hier_comms.pkl"
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--reference", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port(reference):
    from repro_torch.launch.train import spawn_world
    inits = {k: v["init"] for k, v in reference["stateful"].items()
             if "init" in v}
    per_rank = spawn_world("test_torch_hier_comms:_port_rank", WORLD,
                           dict(inits=inits), timeout=600)
    return per_rank


def _port_rank(*, rank, world, inits):
    """One rank of the port's world: every case, then the stateful ones."""
    from unittest import mock

    import torch

    from repro_torch.core import codecs, comms, policy
    from repro_torch.launch.mesh import comm_axes, make_mesh

    torch.set_num_threads(1)
    axes = {"data": comm_axes(make_mesh(**PAIRS["data"], tp=1), "data"),
            "model": comm_axes(make_mesh(**PAIRS["model"], dp=1), "model")}
    out = {"cases": [], "stateful": {}}
    for i, case in enumerate(_cases()):
        axis = axes[case["pair"]]
        x, w = _inputs(i, case)
        dt = getattr(torch, case["dtype"])
        xt = torch.from_numpy(x[rank]).to(dt).requires_grad_(True)
        op, tag = case["op"], case["tag"]
        with policy.use_plan(policy.compile_plan(case["scheme"])), \
                mock.patch.object(codecs.BqCodec, "view_forms",
                                  lambda self, t, v=case["view"]: v), \
                comms.record_traffic() as events:
            if op == "psum":
                y = comms.psum(xt, axis, tag)
            elif op == "reduce_scatter":
                y = comms.reduce_scatter(xt, axis, 1, tag)
            elif op == "all_gather":
                y = comms.all_gather(xt, axis, 1, tag)
            elif op == "ppermute":
                y = comms.ppermute(xt, axis, case["perm"], tag)
            elif op == "g":
                y = comms.copy_fwd_psum_bwd(xt, axis, tag)
            else:
                y = comms.psum_fwd_copy_bwd(xt, axis, tag)
            (g,) = torch.autograd.grad(
                y, xt, torch.from_numpy(w[rank]).to(y.dtype))
        out["cases"].append(dict(
            out=y.detach().float().numpy(), grad=g.float().numpy(),
            events=list(events), wire=list(events.wire)))

    axis = axes["data"]
    x = torch.from_numpy(_stateful_input()[rank])
    for kind, rules in STATEFUL_RULES.items():
        plan = policy.CommPolicy("hs", rules=tuple(
            policy.Rule(c, dim="dp", level=lvl) for c, lvl in rules)) \
            .compile()
        if kind in inits:       # the reference's, the same on every rank
            states = _tensors(inits[kind])
        else:
            n = x.numel()
            states = {k: codecs.get(c).init_state((m,), torch.float32)
                      for k, (c, m) in _stateful_slots(n).items()}
        try:
            with policy.use_plan(plan), comms.codec_state_io(states) as cio, \
                    comms.record_traffic() as events:
                a = comms.psum(x, axis, policy.Site("dp", "hs"))
                b = comms.psum(x, axis, policy.Site("dp", "hs"))
        except NotImplementedError as e:
            out["stateful"][kind] = dict(error=str(e))
            continue
        out["stateful"][kind] = dict(
            out=a.numpy(), out2=b.numpy(), state=_numpy(cio.collect()),
            events=list(events), wire=list(events.wire))
    return out


def _tensors(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _rows(a):
    """A flat payload's 128-value rows, zero-padded."""
    a = a.reshape(-1)
    return np.pad(a, (0, -a.size % 128)).reshape(-1, 128)


def _untagged(wire):
    return [{k: v for k, v in w.items() if k != "tag"} for w in wire]


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(_cases())),
                         ids=[f"{c['pair']}-{c['scheme']}-{c['op']}"
                              f"{'-shift' if c.get('perm') == SHIFT else ''}"
                              f"-{c['dtype']}{'-view' if c['view'] else ''}"
                              for c in _cases()])
def test_hier_collective_matches_reference(i, reference, port):
    case = _cases()[i]
    ref = reference["cases"][i]
    for rank, r in enumerate(port):
        got = r["cases"][i]
        for k in ("out", "grad"):
            np.testing.assert_array_equal(got[k], ref[k][rank],
                                          err_msg=f"{case} rank {rank} {k}")
        assert got["events"] == ref["events"], case
        assert _untagged(got["wire"]) == _untagged(ref["wire"]), case
    levels = {ev["level"] for ev in ref["events"]}
    assert levels <= {"inner", "outer"} and levels, case


def test_stateful_hier_psum_matches_reference(reference, port):
    ref = reference["stateful"]["ok"]
    flips = 0
    for rank, r in enumerate(port):
        got = r["stateful"]["ok"]
        for k in ("out", "out2"):
            # the gathered sum rides bq8: where plr's other sum order moves
            # a value across a rounding boundary, it lands one step away
            # (a bq row is 128 values of the flat vector: the 1/4 chunks
            # are whole rows)
            want, diff = _rows(ref[k][rank]), _rows(got[k] - ref[k][rank])
            far = np.abs(diff) > PLR_TOL * np.abs(want).max()
            step = np.abs(want).max(1, keepdims=True) / 127
            assert (np.abs(diff) <= 1.01 * step)[far].all(), (rank, k)
            flips += int(far.sum())
        for slot, leaves in got["state"].items():
            for leaf, v in (leaves.items() if isinstance(leaves, dict)
                            else [("", leaves)]):
                want = ref["state"][slot][leaf][rank]
                np.testing.assert_allclose(
                    v, want, rtol=0, atol=PLR_TOL * np.abs(want).max(),
                    err_msg=f"rank {rank} {slot}.{leaf}")
        assert got["events"] == ref["events"]
        assert got["wire"] == ref["wire"]
    assert flips <= 1e-3 * WORLD * 2 * np.prod(STATEFUL_SHAPE), flips
    # the inner level carried error feedback, the outer a low-rank factor
    st = port[0]["stateful"]["ok"]["state"]
    assert np.abs(st["dp_inner@hs"]["residual"]).max() > 0
    assert st["dp_outer@hs"]["q"].shape[1] == 4


def test_plr_at_the_inner_level_raises_as_reference(reference, port):
    want = reference["stateful"]["raises"]["error"]
    assert "route plr* to the outer level" in want
    for r in port:
        assert r["stateful"]["raises"]["error"] == want


def test_link_terms_match_reference(reference):
    from repro.analysis import roofline as jrl
    from repro_torch.analysis import roofline as trl

    events = [ev for c in reference["cases"] for ev in c["events"]]
    for train in (False, True):
        for slow in ((), ("node",), ("data", "model")):
            assert trl.link_bytes(events, train, slow) == \
                jrl.link_bytes(events, train, slow)
            assert trl.collective_seconds(events, train, 50e9, 25e9, slow) \
                == jrl.collective_seconds(events, train, slow, 50e9, 25e9)
        for dim in ("dp", "zero", "tp", "pp"):
            for lvl in ("inner", "outer", "flat"):
                assert trl.dim_level_bytes(events, dim, lvl, train) == \
                    jrl.dim_level_bytes(events, dim, lvl, train)
        summary = trl.ledger_summary(events, train)
        want = jrl.ledger_summary(events, train)
        assert summary == want
    for scheme in ("hier_zpp_8_16", "hier_zpp_4_16", "hier_zpp_plr8_16",
                   "baseline"):
        for elems, n_i, n_o in ((1 << 20, 4, 2), (1000, 8, 3)):
            ev_t = trl._two_level_ar_events(scheme, elems, n_i, n_o)
            ev_j = jrl._two_level_ar_events(scheme, elems, n_i, n_o)
            assert ev_t == ev_j
            assert trl.link_bytes(ev_t, False) == jrl.link_bytes(ev_j, False)
    with pytest.raises(TypeError):
        trl.collective_seconds(events, True)    # no default link rates


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
