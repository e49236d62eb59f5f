"""The port's compressed collectives (repro_torch.core.comms) over gloo
worlds of 2, 3 and 4 CPU processes, against the reference's rings over as
many XLA host devices.

Contract asserted here:
  * ``_ring_schedule`` equals the reference's over a sweep of row counts,
    bidirectional splits and chunk counts;
  * for ``psum``, ``reduce_scatter``, ``all_gather``,
    ``reduce_scatter_flat``, ``all_gather_flat``, the ring core
    (``_ring_reduce_scatter``: the sum chunk and the final wire) and
    ``_ppermute_impl`` under bq8, bq16 and bq24, unidirectional and
    bidirectional (realized, and fallen back below the tile floor), every
    rank's outputs are bit-equal to the reference's, and the ledger's
    analytic events and measured wire events are equal, event for event;
  * under ``none`` the outputs agree to f32 rounding (gloo and XLA sum in
    different orders) and the ledger bytes are equal;
  * ``all_gather`` of a bf16 ``[2, 8, 64]`` activation along axis 0, 1 and
    2 under bq16 (the card's fused gathered decode), and along axis 1
    under gq8 (the codec's default decode tail), bit-equal in a world of
    2;
  * ``reduce_scatter`` of a bf16 activation to ``[2, 8, 64]`` chunks along
    axis 0, 1 and 2 (and to ``[2, 32, 64]`` chunks along axis 1, where the
    bidirectional, two-stripe ring splits into four parts) under bq16 in
    worlds of 2, 3 and 4, bit-equal, ledger included, through the block
    forms and through the shard-view ring the card runs (forced on the
    CPU, where the view forms run their plain versions);
  * carried-state codecs over worlds of 2 and 4, each collective called
    twice in one ``codec_state_io`` region (the second call sees the
    first's state): ``ef:bq8`` (``reduce_scatter_flat``, ``psum``,
    ``all_gather_flat``) equal to the reference bit for bit, outputs and
    residuals; ``plr8`` and ``ef:plr8`` (``reduce_scatter_flat``, ``psum``)
    within ``PLR_TOL`` of the largest output, residual or factor entry
    (the port draws Q0 without JAX, 1e-6 from the reference's, and both
    sum in other orders); the ledger equal event for event; every rank
    holding a bit-identical factor Q after the calls.

XLA:CPU fuses the multiply of the reference's fused ring hop into its add
(see ``test_torch_kernels_ring.py``), and a decode's multiply into error
feedback's ``xc - dec``; the port rounds them separately, as its CUDA
kernels do.  The reference here runs with its jnp hop and decode oracles
rounding the multiply first (an opaque integer no-op after it), so every
other step is compared bit for bit.

The reference runs in a subprocess with
``--xla_force_host_platform_device_count=4`` (this file re-invokes itself
with ``--reference``), like ``tests/test_comms_multidev.py``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 3, 4)
STATEFUL_WORLDS = (2, 4)
BIG, SMALL = (48, 1000), (12, 37)
ACT = (2, 8, 64)                       # a bf16 activation shard
# plr8 / ef:plr8 against the reference, relative to the largest entry of
# each output, residual or factor.  Measured on these inputs: at most
# 1.8e-6 (worlds of 2 and 4).
PLR_TOL = 2e-5


def _cases(n: int) -> list:
    out = []
    for codec in ("bq8", "bq16", "bq24"):
        for bidir in (False, True):
            ops = ("psum", "reduce_scatter", "all_gather",
                   "reduce_scatter_flat", "all_gather_flat", "ring")
            if bidir and codec != "bq8":      # the ring core suffices
                ops = ("psum", "ring")
            for op in ops:
                out.append(dict(op=op, codec=codec, bidir=bidir, chunks=1,
                                shape=BIG))
    out.append(dict(op="ring", codec="bq8", bidir=True, chunks=2, shape=BIG))
    out.append(dict(op="psum", codec="bq8", bidir=True, chunks=1,
                    shape=SMALL))                        # tile-floor fallback
    out.append(dict(op="ppermute", codec="bq8", bidir=False, chunks=1,
                    shape=SMALL))
    for op in ("psum", "reduce_scatter", "all_gather"):
        out.append(dict(op=op, codec="none", bidir=False, chunks=1,
                        shape=BIG))
    if n == 2:
        # a bf16 activation gathered along each axis: bq16 in one fused
        # decode on the card, gq8 through the codec's default tail
        for codec, axis_dim in (("bq16", 0), ("bq16", 1), ("bq16", 2),
                                ("gq8", 1)):
            out.append(dict(op="all_gather", codec=codec, bidir=False,
                            chunks=1, shape=ACT, axis_dim=axis_dim,
                            dtype="bfloat16"))
    # a bf16 activation reduce-scattered along each axis to chunks of ACT
    # (the card reads the chunks in place through shard views), bidir
    # with two stripes (below the tile floor: one part); and chunks of 32
    # rows, where the ring's four parts are realized; each through the
    # block forms (the CPU's path) and through the view forms' ring
    # (``view``: the card's path, on the views' plain versions)
    for axis_dim, chunk in ((0, ACT), (1, ACT), (2, ACT), (1, (2, 32, 64))):
        shape = list(chunk)
        shape[axis_dim] *= n
        for view in (False, True):
            out.append(dict(op="reduce_scatter", codec="bq16", bidir=True,
                            chunks=2, shape=tuple(shape), axis_dim=axis_dim,
                            dtype="bfloat16", view=view))
    return out


def _stateful_cases() -> list:
    out = []
    for codec in ("plr8", "ef:bq8", "ef:plr8"):
        for op in ("reduce_scatter_flat", "psum"):
            out.append(dict(op=op, codec=codec, bidir=False, chunks=1,
                            shape=BIG))
    out.append(dict(op="all_gather_flat", codec="ef:bq8", bidir=False,
                    chunks=1, shape=BIG))
    # a payload whose chunks reach past the matrix view (zero chunks)
    out.append(dict(op="reduce_scatter_flat", codec="plr8", bidir=False,
                    chunks=1, shape=SMALL))
    return out


def _inputs(n: int, shape) -> np.ndarray:
    rng = np.random.default_rng(1000 * n + shape[0])
    x = rng.normal(size=(n,) + tuple(shape)) * 3.0
    x[:, 0] = 0.0                                      # an all-zero row
    return x.astype(np.float32)


# --------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# --------------------------------------------------------------------------

def round_first_oracles() -> None:
    """Patch the reference's jnp hop and decode oracles to round the
    decode's multiply before the add (an opaque integer no-op after it),
    as the port's kernels and plain versions do (ROADMAP C.3, C.10)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.kernels import ops, ref

    def sep_add(a, b):
        m = (b != b).astype(jnp.uint32)
        return lax.bitcast_convert_type(
            lax.bitcast_convert_type(a, jnp.uint32) ^ m, jnp.float32) + b

    def dae(q_hi, q_lo, scale, local, *, bits):
        s = sep_add(ref.bq_decode_ref(q_hi, q_lo, scale, bits),
                    local.astype(jnp.float32))
        return ref.bq_encode_ref(s, bits) + (s,)

    def dec(q_hi, q_lo, scale, *, bits):
        # an opaque no-op after the decode, so XLA cannot fuse its multiply
        # into a consumer (error feedback's xc - dec)
        d = ref.bq_decode_ref(q_hi, q_lo, scale, bits)
        return lax.bitcast_convert_type(lax.bitcast_convert_type(
            d, jnp.uint32) ^ (d != d).astype(jnp.uint32), jnp.float32)

    st = ("bits",)
    ops._decode_ref = jax.jit(dec, static_argnames=st)
    ops._dae_ref = jax.jit(dae, static_argnames=st)
    ops._daew_ref = jax.jit(lambda *a, bits: dae(*a, bits=bits)[:3],
                            static_argnames=st)
    ops._da_ref = jax.jit(lambda q_hi, q_lo, scale, local, *, bits: sep_add(
        ref.bq_decode_ref(q_hi, q_lo, scale, bits),
        local.astype(jnp.float32)), static_argnames=st)


def _reference(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import codecs, comms, compat, policy
    from repro.kernels import ops
    from repro.kernels.ref import BLOCK

    round_first_oracles()

    def body(op, n, codec_name, axis_dim=0):
        def f(xl):
            x = xl[0]
            if op == "psum":
                outs = {"out": comms.psum(x, "x", "dp")}
            elif op == "reduce_scatter":
                outs = {"out": comms.reduce_scatter(x, "x", axis_dim, "dp")}
            elif op == "all_gather":
                outs = {"out": comms.all_gather(x, "x", axis_dim, "dp")}
            elif op in ("reduce_scatter_flat", "all_gather_flat"):
                ch = comms.reduce_scatter_flat(x.reshape(-1), "x", "dp")
                outs = {"out": ch if op == "reduce_scatter_flat" else
                        comms.all_gather_flat(ch, "x", x.size, "zero")}
            elif op == "ring":
                codec = policy.current_plan().codec("dp")
                xb = comms._chunked_blocks(x.reshape(-1), n)
                acc, wire = comms._ring_reduce_scatter(xb, "x", codec)
                outs = {"out": acc, **{f"wire.{k}": v for k, v in
                                       wire.items() if v is not None}}
            else:
                codec = policy.current_plan().codec("pp", "fwd")
                perm = [(j, (j + 1) % n) for j in range(n)]
                outs = {"out": comms._ppermute_impl(x, "x", perm, codec)}
            return {k: v[None] for k, v in outs.items()}
        return f

    def leaves(st, prefix="state"):
        out = {}
        for k, v in st.items():
            out.update(leaves(v, f"{prefix}.{k}") if isinstance(v, dict)
                       else {f"{prefix}.{k}": v})
        return out

    def stateful_body(op, n, codec_name):
        c = codecs.get(codec_name)

        def f(xl):
            x = xl[0]
            shapes = {"dp": x.shape if op == "psum" else (x.size,)}
            if op == "all_gather_flat":
                shapes["zero"] = (ops.padded_rows(-(-x.size // n)) * BLOCK,)
            states = {k: c.init_state(sh, jnp.float32)
                      for k, sh in shapes.items()}
            with comms.codec_state_io(states) as cio:
                outs = {"out": body(op, n, codec_name)(xl)["out"][0],
                        "out2": body(op, n, codec_name)(xl)["out"][0]}
            outs.update(leaves(cio.collect()))
            return {k: v[None] for k, v in outs.items()}
        return f

    res = {}
    for n in WORLDS:
        mesh = compat.make_mesh((n,), ("x",), devices=jax.devices()[:n])
        seen = {}              # cases that differ only in the port's path
        for i, case in enumerate(_cases(n)):
            same = repr({k: v for k, v in case.items() if k != "view"})
            if same in seen:
                res[(n, i)] = res[seen[same]]
                continue
            seen[same] = (n, i)
            plan = policy.CommPolicy(
                "rc", rules=(policy.Rule(case["codec"]),)).compile()
            x = jnp.asarray(_inputs(n, case["shape"])).astype(
                case.get("dtype", "float32"))

            def wrapped(xl, case=case):
                with policy.use_plan(plan), comms.ring_options(
                        case["bidir"], case["chunks"]):
                    return body(case["op"], n, case["codec"],
                                case.get("axis_dim", 0))(xl)
            fn = jax.jit(compat.shard_map(wrapped, mesh=mesh,
                                          in_specs=(P("x"),),
                                          out_specs=P("x"),
                                          check_vma=False))
            with comms.record_traffic() as events:
                out = jax.block_until_ready(fn(x))
            # bf16 outputs as f32 (exact), as the port reports them
            res[(n, i)] = ({k: np.asarray(v.astype(jnp.float32) if
                                       v.dtype == jnp.bfloat16 else v)
                            for k, v in out.items()},
                           list(events), list(events.wire))
        if n not in STATEFUL_WORLDS:
            continue
        for i, case in enumerate(_stateful_cases()):
            plan = policy.CommPolicy(
                "rc", rules=(policy.Rule(case["codec"]),)).compile()
            x = jnp.asarray(_inputs(n, case["shape"]))

            def wrapped(xl, case=case):
                with policy.use_plan(plan):
                    return stateful_body(case["op"], n, case["codec"])(xl)
            fn = jax.jit(compat.shard_map(wrapped, mesh=mesh,
                                          in_specs=(P("x"),),
                                          out_specs=P("x"),
                                          check_vma=False))
            with comms.record_traffic() as events:
                out = jax.block_until_ready(fn(x))
            res[(n, "s", i)] = ({k: np.asarray(v) for k, v in out.items()},
                                list(events), list(events.wire))
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "comms.pkl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--reference", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port():
    from repro_torch.launch.train import spawn_world
    res = {}
    for n in WORLDS:
        cases = [{k: v for k, v in c.items() if k != "shape"}
                 for c in _cases(n)]
        # the ranks take row ``rank`` of their case's input
        per_rank = spawn_world(
            "test_torch_comms:_port_rank", n,
            dict(cases=cases, shapes=[c["shape"] for c in _cases(n)]),
            timeout=600)
        for i in range(len(cases)):
            res[(n, i)] = [r[i] for r in per_rank]
        if n not in STATEFUL_WORLDS:
            continue
        cases = _stateful_cases()
        per_rank = spawn_world(
            "test_torch_comms:_port_rank", n,
            dict(cases=[{k: v for k, v in c.items() if k != "shape"}
                        for c in cases],
                 shapes=[c["shape"] for c in cases]),
            timeout=600)
        for i in range(len(cases)):
            res[(n, "s", i)] = [r[i] for r in per_rank]
    return res


def _port_rank(*, rank, world, cases, shapes):
    """One rank of the port's world: each case on its own input.  A case
    with ``view`` runs the reduce-scatter ring on the codec's shard-view
    forms, as on the card; on the CPU they run their plain versions."""
    from unittest import mock

    from repro_torch.core import codecs
    from repro_torch.launch.ring_check import collectives_rank
    out = []
    for case, shape in zip(cases, shapes):
        case = dict(case)
        with mock.patch.object(codecs.BqCodec, "view_forms",
                               lambda self, x, v=case.pop("view", False): v):
            out += collectives_rank(rank=rank, world=world, cases=[case],
                                    payload=_inputs(world, shape))
    return out


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def test_ring_schedule_matches_reference():
    from repro.core import comms as jcomms
    from repro_torch.core import comms as tcomms
    for m in (0, 8, 16, 24, 40, 96, 128, 1000, 1024):
        for bidir in (False, True):
            for chunks in (1, 2, 3, 5):
                assert tcomms._ring_schedule(m, bidir, chunks) == \
                    jcomms._ring_schedule(m, bidir, chunks), \
                    (m, bidir, chunks)


@pytest.mark.parametrize("n", WORLDS)
def test_rings_match_reference(n, reference, port):
    for i, case in enumerate(_cases(n)):
        j_out, j_events, j_wire = reference[(n, i)]
        for rank, r in enumerate(port[(n, i)]):
            assert set(r["result"]) == set(j_out), case
            for k, got in r["result"].items():
                want = j_out[k][rank]
                assert got.shape == want.shape, (case, k)
                if case["codec"] == "none":
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-5, err_msg=str(case))
                else:
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{case} {k}")
            assert r["events"] == j_events, case
            assert r["wire"] == j_wire, case


@pytest.mark.parametrize("n", STATEFUL_WORLDS)
def test_stateful_collectives_match_reference(n, reference, port):
    for i, case in enumerate(_stateful_cases()):
        j_out, j_events, j_wire = reference[(n, "s", i)]
        ranks = port[(n, "s", i)]
        for rank, r in enumerate(ranks):
            assert set(r["result"]) == set(j_out), case
            for k, got in r["result"].items():
                want = j_out[k][rank]
                assert got.shape == want.shape, (case, k)
                if "plr" in case["codec"]:
                    scale = max(np.abs(want).max(), 1e-30)
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=PLR_TOL * scale,
                                               err_msg=f"{case} {k}")
                else:
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{case} {k}")
            assert r["events"] == j_events, case
            assert r["wire"] == j_wire, case
        for k in ranks[0]["result"]:
            if k.endswith(".q"):             # every rank holds the same Q
                for r in ranks[1:]:
                    assert r["result"][k].tobytes() == \
                        ranks[0]["result"][k].tobytes(), (case, k)
        if case["codec"].startswith("ef:"):  # the residual was exercised
            assert np.abs(ranks[0]["result"]["state.dp.residual"]).max() > 0


@pytest.mark.parametrize("n", WORLDS)
def test_ledger_shows_realized_schedule(n, port):
    """The bidirectional split is realized on the big payload and falls
    back, visibly, below the tile floor; compressed wires are smaller."""
    cases = _cases(n)
    by = {(c["op"], c["codec"], c["bidir"], c["chunks"], c["shape"]): i
          for i, c in enumerate(cases)}
    big = port[(n, by[("psum", "bq8", True, 1, BIG)])][0]["wire"][0]
    assert big["op"] == "rs_ring" and big["bidir"] and big["parts"] == 2
    small = port[(n, by[("psum", "bq8", True, 1, SMALL)])][0]["wire"][0]
    assert small["fallback"] and not small["bidir"] and small["parts"] == 1
    striped = port[(n, by[("ring", "bq8", True, 2, BIG)])][0]["wire"][0]
    assert striped["parts"] == 4
    raw = sum(w["payload_bytes"] * w["hops"] for w in
              port[(n, by[("all_gather", "none", False, 1, BIG)])][0]["wire"])
    bq8 = sum(w["payload_bytes"] * w["hops"] for w in
              port[(n, by[("all_gather", "bq8", False, 1, BIG)])][0]["wire"])
    assert bq8 < 0.3 * raw


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference(sys.argv[2])
