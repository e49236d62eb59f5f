"""The port's carried-state codecs (``ef:*``, ``plr*``) against the
reference's, on one CPU process: the cases of ``tests/test_codec_state.py``
that do not need a mesh, plus what the port adds.

Contract asserted here:
  * parameterized names parse, and bad ones fail at construction;
  * stateless codecs carry no state; a stateful codec's state template
    (``init_state`` on the meta device) has the structure, shapes and
    dtypes of what ``encode`` returns, and a plan's template holds exactly
    its stateful sites;
  * ``encode``/``decode`` and the new state agree with the reference: bit
    for bit for ``ef:bq*`` (the reference's decode rounded before the
    subtraction, as the port's is: XLA would fuse it into an FMA), within
    ``PLR_TOL`` of the largest entry for ``plr*`` and ``ef:plr*``;
  * the error-feedback residual is the inner codec's error, and error
    feedback de-biases the truncating codec; plr is exact on a low-rank
    payload, its warm factor improves, its wire is ``r * (m + n)`` floats;
  * the in-place variants (compensate into a donated payload, the new
    residual into the old buffer) equal the pure ones bit for bit, and a
    reduce-scatter chunk reconstructed from its own rows equals the whole
    reconstruction sliced, bit for bit;
  * stateful codecs raise at autodiff sites (the reference's message) and
    outside a codec-state region; a one-rank trainer threads the state
    (template, init, step) and a stateless policy has none; the reference's
    stacked codec state is sliced per rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import codecs, comms, policy, schemes
from repro_torch.kernels import lowrank

STATEFUL = ("ef:bq4", "ef:bq8", "ef:tq8", "plr4", "plr8", "ef:plr4")
STATELESS = ("none", "mpc", "bq4", "bq8", "bq16", "bq24", "gq8", "tq8")
# plr against the reference, relative to the largest entry: the port draws
# Q0 without JAX (1e-6 apart) and sums in other orders.  Measured: 2.4e-6.
PLR_TOL = 2e-5


def _rand(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,)) * scale).astype(np.float32)


def _shapes(st):
    if isinstance(st, dict):
        return {k: _shapes(v) for k, v in st.items()}
    return tuple(st.shape), st.dtype


# --------------------------------------------------------------------------
# names
# --------------------------------------------------------------------------

def test_parameterized_names_parse():
    assert codecs.get("ef:bq4").name == "ef:bq4"
    assert codecs.get("ef:bq4") is codecs.get("ef:bq4")       # cached
    assert codecs.get("plr8").rank == 8
    assert codecs.get("ef:plr4").inner.rank == 4
    assert codecs.get("ef:tq8").inner is codecs.get("tq8")
    assert codecs.get("plr8").kind == "lowrank"
    assert codecs.get("ef:bq4").kind == "ef"


@pytest.mark.parametrize("bad", ["ef:", "ef:none", "ef:mpc", "ef:ef:bq4",
                                 "plr0", "plrx", "ef:bq9", "plr", "plr256"])
def test_bad_parameterized_names_rejected(bad):
    with pytest.raises(KeyError):
        codecs.get(bad)


# --------------------------------------------------------------------------
# state templates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", STATELESS)
def test_stateless_codecs_have_no_state(name):
    c = codecs.get(name)
    assert not c.stateful
    assert c.init_state((256,), torch.float32) is None
    _, st = c.encode(torch.from_numpy(_rand(256)))
    assert st is None


@pytest.mark.parametrize("name", STATEFUL)
@pytest.mark.parametrize("n", [100, 1000, 1 << 14])
def test_init_state_template_matches_encode_output(name, n):
    c = codecs.get(name)
    x = torch.from_numpy(_rand(n, seed=n))
    tmpl = _shapes(c.init_state(x.shape, x.dtype, "meta"))
    _, st1 = c.encode(x, c.init_state(x.shape, x.dtype))
    assert _shapes(st1) == tmpl
    _, st2 = c.encode(x, st1)                # a second step threads cleanly
    assert _shapes(st2) == tmpl


def test_plan_codec_state_template():
    pol = schemes.get("zhybrid_16_8").as_policy().with_rules(
        policy.Rule("ef:bq4", dim="dp", name="zero1_grad*"),
        policy.Rule("plr8", dim="tp", name="grad_rep"))
    sites = [(policy.Site("dp", "zero1_grad"), (1000,), torch.float32),
             (policy.Site("zero", "zero1_param"), (250,), torch.float32),
             (policy.Site("tp", "grad_rep", "bwd"), (100000,), torch.float32)]
    tmpl = pol.compile().codec_state_template(sites)
    assert tmpl == {"dp@zero1_grad": {"residual": ((1000,), torch.float32)},
                    "tp_bwd@grad_rep": {"q": ((512, 8), torch.float32)}}
    assert schemes.get("zhybrid_16_8").as_policy().compile() \
        .codec_state_template(sites) == {}


# --------------------------------------------------------------------------
# the codecs against the reference
# --------------------------------------------------------------------------

@pytest.fixture
def jdecode_rounded(monkeypatch):
    """The reference's bq decode with its multiply rounded before any
    consumer (an opaque integer no-op), as the port's is."""
    def dec(q_hi, q_lo, scale, *, bits):
        d = jref.bq_decode_ref(q_hi, q_lo, scale, bits)
        return jax.lax.bitcast_convert_type(jax.lax.bitcast_convert_type(
            d, jnp.uint32) ^ (d != d).astype(jnp.uint32), jnp.float32)
    monkeypatch.setattr(jops, "_decode_ref",
                        jax.jit(dec, static_argnames=("bits",)))


def _leaves(st, prefix=""):
    out = {}
    for k, v in (st or {}).items():
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", ["ef:bq4", "ef:bq8", "ef:tq8", "plr4",
                                  "plr8", "ef:plr8"])
def test_codec_matches_reference(name, jdecode_rounded):
    x = _rand(20000, seed=11, scale=3.0)
    jc, tc = jcodecs.get(name), codecs.get(name)
    jst, tst = jc.init_state(x.shape, jnp.float32), \
        tc.init_state(x.shape, torch.float32)
    for step in range(3):                 # the state carries across steps
        xs = x * (1.0 + 0.1 * step)
        jw, jst = jc.encode(jnp.asarray(xs), jst)
        tw, tst = tc.encode(torch.from_numpy(xs), tst)
        pairs = [(np.asarray(jc.decode(jw, x.shape, jnp.float32)),
                  tc.decode(tw, x.shape, torch.float32).numpy(), "decode")]
        pairs += [(w, _leaves(tst)[k], k) for k, w in _leaves(jst).items()]
        pairs += [(np.asarray(jw[k]), tw[k].numpy(), f"wire {k}")
                  for k in jw if jw[k] is not None]
        for want, got, what in pairs:
            assert got.shape == want.shape, what
            if "plr" in name:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=PLR_TOL * np.abs(want).max(),
                    err_msg=f"step {step} {what}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"step {step} {what}")


def test_ef_residual_is_inner_quantization_error():
    c = codecs.get("ef:bq4")
    x = torch.from_numpy(_rand(512, seed=7, scale=10.0))
    wire, st1 = c.encode(x, c.init_state(x.shape, x.dtype))
    assert torch.equal(st1["residual"], x - c.decode(wire, x.shape, x.dtype))


def test_ef_debiases_truncating_codec():
    raw, ef = codecs.get("tq8"), codecs.get("ef:tq8")
    x = torch.from_numpy(_rand(2048, seed=9, scale=3.0))
    wire, _ = raw.encode(x)
    raw_err = float((raw.decode(wire, x.shape, x.dtype) - x).abs().mean())
    st = ef.init_state(x.shape, x.dtype)
    dec_sum = torch.zeros_like(x)
    for _ in range(16):
        wire, st = ef.encode(x, st)
        dec_sum += ef.decode(wire, x.shape, x.dtype)
    ef_err = float((dec_sum / 16 - x).abs().mean())
    assert ef_err < 0.25 * raw_err, (ef_err, raw_err)
    assert float(st["residual"].abs().max()) < float(x.abs().max())


def test_plr_exact_on_low_rank_payload():
    m, ncols = lowrank.mat_shape(8 * 128)
    a = torch.from_numpy(_rand(m * 4, seed=1)).reshape(m, 4)
    b = torch.from_numpy(_rand(4 * ncols, seed=2)).reshape(4, ncols)
    x = (a @ b).reshape(-1)                           # rank 4
    c = codecs.get("plr8")
    wire, _ = c.encode(x)
    torch.testing.assert_close(c.decode(wire, x.shape, x.dtype), x,
                               rtol=1e-3, atol=1e-3)


def test_plr_warm_factor_improves_over_steps():
    c = codecs.get("plr4")
    x = torch.from_numpy(_rand(1 << 14, seed=3))
    st = c.init_state(x.shape, x.dtype)
    errs = []
    for _ in range(6):
        wire, st = c.encode(x, st)
        errs.append(float(torch.linalg.norm(c.decode(wire, x.shape,
                                                     x.dtype) - x)))
    assert errs[-1] <= errs[0] * (1 + 1e-6), errs


def test_plr_wire_smaller_than_flat_at_scale():
    n = 1 << 20
    c = codecs.get("plr8")
    m, ncols = lowrank.mat_shape(n)
    assert c.wire_nbytes_for(n) == 8 * (m + ncols) * 4 < 0.02 * n * 4
    assert c.wire_nbytes_for(n) == jcodecs.get("plr8").wire_nbytes_for(n)
    assert codecs.get("ef:bq4").wire_nbytes_for(n) == \
        codecs.get("bq4").wire_nbytes_for(n)
    wire, _ = c.encode(torch.from_numpy(_rand(1 << 14, seed=4)))
    mm, nc = lowrank.mat_shape(1 << 14)
    assert sum(v.numel() * 4 for v in wire.values()) == 8 * (mm + nc) * 4


def test_state_introspection():
    ef, plr, efp = (codecs.get(n) for n in ("ef:bq8", "plr8", "ef:plr4"))
    x = torch.from_numpy(_rand(4096, seed=5))
    _, st = ef.encode(x)
    assert float(codecs.state_residual_sq(st)) == \
        float((st["residual"] ** 2).sum()) > 0
    assert codecs.state_rank(st) is None
    assert codecs.state_residual_sq(plr.init_state(x.shape, x.dtype)) == 0.0
    assert codecs.state_rank(plr.init_state(x.shape, x.dtype)) == 8
    assert codecs.state_rank(efp.init_state(x.shape, x.dtype)) == 4


# --------------------------------------------------------------------------
# the in-place variants the comms layer uses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ef:bq4", "ef:bq8", "ef:tq8"])
def test_in_place_compensate_and_residual_equal_pure(name):
    c = codecs.get(name)
    x = torch.from_numpy(_rand(5000, seed=21, scale=2.0))
    st = {"residual": torch.from_numpy(_rand(5000, seed=22, scale=0.01))}
    xc = c.compensate(x, st)
    want = c.next_state(xc)["residual"]
    donated = x.clone()
    assert c.compensate(donated, st, inplace=True) is donated
    assert torch.equal(donated, xc)
    buf = st["residual"].clone()
    got = c.next_state(donated, out=buf)["residual"]
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got, want)


@pytest.mark.parametrize("n_ranks", [2, 3, 4])
@pytest.mark.parametrize("total", [444, 48000, 200003])
def test_chunk_rows_equal_full_reconstruction_sliced(n_ranks, total):
    """``plr`` under reduce-scatter reconstructs only this rank's rows of
    P^ @ Q'^T; that chunk equals the whole reconstruction, trimmed to the
    payload, zero-padded and sliced (the reference's ``_take_chunk``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import BLOCK
    m, ncols = lowrank.mat_shape(total)
    r = lowrank.rank_for(total, 8)
    phat = torch.from_numpy(_rand(m * r, seed=total)).reshape(m, r)
    q = torch.from_numpy(_rand(ncols * r, seed=total + 1)).reshape(ncols, r)
    chunk_len = ops.padded_rows(-(-total // n_ranks)) * BLOCK
    assert chunk_len % ncols == 0
    full = lowrank.from_mat(lowrank.matmul(phat, q.T), total)
    padded = torch.nn.functional.pad(full, (0, n_ranks * chunk_len - total))
    for i in range(n_ranks):
        got = comms._lowrank_rows(phat, q, i * chunk_len, chunk_len, total)
        assert torch.equal(got, padded[i * chunk_len:(i + 1) * chunk_len]), i


# --------------------------------------------------------------------------
# guards and the trainer
# --------------------------------------------------------------------------

def test_stateful_codec_rejected_at_autodiff_sites():
    plan = policy.CommPolicy("bad", rules=(policy.Rule("ef:bq4"),)).compile()
    ax = comms.Axis("model", 2, 0, None, (0, 1))
    with policy.use_plan(plan):
        for call in (lambda: comms.all_gather(torch.zeros(8), ax, 0, "tp"),
                     lambda: comms.reduce_scatter(torch.zeros(8), ax, 0,
                                                  "tp"),
                     lambda: comms.psum(torch.zeros(8), ax, "tp"),
                     lambda: comms.copy_fwd_psum_bwd(torch.zeros(8), ax,
                                                     "tp")):
            with pytest.raises(NotImplementedError,
                               match="never autodiff traffic"):
                call()


def test_stateful_codec_outside_state_region_raises():
    plan = policy.CommPolicy(
        "ef_dp", rules=(policy.Rule("ef:bq4", dim="dp"),)).compile()
    ax = comms.Axis("data", 2, 0, None, (0, 1))
    with policy.use_plan(plan):
        with pytest.raises(RuntimeError, match="codec-state region"):
            comms.reduce_scatter_flat(torch.zeros(8), ax, "dp@zero1_grad")
        with pytest.raises(RuntimeError, match="codec-state region"):
            comms.psum(torch.zeros(8), ax, "dp")
        with comms.codec_state_io({}):
            with pytest.raises(KeyError, match="no codec-state slot"):
                comms.reduce_scatter_flat(torch.zeros(8), ax, "dp@zero1_grad")
    plr = policy.CommPolicy("plr_zero",
                            rules=(policy.Rule("plr8"),)).compile()
    with policy.use_plan(plr), comms.codec_state_io({}):
        with pytest.raises(NotImplementedError, match="sum collectives"):
            comms.all_gather_flat(torch.zeros(1024), ax, 2000, "zero")


def _mini_trainer(rule):
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import Trainer
    cfg = configs.get("gemma3-1b").reduced().replace(vocab_size=64)
    pol = schemes.get("zhybrid_16_8").as_policy()
    if rule is not None:
        pol = pol.with_rules(rule, name="test")
    return Trainer(Model(cfg, device="cpu"), scheme=pol), cfg


def test_trainer_codec_state_template_and_threading():
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    tr, cfg = _mini_trainer(policy.Rule("ef:bq4", dim="dp",
                                        name="zero1_grad*"))
    n = sum(s[1][0] for s in tr.codec_sites() if s[0].dim == "dp")
    assert tr.codec_state_template() == {
        "dp@zero1_grad": {"residual": ((n,), torch.float32)}}
    params, ostate, cstate = tr.init_all(0)
    assert sorted(cstate) == ["dp@zero1_grad"]
    assert not cstate["dp@zero1_grad"]["residual"].any()
    data = SyntheticCorpus(DataConfig(vocab_size=64, seq_len=16,
                                      global_batch=4))
    for s in range(2):          # a trivial dp axis: the slot carries over
        batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        params, ostate, cstate, m = tr.step(params, ostate, cstate, batch)
    assert sorted(cstate) == ["dp@zero1_grad"]
    assert np.isfinite(float(m["loss"]))


def test_trainer_stateless_policy_has_empty_codec_state():
    tr, _ = _mini_trainer(None)
    assert tr.codec_state_template() == {}
    assert tr.init_all(0)[2] == {}


def test_codec_state_from_jax_takes_this_ranks_slice():
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.models.params import MeshInfo
    from repro_torch.train.train_step import Trainer
    cfg = configs.get("gemma3-1b").reduced()
    pol = schemes.get("zhybrid_16_8").as_policy().with_rules(
        policy.Rule("ef:plr8", dim="dp"))
    world = comms.Axis("world", 4, 3, None, (0, 1, 2, 3))
    mi = MeshInfo(tp=2, dp=2, world=world,
                  model=comms.Axis("model", 2, 1, None, (2, 3)),
                  data=comms.Axis("data", 2, 1, None, (1, 3)))
    tr = Trainer(Model(cfg, mi, device="cpu"), scheme=pol)
    tmpl = tr.codec_state_template()["dp@zero1_grad"]
    (n,), _ = tmpl["residual"]
    (ncols, r), _ = tmpl["inner"]["q"]
    res = np.arange(4 * n, dtype=np.float32)
    q = np.arange(4 * ncols * r, dtype=np.float32).reshape(4 * ncols, r)
    st = tr.codec_state_from_jax(
        {"dp@zero1_grad": {"residual": res, "inner": {"q": q}}})
    got = st["dp@zero1_grad"]
    assert torch.equal(got["residual"], torch.from_numpy(res[3 * n:]))
    assert torch.equal(got["inner"]["q"], torch.from_numpy(q[3 * ncols:]))
    with pytest.raises(KeyError):
        tr.codec_state_from_jax({})
