"""The port's self-tuning host parts (``repro_torch.tune``, the roofline's
ladder walk and ``fault.tune_restart_warnings``) against the reference's,
on the same inputs, in this process (no worlds).

Contract asserted here:
  * the ladder's constants and ``plr_rank`` / ``rung_index`` /
    ``rung_or_default`` / ``promote`` / ``demote`` over every codec equal;
  * ``tracker.pack`` equal slot for slot, ``SignalTracker.drain`` equal,
    and the wrong-length vector rejected with the reference's words;
  * both controllers fed the streams of ``tests/test_tune_controller.py``
    (full walk, hold, insufficient signal, cooldown, plr demotion, no
    predicted saving, loss-guard rollback and veto, spectral rank and
    retune, the determinism stream) make identical ``Decision`` lists
    (floats bit for bit), ``state_dict`` s, rung indices and plan hashes,
    and a ``controller.json`` from either package resumes the walk in the
    other with the same decisions;
  * ``policy_artifact.emit`` from the same stream writes the same JSON
    (``rules``, ``plan_hash``, ``history``, every field), ``load`` rejects
    a bad version, missing fields and unknown rule fields with the
    reference's words, an artifact from either package replays to the same
    ``table_hash`` in the other, and ``topology_mismatch`` is empty on
    equal meshes and lists the same differences on unequal ones;
  * ``recost_events``, ``suggest_scheme`` (with events and mesh-free) and
    ``savings_report`` equal the reference's on the same ledger, the link
    rates passed explicitly (the port has no default);
  * ``tune_restart_warnings`` says the reference's lines word for word;
  * the leading ``r`` columns of the full-width power iteration equal the
    ``plr<r>`` iteration bit for bit (``orthonormalize`` is
    column-sequential, its second projection too).
"""

import json

import numpy as np
import pytest

from repro.analysis import roofline as jrl
from repro.core import codecs as jcodecs
from repro.core import policy as jpolicy
from repro.models.params import MeshInfo as JMeshInfo
from repro.train import fault as jfault
from repro.tune import controller as jcontroller
from repro.tune import ladder as jladder
from repro.tune import policy_artifact as jart
from repro.tune import tracker as jtracker
from repro_torch.analysis import roofline as trl
from repro_torch.core import codecs as tcodecs
from repro_torch.core import policy as tpolicy
from repro_torch.models.params import MeshInfo as TMeshInfo
from repro_torch.train import fault as tfault
from repro_torch.tune import controller as tcontroller
from repro_torch.tune import ladder as tladder
from repro_torch.tune import policy_artifact as tart
from repro_torch.tune import tracker as ttracker

ELEMS = 1 << 16
CFG = dict(interval=10, promote_tol=0.15, demote_tol=0.60, guard=0.05,
           cooldown=2, min_steps=2)


class Pkg:
    """One package's tune surface."""

    def __init__(self, policy, tracker, controller):
        self.policy, self.tracker, self.controller = policy, tracker, \
            controller

    def site(self, name="zero1_grad", level="outer"):
        return self.policy.Site("dp", name, level=level)

    def sig(self, err_ratio, count=10.0, payload=1e4, spec=None):
        return self.tracker.SiteSignals(
            count=count, payload_sq=payload,
            err_sq=(err_ratio ** 2) * payload,
            spec_n=count if spec is not None else 0.0,
            spec=tuple(spec) if spec is not None else (0.0,) * 8)

    def ctrl(self, scheme="hier_zpp_16_16", sites=None):
        if sites is None:
            s = self.site()
            sites = {s.ledger_tag: (s, ELEMS)}
        return self.controller.CompressionController(
            scheme, sites, cfg=self.controller.ControllerConfig(**CFG))


JAX = Pkg(jpolicy, jtracker, jcontroller)
TORCH = Pkg(tpolicy, ttracker, tcontroller)
KEY = "dp_outer@zero1_grad"


def _rounds(c, stream, losses=None):
    """Feed ``stream`` (per round: {site: signals}) with the losses of
    each round before it; returns every decision as a dict."""
    out = []
    for i, sigs in enumerate(stream):
        for step, loss in (losses[i] if losses else ()):
            c.observe_loss(step, loss)
        out.extend(d.as_dict() for d in c.decide(10 * (i + 1), sigs))
    return out


def _scenarios(p: Pkg) -> dict:
    """The streams of tests/test_tune_controller.py, run through ``p``:
    each returns (decisions, state_dict, select, plan hash)."""
    s2 = p.site("other")
    sq = p.site()
    out = {}

    def record(name, c, decisions):
        out[name] = (decisions, c.state_dict(), c.select_indices(),
                     c.plan().table_hash())

    c = p.ctrl()
    record("full_walk", c, _rounds(c, [{KEY: p.sig(0.01)}] * 4))
    c = p.ctrl()
    record("hold", c, _rounds(c, [{KEY: p.sig(0.30)},
                                  {KEY: p.sig(0.01, count=1.0)}, {}]))
    c = p.ctrl("hier_zpp_ef4_16")
    record("cooldown", c, _rounds(c, [{KEY: p.sig(0.90)}]
                                  + [{KEY: p.sig(0.01)}] * 3))
    c = p.ctrl("hier_zpp_plr8_16")
    record("plr_demote", c, _rounds(c, [{KEY: p.sig(0.90)}]))
    c = p.ctrl("hier_zpp_ef4_16", sites={sq.ledger_tag: (sq, 256)})
    record("no_saving", c, _rounds(c, [{sq.ledger_tag: p.sig(0.01)}]))
    c = p.ctrl("hier_zpp_8_16")
    record("guard_rollback", c, _rounds(
        c, [{KEY: p.sig(0.01)}] * 2,
        [[(s, 2.0) for s in range(10)], [(s, 3.0) for s in range(10, 20)]]))
    c = p.ctrl(sites={KEY: (p.site(), ELEMS), s2.ledger_tag: (s2, ELEMS)})
    record("guard_veto", c, _rounds(
        c, [{KEY: p.sig(0.01), s2.ledger_tag: p.sig(0.50)},
            {KEY: p.sig(0.01), s2.ledger_tag: p.sig(0.01)}],
        [[(s, 2.0) for s in range(10)], [(s, 3.0) for s in range(10, 20)]]))
    c = p.ctrl("hier_zpp_ef4_16")
    record("spectral", c, _rounds(c, [
        {KEY: p.sig(0.01, spec=[100, 50, 1, .5, .1, .1, .1, .1])},
        {KEY: p.sig(0.01, spec=[10, 10, 8, 8, 1, 1, 1, 1])},
        {KEY: p.sig(0.01, spec=[9, 8, 1, 1, 1, 1, 1, 1])}]))
    c = p.ctrl()
    stream = [p.sig(0.01), p.sig(0.12), p.sig(0.90), p.sig(0.01),
              p.sig(0.01), p.sig(0.01), p.sig(0.30),
              p.sig(0.01, spec=[9, 8, 1, 1, 1, 1, 1, 1])]
    record("stream", c, _rounds(c, [{KEY: s} for s in stream],
                                [[(i, 2.0 - 0.01 * i)]
                                 for i in range(len(stream))]))
    return out


# --------------------------------------------------------------------------
# ladder and tracker
# --------------------------------------------------------------------------

def test_ladder_matches_reference():
    for name in ("PLR_MAX_RANK", "PLR_RANKS", "LADDER", "RUNGS", "SCHEME_FOR",
                 "SUGGEST_LADDER"):
        assert getattr(tladder, name) == getattr(jladder, name), name
    every = sorted(set(tcodecs.names()) | set(jcodecs.names())
                   | {f"ef:{c}" for c in ("bq4", "bq8", "bq16", "plr8")}
                   | {f"plr{r}" for r in (1, 2, 3, 4, 6, 8, 16, 64)})
    assert every
    for c in every:
        assert tladder.plr_rank(c) == jladder.plr_rank(c), c
        assert tladder.rung_or_default(c) == jladder.rung_or_default(c), c
        assert tladder.rung_or_default(c, 2) == \
            jladder.rung_or_default(c, 2), c
        if c in tladder.RUNGS:
            assert tladder.rung_index(c) == jladder.rung_index(c)
        else:
            with pytest.raises(KeyError) as et:
                tladder.rung_index(c)
            with pytest.raises(KeyError) as ej:
                jladder.rung_index(c)
            assert str(et.value) == str(ej.value)
        if c in tladder.LADDER or tladder.plr_rank(c) is not None:
            for r in tladder.PLR_RANKS:
                assert tladder.promote(c, r) == jladder.promote(c, r), c
            assert tladder.promote(c) == jladder.promote(c)
            assert tladder.demote(c) == jladder.demote(c), c


def test_tracker_pack_and_drain_match_reference():
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(3)
    spec = rng.normal(size=8).astype(np.float32) ** 2
    for sp in (None, spec):
        want = np.asarray(jtracker.pack(1.0, jnp.float32(2.5),
                                        jnp.float32(0.125),
                                        None if sp is None else
                                        jnp.asarray(sp)))
        got = ttracker.pack(1.0, torch.tensor(2.5), torch.tensor(0.125),
                            None if sp is None else torch.from_numpy(sp))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.float32 and got.shape == (ttracker.SIG_LEN,)
    assert (ttracker.I_COUNT, ttracker.I_PAYLOAD, ttracker.I_ERR,
            ttracker.I_SPECN, ttracker.I_SPEC0, ttracker.SIG_LEN) == \
        (jtracker.I_COUNT, jtracker.I_PAYLOAD, jtracker.I_ERR,
         jtracker.I_SPECN, jtracker.I_SPEC0, jtracker.SIG_LEN)
    vec = rng.normal(size=12).astype(np.float32) ** 2
    sig_t, zero_t = ttracker.SignalTracker().drain(
        {"a": torch.from_numpy(vec)})
    sig_j, zero_j = jtracker.SignalTracker().drain({"a": vec})
    assert sig_t == {"a": ttracker.SiteSignals(**vars(sig_j["a"]))}
    assert sig_t["a"].err_ratio == sig_j["a"].err_ratio
    for frac in (0.5, 0.9, 0.999):
        assert sig_t["a"].spectral_rank(frac, tladder.PLR_RANKS) == \
            sig_j["a"].spectral_rank(frac, jladder.PLR_RANKS)
    np.testing.assert_array_equal(zero_t["a"], zero_j["a"])
    with pytest.raises(ValueError) as et:
        ttracker.SignalTracker().drain({"s": torch.zeros(7)})
    with pytest.raises(ValueError) as ej:
        jtracker.SignalTracker().drain({"s": np.zeros(7, np.float32)})
    assert str(et.value) == str(ej.value)
    assert "restart tuning fresh" in str(et.value)


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenarios():
    return _scenarios(JAX), _scenarios(TORCH)


@pytest.mark.parametrize("name", ["full_walk", "hold", "cooldown",
                                  "plr_demote", "no_saving", "guard_rollback",
                                  "guard_veto", "spectral", "stream"])
def test_controller_matches_reference(name, scenarios):
    want, got = scenarios[0][name], scenarios[1][name]
    assert got[0] == want[0]            # decisions, floats bit for bit
    assert got[1] == want[1]            # state_dict
    assert got[2] == want[2]            # rung indices
    assert got[3] == want[3]            # plan hash
    changed = [d for d in got[0] if d["to_codec"] != d["from_codec"]]
    assert changed or name in ("hold", "no_saving")


def test_controller_json_crosses_packages(tmp_path):
    """A controller.json saved by either package resumes the walk in the
    other: the same decisions afterwards as an uninterrupted run."""
    for src, dst in ((JAX, TORCH), (TORCH, JAX)):
        a = src.ctrl()
        a.decide(10, {KEY: src.sig(0.01)})
        a.decide(20, {KEY: src.sig(0.90)})          # demote: cooldown armed
        path = tmp_path / "controller.json"
        path.write_text(json.dumps(a.state_dict()))
        b = dst.ctrl()
        b.load_state_dict(json.loads(path.read_text()))
        assert b.state_dict() == a.state_dict()
        for step in (30, 40, 50):
            da = a.decide(step, {KEY: src.sig(0.01)})
            db = b.decide(step, {KEY: dst.sig(0.01)})
            assert [d.as_dict() for d in db] == [d.as_dict() for d in da]
        other = dst.site("renamed")
        c = dst.ctrl(sites={other.ledger_tag: (other, ELEMS)})
        with pytest.raises(ValueError, match="unknown tunable sites"):
            c.load_state_dict(a.state_dict())


# --------------------------------------------------------------------------
# the artifact
# --------------------------------------------------------------------------

def _walked(p: Pkg):
    c = p.ctrl()
    _rounds(c, [{KEY: p.sig(0.01)}, {KEY: p.sig(0.01)}, {KEY: p.sig(0.90)}])
    return c


def test_artifact_matches_reference(tmp_path):
    art_j = jart.emit(str(tmp_path / "j" / "tune_policy.json"), _walked(JAX))
    art_t = tart.emit(str(tmp_path / "t" / "tune_policy.json"),
                      _walked(TORCH))
    assert art_t == art_j
    text_t = (tmp_path / "t" / "tune_policy.json").read_text()
    assert text_t == (tmp_path / "j" / "tune_policy.json").read_text()
    assert tart.VERSION == jart.VERSION
    assert tart.ARTIFACT_FIELDS == jart.ARTIFACT_FIELDS
    assert tart.RULE_FIELDS == jart.RULE_FIELDS
    # either package's artifact replays to the same plan in the other
    for path in ("j", "t"):
        loaded_t = tart.load(str(tmp_path / path / "tune_policy.json"))
        loaded_j = jart.load(str(tmp_path / path / "tune_policy.json"))
        assert loaded_t == loaded_j == art_j
        h_t = tart.as_policy(loaded_t, base="hier_zpp_16_16").compile(
            None).table_hash()
        h_j = jart.as_policy(loaded_j).compile(None).table_hash()
        assert h_t == h_j == art_j["plan_hash"]
    assert not (tmp_path / "t" / "tune_policy.json.tmp").exists()


def test_artifact_load_rejections_match_reference(tmp_path):
    art = tart.emit(str(tmp_path / "ok.json"), _walked(TORCH))
    bad = {"version": dict(art, version=99),
           "missing": {k: v for k, v in art.items() if k != "plan_hash"},
           "rule": dict(art, rules=[dict(art["rules"][0], bogus=1)])}
    for name, tree in bad.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(tree))
        with pytest.raises(ValueError) as et:
            tart.load(str(p))
        with pytest.raises(ValueError) as ej:
            jart.load(str(p))
        assert str(et.value) == str(ej.value), name
    bad_codec = dict(art, rules=[dict(art["rules"][0], codec="bq3")])
    with pytest.raises(KeyError):
        tart.rules_from(bad_codec)


def test_topology_matches_reference():
    pairs = [(TMeshInfo(dp=2, node=2), JMeshInfo(dp=2, node=2,
                                                 node_axis="node")),
             (TMeshInfo(dp=2, tp=2), JMeshInfo(dp=2, tp=2)),
             (TMeshInfo(dp=2, tp=2, pp=2), JMeshInfo(dp=2, tp=2, pp=2,
                                                     stage_axis="stage"))]
    for mt, mj in pairs:
        assert tart.topology_of(mt) == jart.topology_of(mj)
        art = {"topology": jart.topology_of(mj)}
        assert tart.topology_mismatch(art, mt) == []
        assert jart.topology_mismatch({"topology": tart.topology_of(mt)},
                                      mj) == []
    art = {"topology": jart.topology_of(pairs[0][1])}
    for mt, mj in pairs[1:]:
        diffs = tart.topology_mismatch(art, mt)
        assert diffs and diffs == jart.topology_mismatch(art, mj)
    assert tart.topology_of(None) == jart.topology_of(None) == {}


# --------------------------------------------------------------------------
# the roofline's ladder walk
# --------------------------------------------------------------------------

def _ledger() -> list:
    """A ledger with the DP sync's two levels, a flat DP event, directed
    TP events and a stage handoff (ring schedules re-derived)."""
    ev = []
    for scheme, elems in (("hier_zpp_16_16", 1 << 20), ("hier_zpp_8_16", 999)):
        for e in trl._two_level_ar_events(scheme, elems, 4, 2):
            ev.append(dict(e, tag=f"{e['tag']}_{e['level']}@zero1_grad",
                           nbytes=e["elems"] * 4))
    mk = dict(dtype="bfloat16", mult=1, remat=False, bidir=False)
    ev += [dict(mk, op="all_gather", tag="tp@mlp_in", axis="model", n=2,
                elems=1 << 18, codec_fwd="bq16", codec_bwd="bq16",
                bwd_op="reduce_scatter", level="flat"),
           dict(mk, op="reduce_scatter", tag="tp@mlp_out", axis="model", n=2,
                elems=1 << 19, codec_fwd="bq16", codec_bwd="bq16",
                bwd_op="all_gather", level="flat"),
           dict(mk, op="ppermute", tag="pp_fwd@handoff", axis="stage", n=2,
                elems=1 << 17, codec_fwd="bq16", codec_bwd="bq16",
                bwd_op="ppermute", level="flat"),
           dict(mk, op="all_reduce", tag="dp@zero1_grad", axis="data", n=4,
                elems=123457, codec_fwd="bq8", codec_bwd="bq8", bwd_op=None,
                level="flat", dtype="float32")]
    return ev


def _tuned(policy):
    return policy.as_policy("hier_zpp_16_16").with_rules(
        policy.Rule("ef:bq4", dim="dp", level="outer", name="zero1_grad"),
        policy.Rule("bq8", dim="dp", level="inner", name="zero1_grad"),
        name="hier_zpp_16_16+tuned")


@pytest.mark.parametrize("fast,slow", [(50e9, 25e9), (450e9, 50e9),
                                       (1e9, 1e9)])
def test_ladder_walk_pricing_matches_reference(fast, slow):
    ev = _ledger()
    for cand in ("hier_zpp_16_16", "hier_zpp_plr8_16", "baseline"):
        assert trl.recost_events(ev, cand) == jrl.recost_events(ev, cand)
    assert trl.recost_events(ev, _tuned(tpolicy)) == \
        jrl.recost_events(ev, _tuned(jpolicy))
    for train in (True, False):
        assert trl.suggest_scheme(fast, slow, events=ev, train=train) == \
            jrl.suggest_scheme(fast, slow, events=ev, train=train)
        assert trl.savings_report(
            ev, "hier_zpp_16_16", _tuned(tpolicy), train,
            fast_bytes_per_s=fast, slow_bytes_per_s=slow) == \
            jrl.savings_report(ev, "hier_zpp_16_16", _tuned(jpolicy), train,
                               ici_bw=fast, dcn_bw=slow)
    for elems, n_i, n_o in ((1 << 24, 8, 4), (1 << 20, 2, 2), (5000, 4, 3)):
        assert trl.suggest_scheme(fast, slow, elems=elems, n_inner=n_i,
                                  n_outer=n_o) == \
            jrl.suggest_scheme(fast, slow, elems=elems, n_inner=n_i,
                               n_outer=n_o)
    rep = trl.savings_report(ev, "hier_zpp_16_16", _tuned(tpolicy),
                             fast_bytes_per_s=fast, slow_bytes_per_s=slow)
    assert rep["slow_saved_frac"] > 0
    with pytest.raises(TypeError):
        trl.suggest_scheme()                       # no default link rates
    with pytest.raises(TypeError):
        trl.savings_report(ev, "hier_zpp_16_16", "hier_zpp_8_16")


# --------------------------------------------------------------------------
# restart warnings
# --------------------------------------------------------------------------

def test_tune_restart_warnings_match_reference(tmp_path):
    art = tart.emit(str(tmp_path / "tune_policy.json"), _walked(TORCH),
                    mesh_info=TMeshInfo(dp=2, node=2))
    hb = tmp_path / "heartbeat.json"
    meshes = [(TMeshInfo(dp=2, node=2), JMeshInfo(dp=2, node=2,
                                                  node_axis="node")),
              (TMeshInfo(dp=4), JMeshInfo(dp=4))]
    for beat in (None, {"tune_plan_hash": art["plan_hash"]},
                 {"tune_plan_hash": "0123456789abcdef",
                  "tune_decision_step": 7}, "torn"):
        if beat is None:
            hb.unlink(missing_ok=True)
        else:
            hb.write_text("{" if beat == "torn" else json.dumps(beat))
        for mt, mj in meshes:
            for path in (None, str(hb)):
                got = tfault.tune_restart_warnings(art, mt, path)
                assert got == jfault.tune_restart_warnings(art, mj, path)
    got = tfault.tune_restart_warnings(art, meshes[0][0], str(hb))
    assert got == []                 # a torn heartbeat is no stale plan
    hb.write_text(json.dumps({"tune_plan_hash": "0123456789abcdef",
                              "tune_decision_step": 7}))
    got = tfault.tune_restart_warnings(art, meshes[1][0], str(hb))
    assert got[0] == "tune_policy topology mismatch — dp: artifact=2 mesh=4"
    assert got[-1] == (f"tune_policy plan_hash {art['plan_hash']} != last "
                       "heartbeat plan 0123456789abcdef (decision step 7) — "
                       "the artifact is stale relative to the run it came "
                       "from")


# --------------------------------------------------------------------------
# the probe's leading-r slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("elems", [1 << 16, 300001])
def test_leading_columns_of_full_width_iteration_are_plr_r(elems):
    """The tuned sites run one power iteration at the factor's full width
    R and take its leading r columns as the plr<r> rung: that is the plr<r>
    iteration itself, bit for bit, because both products and
    orthonormalize treat columns one at a time in order."""
    import torch

    from repro_torch.kernels import lowrank

    g = torch.Generator().manual_seed(elems)
    x = torch.randn(elems, generator=g)
    _, ncols = lowrank.mat_shape(elems)
    R = lowrank.rank_for(elems, tladder.PLR_MAX_RANK)
    q = lowrank.init_factor(ncols, R)

    def iteration(q):
        mat = lowrank.to_mat(x)
        phat = lowrank.orthonormalize(lowrank.matmul(mat, q))
        q_loc = lowrank.matmul(mat.T, phat)
        return phat, q_loc, lowrank.orthonormalize(q_loc)

    full = iteration(q)
    for r in tladder.PLR_RANKS:
        part = iteration(q[:, :r].contiguous())
        for a, b in zip(full, part):
            assert torch.equal(a[:, :r], b), r
    p = torch.randn(4096, R, generator=g)
    p[:, 3] = p[:, 0] * 2 + p[:, 1]      # a dependent column zeroes alike
    for r in range(1, R + 1):
        assert torch.equal(lowrank.orthonormalize(p)[:, :r],
                           lowrank.orthonormalize(p[:, :r]))
