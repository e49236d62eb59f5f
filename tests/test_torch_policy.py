"""The port's compression policies (repro_torch.core.policy/schemes/codecs)
against the reference's.

Contract asserted here, for every registered scheme: the compiled plans
resolve every ``(dim, direction, level)`` query, every site's codec pair
and every hierarchical pair to the same codec names, and have the same
``table_hash``; rules resolve first-match-wins with size and name windows
as in the reference; bad codecs, dims, directions and levels fail at
construction.  Carried-state codecs (``ef:*``, ``plr*``) resolve by name
and encode, and the collectives refuse them at autodiff sites and outside
a codec-state region.
"""

import random

import pytest

from repro.core import policy as jpolicy, schemes as jschemes
from repro_torch.core import codecs as tcodecs, comms as tcomms
from repro_torch.core import policy as tpolicy, schemes as tschemes
from repro_torch.models.params import MeshInfo


def _queries():
    out = []
    for dim in tpolicy.DIMS:
        dirs = tpolicy.DIRECTIONS if dim in tpolicy.DIRECTED_DIMS else (None,)
        for dr in dirs:
            for lvl in tpolicy.LEVELS:
                out.append((dim, dr, lvl))
    return out


def _sites():
    """Every flat and level-pinned site the comms layer can emit, named
    and unnamed."""
    tags = []
    for dim in tpolicy.DIMS:
        base = [dim] if dim not in tpolicy.DIRECTED_DIMS else \
            [dim, f"{dim}_fwd", f"{dim}_bwd"]
        for b in base:
            tags.append(b)
            if b != dim or dim not in tpolicy.DIRECTED_DIMS:
                tags += [f"{b}_inner", f"{b}_outer"]
    return tags + [t + "@zero1_grad" for t in tags]


def test_registries_match():
    assert tschemes.names() == jschemes.names()
    assert tpolicy.DIMS == jpolicy.DIMS
    assert tpolicy.DIRECTED_DIMS == jpolicy.DIRECTED_DIMS
    assert tcodecs.names() == sorted(
        __import__("repro.core.codecs", fromlist=["x"]).names())


@pytest.mark.parametrize("name", jschemes.names())
def test_plan_table_and_hash_match(name):
    jp, tp = jpolicy.compile_plan(name), tpolicy.compile_plan(name)
    assert set(tp._table) == set(jp._table) == set(_queries())
    for q in _queries():
        assert tp.codec(*q).name == jp.codec(*q).name, q
    assert tp.table_hash() == jp.table_hash()


@pytest.mark.parametrize("name", jschemes.names())
def test_site_codec_pairs_match(name):
    jp, tp = jpolicy.compile_plan(name), tpolicy.compile_plan(name)
    for tag in _sites():
        js, ts = jpolicy.as_site(tag), tpolicy.as_site(tag)
        assert ts.ledger_tag == js.ledger_tag == tag
        for nbytes in (None, 1 << 10, 1 << 24):
            jf, jb = jp.codec_pair(js, nbytes)
            tf, tb = tp.codec_pair(ts, nbytes)
            assert (tf.name, tb.name) == (jf.name, jb.name), (tag, nbytes)
            assert tf.stateful == jf.stateful
        (ji, jo) = jp.hier_codec_pairs(js)
        (ti, to) = tp.hier_codec_pairs(ts)
        assert [c.name for c in ti + to] == [c.name for c in ji + jo], tag


@pytest.mark.parametrize("seed", range(4))
def test_random_rule_lists_match(seed):
    """Random policies with size and name rules resolve alike, query by
    query, and hash alike."""
    rng = random.Random(seed)
    names = ["none", "mpc", "bq4", "bq8", "bq16", "bq24", "gq8", "tq8"]
    kw = []
    for _ in range(rng.randint(1, 6)):
        kw.append(dict(codec=rng.choice(names),
                       dim=rng.choice(list(tpolicy.DIMS) + [None]),
                       level=rng.choice([None, "flat", "inner", "outer"]),
                       max_bytes=rng.choice([None, 1 << 16]),
                       name=rng.choice([None, "embed*"])))
    jp = jpolicy.CommPolicy("r", tuple(jpolicy.Rule(**k) for k in kw),
                            default="mpc").compile()
    tp = tpolicy.CommPolicy("r", tuple(tpolicy.Rule(**k) for k in kw),
                            default="mpc").compile()
    assert tp.table_hash() == jp.table_hash()
    for q in _queries():
        for nbytes, nm in ((None, None), (1 << 10, "embed_table"),
                           (1 << 20, "mlp_w1")):
            assert tp.codec(*q, nbytes=nbytes, name=nm).name == \
                jp.codec(*q, nbytes=nbytes, name=nm).name, (q, nbytes, nm)


def test_eager_validation():
    for bad in (dict(codec="bq9"), dict(codec="bq8", dim="xx"),
                dict(codec="bq8", direction="sideways"),
                dict(codec="bq8", level="middle"),
                dict(codec="bq8", dim="dp", direction="bwd")):
        with pytest.raises(KeyError):
            tpolicy.Rule(**bad)
    with pytest.raises(ValueError):
        tpolicy.Rule("bq8", min_bytes=100, max_bytes=100)
    with pytest.raises(KeyError):
        tschemes.Scheme(name="bad", dp="bq9")
    for bad in ("xx", "tp_fwd_bogus", "dp_fwd"):
        with pytest.raises(KeyError):
            tpolicy.as_site(bad)


def test_stateful_codecs_resolve_and_refuse_their_wire():
    """Carried-state codecs resolve by name and their wire works at the
    codec level; the collectives refuse it at an autodiff site and outside
    a codec-state region."""
    import torch
    x = torch.linspace(-3, 3, 5000)
    for name in ("ef:bq4", "plr8", "ef:plr8"):
        c = tcodecs.get(name)
        assert c.stateful and c.name == name
        wire, st = c.encode(x, c.init_state(x.shape, x.dtype))
        assert c.decode(wire, x.shape, x.dtype).shape == x.shape
        assert st is not None
    ax = tcomms.Axis("model", 2, 0, None, (0, 1))
    with tpolicy.use_plan(tpolicy.CommPolicy(
            "s", rules=(tpolicy.Rule("ef:bq4"),)).compile()):
        with pytest.raises(NotImplementedError, match="autodiff"):
            tcomms.all_gather(x, ax, 0, "tp")
        with pytest.raises(RuntimeError, match="codec-state region"):
            tcomms.reduce_scatter_flat(x, ax, "dp")
    with pytest.raises(KeyError):
        tcodecs.get("ef:none")             # nothing to feed back
    with pytest.raises(KeyError):
        tcodecs.get("plr999")


def test_use_plan_and_axis_binding():
    plan = tpolicy.compile_plan("zhybrid_16_8", MeshInfo(tp=2, dp=2))
    assert plan.axis("dp").name == "data" and plan.axis("dp").size == 2
    assert plan.axis("tp").name == "model"
    with pytest.raises(KeyError):
        plan.axis("pp")
    with pytest.raises(KeyError):
        tpolicy.compile_plan("baseline").axis("dp")
    with tpolicy.use_plan("zhybrid_16_8") as p:
        assert tpolicy.current_plan() is p
        assert tcomms._codec_pair("tp")[0].name == "bq16"
        assert tcomms._codec_pair("dp")[0].name == "bq8"
    assert tpolicy.current_plan().name == "baseline"
