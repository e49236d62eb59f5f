"""Compression schemes: which codec rides on which parallelism dimension
(port of ``repro.core.schemes``, the whole registry).

The paper's Tables II/III plus the naive baselines, as in the reference:
a scheme maps each communication tag ``<dimension>[_<direction>][_<level>]``
(dimension in dp/zero/tp/pp/ep/cp/kv, direction fwd/bwd for the directed
dims, level inner/outer for hierarchical stages) to a codec.  Each scheme is
sugar over an ordered :class:`~repro_torch.core.policy.Rule` list
(:meth:`Scheme.as_policy`).  Schemes that name a carried-state codec
(``ef:*``, ``plr*``) put it on the optimizer's sync sites:
``ef_zhybrid_16_4`` puts ``ef:bq4`` on the DP gradient sync,
``hier_zpp_plr8_16`` ``plr8`` on its inter-node level.  The ``hier_*`` schemes set per-level
codecs, which the node-factored meshes (``--nodes``, ``--tp-nodes``,
``--pp-nodes``) read: ``hier_zpp_*`` on the DP sync's two levels,
``hier_tpp_*`` on every dimension's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

from repro_torch.core import codecs, policy

# parallelism dimensions, in ledger/table order
DIMS = ("dp", "zero", "tp", "pp", "ep", "cp", "kv")
# dimensions whose tags carry an explicit fwd/bwd direction
DIRECTED_DIMS = ("tp", "pp", "ep", "cp")


def flat_tags() -> list[str]:
    """Every flat (level-free) tag the comms layer can emit."""
    out = []
    for d in DIMS:
        out += [f"{d}_{io}" for io in ("fwd", "bwd")] \
            if d in DIRECTED_DIMS else [d]
    return out


def level_tags() -> list[str]:
    """Every level-aware tag: flat tags x {inner, outer}."""
    return [f"{t}_{lvl}" for t in flat_tags() for lvl in ("inner", "outer")]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """Tag -> codec map over THREE axes of the scheme space:

      dimension (dp/zero/tp/pp/ep/cp/kv) x direction (fwd/bwd) x level.

    The *level* axis prices the link hierarchy of real clusters: the
    intra-node stage of a hierarchical collective (``<tag>_inner``) rides
    fast NVLink/ICI links, the inter-node stage (``<tag>_outer``) rides
    slow IB/DCN links (ZeRO++, arXiv:2306.10209).  Level fields default to
    ``None`` = inherit the flat codec for the tag, so every pre-existing
    scheme keeps its exact behavior under the hierarchical collectives.
    PR 1 added per-level fields for the optimizer's dp/zero sync; the
    model-layer dimensions (tp/pp/ep, with direction) now carry them too,
    so TP all-reduce/all-gather, EP all-to-all, and PP point-to-point hops
    over a node-factored mesh axis get the same inner-mild/outer-aggressive
    treatment."""

    name: str
    dp: str = "none"
    zero: str = "none"
    tp_fwd: str = "none"
    tp_bwd: str = "none"
    pp_fwd: str = "none"
    pp_bwd: str = "none"
    ep_fwd: str = "none"
    ep_bwd: str = "none"
    cp_fwd: str = "none"
    cp_bwd: str = "none"
    kv: str = "none"
    # per-level overrides (hierarchical collectives); None -> flat codec
    dp_inner: str | None = None
    dp_outer: str | None = None
    zero_inner: str | None = None
    zero_outer: str | None = None
    tp_fwd_inner: str | None = None
    tp_fwd_outer: str | None = None
    tp_bwd_inner: str | None = None
    tp_bwd_outer: str | None = None
    pp_fwd_inner: str | None = None
    pp_fwd_outer: str | None = None
    pp_bwd_inner: str | None = None
    pp_bwd_outer: str | None = None
    ep_fwd_inner: str | None = None
    ep_fwd_outer: str | None = None
    ep_bwd_inner: str | None = None
    ep_bwd_outer: str | None = None
    cp_fwd_inner: str | None = None
    cp_fwd_outer: str | None = None
    cp_bwd_inner: str | None = None
    cp_bwd_outer: str | None = None
    kv_inner: str | None = None
    kv_outer: str | None = None

    def __post_init__(self):
        # eager codec validation: a typo'd codec name fails at scheme
        # construction, not deep inside the first traced collective
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            val = getattr(self, f.name)
            if val is not None:
                try:
                    codecs.get(val)
                except KeyError:
                    raise KeyError(
                        f"scheme {self.name!r}: field {f.name!r} names "
                        f"unknown codec {val!r}; have "
                        f"{sorted(codecs._REGISTRY)}") from None

    def codec(self, tag: str) -> codecs.Codec:
        val = getattr(self, tag, None)
        if val is not None:
            return codecs.get(val)
        if tag.endswith(("_inner", "_outer")):
            # level-aware tag with no explicit override: fall back to the
            # flat codec (tp_fwd_inner -> tp_fwd; dp_outer -> dp)
            return self.codec(tag.rsplit("_", 1)[0])
        raise KeyError(f"unknown comm tag {tag!r}")

    @classmethod
    def uniform(cls, name: str, codec_name: str) -> "Scheme":
        """One codec on every flat tag; level fields stay ``None``
        (hierarchical stages inherit the flat codec)."""
        fields = {f.name: codec_name for f in dataclasses.fields(cls)
                  if f.name != "name" and f.default is not None}
        return cls(name=name, **fields)

    @classmethod
    def hybrid(cls, name: str, dp: str, mp: str, zero: str | None = None) -> "Scheme":
        """Paper-style hybrid: one codec for DP, one for all MP + ZeRO
        traffic (cp KV ring hops and serving kv handoffs are
        activation-class — they take the mild MP codec, never the
        aggressive DP one)."""
        z = zero if zero is not None else mp
        return cls(name=name, dp=dp, zero=z,
                   tp_fwd=mp, tp_bwd=mp, pp_fwd=mp, pp_bwd=mp,
                   ep_fwd=mp, ep_bwd=mp, cp_fwd=mp, cp_bwd=mp, kv=mp)

    @classmethod
    def hier(cls, name: str, base: "Scheme", inner: str, outer: str,
             dims: tuple = ("dp", "zero")) -> "Scheme":
        """Level-aware scheme: ``base``'s flat codecs, plus a mild ``inner``
        codec for intra-node stages and an aggressive ``outer`` codec for
        inter-node stages of the hierarchical collectives of every
        dimension in ``dims``.  Directed dimensions (tp/pp/ep/cp) get both
        their fwd and bwd level fields set; dimensions NOT in ``dims``
        keep their level fields at ``None`` (flat-codec fallback)."""
        fields = {}
        for d in dims:
            if d in DIRECTED_DIMS:
                for io in ("fwd", "bwd"):
                    fields[f"{d}_{io}_inner"] = inner
                    fields[f"{d}_{io}_outer"] = outer
            else:
                fields[f"{d}_inner"] = inner
                fields[f"{d}_outer"] = outer
        return dataclasses.replace(base, name=name, **fields)

    def as_policy(self) -> policy.CommPolicy:
        """The scheme as an ordered rule list (the thin-adapter path).

        Per-level fields become level-constrained rules, flat fields
        level-free rules AFTER them — first-match-wins then reproduces
        the legacy fallback chain (``tp_fwd_inner`` -> explicit field ->
        ``tp_fwd``) exactly, so every registered scheme is sugar over
        rules and ``scheme.as_policy().compile(mi)`` is the plan the
        trainers bind."""
        level_rules, flat_rules = [], []
        for d in DIMS:
            dirs = ("fwd", "bwd") if d in DIRECTED_DIMS else (None,)
            for io in dirs:
                base = f"{d}_{io}" if io else d
                for lvl in ("inner", "outer"):
                    val = getattr(self, f"{base}_{lvl}")
                    if val is not None:
                        level_rules.append(policy.Rule(
                            codec=val, dim=d, direction=io, level=lvl))
                flat_rules.append(policy.Rule(
                    codec=getattr(self, base), dim=d, direction=io))
        return policy.CommPolicy(name=self.name,
                                 rules=tuple(level_rules + flat_rules))


BASELINE = Scheme(name="baseline")                                  # stock collectives
NAIVE_ZFP8 = Scheme.uniform("naive_zfp8", "bq8")                    # paper §IV-C
NAIVE_ZFP16 = Scheme.uniform("naive_zfp16", "bq16")
NAIVE_MPC = Scheme.uniform("naive_mpc", "mpc")                      # paper §IV-D
MZHYBRID8 = Scheme.hybrid("mzhybrid8", dp="bq8", mp="mpc")          # paper Table II
MZHYBRID16 = Scheme.hybrid("mzhybrid16", dp="bq16", mp="mpc")
ZHYBRID_16_8 = Scheme.hybrid("zhybrid_16_8", dp="bq8", mp="bq16")   # paper Table III
ZHYBRID_24_8 = Scheme.hybrid("zhybrid_24_8", dp="bq8", mp="bq24")
# beyond-paper rate-4 points: the block-scaled codec tolerates rate 8 where
# bitplane ZFP degraded, so the rate->quality knee sits lower (EXPERIMENTS.md)
NAIVE_ZFP4 = Scheme.uniform("naive_zfp4", "bq4")
ZHYBRID_16_4 = Scheme.hybrid("zhybrid_16_4", dp="bq4", mp="bq16")
# scale-granularity ablation (classic global-scale rate-8 — the regime in
# which the paper observed naive-compression loss degradation)
NAIVE_GQ8 = Scheme.uniform("naive_gq8", "gq8")
MZHYBRID_G8 = Scheme.hybrid("mzhybrid_g8", dp="gq8", mp="mpc")
# rounding-bias ablation (ZFP truncated-bitplane error profile)
NAIVE_TQ8 = Scheme.uniform("naive_tq8", "tq8")
MZHYBRID_T8 = Scheme.hybrid("mzhybrid_t8", dp="tq8", mp="mpc")
# bf16-native ZHybrid: the paper compressed fp32 wires, so its rate-16 MP
# setting is a no-op on bf16 traffic — halving both rates restores the
# intended compression ratios (EXPERIMENTS.md §Perf)
ZHYBRID_8_4 = Scheme.hybrid("zhybrid_8_4", dp="bq4", mp="bq8")
# level-aware (hierarchical) schemes: <name>_<outer>_<inner> — mild codec
# intra-node, aggressive codec on the inter-node stage (ZeRO++ qgZ-style).
# hier_zpp_*: optimizer sync (dp/zero) only, as in PR 1.
# hier_zpp_16_16 is the mild end of the autotune ladder
# (roofline.suggest_scheme): rate-16 on BOTH levels — for clusters whose
# inter-node links are fast enough that the outer stage needs no extra
# squeeze.
HIER_ZPP_16_16 = Scheme.hier("hier_zpp_16_16", ZHYBRID_16_8,
                             inner="bq16", outer="bq16")
HIER_ZPP_8_16 = Scheme.hier("hier_zpp_8_16", ZHYBRID_16_8,
                            inner="bq16", outer="bq8")
HIER_ZPP_4_16 = Scheme.hier("hier_zpp_4_16", ZHYBRID_16_8,
                            inner="bq16", outer="bq4")
HIER_MZPP_8 = Scheme.hier("hier_mzpp_8", MZHYBRID8,
                          inner="mpc", outer="bq8")
# hier_tpp_*: EVERY dimension level-aware — the model-layer TP/EP/PP
# collectives over a node-factored mesh axis also stage inner-mild /
# outer-aggressive (Demystifying Communication Characteristics,
# arXiv:2408.10197: TP AR/AG and EP all-to-all dominate wire volume once a
# mesh axis spans nodes).
HIER_TPP_8_16 = Scheme.hier("hier_tpp_8_16", ZHYBRID_16_8,
                            inner="bq16", outer="bq8", dims=DIMS)
HIER_TPP_4_16 = Scheme.hier("hier_tpp_4_16", ZHYBRID_16_8,
                            inner="bq16", outer="bq4", dims=DIMS)
HIER_MTPP_8 = Scheme.hier("hier_mtpp_8", MZHYBRID8,
                          inner="mpc", outer="bq8", dims=DIMS)
# carried-state codec schemes (stateful protocol, codecs.py):
# error feedback makes the aggressive rate-4 DP setting convergence-safe
# (the residual re-injects the quantization error the naive scheme loses),
# and plr rides the low-rank gradient structure the paper cites
# (arXiv:2301.02654) directly.  DP-dimension only — the model-layer (MP)
# traffic keeps the mild stateless codecs, per the paper's hybrid rule.
EF_ZHYBRID_16_4 = Scheme.hybrid("ef_zhybrid_16_4", dp="ef:bq4", mp="bq16")
HIER_ZPP_EF4_16 = Scheme.hier("hier_zpp_ef4_16", ZHYBRID_16_8,
                              inner="bq16", outer="ef:bq4", dims=("dp",))
HIER_ZPP_PLR8_16 = Scheme.hier("hier_zpp_plr8_16", ZHYBRID_16_8,
                               inner="bq16", outer="plr8", dims=("dp",))

_REGISTRY = {s.name: s for s in (
    BASELINE, NAIVE_ZFP8, NAIVE_ZFP16, NAIVE_MPC,
    MZHYBRID8, MZHYBRID16, ZHYBRID_16_8, ZHYBRID_24_8,
    NAIVE_ZFP4, ZHYBRID_16_4, NAIVE_GQ8, MZHYBRID_G8,
    NAIVE_TQ8, MZHYBRID_T8, ZHYBRID_8_4,
    HIER_ZPP_16_16, HIER_ZPP_8_16, HIER_ZPP_4_16, HIER_MZPP_8,
    HIER_TPP_8_16, HIER_TPP_4_16, HIER_MTPP_8,
    EF_ZHYBRID_16_4, HIER_ZPP_EF4_16, HIER_ZPP_PLR8_16,
)}


def get(name) -> Scheme:
    if isinstance(name, Scheme):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scheme {name!r}; have {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# scheme context: comm calls in model code read it when no plan is bound.
# --------------------------------------------------------------------------

_ctx = threading.local()


def current() -> Scheme:
    return getattr(_ctx, "scheme", BASELINE)


@contextlib.contextmanager
def use(scheme) -> "Scheme":
    prev = getattr(_ctx, "scheme", None)
    _ctx.scheme = get(scheme)
    try:
        yield _ctx.scheme
    finally:
        if prev is None:
            del _ctx.scheme
        else:
            _ctx.scheme = prev
