"""Collective bytes from the comms ledger, and the three-term roofline
(port of ``repro.analysis.roofline``).

:func:`ledger_summary` prices the analytic events of
:class:`repro_torch.core.comms.record_traffic` exactly as the reference
prices its own ledger: per-device link bytes of each collective, its
backward twin included, from the ring schedule the event recorded, and
splits them by link level (:func:`link_bytes`: a hierarchical collective's
inner stages ride the fast intra-node links, its outer stages the slow
inter-node ones).  :func:`recost_events`, :func:`suggest_scheme` and
:func:`savings_report` re-price a recorded ledger under another policy:
the codec-ladder walk over the fast/slow link ratio, and the byte and time
effect of a plan swap the self-tuning controller records.  The device-time
terms of the reference's roofline, and its link rates, were a TPU's and
are not carried over: the callers of :func:`collective_seconds`,
:func:`stage_handoff_seconds`, :func:`cp_ring_seconds`,
:func:`kv_handoff_seconds`, :func:`suggest_scheme` and
:func:`savings_report` name the rates of their own links.
:func:`kv_hbm_bytes` prices a paged KV pool's resident bytes.

:func:`roofline` turns per-device FLOPs, device-memory bytes and
collective bytes into the three times of a step (compute, memory,
collective) at the peaks its caller names.  The defaults are the NVIDIA
H100 SXM's published dense peaks (data sheet, at 700 W): 989e12 FLOP/s
bf16, 3.35e12 B/s HBM3, and 450e9 B/s NVLink per direction (900 GB/s both
ways).  No TPU rate is a default.  :func:`model_flops` and
:func:`active_params` count a step's model FLOPs (6 N D),
:func:`activation_stash_bytes` and :func:`remat_tradeoff` the pipeline's
saved activations against the remat recompute, and
:func:`hlo_collective_counts` / :func:`collective_counts` the collectives
of an HLO text and of a ledger.
"""

from __future__ import annotations

import dataclasses
import re

from repro_torch.core import codecs
from repro_torch.kernels import ops

H100_PEAK_FLOPS = 989e12    # bf16 dense, H100 SXM (data sheet)
H100_HBM_BW = 3.35e12       # bytes/s, HBM3, H100 SXM (data sheet)
H100_NVLINK_BW = 450e9      # bytes/s per direction (900 GB/s NVLink total)

_PER_DEVICE_FACTOR = {
    # fraction of the local payload E that crosses this device's link
    "all_gather": lambda n: n - 1,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "ppermute": lambda n: 1.0,
    "all_to_all": lambda n: (n - 1) / n,
    "none": lambda n: 0.0,
}

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
             "int64": 8, "int8": 1, "uint8": 1, "int16": 2, "bool": 1}


def _wire_bytes(codec_name: str, elems: int, dtype: str) -> float:
    """Wire bytes of an ``elems``-value payload: constant-rate codecs at
    their bits per value; ``plr<r>`` at ``r * (rows + cols)`` floats of its
    matrix view and ``ef:*`` at its inner codec's cost, through
    ``Codec.wire_nbytes_for``."""
    c = codecs.get(codec_name)
    if c.is_identity:
        return elems * _ITEMSIZE.get(dtype, 4)
    return c.wire_nbytes_for(elems)


def _block_codec(codec_name: str):
    """The codec iff it rides the block ring (the families with fused
    decode-add-encode hops), else None.  ``ef:*`` sends exactly its inner
    codec's wire through the same ring, so it prices at the inner codec's
    chunk geometry."""
    c = codecs.get(codec_name)
    if getattr(c, "kind", None) == "ef":
        c = c.inner
    return c if hasattr(c, "decode_add_encode_blocks") else None


def _ring_hop_bytes(c, rows: int, parts=None) -> float:
    if parts:
        return sum(c.wire_nbytes_for((hi - lo) * 128) for lo, hi, _ in parts)
    return c.wire_nbytes_for(rows * 128)


def _coll_bytes(op: str, codec_name: str, elems: int, dtype: str, n: int,
                bidir: bool, ring: dict | None) -> float:
    """Per-device link bytes of one collective: analytic factors for
    identity codecs; the chunk geometry the compressed lowering runs for
    block codecs (all-gather: n-1 hops of the padded local wire;
    reduce-scatter: n-1 ring hops of the padded chunk wire; all-reduce:
    both)."""
    c = _block_codec(codec_name)
    if c is None or op in ("ppermute", "all_to_all", "none"):
        factor = _PER_DEVICE_FACTOR[op](n)
        if bidir:
            factor *= 0.5  # two-direction rings: each link carries half
        return _wire_bytes(codec_name, elems, dtype) * factor
    if op == "all_gather":
        hop = _ring_hop_bytes(c, ops.padded_rows(int(elems)))
        return (n - 1) * hop * (0.5 if bidir else 1.0)
    if ring is None:        # an event built by hand: re-derive the ring
        from repro_torch.core import comms
        ring = comms._ring_schedule(ops.padded_rows(-(-int(elems) // n)),
                                    bidir=bool(bidir), chunks=1)._asdict()
    rows, ring_bidir, parts = ring["rows"], ring["bidir"], ring["parts"]
    hop = _ring_hop_bytes(c, rows, parts)
    out = (n - 1) * hop * (0.5 if ring_bidir else 1.0)
    if op == "all_reduce":
        out += (n - 1) * hop * (0.5 if bidir else 1.0)
    return out


def event_bytes(ev: dict, train: bool) -> dict:
    """Per-device link bytes of one ledger event: ``fwd`` (twice in
    training for a ``remat`` event, whose forward re-runs in the backward
    pass) and, when ``train``, its backward twin ``bwd`` under the
    backward codec."""
    n = ev["n"]
    if n <= 1:
        return {"fwd": 0.0, "bwd": 0.0}
    fwd = _coll_bytes(ev["op"], ev["codec_fwd"], ev["elems"], ev["dtype"],
                      n, bool(ev.get("bidir")), ev.get("ring"))
    if train and ev.get("remat"):
        fwd *= 2
    bwd = 0.0
    if train and ev.get("bwd_op"):
        op_b = ev["bwd_op"]
        if ev["op"] == "all_gather" and op_b == "reduce_scatter":
            e_b = ev["elems"] * n        # cotangent of the gather output
        elif ev["op"] == "reduce_scatter" and op_b == "all_gather":
            e_b = -(-ev["elems"] // n)   # cotangent of the scattered chunk
        else:
            e_b = ev["elems"]
        ring_b = ev.get("ring") if op_b == ev["op"] else None
        bwd = _coll_bytes(op_b, ev["codec_bwd"], e_b, ev["dtype"],
                          n, bool(ev.get("bidir")), ring_b)
    return {"fwd": fwd * ev["mult"], "bwd": bwd * ev["mult"]}


def tag_dim(tag: str) -> str:
    """Communication tag -> parallelism dimension (tp_fwd_inner@x -> tp)."""
    return tag.split("@")[0].split("_")[0]


def ledger_summary(events, train: bool) -> dict:
    """Per-device bytes per tag (without its ``@name``), per axis, per link
    level ("flat", "inner" the intra-node stage of a hierarchical
    collective, "outer" its inter-node stage), per dimension, per
    ``<dim>/<level>``, per site (``<dim>@<name>``) and in total, as the
    reference's ledger summary."""
    per_tag, per_axis, per_level = {}, {}, {}
    per_dim, per_dim_level, per_site = {}, {}, {}
    total = 0.0
    for ev in events:
        b = event_bytes(ev, train)
        tot = b["fwd"] + b["bwd"]
        tag = ev["tag"].split("@")[0]
        dim = tag_dim(tag)
        lvl = ev.get("level", "flat")
        per_tag[tag] = per_tag.get(tag, 0.0) + tot
        per_axis[ev["axis"]] = per_axis.get(ev["axis"], 0.0) + tot
        per_level[lvl] = per_level.get(lvl, 0.0) + tot
        per_dim[dim] = per_dim.get(dim, 0.0) + tot
        key = f"{dim}/{lvl}"
        per_dim_level[key] = per_dim_level.get(key, 0.0) + tot
        _, _, name = ev["tag"].partition("@")
        skey = f"{dim}@{name}" if name else dim
        per_site[skey] = per_site.get(skey, 0.0) + tot
        total += tot
    return {"total_bytes": total, "per_tag": per_tag, "per_axis": per_axis,
            "per_level": per_level, "per_dim": per_dim,
            "per_dim_level": per_dim_level, "per_site": per_site}


def link_bytes(events, train: bool, slow_axes=()) -> dict:
    """Per-device bytes on the fast and the slow link class: a
    hierarchical stage's level says its class ("outer" slow), and a flat
    event is slow iff its axis is in ``slow_axes`` (a flat ring over an
    axis that spans nodes runs at its inter-node links' pace)."""
    fast = slow = 0.0
    for ev in events:
        b = event_bytes(ev, train)
        tot = b["fwd"] + b["bwd"]
        lvl = ev.get("level", "flat")
        if lvl == "outer" or (lvl == "flat" and ev["axis"] in slow_axes):
            slow += tot
        else:
            fast += tot
    return {"fast": fast, "slow": slow}


def collective_seconds(events, train: bool, fast_bytes_per_s: float,
                       slow_bytes_per_s: float, slow_axes=()) -> float:
    """Link time of the collectives, the stages sequential (the fast and
    slow byte pools add, no overlap credit), at the two link rates the
    caller names: there is no default, since the reference's are a TPU's
    interconnect's."""
    lb = link_bytes(events, train, slow_axes)
    return lb["fast"] / fast_bytes_per_s + lb["slow"] / slow_bytes_per_s


def dim_level_bytes(events, dim: str, level: str, train: bool = True) -> float:
    """Per-device bytes of one ``dim/level`` cell, e.g. ``("dp", "outer")``
    for the inter-node DP gradient traffic."""
    return ledger_summary(events, train=train)["per_dim_level"] \
        .get(f"{dim}/{level}", 0.0)


def _two_level_ar_events(scheme_name: str, elems: int, n_inner: int,
                         n_outer: int) -> list:
    """The ledger of one hierarchical DP all-reduce of ``elems`` f32 values
    under ``scheme_name`` (the stage shapes ``comms.hier_all_reduce``
    records), without a mesh."""
    from repro_torch.core import policy
    plan = policy.compile_plan(scheme_name)

    def c(level):
        return plan.codec("dp", None, level).name
    chunk = -(-elems // n_inner)
    mk = dict(tag="dp", dtype="float32", mult=1, remat=False, bidir=False,
              bwd_op=None)
    return [
        dict(mk, op="reduce_scatter", axis="data", n=n_inner, elems=elems,
             codec_fwd=c("inner"), codec_bwd=c("inner"), level="inner"),
        dict(mk, op="all_reduce", axis="node", n=n_outer, elems=chunk,
             codec_fwd=c("outer"), codec_bwd=c("outer"), level="outer"),
        dict(mk, op="all_gather", axis="data", n=n_inner, elems=chunk,
             codec_fwd=c("inner"), codec_bwd=c("inner"), level="inner"),
    ]


# --------------------------------------------------------------------------
# per-level codec autotune: re-price a recorded ledger under candidate
# policies, walking the codec ladder over the fast/slow link ratio
# --------------------------------------------------------------------------

def recost_events(events, policy_like) -> list:
    """Re-price a recorded ledger under a candidate scheme or policy.

    Each event keeps its traffic shape (op, axis, elems, level, ring);
    only the codecs are re-resolved through the candidate's compiled plan,
    from the event's dimension, direction, level, payload size and site
    name, as the reference's."""
    from repro_torch.core import policy
    plan = policy.compile_plan(policy_like)
    out = []
    for ev in events:
        st = policy.as_site(ev["tag"])
        lvl = ev.get("level", "flat")
        # the payload size the live call resolved codecs with (it can
        # exceed elems * itemsize: pro-rated ppermutes, hier AG stages)
        nbytes = ev.get("nbytes",
                        ev["elems"] * _ITEMSIZE.get(ev["dtype"], 4))
        if st.dim in policy.DIRECTED_DIMS and st.direction is None:
            cf = plan.codec(st.dim, "fwd", lvl, nbytes, st.name).name
            cb = plan.codec(st.dim, "bwd", lvl, nbytes, st.name).name
        else:
            cf = cb = plan.codec(st.dim, st.direction, lvl, nbytes,
                                 st.name).name
        out.append(dict(ev, codec_fwd=cf, codec_bwd=cb))
    return out


def suggest_scheme(fast_bytes_per_s: float, slow_bytes_per_s: float, *,
                   elems: int = 1 << 24, n_inner: int = 8, n_outer: int = 4,
                   events=None, train: bool = True) -> dict:
    """Pick per-level codecs from the fast/slow link ratio: walk the
    outer-codec ladder (``tune.ladder.SUGGEST_LADDER``) mild ->
    aggressive and stop at the first candidate whose slow-link seconds no
    longer exceed its fast-link seconds at the two rates the caller names;
    the most aggressive when none gets there.  ``events`` re-prices a
    recorded ledger (:func:`recost_events`); without them, a synthetic
    two-level DP all-reduce of ``elems`` floats.  Returns ``{"scheme",
    "outer_codec", "ratio", "candidates": {name: {"fast_s", "slow_s",
    "total_s", "outer_codec"}}}``, as the reference's."""
    from repro_torch.tune.ladder import SUGGEST_LADDER
    assert fast_bytes_per_s > 0 and slow_bytes_per_s > 0
    cands = {}
    pick = None
    for name, outer in SUGGEST_LADDER:
        if events is not None:
            lb = link_bytes(recost_events(events, name), train=train)
        else:
            lb = link_bytes(_two_level_ar_events(name, elems, n_inner,
                                                 n_outer), train=False)
        fast_s = lb["fast"] / fast_bytes_per_s
        slow_s = lb["slow"] / slow_bytes_per_s
        cands[name] = {"fast_s": fast_s, "slow_s": slow_s,
                       "total_s": fast_s + slow_s, "outer_codec": outer}
        if pick is None and slow_s <= fast_s:
            pick = name
    if pick is None:
        pick = SUGGEST_LADDER[-1][0]
    return {"scheme": pick, "outer_codec": cands[pick]["outer_codec"],
            "ratio": fast_bytes_per_s / slow_bytes_per_s,
            "candidates": cands}


def savings_report(events, before, after, train: bool = True, *,
                   fast_bytes_per_s: float,
                   slow_bytes_per_s: float) -> dict:
    """Predicted wire and time effect of swapping plan ``before`` ->
    ``after``: both re-price the same recorded ledger
    (:func:`recost_events`), so the delta isolates the policy change.
    Returns per-candidate fast/slow link bytes and seconds at the two
    rates the caller names, the slow-link byte saving fraction and the
    seconds saved, as the reference's."""
    out = {}
    for key, cand in (("before", before), ("after", after)):
        lb = link_bytes(recost_events(events, cand), train=train)
        out[key] = {"fast_bytes": lb["fast"], "slow_bytes": lb["slow"],
                    "seconds": lb["fast"] / fast_bytes_per_s
                    + lb["slow"] / slow_bytes_per_s}
    slow0 = out["before"]["slow_bytes"]
    out["slow_saved_frac"] = \
        (slow0 - out["after"]["slow_bytes"]) / slow0 if slow0 else 0.0
    out["seconds_saved"] = out["before"]["seconds"] - out["after"]["seconds"]
    return out


def ledger_per_tag(events, plain: bool = False) -> dict:
    """Per-device training bytes (backward twins included) per site tag;
    ``plain`` prices every event as if its codecs were ``none``: the
    payload the codecs compress."""
    out = {}
    for ev in events:
        if plain:
            ev = {**ev, "codec_fwd": "none", "codec_bwd": "none"}
        b = event_bytes(ev, train=True)
        out[ev["tag"]] = out.get(ev["tag"], 0.0) + b["fwd"] + b["bwd"]
    return out


def wire_per_dim(wire_events) -> dict:
    """Measured wire bytes (payload x hops) per dimension, from the
    ledger's ``.wire`` events."""
    out = {}
    for w in wire_events:
        dim = tag_dim(w["tag"])
        out[dim] = out.get(dim, 0) + w["payload_bytes"] * w["hops"] * w["mult"]
    return out


def wire_per_dim_level(wire_events) -> dict:
    """Measured wire bytes (payload x hops) per ``<dim>/<level>``, the
    level read from the site tag (``dp_outer@zero1_grad`` -> ``dp/outer``;
    an unpinned site is ``flat``)."""
    out = {}
    for w in wire_events:
        tag = w["tag"].split("@")[0]
        lvl = tag.rsplit("_", 1)[1] if tag.endswith(("_inner", "_outer")) \
            else "flat"
        key = f"{tag_dim(tag)}/{lvl}"
        out[key] = out.get(key, 0) + w["payload_bytes"] * w["hops"] * w["mult"]
    return out


# --------------------------------------------------------------------------
# pipeline-parallel terms: the schedule's ticks and bubble, stage handoffs
# --------------------------------------------------------------------------

def pipeline_ticks(pp: int, n_micro: int, vpp: int = 1) -> int:
    """Ticks of the realized schedule (the pipeline's loop runs exactly
    this many): ``n_micro + pp - 1`` for 1F1B, ``n_micro * vpp + pp - 1``
    for interleaved virtual stages, ``n_micro`` without a stage axis."""
    if pp <= 1:
        return max(n_micro, 1)
    if n_micro < 1 or vpp < 1:
        raise ValueError(f"n_micro {n_micro} and vpp {vpp} must be >= 1")
    return n_micro * vpp + pp - 1


def bubble_fraction(pp: int, n_micro: int, vpp: int = 1) -> float:
    """Idle share of the schedule, ``(pp - 1) / pipeline_ticks``: a tick
    runs ``1/vpp`` of a rank's depth, so interleaving cuts the bubble
    about ``1/vpp`` at fixed ``pp``."""
    if pp <= 1:
        return 0.0
    return (pp - 1) / pipeline_ticks(pp, n_micro, vpp)


def stage_handoff_seconds(events, train: bool,
                          link_bytes_per_s: float) -> float:
    """Link time of the ``pp`` events alone (the stage handoffs and the
    stage fold) at ``link_bytes_per_s``: the reference prices them at its
    TPU's link rates, which do not apply here, so the caller names the
    rate of its own link."""
    pp_ev = [ev for ev in events if tag_dim(ev["tag"]) == "pp"]
    return ledger_summary(pp_ev, train)["total_bytes"] / link_bytes_per_s


def cp_ring_seconds(events, train: bool, fast_bytes_per_s: float,
                    slow_bytes_per_s: float, slow_axes=()) -> float:
    """Link time of the ``cp`` events alone: the ring attention's K/V
    hops (one ppermute event per hop, each carrying its codec's wire
    bytes) and the cp gradient fold, through :func:`collective_seconds`
    (a two-level ring's node-crossing hops on the slow link, a flat ring
    over an axis of ``slow_axes`` on it end to end), at the two link rates
    the caller names."""
    cp_ev = [ev for ev in events if tag_dim(ev["tag"]) == "cp"]
    return collective_seconds(cp_ev, train, fast_bytes_per_s,
                              slow_bytes_per_s, slow_axes)


def kv_handoff_seconds(events, fast_bytes_per_s: float,
                       slow_bytes_per_s: float, train: bool = False,
                       slow_axes=()) -> float:
    """Link time of the ``kv`` events alone: the disaggregated server's
    prefill -> decode handoff (``comms.pool_handoff``, one ppermute per
    cache leaf under the plan's ``kv`` codec), through
    :func:`collective_seconds` at the two link rates the caller names.
    Serving runs no backward, so ``train`` defaults False; a pool axis in
    ``slow_axes`` rides the slow link."""
    kv_ev = [ev for ev in events if tag_dim(ev["tag"]) == "kv"]
    return collective_seconds(kv_ev, train, fast_bytes_per_s,
                              slow_bytes_per_s, slow_axes)


def kv_hbm_bytes(n_blocks: int, block_tokens: int, n_layers: int,
                 kv_heads: int, head_dim: int, codec: str = "none",
                 dtype: str = "bfloat16") -> float:
    """Resident device bytes of a paged KV pool (K and V): under a bq
    storage codec the pool holds wire planes, so the bytes shrink by the
    codec's bits per value, the ledger's arithmetic applied to capacity."""
    elems = 2 * n_layers * n_blocks * block_tokens * kv_heads * head_dim
    return _wire_bytes(codec, elems, dtype)


def pipelined_step_time(base_step_s: float, pp: int, n_micro: int,
                        vpp: int = 1) -> float:
    """Step time with the schedule's bubble: the same per-rank work, busy
    ``1 - bubble`` of the ticks."""
    return base_step_s / max(1.0 - bubble_fraction(pp, n_micro, vpp), 1e-9)


# --------------------------------------------------------------------------
# activation memory: the pipeline's saved activations, and the remat trade
# --------------------------------------------------------------------------

def activation_stash_bytes(d_model: int, tokens_per_micro: int,
                           layers_per_rank: int, n_micro: int, pp: int,
                           vpp: int = 1, remat: bool = False,
                           bytes_per_value: int = 2,
                           saved_per_layer: float = 8.0) -> float:
    """Peak per-rank activation stash of the pipeline's ticks, in bytes
    (the reference's arithmetic).

    What it models here: the tensors autograd saves through the eager tick
    loop (:mod:`repro_torch.train.pipeline`).  Each of the ``T =
    pipeline_ticks(...)`` ticks keeps its carry activation
    (``tokens_per_micro * d_model``) alive for the backward pass, plus the
    tensors saved by the layers that ran that tick (``layers_per_rank /
    vpp``, one virtual slice) at ``saved_per_layer`` activations per layer
    per token (attention q/k/v and probabilities, the MLP hidden: about 8
    x d_model for a standard block).  ``remat=True`` models activation
    checkpointing of the stage body: only the carry is saved per tick, and
    the layers' tensors are recomputed in the backward pass."""
    t = pipeline_ticks(pp, n_micro, vpp)
    carry = tokens_per_micro * d_model * bytes_per_value
    if remat:
        return float(t * carry)
    per_tick_layers = layers_per_rank / max(vpp, 1)
    layer = tokens_per_micro * d_model * saved_per_layer * bytes_per_value
    return float(t * (carry + per_tick_layers * layer))


def remat_tradeoff(d_model: int, tokens_per_micro: int,
                   layers_per_rank: int, n_micro: int, pp: int,
                   vpp: int = 1, bytes_per_value: int = 2,
                   peak_flops: float = H100_PEAK_FLOPS,
                   handoff_s: float = 0.0) -> dict:
    """Price the per-stage remat policy: the bytes it saves against the
    seconds its recompute costs at ``peak_flops`` (the forward of the
    rank's layers over all microbatches, ``12 * tokens * d_model^2`` a
    layer), beside the stage-handoff seconds, as the reference's."""
    stash = activation_stash_bytes(d_model, tokens_per_micro,
                                   layers_per_rank, n_micro, pp, vpp,
                                   remat=False,
                                   bytes_per_value=bytes_per_value)
    stash_remat = activation_stash_bytes(d_model, tokens_per_micro,
                                         layers_per_rank, n_micro, pp, vpp,
                                         remat=True,
                                         bytes_per_value=bytes_per_value)
    fwd_flops_per_layer = 12.0 * tokens_per_micro * d_model * d_model
    extra_s = n_micro * layers_per_rank * fwd_flops_per_layer / peak_flops
    return {
        "ticks": pipeline_ticks(pp, n_micro, vpp),
        "bubble_fraction": bubble_fraction(pp, n_micro, vpp),
        "stash_bytes": stash,
        "stash_bytes_remat": stash_remat,
        "bytes_saved": stash - stash_remat,
        "remat_extra_seconds": extra_s,
        "stage_handoff_seconds": handoff_s,
    }


# --------------------------------------------------------------------------
# collective counts: of an HLO text, and of a ledger
# --------------------------------------------------------------------------

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)\s*)?[a-z0-9\[\],{}\s]*?"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")


def hlo_collective_counts(hlo_text: str) -> dict:
    """Collective ops per kind in an HLO module's text (the reference's
    parser; this package emits no HLO, see :func:`collective_counts`)."""
    counts = {}
    for m in _COLL_RE.finditer(hlo_text):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def collective_counts(events) -> dict:
    """Collective calls per op (``all_reduce``, ``reduce_scatter``, ...) in
    a ledger's analytic events: this package's counterpart of
    :func:`hlo_collective_counts`, one count per recorded call."""
    counts = {}
    for ev in events:
        counts[ev["op"]] = counts.get(ev["op"], 0) + 1
    return counts


# --------------------------------------------------------------------------
# model flops
# --------------------------------------------------------------------------

def model_flops(cfg, n_params_active: int, tokens: int) -> float:
    """6 * N * D (dense) / 6 * N_active * D (MoE)."""
    return 6.0 * n_params_active * tokens


def active_params(cfg, n_params_total: int) -> int:
    """Approximate active parameters per token of an MoE architecture."""
    if not cfg.n_experts:
        return n_params_total
    F = cfg.moe_d_ff or cfg.d_ff
    expert_p = cfg.n_experts * 3 * cfg.d_model * F
    per_layer_active = cfg.top_k * 3 * cfg.d_model * F
    n_moe_layers = sum(g.n for g in cfg.layer_groups if g.kind == "moe")
    return int(n_params_total - n_moe_layers * expert_p
               + n_moe_layers * per_layer_active)


# --------------------------------------------------------------------------
# the three terms
# --------------------------------------------------------------------------

_ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "flops",
                  "hbm_bytes", "coll_bytes", "model_flops")


@dataclasses.dataclass
class Roofline:
    """The three terms of a step at ``peak_flops``, the compute peak the
    step was priced at (which :attr:`mfu` divides by)."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_bytes: float
    model_flops: float
    peak_flops: float = H100_PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        return (self.model_flops / max(self.step_time_s, 1e-12)) \
            / self.peak_flops

    def to_dict(self):
        """The reference's keys (the peaks are the caller's to record)."""
        return {**{k: getattr(self, k) for k in _ROOFLINE_KEYS},
                "dominant": self.dominant, "mfu": self.mfu,
                "useful_ratio": self.useful_ratio,
                "step_time_s": self.step_time_s}


def roofline(cost, coll_bytes_per_device: float, n_chips: int,
             model_flops_total: float, *,
             peak_flops: float = H100_PEAK_FLOPS,
             hbm_bytes_per_s: float = H100_HBM_BW,
             link_bytes_per_s: float = H100_NVLINK_BW) -> Roofline:
    """The three terms of a step from its per-device cost (``{"flops",
    "bytes accessed"}``), its per-device collective bytes and the model
    FLOPs of the whole step over ``n_chips``, at the peaks the caller
    names (by default the H100's)."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / peak_flops,
        memory_s=bytes_ / hbm_bytes_per_s,
        collective_s=coll_bytes_per_device / link_bytes_per_s,
        flops=flops,
        hbm_bytes=bytes_,
        coll_bytes=coll_bytes_per_device,
        model_flops=model_flops_total / n_chips,
        peak_flops=peak_flops,
    )
