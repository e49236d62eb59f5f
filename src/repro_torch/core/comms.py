"""Compression-assisted collectives over ``torch.distributed`` (port of the
flat half of ``repro.core.comms``).

Every collective the model and the optimizer emit goes through this module,
tagged with a :class:`Site`.  The active compiled
:class:`~repro_torch.core.policy.CommPlan` (``policy.use_plan``, else the
adapter plan of the current scheme) maps the site and its payload size to a
codec:

* identity codecs (``none``, ``mpc``) run the plain collective;
* ``bq*`` codecs run the compressed forms, whose payload is the encoded
  wire dict: all-gather encodes once, exchanges the wire and decodes;
  reduce-scatter and all-reduce run a ring whose hop body is the fused
  decode-add-encode kernel (wire-only on intermediate hops, with the sum on
  the all-reduce tail), ending in decode-add on the last reduce-scatter
  hop.  All-reduce is the ring reduce-scatter plus an all-gather of the
  final compressed chunk (paper §IV-A).

Autodiff: each collective is a ``torch.autograd.Function`` whose backward
runs the transpose collective under the backward-direction codec, as the
reference's ``custom_vjp`` pairs do.

Hierarchical collectives: an :class:`AxisPair` (a node-factored axis, its
outer node axis, its inner axis and the joint axis over both) routes every
entry point through the two-level decomposition with per-level codecs,
as the reference's ``hier_*`` family does: all-reduce = RS(inner) ->
AR(outer) -> AG(inner), reduce-scatter = RS(inner) -> RS(outer),
all-gather = AG(outer) -> AG(inner), and the permutation sends its edges
inside a node under the inner codec and those that cross a node under the
outer one.  Each stage's kernel launches count under its level
(``bq.LAUNCH_LEVELS``).

An :class:`Axis` is one mesh axis seen from this rank: its size, this
rank's index along it, its process group and the global ranks it holds.
Ranks exchange through small private helpers.  Gloo, the backend used
here, exchanges host tensors only, so a CUDA payload is staged through
pinned host memory explicitly (``STAGING`` counts the bytes, and the
seconds under :func:`time_staging`); every encode, fused hop and decode
stays on the device.

Carried-state codecs (``ef:*``, ``plr*``) ride only the optimizer's sync
sites, inside a :class:`codec_state_io` region that binds the step's codec
state: ``ef:*`` compensates with its residual, rides the inner codec and
stashes the new error; ``plr*`` runs the two-factor low-rank all-reduce on
the kernels of :mod:`repro_torch.kernels.lowrank`, its factors summed
uncompressed as the reference's ``lax.psum`` does.  Autodiff traffic never
carries them.

Runtime-tunable sites (the self-tuning controller's swap point,
:mod:`repro_torch.tune`): inside a :class:`tune_io` region, a registered
sum site (the optimizer's DP gradient sync) dispatches on a host rung
index over the ladder's executable rungs (:func:`_tuned_collective`)
instead of its plan-static codec, and accumulates the controller's
signals.

The ledger (:class:`record_traffic`), the ring options, the wire-site tag,
the codec-state region and the tune region are process-wide rather than
thread-local: autograd runs the backward of CUDA tensors on its own
thread, which must see the same bindings.

Activation checkpointing (:func:`checkpointed`, for the remat'd layer
groups and the pipeline's remat policy) re-runs a body's collectives in
the backward pass: their analytic events are muted there, and a remat'd
layer group's forward events carry ``remat`` (:class:`scope_remat`) so
that the roofline prices their forward twice, as the reference's does.

The all-to-all (:func:`all_to_all`, the expert-parallel ``ep`` token
routing) splits its payload into one slice per rank; under a ``bq*``
codec each slice is encoded in block form, the wire planes are exchanged
and decoded.  On a pair it is :func:`hier_all_to_all`: the intra-node
exchange under the inner codec, then the inter-node one under the outer
codec, chunks in the joint outer-major order.

Serving adds :func:`pool_handoff` (the disaggregated prefill -> decode KV
handoff over the pool axis, ledgered under ``kv``) and
:func:`raw_all_gather` (the uncompressed, ledger-free gather that moves
prefill caches into the decode layout).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.core import codecs, policy
from repro_torch.kernels import bq, lowrank, ops
from repro_torch.kernels.ref import BLOCK

Site = policy.Site
site = policy.site


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it.  ``ranks[i]`` is the global
    rank at axis index ``i``; ``group`` is the process group over them
    (``None`` with ``size == 1``, or for the default group)."""

    name: str
    size: int = 1
    index: int = 0
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)
    ranks: tuple = ()


@dataclasses.dataclass(frozen=True)
class AxisPair:
    """A node-factored mesh axis (the port of the reference's
    ``compat.AxisPair``): ``outer`` enumerates nodes (slow links),
    ``inner`` the ranks inside one node (fast links), and ``joint`` is the
    flat axis over both, linearized outer-major (joint index ``o * n_inner
    + i``), named ``(outer, inner)``.  The collectives dispatch on it to
    the hierarchical two-level forms; uncompressed sums (:func:`raw_psum`,
    :func:`pmax`) and ``size`` / ``index`` see the joint axis."""

    outer: Axis
    inner: Axis
    joint: Axis

    @property
    def size(self) -> int:
        return self.joint.size

    @property
    def index(self) -> int:
        return self.joint.index


def _is_pair(axis) -> bool:
    return isinstance(axis, AxisPair)


def _flat(axis) -> Axis:
    """The flat axis a collective that has no two-level form runs over:
    the joint axis of a pair."""
    return axis.joint if _is_pair(axis) else axis


# --------------------------------------------------------------------------
# process-wide state: the ledger, the ring options, the wire-site tag
# --------------------------------------------------------------------------

class _State:
    events = None
    muted = 0
    facts = {}
    bidir = False
    chunks = 1
    wire_tag = "-"
    level = "flat"
    time_staging = False
    state_io = None
    tune_io = None
    shape_only = 0
    remat = False


_rec = _State()

# bytes copied between the card and host memory for the exchange, and the
# host seconds spent staging and exchanging (under time_staging only)
STAGING = {"bytes": 0, "seconds": 0.0}


# host seconds of named spans (under time_staging only)
SPANS: collections.Counter = collections.Counter()


def reset_staging() -> None:
    STAGING.update(bytes=0, seconds=0.0)
    SPANS.clear()


def time_staging(on: bool) -> None:
    """Split step time into compute and exchange: with ``on``, every
    exchange first drains the device and adds its host seconds to
    ``STAGING["seconds"]``.  Off (the default), exchanges carry no
    measurement sync and only the staged bytes are counted."""
    _rec.time_staging = bool(on)


class _EventLog(list):
    """The ledger :class:`record_traffic` yields: the list holds the
    analytic per-call events (:func:`_account`), ``.wire`` the measured
    per-phase wire events (:func:`_log`)."""

    def __init__(self):
        super().__init__()
        self.wire = []


class record_traffic:
    """Collective ledger.  Every public comms call appends one analytic
    event (local payload elements, axis size, both codecs, the ring
    schedule of ring-lowered ops) with the reference's keys, so both
    packages' ledgers price alike; the implementations append the measured
    wire events (encoded bytes per hop x hops).  Unlike the reference,
    backward events carry the site tag of their forward call."""

    def __enter__(self):
        self.prev = _rec.events
        self.events = _EventLog()
        _rec.events = self.events
        return self.events

    def __exit__(self, *exc):
        _rec.events = self.prev
        return False


class scope_facts:
    """Attach key/value facts to every ledger event (analytic and wire)
    recorded inside; inner scopes shadow outer keys.  The pipeline wraps
    its ticks in ``scope_facts(vpp=V)``, as the reference does, so each
    event records which schedule produced it.

    The reference's ``scope_mult`` multiplies the events of a body traced
    once and run many times, where this package runs every tick eagerly
    and records each call's events; its ``remat`` mark is
    :class:`scope_remat`."""

    def __init__(self, **facts):
        self.facts = facts

    def __enter__(self):
        self.prev = _rec.facts
        _rec.facts = {**self.prev, **self.facts}
        return self

    def __exit__(self, *exc):
        _rec.facts = self.prev
        return False


class scope_remat:
    """Mark the analytic events recorded inside ``remat`` when ``on``: the
    forward collectives of a rematerialized layer group, which re-run in
    the backward pass (``roofline.event_bytes`` prices their forward twice
    in training), as the reference's ``scope_mult(remat=True)`` marks
    them.  An outer mark stays on inside."""

    def __init__(self, on: bool):
        self.on = bool(on)

    def __enter__(self):
        self.prev = _rec.remat
        _rec.remat = self.prev or self.on
        return self

    def __exit__(self, *exc):
        _rec.remat = self.prev
        return False


class mute_ledger:
    """Drop the analytic events of the collectives called inside.

    Activation checkpointing (:func:`checkpointed`) re-runs a body during
    the backward pass; the reference's ledger counts a checkpointed body
    once (traced once), so the recompute's analytic events are muted.  Its
    measured wire events are kept: those bytes do cross."""

    def __enter__(self):
        _rec.muted += 1
        return self

    def __exit__(self, *exc):
        _rec.muted -= 1
        return False


def checkpointed(fn):
    """``fn`` under activation checkpointing: ``torch.utils.checkpoint``,
    non-reentrant, so only its tensor inputs are saved and the backward
    runs it again, whole (early stop off: every collective of the body
    re-runs, in the same order on every rank).  The recompute runs where
    the backward runs, on autograd's own thread for CUDA tensors, where
    the forward's thread-local plan is unbound: it re-binds that plan, so
    that its collectives take the same codecs, and mutes their analytic
    events (:class:`mute_ledger`).  The bodies draw no random numbers, so
    no RNG state is kept."""
    def run(*args):
        plan = policy.current_plan()
        calls = []

        def body(*a):
            calls.append(1)
            if len(calls) > 1:          # the recompute, in the backward
                with policy.use_plan(plan), mute_ledger():
                    return fn(*a)
            return fn(*a)
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False, preserve_rng_state=False)
    return run


class shape_only:
    """Trace on shapes alone: inside, the raw transports (the exchange,
    all-gather, all-reduce, reduce-scatter and all-to-all every collective
    of this module, :func:`raw_psum`, :func:`pmax`, :func:`raw_ppermute`
    and :func:`raw_all_gather` reduce to) return a result of the right
    shape and dtype on their input's device without moving or staging
    anything, and need no process group.  The ledger records exactly what
    a real run records.  The dry-run traces one rank's step on meta
    tensors this way (:mod:`repro_torch.launch.dryrun`); the values that
    come out are meaningless."""

    def __enter__(self):
        _rec.shape_only += 1
        return self

    def __exit__(self, *exc):
        _rec.shape_only -= 1
        return False


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _account(op, tag, x, axis, c_fwd, c_bwd, bwd_op=None, level="flat",
             elems=None, nbytes=None):
    """Append one analytic ledger event (see the reference's docstring)."""
    events = _rec.events
    if events is None or _rec.muted:
        return
    if level == "flat" and tag.endswith(("_inner", "_outer")):
        level = tag.rsplit("_", 1)[1]
    if elems is None:
        elems = x.numel()
    if nbytes is None:
        nbytes = int(elems) * x.element_size()
    n = int(axis.size)
    ev = dict(
        op=op, tag=tag, axis=axis.name, n=n,
        elems=int(elems), dtype=_dtype_name(x.dtype), nbytes=int(nbytes),
        codec_fwd=c_fwd.name, codec_bwd=c_bwd.name,
        bwd_op=bwd_op, mult=1, remat=_rec.remat,
        bidir=_bidir(), level=level, **_rec.facts)
    if op in ("all_reduce", "reduce_scatter") and n > 1:
        sched = _ring_schedule(ops.padded_rows(-(-int(elems) // n)))
        ev["ring"] = dict(rows=sched.rows, hops=n - 1,
                          parts=[list(p) for p in sched.parts],
                          bidir=sched.bidir, fallback=sched.fallback,
                          chunks=sched.chunks)
    events.append(ev)


def _log(op, tag, codec, payload_bytes, hops, **facts):
    """Measured wire event: ``payload_bytes`` encoded bytes per hop (tile
    padding included), repeated ``hops`` times."""
    events = _rec.events
    if events is None:
        return
    if not tag or tag == "-":
        tag = _rec.wire_tag
    events.wire.append(dict(
        op=op, tag=tag, codec=codec.name, payload_bytes=int(payload_bytes),
        hops=int(hops), mult=1, **_rec.facts, **facts))


class _bind:
    """Bind the wire-site tag, the ring options and the link level the
    kernel launches count under (``None`` keeps the current value) for the
    duration of a block."""

    def __init__(self, tag=None, bidir=None, chunks=None, level=None):
        self.new = (tag, bidir, chunks, level)

    def __enter__(self):
        self.prev = (_rec.wire_tag, _rec.bidir, _rec.chunks, _rec.level)
        tag, bidir, chunks, level = self.new
        if tag is not None:
            _rec.wire_tag = tag
        if bidir is not None:
            _rec.bidir = bool(bidir)
        if chunks is not None:
            _rec.chunks = int(chunks)
        if level is not None:
            _rec.level = level
            bq.set_launch_level(level)
        return self

    def __exit__(self, *exc):
        _rec.wire_tag, _rec.bidir, _rec.chunks, level = self.prev
        if self.new[3] is not None:
            _rec.level = level
            bq.set_launch_level(level)
        return False


def _wire_site(s):
    """Bind a site's wire tag and its link level (a level-pinned site's,
    else "flat")."""
    return _bind(tag=s.ledger_tag, level=s.level or "flat")


def _stage(level: str):
    """One stage of a hierarchical collective: its launches count under
    ``level``."""
    return _bind(level=level)


class ring_options(_bind):
    """Levers of the compressed rings: ``bidir`` splits the payload rows
    over two counter-rotating rings; ``chunks`` stripes each directional
    ring into up to that many row-striped sub-rings.  Both are bit-exact
    for bq codecs (scales are per 128-lane row) at a fixed ``bidir``."""

    def __init__(self, bidir: bool, chunks: int = 1):
        if chunks < 1:
            raise ValueError(f"ring chunks must be >= 1, got {chunks}")
        super().__init__(bidir=bidir, chunks=chunks)


def _bidir() -> bool:
    return bool(_rec.bidir)


def _ring_chunks() -> int:
    return int(_rec.chunks)


def _payload_nbytes(x) -> int:
    return int(x.numel() * x.element_size())


def _codec_pair(tag, nbytes: int | None = None):
    """(fwd, bwd) codecs of one single-stage collective, resolved through
    the active compiled plan."""
    return policy.current_plan().codec_pair(policy.as_site(tag), nbytes)


def _require_stateless(s, *cs):
    """Raise for a stateful codec at an autodiff site (the reference's
    message)."""
    for c in cs:
        if getattr(c, "stateful", False):
            raise NotImplementedError(
                f"stateful codec {c.name!r} resolved at site "
                f"{s.ledger_tag!r}: error-feedback / low-rank codecs ride "
                f"only the optimizer's sync sites (inside a "
                f"codec_state_io region), never autodiff traffic.  "
                f"Exempt this site with a policy rule, e.g. "
                f"Rule('bq8', dim='{s.dim}') ordered before the stateful "
                f"rule.")


# --------------------------------------------------------------------------
# codec-state io: the carried state of stateful codecs (ef:*, plr*)
# --------------------------------------------------------------------------

class codec_state_io:
    """Bind the codec-state dict for the optimizer's sync region.

    The trainer passes the step's codec state (one slot per stateful site,
    keyed by the site's ledger tag; template from
    ``CommPlan.codec_state_template``); each stateful comms site reads its
    slot and writes the updated state back.  ``collect()`` returns the
    post-region dict (slots of sites that did not fire keep their old
    value).  Process-wide, like the ledger."""

    def __init__(self, states: dict | None):
        self.states = dict(states or {})

    def __enter__(self):
        self.prev = _rec.state_io
        _rec.state_io = self
        return self

    def __exit__(self, *exc):
        _rec.state_io = self.prev
        return False

    def read(self, key: str):
        try:
            return self.states[key]
        except KeyError:
            raise KeyError(
                f"no codec-state slot for site {key!r} (have "
                f"{sorted(self.states)}); the trainer's state template "
                f"(Trainer.codec_sites) does not cover this site — route "
                f"it to a stateless codec with a policy rule") from None

    def write(self, key: str, st):
        self.states[key] = st

    def collect(self) -> dict:
        return dict(self.states)


def _state_slot(s, c):
    """(io, key, state) for a stateful codec at a supported site."""
    io = _rec.state_io
    key = s.ledger_tag
    if io is None:
        raise RuntimeError(
            f"stateful codec {c.name!r} resolved for site {key!r} outside "
            f"a codec-state region: ef:*/plr* codecs ride only the "
            f"optimizer's dp/zero sync sites, which the trainers wrap in "
            f"comms.codec_state_io(...).  Route this site to a stateless "
            f"codec with a policy rule (e.g. Rule('bq8', dim='{s.dim}')).")
    return io, key, io.read(key)


def _stateful_ok() -> bool:
    """True inside a ``codec_state_io`` region, the optimizer's sync
    scope; autodiff traffic runs outside it."""
    return _rec.state_io is not None


# --------------------------------------------------------------------------
# tune io: runtime-tunable sites (the self-tuning controller's swap point)
# --------------------------------------------------------------------------

class tune_io:
    """Bind the runtime-tunable site table for one step.

    ``select`` maps a tunable site's ledger tag to a host ``int`` rung
    index over :data:`repro_torch.tune.ladder.RUNGS`; a registered site
    dispatches on it (:func:`_tuned_collective`) instead of its
    plan-static codec, so the host-side controller changes a site's codec
    by passing another integer to the next step: nothing is rebuilt.
    ``sig`` carries each site's signal accumulator (the
    :mod:`repro_torch.tune.tracker` layout); the tuned sites add their
    step's increment, summed over ``axis`` (the whole world) and divided
    by its size, so every rank holds the same accumulator.  Process-wide,
    like :class:`codec_state_io`; sites not in ``select`` are untouched."""

    def __init__(self, select: dict, sig: dict, axis=None):
        self.select = {k: int(v) for k, v in (select or {}).items()}
        self.sig = dict(sig or {})
        self.axis = axis

    def __enter__(self):
        self.prev = _rec.tune_io
        _rec.tune_io = self
        return self

    def __exit__(self, *exc):
        _rec.tune_io = self.prev
        return False

    def add_sig(self, key: str, inc: torch.Tensor) -> None:
        axis = self.axis
        if axis is not None and axis.size > 1:
            # mean over the world, as the reference's psum / n: ``count``
            # stays a true step count and the payload and error sums
            # become per-rank means (their ratios, all the controller
            # reads, are unchanged).  48 bytes, uncompressed
            inc = raw_psum(inc, axis) / axis.size
        acc = torch.as_tensor(self.sig[key], dtype=torch.float32,
                              device=inc.device)
        self.sig[key] = acc + inc

    def collect(self) -> dict:
        return dict(self.sig)


def _tuned_site(s):
    """The active tune_io region iff ``s`` is registered as tunable."""
    tio = _rec.tune_io
    if tio is not None and s.ledger_tag in tio.select:
        return tio
    return None


# --------------------------------------------------------------------------
# raw exchange between ranks (uncompressed; gloo takes host tensors)
# --------------------------------------------------------------------------

def _host(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """A host copy of ``t`` for the exchange (pinned when it comes from the
    card); a host ``t`` is copied only when ``copy`` (the exchange writes
    into it)."""
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format) if copy \
            else t.contiguous()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGING["bytes"] += h.numel() * h.element_size()
    return h


def _device(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "cpu":
        return h
    STAGING["bytes"] += h.numel() * h.element_size()
    return h.to(like.device)


def _pinned_empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype,
                       pin_memory=like.device.type == "cuda")


class _staged:
    """Under :func:`time_staging`, time one exchange on the host clock,
    with the device drained first so queued kernels do not count as
    exchange time; otherwise do nothing."""

    def __init__(self, like: torch.Tensor):
        self.on = _rec.time_staging
        self.like = like

    def __enter__(self):
        if self.on:
            if self.like.device.type == "cuda":
                torch.cuda.synchronize(self.like.device)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on:
            STAGING["seconds"] += time.perf_counter() - self.t0
        return False


class span(_staged):
    """Under :func:`time_staging`, add the host seconds of a region to
    ``SPANS[name]``, the device drained at both ends; otherwise do
    nothing."""

    def __init__(self, name: str, like: torch.Tensor):
        super().__init__(like)
        self.name = name

    def __exit__(self, *exc):
        if self.on:
            if self.like.device.type == "cuda":
                torch.cuda.synchronize(self.like.device)
            SPANS[self.name] += time.perf_counter() - self.t0
        return False


def _pack(wire: dict):
    """Wire dict -> (one uint8 tensor, layout): one message per exchange."""
    layout, parts = [], []
    for k, v in wire.items():
        if v is None:
            layout.append((k, None, None, 0))
            continue
        b = v.contiguous().reshape(-1).view(torch.uint8)
        layout.append((k, tuple(v.shape), v.dtype, b.numel()))
        parts.append(b)
    return torch.cat(parts) if len(parts) > 1 else parts[0], layout


def _unpack(buf: torch.Tensor, layout) -> dict:
    out, at = {}, 0
    for k, shape, dtype, nb in layout:
        if shape is None:
            out[k] = None
            continue
        out[k] = buf[at:at + nb].view(dtype).reshape(shape)
        at += nb
    return out


def _bound(axis: Axis) -> Axis:
    if axis.size > 1 and len(axis.ranks) != axis.size:
        raise RuntimeError(
            f"axis {axis.name!r} of size {axis.size} is not bound to a "
            f"process group (build the mesh with launch.mesh.make_mesh)")
    return axis


def _exchange(buf: torch.Tensor, axis: Axis, perm) -> torch.Tensor:
    """Point-to-point permutation of one tensor over ``axis``: for each
    ``(src, dst)`` pair of axis indices, ``src`` sends and ``dst``
    receives; a rank that receives nothing gets zeros.  Every send and
    receive of the rank is posted together, so a ring cannot deadlock."""
    if _rec.shape_only:
        return torch.zeros_like(buf)
    idx = _bound(axis).index
    with _staged(buf):
        h = _host(buf)
        out = torch.zeros_like(h)
        ops_ = [dist.P2POp(dist.isend, h, axis.ranks[d], group=axis.group)
                for s, d in perm if s == idx]
        ops_ += [dist.P2POp(dist.irecv, out, axis.ranks[s], group=axis.group)
                 for s, d in perm if d == idx]
        if ops_:
            for req in dist.batch_isend_irecv(ops_):
                req.wait()
        return _device(out, buf)


def _shift_wire(wire: dict, axis: Axis, shift: int) -> dict:
    """Ring hop: send ``wire`` to axis index ``(i + shift) % n`` and return
    the wire received from ``(i - shift) % n``."""
    n = axis.size
    buf, layout = _pack(wire)
    perm = [(j, (j + shift) % n) for j in range(n)]
    return _unpack(_exchange(buf, axis, perm), layout)


def _all_gather_raw(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """-> ``[n, *t.shape]``: every rank's ``t`` in axis order."""
    if _rec.shape_only:
        return t.new_zeros((axis.size,) + tuple(t.shape))
    _bound(axis)
    with _staged(t):
        h = _host(t)
        out = _pinned_empty((axis.size,) + tuple(h.shape), h.dtype, t)
        dist.all_gather(list(out.unbind(0)), h, group=axis.group)
        return _device(out, t)


def _all_gather_wire(wire: dict, axis: Axis) -> dict:
    """Wire dict -> wire dict of ``[n, ...]`` planes in axis order."""
    buf, layout = _pack(wire)
    g = _all_gather_raw(buf, axis)
    per = [_unpack(g[j], layout) for j in range(axis.size)]
    return {k: None if per[0][k] is None else
            torch.stack([p[k] for p in per]) for k in wire}


def _reduce_dtype(dtype) -> torch.dtype:
    """Sums of low-precision floats run in f32 and round once."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _all_reduce_raw(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM):
    if _rec.shape_only:
        return x.clone()
    if _bound(axis).size == 1:
        return x
    with _staged(x):
        h = _host(x.to(_reduce_dtype(x.dtype)), copy=True)
        dist.all_reduce(h, op=op, group=axis.group)
        return _device(h, x).to(x.dtype)


def _psum_scatter_raw(x: torch.Tensor, axis: Axis, axis_dim: int):
    """Uncompressed tiled reduce-scatter of dim ``axis_dim``: an all-to-all
    of the n chunks, then a sum in axis order."""
    n = axis.size if _rec.shape_only else _bound(axis).size
    xs = x.unflatten(axis_dim, (n, -1)).movedim(axis_dim, 0)  # [n, ..chunk..]
    if _rec.shape_only:
        return xs.sum(dim=0).to(x.dtype)
    with _staged(x):
        h = _host(xs.to(_reduce_dtype(x.dtype)))
        out = _pinned_empty(h.shape, h.dtype, x)
        dist.all_to_all_single(out, h, group=axis.group)
        return _device(out.sum(dim=0), x).to(x.dtype)


def _all_to_all_raw(xs: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[n, ...]`` -> ``[n, ...]``: row ``j`` goes to axis index ``j``, and
    row ``j`` of the result came from axis index ``j``.  The rows travel as
    bytes, so any dtype crosses unchanged."""
    if _rec.shape_only:
        return torch.zeros_like(xs)
    n = _bound(axis).size
    with _staged(xs):
        h = _host(xs).reshape(n, -1).view(torch.uint8)
        out = _pinned_empty(h.shape, torch.uint8, xs)
        dist.all_to_all_single(out, h, group=axis.group)
        return _device(out.view(xs.dtype).reshape(xs.shape), xs)


def _all_to_all_wire(wire: dict, axis: Axis) -> dict:
    """Wire dict of ``[n, ...]`` planes -> the planes' rows exchanged as by
    :func:`_all_to_all_raw`, all planes in one message."""
    n = axis.size
    rows = {k: v.contiguous().reshape(n, -1).view(torch.uint8)
            for k, v in wire.items() if v is not None}
    got = _all_to_all_raw(torch.cat(list(rows.values()), 1), axis)
    out, at = {}, 0
    for k, v in wire.items():
        if v is None:
            out[k] = None
            continue
        nb = rows[k].shape[1]
        out[k] = got[:, at:at + nb].contiguous().view(v.dtype).reshape(
            v.shape)
        at += nb
    return out


def raw_psum(x: torch.Tensor, axis: Axis, mean: bool = False,
             local_bwd: bool = False):
    """Uncompressed all-reduce (``lax.psum``/``pmean``), outside the
    ledger.  Differentiable: its backward is the same all-reduce of the
    cotangent, the transpose the reference's step differentiates through
    (its shard_map runs without varying-axes checks).  ``local_bwd`` says
    the cotangent is the same on every rank of ``axis`` (the output feeds
    a replicated loss), so that all-reduce is a local multiply by the axis
    size: no collective in the backward, and a rank whose ``x`` carries
    no gradient need not join it."""
    axis = _flat(axis)
    if axis.size == 1:
        return x
    return _RawPsumFn.apply(x, axis, mean, local_bwd)


class _RawPsumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mean, local_bwd):
        ctx.axis, ctx.mean, ctx.local_bwd = axis, mean, local_bwd
        out = _all_reduce_raw(x, axis)
        return out / axis.size if mean else out

    @staticmethod
    def backward(ctx, g):
        out = g * ctx.axis.size if ctx.local_bwd else \
            _all_reduce_raw(g, ctx.axis)
        return (out / ctx.axis.size if ctx.mean else out), None, None, None


def pmax(x, axis: Axis):
    """Max all-reduce over ``axis`` (never compressed: tiny softmax-stat
    payloads).  No gradient flows through it, as in the reference, whose
    VJP is zero; callers pass detached values.  A pair reduces as its
    joint axis: max has no two-level codec treatment."""
    axis = _flat(axis)
    if axis.size == 1:
        return x
    with torch.no_grad():
        return _all_reduce_raw(x.detach(), axis, op=dist.ReduceOp.MAX)


def raw_ppermute(x, axis, perm):
    """Uncompressed permutation over ``axis`` (a pair permutes on its joint
    axis), outside the ledger and without a gradient, as the reference's
    ``lax.ppermute`` of the ring attention's integer positions and
    validity masks: no codec touches them (compare ``tp@attn_pos``, which
    does).  A bool payload rides as bytes."""
    axis = _flat(axis)
    if axis.size == 1:
        return x
    with torch.no_grad():
        if x.dtype == torch.bool:
            return _exchange(x.to(torch.uint8), axis, perm).bool()
        return _exchange(x.contiguous(), axis, perm)


def raw_all_gather(x, axis, axis_dim: int):
    """Uncompressed all-gather of dim ``axis_dim`` over ``axis`` (a pair
    gathers on its joint axis), outside the ledger and without a gradient:
    host-side data movement that the reference does outside its step (the
    serving launcher's prefill-to-decode cache layout) and that no codec
    or ledger event may see."""
    axis = _flat(axis)
    if axis.size == 1:
        return x
    with torch.no_grad():
        g = _all_gather_raw(x.contiguous(), axis)
        return torch.movedim(g, 0, axis_dim).reshape(
            ops.gathered_shape(x.shape, axis.size, axis_dim))


# --------------------------------------------------------------------------
# block-layout helpers
# --------------------------------------------------------------------------

def _chunked_blocks(flat: torch.Tensor, n: int) -> torch.Tensor:
    """1-D -> [n, M, BLOCK] f32 with each of the n chunks tile-padded."""
    per = -(-flat.shape[0] // n)
    m = ops.padded_rows(per)
    out = torch.zeros(n * m * BLOCK, dtype=torch.float32, device=flat.device)
    out[:flat.shape[0]] = flat
    return out.reshape(n, m, BLOCK)


def _chunk_shape(x: torch.Tensor, axis_dim: int, n: int) -> tuple:
    """Shape of one of the n chunks of x split along ``axis_dim``."""
    s = x.shape[axis_dim]
    if s % n:
        raise ValueError(f"dim {axis_dim} of size {s} not divisible by axis "
                         f"size {n}")
    return tuple(x.shape[:axis_dim] + (s // n,) + x.shape[axis_dim + 1:])


def _split_for_scatter(x: torch.Tensor, axis_dim: int, n: int):
    """x with x.shape[axis_dim] % n == 0 -> ([n, M, BLOCK] blocks of the
    n chunks, chunk_shape)."""
    chunk_shape = _chunk_shape(x, axis_dim, n)
    s = x.shape[axis_dim]
    xs = x.reshape(x.shape[:axis_dim] + (n, s // n) + x.shape[axis_dim + 1:])
    flat = torch.movedim(xs, axis_dim, 0).reshape(n, -1)
    m = ops.padded_rows(flat.shape[1])
    out = torch.zeros((n, m * BLOCK), dtype=torch.float32, device=x.device)
    out[:, :flat.shape[1]] = flat
    return out.reshape(n, m, BLOCK), chunk_shape


# --------------------------------------------------------------------------
# the compressed ring (reduce-scatter core)
# --------------------------------------------------------------------------

_RING_TILE = 8  # kernel row tile: every sub-ring keeps tile alignment

RingSchedule = collections.namedtuple(
    "RingSchedule", ["parts", "rows", "bidir", "fallback", "chunks"])


def _ring_schedule(m: int, bidir: bool | None = None,
                   chunks: int | None = None) -> RingSchedule:
    """Row partition of an ``[n, m, BLOCK]`` ring payload into independent
    sub-rings: ``parts`` is a tuple of ``(row_lo, row_hi, direction)``.
    The bidirectional split comes first (skipped, ``fallback=True``, when
    the halves would break the 8-row tile), then each directional segment
    is striped into up to ``chunks`` tile-aligned parts.  ``bidir`` and
    ``chunks`` record what was realized.  (Verbatim from the reference.)"""
    want_bidir = _bidir() if bidir is None else bool(bidir)
    want_chunks = _ring_chunks() if chunks is None else int(chunks)
    half = (m // 2) // _RING_TILE * _RING_TILE
    bidir = want_bidir and half >= _RING_TILE
    fallback = want_bidir and not bidir
    segs = [(0, half, +1), (half, m, -1)] if bidir else [(0, m, +1)]
    parts = []
    realized = 1
    for lo, hi, d in segs:
        tiles = (hi - lo) // _RING_TILE
        k = max(1, min(want_chunks, tiles))
        realized = max(realized, k)
        base, rem = divmod(tiles, k)
        at = lo
        for i in range(k):
            rows = (base + (1 if i < rem else 0)) * _RING_TILE
            parts.append((at, at + rows, d))
            at += rows
        assert at == hi
    return RingSchedule(tuple(parts), m, bidir, fallback, realized)


def _ring_rs_dir(take, n: int, axis: Axis, codec, direction: int,
                 want_wire: bool = True, out=None):
    """One directional ring (+1 clockwise, -1 counter-clockwise) over n
    chunks, ``take(k)`` giving chunk k's addend.  Rank i ends owning the
    full sum of chunk i.  Returns ``(acc, wire, hop_nbytes)``.
    Intermediate hops run the wire-only fused hop; the last hop runs the
    fused hop with the sum (``want_wire``: the all-reduce gathers the
    compressed chunk) or decode-add (plain reduce-scatter).  The addends
    are ``[M, BLOCK]`` f32 blocks, or, with ``out``, shard views read in
    place by the codec's view forms, whose last hop writes this rank's sums
    into ``out`` (returned as ``acc``)."""
    idx = axis.index
    view = out is not None
    acc = take((idx - direction) % n)
    wire = codec.encode_view(acc) if view else codec.encode_blocks(acc)
    hop_nbytes = ops.wire_nbytes(wire)
    for t in range(n - 1):
        wire = _shift_wire(wire, axis, direction)
        local = take((idx - direction * (2 + t)) % n)
        if t < n - 2:
            wire = codec.decode_add_encode_view(wire, local) if view else \
                codec.decode_add_encode_blocks(wire, local, want_sum=False)[0]
        elif want_wire:
            wire, acc = codec.decode_add_encode_blocks(wire, local)
        else:
            acc = codec.decode_add_view(wire, local, out) if view else \
                codec.decode_add_blocks(wire, local)
            wire = None
    return acc, wire, hop_nbytes


def _ring_parts(m: int, n: int, codec, part):
    """Run the sub-rings of :func:`_ring_schedule` over ``m`` rows one
    after another, in the same order on every rank (``part(lo, hi,
    direction, whole)`` runs one), and log the ring; returns the parts'
    ``(accs, wires)``."""
    sched = _ring_schedule(m)
    accs, wires, hop_nbytes = [], [], 0
    for lo, hi, d in sched.parts:
        acc, wire, nb = part(lo, hi, d, len(sched.parts) == 1)
        accs.append(acc)
        wires.append(wire)
        hop_nbytes += nb
    _log("rs_ring", "-", codec, hop_nbytes, n - 1,
         parts=len(sched.parts), bidir=sched.bidir, fallback=sched.fallback)
    return accs, wires


def _ring_reduce_scatter(xb, axis: Axis, codec, want_wire: bool = True):
    """xb: [n, M, BLOCK] per-rank addends -> (sum chunk [M, BLOCK] f32 owned
    by this rank — rank i owns chunk i — and the final compressed wire,
    ``None`` unless ``want_wire``).  The row partition comes from
    :func:`_ring_schedule`."""
    n, m = xb.shape[0], xb.shape[1]

    def part(lo, hi, d, whole):
        p = xb if whole else xb[:, lo:hi]
        return _ring_rs_dir(p.__getitem__, n, axis, codec, d, want_wire)
    accs, wires = _ring_parts(m, n, codec, part)
    if len(accs) == 1:
        return accs[0], wires[0]
    acc = torch.cat(accs, dim=0)
    wire = None if not want_wire else {
        k: None if wires[0][k] is None else
        torch.cat([w[k] for w in wires], dim=0) for k in wires[0]}
    return acc, wire


def _ring_reduce_scatter_view(x, axis: Axis, axis_dim: int, codec):
    """The ring reduce-scatter of x along ``axis_dim`` on the codec's
    shard-view forms: every chunk is read in place and this rank's sum is
    written in x's type to a fresh chunk-shaped tensor, with the wires,
    ring schedule and ledger of ``_split_for_scatter`` + the block ring +
    ``ops.from_blocks``, and no f32 copy of the payload or the sum."""
    n = axis.size
    out = torch.empty(_chunk_shape(x, axis_dim, n), dtype=x.dtype,
                      device=x.device)
    x = x.contiguous()

    def part(lo, hi, d, whole):
        return _ring_rs_dir(
            lambda k: ops.shard_view(x, axis_dim, n, k, lo, hi), n, axis,
            codec, d, want_wire=False, out=out)
    _ring_parts(ops.padded_rows(out.numel()), n, codec, part)
    return out


# --------------------------------------------------------------------------
# primitive implementations (no autodiff)
# --------------------------------------------------------------------------

def _psum_impl(x, axis: Axis, codec):
    if codec.is_identity:
        _log("all_reduce", "-", codec, 2 * _payload_nbytes(x), 1)
        return _all_reduce_raw(x, axis)
    n = axis.size
    if n == 1:
        return x
    xb = _chunked_blocks(x.reshape(-1), n)
    acc, wire = _ring_reduce_scatter(xb, axis, codec)
    del acc, xb  # the all-reduce gathers the final compressed chunk instead
    gathered = _all_gather_wire(wire, axis)
    _log("ar_allgather", "-", codec, ops.wire_nbytes(wire), n - 1)
    full = codec.decode_blocks(gathered)            # [n, M, BLOCK]
    return full.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def _reduce_scatter_impl(x, axis: Axis, axis_dim: int, codec):
    n = axis.size
    if n == 1:
        return x
    if codec.is_identity:
        _log("reduce_scatter", "-", codec, _payload_nbytes(x), 1)
        return _psum_scatter_raw(x, axis, axis_dim)
    if codec.view_forms(x):
        return _ring_reduce_scatter_view(x, axis, axis_dim, codec)
    xb, chunk_shape = _split_for_scatter(x, axis_dim, n)
    acc, _ = _ring_reduce_scatter(xb, axis, codec, want_wire=False)
    return ops.from_blocks(acc, chunk_shape, x.dtype)


def _all_gather_impl(x, axis: Axis, axis_dim: int, codec):
    n = axis.size
    if n == 1:
        return x
    if codec.is_identity:
        _log("all_gather", "-", codec, _payload_nbytes(x), n - 1)
        return torch.movedim(_all_gather_raw(x, axis), 0, axis_dim).reshape(
            ops.gathered_shape(x.shape, n, axis_dim))
    wire, _ = codec.encode(x)
    _log("all_gather", "-", codec, ops.wire_nbytes(wire), n - 1)
    # each shard's tile padding is stripped before the shards are joined
    return codec.decode_gathered(_all_gather_wire(wire, axis), x.shape,
                                 x.dtype, axis_dim)


def _ppermute_impl(x, axis: Axis, perm, codec):
    """Point-to-point permutation of ``x`` (ranks that receive nothing get
    zeros), its wire encoded under ``codec``."""
    if codec.is_identity:
        _log("ppermute", "-", codec, _payload_nbytes(x), 1)
        return _exchange(x.contiguous(), axis, perm)
    wire, _ = codec.encode(x)
    _log("ppermute", "-", codec, ops.wire_nbytes(wire), 1)
    buf, layout = _pack(wire)
    return codec.decode(_unpack(_exchange(buf, axis, perm), layout),
                        x.shape, x.dtype)


def _all_to_all_impl(x, axis: Axis, split_axis: int, concat_axis: int,
                     codec):
    """Tiled all-to-all: slice ``j`` of ``x`` along ``split_axis`` goes to
    axis index ``j``; the received slices join along ``concat_axis`` in
    source order.  A compressed codec encodes the ``n`` slices in block
    form, exchanges the wire planes and decodes them."""
    n = axis.size
    if n == 1:
        return x
    chunk_shape = _chunk_shape(x, split_axis, n)
    if codec.is_identity:
        _log("all_to_all", "-", codec,
             _payload_nbytes(x) * (n - 1) // n, 1)
        xs = x.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
        parts = _all_to_all_raw(xs, axis)
    else:
        xb, _ = _split_for_scatter(x, split_axis, n)          # [n, M, BLOCK]
        wire = codec.encode_blocks(xb)
        del xb
        _log("all_to_all", "-", codec,
             ops.wire_nbytes(wire) * (n - 1) // n, 1)
        blocks = codec.decode_blocks(_all_to_all_wire(wire, axis))
        # each slice's tile padding is stripped before the slices join
        parts = blocks.reshape(n, -1)[:, :x.numel() // n].reshape(
            (n,) + chunk_shape).to(x.dtype)
    shape = list(chunk_shape)
    shape[concat_axis] *= n
    return torch.movedim(parts, 0, concat_axis).reshape(shape)


# --------------------------------------------------------------------------
# autodiff-aware pairs (the reference's custom_vjp pairs)
# --------------------------------------------------------------------------

def _opts():
    """The bindings a backward must re-establish on autograd's thread."""
    return _rec.wire_tag, _rec.bidir, _rec.chunks, _rec.level


class _PsumFn(torch.autograd.Function):
    """All-reduce forward, all-reduce of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, axis, c_fwd, c_bwd):
        ctx.saved = (axis, c_bwd, _opts())
        return _psum_impl(x, axis, c_fwd)

    @staticmethod
    def backward(ctx, g):
        axis, c_bwd, opts = ctx.saved
        with _bind(*opts):
            return _psum_impl(g, axis, c_bwd), None, None, None


class _AgFn(torch.autograd.Function):
    """All-gather forward, reduce-scatter of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, axis, axis_dim, c_fwd, c_bwd):
        ctx.saved = (axis, axis_dim, c_bwd, _opts())
        return _all_gather_impl(x, axis, axis_dim, c_fwd)

    @staticmethod
    def backward(ctx, g):
        axis, axis_dim, c_bwd, opts = ctx.saved
        with _bind(*opts):
            return (_reduce_scatter_impl(g, axis, axis_dim, c_bwd),
                    None, None, None, None)


class _RsFn(torch.autograd.Function):
    """Reduce-scatter forward, all-gather of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, axis, axis_dim, c_fwd, c_bwd):
        ctx.saved = (axis, axis_dim, c_bwd, _opts())
        return _reduce_scatter_impl(x, axis, axis_dim, c_fwd)

    @staticmethod
    def backward(ctx, g):
        axis, axis_dim, c_bwd, opts = ctx.saved
        with _bind(*opts):
            return (_all_gather_impl(g, axis, axis_dim, c_bwd),
                    None, None, None, None)


class _GFn(torch.autograd.Function):
    """Megatron 'g': identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, axis, c_bwd):
        ctx.saved = (axis, c_bwd, _opts())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, c_bwd, opts = ctx.saved
        with _bind(*opts):
            return _psum_impl(g, axis, c_bwd), None, None


class _FFn(torch.autograd.Function):
    """Megatron 'f': all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis, c_fwd):
        return _psum_impl(x, axis, c_fwd)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PpermuteFn(torch.autograd.Function):
    """Permutation forward, the inverse permutation of the cotangent
    backward (each rank gets the gradient of what it sent; a rank that
    sent nothing gets zeros)."""

    @staticmethod
    def forward(ctx, x, axis, perm, c_fwd, c_bwd):
        ctx.saved = (axis, tuple((d, s) for s, d in perm), c_bwd, _opts())
        return _ppermute_impl(x, axis, perm, c_fwd)

    @staticmethod
    def backward(ctx, g):
        axis, inv, c_bwd, opts = ctx.saved
        with _bind(*opts):
            return (_ppermute_impl(g.contiguous(), axis, inv, c_bwd), None,
                    None, None, None)


class _A2aFn(torch.autograd.Function):
    """All-to-all forward, the transpose all-to-all (split and concat
    swapped) of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis, c_fwd, c_bwd):
        ctx.saved = (axis, split_axis, concat_axis, c_bwd, _opts())
        return _all_to_all_impl(x, axis, split_axis, concat_axis, c_fwd)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis, c_bwd, opts = ctx.saved
        with _bind(*opts):
            return (_all_to_all_impl(g.contiguous(), axis, concat_axis,
                                     split_axis, c_bwd),
                    None, None, None, None, None)


# --------------------------------------------------------------------------
# public, site-resolving entry points
#
# ``axis`` is a flat :class:`Axis`, or an :class:`AxisPair`, which routes
# through the two-level hierarchical decomposition with per-level codecs
# (the hier_* family below).
# --------------------------------------------------------------------------

def psum(x, axis, tag):
    """All-reduce-sum over ``axis`` under the active plan's codec for
    ``tag`` (backward: all-reduce under the bwd codec).  A pair routes to
    :func:`hier_all_reduce`.  A stateful codec routes through the
    carried-state sum (no backward), valid only inside a
    ``codec_state_io`` region, never under autodiff; a site registered in
    the active :class:`tune_io` region dispatches on its rung instead."""
    s = policy.as_site(tag)
    if _is_pair(axis):
        return hier_all_reduce(x, axis, s)
    c_fwd, c_bwd = _codec_pair(s, _payload_nbytes(x))
    if _tuned_site(s) is not None and axis.size > 1:
        with _wire_site(s):
            return _tuned_psum(x, axis, s, c_fwd)
    if c_fwd.stateful or c_bwd.stateful:
        if s.dim in policy.DIRECTED_DIMS and not _stateful_ok():
            _require_stateless(s, c_fwd, c_bwd)  # raises: autodiff traffic
        with _wire_site(s):
            return _stateful_psum(x, axis, s, c_fwd)
    _account("all_reduce", s.ledger_tag, x, axis, c_fwd, c_bwd,
             bwd_op="all_reduce", level=s.level or "flat")
    with _wire_site(s):
        if axis.size == 1:
            return _psum_impl(x, axis, c_fwd)
        return _PsumFn.apply(x, axis, c_fwd, c_bwd)


def all_gather(x, axis, axis_dim: int, tag):
    """All-gather dim ``axis_dim`` over ``axis`` (backward: reduce-scatter
    under the bwd codec).  A pair routes to :func:`hier_all_gather`."""
    s = policy.as_site(tag)
    if _is_pair(axis):
        return hier_all_gather(x, axis, axis_dim, s)
    c_fwd, c_bwd = _codec_pair(s, _payload_nbytes(x))
    _require_stateless(s, c_fwd, c_bwd)
    _account("all_gather", s.ledger_tag, x, axis, c_fwd, c_bwd,
             bwd_op="reduce_scatter", level=s.level or "flat")
    if axis.size == 1:
        return x
    with _wire_site(s):
        return _AgFn.apply(x, axis, axis_dim, c_fwd, c_bwd)


def reduce_scatter(x, axis, axis_dim: int, tag):
    """Sum-reduce-scatter dim ``axis_dim`` over ``axis`` (backward:
    all-gather under the bwd codec).  A pair routes to
    :func:`hier_reduce_scatter`."""
    s = policy.as_site(tag)
    if _is_pair(axis):
        return hier_reduce_scatter(x, axis, axis_dim, s)
    c_fwd, c_bwd = _codec_pair(s, _payload_nbytes(x))
    _require_stateless(s, c_fwd, c_bwd)
    _account("reduce_scatter", s.ledger_tag, x, axis, c_fwd, c_bwd,
             bwd_op="all_gather", level=s.level or "flat")
    if axis.size == 1:
        return x
    with _wire_site(s):
        return _RsFn.apply(x, axis, axis_dim, c_fwd, c_bwd)


def copy_fwd_psum_bwd(x, axis, tag):
    """Megatron 'g': identity forward, (compressed) all-reduce backward; on
    a pair a two-level all-reduce under the ``<tag>_bwd_inner`` /
    ``<tag>_bwd_outer`` codecs."""
    s = policy.as_site(tag)
    nbytes = _payload_nbytes(x)
    if _is_pair(axis):
        chunk = -(-x.numel() // axis.inner.size)
        (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(
            s, nbytes, chunk * x.element_size())
        _account_hier(
            [("none", axis.inner, "inner", x.numel(), "all_reduce"),
             ("none", axis.outer, "outer", chunk, "all_reduce")],
            s.ledger_tag, x, [(ci_f, ci_b), (co_f, co_b)],
            {"inner": nbytes, "outer": chunk * x.element_size()})
        if axis.size == 1:
            return x
        with _wire_site(s):
            return _HierGFn.apply(x, axis, (ci_b, co_b))
    _, c_bwd = _codec_pair(s, nbytes)
    _require_stateless(s, c_bwd)
    _account("none", s.ledger_tag, x, axis, c_bwd, c_bwd,
             bwd_op="all_reduce", level=s.level or "flat")
    if axis.size == 1:
        return x
    with _wire_site(s):
        return _GFn.apply(x, axis, c_bwd)


def psum_fwd_copy_bwd(x, axis, tag):
    """Megatron 'f': (compressed) all-reduce forward, identity backward; on
    a pair a two-level all-reduce under the ``<tag>_fwd_inner`` /
    ``<tag>_fwd_outer`` codecs."""
    s = policy.as_site(tag)
    nbytes = _payload_nbytes(x)
    if _is_pair(axis):
        chunk = -(-x.numel() // axis.inner.size)
        (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(
            s, nbytes, chunk * x.element_size())
        _account_hier(
            [("reduce_scatter", axis.inner, "inner", x.numel(), None),
             ("all_reduce", axis.outer, "outer", chunk, None),
             ("all_gather", axis.inner, "inner", chunk, None)],
            s.ledger_tag, x, [(ci_f, ci_b), (co_f, co_b), (ci_f, ci_b)],
            {"inner": nbytes, "outer": chunk * x.element_size()})
        with _wire_site(s):
            if axis.size == 1:
                return x
            return _HierFFn.apply(x, axis, (ci_f, co_f))
    c_fwd, _ = _codec_pair(s, nbytes)
    _require_stateless(s, c_fwd)
    _account("all_reduce", s.ledger_tag, x, axis, c_fwd, c_fwd,
             bwd_op=None, level=s.level or "flat")
    with _wire_site(s):
        if axis.size == 1:
            return _psum_impl(x, axis, c_fwd)
        return _FFn.apply(x, axis, c_fwd)


def ppermute(x, axis, perm, tag):
    """Point-to-point permutation over ``axis``: each ``(src, dst)`` pair of
    axis indices sends ``src``'s ``x`` to ``dst``; a rank that receives
    nothing gets zeros (backward: the inverse permutation under the bwd
    codec).  A partial permutation is pro-rated in the ledger, as in the
    reference: only ``len(perm) / n`` of the ranks send.  On a pair,
    ``perm`` indexes the joint (outer-major) axis and routes to
    :func:`hier_ppermute`."""
    s = policy.as_site(tag)
    if _is_pair(axis):
        return hier_ppermute(x, axis, perm, s)
    nbytes = _payload_nbytes(x)
    c_fwd, c_bwd = _codec_pair(s, nbytes)
    _require_stateless(s, c_fwd, c_bwd)
    perm = tuple(perm)
    n = int(axis.size)
    _account("ppermute", s.ledger_tag, x, axis, c_fwd, c_bwd,
             bwd_op="ppermute", elems=x.numel() * len(perm) // n,
             level=s.level or "flat", nbytes=nbytes)
    with _wire_site(s):
        return _PpermuteFn.apply(x, axis, perm, c_fwd, c_bwd)


def all_to_all(x, axis, split_axis: int, concat_axis: int, tag):
    """All-to-all over ``axis`` (backward: the all-to-all with split and
    concat swapped, under the bwd codec).  A pair routes to
    :func:`hier_all_to_all`."""
    s = policy.as_site(tag)
    if _is_pair(axis):
        return hier_all_to_all(x, axis, split_axis, concat_axis, s)
    c_fwd, c_bwd = _codec_pair(s, _payload_nbytes(x))
    _require_stateless(s, c_fwd, c_bwd)
    _account("all_to_all", s.ledger_tag, x, axis, c_fwd, c_bwd,
             bwd_op="all_to_all", level=s.level or "flat")
    if axis.size == 1:
        return x
    with _wire_site(s):
        return _A2aFn.apply(x, axis, split_axis, concat_axis, c_fwd, c_bwd)


def stage_send(x, axis, tag="pp"):
    """Pipeline stage handoff: stage ``s`` sends ``x`` to stage ``s + 1``
    (no wraparound: the first stage receives zeros, the last sends
    nothing).  Under the scheme's ``pp_fwd`` codec; the backward returns
    the activation gradient upstream under ``pp_bwd``.  On a pair the
    handoffs inside a node ride ``pp_*_inner``, those that cross a node
    ``pp_*_outer`` (:func:`hier_ppermute`)."""
    n = int(axis.size)
    if n == 1:
        return torch.zeros_like(x)
    return ppermute(x, axis, [(s, s + 1) for s in range(n - 1)], tag)


def stage_ring_send(x, axis, tag="pp"):
    """Wraparound stage handoff of the interleaved (vpp > 1) schedule:
    stage ``s`` sends ``x`` to stage ``(s + 1) % pp``, since the chunk after
    the last rank's slice ``v`` is the first rank's slice ``v + 1``.  Same
    codecs as :func:`stage_send`."""
    n = int(axis.size)
    if n == 1:
        return x
    return ppermute(x, axis, [(s, (s + 1) % n) for s in range(n)], tag)


def stage_recv(x, axis, tag="pp"):
    """Reverse stage shift: stage ``s`` sends ``x`` to stage ``s - 1`` (the
    backward-edge twin of :func:`stage_send`; its own backward is the
    forward shift)."""
    n = int(axis.size)
    if n == 1:
        return torch.zeros_like(x)
    return ppermute(x, axis, [(s + 1, s) for s in range(n - 1)], tag)


def pool_handoff(x, axis, tag="kv@prefill_handoff", src: int = 0,
                 dst: int = 1):
    """Serving prefill -> decode pool handoff: pool rank ``src`` sends ``x``
    to pool rank ``dst``.  A one-edge :func:`ppermute` (the pool rank that
    receives nothing gets zeros: the prefill pool drops its KV), so the
    KV transfer rides the compression path and the ledger under the
    serving ``kv`` dimension, its event pro-rated by the ``1/n`` edge
    fraction; ``roofline.kv_handoff_seconds`` prices these events.  On an
    axis of one rank (or none) it returns ``x``."""
    if axis is None or int(axis.size) == 1:
        return x
    return ppermute(x, axis, [(src, dst)], tag)


# --------------------------------------------------------------------------
# hierarchical two-level collectives (ZeRO++-style, arXiv:2306.10209; the
# reference's hier_* family)
#
#   all-reduce      = RS(inner, mild) -> AR(outer, aggressive) -> AG(inner)
#   reduce-scatter  = RS(inner, mild) -> RS(outer, aggressive)
#   all-gather      = AG(outer, aggressive) -> AG(inner, mild)
#
# The outer stage moves only a 1/n_inner chunk over the slow links.  Chunks
# are assigned outer-major, so with identity codecs each op equals the
# flat collective over the joint axis.
# --------------------------------------------------------------------------

def _hier_codec_pairs(tag, nbytes_inner: int | None = None,
                      nbytes_outer: int | None = None,
                      allow_stateful: bool = False):
    """``((inner_fwd, inner_bwd), (outer_fwd, outer_bwd))`` for ``tag``,
    from the active plan; ``nbytes_*`` are each stage's payload (the outer
    stage moves a 1/n_inner chunk).  ``allow_stateful`` (all-reduce only)
    admits carried-state codecs inside a ``codec_state_io`` region, whose
    slots are per level (``<dim>_inner@name``)."""
    s = policy.as_site(tag)
    pairs = policy.current_plan().hier_codec_pairs(s, nbytes_inner,
                                                   nbytes_outer)
    if not (allow_stateful and _stateful_ok()):
        _require_stateless(s, *pairs[0], *pairs[1])
    return pairs


def _account_hier(stages, tag, x, c_pairs, nbytes_by_level=None):
    """Ledger the per-stage events of one hierarchical op: ``stages`` is a
    list of ``(op, axis, level, elems, bwd_op)``, ``c_pairs`` each stage's
    ``(fwd, bwd)`` codecs, ``nbytes_by_level`` the payload each level's
    codec resolution saw."""
    nbl = nbytes_by_level or {}
    for (op, axis, level, elems, bwd_op), (cf, cb) in zip(stages, c_pairs):
        _account(op, tag, x, axis, cf, cb, bwd_op=bwd_op, level=level,
                 elems=elems, nbytes=nbl.get(level))


def _hier_psum_impl(x, pair: AxisPair, c_in, c_out):
    """RS(inner) -> AR(outer) -> AG(inner) on the flattened payload."""
    inner, outer = pair.inner, pair.outer
    n_i, n_o = inner.size, outer.size
    if n_i == 1 and n_o == 1:
        return x
    if n_i == 1:
        with _stage("outer"):
            return _psum_impl(x, outer, c_out)
    total = x.numel()
    xb = _chunked_blocks(x.reshape(-1), n_i)            # [n_i, M, BLOCK] f32
    # stage 1: intra-node reduce-scatter, rank i owns sum-chunk i.  With
    # one node the ring's final fused re-encode is the stage-3 wire;
    # otherwise stage 2 changes the chunk and the re-encode would be dead
    wire = None
    with _stage("inner"):
        if c_in.is_identity:
            chunk = _psum_scatter_raw(xb, inner, 0)[0]
        else:
            chunk, wire = _ring_reduce_scatter(xb, inner, c_in,
                                               want_wire=n_o == 1)
    del xb
    # stage 2: inter-node all-reduce of the 1/n_i chunk
    if n_o > 1:
        with _stage("outer"):
            chunk = _psum_impl(chunk, outer, c_out)
        wire = None
    # stage 3: intra-node all-gather of the fully reduced chunks
    with _stage("inner"):
        if c_in.is_identity:
            full = _all_gather_raw(chunk, inner)
        else:
            if wire is None:
                wire = c_in.encode_blocks(chunk)
            _log("ar_allgather", "-", c_in, ops.wire_nbytes(wire), n_i - 1)
            full = c_in.decode_blocks(_all_gather_wire(wire, inner))
    return full.reshape(-1)[:total].reshape(x.shape).to(x.dtype)


def _hier_reduce_scatter_impl(x, pair: AxisPair, axis_dim: int, c_in,
                              c_out):
    """Scatter dim ``axis_dim`` over the joint axis, outer-major chunks: the
    payload viewed as ``(pre, n_o, n_i, s / n, post)`` is scattered over
    the inner axis along ``axis_dim + 1``, then over the outer axis along
    ``axis_dim``."""
    n_i, n_o = pair.inner.size, pair.outer.size
    n = n_i * n_o
    if n == 1:
        return x
    s = x.shape[axis_dim]
    if s % n:
        raise ValueError(f"dim {axis_dim} of size {s} not divisible by {n}")
    pre, post = tuple(x.shape[:axis_dim]), tuple(x.shape[axis_dim + 1:])
    xr = x.reshape(pre + (n_o, n_i, s // n) + post)
    with _stage("inner"):
        y = _reduce_scatter_impl(xr, pair.inner, axis_dim + 1, c_in)
    del xr
    with _stage("outer"):
        z = _reduce_scatter_impl(y, pair.outer, axis_dim, c_out)
    return z.reshape(pre + (s // n,) + post)


def _hier_all_gather_impl(x, pair: AxisPair, axis_dim: int, c_in, c_out):
    """The transpose of :func:`_hier_reduce_scatter_impl`: gather over the
    outer axis along ``axis_dim``, then over the inner axis along
    ``axis_dim + 1`` of ``(pre, n_o, 1, s, post)``."""
    n_i, n_o = pair.inner.size, pair.outer.size
    if n_i * n_o == 1:
        return x
    s = x.shape[axis_dim]
    pre, post = tuple(x.shape[:axis_dim]), tuple(x.shape[axis_dim + 1:])
    with _stage("outer"):
        y = _all_gather_impl(x, pair.outer, axis_dim, c_out)
    yr = y.reshape(pre + (n_o, 1, s) + post)
    with _stage("inner"):
        z = _all_gather_impl(yr, pair.inner, axis_dim + 1, c_in)
    return z.reshape(pre + (n_o * n_i * s,) + post)


def _hier_ppermute_impl(x, pair: AxisPair, perm, c_in, c_out):
    """Edge-classified permutation over the joint axis: edges inside a node
    ride ``c_in``, edges that cross a node ``c_out``.  A rank receives
    along at most one edge, so the two classes merge by a per-rank
    choice."""
    n_i, n_o = pair.inner.size, pair.outer.size
    if n_i * n_o == 1:
        return x
    if n_o == 1:
        with _stage("inner"):
            return _ppermute_impl(x, pair.inner, perm, c_in)
    if n_i == 1:
        with _stage("outer"):
            return _ppermute_impl(x, pair.outer, perm, c_out)
    intra = tuple((s, d) for s, d in perm if s // n_i == d // n_i)
    inter = tuple((s, d) for s, d in perm if s // n_i != d // n_i)
    if not inter:
        with _stage("inner"):
            return _ppermute_impl(x, pair.joint, intra, c_in)
    if not intra:
        with _stage("outer"):
            return _ppermute_impl(x, pair.joint, inter, c_out)
    with _stage("inner"):
        y_in = _ppermute_impl(x, pair.joint, intra, c_in)
    with _stage("outer"):
        y_out = _ppermute_impl(x, pair.joint, inter, c_out)
    return y_in if any(d == pair.index for _, d in intra) else y_out


def _hier_all_to_all_impl(x, pair: AxisPair, split_axis: int,
                          concat_axis: int, c_in, c_out):
    """Two-stage decomposition of the joint tiled all-to-all: the chunk
    index along ``split_axis`` splits outer-major into ``(co, ci)``; the
    inner stage exchanges ``ci`` inside a node, the outer stage ``co``
    across nodes, and the result holds the chunks in joint source order,
    as the flat all-to-all over the joint axis does."""
    n_i, n_o = pair.inner.size, pair.outer.size
    n = n_i * n_o
    if n == 1:
        return x
    if n_o == 1:
        with _stage("inner"):
            return _all_to_all_impl(x, pair.inner, split_axis, concat_axis,
                                    c_in)
    if n_i == 1:
        with _stage("outer"):
            return _all_to_all_impl(x, pair.outer, split_axis, concat_axis,
                                    c_out)
    sa, s = split_axis, x.shape[split_axis]
    if s % n:
        raise ValueError(f"dim {sa} of size {s} not divisible by {n}")
    pre, post = tuple(x.shape[:sa]), tuple(x.shape[sa + 1:])
    xr = x.reshape(pre + (n_o, n_i, s // n) + post)
    with _stage("inner"):
        y = _all_to_all_impl(xr, pair.inner, sa + 1, sa + 1, c_in)
    with _stage("outer"):
        z = _all_to_all_impl(y, pair.outer, sa, sa, c_out)
    z = z.reshape(pre + (n, s // n) + post)            # joint source order
    if concat_axis == split_axis:
        return z.reshape(pre + (s,) + post)
    shape = list(pre + (s // n,) + post)
    shape[concat_axis] *= n
    return torch.movedim(torch.movedim(z, sa, 0), 0, concat_axis).reshape(
        shape)


class _HierA2aFn(torch.autograd.Function):
    """Two-stage all-to-all forward, the transpose two-stage all-to-all
    under the ``_bwd`` codecs backward."""

    @staticmethod
    def forward(ctx, x, pair, split_axis, concat_axis, cs_in, cs_out):
        ctx.saved = (pair, split_axis, concat_axis, cs_in, cs_out, _opts())
        return _hier_all_to_all_impl(x, pair, split_axis, concat_axis,
                                     cs_in[0], cs_out[0])

    @staticmethod
    def backward(ctx, g):
        pair, split_axis, concat_axis, cs_in, cs_out, opts = ctx.saved
        with _bind(*opts):
            return (_hier_all_to_all_impl(g.contiguous(), pair, concat_axis,
                                          split_axis, cs_in[1], cs_out[1]),
                    None, None, None, None, None)


class _HierPsumFn(torch.autograd.Function):
    """Two-level all-reduce forward, the same decomposition of the
    cotangent under the ``_bwd`` codecs backward."""

    @staticmethod
    def forward(ctx, x, pair, cs_in, cs_out):
        ctx.saved = (pair, cs_in, cs_out, _opts())
        return _hier_psum_impl(x, pair, cs_in[0], cs_out[0])

    @staticmethod
    def backward(ctx, g):
        pair, cs_in, cs_out, opts = ctx.saved
        with _bind(*opts):
            return (_hier_psum_impl(g, pair, cs_in[1], cs_out[1]), None,
                    None, None)


class _HierRsFn(torch.autograd.Function):
    """Two-level reduce-scatter forward, two-level all-gather backward."""

    @staticmethod
    def forward(ctx, x, pair, axis_dim, cs_in, cs_out):
        ctx.saved = (pair, axis_dim, cs_in, cs_out, _opts())
        return _hier_reduce_scatter_impl(x, pair, axis_dim, cs_in[0],
                                         cs_out[0])

    @staticmethod
    def backward(ctx, g):
        pair, axis_dim, cs_in, cs_out, opts = ctx.saved
        with _bind(*opts):
            return (_hier_all_gather_impl(g.contiguous(), pair, axis_dim,
                                          cs_in[1], cs_out[1]),
                    None, None, None, None)


class _HierAgFn(torch.autograd.Function):
    """Two-level all-gather forward, two-level reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, pair, axis_dim, cs_in, cs_out):
        ctx.saved = (pair, axis_dim, cs_in, cs_out, _opts())
        return _hier_all_gather_impl(x, pair, axis_dim, cs_in[0], cs_out[0])

    @staticmethod
    def backward(ctx, g):
        pair, axis_dim, cs_in, cs_out, opts = ctx.saved
        with _bind(*opts):
            return (_hier_reduce_scatter_impl(g.contiguous(), pair, axis_dim,
                                              cs_in[1], cs_out[1]),
                    None, None, None, None)


class _HierPpermuteFn(torch.autograd.Function):
    """Edge-classified permutation forward, the inverse permutation under
    the ``_bwd`` codecs backward (inversion keeps an edge's class)."""

    @staticmethod
    def forward(ctx, x, pair, perm, cs_in, cs_out):
        ctx.saved = (pair, tuple((d, s) for s, d in perm), cs_in, cs_out,
                     _opts())
        return _hier_ppermute_impl(x, pair, perm, cs_in[0], cs_out[0])

    @staticmethod
    def backward(ctx, g):
        pair, inv, cs_in, cs_out, opts = ctx.saved
        with _bind(*opts):
            return (_hier_ppermute_impl(g.contiguous(), pair, inv, cs_in[1],
                                        cs_out[1]), None, None, None, None)


class _HierGFn(torch.autograd.Function):
    """Hierarchical Megatron 'g': identity forward, two-level all-reduce
    backward."""

    @staticmethod
    def forward(ctx, x, pair, c_bwds):
        ctx.saved = (pair, c_bwds, _opts())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        pair, c_bwds, opts = ctx.saved
        with _bind(*opts):
            return _hier_psum_impl(g, pair, *c_bwds), None, None


class _HierFFn(torch.autograd.Function):
    """Hierarchical Megatron 'f': two-level all-reduce forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, pair, c_fwds):
        return _hier_psum_impl(x, pair, *c_fwds)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def hier_all_reduce(x, pair: AxisPair, tag):
    """Two-level all-reduce-sum over ``pair``: ``RS(inner)`` of the
    flattened payload under the ``<tag>_inner`` codec (directed tags:
    ``<tag>_fwd_inner``), ``AR(outer)`` of the ``1/n_inner`` chunk under
    ``<tag>_outer``, ``AG(inner)`` of the reduced chunks.  Backward: the
    same decomposition of the cotangent under the ``_bwd`` codecs.  Inside
    a ``codec_state_io`` region a carried-state codec at either level
    routes to :func:`_stateful_hier_psum`.  Ledger: an inner RS, an outer
    AR and an inner AG event."""
    s = policy.as_site(tag)
    n_i = pair.inner.size
    chunk = -(-x.numel() // n_i)
    nbytes = _payload_nbytes(x)
    (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(
        s, nbytes, chunk * x.element_size(), allow_stateful=True)
    if any(c.stateful for c in (ci_f, ci_b, co_f, co_b)):
        # optimizer-side (inside codec_state_io, or _hier_codec_pairs
        # raised): per-level carried state, no backward
        return _stateful_hier_psum(x, pair, s, ci_f, co_f)
    _account_hier(
        [("reduce_scatter", pair.inner, "inner", x.numel(), "all_gather"),
         ("all_reduce", pair.outer, "outer", chunk, "all_reduce"),
         ("all_gather", pair.inner, "inner", chunk, "reduce_scatter")],
        s.ledger_tag, x, [(ci_f, ci_b), (co_f, co_b), (ci_f, ci_b)],
        {"inner": nbytes, "outer": chunk * x.element_size()})
    with _wire_site(s):
        if pair.size == 1:
            return x
        return _HierPsumFn.apply(x, pair, (ci_f, ci_b), (co_f, co_b))


hier_psum = hier_all_reduce     # the ZeRO++ name, as in the reference


def hier_reduce_scatter(x, pair: AxisPair, axis_dim: int, tag):
    """Two-level reduce-scatter of dim ``axis_dim`` (outer-major chunks):
    ``RS(inner)`` of the whole payload under ``<tag>_inner``, then
    ``RS(outer)`` of the surviving ``1/n_inner`` under ``<tag>_outer``.
    Backward: :func:`hier_all_gather` under the ``_bwd`` codecs."""
    s = policy.as_site(tag)
    n_i = pair.inner.size
    nbytes = _payload_nbytes(x)
    part = x.numel() // n_i
    (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(
        s, nbytes, part * x.element_size())
    _account_hier(
        [("reduce_scatter", pair.inner, "inner", x.numel(), "all_gather"),
         ("reduce_scatter", pair.outer, "outer", part, "all_gather")],
        s.ledger_tag, x, [(ci_f, ci_b), (co_f, co_b)],
        {"inner": nbytes, "outer": part * x.element_size()})
    if pair.size == 1:
        return x
    with _wire_site(s):
        return _HierRsFn.apply(x, pair, axis_dim, (ci_f, ci_b),
                               (co_f, co_b))


def hier_all_gather(x, pair: AxisPair, axis_dim: int, tag):
    """Two-level all-gather of dim ``axis_dim``: ``AG(outer)`` of the local
    shard under ``<tag>_outer``, then ``AG(inner)`` of the node-gathered
    block under ``<tag>_inner``.  Backward: :func:`hier_reduce_scatter`
    under the ``_bwd`` codecs."""
    s = policy.as_site(tag)
    n_o = pair.outer.size
    nbytes = _payload_nbytes(x)
    (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(s, nbytes * n_o, nbytes)
    _account_hier(
        [("all_gather", pair.outer, "outer", x.numel(), "reduce_scatter"),
         ("all_gather", pair.inner, "inner", x.numel() * n_o,
          "reduce_scatter")],
        s.ledger_tag, x, [(co_f, co_b), (ci_f, ci_b)],
        {"inner": nbytes * n_o, "outer": nbytes})
    if pair.size == 1:
        return x
    with _wire_site(s):
        return _HierAgFn.apply(x, pair, axis_dim, (ci_f, ci_b), (co_f, co_b))


def hier_ppermute(x, pair: AxisPair, perm, tag):
    """Edge-classified permutation over ``pair``; ``perm`` indexes the joint
    (outer-major) axis, as a flat permutation over it would.  Edges inside
    a node ride ``<tag>_fwd_inner``, edges that cross a node
    ``<tag>_fwd_outer``; the backward is the inverse permutation under the
    ``_bwd`` codecs.  Ledger: an inner event scaled by the intra-node edge
    fraction and an outer event by the node-crossing one."""
    st = policy.as_site(tag)
    nbytes = _payload_nbytes(x)
    (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(st, nbytes, nbytes)
    n_i, n = pair.inner.size, pair.size
    perm = tuple((int(s), int(d)) for s, d in perm)
    k_in = sum(1 for s, d in perm if s // n_i == d // n_i)
    k_out = len(perm) - k_in
    _account_hier(
        [("ppermute", pair.inner, "inner", x.numel() * k_in // n,
          "ppermute"),
         ("ppermute", pair.outer, "outer", x.numel() * k_out // n,
          "ppermute")],
        st.ledger_tag, x, [(ci_f, ci_b), (co_f, co_b)],
        {"inner": nbytes, "outer": nbytes})
    with _wire_site(st):
        return _HierPpermuteFn.apply(x, pair, perm, (ci_f, ci_b),
                                     (co_f, co_b))


def hier_all_to_all(x, pair: AxisPair, split_axis: int, concat_axis: int,
                    tag):
    """Two-stage all-to-all over ``pair`` (DeepSpeed-TED style): the intra-
    node exchange under ``<tag>_fwd_inner``, then the inter-node one under
    ``<tag>_fwd_outer``; with identity codecs it equals the flat all-to-all
    over the joint axis.  Backward: the transpose all-to-all under the
    ``_bwd`` codecs.  Ledger: one inner and one outer event, each of the
    whole local payload."""
    s = policy.as_site(tag)
    nbytes = _payload_nbytes(x)
    (ci_f, ci_b), (co_f, co_b) = _hier_codec_pairs(s, nbytes, nbytes)
    _account_hier(
        [("all_to_all", pair.inner, "inner", x.numel(), "all_to_all"),
         ("all_to_all", pair.outer, "outer", x.numel(), "all_to_all")],
        s.ledger_tag, x, [(ci_f, ci_b), (co_f, co_b)],
        {"inner": nbytes, "outer": nbytes})
    if pair.size == 1:
        return x
    with _wire_site(s):
        return _HierA2aFn.apply(x, pair, split_axis, concat_axis,
                                (ci_f, ci_b), (co_f, co_b))


# --------------------------------------------------------------------------
# flat-vector paths for the optimizer (outside autodiff)
# --------------------------------------------------------------------------

def reduce_scatter_flat(flat: torch.Tensor, axis, tag="dp",
                        mean: bool = False,
                        donate: bool = False) -> torch.Tensor:
    """1-D sum-reduce-scatter: rank i returns padded chunk i (length
    ``padded_rows(ceil(len / n)) * BLOCK``).

    Stateful codecs: ``ef:*`` compensates with the stashed residual, rides
    the inner codec's ring on the compensated vector and stashes the new
    local error; ``plr*`` runs the two-factor low-rank all-reduce and
    reconstructs this rank's chunk only.  ``donate`` says the caller gives
    ``flat`` up: ``ef:*`` then compensates into it in place.  A site
    registered in the active :class:`tune_io` region dispatches on its
    rung instead.  A pair runs as its joint axis (the optimizer stages the
    node level itself)."""
    s = policy.as_site(tag)
    axis = _flat(axis)
    c, _ = _codec_pair(s, _payload_nbytes(flat))
    if _tuned_site(s) is not None and axis.size > 1:
        with _wire_site(s):
            return _tuned_reduce_scatter_flat(flat, axis, s, c, mean, donate)
    if c.stateful and axis.size > 1:
        with _wire_site(s):
            return _stateful_reduce_scatter_flat(flat, axis, s, c, mean,
                                                 donate)
    if c.stateful:          # trivial axis: nothing crosses the wire
        c = codecs.NONE
    _account("reduce_scatter", s.ledger_tag, flat, axis, c, c, bwd_op=None,
             level=s.level or "flat")
    with _wire_site(s):
        return _reduce_scatter_flat_impl(flat, axis, c, mean)


def _reduce_scatter_flat_impl(flat, axis: Axis, c, mean):
    n = axis.size
    if n == 1:
        # still tile-pad: the ZeRO-1 master chunk is sized
        # padded_rows(ceil(len / n)) * BLOCK even on a trivial axis
        m = ops.padded_rows(flat.shape[0])
        flat = torch.nn.functional.pad(flat, (0, m * BLOCK - flat.shape[0]))
        return flat / n if mean else flat
    xb = _chunked_blocks(flat, n)
    if c.is_identity:
        _log("reduce_scatter", "-", c, _payload_nbytes(flat), 1)
        chunk = _psum_scatter_raw(xb, axis, 0)[0]
    else:
        chunk, _ = _ring_reduce_scatter(xb, axis, c, want_wire=False)
    chunk = chunk.reshape(-1)
    return chunk / n if mean else chunk


def all_gather_flat(chunk: torch.Tensor, axis, total: int,
                    tag="zero") -> torch.Tensor:
    """Inverse of :func:`reduce_scatter_flat`: gather the padded chunks,
    trim to ``total``.

    ``ef:*`` codecs compensate the local chunk before encoding (error
    feedback on the lossy param broadcast); low-rank codecs ride sum
    collectives only and raise here."""
    s = policy.as_site(tag)
    axis = _flat(axis)
    c, _ = _codec_pair(s, _payload_nbytes(chunk))
    if c.stateful and axis.size > 1:
        if c.kind != "ef" or c.inner.stateful:
            raise NotImplementedError(
                f"codec {c.name!r} at gather site {s.ledger_tag!r}: "
                "low-rank codecs ride sum collectives only (ef:<bq*> "
                "works on gathers)")
        io, key, st = _state_slot(s, c)
        xc = c.compensate(chunk, st)
        _account("all_gather", s.ledger_tag, xc, axis, c, c, bwd_op=None,
                 level=s.level or "flat")
        # one encode serves both the wire and the residual (unlike the
        # ring paths, the gathered wire IS the local encode)
        wire = c.inner.encode_blocks(xc.reshape(-1, BLOCK))
        dec = c.inner.decode_blocks(wire).reshape(xc.shape)
        io.write(key, {"residual": torch.sub(xc, dec, out=st["residual"])})
        del dec
        _log("all_gather", s.ledger_tag, c, ops.wire_nbytes(wire),
             axis.size - 1)
        gathered = {k: None if v is None else v.reshape(-1, v.shape[-1])
                    for k, v in _all_gather_wire(wire, axis).items()}
        return c.inner.decode_blocks(gathered).reshape(-1)[:total]
    if c.stateful:
        c = codecs.NONE
    _account("all_gather", s.ledger_tag, chunk, axis, c, c, bwd_op=None,
             level=s.level or "flat")
    with _wire_site(s):
        return _all_gather_flat_impl(chunk, axis, total, c)


def _all_gather_flat_impl(chunk, axis: Axis, total, c):
    n = axis.size
    if n == 1:
        return chunk[:total]
    if c.is_identity:
        _log("all_gather", "-", c, _payload_nbytes(chunk), n - 1)
        full = _all_gather_raw(chunk, axis).reshape(-1)
    else:
        wire = c.encode_blocks(chunk.reshape(-1, BLOCK))
        _log("all_gather", "-", c, ops.wire_nbytes(wire), n - 1)
        gathered = {k: None if v is None else v.reshape(-1, v.shape[-1])
                    for k, v in _all_gather_wire(wire, axis).items()}
        full = c.decode_blocks(gathered).reshape(-1)
    return full[:total]


# --------------------------------------------------------------------------
# carried-state sum collectives (ef:* and plr*), optimizer-side, no autodiff
# --------------------------------------------------------------------------

def _lowrank_factors(flat, axis: Axis, state):
    """PowerSGD's two factor exchanges on the matrix view of ``flat``
    (arXiv:1905.13727).  Every rank holds the same warm factor ``Q``, and
    both updates come from all-reduced values, so every rank keeps the
    same factors:

        P   = allreduce_sum(M_i @ Q)        (a)  wire: m x r floats
        P^  = orth(P)                       local, identical on all ranks
        Q'  = allreduce_sum(M_i^T @ P^)     (b)  wire: n x r floats

    Returns ``(P^, M_i^T P^, Q')``; the sum's low-rank approximation is
    ``P^ @ Q'^T`` (c).  The factors are summed uncompressed
    (``raw_psum``), as the reference's ``lax.psum``."""
    mat = lowrank.to_mat(flat)
    p = raw_psum(lowrank.matmul(mat, state["q"]), axis)
    phat = lowrank.orthonormalize(p)
    q_loc = lowrank.matmul(mat.T, phat)
    del mat
    return phat, q_loc, raw_psum(q_loc, axis)


def _lowrank_psum_impl(x, axis: Axis, c, state, want_local: bool = False):
    """Two-factor low-rank all-reduce of ``x``: ``(sum, state')``, plus this
    rank's own transmitted reconstruction ``P^ @ (M_i^T P^)^T`` when
    ``want_local`` (the error-feedback wrapper's residual needs it)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    phat, q_loc, q_new = _lowrank_factors(flat, axis, state)
    out = lowrank.from_mat(lowrank.matmul(phat, q_new.T), n).reshape(x.shape)
    state2 = {"q": lowrank.orthonormalize(q_new)}
    if want_local:
        rec = lowrank.from_mat(lowrank.matmul(phat, q_loc.T), n)
        return out, state2, rec.reshape(x.shape)
    return out, state2


def _lowrank_rows(phat, q, lo: int, length: int, n: int) -> torch.Tensor:
    """Elements ``[lo, lo + length)`` of ``from_mat(P^ @ Q^T, n)`` padded
    with zeros past ``n``: the reconstruction (c) of those matrix rows
    only.  ``lo`` and ``length`` are multiples of the view's width."""
    ncols = q.shape[0]
    out = torch.empty(length, dtype=torch.float32, device=phat.device)
    r0 = lo // ncols
    r1 = max(r0, min(phat.shape[0], (lo + length) // ncols))
    done = (r1 - r0) * ncols          # rows past the view's are zero
    if done:
        lowrank.matmul(phat[r0:r1], q.T, out=out[:done].view(r1 - r0, ncols))
    out[min(max(n - lo, 0), done):].zero_()
    return out


def _stateful_psum(x, axis: Axis, s, c):
    """All-reduce under a carried-state codec (optimizer-side, no VJP)."""
    io, key, st = _state_slot(s, c)
    if axis.size == 1:
        return x        # nothing crosses the wire; the slot carries over
    # bwd_op matches what the stateless psum records at the same site, so
    # stateful-vs-stateless byte comparisons stay like for like
    if c.kind == "lowrank":
        _account("all_reduce", s.ledger_tag, x, axis, c, c,
                 bwd_op="all_reduce", level=s.level or "flat")
        out, st2 = _lowrank_psum_impl(x, axis, c, st)
        io.write(key, st2)
        return out.to(x.dtype)
    if c.kind != "ef":
        raise NotImplementedError(
            f"carried-state codec {c.name!r} (kind={c.kind!r}) has no "
            "sum-collective implementation in comms")
    xc = c.compensate(x, st)
    _account("all_reduce", s.ledger_tag, xc, axis, c, c,
             bwd_op="all_reduce", level=s.level or "flat")
    if c.inner.stateful:    # ef:plr* — PowerSGD with error feedback
        out, inner_st2, rec = _lowrank_psum_impl(xc, axis, c.inner,
                                                 st["inner"], want_local=True)
        io.write(key, {"residual": torch.sub(xc, rec, out=st["residual"]),
                       "inner": inner_st2})
    else:
        io.write(key, c.next_state(xc, out=st["residual"]))
        out = _psum_impl(xc, axis, c.inner)
    return out.to(x.dtype)


def _stateful_reduce_scatter_flat(flat, axis: Axis, s, c, mean: bool,
                                  donate: bool):
    """Reduce-scatter under a carried-state codec.  Memory, at gemma3-1b's
    per-rank gradient (2.15 GB): ``ef:*`` compensates into ``flat`` when
    donated and writes the new residual into the old one's buffer;
    ``plr*`` reconstructs only this rank's chunk (its matrix rows: a chunk
    is whole rows, since chunk lengths are multiples of 1024) instead of
    the whole sum."""
    io, key, st = _state_slot(s, c)
    n_ranks = axis.size
    total = flat.shape[0]
    chunk_len = ops.padded_rows(-(-total // n_ranks)) * BLOCK

    def take(phat, q_sum):
        chunk = _lowrank_rows(phat, q_sum, axis.index * chunk_len, chunk_len,
                              total)
        return chunk.div_(n_ranks) if mean else chunk

    if c.kind == "lowrank":
        # the low-rank op is inherently an all-reduce; RS = AR + local rows
        _account("all_reduce", s.ledger_tag, flat, axis, c, c, bwd_op=None,
                 level=s.level or "flat")
        phat, _, q_sum = _lowrank_factors(flat.to(torch.float32), axis, st)
        io.write(key, {"q": lowrank.orthonormalize(q_sum)})
        return take(phat, q_sum)
    if c.kind != "ef":
        raise NotImplementedError(
            f"carried-state codec {c.name!r} (kind={c.kind!r}) has no "
            "reduce-scatter implementation in comms")
    xc = c.compensate(flat, st, inplace=donate)
    if c.inner.stateful:    # ef:plr* — PowerSGD with error feedback
        _account("all_reduce", s.ledger_tag, xc, axis, c, c, bwd_op=None,
                 level=s.level or "flat")
        phat, q_loc, q_sum = _lowrank_factors(xc, axis, st["inner"])
        rec = lowrank.from_mat(lowrank.matmul(phat, q_loc.T), total)
        io.write(key, {"residual": torch.sub(xc, rec, out=st["residual"]),
                       "inner": {"q": lowrank.orthonormalize(q_sum)}})
        del rec
        return take(phat, q_sum)
    _account("reduce_scatter", s.ledger_tag, xc, axis, c, c, bwd_op=None,
             level=s.level or "flat")
    io.write(key, c.next_state(xc, out=st["residual"]))
    return _reduce_scatter_flat_impl(xc, axis, c.inner, mean)


def _stateful_hier_psum(x, pair: AxisPair, s, c_in, c_out):
    """Two-level all-reduce with per-level carried-state codecs, the
    optimizer-side twin of :func:`_hier_psum_impl` (no backward).  Each
    level's codec keeps its state in its own level-pinned slot
    (``<dim>_inner@name`` / ``<dim>_outer@name``; the trainer enumerates
    them).  The stage-3 gather rides the inner *transport* codec (an
    ``ef:*`` inner's wire codec): error feedback compensated stage 1, and
    compensating the reduced chunks again would count the residual twice.
    ``plr*`` at the inner level has no scatter/gather form and raises, as
    in the reference: low-rank codecs belong on the outer level."""
    inner, outer = pair.inner, pair.outer
    n_i, n_o = inner.size, outer.size
    total = x.numel()
    flat = x.reshape(-1)
    s_in = policy.Site(s.dim, name=s.name, direction=s.direction,
                       level="inner")
    s_out = policy.Site(s.dim, name=s.name, direction=s.direction,
                        level="outer")
    # stage 1: intra-node reduce-scatter under the inner codec
    if n_i == 1:
        m = ops.padded_rows(total)
        chunk = torch.nn.functional.pad(flat, (0, m * BLOCK - total))
    elif c_in.stateful:
        if c_in.kind == "lowrank" or (c_in.kind == "ef"
                                      and c_in.inner.stateful):
            raise NotImplementedError(
                f"codec {c_in.name!r} at the inner level of hier site "
                f"{s.ledger_tag!r}: low-rank codecs ride flat sum "
                "collectives only — route plr* to the outer level")
        with _wire_site(s_in):
            chunk = _stateful_reduce_scatter_flat(flat, inner, s_in, c_in,
                                                  False, False)
    else:
        _account("reduce_scatter", s_in.ledger_tag, flat, inner, c_in,
                 c_in, bwd_op=None, level="inner")
        with _wire_site(s_in):
            chunk = _reduce_scatter_flat_impl(flat, inner, c_in, False)
    # stage 2: inter-node all-reduce of the 1/n_i chunk
    if n_o > 1:
        if c_out.stateful:
            with _wire_site(s_out):
                chunk = _stateful_psum(chunk, outer, s_out, c_out)
        else:
            _account("all_reduce", s_out.ledger_tag, chunk, outer, c_out,
                     c_out, bwd_op=None, level="outer")
            with _wire_site(s_out):
                chunk = _psum_impl(chunk, outer, c_out)
    # stage 3: intra-node all-gather of the fully reduced chunks
    if n_i == 1:
        out = chunk[:total]
    else:
        c_t = c_in.inner if c_in.stateful else c_in
        _account("all_gather", s_in.ledger_tag, chunk, inner, c_t, c_t,
                 bwd_op=None, level="inner")
        with _wire_site(s_in):
            out = _all_gather_flat_impl(chunk, inner, total, c_t)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# runtime-tunable sites: a host index over the executable rungs of the codec
# ladder.  The self-tuning controller (repro_torch.tune) changes a site's
# codec by passing another rung index to the next step; every rung's state
# stays live in the site's union slot, so nothing is rebuilt.
# --------------------------------------------------------------------------

# rows of the 128-wide block view a probe or error-feedback roundtrip
# encodes at once (64 MB of f32): the full-width payload is never decoded
# whole
_ROUNDTRIP_ROWS = 1 << 17


def _block_chunks(v: torch.Tensor):
    """``(lo, x2d)`` over the zero-padded ``(padded_rows(len), BLOCK)``
    block view of the flat f32 ``v``, in row chunks: ``x2d`` holds elements
    ``[lo, lo + x2d.numel())`` (past ``len(v)``, zeros).  Whole-row chunks
    are views of ``v``; only the last, padded one is a copy."""
    n = v.shape[0]
    rows = ops.padded_rows(n)
    step = _ROUNDTRIP_ROWS
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        lo, hi = r0 * BLOCK, r1 * BLOCK
        if hi <= n:
            yield lo, v[lo:hi].view(r1 - r0, BLOCK)
        else:
            x2d = torch.zeros((r1 - r0) * BLOCK, dtype=torch.float32,
                              device=v.device)
            x2d[:n - lo] = v[lo:n]
            yield lo, x2d.view(r1 - r0, BLOCK)


def _sq_sum(v: torch.Tensor) -> torch.Tensor:
    """``sum(v * v)`` in f32, a row chunk at a time."""
    acc = torch.zeros((), dtype=torch.float32, device=v.device)
    for _, x2d in _block_chunks(v):
        acc = acc + torch.sum(x2d * x2d)
    return acc


def _probe_err(v: torch.Tensor, probe) -> torch.Tensor:
    """``||x - D(E(x))||^2`` of ``v``'s block view under ``probe``: the
    next rung's local roundtrip, a row chunk at a time (bq scales are per
    row, so each row's roundtrip is the whole view's)."""
    acc = torch.zeros((), dtype=torch.float32, device=v.device)
    for _, x2d in _block_chunks(v):
        d = probe.decode_blocks(probe.encode_blocks(x2d)).sub_(x2d)
        acc = acc + torch.sum(d * d)
    return acc


def _ef_residual(xc: torch.Tensor, codec, out: torch.Tensor) -> torch.Tensor:
    """Write ``xc - D(E(xc))`` (error feedback's new residual, the
    inner codec's local roundtrip error) into ``out``, a row chunk at a
    time; returns its squared norm."""
    n = xc.shape[0]
    acc = torch.zeros((), dtype=torch.float32, device=xc.device)
    for lo, x2d in _block_chunks(xc):
        r = torch.sub(x2d, codec.decode_blocks(codec.encode_blocks(x2d)))
        r = r.reshape(-1)[:n - lo]
        out[lo:lo + r.shape[0]] = r
        acc = acc + torch.sum(r * r)
    return acc


def _factor_psum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Uncompressed all-reduce of a low-rank factor (the reference's
    ``lax.psum``), logged as measured wire like an identity all-reduce."""
    _log("all_reduce", "-", codecs.NONE, 2 * _payload_nbytes(t), 1)
    return raw_psum(t, axis)


def _tuned_psum(x, axis: Axis, s, c_plan):
    return _tuned_collective(x, axis, s, c_plan, "ar")


def _tuned_reduce_scatter_flat(flat, axis: Axis, s, c_plan, mean: bool,
                               donate: bool = False):
    return _tuned_collective(flat, axis, s, c_plan, "rs", mean, donate)


def _tuned_collective(x, axis: Axis, s, c_plan, kind: str,
                      mean: bool = False, donate: bool = False):
    """Sum collective (``kind`` "rs": :func:`reduce_scatter_flat`, "ar":
    :func:`psum`) dispatched on the site's rung in the active
    :class:`tune_io` region.

    Branch order is :data:`repro_torch.tune.ladder.RUNGS` — ``(bq16, bq8,
    ef:bq4, plr2, plr4, plr8)``; the rung is a Python index into the six
    branch functions (the reference's ``lax.switch``).  Every branch
    returns ``(out, residual', q', sig)`` over the site's union codec
    state (an error-feedback residual AND a warm low-rank factor, in its
    ``codec_state_io`` slot): the residual is written by ``ef:bq4`` only,
    the factor by ``ef:bq4`` and ``plr*``, and the other branches pass
    them through.

    Signals (:mod:`repro_torch.tune.tracker` layout): every rung measures
    the payload energy and a squared compression error — its own realized
    error for ``ef``/``plr`` rungs, a local next-rung roundtrip probe for
    the ``bq`` rungs (bq16 probes bq8, bq8 probes bq4), so the
    controller's promote test reads the error the next rung would take.
    The ``ef:bq4`` and ``plr`` rungs also run one power iteration of the
    warm factor at its full width ``R = lowrank.rank_for(elems,
    PLR_MAX_RANK)``: ``lowrank.orthonormalize`` is column-sequential (its
    second projection too), so the leading ``r`` columns of that
    iteration are exactly the ``plr<r>`` iteration, and one probe prices
    every registered rank.

    Ledger: one analytic event at the plan's static codec ``c_plan`` (the
    startup codec) with the fact ``tunable=1``, the branch's own analytic
    events muted, as the reference records it.  The measured wire events
    are the bytes of the rung actually taken (the factor all-reduces
    included), so after a swap the priced and measured bytes part on
    purpose.

    Memory, at a full-width rank's 2 GB flat gradient: the probe and the
    error-feedback roundtrip run a row chunk at a time; ``ef:bq4``
    compensates into a donated ``x``; the ``rs`` form of a ``plr`` rung
    reconstructs this rank's rows only.  Against the reference only the
    summation order of the signal sums changes."""
    from repro_torch.tune import ladder as _ladder
    from repro_torch.tune import tracker as _tracker
    tio = _rec.tune_io
    key = s.ledger_tag
    cio = _rec.state_io
    if cio is None:
        raise RuntimeError(
            f"tunable site {key!r} called outside a codec_state_io region "
            "— tunable sites carry a union codec-state slot; wrap the "
            "optimizer sync in comms.codec_state_io(...)")
    st = cio.read(key)
    n = axis.size
    f32 = x.reshape(-1)
    if f32.dtype != torch.float32:
        f32, donate = f32.to(torch.float32), True
    total = f32.shape[0]
    payload_sq = _sq_sum(f32)
    q0 = st["q"]
    R = q0.shape[-1]
    chunk_len = ops.padded_rows(-(-total // n)) * BLOCK

    def power_iter(mat, q):
        p = lowrank.matmul(mat, q)
        if n > 1:
            p = _factor_psum(p, axis)
        phat = lowrank.orthonormalize(p)
        q_loc = lowrank.matmul(mat.T, phat)
        q_new = _factor_psum(q_loc, axis) if n > 1 else q_loc
        spec = torch.nn.functional.pad(torch.sum(p * p, dim=0),
                                       (0, _ladder.PLR_MAX_RANK - R))
        return phat, q_loc, q_new, spec

    def ride(v, c):
        if kind == "rs":
            return _reduce_scatter_flat_impl(v, axis, c, mean)
        return _psum_impl(v, axis, c)

    bq16, bq8, bq4 = codecs.get("bq16"), codecs.get("bq8"), codecs.get("bq4")

    def bq_rung(c, probe):
        def branch(v, residual, q):
            sig = _tracker.pack(1.0, payload_sq, _probe_err(v, probe))
            return ride(v, c), residual, q, sig
        return branch

    def ef4_rung(v, residual, q):
        # xc = v + residual, into v when donated; the new residual
        # replaces the old one, spent once xc is formed
        xc = v.add_(residual) if donate else v + residual
        err = _ef_residual(xc, bq4, residual)
        mat = lowrank.to_mat(xc)
        _, _, q_new, spec = power_iter(mat, q)
        del mat
        sig = _tracker.pack(1.0, payload_sq, err, spec)
        return ride(xc, bq4), residual, lowrank.orthonormalize(q_new), sig

    def plr_rung(r):
        r_eff = min(r, R)

        def branch(v, residual, q):
            mat = lowrank.to_mat(v)
            phat, q_loc, q_new, spec = power_iter(mat, q)
            ph = phat[:, :r_eff].contiguous()
            qn = q_new[:, :r_eff].contiguous()
            ql = q_loc[:, :r_eff].contiguous()
            # ||M_i - P^ (M_i^T P^)^T||^2: this rank's own transmitted
            # reconstruction's error, a row chunk at a time
            err = torch.zeros((), dtype=torch.float32, device=v.device)
            for r0 in range(0, mat.shape[0], _ROUNDTRIP_ROWS):
                r1 = min(r0 + _ROUNDTRIP_ROWS, mat.shape[0])
                d = lowrank.matmul(ph[r0:r1], ql.T).sub_(mat[r0:r1])
                err = err + torch.sum(d * d)
            del mat
            if kind == "rs":
                out = _lowrank_rows(ph, qn, axis.index * chunk_len,
                                    chunk_len, total)
                if mean:
                    out.div_(n)
            else:
                out = lowrank.from_mat(lowrank.matmul(ph, qn.T), total)
            sig = _tracker.pack(1.0, payload_sq, err, spec)
            return out, residual, lowrank.orthonormalize(q_new), sig
        return branch

    branches = [bq_rung(bq16, bq8), bq_rung(bq8, bq4), ef4_rung,
                plr_rung(2), plr_rung(4), plr_rung(8)]
    assert len(branches) == len(_ladder.RUNGS)
    op = "reduce_scatter" if kind == "rs" else "all_reduce"
    with scope_facts(tunable=1):
        _account(op, key, x, axis, c_plan, c_plan, bwd_op=None,
                 level=s.level or "flat")
    with mute_ledger():
        out, new_res, new_q, sig = branches[tio.select[key]](
            f32, st["residual"], q0)
    cio.write(key, {"residual": new_res, "q": new_q})
    tio.add_sig(key, sig)
    if kind == "ar":
        out = out.reshape(x.shape)
    return out.to(x.dtype)
