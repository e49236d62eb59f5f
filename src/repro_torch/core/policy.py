"""Rule-based compression policies compiled into per-mesh comm plans (port
of ``repro.core.policy``).

* :class:`TagQuery` — one collective at the time it is issued: ``dim``
  (dp/zero/tp/pp/ep/cp/kv), autodiff ``direction`` (fwd/bwd; ``None`` for
  the direction-free dims), hierarchy ``level``, the uncompressed payload
  size ``nbytes``, and an optional site ``name``.
* :class:`Rule` — a predicate over TagQuery fields plus the codec to use
  when it matches; unset fields match anything.
* :class:`CommPolicy` — an ordered rule list with a default codec,
  first-match-wins.  ``compile(mesh_info)`` binds the logical dims to the
  mesh's axes once and returns an immutable :class:`CommPlan` whose
  static ``(dim, direction, level)`` table the comms entry points read.

Every registered scheme (:mod:`repro_torch.core.schemes`) is sugar over
rules, exactly as in the reference, so both packages resolve every site of
every scheme to the same codec pair and the same ``table_hash``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import functools
import threading

from repro_torch.core import codecs

DIMS = ("dp", "zero", "tp", "pp", "ep", "cp", "kv")
DIRECTED_DIMS = ("tp", "pp", "ep", "cp")
DIRECTIONS = ("fwd", "bwd")
LEVELS = ("flat", "inner", "outer")


def _check(value, allowed, what):
    if value not in allowed:
        raise KeyError(f"unknown {what} {value!r}; have {list(allowed)}")


# --------------------------------------------------------------------------
# the structured tag: what one collective call site looks like to a rule
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TagQuery:
    """One collective, as seen by the rule matcher.

    ``nbytes`` is the UNCOMPRESSED local wire payload (elements x logical
    itemsize) — the quantity size-threshold rules reason about.  ``None``
    means unknown (registry introspection, docs generation); size rules
    never match an unknown size."""

    dim: str
    direction: str | None = None    # fwd/bwd; None for dp/zero
    level: str = "flat"
    nbytes: int | None = None
    name: str | None = None


@dataclasses.dataclass(frozen=True)
class Site:
    """A structured comm tag, passed by call sites to the comms entry
    points in place of the legacy tag string.

    ``direction``/``level`` pin the query instead of deriving it from the
    collective (the optimizer's explicit ``bwd`` gradient folds, the
    staged flat-vector sync's ``outer`` hop); ``name`` labels the site for
    per-tensor rules and the ledger (``tp@attn_out``)."""

    dim: str
    name: str | None = None
    direction: str | None = None
    level: str | None = None

    def __post_init__(self):
        _check(self.dim, DIMS, "comm dimension")
        if self.direction is not None:
            _check(self.direction, DIRECTIONS, "direction")
            if self.dim not in DIRECTED_DIMS:
                raise KeyError(f"dimension {self.dim!r} carries no "
                               f"direction (got {self.direction!r})")
        if self.level is not None:
            _check(self.level, ("inner", "outer"), "level")
            if self.dim in DIRECTED_DIMS and self.direction is None:
                raise KeyError(
                    f"level-pinned {self.dim!r} site needs a direction "
                    f"({self.dim}_fwd_{self.level} / _bwd_{self.level})")

    @property
    def ledger_tag(self) -> str:
        """The tag string ledger events carry — identical to the legacy
        string for unnamed sites, ``...@name`` for named ones."""
        t = self.dim
        if self.direction:
            t += f"_{self.direction}"
        if self.level:
            t += f"_{self.level}"
        if self.name:
            t += f"@{self.name}"
        return t


def site(dim: str, name: str | None = None, direction: str | None = None,
         level: str | None = None) -> Site:
    """Sugar for :class:`Site` (positional name — the common case)."""
    return Site(dim, name=name, direction=direction, level=level)


@functools.lru_cache(maxsize=512)
def _parse_tag(tag: str) -> Site:
    base, _, name = tag.partition("@")
    parts = base.split("_")
    dim = parts[0]
    _check(dim, DIMS, "comm tag dimension")
    direction = level = None
    for p in parts[1:]:
        if p in DIRECTIONS and direction is None and level is None:
            direction = p
        elif p in ("inner", "outer") and level is None:
            level = p
        else:
            raise KeyError(f"unknown comm tag {tag!r}")
    return Site(dim, name=name or None, direction=direction, level=level)


def as_site(tag) -> Site:
    """Legacy tag string (``"tp"``, ``"tp_bwd"``, ``"dp_outer"``,
    ``"ep@moe_dispatch"``) or :class:`Site` -> :class:`Site`."""
    if isinstance(tag, Site):
        return tag
    return _parse_tag(tag)


# --------------------------------------------------------------------------
# rules and policies
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rule:
    """codec + a conjunction of TagQuery predicates; unset fields match
    anything.

    * ``dim`` — one dimension or a tuple of dimensions;
    * ``direction`` / ``level`` — exact match;
    * ``min_bytes`` (inclusive) / ``max_bytes`` (exclusive) — payload
      size window; a query with unknown size never matches a size rule;
    * ``name`` — :mod:`fnmatch` glob over the site name; a nameless
      query never matches a name rule.

    Validated eagerly: an unknown codec, dimension, direction, or level
    raises at construction time."""

    codec: str
    dim: str | tuple | None = None
    direction: str | None = None
    level: str | None = None
    min_bytes: int | None = None
    max_bytes: int | None = None
    name: str | None = None

    def __post_init__(self):
        codecs.get(self.codec)          # eager: typo'd codec fails HERE
        if self.dim is not None:
            dims = (self.dim,) if isinstance(self.dim, str) else \
                tuple(self.dim)
            for d in dims:
                _check(d, DIMS, "rule dimension")
            object.__setattr__(self, "dim", dims)
        if self.direction is not None:
            _check(self.direction, DIRECTIONS, "rule direction")
        if self.level is not None:
            _check(self.level, LEVELS, "rule level")
        if self.min_bytes is not None and self.max_bytes is not None \
                and self.min_bytes >= self.max_bytes:
            raise ValueError(f"empty size window [{self.min_bytes}, "
                             f"{self.max_bytes})")
        if self.direction is not None and self.dim is not None \
                and not any(d in DIRECTED_DIMS for d in self.dim):
            raise KeyError(
                f"rule pins direction {self.direction!r} but its "
                f"dimension(s) {self.dim} carry no direction — the rule "
                f"could never match")

    @property
    def dynamic(self) -> bool:
        """True if matching needs trace-time payload facts (size/name)."""
        return (self.min_bytes is not None or self.max_bytes is not None
                or self.name is not None)

    def matches(self, q: TagQuery) -> bool:
        if self.dim is not None and q.dim not in self.dim:
            return False
        if self.direction is not None and q.direction != self.direction:
            return False
        if self.level is not None and q.level != self.level:
            return False
        if self.min_bytes is not None and (q.nbytes is None
                                           or q.nbytes < self.min_bytes):
            return False
        if self.max_bytes is not None and (q.nbytes is None
                                           or q.nbytes >= self.max_bytes):
            return False
        if self.name is not None and (q.name is None or not
                                      fnmatch.fnmatchcase(q.name, self.name)):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """An ordered rule list; first match wins, else ``default``.

    Policies are data — compose them by prepending override rules
    (:meth:`with_rules`) or concatenating rule lists.  Nothing reads a
    policy directly at trace time: :meth:`compile` it against the mesh
    and hand the resulting :class:`CommPlan` to the trainer/server."""

    name: str
    rules: tuple = ()
    default: str = "none"

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        for r in self.rules:
            if not isinstance(r, Rule):
                raise TypeError(f"rules must be Rule instances, got {r!r}")
        codecs.get(self.default)

    def codec_name(self, q: TagQuery) -> str:
        _check(q.dim, DIMS, "comm dimension")
        for r in self.rules:
            if r.matches(q):
                return r.codec
        return self.default

    def with_rules(self, *rules: Rule, name: str | None = None) -> "CommPolicy":
        """New policy with ``rules`` PREPENDED (they override, since
        resolution is first-match-wins)."""
        return CommPolicy(name=name or self.name, rules=rules + self.rules,
                          default=self.default)

    @property
    def dynamic(self) -> bool:
        return any(r.dynamic for r in self.rules)

    def compile(self, mesh_info=None) -> "CommPlan":
        """Resolve axes + validate every reachable codec, once.

        ``mesh_info`` is a :class:`~repro_torch.models.params.MeshInfo`
        or ``None`` for a mesh-free plan (codec resolution only —
        ``plan.axis`` raises).  Validation walks the full
        ``dim x direction x level`` cross product through the rules so a
        bad codec or an impossible rule surfaces here, not at trace
        time."""
        table = {}
        for dim in DIMS:
            dirs = DIRECTIONS if dim in DIRECTED_DIMS else (None,)
            for dr in dirs:
                for lvl in LEVELS:
                    cname = self.codec_name(TagQuery(dim, dr, lvl))
                    table[(dim, dr, lvl)] = codecs.get(cname)
        for r in self.rules:            # reachable-codec validation
            codecs.get(r.codec)
        return CommPlan(policy=self, _table=table,
                        _axes=_resolve_axes(mesh_info),
                        dynamic=self.dynamic)


def _resolve_axes(mesh_info) -> dict:
    """Logical dim -> comms axis (an :class:`~repro_torch.core.comms.Axis`
    or a node-factored :class:`~repro_torch.core.comms.AxisPair`), resolved
    once: ``dp`` rides the ``(node, data)`` pair of a ``--nodes`` mesh, else
    the data axis; ``zero`` stays on the inner data axis (hpZ: the master
    chunks are replicated per node, so the param gather never leaves the
    node); ``tp`` and ``ep`` ride the (possibly ``(tpnode, model)``) model
    axes, ``pp`` the (possibly ``(ppnode, stage)``) stage axes and ``cp``
    the (possibly ``(cpnode, cp)``) context-parallel axes, and ``kv`` the
    serving pool axis the prefill -> decode KV handoff crosses, each
    ``None`` on a mesh without that axis."""
    if mesh_info is None:
        return {}
    mi = mesh_info
    return {"dp": mi.data_pair, "zero": mi.dp_axes, "tp": mi.tp_axes,
            "ep": mi.tp_axes, "pp": mi.stage_axes, "cp": mi.cp_axes,
            "kv": mi.pool_axis}


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A compiled, immutable policy: the bound handles comms consumes.

    ``_table`` maps every valid ``(dim, direction, level)`` triple to a
    codec object — the 33-entry static resolution (exactly the legacy
    Scheme field space).  Dynamic policies (size/name rules) fall back to
    a first-match rule scan when the query carries trace-time facts."""

    policy: CommPolicy
    _table: dict
    _axes: dict
    dynamic: bool = False

    @property
    def name(self) -> str:
        return self.policy.name

    def axis(self, dim: str):
        """The comms axis ``dim``'s traffic rides on the compiled mesh."""
        _check(dim, DIMS, "comm dimension")
        if not self._axes:
            raise KeyError(f"plan {self.name!r} was compiled without a "
                           "mesh — no axis bindings")
        ax = self._axes[dim]
        if ax is None:
            raise KeyError(f"mesh has no axis for dimension {dim!r}")
        return ax

    def table_hash(self) -> str:
        """Stable short hash of the plan's codec resolution: the 33-entry
        static table plus the ordered dynamic (size/name) rule list.

        Independent of the policy's display name — this is the identity
        the tuning controller stamps into heartbeats and
        ``tune_policy.json`` artifacts, so an elastic restart can tell
        "same policy" from "same name, different resolution" (e.g. an
        artifact replayed on a different topology).  Name/size rules are
        resolved per call site at trace time, outside the static table,
        so they hash by their (order-sensitive) predicate serialization."""
        import hashlib
        items = sorted((f"{d}:{dr}:{lvl}={c.name}"
                        for (d, dr, lvl), c in self._table.items()))
        items += [f"rule{i}:{r.codec}:{r.dim}:{r.direction}:{r.level}:"
                  f"{r.min_bytes}:{r.max_bytes}:{r.name}"
                  for i, r in enumerate(self.policy.rules) if r.dynamic]
        return hashlib.sha256("|".join(items).encode()).hexdigest()[:16]

    def codec(self, dim: str, direction: str | None = None,
              level: str = "flat", nbytes: int | None = None,
              name: str | None = None) -> codecs.Codec:
        key = (dim, direction, level)
        if self.dynamic and (nbytes is not None or name is not None):
            if key not in self._table:
                raise KeyError(f"unknown comm query {key!r}")
            q = TagQuery(dim, direction, level, nbytes, name)
            return codecs.get(self.policy.codec_name(q))
        try:
            return self._table[key]
        except KeyError:
            raise KeyError(f"unknown comm query {key!r} (directed dims "
                           "need fwd/bwd; dp/zero take none)") from None

    def codec_pair(self, site_: Site, nbytes: int | None = None):
        """(fwd, bwd) codecs for one single-stage (flat or level-pinned)
        collective — the plan-side twin of the legacy tag fallback."""
        lvl = site_.level or "flat"
        if site_.dim not in DIRECTED_DIMS or site_.direction or site_.level:
            c = self.codec(site_.dim, site_.direction, lvl, nbytes,
                           site_.name)
            return c, c
        return (self.codec(site_.dim, "fwd", "flat", nbytes, site_.name),
                self.codec(site_.dim, "bwd", "flat", nbytes, site_.name))

    def stateful_sites(self, sites) -> dict:
        """Resolve the carried-state sites of this plan, once.

        ``sites`` is an iterable of ``(Site, local_shape, dtype)``: the
        carried-state-capable call sites a trainer emits with their
        per-rank payload shapes.  Each site's codec is resolved exactly as
        the comms entry point will (same nbytes, same name); sites whose
        codec is stateful map ``{ledger_tag: (codec, shape, dtype)}``,
        stateless sites are dropped.  The state template and the trainer's
        state init both derive from this one resolution."""
        import math

        import torch

        out = {}
        for site_, shape, dtype in sites:
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype) \
                .element_size()
            c_fwd, _ = self.codec_pair(site_, nbytes)
            if getattr(c_fwd, "stateful", False):
                out[site_.ledger_tag] = (c_fwd, tuple(shape), dtype)
        return out

    def codec_state_template(self, sites) -> dict:
        """The codec-state dict the trainer threads through its step: one
        ``{ledger_tag: state}`` slot per stateful site of
        :meth:`stateful_sites`, each leaf given as ``(shape, dtype)``
        (the state built on the ``meta`` device, which allocates
        nothing); stateless codecs contribute nothing."""
        def shapes(st):
            if isinstance(st, dict):
                return {k: shapes(v) for k, v in st.items()}
            return tuple(st.shape), st.dtype

        return {key: shapes(c.init_state(shape, dtype, "meta"))
                for key, (c, shape, dtype)
                in self.stateful_sites(sites).items()}

    def hier_codec_pairs(self, site_: Site, nbytes_inner: int | None = None,
                         nbytes_outer: int | None = None):
        """((inner_fwd, inner_bwd), (outer_fwd, outer_bwd)) for one
        two-level hierarchical collective.  ``nbytes_*`` are the per-stage
        payloads (the outer stage moves only a 1/n_inner chunk)."""
        d, n = site_.dim, site_.name
        if d not in DIRECTED_DIMS or site_.direction:
            dr = site_.direction
            ci = self.codec(d, dr, "inner", nbytes_inner, n)
            co = self.codec(d, dr, "outer", nbytes_outer, n)
            return (ci, ci), (co, co)
        return ((self.codec(d, "fwd", "inner", nbytes_inner, n),
                 self.codec(d, "bwd", "inner", nbytes_inner, n)),
                (self.codec(d, "fwd", "outer", nbytes_outer, n),
                 self.codec(d, "bwd", "outer", nbytes_outer, n)))


# --------------------------------------------------------------------------
# normalization + the trace-time plan context
# --------------------------------------------------------------------------

def as_policy(obj) -> CommPolicy:
    """str (registered scheme name) | Scheme | CommPolicy | CommPlan ->
    CommPolicy."""
    if isinstance(obj, CommPolicy):
        return obj
    if isinstance(obj, CommPlan):
        return obj.policy
    if hasattr(obj, "as_policy"):        # a Scheme (duck-typed: survives
        return obj.as_policy()           # `python -m` module aliasing)
    from repro_torch.core import schemes
    return schemes.get(obj).as_policy()


def compile_plan(obj, mesh_info=None) -> CommPlan:
    """Normalize + compile in one step (CommPlans recompile against the
    given mesh so axis bindings always match)."""
    return as_policy(obj).compile(mesh_info)


_ctx = threading.local()


@functools.lru_cache(maxsize=128)
def _scheme_plan(scheme) -> CommPlan:
    """Mesh-free compiled plan of a Scheme — the adapter path the legacy
    ``schemes.use(...)`` context resolves through."""
    return scheme.as_policy().compile(None)


def current_plan() -> CommPlan:
    """The active plan: an explicit ``use_plan`` context, else the
    compiled adapter of the legacy thread-local scheme."""
    plan = getattr(_ctx, "plan", None)
    if plan is not None:
        return plan
    from repro_torch.core import schemes
    return _scheme_plan(schemes.current())


@contextlib.contextmanager
def use_plan(plan):
    """Bind the compiled plan comms resolution reads (thread-local, so
    parallel tracing stays correct).  Accepts anything
    :func:`compile_plan` does; trainers pass their per-mesh plan."""
    if not isinstance(plan, CommPlan):
        plan = compile_plan(plan)
    prev = getattr(_ctx, "plan", None)
    _ctx.plan = plan
    try:
        yield plan
    finally:
        if prev is None:
            del _ctx.plan
        else:
            _ctx.plan = prev
