"""The host-side decision core of the self-tuning compression loop (port
of ``repro.tune.controller``).

Every ``--tune-interval`` steps the launch loop drains the in-step
signal accumulators (:mod:`repro_torch.tune.tracker`), hands them to
:meth:`CompressionController.decide`, and applies the returned decisions
by (a) writing the new rung indices into ``tune_state['select']`` —
a host integer swap, nothing rebuilt — and (b) recompiling the
controller's :class:`~repro_torch.core.policy.CommPolicy` into a fresh
:class:`~repro_torch.core.policy.CommPlan` for pricing, heartbeats, and
the ``tune_policy.json`` artifact.

The walk per site, along :data:`repro_torch.tune.ladder.LADDER`:

* **promote** (one rung more aggressive) when the measured relative
  compression error stays bounded (``err_ratio < promote_tol``), the
  loss guard is clean, AND the roofline wire pricing predicts the next
  rung actually saves bytes at this site's payload shape (a ``plr``
  factor pair can exceed a nibble wire on squat payloads — then the
  ladder stops at ``ef:bq4``);
* **demote** (one rung milder, plus a cooldown) when the realized error
  blows up (``err_ratio > demote_tol``) or the loss guard attributes a
  regression to the site's last promotion;
* **retune** the low-rank rank in place from the measured spectral
  decay (smallest registered rank capturing ``spec_frac`` of the probed
  subspace energy).

Decisions are a pure, deterministic function of the signal stream and
the controller's own prior state — no RNG, no wall clock — which is
what makes the decision core unit-testable with synthetic streams
(``tests/test_torch_tune.py`` feeds this and the reference's the same
ones) and a resumed run replayable.  Fed the same signals, it makes the
reference's decisions with the same floats.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import codecs, policy
from repro_torch.tune import ladder


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the ladder walk (CLI: ``--tune-interval``/``--tune-guard``).

    ``promote_tol``/``demote_tol`` bound the relative compression error
    ``sqrt(||x - D(E(x))||^2 / ||x||^2)`` (hysteresis: demote_tol well
    above promote_tol so sites don't flap); ``guard`` is the relative
    loss-EMA regression that vetoes promotions and rolls back the most
    recent one; ``cooldown`` is how many decision rounds a demoted site
    holds before it may promote again."""

    interval: int = 50
    promote_tol: float = 0.15
    demote_tol: float = 0.60
    guard: float = 0.05
    cooldown: int = 2
    spec_frac: float = 0.90
    min_steps: int = 2
    loss_ema: float = 0.8


@dataclasses.dataclass(frozen=True)
class Decision:
    """One accepted (or explicitly held) per-site ladder move."""

    step: int
    site: str
    action: str                 # promote | demote | retune | hold
    from_codec: str
    to_codec: str
    reason: str
    err_ratio: float
    wire_before: float = 0.0    # predicted per-step site wire bytes
    wire_after: float = 0.0

    @property
    def changed(self) -> bool:
        return self.to_codec != self.from_codec

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _wire(codec_name: str, elems: int) -> float:
    """Predicted per-step wire bytes of one site payload under a codec —
    the same ``wire_nbytes_for`` arithmetic the roofline ledger prices
    with, so "promote only on predicted savings" and the recorded-bytes
    acceptance gate agree."""
    return float(codecs.get(codec_name).wire_nbytes_for(elems))


class CompressionController:
    """Walks each tunable site along the codec ladder from measured
    signals.

    ``sites`` maps the tunable sites' ledger-tag keys to
    ``(Site, elems)`` — the site identity rules are emitted against and
    the per-rank payload element count wire predictions price.  The
    starting rung per site comes from ``base_policy``'s resolution at
    that site, so a tuned run begins exactly where its static scheme
    stands."""

    def __init__(self, base_policy, sites: dict, mesh_info=None,
                 cfg: ControllerConfig | None = None, start_step: int = 0):
        self.base_policy = policy.as_policy(base_policy)
        self.cfg = cfg or ControllerConfig()
        self.mesh_info = mesh_info
        self.sites = dict(sites)
        base_plan = self.base_policy.compile(None)
        f32 = 4
        self.codec = {
            key: ladder.RUNGS[ladder.rung_or_default(
                base_plan.codec_pair(s, elems * f32)[0].name)]
            for key, (s, elems) in self.sites.items()}
        self.cooldown = {key: 0 for key in self.sites}
        self.history: list[dict] = []
        self.last_decision_step = start_step
        self._loss_ema = None
        self._guard_ref = None
        self._last_promoted: set = set()

    # -- loss guard --------------------------------------------------------
    def observe_loss(self, step: int, loss: float):
        """Feed the per-step training loss (EMA'd for the guard)."""
        a = self.cfg.loss_ema
        self._loss_ema = loss if self._loss_ema is None \
            else a * self._loss_ema + (1 - a) * loss

    def _regressed(self) -> bool:
        return (self._guard_ref is not None and self._loss_ema is not None
                and self._loss_ema > self._guard_ref * (1 + self.cfg.guard)
                and bool(self._last_promoted))

    # -- the walk ----------------------------------------------------------
    def decide(self, step: int, signals: dict) -> list[Decision]:
        """One decision round over the drained per-site signals.

        Deterministic in (signals, prior controller state).  Returns
        every site's decision (including holds, for the history); the
        caller applies ``changed`` ones via :meth:`select_indices` and
        :meth:`plan`."""
        cfg = self.cfg
        regressed = self._regressed()
        out = []
        promoted: set = set()
        for key in sorted(self.sites):
            s, elems = self.sites[key]
            cur = self.codec[key]
            sig = signals.get(key)
            d = None
            if regressed and key in self._last_promoted:
                # loss guard: blame the most recent promotion(s)
                to = ladder.demote(cur)
                self.cooldown[key] = cfg.cooldown
                d = Decision(step, key, "demote", cur, to,
                             "loss-guard regression", -1.0,
                             _wire(cur, elems), _wire(to, elems))
            elif sig is None or sig.count < cfg.min_steps:
                d = Decision(step, key, "hold", cur, cur,
                             "insufficient signal", -1.0)
            elif sig.err_ratio > cfg.demote_tol and cur != ladder.LADDER[0]:
                to = ladder.demote(cur)
                self.cooldown[key] = cfg.cooldown
                d = Decision(step, key, "demote", cur, to,
                             f"residual blow-up ({sig.err_ratio:.3f} > "
                             f"{cfg.demote_tol})", sig.err_ratio,
                             _wire(cur, elems), _wire(to, elems))
            elif self.cooldown[key] > 0:
                self.cooldown[key] -= 1
                d = Decision(step, key, "hold", cur, cur, "cooldown",
                             sig.err_ratio)
            elif regressed:
                d = Decision(step, key, "hold", cur, cur,
                             "loss-guard veto", sig.err_ratio)
            elif sig.err_ratio < cfg.promote_tol:
                rank = sig.spectral_rank(cfg.spec_frac, ladder.PLR_RANKS)
                to = ladder.promote(cur, rank)
                wb, wa = _wire(cur, elems), _wire(to, elems)
                # a rank retune tracks the measured spectrum BOTH ways
                # (widening trades wire for subspace coverage on purpose);
                # only genuine rung promotions must predict a wire saving
                retune = ladder.plr_rank(cur) is not None
                if to != cur and (retune or wa < wb):
                    action = "retune" if retune else "promote"
                    promoted.add(key)
                    d = Decision(step, key, action, cur, to,
                                 f"bounded error ({sig.err_ratio:.3f} < "
                                 f"{cfg.promote_tol}), predicted "
                                 f"{wb - wa:.0f}B/step saved",
                                 sig.err_ratio, wb, wa)
                elif to != cur:
                    d = Decision(step, key, "hold", cur, cur,
                                 f"no predicted wire saving "
                                 f"({wa:.0f}B >= {wb:.0f}B)",
                                 sig.err_ratio, wb, wa)
                else:
                    d = Decision(step, key, "hold", cur, cur, "at top rung",
                                 sig.err_ratio)
            else:
                d = Decision(step, key, "hold", cur, cur,
                             "error above promote tolerance",
                             sig.err_ratio)
            self.codec[key] = d.to_codec
            out.append(d)
            self.history.append(d.as_dict())
        self._last_promoted = promoted
        self._guard_ref = self._loss_ema
        self.last_decision_step = step
        return out

    # -- plan / select materialization ------------------------------------
    def rules(self) -> tuple:
        """One exact-site override rule per tunable site, in sorted-key
        order — prepended onto the base policy they win first-match."""
        out = []
        for key in sorted(self.sites):
            s, _ = self.sites[key]
            out.append(policy.Rule(self.codec[key], dim=s.dim,
                                   direction=s.direction,
                                   level=s.level or "flat", name=s.name))
        return tuple(out)

    def policy_now(self) -> policy.CommPolicy:
        return self.base_policy.with_rules(
            *self.rules(), name=f"{self.base_policy.name}+tuned")

    def plan(self) -> policy.CommPlan:
        """The current assignment compiled against the mesh — NOT handed
        to the running step (which dispatches on :meth:`select_indices`);
        used for pricing, the heartbeat hash, and the artifact."""
        return self.policy_now().compile(self.mesh_info)

    def select_indices(self) -> dict:
        """Per-site rung ints for ``tune_state['select']`` — the one
        value the running step actually consumes."""
        return {key: ladder.rung_index(c) for key, c in self.codec.items()}

    # -- persistence (checkpointed next to <ckpt>/tune/) -------------------
    def state_dict(self) -> dict:
        return {"codec": dict(self.codec), "cooldown": dict(self.cooldown),
                "history": list(self.history),
                "last_decision_step": self.last_decision_step,
                "loss_ema": self._loss_ema, "guard_ref": self._guard_ref,
                "last_promoted": sorted(self._last_promoted)}

    def load_state_dict(self, st: dict):
        unknown = set(st.get("codec", {})) - set(self.sites)
        if unknown:
            raise ValueError(
                f"controller state names unknown tunable sites {sorted(unknown)} "
                f"(have {sorted(self.sites)}) — saved on a different "
                "topology/bucketing; restart tuning fresh")
        self.codec.update(st.get("codec", {}))
        self.cooldown.update(st.get("cooldown", {}))
        self.history = list(st.get("history", []))
        self.last_decision_step = int(st.get("last_decision_step", 0))
        self._loss_ema = st.get("loss_ema")
        self._guard_ref = st.get("guard_ref")
        self._last_promoted = set(st.get("last_promoted", []))
