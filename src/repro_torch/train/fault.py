"""Fault tolerance: step monitoring, straggler detection, restart policy
(port of ``repro.train.fault``).

* StepMonitor  — EMA of step wall-time; flags stragglers (step > k x EMA)
  and writes a heartbeat file other hosts / the launcher can watch (the
  reference's keys, written atomically).
* RestartPolicy — decides recovery actions: resume from the latest
  checkpoint (the deterministic data stream makes the replay exact),
  elastically onto another ``--dp`` / ``--tp`` / ``--pp`` through
  :mod:`repro_torch.train.checkpoint`.

* tune_restart_warnings — the loud pre-flight of a resume with a tuned
  policy artifact (``--policy-from``): its topology against the live mesh,
  its plan hash against the one the run's last heartbeat stamped (the
  monitor's ``tune_*`` fields, which a self-tuning run sets after each
  decision round).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time


@dataclasses.dataclass
class StepMonitor:
    heartbeat_path: str | None = None
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    ema: float | None = None
    last_t: float | None = None
    stragglers: int = 0
    steps: int = 0
    # the compression plan a self-tuning run is executing, stamped into
    # the heartbeat when set
    tune_plan_hash: str | None = None
    tune_decision_step: int | None = None

    def begin(self):
        self.last_t = time.monotonic()

    def end(self, step: int) -> dict:
        now = time.monotonic()
        dt = now - (self.last_t or now)
        self.steps += 1
        is_straggler = False
        if self.ema is not None and dt > self.straggler_factor * self.ema:
            self.stragglers += 1
            is_straggler = True
        self.ema = dt if self.ema is None else \
            self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        if self.heartbeat_path:
            hb = {"step": step, "t": time.time(), "dt": dt,
                  "ema": self.ema, "straggler": is_straggler}
            if self.tune_plan_hash is not None:
                hb["tune_plan_hash"] = self.tune_plan_hash
                hb["tune_decision_step"] = self.tune_decision_step
            p = pathlib.Path(self.heartbeat_path)
            tmp = p.with_suffix(".tmp")
            tmp.write_text(json.dumps(hb))
            os.replace(tmp, p)
        return {"dt": dt, "ema": self.ema, "straggler": is_straggler}


def heartbeat_stale(path, timeout_s: float) -> bool:
    """Launcher-side liveness check: no heartbeat for timeout -> dead
    host."""
    p = pathlib.Path(path)
    if not p.exists():
        return True
    try:
        hb = json.loads(p.read_text())
    except (ValueError, OSError):
        return True
    return (time.time() - hb["t"]) > timeout_s


def tune_restart_warnings(artifact: dict, mesh_info,
                          heartbeat_path=None) -> list:
    """Loud pre-flight for resuming with a tuned-policy artifact.

    Returns human-readable warning lines (empty = clean).  Two checks:
    the artifact's recorded topology against the live mesh (an elastic
    restart onto a different dp/node split invalidates the byte
    arithmetic the rules were derived from), and — when the dead run's
    heartbeat survives — the artifact's ``plan_hash`` against the plan
    hash the run was actually executing, which catches replaying a stale
    artifact from an earlier decision round.  The reference's lines, word
    for word."""
    from repro_torch.tune import policy_artifact
    warnings = []
    for diff in policy_artifact.topology_mismatch(artifact, mesh_info):
        warnings.append(f"tune_policy topology mismatch — {diff}")
    if heartbeat_path:
        p = pathlib.Path(heartbeat_path)
        if p.exists():
            try:
                hb = json.loads(p.read_text())
            except (ValueError, OSError):
                hb = {}
            run_hash = hb.get("tune_plan_hash")
            art_hash = artifact.get("plan_hash")
            if run_hash and art_hash and run_hash != art_hash:
                warnings.append(
                    f"tune_policy plan_hash {art_hash} != last heartbeat "
                    f"plan {run_hash} (decision step "
                    f"{hb.get('tune_decision_step')}) — the artifact is "
                    "stale relative to the run it came from")
    return warnings


@dataclasses.dataclass
class RestartPolicy:
    ckpt_dir: str
    max_restarts: int = 10
    restarts: int = 0

    def should_restart(self) -> bool:
        return self.restarts < self.max_restarts

    def on_failure(self) -> int | None:
        """Returns the step to resume from (None = cold start)."""
        from repro_torch.train import checkpoint
        self.restarts += 1
        return checkpoint.latest_step(self.ckpt_dir)
