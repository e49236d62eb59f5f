"""Fault tolerance: step monitoring, straggler detection, restart policy
(port of ``repro.train.fault``).

* StepMonitor  — EMA of step wall-time; flags stragglers (step > k x EMA)
  and writes a heartbeat file other hosts / the launcher can watch (the
  reference's keys, written atomically).
* RestartPolicy — decides recovery actions: resume from the latest
  checkpoint (the deterministic data stream makes the replay exact),
  elastically onto another ``--dp`` / ``--tp`` / ``--pp`` through
  :mod:`repro_torch.train.checkpoint`.

The reference's ``tune_restart_warnings`` checks a tuned-policy artifact,
which this package has not ported yet; the monitor's two ``tune_*``
fields are plain fields that the heartbeat carries when set.
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
