"""The port's fault tolerance (repro_torch.train.fault) against the
reference's: ``StepMonitor``'s straggler flags, EMA and heartbeat file
(the same keys, written atomically), ``heartbeat_stale``,
``RestartPolicy`` and ``tune_restart_warnings``, on the same scripted
clocks and files.  Each fault
module's ``time`` is replaced by a scripted clock (the process's own
clock is untouched), so the comparisons are exact."""

import json
import time

import numpy as np
import pytest


class Clock:
    """A ``time`` module whose ``monotonic`` and ``time`` follow a script
    of step lengths: each ``begin`` / ``end`` pair is one step."""

    def __init__(self, dts):
        self.ticks = []
        at = 100.0
        for dt in dts:
            self.ticks += [at, at + dt]
            at += dt + 0.5
        self.i = 0

    def monotonic(self):
        t = self.ticks[self.i]
        self.i += 1
        return t

    def time(self):
        return 1.7e9 + self.ticks[self.i - 1]


SCRIPTS = {
    "steady": (dict(), [0.01, 0.011, 0.009, 0.01]),
    "straggler": (dict(straggler_factor=2.0, ema_decay=0.0),
                  [0.01, 0.06, 0.01, 0.05]),
    "slow_ema": (dict(straggler_factor=1.5, ema_decay=0.5),
                 [0.02, 0.02, 0.035, 0.02, 0.04]),
    "tuned": (dict(tune_plan_hash="abc123", tune_decision_step=7),
              [0.01, 0.03]),
}


def _drive(mod, kw, dts, path, monkeypatch):
    monkeypatch.setattr(mod, "time", Clock(dts))
    mon = mod.StepMonitor(heartbeat_path=str(path), **kw)
    infos, beats = [], []
    for step, _ in enumerate(dts):
        mon.begin()
        infos.append(mon.end(step))
        beats.append(json.loads(path.read_text()))
    monkeypatch.undo()
    return infos, beats, (mon.stragglers, mon.steps, mon.ema)


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_step_monitor_matches_reference(script, tmp_path, monkeypatch):
    from repro.train import fault as jfault
    from repro_torch.train import fault as tfault
    kw, dts = SCRIPTS[script]
    want = _drive(jfault, kw, dts, tmp_path / "ref.json", monkeypatch)
    got = _drive(tfault, kw, dts, tmp_path / "port.json", monkeypatch)
    assert got == want
    infos, beats, (stragglers, steps, _) = got
    assert steps == len(dts)
    assert stragglers == sum(i["straggler"] for i in infos)
    keys = ["dt", "ema", "step", "straggler", "t"]
    if "tune_plan_hash" in kw:
        keys += ["tune_decision_step", "tune_plan_hash"]
    assert all(sorted(b) == keys for b in beats)
    # the atomic write leaves no temporary file behind
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.json",
                                                          "ref.json"]
    if script == "straggler":
        assert [i["straggler"] for i in infos] == [False, True, False, True]


def test_step_monitor_without_heartbeat(monkeypatch):
    from repro_torch.train import fault
    monkeypatch.setattr(fault, "time", Clock([0.01, 0.05]))
    mon = fault.StepMonitor(straggler_factor=2.0, ema_decay=0.0)
    for step in range(2):
        mon.begin()
        info = mon.end(step)
    assert info["straggler"] and mon.stragglers == 1


@pytest.mark.parametrize("case", ["missing", "corrupt", "fresh", "stale"])
def test_heartbeat_stale_matches_reference(case, tmp_path):
    from repro.train import fault as jfault
    from repro_torch.train import fault as tfault
    p = tmp_path / "hb.json"
    if case == "corrupt":
        p.write_text("{not json")
    elif case in ("fresh", "stale"):
        age = 5.0 if case == "fresh" else 120.0
        p.write_text(json.dumps({"step": 3, "t": time.time() - age}))
    want = jfault.heartbeat_stale(p, timeout_s=60)
    assert tfault.heartbeat_stale(p, timeout_s=60) == want
    assert want == (case != "fresh")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_restart_policy_reads_either_package(writer, tmp_path):
    import jax.numpy as jnp
    import torch
    from repro.models.params import Pv as JPv
    from repro.train import checkpoint as jck, fault as jfault
    from repro_torch.train import checkpoint as tck, fault as tfault
    pols = {"reference": jfault.RestartPolicy(str(tmp_path), max_restarts=2),
            "port": tfault.RestartPolicy(str(tmp_path), max_restarts=2)}
    for pol in pols.values():
        assert pol.should_restart()
        assert pol.on_failure() is None          # no checkpoint yet
    if writer == "reference":
        jck.save(tmp_path, 9, {"w": JPv(jnp.zeros((4,)), (None,))})
    else:
        tck.save(tmp_path, 9, {"w": tck.Pv(torch.zeros(4), (None,))})
    for pol in pols.values():
        assert pol.on_failure() == 9
        assert not pol.should_restart()          # budget exhausted
        assert pol.restarts == 2


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("beat", ["none", "same", "stale"])
def test_tune_restart_warnings_match_reference(writer, beat, tmp_path,
                                               monkeypatch):
    """The pre-flight of a ``--policy-from`` resume says the reference's
    lines word for word, against a heartbeat either package's monitor
    stamped with the run's plan hash."""
    from repro.models.params import MeshInfo as JMeshInfo
    from repro.train import fault as jfault
    from repro_torch.models.params import MeshInfo as TMeshInfo
    from repro_torch.train import fault as tfault
    art = {"version": 1, "plan_hash": "89ab89ab89ab89ab", "step": 9,
           "topology": {"dp": 2, "tp": 1, "pp": 1, "cp": 1, "nodes": 2,
                        "pods": 1}}
    hb = tmp_path / "heartbeat.json"
    if beat != "none":
        mod = jfault if writer == "reference" else tfault
        monkeypatch.setattr(mod, "time", Clock([0.01]))
        mon = mod.StepMonitor(
            heartbeat_path=str(hb), tune_decision_step=9,
            tune_plan_hash=art["plan_hash"] if beat == "same"
            else "0000111122223333")
        mon.begin()
        mon.end(9)
        monkeypatch.undo()
    meshes = ((TMeshInfo(dp=2, node=2), JMeshInfo(dp=2, node=2,
                                                  node_axis="node")),
              (TMeshInfo(dp=4, tp=2), JMeshInfo(dp=4, tp=2)))
    for mt, mj in meshes:
        for path in (None, str(hb)):
            want = jfault.tune_restart_warnings(art, mj, path)
            assert tfault.tune_restart_warnings(art, mt, path) == want
    lines = tfault.tune_restart_warnings(art, meshes[1][0], str(hb))
    assert lines[:3] == ["tune_policy topology mismatch — dp: artifact=2 "
                         "mesh=4",
                         "tune_policy topology mismatch — nodes: artifact=2 "
                         "mesh=1",
                         "tune_policy topology mismatch — tp: artifact=1 "
                         "mesh=2"]
    assert len(lines) == (4 if beat == "stale" else 3)
    if beat == "stale":
        assert lines[3] == ("tune_policy plan_hash 89ab89ab89ab89ab != last "
                            "heartbeat plan 0000111122223333 (decision step "
                            "9) — the artifact is stale relative to the run "
                            "it came from")


def test_ema_is_the_reference_recurrence(monkeypatch):
    """The EMA after a script is the reference's closed recurrence."""
    from repro_torch.train import fault
    dts = [0.02, 0.04, 0.01]
    monkeypatch.setattr(fault, "time", Clock(dts))
    mon = fault.StepMonitor(ema_decay=0.9)
    for step in range(3):
        mon.begin()
        mon.end(step)
    ema = dts[0]
    for dt in dts[1:]:
        ema = 0.9 * ema + 0.1 * dt
    np.testing.assert_allclose(mon.ema, ema, rtol=1e-12)
