"""``tune_policy.json``: every accepted plan as a reproducible artifact
(port of ``repro.tune.policy_artifact``; an artifact from either package
loads in the other).

The controller's output is not just a live ``select`` swap — each
accepted decision round serializes the resulting rule set in the same
shape ``--codec-for`` rules take, so the derived policy outlives the
run: ``launch --policy-from tune_policy.json`` replays it as a static
policy (bit-identical plan table, verified by
``tests/test_torch_tune_train.py``), and an elastic restart can compare
the artifact's ``plan_hash``/``topology`` stamp against its own mesh
before trusting it (``train/fault.py`` heartbeats carry the same hash).

Top-level fields:

* ``version`` — artifact schema version (this module bumps it on layout
  changes; loaders reject unknown majors loudly);
* ``base_scheme`` — the policy name the run started from;
* ``topology`` — the mesh the rules were derived on
  (dp/tp/pp/cp/nodes/pods; ``pods`` is 1 on a mesh without a pod axis,
  as the reference writes it);
* ``plan_hash`` — ``CommPlan.table_hash()`` of the emitted assignment;
* ``step`` — the training step of the last accepted decision;
* ``rules`` — ordered site-override rules (dim/direction/level/name/
  codec), first-match-wins ahead of the base scheme's own rules;
* ``history`` — the full decision log (promote/demote/retune/hold with
  measured error ratios and predicted wire deltas).
"""

from __future__ import annotations

import json
import os

VERSION = 1

#: The artifact's top-level field names — the single list the loader
#: validates against.
ARTIFACT_FIELDS = ("version", "base_scheme", "topology", "plan_hash",
                   "step", "rules", "history")

#: Per-rule field names (the ``--codec-for``-shaped part).
RULE_FIELDS = ("codec", "dim", "direction", "level", "name")


def topology_of(mi) -> dict:
    """The mesh identity stamp (a MeshInfo, or None for mesh-free)."""
    if mi is None:
        return {}
    return {"dp": mi.dp, "tp": mi.tp, "pp": mi.pp, "cp": mi.cp,
            "nodes": mi.node, "pods": mi.pod}


def _rule_dict(r) -> dict:
    dim = r.dim[0] if isinstance(r.dim, tuple) and len(r.dim) == 1 else r.dim
    return {"codec": r.codec, "dim": dim, "direction": r.direction,
            "level": r.level, "name": r.name}


def emit(path: str, controller, mesh_info=None) -> dict:
    """Serialize the controller's current accepted plan to ``path``
    (atomic: write + rename, so a crashed run never leaves a torn
    artifact).  Returns the artifact dict."""
    plan = controller.plan()
    art = {"version": VERSION,
           "base_scheme": controller.base_policy.name,
           "topology": topology_of(mesh_info
                                   if mesh_info is not None
                                   else controller.mesh_info),
           "plan_hash": plan.table_hash(),
           "step": controller.last_decision_step,
           "rules": [_rule_dict(r) for r in controller.rules()],
           "history": list(controller.history)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return art


def load(path: str) -> dict:
    """Read + validate an artifact (unknown version or missing fields
    fail loudly — a tuned policy silently misread is a silent scheme
    change)."""
    with open(path) as f:
        art = json.load(f)
    if art.get("version") != VERSION:
        raise ValueError(f"{path}: tune_policy version "
                         f"{art.get('version')!r} != supported {VERSION}")
    missing = [k for k in ARTIFACT_FIELDS if k not in art]
    if missing:
        raise ValueError(f"{path}: tune_policy missing fields {missing}")
    for r in art["rules"]:
        bad = set(r) - set(RULE_FIELDS)
        if bad:
            raise ValueError(f"{path}: unknown rule fields {sorted(bad)}")
    return art


def rules_from(art: dict) -> tuple:
    """Artifact -> ordered :class:`~repro_torch.core.policy.Rule` overrides
    (validated eagerly — a typo'd codec in a hand-edited artifact fails
    here, not at the first step)."""
    from repro_torch.core import policy
    return tuple(policy.Rule(r["codec"], dim=r.get("dim"),
                             direction=r.get("direction"),
                             level=r.get("level"), name=r.get("name"))
                 for r in art["rules"])


def as_policy(art: dict, base=None):
    """Artifact -> CommPolicy: its rules prepended onto ``base`` (default:
    the artifact's own recorded base scheme)."""
    from repro_torch.core import policy
    base_pol = policy.as_policy(base if base is not None
                                else art["base_scheme"])
    return base_pol.with_rules(*rules_from(art),
                               name=f"{base_pol.name}+tuned")


def topology_mismatch(art: dict, mi) -> list:
    """Human-readable field mismatches between the artifact's recorded
    topology and the live mesh — the loud warning an elastic restart
    prints before applying a foreign artifact (the rules still load: a
    site-name rule set is meaningful across meshes, but the byte
    arithmetic it was derived from is not)."""
    here = topology_of(mi)
    rec = art.get("topology") or {}
    return [f"{k}: artifact={rec.get(k)!r} mesh={here.get(k)!r}"
            for k in sorted(set(rec) | set(here))
            if rec.get(k) != here.get(k)]
