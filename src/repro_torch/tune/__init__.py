"""Self-tuning compression (port of ``repro.tune``): the measurement ->
policy loop that derives the paper's hybrid scheme at run time.

* :mod:`repro_torch.tune.ladder` — the ``bq16 -> bq8 -> ef:bq4 ->
  plr<r>`` promotion ladder, shared by ``roofline.suggest_scheme`` and the
  controller;
* :mod:`repro_torch.tune.tracker` — the per-site signal vector the tuned
  comms sites accumulate each step, and its host-side reader;
* :mod:`repro_torch.tune.controller` — the host-side decision core that
  walks each site up and down the ladder every ``--tune-interval`` steps;
* :mod:`repro_torch.tune.policy_artifact` — every accepted plan as a
  replayable ``tune_policy.json`` (``--policy-from``).

Import-light, as the reference's: :mod:`repro_torch.analysis.roofline`
imports the ladder, so nothing here imports the analysis layer back.
"""
