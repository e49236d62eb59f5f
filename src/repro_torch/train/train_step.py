"""The training step (port of ``repro.train.train_step`` without tuning and
without codec state).

One step = forward -> backward under the compiled plan and the ring
options -> the optimizer's compressed ZeRO-1 sync and update.  PyTorch runs
it eagerly, so the reference's ``jit``, ``shard_map`` and buffer donation
have no counterpart: each rank runs the step on its own shards, and the
optimizer updates the parameter tensors in place.
"""

from __future__ import annotations

import torch

from repro_torch.core import comms
from repro_torch.core import policy as policy_lib
from repro_torch.models.model import Model
from repro_torch.models.params import leaves
from repro_torch.train.optimizer import Adam, AdamConfig


class Trainer:
    """Step and init for (model, policy, optimizer).  ``scheme`` is
    anything :func:`~repro_torch.core.policy.compile_plan` accepts; it is
    compiled against the model's mesh once here."""

    def __init__(self, model: Model, scheme="baseline",
                 opt_cfg: AdamConfig | None = None, ring_bidir: bool = False,
                 ring_chunks: int = 1):
        self.model = model
        self.policy = policy_lib.as_policy(scheme)
        self.plan = self.policy.compile(model.mi)
        self.ring_bidir = ring_bidir
        self.ring_chunks = ring_chunks
        self.opt = Adam(opt_cfg or AdamConfig(), model.mi, model.plan)

    def init_all(self, seed: int):
        """``(params, opt_state)`` of this rank."""
        params = self.model.init(seed)
        return params, self.opt.init(params)

    def step(self, params, opt_state, batch):
        """One training step; ``params`` are updated in place.  Returns
        ``(params, opt_state, metrics)``."""
        ts = [t for _, t in leaves(self.model.plan, params)]
        with policy_lib.use_plan(self.plan), \
                comms.ring_options(self.ring_bidir, self.ring_chunks):
            for t in ts:
                t.requires_grad_(True)
            try:
                loss, metrics = self.model.loss_fn(params, batch)
                grads = list(torch.autograd.grad(loss, ts))
            finally:
                for t in ts:
                    t.requires_grad_(False)
            opt_state, stats = self.opt.apply(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), **metrics, **stats}
