"""Top-level model: plan, parameter init and access (port of
``repro.models.model`` for the decoder the paged server drives)."""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (MeshInfo, count_params, init_params,
                                       resolve_device)


class Model:
    """``device=None`` means the card (raises without one); pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: ArchConfig, mi: MeshInfo | None = None,
                 device=None):
        self.cfg = cfg
        self.mi = mi or MeshInfo()
        self.device = resolve_device(device)
        self.plan = transformer.model_plan(cfg, self.mi)

    def init(self, seed: int) -> dict:
        """Random weights from ``seed`` through a ``torch.Generator`` on
        the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.plan, gen, self.device)

    def n_params(self) -> int:
        return count_params(self.plan)
