"""Top-level model: plan, parameter init, the training and prefill
forward, and the loss (port of ``repro.models.model`` for the dense
decoder)."""

from __future__ import annotations

import torch

from repro_torch.core import comms
from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (MeshInfo, count_params, init_params,
                                       resolve_device)


class Model:
    """``device=None`` means the card (raises without one); pass
    ``device="cpu"`` to run on the CPU.  ``mi`` is this rank's view of the
    mesh (one rank by default).  On a stage mesh the plan's layer groups
    describe one stage chunk (``stage_groups``), stage-stacked, and
    ``vpp > 1`` interleaves ``vpp`` round-robin chunks per stage rank; the
    pipeline (:mod:`repro_torch.train.pipeline`) drives them through
    :meth:`run_stage`."""

    def __init__(self, cfg: ArchConfig, mi: MeshInfo | None = None,
                 device=None, vpp: int = 1):
        self.cfg = cfg
        self.mi = mi or MeshInfo()
        if vpp != 1 and self.mi.pp == 1:
            raise ValueError("vpp > 1 (interleaved virtual stages) needs a "
                             "stage mesh")
        self.vpp = vpp
        self.device = resolve_device(device)
        self.mode = cfg.attn_mode_for(self.mi.tp)
        self.stage_groups = transformer.stage_partition(
            cfg, self.mi.pp, vpp) if self.mi.pp > 1 else None
        self.plan = transformer.model_plan(cfg, self.mi, vpp)

    def init(self, seed: int) -> dict:
        """This rank's shards of random weights from ``seed``, drawn through
        a ``torch.Generator`` on the model's device (the same global
        tensors on every mesh)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.plan, gen, self.device, self.mi)

    def n_params(self) -> int:
        return count_params(self.plan)

    # -- training ----------------------------------------------------------
    def _positions(self, B: int, S_loc: int) -> torch.Tensor:
        """GLOBAL positions of this rank's tokens [B, S_loc]: tp slices the
        cp-local slice contiguously (the embedding's reduce-scatter); cp
        shards the whole sequence in zigzag (causal load-balanced) order,
        cp rank i owning the half-chunks i and 2cp-1-i of length S/(2cp),
        so every rank sees the same causal mask volume."""
        mi = self.mi
        j = mi.tp_axes.index * S_loc + torch.arange(
            S_loc, dtype=torch.int32, device=self.device)
        if mi.cp > 1:
            c = (S_loc * mi.tp) // 2          # the half-chunk, S/(2cp)
            i = mi.cp_axes.index
            j = torch.where(j < c, i * c + j,
                            (2 * mi.cp - 1 - i) * c + (j - c))
        return j[None].expand(B, S_loc)

    def _embed_input(self, params, batch) -> torch.Tensor:
        """tokens [B_loc, S] -> this rank's embedded sequence slice."""
        return layers.embed(params["embed"], batch["tokens"], self.cfg,
                            self.mi)

    def run_decoder(self, params, x, pos, phase="train"):
        """Every layer group on ``x`` (a stage-free mesh); at
        ``phase="prefill"`` -> (x, each group's stacked caches)."""
        caches = []
        for gp, g in zip(params["groups"], self.cfg.layer_groups):
            x = transformer.run_group(gp, x, g, self.cfg, self.mi, self.mode,
                                      pos, phase)
            if phase == "prefill":
                x, c = x
                caches.append(c)
        return (x, caches) if phase == "prefill" else x

    def run_stage(self, params, x, pos, v=None) -> torch.Tensor:
        """This stage rank's layer chunk on ``x`` (a stage mesh only);
        ``v`` selects which of the rank's ``vpp`` round-robin chunks runs
        (interleaved layout).  Embedding and head stay with the caller."""
        for i, g in enumerate(self.stage_groups):
            gp = transformer.take_stage(params["groups"][i], v)
            x = transformer.run_group(gp, x, g, self.cfg, self.mi, self.mode,
                                      pos)
        return x

    def head(self, params, x) -> torch.Tensor:
        """Final norm and the tied head: [B, S_loc, D] -> logits [B, S,
        V_loc] f32."""
        x = layers.norm(params["final_norm"], x, self.cfg, self.mi)
        return layers.lm_head_logits(params, x, self.cfg, self.mi)

    def forward(self, params, batch, phase="train"):
        """batch {tokens [B_loc, S]} -> logits [B_loc, S, V_loc] f32; at
        ``phase="prefill"`` -> (logits, the caches of every layer group,
        in the training layout: :mod:`repro_torch.serve.kv_cache`)."""
        if self.mi.pp > 1:
            raise ValueError("flat forward on a stage mesh: use "
                             "repro_torch.train.pipeline")
        x = self._embed_input(params, batch)
        pos = self._positions(x.shape[0], x.shape[1])
        if phase == "train":
            return self.head(params, self.run_decoder(params, x, pos))
        x, caches = self.run_decoder(params, x, pos, phase)
        return self.head(params, x), caches

    def loss_fn(self, params, batch):
        """Global-mean token cross-entropy (a scalar, the same on every
        rank) and its metrics."""
        cfg, mi = self.cfg, self.mi
        logits = self.forward(params, batch)
        ltok, w = layers.vocab_parallel_xent(logits, batch["labels"], cfg, mi)
        del logits
        # cp ranks hold disjoint token slices: their sums add like the
        # batch axes'
        num = comms.raw_psum(ltok.sum(), mi.batch_cp_axes)
        den = comms.raw_psum(w.sum(), mi.batch_cp_axes)
        # every model shard holds the full-sequence loss: the mean over the
        # model axis folds the replication into one scalar
        num = comms.raw_psum(num, mi.tp_axes, mean=True)
        den = comms.raw_psum(den, mi.tp_axes, mean=True)
        loss = num / torch.clamp(den, min=1.0)
        return loss, {"xent": loss.detach(), "tokens": den.detach()}
