"""Top-level model: plan, parameter init, the training and prefill
forward, and the loss (port of ``repro.models.model`` for the dense
decoders, qwen2-vl's backbone (its precomputed ``vision`` embeddings
merged under ``vis_mask``, its M-RoPE ids ``pos3``), the
Mixture-of-Experts decoders, whose load-balance aux term the loss adds,
the recurrent families: zamba2's mamba stack with its shared attention
block, ``params["shared"]``, and xLSTM, and whisper's encoder-decoder
backbone: its encoder stack over the stub ``frames`` embeddings, then
``enc_norm``, whose output every decoder layer cross-attends to)."""

from __future__ import annotations

import torch

from repro_torch.core import comms
from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (MeshInfo, bind_fsdp, count_params,
                                       init_params, resolve_device,
                                       torch_dtype)

_LB_COEF = 0.01  # MoE load-balance aux weight


def lb_term(aux, mi: MeshInfo, micro: int = 1):
    """The MoE aux of this rank (summed over its layers) -> ``(lb_loss,
    drop_frac)``: each averaged over the model, batch and cp axes, as the
    reference's ``pmean``, and divided by ``micro`` (per-microbatch sums
    add up to ``micro`` times the whole batch's mean).  ``lb_loss`` keeps
    its gradient; ``drop_frac`` is a detached metric."""
    v = torch.stack([aux["lb_loss"], aux["drop_frac"].detach()])
    v = comms.raw_psum(v, mi.tp_axes, mean=True)
    v = comms.raw_psum(v, mi.batch_cp_axes, mean=True) / micro
    return v[0], v[1].detach()


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

    def group_params(self, params, i: int):
        """Layer group ``i``'s tree as the bodies read it: its ZeRO-3
        leaves wrapped with their specs (``bind_fsdp``), so each layer
        re-gathers them where it reads them."""
        return bind_fsdp(self.plan["groups"][i], params["groups"][i])

    def shared_params(self, params):
        """The shared attention block's tree (``None`` without one), its
        ZeRO-3 leaves wrapped as in :meth:`group_params`."""
        if "shared" not in self.plan:
            return None
        return bind_fsdp(self.plan["shared"], params["shared"])

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
        """tokens [B_loc, S] -> this rank's embedded sequence slice; an
        M-RoPE model given ``vision`` [B_loc, S_loc, D] takes it where
        ``vis_mask`` [B_loc, S_loc] is set (the stubbed vision frontend's
        patch embeddings, merged into the token stream)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], batch["tokens"], cfg, self.mi)
        if cfg.mrope and "vision" in batch:
            mask = batch["vis_mask"][..., None]
            x = torch.where(mask, batch["vision"].to(x.dtype), x)
        return x

    def encode(self, params, frames):
        """whisper's encoder over this rank's slice of the stub frame
        embeddings [B_loc, Se_loc, D] (cast to the model's type; sharded
        over tp as the reference's batch spec ``P(batch, tp, None)``) ->
        (the encoder's output after ``enc_norm``, its global positions).
        A config without ``enc_attn`` groups (the reference's reduced
        whisper: fault C.21) runs ``enc_norm`` alone."""
        cfg = self.cfg
        x = frames.to(torch_dtype(cfg.dtype))
        pos = self._positions(x.shape[0], x.shape[1])
        for i, g in enumerate(cfg.layer_groups):
            if g.kind == "enc_attn":
                x, _, _ = transformer.run_group(self.group_params(params, i),
                                                x, g, cfg, self.mi,
                                                self.mode, pos)
        return layers.norm(params["enc_norm"], x, cfg, self.mi), pos

    def run_decoder(self, params, x, pos, phase="train", pos3=None,
                    cross=None, cross_pos=None):
        """Every decoder layer group on ``x`` (a stage-free mesh) -> (x,
        each group's stacked caches at ``phase="prefill"`` (else
        ``None`` s), the MoE aux summed over the layers or ``None``).
        ``enc_attn`` groups are the encoder's (:meth:`encode`): skipped,
        their cache ``None``; ``cross`` / ``cross_pos`` are the encoder's
        output and positions, which the ``dec_attn`` layers attend to."""
        caches, aux = [], None
        shared = self.shared_params(params)
        for i, g in enumerate(self.cfg.layer_groups):
            if g.kind == "enc_attn":
                caches.append(None)
                continue
            x, c, a = transformer.run_group(self.group_params(params, i), x,
                                            g, self.cfg, self.mi, self.mode,
                                            pos, phase, pos3, shared, cross,
                                            cross_pos)
            caches.append(c)
            aux = transformer.add_aux(aux, a)
        return x, caches, aux

    def run_stage(self, params, x, pos, v=None):
        """This stage rank's layer chunk on ``x`` (a stage mesh only) ->
        (x, its MoE aux or ``None``); ``v`` selects which of the rank's
        ``vpp`` round-robin chunks runs (interleaved layout).  Embedding
        and head stay with the caller."""
        aux = None
        for i, g in enumerate(self.stage_groups):
            gp = transformer.take_stage(self.group_params(params, i), v)
            x, _, a = transformer.run_group(gp, x, g, self.cfg, self.mi,
                                            self.mode, pos)
            aux = transformer.add_aux(aux, a)
        return x, aux

    def head(self, params, x) -> torch.Tensor:
        """Final norm and the head (tied or not): [B, S_loc, D] -> logits
        [B, S, V_loc] f32."""
        x = layers.norm(params["final_norm"], x, self.cfg, self.mi)
        return layers.lm_head_logits(params, x, self.cfg, self.mi)

    def _forward(self, params, batch, phase):
        """-> (logits, caches, MoE aux) of :meth:`forward`."""
        if self.mi.pp > 1:
            raise ValueError("flat forward on a stage mesh: use "
                             "repro_torch.train.pipeline")
        cross = cross_pos = None
        if self.cfg.encoder_layers:
            cross, cross_pos = self.encode(params, batch["frames"])
        x = self._embed_input(params, batch)
        pos = self._positions(x.shape[0], x.shape[1])
        pos3 = batch.get("pos3") if self.cfg.mrope else None
        x, caches, aux = self.run_decoder(params, x, pos, phase, pos3, cross,
                                          cross_pos)
        return self.head(params, x), caches, aux

    def forward(self, params, batch, phase="train"):
        """batch {tokens [B_loc, S]} (an M-RoPE model's also ``vision``,
        ``vis_mask`` and ``pos3`` [B_loc, S_loc, 3], each optional; an
        encoder-decoder's also ``frames`` [B_loc, Se / tp, D]) ->
        logits [B_loc, S, V_loc] f32; at ``phase="prefill"`` -> (logits,
        the caches of every layer group, in the training layout:
        :mod:`repro_torch.serve.kv_cache`)."""
        logits, caches, _ = self._forward(params, batch, phase)
        return logits if phase == "train" else (logits, caches)

    def loss_fn(self, params, batch):
        """Global-mean token cross-entropy, plus the MoE load-balance term
        of an expert model (a scalar, the same on every rank), and its
        metrics (an expert model's also ``lb_loss`` and ``drop_frac``,
        summed over its layers)."""
        cfg, mi = self.cfg, self.mi
        logits, _, aux = self._forward(params, batch, "train")
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
        metrics = {"xent": loss.detach(), "tokens": den.detach()}
        if cfg.n_experts:
            lb, drop = lb_term(aux if aux is not None else
                               transformer.zero_aux(loss.device), mi)
            loss = loss + _LB_COEF * lb
            metrics.update(lb_loss=lb.detach(), drop_frac=drop)
        return loss, metrics
