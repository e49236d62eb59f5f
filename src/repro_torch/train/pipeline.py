"""Microbatched pipeline-parallel training over the ``stage`` axis (port of
``repro.train.pipeline``).

The schedule is the reference's SPMD form of 1F1B: the local batch splits
into ``n_micro`` microbatches and every rank runs ``T = n_micro + pp - 1``
ticks; at tick ``t`` stage ``s`` processes microbatch ``t - s`` (masked
outside the fill/drain window):

    tick          0     1     2     3       (pp = 2, n_micro = 3)
    stage 0     mb0   mb1   mb2    --
    stage 1      --   mb0   mb1   mb2      -> loss(mb) as each drains

Each tick first hands the previous tick's output one stage down
(:func:`repro_torch.core.comms.stage_send`, under the scheme's ``pp_fwd``
codec; its backward returns the activation gradient upstream under
``pp_bwd``), then the first stage takes the embedded microbatch in place
of what it received, every stage runs its layer chunk, and the last stage
drains: final norm, head and vocab-parallel cross-entropy, summed into the
global token mean.
On a ``--pp-nodes`` mesh the stage axis is the ``(ppnode, stage)`` pair,
and the handoff is :func:`~repro_torch.core.comms.hier_ppermute`: a
boundary inside a node rides the ``pp_*_inner`` codec, one that crosses a
node the ``pp_*_outer`` codec.

Interleaved virtual stages (``model.vpp = V > 1``): rank ``s`` holds ``V``
round-robin chunks (chunk ``c = v * pp + s`` is its slice ``v``), the step
runs ``T = n_micro * V + pp - 1`` ticks of ``1/V`` of its depth, and the
handoff is a full ring (:func:`~repro_torch.core.comms.stage_ring_send`):
the chunk after the last rank's slice ``v`` is the first rank's ``v + 1``.
Rank ``s`` at tick ``t`` decodes its work from ``u = t - s``: slot ``r = u %
pp``, slice ``v = (u % (pp V)) // pp``, microbatch ``(u // (pp V)) * pp +
r``.

How the SPMD schedule runs as processes:

* every rank runs every tick, the stage body on fill and drain ticks (on
  zeros or a clamped microbatch) and every handoff included, so the TP
  and PP collectives, and the ledger, match the reference's event for
  event (the reference records its tick body ``T`` times);
* work whose result the reference weighs by zero and which emits no ledger
  event is skipped: the embedding of a tick whose stage does not take it
  and the head of a tick that does not drain run without autograd (their
  forward collectives are the reference's events), so no backward runs for
  them;
* stage 0 blends its received activation away with ``torch.where``, as the
  reference does, which keeps the handoff in the graph, and the backward
  (one ``torch.autograd.grad`` per rank) takes every handoff's output as
  a root with a zero cotangent: every rank runs every handoff's backward,
  tick by tick in reverse order (a handoff's backward needs its tick's
  stage body's, which needs the next handoff's), so the two sides of each
  exchange meet and no rank waits on a backward its neighbour never posts;
* the stage fold of the loss's numerator and denominator is an all-reduce
  whose cotangent is the same on every stage rank (the loss is
  replicated), so its backward multiplies by ``pp`` locally and the first
  stage, whose partial sums carry no gradient, need not join it;
* an expert model's MoE aux is summed over the ticks on which this stage
  holds a real microbatch, folded over the stage axis the same way, and
  its load-balance mean divided by ``n_micro`` (the microbatches' means
  add up to ``n_micro`` times the whole batch's), as in the reference.

Activation memory: a ``remat`` config (every full-size one) checkpoints
each layer of the stage body, as the flat step does
(:func:`repro_torch.models.transformer.run_group`), so a tick keeps only
its layers' inputs; the recompute of each layer re-runs its TP, ZeRO-3
and expert collectives, whose analytic events are muted while their
forward events carry ``remat``, as in the reference.  ``--remat-policy``
adds the reference's tick-level checkpoint around that: ``full``
checkpoints every stage body, ``per_stage:<v,...>`` the ticks where stage
0 runs the named slices, keyed on the tick, never on the rank's slice, as
in the reference; the per-layer checkpoints nest inside it.  Both levels
run under one helper, :func:`repro_torch.core.comms.checkpointed`
(non-reentrant ``torch.utils.checkpoint``; its recompute re-binds the
forward's plan on autograd's thread and mutes the recompute's analytic
ledger events, as the reference's ledger counts a checkpointed body
once).  ``+offload`` parks the stage body's saved activations in pinned
host memory (``torch.autograd.graph.save_on_cpu``) instead of
recomputing them: the reference offloads its checkpoint's matmul
residuals, which PyTorch has no policy for.  The handoff stays outside,
so remat never re-sends stage traffic.

The gradients of the stage-replicated embedding and final norm are folded
over the stage axis by :meth:`repro_torch.train.optimizer.Adam.apply`.
A checkpoint holds the pipeline trainer's state in the flat trainer's
global layouts (:meth:`Trainer.param_shards`, ``opt_state_shards``,
``codec_state_shards``) with the stage axis in them: a stage-stacked
group leaf ``[pp, n, ...]`` (``[vpp, pp, n, ...]`` interleaved) splits
over the stage ranks, the ZeRO-1 chunks over (stage, model, data).
``pp == 1`` is plain gradient accumulation over ``n_micro`` microbatches.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.analysis.roofline import pipeline_ticks
from repro_torch.core import comms
from repro_torch.models import layers, transformer
from repro_torch.models.model import _LB_COEF, Model, lb_term
from repro_torch.models.params import torch_dtype
from repro_torch.train.train_step import Trainer

_F32 = torch.float32


def parse_remat_policy(spec, vpp: int):
    """``--remat-policy`` spec -> ``(mode, flags, offload)`` (the
    reference's): ``mode`` is ``none`` / ``full`` / ``per_stage`` (a
    ``per_stage:`` naming every slice is ``full``, naming none ``none``),
    ``flags`` one checkpoint-this-slice boolean per virtual slice,
    ``offload`` the ``+offload`` suffix."""
    if spec is None or spec == "none":
        return "none", (False,) * vpp, False
    offload = False
    if spec.endswith("+offload"):
        offload, spec = True, spec[: -len("+offload")]
    if spec == "none":
        raise ValueError("--remat-policy none+offload: offload stashes "
                         "checkpoint residuals — it needs remat enabled")
    if spec == "full":
        return "full", (True,) * vpp, offload
    if spec.startswith("per_stage:"):
        body = spec[len("per_stage:"):]
        try:
            idx = sorted({int(tok) for tok in body.split(",") if tok != ""})
        except ValueError:
            raise ValueError(
                f"bad --remat-policy spec {spec!r}: per_stage wants a "
                "comma list of virtual-stage indices, e.g. per_stage:0,2"
            ) from None
        bad = [i for i in idx if not 0 <= i < vpp]
        if bad:
            raise ValueError(f"--remat-policy {spec!r}: virtual stage(s) "
                             f"{bad} out of range for vpp={vpp}")
        flags = tuple(i in idx for i in range(vpp))
        if all(flags):
            return "full", flags, offload
        if not any(flags):
            return "none", flags, False
        return "per_stage", flags, offload
    raise ValueError(f"unknown --remat-policy {spec!r} (expected none | "
                     "full | per_stage:<v,v,...>, optionally +offload)")


def _remat_wrap(fn, offload: bool):
    """A stage body under the remat policy: checkpointed
    (:func:`repro_torch.core.comms.checkpointed`, which a remat'd layer
    group's layers also run under), or with ``offload`` its saved
    activations parked in pinned host memory."""
    if offload:
        def parked(*args):
            with torch.autograd.graph.save_on_cpu(pin_memory=True):
                return fn(*args)
        return parked
    return comms.checkpointed(fn)


def _stage_body(model: Model, params, x, pos, v=None, pos3=None,
                cross=None, cross_pos=None):
    """One tick's layers -> (y, MoE aux or ``None``): the rank's chunk on a
    stage mesh, the whole decoder on a flat one (``pp == 1`` gradient
    accumulation, which alone takes M-RoPE ids ``pos3`` and an encoder's
    output ``cross`` / ``cross_pos``)."""
    if model.mi.pp > 1:
        return model.run_stage(params, x, pos, v)
    x, _, aux = model.run_decoder(params, x, pos, pos3=pos3, cross=cross,
                                  cross_pos=cross_pos)
    return x, aux


def pipeline_loss_fn(model: Model, n_micro: int, remat_policy=None):
    """The microbatched 1F1B loss: ``(params, batch) -> (loss, metrics,
    handoffs)``, ``loss`` the global-mean token cross-entropy (replicated
    on every rank) and ``handoffs`` every stage handoff's output, which
    the backward takes as roots with a zero cotangent (see the module
    docstring).  ``model.vpp > 1`` selects the interleaved schedule;
    ``remat_policy`` is a :func:`parse_remat_policy` spec."""
    cfg, mi = model.cfg, model.mi
    pp, M, V = mi.pp, n_micro, model.vpp
    if pp > 1 and (cfg.encoder_layers or cfg.mrope):
        raise ValueError(
            "encoder / vision inputs are not pipelineable (cross-stage "
            "context) — pp=1 gradient accumulation supports them")
    if V > 1:
        if pp == 1:
            raise ValueError("vpp > 1 (interleaved virtual stages) needs "
                             "pp > 1")
        if M % pp:
            raise ValueError(
                f"interleaved 1F1B needs n_micro divisible by pp (n_micro="
                f"{M}, pp={pp}) — the round-robin decode walks "
                "microbatches in groups of pp")
    rmode, rflags, roffload = parse_remat_policy(remat_policy, V)
    T = pipeline_ticks(pp, M, V)
    stage_ax = mi.stage_axes
    sidx = stage_ax.index if pp > 1 else 0
    handoff = comms.site("pp", "stage_handoff")

    def run(p, x, pos, v=None, pos3=None, cross=None, cross_pos=None):
        return _stage_body(model, p, x, pos, v, pos3, cross, cross_pos)
    ckpt = _remat_wrap(run, roffload)

    def clip(i, hi):
        return min(max(i, 0), hi - 1)

    def decode(t):
        """(microbatch embedded, microbatch whose labels drain, virtual
        slice, takes the embedding, drains into the loss, checkpoints its
        body, holds a real microbatch) of this rank at tick ``t``."""
        if V == 1:
            # stage 0 embeds microbatch t; the last stage drains t - (pp-1)
            return (clip(t, M), clip(t - (pp - 1), M), None, sidx == 0,
                    t >= pp - 1 and sidx == pp - 1, rflags[0],
                    sidx <= t < sidx + M)
        u = t - sidx
        live = 0 <= u < M * V
        uc = clip(u, M * V)
        r, v = uc % pp, (uc % (pp * V)) // pp
        m = (uc // (pp * V)) * pp + r
        # keyed on the tick (stage 0's slice), never on this rank's slice
        vtick = (clip(t, M * V) % (pp * V)) // pp
        return (m, m, v, sidx == 0 and v == 0,
                live and v == V - 1 and sidx == pp - 1,
                rmode == "full" or (rmode == "per_stage" and rflags[vtick]),
                live)

    def loss_fn(params, batch):
        B, S = batch["tokens"].shape
        if B % M:
            raise ValueError(f"local batch {B} not divisible by {M} "
                             "microbatches")
        mb = {k: v.reshape((M, B // M) + v.shape[1:])
              for k, v in batch.items()}
        # S is the cp-local slice already; _positions maps the tp
        # sub-slice to its global zigzag positions
        s_loc = S // mi.tp if mi.tp > 1 else S
        pos = model._positions(B // M, s_loc)
        dev = model.device
        y = torch.zeros((B // M, s_loc, cfg.d_model),
                        dtype=torch_dtype(cfg.dtype), device=dev)
        num = torch.zeros((), dtype=_F32, device=dev)
        den = torch.zeros((), dtype=_F32, device=dev)
        aux = transformer.zero_aux(dev)
        handoffs = []
        first = {b: torch.tensor(b, device=dev) for b in (False, True)}
        facts = comms.scope_facts(vpp=V) if pp > 1 \
            else contextlib.nullcontext()
        with facts:
            for t in range(T):
                m, m_lab, v, takes_embed, drains, remat, live = decode(t)
                # 1. handoff: the previous tick's output moves one stage on
                if pp > 1:
                    send = comms.stage_send if V == 1 \
                        else comms.stage_ring_send
                    recv = send(y, stage_ax, handoff)
                    if recv.requires_grad:
                        handoffs.append(recv)
                # 2. the embedded microbatch, taken by the first chunk only
                with torch.set_grad_enabled(takes_embed and
                                            torch.is_grad_enabled()):
                    e = model._embed_input(params, {k: val[m] for k, val
                                                    in mb.items()})
                x_in = torch.where(first[takes_embed], e, recv) \
                    if pp > 1 else e
                # the encoder over this microbatch's frames (pp == 1 only,
                # refused above), outside the remat policy as in the
                # reference
                cross = cross_pos = None
                if cfg.encoder_layers:
                    cross, cross_pos = model.encode(params, mb["frames"][m])
                # 3. this tick's layers, under the remat policy
                pos3 = mb["pos3"][m] if cfg.mrope and "pos3" in mb else None
                y, aux_t = (ckpt if remat else run)(params, x_in, pos, v,
                                                    pos3, cross, cross_pos)
                # the aux counts the ticks that hold a real microbatch
                if live:
                    aux = transformer.add_aux(aux, aux_t)
                # 4. drain: head and cross-entropy; the ticks that do not
                #    drain run them for their collectives alone
                with torch.set_grad_enabled(drains and
                                            torch.is_grad_enabled()):
                    logits = model.head(params, y)
                    ltok, w = layers.vocab_parallel_xent(
                        logits, mb["labels"][m_lab], cfg, mi)
                    del logits
                    if drains:
                        num = num + ltok.sum()
                        den = den + w.sum()
        # fold the per-stage partials (the last stage holds them), then
        # the batch and cp axes and the model axes as the flat loss does
        if pp > 1:
            num = comms.raw_psum(num, mi.sp_axes, local_bwd=True)
            den = comms.raw_psum(den, mi.sp_axes, local_bwd=True)
            if cfg.n_experts:
                aux = {k: comms.raw_psum(a, mi.sp_axes, local_bwd=True)
                       for k, a in aux.items()}
        num = comms.raw_psum(num, mi.batch_cp_axes)
        den = comms.raw_psum(den, mi.batch_cp_axes)
        num = comms.raw_psum(num, mi.tp_axes, mean=True)
        den = comms.raw_psum(den, mi.tp_axes, mean=True)
        loss = num / torch.clamp(den, min=1.0)
        metrics = {"xent": loss.detach(), "tokens": den.detach()}
        if cfg.n_experts:
            lb, drop = lb_term(aux, mi, M)
            loss = loss + _LB_COEF * lb
            metrics.update(lb_loss=lb.detach(), drop_frac=drop)
        return loss, metrics, handoffs

    return loss_fn


class PipelineTrainer(Trainer):
    """:class:`~repro_torch.train.train_step.Trainer` running the
    microbatched 1F1B schedule (interleaved when the model was built with
    ``vpp > 1``); on a stage-free mesh it is plain gradient accumulation
    over ``n_micro`` microbatches."""

    def __init__(self, model: Model, scheme="baseline", opt_cfg=None,
                 n_micro: int = 1, ring_bidir: bool = False,
                 ring_chunks: int = 1, remat_policy=None,
                 tune: bool = False):
        super().__init__(model, scheme=scheme, opt_cfg=opt_cfg,
                         ring_bidir=ring_bidir, ring_chunks=ring_chunks,
                         tune=tune)
        # fails here on a bad spec or schedule
        self.loss_fn = pipeline_loss_fn(model, n_micro, remat_policy)

    def _loss_and_grads(self, params, batch, ts):
        loss, metrics, handoffs = self.loss_fn(params, batch)
        roots = ([loss] if loss.requires_grad else []) + handoffs
        cots = [None if r is loss else torch.zeros_like(r) for r in roots]
        grads = torch.autograd.grad(roots, ts, grad_outputs=cots,
                                    allow_unused=True)
        return loss, metrics, [torch.zeros_like(t) if g is None else g
                               for g, t in zip(grads, ts)]
