"""The training step (port of ``repro.train.train_step``).

One step = forward -> backward under the compiled plan and the ring
options -> the optimizer's compressed ZeRO-1 sync and update, inside a
``comms.codec_state_io`` region that threads the carried state of stateful
codecs (``ef:*``, ``plr*``).  PyTorch runs it eagerly, so the reference's
``jit``, ``shard_map`` and buffer donation have no counterpart: each rank
runs the step on its own shards, and the optimizer updates the parameter
tensors in place.

A trainer built with ``tune`` also runs :meth:`Trainer.step_tuned`: the
optimizer's DP gradient sync sites (:meth:`Trainer.tune_sites`) dispatch
on the host rung indices of a ``tune_state`` (``comms.tune_io``) and
accumulate the self-tuning controller's signals
(:mod:`repro_torch.tune`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import comms
from repro_torch.core import policy as policy_lib
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BLOCK
from repro_torch.models.model import Model
from repro_torch.models.params import (defs, leaves, local_index,
                                       local_shape, map_leaves, torch_dtype,
                                       writes_replica)
from repro_torch.train.checkpoint import Pv, Shard, take, whole
from repro_torch.train.optimizer import Adam, AdamConfig, _leaf_class


def zigzag_seq_indices(cp: int, S: int):
    """Global sequence order whose contiguous cp-sharding yields the
    zigzag (causal load-balanced) chunks: rank i owns half-chunks i and
    2cp-1-i of length S/(2cp).  Matches ``Model._positions`` exactly —
    ``indices[r * S//cp + j]`` is the global position of cp rank r's
    j-th local token."""
    assert S % (2 * cp) == 0, \
        f"seq len {S} must divide 2*cp={2 * cp} for zigzag cp sharding"
    c = S // (2 * cp)
    parts = []
    for i in range(cp):
        parts.append(np.arange(i * c, (i + 1) * c))
        parts.append(np.arange((2 * cp - 1 - i) * c, (2 * cp - i) * c))
    return np.concatenate(parts)


def zigzag_shard_seq(batch: dict, cp: int) -> dict:
    """Host-side seq permutation of tokens/labels for a cp mesh (identity
    when cp == 1).  Labels ride the same permutation, so each position
    keeps its own next-token target."""
    if cp <= 1:
        return batch
    idx = zigzag_seq_indices(cp, batch["tokens"].shape[1])
    out = dict(batch)
    for key in ("tokens", "labels"):
        out[key] = batch[key][:, idx]
    return out


def _parts(tree, shards):
    """This rank's parts of the global numpy leaves of ``tree`` (the
    reference's layout), as the :class:`Shard` leaves of ``shards`` name
    them; ``None`` in ``shards`` is no leaf."""
    if shards is None:
        return None
    if isinstance(shards, dict):
        return {k: _parts(tree[k], v) for k, v in shards.items()}
    if isinstance(shards, list):
        return [_parts(t, v) for t, v in zip(tree, shards)]
    a = np.asarray(tree)
    if tuple(a.shape) != tuple(shards.shape):
        raise ValueError(f"global leaf of shape {a.shape}, this layout "
                         f"wants {tuple(shards.shape)}")
    return take(a, shards)


class Trainer:
    """Step and init for (model, policy, optimizer).  ``scheme`` is
    anything :func:`~repro_torch.core.policy.compile_plan` accepts; it is
    compiled against the model's mesh once here."""

    def __init__(self, model: Model, scheme="baseline",
                 opt_cfg: AdamConfig | None = None, ring_bidir: bool = False,
                 ring_chunks: int = 1, tune: bool = False):
        self.model = model
        self.policy = policy_lib.as_policy(scheme)
        self.plan = self.policy.compile(model.mi)
        self.ring_bidir = ring_bidir
        self.ring_chunks = ring_chunks
        self.tune = bool(tune)
        self.opt = Adam(opt_cfg or AdamConfig(), model.mi, model.plan)
        # device bytes allocated when the last flat step's forward ended
        # (what the backward starts from); None off the card
        self.fwd_allocated = None

    # ------------------------------------------------------------------
    # codec state
    # ------------------------------------------------------------------
    def codec_sites(self) -> list:
        """The carried-state-capable comm sites of the step, with their
        per-rank payload shapes: on a ``--nodes`` mesh the node fold of
        each class-A (ZeRO-3) leaf's gradient (``dp_outer@grad_fsdp{i}``,
        the leaf's local shape), on a multi-pod mesh its pod fold
        (``dp@grad_fsdp{i}_pod``), the cp fold of the whole gradient, the tp
        class-C gradient fold, the pp fold of the stage-replicated leaves
        and the flat ZeRO-1 dp/zero sync, one chain per grad-sync bucket,
        in the reference's order.  A fold over a node-factored pair
        has a slot per level (the whole payload inner, its padded
        ``1/n_inner`` chunk outer, as :func:`comms._stateful_hier_psum`
        reads them), and so has the DP sync of a ``--nodes`` mesh (the
        reduce-scatter inner, the chunk's all-reduce outer, the param
        gather inner), and so has a multi-pod mesh's (the chunk's pod
        all-reduce, ``dp@zero1_grad{b}_pod``).  Mirrors :meth:`Adam.apply`
        (site names, levels and payload sizes), as the reference's
        ``Trainer.codec_sites`` does."""
        mi = self.model.mi
        local = [(math.prod(local_shape(d, mi)), _leaf_class(d.spec))
                 for d in defs(self.model.plan)]
        f32 = torch.float32
        sites = []
        for i, d in enumerate(defs(self.model.plan)):
            if _leaf_class(d.spec) != "A":
                continue
            if mi.node > 1:
                sites.append((comms.Site("dp", f"grad_fsdp{i}",
                                         level="outer"),
                              local_shape(d, mi), f32))
            if mi.pod > 1:
                sites.append((comms.Site("dp", f"grad_fsdp{i}_pod"),
                              local_shape(d, mi), f32))
        folds = []
        if mi.cp > 1:
            folds.append(("cp", "grad_seq_rep", mi.cp_axes,
                          sum(n for n, _ in local)))
        n_c = sum(n for n, c in local if c == "C")
        if mi.tp > 1:
            folds.append(("tp", "grad_rep", mi.tp_axes, n_c))
        # the stage-replicated leaves' fold over the stage axis
        n_s = sum(n for (n, c), d in zip(local, defs(self.model.plan))
                  if c != "A" and "stage" not in d.spec)
        if mi.pp > 1:
            folds.append(("pp", "grad_stage_rep", mi.stage_axes, n_s))
        for dim, name, axes, elems in folds:
            if not elems:
                continue
            if isinstance(axes, comms.AxisPair):
                cl = ops.padded_rows(-(-elems // axes.inner.size)) * BLOCK
                sites.append((comms.Site(dim, name, "bwd", level="inner"),
                              (elems,), f32))
                sites.append((comms.Site(dim, name, "bwd", level="outer"),
                              (cl,), f32))
            else:
                sites.append((comms.Site(dim, name, "bwd"), (elems,), f32))
        hier = mi.node > 1
        lvl = "inner" if hier else None
        bucketed = self.opt.cfg.grad_buckets > 1
        for b, (lo, hi) in enumerate(self.opt._bucket_bounds(
                sum(n for n, c in local if c != "A"))):
            sfx = str(b) if bucketed else ""
            cl = self.opt._chunk_len(hi - lo)
            sites.append((comms.Site("dp", f"zero1_grad{sfx}", level=lvl),
                          (hi - lo,), f32))
            if hier:
                sites.append((comms.Site("dp", f"zero1_grad{sfx}",
                                         level="outer"), (cl,), f32))
            if mi.pod > 1:
                sites.append((comms.Site("dp", f"zero1_grad{sfx}_pod"),
                              (cl,), f32))
            sites.append((comms.Site("zero", f"zero1_param{sfx}", level=lvl),
                          (cl,), f32))
        return sites

    def codec_state_template(self) -> dict:
        """``{ledger_tag: state}`` with each leaf as ``(shape, dtype)``;
        empty for stateless policies.  A tuned trainer adds (or widens) a
        union slot per tunable site: the error-feedback residual AND the
        warm low-rank factor, so every rung's state is live whichever rung
        the controller selects."""
        tmpl = self.plan.codec_state_template(self.codec_sites())
        if self.tune:
            tmpl = {**tmpl, **self._tune_union_template()}
        return tmpl

    def init_codec_state(self) -> dict:
        """This rank's initial codec state on the model's device: zero
        residuals for error feedback, the deterministic warm factor for
        plr (identical on every rank).  Its slots come from the same
        ``plan.stateful_sites`` resolution as the template, and a tuned
        trainer's union slots from :meth:`tune_sites`."""
        dev = self.model.device
        out = {key: c.init_state(shape, dtype, dev)
               for key, (c, shape, dtype) in
               self.plan.stateful_sites(self.codec_sites()).items()}
        if self.tune:
            from repro_torch.kernels import lowrank
            from repro_torch.tune import ladder
            for key, (s, elems) in self.tune_sites().items():
                _, ncols = lowrank.mat_shape(elems)
                out[key] = {
                    "residual": torch.zeros((elems,), dtype=torch.float32,
                                            device=dev),
                    "q": lowrank.init_factor(
                        ncols, lowrank.rank_for(elems, ladder.PLR_MAX_RANK),
                        dev)}
        return out

    # ------------------------------------------------------------------
    # runtime-tunable sites (the self-tuning controller's swap surface)
    # ------------------------------------------------------------------
    def tune_sites(self) -> dict:
        """``{ledger_tag: (Site, per_rank_elems)}`` of the runtime-tunable
        sites: the flat ZeRO-1 DP gradient sync chain (``dp@zero1_grad{b}``,
        or ``dp_inner@`` and ``dp_outer@`` on a ``--nodes`` mesh), the
        paper's aggressive-DP compression target.  Only sum collectives
        over axes larger than 1 qualify; the param gather stays on its
        plan-static codec, and so does a multi-pod mesh's pod hop.  As the
        reference's."""
        mi = self.model.mi
        n = sum(math.prod(local_shape(d, mi)) for d in defs(self.model.plan)
                if _leaf_class(d.spec) != "A")
        hier = mi.node > 1
        bucketed = self.opt.cfg.grad_buckets > 1
        out = {}
        for b, (lo, hi) in enumerate(self.opt._bucket_bounds(n)):
            sfx = str(b) if bucketed else ""
            if mi.dp > 1:
                s = comms.Site("dp", f"zero1_grad{sfx}",
                               level="inner" if hier else None)
                out[s.ledger_tag] = (s, hi - lo)
            if hier:
                s = comms.Site("dp", f"zero1_grad{sfx}", level="outer")
                out[s.ledger_tag] = (s, self.opt._chunk_len(hi - lo))
        return out

    def _tune_union_template(self) -> dict:
        from repro_torch.kernels import lowrank
        from repro_torch.tune import ladder
        out = {}
        for key, (s, elems) in self.tune_sites().items():
            _, ncols = lowrank.mat_shape(elems)
            r = lowrank.rank_for(elems, ladder.PLR_MAX_RANK)
            out[key] = {"residual": ((elems,), torch.float32),
                        "q": ((ncols, r), torch.float32)}
        return out

    def init_tune_state(self) -> dict:
        """``{"select", "sig"}``: each site's rung index (a host ``int``)
        seeded from the compiled plan's own resolution at the site (a
        tuned run starts where its static scheme stands), and its zeroed
        signal accumulator on the model's device."""
        from repro_torch.tune import ladder, tracker
        sel, sig = {}, {}
        for key, (s, elems) in self.tune_sites().items():
            c = self.plan.codec_pair(s, elems * 4)[0].name
            sel[key] = ladder.rung_or_default(c)
            sig[key] = torch.zeros((tracker.SIG_LEN,), dtype=torch.float32,
                                   device=self.model.device)
        return {"select": sel, "sig": sig}

    def tune_state_shards(self, state=None) -> dict:
        """The tune state as the reference's global leaves (its
        ``tune_structs``): replicated, so each leaf is whole on every rank
        and rank 0 writes it; ``select`` an int32 scalar, ``sig`` f32
        ``[SIG_LEN]``.  :meth:`tune_state_from_shards` reads them back."""
        from repro_torch.tune import tracker
        lead = self.model.mi.all_axes.index == 0
        dev = self.model.device

        def leaf(shape, dtype, v):
            return Shard(shape, whole(shape), dtype, v, lead, dev)
        out = {"select": {}, "sig": {}}
        for key in self.tune_sites():
            sel = None if state is None else torch.tensor(
                state["select"][key], dtype=torch.int32)
            out["select"][key] = leaf((), torch.int32, sel)
            out["sig"][key] = leaf((tracker.SIG_LEN,), torch.float32,
                                   None if state is None else
                                   torch.as_tensor(state["sig"][key],
                                                   dtype=torch.float32))
        return out

    @staticmethod
    def tune_state_from_shards(tree: dict) -> dict:
        """The tune state from :meth:`tune_state_shards`' restored leaves
        (each ``select`` a Python int again)."""
        return {"select": {k: int(v) for k, v in tree["select"].items()},
                "sig": dict(tree["sig"])}

    def codec_state_shards(self, state=None) -> dict:
        """The codec state as the reference's global leaves (its
        ``codec_structs``): every slot stacks each rank's along dim 0 in
        the order of ``MeshInfo.all_axes`` (pod, node, data, cp, stage, model,
        the factored ones joint), which is the global rank here.  Each leaf
        is a :class:`~repro_torch.train.checkpoint.Shard` holding this
        rank's part (of ``state``, when given)."""
        mi = self.model.mi
        world, r = mi.all_axes.size, mi.all_axes.index

        def walk(t, w):
            if isinstance(w, dict):
                return {k: walk(None if t is None else t[k], w[k])
                        for k in w}
            (n, *tail), dtype = w
            return Shard((world * n, *tail),
                         (slice(r * n, (r + 1) * n), *whole(tail)), dtype, t,
                         True, self.model.device)
        tmpl = self.codec_state_template()
        return {k: walk(None if state is None else state[k], tmpl[k])
                for k in tmpl}

    def codec_state_from_jax(self, tree: dict) -> dict:
        """This rank's codec state from the reference's (numpy leaves, the
        global layout of :meth:`codec_state_shards`)."""
        shards = self.codec_state_shards()
        if sorted(tree) != sorted(shards):
            raise KeyError(f"codec-state slots {sorted(tree)} do not match "
                           f"this trainer's {sorted(shards)}")
        return _parts(tree, shards)

    # ------------------------------------------------------------------
    # the global layouts a checkpoint holds
    # ------------------------------------------------------------------
    def param_shards(self, params=None) -> dict:
        """The parameters as the reference's global ``Pv`` leaves: each a
        :class:`~repro_torch.train.checkpoint.Shard` of the plan's shape
        holding this rank's shard (of ``params``, when given), written by
        the first replica, with the leaf's logical spec."""
        mi, dev = self.model.mi, self.model.device
        return map_leaves(
            lambda d, t: Pv(Shard(d.shape, local_index(d.shape, d.spec, mi),
                                  torch_dtype(d.dtype), t,
                                  writes_replica(d.spec, mi), dev), d.spec),
            self.model.plan, params)

    def opt_state_shards(self, state=None) -> dict:
        """The optimizer state as the reference's global leaves
        (:meth:`Adam.state_shards`)."""
        return self.opt.state_shards(state, self.model.device)

    def params_from_master(self, params, opt_state) -> bool:
        """Re-derive ``params`` in place from a restored optimizer state's
        master chunks, as the last step derived them, and say whether it
        did.  A replicated leaf's replicas need not agree bit for bit
        (class-C leaves sum their gradient through a lossy all-reduce on
        each tp rank), and a checkpoint keeps one, so this is what makes
        a resume on the same layout continue bit for bit.  On a
        ``--nodes`` mesh the gather runs over the inner data axis from the
        node's replica of the chunks (hpZ), as the step's does.  Untouched
        when the state has taken no step (the params never came out of the
        gather) or the gather carries codec state (``ef:*`` at a ZeRO
        site: its residual has moved on)."""
        stateful = self.plan.stateful_sites(self.codec_sites())
        if not opt_state["step"] or any(k.startswith(("zero@", "zero_"))
                                        for k in stateful):
            return False
        with policy_lib.use_plan(self.plan), \
                comms.ring_options(self.ring_bidir, self.ring_chunks):
            self.opt.gather_params(params, opt_state["master"])
        return True

    def opt_state_from_jax(self, tree: dict) -> dict:
        """This rank's optimizer state from the reference's (numpy
        leaves): its slice of each flat chunk and the step."""
        return Adam.state_from_shards(_parts(tree, self.opt_state_shards()))

    # ------------------------------------------------------------------
    def init_all(self, seed: int):
        """``(params, opt_state, codec_state)`` of this rank; the codec
        state is ``{}`` under stateless policies."""
        params = self.model.init(seed)
        return params, self.opt.init(params), self.init_codec_state()

    def _loss_and_grads(self, params, batch, ts):
        """(loss, metrics, the gradients of ``ts`` as a list)."""
        loss, metrics = self.model.loss_fn(params, batch)
        if loss.device.type == "cuda":
            self.fwd_allocated = torch.cuda.memory_allocated(loss.device)
        return loss, metrics, list(torch.autograd.grad(loss, ts))

    def step(self, params, opt_state, codec_state, batch):
        """One training step; ``params`` are updated in place, and so are
        the codec state's residual buffers.  Returns ``(params, opt_state,
        codec_state, metrics)``."""
        out = self._step(params, opt_state, codec_state, batch, None)
        return out[:3] + out[4:]

    def step_tuned(self, params, opt_state, codec_state, tune_state, batch):
        """One step of a ``tune`` trainer: :meth:`step` with the DP sync
        sites dispatching on ``tune_state["select"]`` and adding to its
        signal accumulators (``comms.tune_io`` inside the codec-state
        region).  Returns ``(params, opt_state, codec_state, tune_state,
        metrics)``; the new ``tune_state`` keeps the same ``select``."""
        if not self.tune:
            raise RuntimeError("step_tuned needs a trainer built with tune")
        return self._step(params, opt_state, codec_state, batch, tune_state)

    def _step(self, params, opt_state, codec_state, batch, tune_state):
        ts = [t for _, t in leaves(self.model.plan, params)]
        with policy_lib.use_plan(self.plan), \
                comms.ring_options(self.ring_bidir, self.ring_chunks):
            for t in ts:
                t.requires_grad_(True)
            try:
                loss, metrics, grads = self._loss_and_grads(params, batch, ts)
            finally:
                for t in ts:
                    t.requires_grad_(False)
            # the optimizer's sync sites read and write their codec-state
            # slots in this region; everything the model emits under
            # autodiff stays stateless (guarded in comms)
            with comms.codec_state_io(codec_state) as cio:
                if tune_state is None:
                    opt_state, stats = self.opt.apply(params, grads,
                                                      opt_state)
                else:
                    with comms.tune_io(tune_state["select"],
                                       tune_state["sig"],
                                       axis=self.model.mi.all_axes) as tio:
                        opt_state, stats = self.opt.apply(params, grads,
                                                          opt_state)
                    tune_state = {"select": dict(tune_state["select"]),
                                  "sig": tio.collect()}
            codec_state = cio.collect()
        return params, opt_state, codec_state, tune_state, \
            {"loss": loss.detach(), **metrics, **stats}


def make_trainer(model: Model, scheme="baseline",
                 opt_cfg: AdamConfig | None = None, n_micro: int = 1,
                 ring_bidir: bool = False, ring_chunks: int = 1,
                 remat_policy: str | None = None,
                 tune: bool = False) -> Trainer:
    """The flat step, or the microbatched 1F1B pipeline trainer when the
    mesh has a stage axis, the batch splits into microbatches or a remat
    policy is set (a model built with ``vpp > 1`` runs the interleaved
    schedule).  ``tune`` adds :meth:`Trainer.step_tuned`, the step whose
    DP sync sites dispatch on the rung indices of a ``tune_state``."""
    if model.mi.pp > 1 or n_micro > 1 or remat_policy not in (None, "none"):
        from repro_torch.train.pipeline import PipelineTrainer
        return PipelineTrainer(model, scheme=scheme, opt_cfg=opt_cfg,
                               n_micro=n_micro, ring_bidir=ring_bidir,
                               ring_chunks=ring_chunks,
                               remat_policy=remat_policy, tune=tune)
    return Trainer(model, scheme=scheme, opt_cfg=opt_cfg,
                   ring_bidir=ring_bidir, ring_chunks=ring_chunks, tune=tune)
