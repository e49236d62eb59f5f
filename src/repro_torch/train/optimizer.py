"""Adam with ZeRO-1 sharded optimizer state and compressed gradient sync
(port of ``repro.train.optimizer``).

Gradient classes, routed by each leaf's sharding spec (read from the
plan):

  A. fsdp ("data" in spec, ZeRO-3 leaves): the backward of the leaf's
     all-gather (``layers.use``) already reduce-scattered its gradient
     over data under the *ZeRO* codec, so the local shard updates
     directly: an all-reduce over the model axis under the *tp_bwd*
     codec for a leaf that is not model-sharded (``tp_bwd@grad_fsdp``),
     on a ``--nodes`` mesh one over the node axis per leaf
     (``dp_outer@grad_fsdp{i}``, ``i`` the leaf's index, so a stateful
     dp codec keeps one slot per leaf), on a multi-pod mesh one over the
     pod axis per leaf (``dp@grad_fsdp{i}_pod``), then Adam on f32 ``{master, m,
     v}`` held at the leaf's own sharding (never bq8, never bucketed),
     scaled by the shared clip.
  B. model-sharded (TP/vocab): per-data-shard partial grads -> one flat
     reduce-scatter over data under the *DP* codec, a ZeRO-1 chunk update,
     an all-gather of the params back under the *ZeRO* codec.
  C. replicated (norms, ring-mode attention weights): first an all-reduce
     over the model axis under the *tp_bwd* codec (paper §III-A: MP
     gradients take the MP codec), then class B's flat DP path.

On a cp mesh every leaf's gradient is partial per cp rank (each holds a
slice of the sequence), so the whole gradient folds over the cp axes
first, as one flat f32 all-reduce under the *cp_bwd* codec (site
``cp@grad_seq_rep``), and the ZeRO-1 state is replicated over cp.
On a pipeline mesh the stage-replicated leaves (embedding, final norm)
hold one partial gradient per stage, folded over the stage axis under the
*pp_bwd* codec (site ``pp@grad_stage_rep``); ZeRO-1 shards each stage
rank's own flat vector over data only.  On a ``--nodes`` mesh the DP
sync has two levels, as the reference's (ZeRO++ hpZ): a reduce-scatter
over the inner data axis (site ``dp_inner@zero1_grad``), an all-reduce of
that chunk over the node axis (``dp_outer@zero1_grad``), the update, and
the param gather over the inner data axis (``zero_inner@zero1_param``):
the master chunks are replicated per node.  On a multi-pod mesh the chunk
that the data reduce-scatter leaves is all-reduced over the outer pod axis
(``dp@zero1_grad{b}_pod``) before the update, and the master chunks are
replicated per pod.  On a ``--tp-nodes`` or
``--pp-nodes`` mesh the tp and stage folds are two-level all-reduces over
their pairs.  The global grad-norm clip sums each class's squares divided
by its replication factor over the whole world, uncompressed, as the
reference does.  ``state_bits=8`` keeps m
and v as bq8 wire planes (encode/decode on the bq kernels).  ``grad_buckets > 1`` splits the flat sync into that many
reduce-scatter / all-gather chains and applies the clip after the sync.

The sync sites are named as in the reference (``tp_bwd@grad_rep``,
``dp@zero1_grad{b}``, ``zero@zero1_param{b}``), so a policy may put a
carried-state codec (``ef:*``, ``plr*``) on any of them; the trainer binds
their state around :meth:`Adam.apply` (``comms.codec_state_io``).

Unlike the reference, whose arrays are immutable, :meth:`Adam.apply`
writes the new parameters into the parameter tensors in place, builds the
flat gradient straight from the per-leaf gradients, and donates it to the
DP sync (error feedback compensates into it): at gemma3-1b's width each
saves a full copy of the rank's parameters or gradient.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import comms
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BLOCK
from repro_torch.models.params import (MeshInfo, defs, leaves, local_index,
                                       local_shape, writes_replica)
from repro_torch.train.checkpoint import Shard, whole

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    state_bits: int = 32            # 8 -> bq8-quantized m/v
    warmup: int = 10
    grad_buckets: int = 1


def _leaf_class(spec: tuple) -> str:
    if "data" in spec:
        return "A"
    if "model" in spec:
        return "B"
    return "C"


def _flat_concat(ts, scale=None) -> torch.Tensor:
    """Concatenate tensors into one f32 vector, each optionally multiplied
    by ``scale`` in its own dtype first (the reference's cast points)."""
    n = sum(t.numel() for t in ts)
    dev = ts[0].device if ts else "cpu"
    out = torch.empty(n, dtype=_F32, device=dev)
    off = 0
    for t in ts:
        v = t if scale is None else t * scale.to(t.dtype)
        out[off:off + t.numel()] = v.reshape(-1)
        off += t.numel()
    return out


def _fold(grads: list, idx: list, axis, site) -> None:
    """All-reduce the gradients ``grads[i]``, ``i`` in ``idx``, over
    ``axis`` at ``site`` as one flat f32 vector; each is replaced by its
    slice of the sum."""
    flat = comms.psum(_flat_concat([grads[i] for i in idx]), axis, site)
    off = 0
    for i in idx:
        n = grads[i].numel()
        grads[i] = flat[off:off + n].reshape(grads[i].shape)
        off += n


def _lr_at(cfg: AdamConfig, step: int, device) -> torch.Tensor:
    warm = torch.clamp(torch.tensor(step, dtype=_F32, device=device)
                       / max(cfg.warmup, 1), max=1.0)
    return cfg.lr * warm


class Adam:
    """ZeRO-1 Adam over this rank's shards; ``plan`` is the model's plan
    (leaf order and specs)."""

    def __init__(self, cfg: AdamConfig, mi: MeshInfo, plan):
        self.cfg = cfg
        self.mi = mi
        self.plan = plan
        self.keep_flat_grad = False   # stash the pre-sync flat gradient
        self.last_flat_grad = None

    def _split(self, tree):
        ls = leaves(self.plan, tree)
        return [t for _, t in ls], [_leaf_class(d.spec) for d, _ in ls]

    def _flat_leaves(self, tree) -> list:
        """The leaves of the flat ZeRO-1 vector: classes B and C."""
        ts, classes = self._split(tree)
        return [t for t, c in zip(ts, classes) if c != "A"]

    def _stage_rep(self) -> list:
        """Whether each leaf is stage-replicated (on a stage mesh, every
        leaf but the stage-stacked layer groups; class A shards only
        group leaves, which are stage-stacked)."""
        return [self.mi.pp > 1 and "stage" not in d.spec
                and _leaf_class(d.spec) != "A" for d in defs(self.plan)]

    # ------------------------------------------------------------------
    def _chunk_len(self, n: int) -> int:
        """Length of this shard's ZeRO-1 flat chunk (matches
        comms.reduce_scatter_flat's padding)."""
        return ops.padded_rows(-(-n // self.mi.dp)) * BLOCK

    def _bucket_bounds(self, n: int) -> list:
        k = max(1, min(self.cfg.grad_buckets, n or 1))
        base, rem = divmod(n, k)
        bounds, at = [], 0
        for i in range(k):
            ln = base + (1 if i < rem else 0)
            bounds.append((at, at + ln))
            at += ln
        return bounds

    def init(self, params) -> dict:
        """This data shard's slice of the flat params (per grad-sync
        bucket), zero moments and the step; each class-A leaf's f32
        ``{master, m, v}`` at its own sharding under ``fsdp`` (``None``
        for the other leaves)."""
        all_ts, classes = self._split(params)
        fsdp = [{"master": t.to(_F32, copy=True),
                 "m": torch.zeros(t.shape, dtype=_F32, device=t.device),
                 "v": torch.zeros(t.shape, dtype=_F32, device=t.device)}
                if c == "A" else None for t, c in zip(all_ts, classes)]
        ts = [t for t, c in zip(all_ts, classes) if c != "A"]
        n = sum(t.numel() for t in ts)
        idx = self.mi.dp_axes.index
        dev = ts[0].device
        segs = []
        for lo, hi in self._bucket_bounds(n):
            cl = self._chunk_len(hi - lo)
            seg = torch.zeros(cl, dtype=_F32, device=dev)
            a, b = lo + idx * cl, min(lo + (idx + 1) * cl, hi)
            off = 0
            for t in ts:                      # copy flat[a:b] leaf by leaf
                s0, s1 = max(a, off), min(b, off + t.numel())
                if s0 < s1:
                    seg[s0 - a:s1 - a] = t.reshape(-1)[s0 - off:s1 - off]
                off += t.numel()
            segs.append(seg)
        master = torch.cat(segs)
        zc = torch.zeros_like(master)
        m = self._state_encode(zc)
        v = self._state_encode(zc.clone())
        return {"fsdp": fsdp, "master": master, "m": m, "v": v, "step": 0}

    def state_shards(self, state=None, device="cpu") -> dict:
        """The state as the reference's global leaves, each a
        :class:`~repro_torch.train.checkpoint.Shard` holding this rank's
        part (of ``state``, when given).  As the reference lays out its
        state (``Trainer.opt_state_specs``), a flat chunk differs on every
        rank and shards over the joint (stage, model, data) axes, data
        minor, so this rank's is chunk ``(s * tp + t) * dp + d`` of the
        global vector, stage and model joint, data inner (bq8 m and v
        likewise by rows, ``q_lo`` none); a ``--nodes`` mesh replicates
        the chunks per node, and its first node writes them, a multi-pod
        mesh per pod, and its first pod writes them, and a cp mesh
        replicates them over cp, and cp index 0 writes them; the
        ``step`` is one replicated int32.  The ``fsdp`` list holds, for
        each class-A leaf, its f32 ``{master, m, v}`` as global leaves of
        the parameter's shape sharded as the parameter is (written by the
        parameter's first replica), and ``None`` (no leaf) for the
        others."""
        mi = self.mi
        n = sum(math.prod(local_shape(d, mi)) for d in defs(self.plan)
                if _leaf_class(d.spec) != "A")
        cl = sum(self._chunk_len(hi - lo) for lo, hi in self._bucket_bounds(n))
        world = mi.dp * mi.pp * mi.tp       # the state's shards: no node
        c = mi.coords
        g = (c["stage"] * mi.tp + c["model"]) * mi.dp + c["data"]

        def chunk(rows, tail, dtype, value):
            # replicated over pods, nodes (hpZ) and cp: the ranks of the
            # first pod, the first node and cp index 0 write
            return Shard((world * rows, *tail),
                         (slice(g * rows, (g + 1) * rows), *whole(tail)),
                         dtype, value,
                         c["pod"] == 0 and c["node"] == 0 and c["cp"] == 0,
                         device)

        def moment(k):
            v = None if state is None else state[k]
            if self.cfg.state_bits != 8:
                return chunk(cl, (), _F32, v)
            v = v or {}
            return {"q_hi": chunk(cl // BLOCK, (BLOCK,), torch.int8,
                                  v.get("q_hi")),
                    "q_lo": None,
                    "scale": chunk(cl // BLOCK, (1,), _F32, v.get("scale"))}
        step = None if state is None else torch.tensor(state["step"],
                                                       dtype=torch.int32)
        fsdp = []
        for i, d in enumerate(defs(self.plan)):
            if _leaf_class(d.spec) != "A":
                fsdp.append(None)
                continue
            st = None if state is None else state["fsdp"][i]
            fsdp.append({k: Shard(d.shape, local_index(d.shape, d.spec, mi),
                                  _F32, None if st is None else st[k],
                                  writes_replica(d.spec, mi), device)
                         for k in ("master", "m", "v")})
        return {"fsdp": fsdp, "master": chunk(cl, (), _F32,
                                None if state is None else state["master"]),
                "m": moment("m"), "v": moment("v"),
                "step": Shard((), (), torch.int32, step,
                              mi.all_axes.index == 0, device)}

    @staticmethod
    def state_from_shards(tree: dict) -> dict:
        """The state from :meth:`state_shards`' leaves, restored (the step
        a Python int again)."""
        return {**tree, "step": int(tree["step"])}

    # ------------------------------------------------------------------
    def _adam_update(self, g, m, v, master, step: int):
        """The Adam update of ``master`` from ``g``, writing ``m``, ``v``
        and ``master`` in place (the reference donates its state buffers
        to the step; the old and new state together would double the f32
        state a rank holds through the update), each in-place step
        rounding as the reference's out-of-place expression."""
        c = self.cfg
        m.mul_(c.b1).add_((1 - c.b1) * g)
        v.mul_(c.b2).add_((1 - c.b2) * g * g)
        t = torch.tensor(step + 1.0, dtype=_F32, device=g.device)
        one = torch.ones((), dtype=_F32, device=g.device)
        # the reference's expression, each temporary freed once used (the
        # in-place steps round as their out-of-place forms): at dp 1 the
        # f32 chunk is the whole model, and the update's peak is what a
        # rank needs most
        den = torch.sqrt(v / (1 - torch.pow(one * c.b2, t))).add_(c.eps)
        upd = (m / (1 - torch.pow(one * c.b1, t))).div_(den)
        del den
        if c.weight_decay:
            upd = upd + c.weight_decay * master
        return master.sub_(upd.mul_(_lr_at(c, step, g.device))), m, v

    def _state_decode(self, s):
        if self.cfg.state_bits == 8:
            return ops.bq_decode_blocks(s, 8).reshape(-1)
        return s

    def _state_encode(self, x):
        if self.cfg.state_bits == 8:
            return ops.bq_encode_blocks(x.reshape(-1, BLOCK), 8)
        return x

    # ------------------------------------------------------------------
    @torch.no_grad()
    def gather_params(self, params, master: torch.Tensor) -> None:
        """Write the parameters in place from the data group's master
        chunks: the ZeRO-1 all-gather (under the *ZeRO* codec, per
        grad-sync bucket) that ends :meth:`apply`."""
        ts = self._flat_leaves(params)
        total = sum(t.numel() for t in ts)
        lvl = "inner" if self.mi.node > 1 else None
        if self.cfg.grad_buckets <= 1:
            flat_new = comms.all_gather_flat(
                master, self.mi.dp_axes, total,
                comms.Site("zero", "zero1_param", level=lvl))
        else:
            segs, at = [], 0
            for b, (lo, hi) in enumerate(self._bucket_bounds(total)):
                cl = self._chunk_len(hi - lo)
                segs.append(comms.all_gather_flat(
                    master[at:at + cl], self.mi.dp_axes, hi - lo,
                    comms.Site("zero", f"zero1_param{b}", level=lvl)))
                at += cl
            flat_new = torch.cat(segs)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat_new[off:off + n].reshape(t.shape))
            off += n

    @torch.no_grad()
    def apply(self, params, grads: list, state: dict):
        """One update.  ``grads`` are in the plan's leaf order; the list is
        consumed (emptied once the flat gradient is built, to free it).
        Writes the new parameters into ``params`` and the new master and
        moments into ``state``'s tensors in place; returns (new state,
        stats)."""
        mi, cfg = self.mi, self.cfg
        ts, classes = self._split(params)
        step = state["step"]

        # -- the cp fold: every leaf's gradient is partial per cp rank
        # (each back-propagated only its zigzag slice of the sequence, and
        # the params are replicated over cp), so the whole gradient set
        # folds over the cp axes (cp_bwd codec, two-level on a pair)
        # before any class routing
        if mi.cp > 1:
            site = comms.Site("cp", "grad_seq_rep", "bwd")
            with comms.span(site.ledger_tag, ts[0]):
                _fold(grads, list(range(len(grads))), mi.cp_axes, site)

        # -- class C: fold the model-axis partial grads (MP codec)
        if mi.tp > 1 and "C" in classes:
            _fold(grads, [i for i, c in enumerate(classes) if c == "C"],
                  mi.tp_axes, comms.Site("tp", "grad_rep", "bwd"))

        # -- stage-replicated leaves (embedding, final norm): each stage
        # holds a partial gradient, folded over the stage axis (PP codec)
        srep = self._stage_rep()
        if any(srep):
            site = comms.Site("pp", "grad_stage_rep", "bwd")
            with comms.span(site.ledger_tag, ts[0]):
                _fold(grads, [i for i, r in enumerate(srep) if r],
                      mi.stage_axes, site)

        # -- global grad-norm clip: each class's squares over its
        # replication factor (after the cp fold every leaf is replicated
        # over cp too; stage-replicated leaves also over pp), summed over
        # the whole world
        outer = mi.pod * mi.node * mi.cp
        rep = {"A": outer, "B": mi.dp * outer, "C": mi.dp * mi.tp * outer}
        sq = torch.zeros((), dtype=_F32, device=ts[0].device)
        for g, c, r in zip(grads, classes, srep):
            sq = sq + torch.sum(g.to(_F32) ** 2) / (rep[c] * (mi.pp if r
                                                              else 1))
        sq = comms.raw_psum(sq, mi.all_axes)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)

        # -- class A (ZeRO-3): the local update.  The norm above read
        # these gradients before their model and node folds, as the
        # reference's does (a class-A leaf that is not model-sharded
        # counts each tp rank's partial gradient).
        new_fsdp = [None] * len(ts)
        for i, (t, c) in enumerate(zip(ts, classes)):
            if c != "A":
                continue
            gv = grads[i].to(_F32)
            if "model" not in defs(self.plan)[i].spec:
                gv = comms.psum(gv, mi.tp_axes,
                                comms.Site("tp", "grad_fsdp", "bwd"))
            if mi.node > 1:
                gv = comms.psum(gv, mi.node_axes,
                                comms.Site("dp", f"grad_fsdp{i}",
                                           level="outer"))
            if mi.pod > 1:
                gv = comms.psum(gv, mi.pod_axes,
                                comms.Site("dp", f"grad_fsdp{i}_pod"))
            st = state["fsdp"][i]
            master, m, v = self._adam_update(gv * scale, st["m"], st["v"],
                                             st["master"], step)
            new_fsdp[i] = {"master": master, "m": m, "v": v}
            t.copy_(master)

        # -- classes B + C: flat compressed DP reduce-scatter (ZeRO-1);
        # bucketed mode defers the clip until after the sync
        bucketed = cfg.grad_buckets > 1
        gflat = _flat_concat([g for g, c in zip(grads, classes) if c != "A"],
                             None if bucketed else scale)
        grads.clear()
        if self.keep_flat_grad:
            self.last_flat_grad = gflat
        # two levels on a (node, data) mesh: the intra-node reduce-scatter,
        # then the inter-node all-reduce of its 1/dp chunk
        hier = mi.node > 1
        chunks = []
        for b, (lo, hi) in enumerate(self._bucket_bounds(gflat.shape[0])):
            sfx = str(b) if bucketed else ""
            # the sync consumes the flat gradient (error feedback may
            # compensate into it), unless it is kept for the caller
            gc = comms.reduce_scatter_flat(
                gflat[lo:hi], mi.dp_axes,
                comms.Site("dp", f"zero1_grad{sfx}",
                           level="inner" if hier else None),
                donate=not self.keep_flat_grad)
            if hier:
                gc = comms.psum(gc, mi.node_axes,
                                comms.Site("dp", f"zero1_grad{sfx}",
                                           level="outer"))
            # multi-pod: the chunk also sums over the outer pod axis
            if mi.pod > 1:
                gc = comms.psum(gc, mi.pod_axes,
                                comms.Site("dp", f"zero1_grad{sfx}_pod"))
            chunks.append(gc)
        del gflat
        gchunk = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        del chunks
        if bucketed:
            gchunk = gchunk * scale
        m = self._state_decode(state["m"])
        v = self._state_decode(state["v"])
        master, m, v = self._adam_update(gchunk, m, v, state["master"], step)
        del gchunk
        self.gather_params(params, master)
        new_state = {"fsdp": new_fsdp, "master": master,
                     "m": self._state_encode(m),
                     "v": self._state_encode(v), "step": step + 1}
        return new_state, {"grad_norm": gnorm,
                           "lr": _lr_at(cfg, step, gnorm.device)}
