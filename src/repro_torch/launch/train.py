"""Training entry point: the compressed ZeRO-1, Megatron-SP step over a
``dp x cp x pp x tp`` world of processes.

    # on the card: gemma3-1b at full width, 4 ranks sharing it
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --dp 2 --tp 2 --scheme zhybrid_16_8 --steps 5 --seq 1024 \\
        --global-batch 4

    # on the CPU, reduced width
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --dp 2 --tp 2 --scheme zhybrid_16_8 --device cpu

    # carried-state codecs: plr8 on the DP gradient sync, or error feedback
    ... --scheme zhybrid_16_8 --codec-for 'dp@zero1_grad*=plr8'
    ... --scheme ef_zhybrid_16_4

    # checkpoints every 2 steps (params, <dir>/opt, <dir>/codec), then a
    # resume from the latest, here elastically onto dp 4 x tp 1 (the opt
    # and codec state fall back, loudly, where their layout changed)
    ... --dp 2 --tp 2 --steps 2 --ckpt-dir /tmp/ck --ckpt-every 2
    ... --dp 4 --tp 1 --steps 2 --ckpt-dir /tmp/ck --resume

    # node-factored meshes: two-level DP sync (hpZ), two-level TP
    # collectives, stage handoffs that cross a node on the outer codec
    ... --reduced --dp 4 --nodes 2 --scheme hier_zpp_8_16 --device cpu
    ... --reduced --dp 2 --tp 4 --tp-nodes 2 --scheme hier_tpp_8_16
    ... --reduced --pp 4 --pp-nodes 2 --layers 4 --microbatches 4

    # context parallelism: each cp rank holds a zigzag slice of the
    # sequence, K/V ride the cp ring (cp codecs); --cp-nodes factors it
    ... --reduced --dp 2 --cp 2 --scheme zhybrid_16_8 --device cpu
    ... --reduced --cp 4 --cp-nodes 2 --scheme hier_tpp_8_16 --device cpu

    # self-tuning compression: the DP sync sites walk the codec ladder
    # every 2 steps from hier_zpp_16_16 (<ckpt>/tune_policy.json holds the
    # accepted plan), then a static replay of that plan
    ... --reduced --dp 4 --nodes 2 --scheme hier_zpp_16_16 --tune \\
        --tune-interval 2 --steps 8 --ckpt-dir /tmp/ck --device cpu
    ... --reduced --dp 4 --nodes 2 --scheme hier_zpp_16_16 \\
        --policy-from /tmp/ck/tune_policy.json --device cpu

    # multi-pod: the outer data-parallel pod axis; the ZeRO-1 chunk of
    # the data reduce-scatter all-reduces over the pods (dp@zero1_grad_pod)
    ... --reduced --pod 2 --dp 2 --scheme zhybrid_16_8 --device cpu

    # pipeline stages: 1F1B over 2 stages, or interleaved with remat;
    # gemma3-1b's 5:1 local:global pattern does not tile into stages, so
    # --layers makes the stack uniform (global attention in every layer)
    ... --arch gemma3-1b --reduced --layers 4 --dp 2 --tp 2 --pp 2 \\
        --microbatches 2 --scheme zhybrid_16_8 --device cpu
    ... --layers 8 --pp 2 --vpp 2 --microbatches 2 \\
        --remat-policy per_stage:0

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) each process joins that
group as one rank.  Otherwise the command spawns ``pod * dp * cp * pp *
tp`` processes itself, so one command runs the step as in the reference.
Ranks exchange through ``torch.distributed``'s gloo backend: on the card,
every encode, fused ring hop and decode runs as a kernel, and only the
wire planes cross between ranks through host memory.

The flags are those of ``repro.launch.train`` for this path, plus
``--device``; ``--codec-for`` and ``--no-compress-below`` prepend policy
rules as in the reference (:func:`comm_policy`).  ``--cp`` shards the
sequence over a context-parallel axis (the host permutes each batch into
zigzag order, :func:`~repro_torch.train.train_step.zigzag_shard_seq`, and
each rank takes its contiguous ``S / cp`` slice of it).  ``--nodes``,
``--cp-nodes``, ``--tp-nodes`` and ``--pp-nodes`` (an int, or ``NxD``: N
nodes of D ranks) factor the data, cp, model and stage axes over nodes, as
the reference's do.  ``--pod`` adds the reference's outer data-parallel
axis, outermost; it excludes ``--nodes``, as in the reference.
``--tune`` runs the self-tuning controller (:mod:`repro_torch.tune`) every
``--tune-interval`` steps, with ``--tune-guard`` its loss guard;
``--policy-from`` replays a ``tune_policy.json`` as static rules ahead of
the scheme's.  An encoder-decoder (whisper-base) trains on stub frame
embeddings beside the tokens (``SyntheticCorpus.frames``: seeded normals
per step, which the reference's launcher never feeds: fault C.22);
``--cp`` on it is refused (fault C.23), and ``--pp`` with the reference's
message (its encoder context cannot cross stages).  ``--host-devices``,
an XLA host-device count with no counterpart in a world of processes, is
accepted and refused, never ignored.

Checkpoints are the reference's (:mod:`repro_torch.train.checkpoint`):
each rank writes its own shards of the global leaves, every
``--ckpt-every`` steps without blocking, and a final blocking save when
the last step has none.  ``--resume`` continues from the latest step
(the data stream continues from it too); the optimizer and codec state
restore where their global layout did not change, and otherwise
re-initialize with the reference's ``WARNING:`` lines.  Rank 0 keeps
``<ckpt>/heartbeat.json`` (:class:`~repro_torch.train.fault.StepMonitor`;
a tuned run stamps its plan hash there).  A tuned run also saves
``<ckpt>/tune/``: the tune state's arrays and the controller's
``controller.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import os
import pickle
import queue
import socket
import statistics
import sys
import time
import traceback

import torch
import torch.distributed as dist

# flags of the reference this package refuses at a non-default value:
# (attribute, default)
_UNPORTED = (("host_devices", 0),)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving smoke-size config")
    ap.add_argument("--layers", type=int, default=0,
                    help="override the config's layer count (resets "
                         "heterogeneous layer groups to uniform)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pod", type=int, default=1,
                    help="outer data-parallel axis (multi-pod): the batch "
                         "splits over pod x dp, and the ZeRO-1 gradient "
                         "chunk all-reduces over the pods under the dp "
                         "codec after the data reduce-scatter; excludes "
                         "--nodes")
    ap.add_argument("--nodes", default="1",
                    help="factor dp into (node, data) sub-axes: the DP "
                         "sync runs two levels (hpZ); an int or 'NxD' (N "
                         "nodes x D dp ranks per node)")
    ap.add_argument("--tp-nodes", default="1",
                    help="factor tp into (tpnode, model) sub-axes: the TP "
                         "collectives run two levels; an int or 'NxD'")
    ap.add_argument("--cp", type=int, default=1,
                    help="context-parallel degree (a cp axis of processes: "
                         "each holds a zigzag slice of the sequence, ring "
                         "attention rotates the K/V blocks under the "
                         "scheme's cp codecs)")
    ap.add_argument("--cp-nodes", default="1",
                    help="factor cp into (cpnode, cp) sub-axes: ring hops "
                         "and the cp gradient fold that cross a node ride "
                         "the cp_*_outer codec; an int or 'NxD'")
    ap.add_argument("--pp-nodes", default="1",
                    help="factor pp into (ppnode, stage) sub-axes: stage "
                         "handoffs that cross a node ride the outer codec; "
                         "an int or 'NxD'")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (a stage axis of processes; the "
                         "layer stack splits into identical contiguous "
                         "chunks)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split the per-rank batch into N microbatches "
                         "(1F1B on a stage mesh, gradient accumulation "
                         "otherwise)")
    ap.add_argument("--vpp", type=int, default=1,
                    help="interleaved virtual stages per stage rank "
                         "(needs --pp > 1 and --microbatches divisible by "
                         "--pp)")
    ap.add_argument("--remat-policy", default="none",
                    help="activation checkpointing of the stage bodies: "
                         "none | full | per_stage:<v,v,...>, optionally "
                         "+offload (saved activations in pinned host "
                         "memory instead)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--scheme", default="baseline")
    ap.add_argument("--ring-bidir", action="store_true",
                    help="split compressed rings into two counter-rotating "
                         "half-rings")
    ap.add_argument("--ring-chunks", type=int, default=1,
                    help="stripe each compressed ring into N row chunks")
    ap.add_argument("--grad-buckets", type=int, default=1,
                    help="split the flat ZeRO-1 DP gradient sync into N "
                         "buckets, clip applied after the sync")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt-state-bits", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--no-compress-below", type=int, default=0,
                    help="route payloads below this many bytes to 'none'")
    ap.add_argument("--codec-for", action="append", default=[],
                    metavar="[DIM@]NAME_GLOB=CODEC",
                    help="prepend a policy rule, e.g. "
                         "'dp@zero1_grad*=plr8', 'dp=ef:bq4', 'embed*=bq16' "
                         "(repeatable; first match wins)")
    ap.add_argument("--tune", action="store_true",
                    help="self-tuning compression: the DP gradient sync "
                         "sites walk the codec ladder (bq16 -> bq8 -> "
                         "ef:bq4 -> plr<r>) from measured signals")
    ap.add_argument("--tune-interval", type=int, default=50,
                    help="steps between the controller's decision rounds")
    ap.add_argument("--tune-guard", type=float, default=0.05,
                    help="relative loss-EMA regression that vetoes "
                         "promotions and rolls back the last one")
    ap.add_argument("--policy-from", default="",
                    help="replay a tune_policy.json: its site rules ahead "
                         "of the scheme's (first match wins)")
    # refused: an XLA host-device count, which a world of processes has
    # no counterpart of
    ap.add_argument("--host-devices", type=int, default=0,
                    help="not ported (an XLA host-device count)")
    return ap


def unported(args) -> list[str]:
    """Messages for every flag set to something this package cannot run."""
    out = []
    for attr, default in _UNPORTED:
        val = getattr(args, attr)
        if val != default:
            flag = "--" + attr.replace("_", "-")
            out.append(f"{flag} {val!r} is not ported (an XLA host-device "
                       f"count: this package runs one process per rank)")
    return out


def comm_policy(scheme: str, codec_for=(), no_compress_below: int = 0):
    """The named scheme as a policy, with the override rules of
    ``--no-compress-below`` and ``--codec-for [DIM@]NAME_GLOB=CODEC``
    prepended (first match wins), as the reference's launcher builds it.
    Raises ``ValueError`` for a malformed spec and ``KeyError`` for an
    unknown codec or dimension."""
    from repro_torch.core import policy as policy_lib

    pol = policy_lib.as_policy(scheme)
    overrides = []
    if no_compress_below > 0:
        overrides.append(policy_lib.Rule("none", max_bytes=no_compress_below))
    for spec in codec_for:
        pat, _, codec = spec.partition("=")
        if not pat or not codec:
            raise ValueError(f"--codec-for wants [DIM@]NAME_GLOB=CODEC, got "
                             f"{spec!r}")
        dim, at, name = pat.partition("@")
        if at and dim:                           # dp@zero1_grad*=ef:bq4
            overrides.append(policy_lib.Rule(codec, dim=dim,
                                             name=name or None))
        elif pat in policy_lib.DIMS:             # dp=plr8 (whole dimension)
            overrides.append(policy_lib.Rule(codec, dim=pat))
        else:                                    # embed*=bq16 (name glob)
            overrides.append(policy_lib.Rule(codec, name=pat))
    if overrides:
        pol = pol.with_rules(*overrides, name=f"{pol.name}+cli")
    return pol


def model_config(arch: str, reduced: bool = False, layers: int = 0,
                 depth: int = 0):
    """The architecture's config, at smoke size under ``reduced``;
    ``layers`` resets the layer stack to that many uniform layers, as the
    reference's ``--layers`` does, and ``depth`` keeps the stack's first
    ``depth`` layers, its layer pattern kept (``ArchConfig.truncated``)."""
    from repro_torch import configs

    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = cfg.replace(n_layers=layers, groups=())
    if depth:
        cfg = cfg.truncated(depth)
    return cfg


def check_cp(cfg, cp: int) -> None:
    """Refuse context parallelism on a stack with recurrent layers: their
    state crosses sequence shards over the model axes only
    (``cross_shard_prefix``), so each cp rank would start its recurrence
    from a zero state on its zigzag slice.  The reference's launcher runs
    that silently and trains another model (fault C.20).  Refuse it on an
    encoder-decoder too: the reference shards the frames over the batch
    and tp axes only, yet gives the encoder zigzag cp positions and rings
    its K/V over cp, so each frame is attended twice at two positions
    (fault C.23)."""
    if cp <= 1:
        return
    kinds = sorted({g.kind for g in cfg.layer_groups
                    if g.kind in ("mamba", "mlstm", "slstm")})
    if kinds:
        raise ValueError(
            f"--cp {cp} is refused for {cfg.name}: its recurrent layers "
            f"{kinds} carry their state across sequence shards over the "
            f"model axes only, so a cp rank would start each recurrence "
            f"from zero on its zigzag slice (the reference computes that "
            f"silently)")
    if cfg.encoder_layers:
        raise ValueError(
            f"--cp {cp} is refused for {cfg.name}: its encoder's frames "
            f"are not split over cp, yet take zigzag cp positions and ring "
            f"over cp, so every frame is attended twice at two positions "
            f"(the reference computes that silently)")


def node_counts(args) -> dict:
    """``--nodes``, ``--tp-nodes``, ``--pp-nodes`` and ``--cp-nodes`` as
    node counts (``nodes``, ``tp_nodes``, ``pp_nodes``, ``cp_nodes``);
    ``ValueError`` for a spec that does not divide its axis, and for
    ``--nodes`` beside ``--pod`` (the reference asserts they exclude each
    other)."""
    from repro_torch.launch.mesh import parse_nodes_spec

    if args.pod < 1:
        raise ValueError(f"--pod {args.pod} must be >= 1")
    nodes = parse_nodes_spec(args.nodes, args.dp)
    if args.pod > 1 and nodes > 1:
        raise ValueError(f"--pod {args.pod} and --nodes {args.nodes} are "
                         f"mutually exclusive outer data-parallel axes")
    return dict(nodes=nodes,
                tp_nodes=parse_nodes_spec(args.tp_nodes, args.tp,
                                          flag="--tp-nodes"),
                pp_nodes=parse_nodes_spec(args.pp_nodes, args.pp,
                                          flag="--pp-nodes"),
                cp_nodes=parse_nodes_spec(args.cp_nodes, args.cp,
                                          flag="--cp-nodes"))


def check_schedule(args) -> None:
    """Raise ``ValueError`` for a mesh or pipeline the flags cannot run: a
    node spec that does not divide its axis, a sequence the zigzag cp
    sharding or the tp sequence split cannot cut, a bad ``--vpp`` or
    ``--remat-policy``, or a layer stack that does not split into ``pp *
    vpp`` identical chunks (the reference's messages)."""
    from repro_torch.launch.mesh import validate_vpp
    from repro_torch.models.transformer import stage_partition
    from repro_torch.train.pipeline import parse_remat_policy

    node_counts(args)
    if args.cp < 1:
        raise ValueError(f"--cp {args.cp} must be >= 1")
    check_cp(model_config(args.arch, args.reduced, args.layers), args.cp)
    if args.cp > 1 and args.seq % (2 * args.cp):
        raise ValueError(f"seq len {args.seq} must divide 2*cp="
                         f"{2 * args.cp} for zigzag cp sharding")
    if (args.seq // args.cp) % args.tp:
        raise ValueError(f"dim 1 of size {args.seq // args.cp} not "
                         f"divisible by axis size {args.tp}")
    validate_vpp(args.vpp, args.pp, args.microbatches)
    parse_remat_policy(args.remat_policy, args.vpp)
    if args.pp > 1:
        stage_partition(model_config(args.arch, args.reduced, args.layers),
                        args.pp, args.vpp)


# --------------------------------------------------------------------------
# resume: the reference's loud fallbacks
# --------------------------------------------------------------------------

def _restore_opt(trainer, params, opt_dir, step, checkpoint, say=print):
    """Resume the optimizer state saved alongside the params.

    A param-only checkpoint (no ``opt/`` subdir, or another step there) or
    an elastic restart whose new topology changes the state's global
    layout both fall back to a fresh state, with the reference's loud
    warning, since that resets the Adam moments."""
    if not opt_dir or checkpoint.latest_step(opt_dir) != step:
        say("WARNING: no optimizer checkpoint for this step — "
            "reinitializing Adam moments (old param-only checkpoint?)")
        return trainer.opt.init(params)
    try:
        ostate, _ = checkpoint.restore(opt_dir, trainer.opt_state_shards(),
                                       step=step)
        say(f"restored optimizer state at step {step}")
        return trainer.opt.state_from_shards(ostate)
    except (ValueError, AssertionError) as e:
        say(f"WARNING: optimizer state not portable to this topology "
            f"({e}) — reinitializing Adam moments")
        return trainer.opt.init(params)


def _restore_codec(trainer, codec_dir, step, checkpoint, say=print):
    """Resume the carried codec state (ef residuals / plr factors) saved
    alongside the params, with :func:`_restore_opt`'s loud fallbacks:
    resetting an error-feedback residual silently would quietly re-bias
    the very gradients the ef codec exists to de-bias.  A stateless policy
    has nothing to restore and says nothing."""
    if not trainer.codec_state_template():
        return {}
    if not codec_dir or checkpoint.latest_step(codec_dir) != step:
        say("WARNING: no codec-state checkpoint for this step — "
            "reinitializing error-feedback/low-rank codec state "
            "(pre-stateful-codec checkpoint?)")
        return trainer.init_codec_state()
    try:
        cstate, _ = checkpoint.restore(codec_dir,
                                       trainer.codec_state_shards(),
                                       step=step)
        say(f"restored codec state at step {step}")
        return cstate
    except (ValueError, AssertionError) as e:
        say(f"WARNING: codec state not portable to this topology "
            f"({e}) — reinitializing")
        return trainer.init_codec_state()


def _restore_tune(trainer, tune_dir, step, checkpoint, say=print):
    """Resume the self-tuning signal accumulators saved under
    ``<ckpt>/tune/``, with the reference's loud fallbacks: a pre-tune
    checkpoint or a topology change that renames the tunable sites starts
    the controller interval fresh (zeroed accumulators) with a warning.
    Returns ``None`` on fallback — the caller takes the rung selections
    from the restored controller state (or the plan)."""
    if not tune_dir or checkpoint.latest_step(tune_dir) != step:
        say("WARNING: no tune-state checkpoint for this step — "
            "starting the controller interval fresh (zeroed signal "
            "accumulators)")
        return None
    try:
        tstate, _ = checkpoint.restore(tune_dir, trainer.tune_state_shards(),
                                       step=step)
        say(f"restored tune state at step {step}")
        return trainer.tune_state_from_shards(tstate)
    except (ValueError, AssertionError) as e:
        say(f"WARNING: tune state not portable to this topology ({e}) — "
            "starting the controller interval fresh")
        return None


def _restore_controller(ctrl, tune_dir, say=print) -> None:
    """Resume the controller's ladder position from
    ``<ckpt>/tune/controller.json``, with the reference's fallbacks."""
    path = os.path.join(tune_dir, "controller.json") if tune_dir else ""
    if not (path and os.path.exists(path)):
        say("WARNING: no tune controller state in checkpoint — "
            "restarting the ladder walk from the base scheme")
        return
    try:
        with open(path) as f:
            ctrl.load_state_dict(json.load(f))
        say(f"restored tune controller (last decision step "
            f"{ctrl.last_decision_step})")
    except (ValueError, KeyError) as e:
        say(f"WARNING: tune controller state not portable ({e}) — "
            "restarting the ladder walk from the base scheme")


def _save_controller(ctrl, tune_dir) -> None:
    """The controller's host state as ``<tune_dir>/controller.json``
    (atomic write + rename, like the heartbeat)."""
    os.makedirs(tune_dir, exist_ok=True)
    tmp = os.path.join(tune_dir, "controller.json.tmp")
    with open(tmp, "w") as f:
        json.dump(ctrl.state_dict(), f)
    os.replace(tmp, os.path.join(tune_dir, "controller.json"))


# --------------------------------------------------------------------------
# a world of processes
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    mod, _, fn = target.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _rank_main(target, rank, world, port, kwargs, out_q):
    """Body of one spawned rank: join the gloo group, run ``target``, put
    ``(rank, ok, result or traceback)`` on the queue."""
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(minutes=10))
        out_q.put((rank, True, _resolve(target)(rank=rank, world=world,
                                                **kwargs)))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(target: str, world: int, kwargs: dict,
                timeout: float | None = None) -> list:
    """Run ``module:function`` in ``world`` fresh processes joined in one
    gloo group (``function(rank=, world=, **kwargs)``); return the results
    in rank order.  Any rank's failure raises here with its traceback, and
    every process is stopped before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, kwargs, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, t0 = {}, time.monotonic()
    try:
        while len(results) < world:
            try:
                rank, ok, payload = out_q.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[i].exitcode for i in dead]})")
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"world of {world} timed out")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def rank_device(device, rank: int) -> torch.device:
    """``cpu``, or the card of this rank (ranks share the cards round-robin;
    one card holds every rank)."""
    from repro_torch.models.params import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


# --------------------------------------------------------------------------
# one rank's run
# --------------------------------------------------------------------------

def train_rank(*, rank: int = 0, world: int = 1, arch: str,
               reduced: bool = False, layers: int = 0, depth: int = 0,
               overrides: dict | None = None, dp: int = 1, tp: int = 1,
               pp: int = 1, cp: int = 1, pod: int = 1,
               nodes: int = 1, tp_nodes: int = 1, pp_nodes: int = 1,
               cp_nodes: int = 1, microbatches: int = 1,
               vpp: int = 1, remat_policy: str = "none",
               steps: int = 20, seq: int = 64,
               global_batch: int = 8, scheme: str = "baseline",
               codec_for=(), no_compress_below: int = 0,
               ring_bidir: bool = False, ring_chunks: int = 1,
               grad_buckets: int = 1, lr: float = 1e-3,
               opt_state_bits: int = 32, seed: int = 0, device=None,
               backend=None, deterministic: bool = False,
               time_staging: bool = False, flat_grad_out: str = "",
               init_from: str = "", codec_state_from: str = "",
               ckpt_dir: str = "", ckpt_every: int = 50,
               resume: bool = False, tune: bool = False,
               tune_interval: int = 50, tune_guard: float = 0.05,
               policy_from: str = "") -> dict:
    """Train ``steps`` steps as rank ``rank`` of a ``pod x dp x cp x pp x
    tp`` world whose process group is initialized (or alone, for a
    one-rank world); ``pod`` is the outer data-parallel axis (the batch
    splits over ``pod x dp``); ``nodes``, ``cp_nodes``, ``tp_nodes`` and ``pp_nodes`` factor
    the data, cp, model and stage axes over nodes
    (:func:`~repro_torch.launch.mesh.make_mesh`); each batch is permuted
    into zigzag order on the host and this rank takes its rows and its
    contiguous ``seq / cp`` slice of it; ``depth`` cuts the stack to its
    first layers, the pattern kept (:func:`model_config`); ``overrides``
    replaces config fields afterwards (``{"fsdp_params": True}`` turns
    ZeRO-3 on, as the reference's tests do on a config that ships
    without it; no flag sets it); ``pp``,
    ``microbatches``, ``vpp`` and ``remat_policy`` select the pipeline
    trainer as the reference's ``make_trainer`` does.

    ``codec_for`` and ``no_compress_below`` prepend policy rules to
    ``scheme`` (:func:`comm_policy`); ``backend="torch"`` runs every bq and
    lowrank op through its plain version;
    ``deterministic`` turns on ``torch.use_deterministic_algorithms`` and
    turns TF32 off; ``time_staging`` times every exchange
    (:func:`comms.time_staging`, a device drain before each);
    ``flat_grad_out`` names a file where rank 0 saves its last pre-sync
    flat gradient; ``init_from`` names a pickle of a global parameter tree
    (numpy arrays in the plan's layout, such as the reference package's
    weights) to start from instead of ``seed``; ``codec_state_from`` names
    a pickle of the reference's global codec state (numpy leaves) to start
    from instead of this package's own init.  ``ckpt_dir``, ``ckpt_every``
    and ``resume`` checkpoint and resume as the reference's launcher does
    (a resumed run starts at the checkpoint's step and ignores
    ``init_from`` and ``codec_state_from``).  ``tune``, ``tune_interval``
    and ``tune_guard`` run the self-tuning controller as the reference's
    launcher does (every rank runs its own on the world-summed signals,
    so all decide alike; rank 0 writes ``<ckpt>/tune_policy.json`` after
    each round and ``<ckpt>/tune/controller.json`` with each checkpoint);
    ``policy_from`` replays a ``tune_policy.json`` ahead of the scheme,
    its ``tune_restart_warnings`` said as ``WARNING:`` lines.  Returns
    this rank's metrics:
    losses, grad norms (an expert model's ``lb_loss`` and ``drop_frac``
    too), the device bytes allocated at the end of each step's forward
    (``fwd_allocated``, the flat step on a card; else ``None``), step
    seconds, the staged bytes and (under
    ``time_staging``) seconds and the seconds of the timed spans
    (``comms.SPANS``), peak device memory, kernel launches (also
    by bq kernel, wire rows and rate), the
    first step's ledger (its analytic events; per dimension, measured wire
    bytes and the priced events, and priced and measured per
    ``dim/level`` and priced per link class,
    ``link_bytes`` with every outer level slow), per site tag (priced, and
    priced as if uncompressed) and per named site (priced), the kernel launches per bq kernel and link
    level,
    the schedule's ticks and bubble fraction, per codec-state slot its
    residual energy and factor rank after the last step, the first step,
    what the resume printed, the straggler flags, the checkpoints'
    seconds (``ckpt``: in ``save`` calls, in the saving threads, waiting
    for them at the end, restoring) and bytes on disk, and under ``tune``
    the controller's record (``tune``: the decision history, the final
    codecs and their rules, the ``select`` and the drained signals of each
    round, the ``select`` of each step, the measured wire bytes per
    ``dim/level`` at every step, and the first step's analytic ledger)."""
    import numpy as np

    from repro_torch.analysis import roofline
    from repro_torch.core import codecs, comms
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import bq, lowrank, ops
    from repro_torch.launch.mesh import make_mesh, validate_vpp
    from repro_torch.models.model import Model
    from repro_torch.train import checkpoint, fault
    from repro_torch.train.optimizer import AdamConfig
    from repro_torch.train.train_step import make_trainer, zigzag_shard_seq
    from repro_torch.tune import policy_artifact, tracker
    from repro_torch.tune.controller import (CompressionController,
                                             ControllerConfig)

    if pod * dp * cp * pp * tp != world:
        raise ValueError(f"pod {pod} x dp {dp} x cp {cp} x pp {pp} x tp {tp} "
                         f"!= world {world}")
    validate_vpp(vpp, pp, microbatches)
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ops.set_default_backend(backend)
    comms.time_staging(time_staging)
    cfg = model_config(arch, reduced, layers, depth)
    if overrides:
        cfg = cfg.replace(**overrides)
    check_cp(cfg, cp)
    mi = make_mesh(dp, tp, pp, nodes=nodes, tp_nodes=tp_nodes,
                   pp_nodes=pp_nodes, cp=cp, cp_nodes=cp_nodes, pod=pod)
    model = Model(cfg, mi, device=dev, vpp=vpp)
    log = []

    def say(msg):
        log.append(msg)
        if rank == 0:
            print(msg, flush=True)

    pol = comm_policy(scheme, codec_for, no_compress_below)
    if policy_from:
        art = policy_artifact.load(policy_from)
        for w in fault.tune_restart_warnings(
                art, mi, heartbeat_path=os.path.join(
                    ckpt_dir, "heartbeat.json") if ckpt_dir else None):
            say(f"WARNING: {w}")
        pol = policy_artifact.as_policy(art, base=pol)
        say(f"applied tuned policy {policy_from}: {len(art['rules'])} site "
            f"rules from step {art['step']} (plan {art['plan_hash']})")
    trainer = make_trainer(
        model, scheme=pol,
        opt_cfg=AdamConfig(lr=lr, state_bits=opt_state_bits,
                           grad_buckets=grad_buckets),
        n_micro=microbatches, ring_bidir=ring_bidir,
        ring_chunks=ring_chunks, remat_policy=remat_policy, tune=tune)

    opt_dir = os.path.join(ckpt_dir, "opt") if ckpt_dir else ""
    codec_dir = os.path.join(ckpt_dir, "codec") if ckpt_dir else ""
    tune_dir = os.path.join(ckpt_dir, "tune") if ckpt_dir else ""
    # seconds: in save() (host copies, file creation; a blocking save
    # whole), in the saving threads, waiting for them after the last step,
    # restoring; bytes of the last checkpoint
    ck = {"save_s": 0.0, "thread_s": 0.0, "wait_s": 0.0, "restore_s": 0.0,
          "bytes": 0, "steps": []}
    start = 0
    resumed = resume and bool(ckpt_dir) and \
        checkpoint.latest_step(ckpt_dir) is not None
    if resumed:
        t0 = time.perf_counter()
        tree, man = checkpoint.restore(ckpt_dir, trainer.param_shards())
        params = checkpoint.unwrap(tree)
        start = man["step"]
        ostate = _restore_opt(trainer, params, opt_dir, start, checkpoint,
                              say)
        trainer.params_from_master(params, ostate)
        cstate = _restore_codec(trainer, codec_dir, start, checkpoint, say)
        ck["restore_s"] = time.perf_counter() - t0
        say(f"resumed from step {start} (elastic onto dp={dp} tp={tp} "
            f"pp={pp}" + (f" pod={pod})" if pod > 1 else ")"))
    elif init_from:
        from repro_torch.models.params import from_jax_params
        with open(init_from, "rb") as f:
            params = from_jax_params(pickle.load(f), cfg, dev, mi, vpp)
        ostate = trainer.opt.init(params)
        cstate = trainer.init_codec_state()
    else:
        params, ostate, cstate = trainer.init_all(seed)
    if codec_state_from and not start:
        with open(codec_state_from, "rb") as f:
            cstate = trainer.codec_state_from_jax(pickle.load(f))
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=global_batch, seed=seed))
    if global_batch % (pod * dp):
        raise ValueError(f"--global-batch {global_batch} not divisible by "
                         f"--pod {pod} x --dp {dp}")
    # the batch shards over the joint (pod, node, data) axis, pod- and
    # node-major, and the zigzag-permuted sequence contiguously over the
    # cp axis
    b_loc, d = global_batch // (pod * dp), mi.batch_axes.index
    s_loc, c = seq // cp, mi.coords["cp"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the self-tuning controller: every rank runs its own on the
    # world-summed signals, so every rank makes the same decisions
    tstate = ctrl = None
    if tune:
        ctrl = CompressionController(
            trainer.policy, trainer.tune_sites(), mesh_info=mi,
            cfg=ControllerConfig(interval=tune_interval, guard=tune_guard),
            start_step=start)
        trk = tracker.SignalTracker()
        if resumed:
            _restore_controller(ctrl, tune_dir, say)
            tstate = _restore_tune(trainer, tune_dir, start, checkpoint, say)
        if tstate is None:
            tstate = trainer.init_tune_state()
        # the rung selections always come from the controller (which just
        # restored its ladder position, or starts at the base scheme's)
        tstate = {"select": ctrl.select_indices(), "sig": tstate["sig"]}

    pending = []

    def save_all(at: int, blocking: bool) -> None:
        t0 = time.perf_counter()
        trees = [(ckpt_dir, trainer.param_shards(params)),
                 (opt_dir, trainer.opt_state_shards(ostate)),
                 (codec_dir, trainer.codec_state_shards(cstate))]
        if tune:
            trees.append((tune_dir, trainer.tune_state_shards(tstate)))
        for where, tree in trees:
            p = checkpoint.save(where, at, tree, blocking=blocking)
            if p is not None:
                pending.append(p)
        if tune and rank == 0:
            _save_controller(ctrl, tune_dir)
        ck["save_s"] += time.perf_counter() - t0
        ck["steps"].append(at)

    if ckpt_dir and rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    mon = fault.StepMonitor(heartbeat_path=os.path.join(
        ckpt_dir, "heartbeat.json") if ckpt_dir and rank == 0 else None)
    tuned = {"rounds": [], "select_per_step": [], "wire_per_step": []}
    if tune:
        mon.tune_plan_hash = ctrl.plan().table_hash()
        mon.tune_decision_step = ctrl.last_decision_step
    out = {"rank": rank, "coords": [d, mi.coords["stage"], mi.tp_axes.index],
           "start": start, "restore_log": log, "straggler": [],
           "losses": [], "grad_norms": [], "step_s": [], "staging_s": [],
           "span_s": [], "staging_bytes": [], "fwd_allocated": [],
           "ticks": roofline.pipeline_ticks(pp, microbatches, vpp),
           "bubble": roofline.bubble_fraction(pp, microbatches, vpp)}
    bq.reset_launches()
    lowrank.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for step in range(start, start + steps):
        mon.begin()
        nb = zigzag_shard_seq(data.batch(step), cp)
        batch = {k: torch.from_numpy(np.ascontiguousarray(
                     v[d * b_loc:(d + 1) * b_loc, c * s_loc:(c + 1) * s_loc]))
                 .to(dev) for k, v in nb.items()}
        if cfg.encoder_layers:
            # this rank's rows and tp slice of the encoder's stub input
            # (the reference's batch spec P(batch, tp, None))
            t, s_tp = mi.tp_axes.index, seq // tp
            batch["frames"] = torch.from_numpy(np.ascontiguousarray(
                data.frames(step, cfg.d_model)[d * b_loc:(d + 1) * b_loc,
                                               t * s_tp:(t + 1) * s_tp])
            ).to(dev)
        trainer.opt.keep_flat_grad = bool(flat_grad_out) and rank == 0 \
            and step == start + steps - 1
        comms.reset_staging()
        sync()
        t0 = time.perf_counter()
        with comms.record_traffic() as events:
            if tune:
                params, ostate, cstate, tstate, metrics = \
                    trainer.step_tuned(params, ostate, cstate, tstate, batch)
            else:
                params, ostate, cstate, metrics = trainer.step(
                    params, ostate, cstate, batch)
            sync()
        out["step_s"].append(time.perf_counter() - t0)
        out["straggler"].append(mon.end(step)["straggler"])
        out["staging_s"].append(comms.STAGING["seconds"])
        out["span_s"].append(dict(comms.SPANS))
        out["staging_bytes"].append(comms.STAGING["bytes"])
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["fwd_allocated"].append(trainer.fwd_allocated)
        if "lb_loss" in metrics:
            out.setdefault("lb_loss", []).append(float(metrics["lb_loss"]))
            out.setdefault("drop_frac", []).append(
                float(metrics["drop_frac"]))
        if step == start:
            out["events0"] = list(events)
            out["wire_per_dim"] = roofline.wire_per_dim(events.wire)
            out["wire_per_dim_level"] = roofline.wire_per_dim_level(
                events.wire)
            summary = roofline.ledger_summary(events, train=True)
            out["priced_per_dim"] = summary["per_dim"]
            out["priced_per_dim_level"] = summary["per_dim_level"]
            out["priced_per_site"] = summary["per_site"]
            out["link_bytes"] = roofline.link_bytes(events, train=True)
            out["priced_per_tag"] = roofline.ledger_per_tag(events)
            out["payload_per_tag"] = roofline.ledger_per_tag(events,
                                                             plain=True)
        if tune:
            tuned["select_per_step"].append(dict(tstate["select"]))
            tuned["wire_per_step"].append(
                roofline.wire_per_dim_level(events.wire))
            ctrl.observe_loss(step, out["losses"][-1])
            if (step + 1 - start) % tune_interval == 0:
                sigs, zeroed = trk.drain(tstate["sig"])
                for dec in ctrl.decide(step, sigs):
                    if dec.changed:
                        say(f"tune[{dec.site}] step {step}: {dec.action} "
                            f"{dec.from_codec} -> {dec.to_codec} "
                            f"({dec.reason})")
                tstate = {"select": ctrl.select_indices(),
                          "sig": {k: torch.from_numpy(z).to(dev)
                                  for k, z in zeroed.items()}}
                tuned["rounds"].append(dict(
                    step=step, select=dict(tstate["select"]),
                    signals={k: dataclasses.asdict(v)
                             for k, v in sigs.items()}))
                mon.tune_plan_hash = ctrl.plan().table_hash()
                mon.tune_decision_step = step
                if ckpt_dir and rank == 0:
                    policy_artifact.emit(
                        os.path.join(ckpt_dir, "tune_policy.json"), ctrl)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_all(step + 1, blocking=False)
    if ckpt_dir:
        t0 = time.perf_counter()
        checkpoint.join_all(pending)
        ck["wait_s"] = time.perf_counter() - t0
        ck["thread_s"] = sum(p.seconds for p in pending)
        last = start + steps
        if checkpoint.latest_step(ckpt_dir) != last:
            save_all(last, blocking=True)
        ck["bytes"] = sum(checkpoint.nbytes(where, last)
                          for where in (ckpt_dir, opt_dir, codec_dir)
                          + ((tune_dir,) if tune else ()))
        say(f"checkpointed at step {last}")
    if tune:
        if ckpt_dir and rank == 0:
            art = policy_artifact.emit(
                os.path.join(ckpt_dir, "tune_policy.json"), ctrl)
            say(f"tune_policy.json: plan {art['plan_hash']} "
                f"({len(art['rules'])} site rules)")
        say("tuned codecs: " + ", ".join(
            f"{k}={v}" for k, v in sorted(ctrl.codec.items())))
        out["tune"] = dict(tuned, events0=out["events0"],
                           history=list(ctrl.history),
                           codecs=dict(ctrl.codec),
                           plan_hash=ctrl.plan().table_hash(),
                           sites={k: [s.dim, s.name, s.level, e] for k, (s, e)
                                  in trainer.tune_sites().items()},
                           rules=[policy_artifact._rule_dict(r)
                                  for r in ctrl.rules()])
    out["stragglers"] = mon.stragglers
    out["ckpt"] = ck
    out["plan_hash"] = trainer.plan.table_hash()
    if trainer.opt.last_flat_grad is not None:
        torch.save(trainer.opt.last_flat_grad.cpu(), flat_grad_out)
        trainer.opt.last_flat_grad = None
    out["launches"] = {**bq.LAUNCHES, **lowrank.LAUNCHES}
    out["launch_shapes"] = bq.launch_shapes()
    out["launch_levels"] = {f"{k}/{lvl}": v for (k, lvl), v
                            in sorted(bq.LAUNCH_LEVELS.items())}
    out["codec_state"] = {
        k: {"residual_sq": float(codecs.state_residual_sq(st)),
            "rank": codecs.state_rank(st)} for k, st in cstate.items()}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    out["teacher_floor"] = data.optimal_xent()
    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return out


def rank_kwargs(args, **extra) -> dict:
    """:func:`train_rank`'s keywords for the parsed flags (plus ``extra``);
    raises before anything starts when the flags ask for a card and there
    is none."""
    from repro_torch.models.params import resolve_device

    dev = resolve_device(args.device)
    return dict(arch=args.arch, reduced=args.reduced, layers=args.layers,
                dp=args.dp, tp=args.tp, pp=args.pp, cp=args.cp, pod=args.pod,
                **node_counts(args),
                microbatches=args.microbatches, vpp=args.vpp,
                remat_policy=args.remat_policy, steps=args.steps,
                seq=args.seq, global_batch=args.global_batch,
                scheme=args.scheme, codec_for=list(args.codec_for),
                no_compress_below=args.no_compress_below,
                ring_bidir=args.ring_bidir, ring_chunks=args.ring_chunks,
                grad_buckets=args.grad_buckets, lr=args.lr,
                opt_state_bits=args.opt_state_bits, seed=args.seed,
                device=dev.type, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                tune=args.tune, tune_interval=args.tune_interval,
                tune_guard=args.tune_guard, policy_from=args.policy_from,
                **extra)


def run(args, **extra) -> list:
    """Run the parsed flags (plus :func:`train_rank` keywords ``extra``) as
    a world of ``pod * dp * cp * pp * tp`` spawned processes; returns the
    per-rank results."""
    from repro_torch.kernels import bq

    kwargs = rank_kwargs(args, **extra)      # no card: raise before spawning
    world = args.pod * args.dp * args.cp * args.pp * args.tp
    if kwargs["device"] == "cuda":
        bq.build()                           # once, before the ranks start
        # ranks share one card: growable segments keep each rank's
        # reserved-but-free memory from fragmenting the card
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        if kwargs.get("deterministic"):
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if world == 1:
        return [train_rank(**kwargs)]
    return spawn_world("repro_torch.launch.train:train_rank", world, kwargs)


def _report(res: list, args) -> None:
    r0 = res[0]
    for step, (loss, gn, dt, slow) in enumerate(
            zip(r0["losses"], r0["grad_norms"], r0["step_s"],
                r0["straggler"]), start=r0["start"]):
        print(f"step {step:5d} loss={loss:.4f} gnorm={gn:.3f} dt={dt:.2f}s"
              + (" STRAGGLER" if slow else ""))
    tail = r0["step_s"][1:] or r0["step_s"]
    tok = args.global_batch * args.seq
    peak = max(r["peak_bytes"] for r in res) / 2**30
    print(f"done: final loss {r0['losses'][-1]:.4f}, teacher floor "
          f"{r0['teacher_floor']:.4f}, stragglers {r0['stragglers']}/"
          f"{len(r0['losses'])}; {statistics.median(tail) * 1e3:.1f} "
          f"ms/step ({tok / statistics.median(tail):.0f} tok/s) on "
          f"{r0['device']}, {len(res)} ranks, peak {peak:.2f} GiB per rank")
    if args.ckpt_dir:
        ck = r0["ckpt"]
        print(f"checkpoints: steps {ck['steps']}, {ck['bytes'] / 1e9:.3f} GB "
              f"on disk (the last); {ck['save_s']:.2f}s in save calls, "
              f"{ck['thread_s']:.2f}s in saving threads, {ck['wait_s']:.2f}s "
              f"waiting for them, {ck['restore_s']:.2f}s restoring (rank 0)")
    if args.pp > 1 or args.microbatches > 1:
        print(f"pipeline: pp {args.pp} x vpp {args.vpp}, "
              f"{args.microbatches} microbatches, {r0['ticks']} ticks, "
              f"bubble fraction {r0['bubble']:.4f}")
    launches = {k: sum(r["launches"][k] for r in res) for k in r0["launches"]}
    print(f"kernel launches (all ranks): {launches}")
    by = {}
    for r in res:
        for k, v in r["launch_levels"].items():
            by[k] = by.get(k, 0) + v
    if any(not k.endswith("/flat") for k in by):
        print(f"kernel launches by link level (all ranks): {by}")
    print(f"wire per rank, first step, per dim/level: priced "
          f"{r0['priced_per_dim_level']}, measured "
          f"{r0['wire_per_dim_level']}; link bytes fast/slow "
          f"{r0['link_bytes']}")
    for k, st in r0["codec_state"].items():
        print(f"codec state {k} (rank 0): residual^2 {st['residual_sq']:.4g}"
              + (f", factor rank {st['rank']}" if st["rank"] else ""))
    if "tune" in r0:
        tu = r0["tune"]
        for step, (sel, wire) in enumerate(
                zip(tu["select_per_step"], tu["wire_per_step"]),
                start=r0["start"]):
            print(f"tune step {step}: rungs {sel}, measured wire per "
                  f"dim/level {wire}")
        print(f"tuned codecs: {tu['codecs']} (plan {tu['plan_hash']})")


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    bad = unported(args)
    if bad:
        ap.error("; ".join(bad))
    try:
        comm_policy(args.scheme, args.codec_for, args.no_compress_below)
        check_schedule(args)
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dist.init_process_group("gloo", rank=rank, world_size=world)
        try:
            res = train_rank(
                rank=rank, world=world, arch=args.arch, reduced=args.reduced,
                layers=args.layers, dp=args.dp, tp=args.tp, pp=args.pp,
                cp=args.cp, pod=args.pod, **node_counts(args),
                microbatches=args.microbatches, vpp=args.vpp,
                remat_policy=args.remat_policy, steps=args.steps,
                seq=args.seq, global_batch=args.global_batch,
                scheme=args.scheme, codec_for=list(args.codec_for),
                no_compress_below=args.no_compress_below,
                ring_bidir=args.ring_bidir,
                ring_chunks=args.ring_chunks, grad_buckets=args.grad_buckets,
                lr=args.lr, opt_state_bits=args.opt_state_bits,
                seed=args.seed, device=args.device, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                tune=args.tune, tune_interval=args.tune_interval,
                tune_guard=args.tune_guard, policy_from=args.policy_from)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            _report([res], args)
        return
    _report(run(args), args)


if __name__ == "__main__":
    main()
