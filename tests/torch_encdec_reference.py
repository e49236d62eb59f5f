"""The reference side of the encoder-decoder parity tests
(``test_torch_encdec.py`` and ``test_torch_encdec_train.py``): the inputs
both packages share, and ONE reference subprocess that computes
everything both files compare against, started by whichever file asks
first and read by both.

The subprocess runs on 4 XLA host devices: the modules (the encoder
stack, cross-attention in training and prefill, the cross decode) at tp 2
(head mode) and tp 4 (ring mode), the trainer cases, the ``Server`` and
``DisaggServer`` runs, and the reference faults C.22-C.24.  Its result is
a pickle in a directory every pytest worker of the session shares (under
``pytest-xdist`` the parent of the worker's base temp dir, otherwise the
base temp dir); a lock file makes exactly one worker start it, and the
others wait for the pickle.
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# the small whisper: the reference's reduced config (d 64, 4 q / 2 kv
# heads of 16, f32) with its encoder kept (the reduced plan drops it:
# fault C.21)
ENC, DEC = 2, 2

# modules: decoder tokens, encoder frames, the cross decode's indices (one
# inside the encoder's length, one past it)
B_MOD, S_DEC, S_ENC = 2, 8, 8
IDX_LO, IDX_HI = 3, S_ENC + 1

# training: as test_torch_recurrent_train.py
SEQ, GB, STEPS = 32, 4, 2
SCHEMES = ("baseline", "zhybrid_16_8")
MESHES = {"tp2": dict(dp=1, tp=2), "tp4": dict(dp=1, tp=4),
          "dp2_tp2": dict(dp=2, tp=2)}
TRAIN = {f"{m}/{s}": dict(scheme=s, **mesh)
         for m, mesh in MESHES.items() for s in SCHEMES}

# serving: batched at tp 2 (head mode) and tp 4 (ring mode), disagg at
# dp 1 x tp 2 (two pools of 2), prompts of S_SRV tokens, GEN generated
SERVE_SEED, B_SRV, S_SRV, GEN = 7, 4, 8, 4
SERVE_SCHEME, KV_CODEC = "zhybrid_16_8", "bq8"
SERVE = {"batched/tp2": dict(mode="batched", tp=2),
         "batched/tp4": dict(mode="batched", tp=4),
         "disagg/tp2": dict(mode="disagg", tp=2)}

TIMEOUT = 900


def small(cfg):
    """``cfg`` (either package's reduced whisper-base) with its encoder."""
    mod = sys.modules[type(cfg).__module__]
    return cfg.replace(groups=mod.encdec_groups(ENC, DEC),
                       encoder_layers=ENC)


def port_cfg():
    from repro_torch import configs
    return small(configs.get("whisper-base").reduced())



def overrides() -> dict:
    """``train_rank``'s ``overrides`` that turn the reduced config into
    :func:`small`'s."""
    from repro_torch.models.config import encdec_groups
    return dict(groups=encdec_groups(ENC, DEC), encoder_layers=ENC)


def weights():
    """The global weights both packages start from: each leaf of the small
    whisper's plan drawn as the reference's init does it (normal * scale,
    zeros, ones), from a numpy seed, as a tree of numpy arrays."""
    from repro_torch.models.params import MeshInfo, map_leaves
    from repro_torch.models.transformer import model_plan

    rng = np.random.default_rng(0)

    def draw(d, _):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        return (rng.standard_normal(d.shape) * d.scale).astype(np.float32)
    return map_leaves(draw, model_plan(port_cfg(), MeshInfo()))


def module_inputs(d_model: int, kv: int, hd: int) -> dict:
    """Numpy inputs of the module comparisons: frames, the cross-attention
    sublayer's queries and encoder slice, the cross cache and a decoded
    token."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    return {"frames": rng.normal(size=(B_MOD, S_ENC, d_model)).astype(f32),
            "h": rng.normal(size=(B_MOD, S_DEC, d_model)).astype(f32),
            "cross": rng.normal(size=(B_MOD, S_ENC, d_model)).astype(f32),
            "w": rng.normal(size=(B_MOD, S_DEC, d_model)).astype(f32),
            "xk": rng.normal(size=(B_MOD, S_ENC, kv, hd)).astype(f32),
            "xv": rng.normal(size=(B_MOD, S_ENC, kv, hd)).astype(f32),
            "x1": rng.normal(size=(B_MOD, 1, d_model)).astype(f32)}


def serve_prompts():
    return np.random.default_rng(SERVE_SEED).integers(
        0, 512, (B_SRV, S_SRV)).astype(np.int32)


def s_max(tp: int) -> int:
    return -(-(S_SRV + GEN) // (2 * tp)) * (2 * tp)


# --------------------------------------------------------------------------
# the reference subprocess
# --------------------------------------------------------------------------

def _reference(args: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.analysis import roofline
    from repro.core import comms, compat, schemes
    from repro.launch.mesh import make_mesh
    from repro.models import attention
    from repro.models.model import Model
    from repro.models.params import MeshInfo, Pv
    from repro.serve.disagg import DECODE, DisaggServer, make_disagg_mesh
    from repro.serve.serve_step import Server
    from repro.train import checkpoint
    from repro.train.optimizer import AdamConfig
    from repro.train.train_step import batch_specs, make_trainer
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch.serve import make_frames

    def is_pv(x):
        return isinstance(x, Pv)

    cfg = small(configs.get("whisper-base").reduced())
    with open(args["tree"], "rb") as f:
        tree = pickle.load(f)

    def load(model, mesh):
        structs = model.structs()
        return jax.tree.map(
            lambda st, sh, a: Pv(jax.device_put(a.astype(st.v.dtype), sh.v),
                                 st.spec), structs,
            checkpoint.resharded_specs(structs, mesh), tree, is_leaf=is_pv)

    def layer0(tree_):
        return jax.tree.map(lambda pv: Pv(pv.v[0], pv.spec[1:]), tree_,
                            is_leaf=is_pv)

    out = {"modules": {}, "train": {}, "serve": {}, "faults": {}}
    inp = module_inputs(cfg.d_model, cfg.n_kv_heads, cfg.head_dim_)
    j = {k: jnp.asarray(v) for k, v in inp.items()}

    # ---- modules at tp 2 (head mode) and tp 4 (ring mode), baseline ----
    for tp in (2, 4):
        mesh = make_mesh(1, tp)
        mi = MeshInfo.from_mesh(mesh)
        model = Model(cfg, mi)
        mode = model.mode
        params = load(model, mesh)
        pspecs = model.specs()
        seq = P(None, "model", None)
        res = {"mode": mode}

        def enc(p, fr, model=model):
            with comms.vma_mode(False):
                return model._encode(p, fr, "train")
        with schemes.use("baseline"):
            x, pos = jax.jit(compat.shard_map(
                enc, mesh=mesh, in_specs=(pspecs, seq),
                out_specs=(seq, P(None, "model")), check_vma=False))(
                params, j["frames"])
        res["encode"], res["encode_pos"] = np.asarray(x), np.asarray(pos)

        def xattn(p, h, c, w, mi=mi, model=model, mode=mode):
            with comms.vma_mode(False):
                xp = layer0(p["groups"][1]["xattn"])
                pos = model._positions(h.shape[0], h.shape[1])
                cpos = model._positions(c.shape[0], c.shape[1])

                def f(h, c):
                    o, cache = attention.attn_train(
                        xp, h, pos, cfg, mi, mode, causal=False, window=0,
                        cross=c, cross_pos=cpos, want_cache=True)
                    return jnp.sum(o * w), (o, cache)
                (_, (o, cache)), (gh, gc) = jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True)(h, c)
            return o, cache, gh, gc
        if mode == "head":
            kv, pkv = P(None, None, "model", None), P()
        else:
            kv, pkv = P(None, "model", None, None), P(None, "model")
        with schemes.use("baseline"):
            o, (k, v, pk), gh, gc = jax.jit(compat.shard_map(
                xattn, mesh=mesh, in_specs=(pspecs, seq, seq, seq),
                out_specs=(seq, (kv, kv, pkv), seq, seq),
                check_vma=False))(params, j["h"], j["cross"], j["w"])
        res.update(xattn_out=np.asarray(o), xattn_k=np.asarray(k),
                   xattn_v=np.asarray(v), xattn_pos=np.asarray(pk),
                   xattn_dh=np.asarray(gh), xattn_dcross=np.asarray(gc))

        def dec(p, x1, k, v, ln, idx, mi=mi, mode=mode):
            with comms.vma_mode(False):
                y, _ = attention.attn_decode(
                    layer0(p["groups"][1]["xattn"]), x1,
                    {"k": k, "v": v, "len": ln}, idx, cfg, mi, mode,
                    seq_axes=("model",), cross=True)
            return y
        for idx in (IDX_LO, IDX_HI):
            with schemes.use("baseline"):
                y = jax.jit(compat.shard_map(
                    dec, mesh=mesh, in_specs=(pspecs, P(), kv, kv, P(), P()),
                    out_specs=P(), check_vma=False))(
                    params, j["x1"], j["xk"], j["xv"], jnp.int32(S_ENC),
                    jnp.int32(idx))
            res[f"decode_{idx}"] = np.asarray(y)
        out["modules"][tp] = res
        jax.clear_caches()

    # ---- the trainer cases ----
    for case, c in TRAIN.items():
        mesh = make_mesh(c["dp"], c["tp"])
        mi = MeshInfo.from_mesh(mesh)
        tr = make_trainer(Model(cfg, mi), mesh, scheme=c["scheme"],
                          opt_cfg=AdamConfig(lr=1e-3))
        params = load(tr.model, mesh)
        ostate, cstate = tr.opt_init(params), tr.init_codec_state()
        data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=GB,
                                          seed=0))
        bspecs = batch_specs(cfg, mi)
        losses, gnorms, ledger = [], [], None
        for step in range(STEPS):
            nb = dict(data.batch(step), frames=data.frames(step, cfg.d_model))
            batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
                     for k, v in nb.items()}
            with comms.record_traffic() as events:
                params, ostate, cstate, m = tr.step(params, ostate, cstate,
                                                    batch)
            if ledger is None:
                ledger = roofline.ledger_summary(events, train=True)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out["train"][case] = dict(losses=losses, gnorms=gnorms,
                                  per_dim_level=ledger["per_dim_level"],
                                  per_site=ledger["per_site"])
        jax.clear_caches()

    # ---- serving ----
    prompts = serve_prompts()
    frames = make_frames(B_SRV, S_SRV, cfg.d_model, SERVE_SEED)

    def np_caches(caches):
        return [None if c is None else
                {k: np.asarray(v) for k, v in c.items()} for c in caches]

    def ledger_of(events):
        return roofline.ledger_summary(events, train=False)["per_dim_level"]

    for case, c in SERVE.items():
        tp, sm = c["tp"], s_max(c["tp"])
        host = {"tokens": prompts, "labels": prompts, "frames": frames}
        if c["mode"] == "batched":
            mesh = make_mesh(1, tp)
            mi = MeshInfo.from_mesh(mesh)
            model = Model(cfg, mi)
            srv = Server(model, mesh, scheme=SERVE_SCHEME)
            bspecs = batch_specs(cfg, mi)
            batch = {k: jax.device_put(jnp.asarray(v),
                                       NamedSharding(mesh, bspecs[k]))
                     for k, v in host.items()}
            with comms.record_traffic() as ev_p:
                tok, caches = srv.prefill_step(
                    {k: bspecs[k] for k in batch}, B_SRV)(load(model, mesh),
                                                          batch)
            pre = np_caches(caches)
            dec, structs, cspecs = srv.decode_step(B_SRV, sm, s_enc=S_SRV)
            padded = []            # the reference launcher's host pad
            for st, cs, pc in zip(structs, cspecs, pre):
                if st is None:
                    padded.append(None)
                    continue
                new = {}
                for k, v in st.items():
                    if k == "xlen":
                        a = np.full(v.shape, S_SRV, np.int32)
                    else:
                        a = np.zeros(v.shape, v.dtype)
                        a[tuple(slice(0, d) for d in pc[k].shape)] = pc[k]
                    new[k] = jax.device_put(jnp.asarray(a),
                                            NamedSharding(mesh, cs[k]))
                padded.append(new)
            params = load(model, mesh)
            toks, caches, ev_d = [np.asarray(tok)], padded, None
            after = np_caches(padded)
            for i in range(1, GEN):
                tok_in = jax.device_put(
                    jnp.asarray(toks[-1])[:, None],
                    NamedSharding(mesh, P(mi.batch_axes, None)))
                with comms.record_traffic() as ev:
                    t, caches = dec(params, tok_in, caches,
                                    jnp.int32(S_SRV + i - 1))
                ev_d = ev_d if ev_d is not None else list(ev)
                toks.append(np.asarray(t))
            out["serve"][case] = dict(
                tokens=np.stack(toks, 1), prefill=pre, padded=after,
                final=np_caches(caches), ledger_prefill=ledger_of(ev_p),
                ledger_decode=ledger_of(ev_d))
        else:
            mesh = make_disagg_mesh(1, tp)
            mi = MeshInfo.from_mesh(mesh)
            model = Model(cfg, mi)
            srv = DisaggServer(model, mesh, scheme=SERVE_SCHEME,
                               kv_codec=KV_CODEC)
            params = load(model, mesh)
            bspecs = batch_specs(cfg, mi)
            staged = srv.stage_batch(host, bspecs)
            tok0, caches = srv.prefill_step({k: bspecs[k] for k in staged},
                                            B_SRV)(params, staged)
            padded = srv.pad_prefill_caches(
                jax.tree.map(np.asarray, caches), B_SRV, sm, s_enc=S_SRV)
            with comms.record_traffic() as ev_h:
                padded = srv.handoff_step(B_SRV, sm, s_enc=S_SRV)(padded)
                jax.block_until_ready(padded)
            hand = [None if c_ is None else
                    {k: np.asarray(v)[DECODE] for k, v in c_.items()}
                    for c_ in padded]
            dec = srv.decode_step(B_SRV, sm, s_enc=S_SRV)
            toks = [np.asarray(tok0)[0]]
            for i in range(1, GEN):
                g = np.zeros((2, B_SRV, 1), np.int32)
                g[DECODE] = toks[-1][:, None]
                tok_in = jax.device_put(jnp.asarray(g), NamedSharding(
                    mesh, P("pool", mi.batch_axes, None)))
                t, padded = dec(params, tok_in, padded,
                                jnp.int32(S_SRV + i - 1))
                toks.append(np.asarray(t)[DECODE])
            out["serve"][case] = dict(tokens=np.stack(toks, 1),
                                      handoff=hand,
                                      ledger_handoff=ledger_of(ev_h))
        jax.clear_caches()

    # ---- C.23: the loss at cp 1 and cp 2, the same weights and batch ----
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=GB, seed=0))
    nb = dict(data.batch(0), frames=data.frames(0, cfg.d_model))
    for cp in (1, 2):
        mesh = make_mesh(1, 1, cp=cp)
        model = Model(cfg, MeshInfo.from_mesh(mesh))
        bs = batch_specs(cfg, model.mi)

        def loss(p, b, model=model):
            with comms.vma_mode(False):
                return model.loss_fn(p, b)[0]
        batch = {k: jax.device_put(v, NamedSharding(mesh, bs[k]))
                 for k, v in nb.items()}  # cp 1: zigzag_shard_seq is id.
        if cp > 1:
            from repro.train.train_step import zigzag_shard_seq
            batch = {k: jax.device_put(v, NamedSharding(mesh, bs[k]))
                     for k, v in zigzag_shard_seq(nb, cp).items()}
        with schemes.use("baseline"):
            out["faults"][("cp", cp)] = float(jax.jit(compat.shard_map(
                loss, mesh=mesh, in_specs=(model.specs(), bs),
                out_specs=P(), check_vma=False))(load(model, mesh), batch))

        def enc_pos(fr, model=model):
            return model._positions(fr.shape[0], fr.shape[1])
        # the positions the encoder gives each cp rank's frames (the
        # frames are not split over cp: every rank holds them all)
        out["faults"][("cp_pos", cp)] = np.asarray(jax.jit(compat.shard_map(
            enc_pos, mesh=mesh, in_specs=(bs["frames"],),
            out_specs=P(None, "cp") if cp > 1 else P(), check_vma=False))(
            batch["frames"]))
    jax.clear_caches()

    # ---- C.22: the reference's launchers feed no frames ----
    from repro.launch import serve as jserve, train as jtrain
    for name, mod, argv in (
            ("train", jtrain, ["--arch", "whisper-base", "--reduced",
                               "--steps", "1"]),
            ("disagg", jserve, ["--arch", "whisper-base", "--reduced",
                                "--mode", "disagg", "--gen", "2"])):
        saved = sys.argv
        sys.argv = [name] + argv
        try:
            mod.main()
            out["faults"][name] = None
        except Exception as e:            # noqa: BLE001 - recorded as is
            out["faults"][name] = (type(e).__name__, str(e))
        finally:
            sys.argv = saved
    tmp = args["out"] + ".part"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, args["out"])


# --------------------------------------------------------------------------
# one subprocess per pytest session
# --------------------------------------------------------------------------

def _shared_dir(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def start(tmp_path_factory):
    """Start the reference subprocess unless another worker of this
    session did; returns a function that waits for its result (the
    unpickled dict) and a cleanup function."""
    root = _shared_dir(tmp_path_factory)
    out, err = root / "encdec_ref.pkl", root / "encdec_ref.err"
    proc = None
    with open(root / "encdec_ref.lock", "a+") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        started = root / "encdec_ref.started"
        if not started.exists():
            tree = root / "encdec_ref_tree.pkl"
            with open(tree, "wb") as f:
                pickle.dump(weights(), f)
            env = {**os.environ,
                   "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
                   "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                   "JAX_PLATFORMS": "cpu"}
            errf = open(err, "w")
            proc = subprocess.Popen(
                [sys.executable, __file__, "--reference",
                 json.dumps(dict(tree=str(tree), out=str(out)))],
                env=env, stdout=subprocess.DEVNULL, stderr=errf, text=True)
            errf.close()
            started.touch()

    def wait() -> dict:
        t0 = time.time()
        while not out.exists():
            if proc is not None and proc.poll() not in (None, 0):
                raise RuntimeError("reference failed:\n"
                                   + err.read_text()[-4000:])
            if proc is None and (root / "encdec_ref.failed").exists():
                raise RuntimeError("reference failed:\n"
                                   + err.read_text()[-4000:])
            if time.time() - t0 > TIMEOUT:
                raise TimeoutError("the reference did not finish")
            time.sleep(0.2)
        with open(out, "rb") as f:
            return pickle.load(f)

    def cleanup() -> None:
        if proc is None:
            return
        if proc.poll() is None:
            try:
                proc.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            (root / "encdec_ref.failed").touch()
    return wait, cleanup


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    try:
        _reference(json.loads(sys.argv[2]))
    except BaseException:
        a = json.loads(sys.argv[2])
        Path(a["out"]).with_suffix(".failed").touch()
        raise
