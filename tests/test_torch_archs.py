"""The port's other dense decoders (qwen2-72b, gemma3-4b, minitron-4b,
qwen2-vl-72b), its Mixture-of-Experts decoders (qwen3-moe-235b-a22b,
kimi-k2-1t-a32b), its recurrent families (zamba2-1.2b, xlstm-1.3b) and
whisper-base's encoder-decoder backbone beside gemma3-1b, against the
reference, at ``--reduced`` on one device.

Contract asserted here, with the tolerances and their reasons:
  * for each ported architecture, on the reference's weights
    (``from_jax_params``) and the reference's ``make_batch`` inputs
    (``tests/test_arch_smoke.py``: tokens and labels from a numpy seed,
    for whisper the encoder's stub ``frames``, and for qwen2-vl the
    ``vision`` embeddings merged under ``vis_mask`` and the M-RoPE ids
    ``pos3``), the loss within rtol 1e-5 and every
    parameter's gradient within 1e-4 of its largest entry (f32 throughout;
    the frameworks order the matmul and softmax sums differently, an ulp
    or so per op; the untied head, qkv bias, relu2, M-RoPE and the MoE
    load-balance term included);
  * ``apply_mrope`` within 1e-6 of the reference's (f32 cos and sin of
    the same angles) and ``mrope_sections`` equal;
  * the full configs carry the reference's dims, and their plans (built
    without allocating) the reference's parameter counts, layer plans and
    plausible sizes, as ``test_full_config_dims`` and
    ``test_param_counts_plausible`` hold the reference's;
  * every architecture of the reference is ported: ``get`` returns its
    config;
  * gradient accumulation (pp 1) takes qwen2-vl's vision and M-RoPE ids
    microbatch by microbatch, to the flat loss within rtol 1e-6, and a
    stage mesh refuses M-RoPE, as the reference's pipeline does.
"""

import numpy as np
import pytest

from repro_torch import configs as tconfigs

PORTED = ("gemma3-1b", "qwen2-72b", "gemma3-4b", "minitron-4b",
          "qwen2-vl-72b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
          "zamba2-1.2b", "xlstm-1.3b", "whisper-base")


def test_registry_splits_ported_and_not_yet():
    from repro import configs as jconfigs
    assert tconfigs.ARCH_IDS == PORTED
    assert set(PORTED) == set(jconfigs.ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("whisper-tiny")


@pytest.mark.parametrize("arch", ("whisper-base",))
def test_last_ported_arch_is_the_reference_config(arch):
    """whisper-base, the last architecture the port took, is the
    reference's: the encoder-decoder family with 6 + 6 layers, tied
    embeddings, LayerNorm and GELU."""
    from repro import configs as jconfigs
    cfg, ref = tconfigs.get(arch), jconfigs.get(arch)
    assert cfg.family == ref.family == "encdec"
    assert (cfg.encoder_layers, cfg.encoder_seq, cfg.padded_vocab) == \
        (ref.encoder_layers, ref.encoder_seq, ref.padded_vocab) == \
        (6, 0, 51968)
    assert [(g.kind, g.n) for g in cfg.layer_groups] == \
        [(g.kind, g.n) for g in ref.layer_groups] == \
        [("enc_attn", 6), ("dec_attn", 6)]


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference(arch):
    """Every field the port's config carries equals the reference's, at
    full size and at ``--reduced``."""
    import dataclasses

    from repro import configs as jconfigs
    for t, j in ((tconfigs.get(arch), jconfigs.get(arch)),
                 (tconfigs.get(arch).reduced(), jconfigs.get(arch).reduced())):
        for f in dataclasses.fields(t):
            want = getattr(j, f.name)
            got = getattr(t, f.name)
            if f.name == "groups":
                got = [dataclasses.astuple(g) for g in got]
                want = [dataclasses.astuple(g) for g in want]
            assert got == want, (arch, f.name)


@pytest.mark.parametrize("arch", PORTED)
def test_full_config_dims(arch):
    """The full configs carry the exact assigned dims (no allocation)."""
    cfg = tconfigs.get(arch)
    brief = {
        "gemma3-1b": (26, 1152, 4, 1, 6912, 262144),
        "qwen2-72b": (80, 8192, 64, 8, 29568, 152064),
        "gemma3-4b": (34, 2560, 8, 4, 10240, 262144),
        "minitron-4b": (32, 3072, 24, 8, 9216, 256000),
        "qwen2-vl-72b": (80, 8192, 64, 8, 29568, 152064),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 0, 151936),
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 18432, 163840),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "xlstm-1.3b": (48, 2048, 4, 4, 0, 50304),
        "whisper-base": (6, 512, 8, 8, 2048, 51865),
    }[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == brief
    # zamba2's shared-attention insertions are groups, not layers, and
    # whisper's n_layers counts its decoder (as the reference's
    # test_full_config_dims counts them)
    shared = sum(1 for g in cfg.layer_groups if g.kind == "shared_attn")
    assert sum(g.n for g in cfg.layer_groups) == \
        cfg.n_layers + cfg.encoder_layers + shared


def test_param_counts_plausible():
    """Plan sizes in the right ballpark for the headline sizes, and equal
    to the reference's plans (built without allocating, full width)."""
    from repro import configs as jconfigs
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo, count_params
    from repro_torch.models import transformer
    from repro_torch.models.params import MeshInfo, defs

    bounds = {"gemma3-1b": (0.7e9, 2.1e9), "qwen2-72b": (60e9, 85e9),
              "gemma3-4b": (3e9, 5.5e9), "minitron-4b": (3e9, 5.5e9),
              "qwen2-vl-72b": (60e9, 85e9),
              "qwen3-moe-235b-a22b": (220e9, 250e9),
              "kimi-k2-1t-a32b": (0.9e12, 1.1e12),
              "zamba2-1.2b": (0.8e9, 2.0e9), "xlstm-1.3b": (0.8e9, 2.0e9),
              "whisper-base": (0.05e9, 0.1e9)}
    for arch, (lo, hi) in bounds.items():
        n = sum(d.size() for d in defs(transformer.model_plan(
            tconfigs.get(arch), MeshInfo())))
        assert lo <= n <= hi, (arch, n)
        assert n == count_params(JModel(jconfigs.get(arch),
                                        JMeshInfo()).plan), arch


def test_mrope_matches_reference():
    import jax.numpy as jnp
    import torch

    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    rng = np.random.default_rng(0)
    for hd in (16, 128):
        assert tlayers.mrope_sections(hd) == jlayers.mrope_sections(hd)
        x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
        pos3 = rng.integers(0, 4096, (2, 12, 3)).astype(np.int32)
        want = np.asarray(jlayers.apply_mrope(jnp.asarray(x),
                                              jnp.asarray(pos3), 1e6))
        got = tlayers.apply_mrope(torch.from_numpy(x),
                                  torch.from_numpy(pos3), 1e6).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # all three sections at one position: the plain rope, bit for bit
    pos = torch.from_numpy(rng.integers(0, 512, (2, 12)).astype(np.int32))
    xt = torch.from_numpy(x)
    assert torch.equal(tlayers.apply_mrope(xt, pos[..., None].expand(2, 12, 3),
                                           1e6),
                       tlayers.apply_rope(xt, pos, 1e6))


def _make_batch(cfg, B=2, S=16, seed=0):
    """``tests/test_arch_smoke.py``'s ``make_batch``, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope:
        batch["vision"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
        batch["vis_mask"] = rng.integers(0, 2, (B, S)) > 0
        batch["pos3"] = np.broadcast_to(
            np.arange(S)[None, :, None], (B, S, 3)).astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_grads_match_reference(arch):
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.core import comms as jcomms, compat
    from repro.models.model import Model as JModel
    from repro.models.params import MeshInfo as JMeshInfo, Pv
    from repro_torch.models.model import Model as TModel
    from repro_torch.models.params import from_jax_params, leaves

    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jcfg = jconfigs.get(arch).reduced()
    jmodel = JModel(jcfg, JMeshInfo.from_mesh(mesh))
    jparams = jmodel.init(jax.random.key(1))
    batch = _make_batch(jcfg)
    bspecs = {k: P("data", *([None] if v.ndim == 2 else [None, None]))
              for k, v in batch.items()}
    if jcfg.mrope:       # as make_batch's specs (one device: no split)
        bspecs.update(vision=P("data", "model", None),
                      vis_mask=P("data", "model"),
                      pos3=P("data", "model", None))

    def f(params, b):
        with jcomms.vma_mode(False):
            (loss, _), grads = jax.value_and_grad(jmodel.loss_fn,
                                                  has_aux=True)(params, b)
        return loss, grads
    specs = jmodel.specs()
    jloss, jgrads = jax.jit(compat.shard_map(
        f, mesh=mesh, in_specs=(specs, bspecs), out_specs=(P(), specs),
        check_vma=False))(jparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()})

    tcfg = tconfigs.get(arch).reduced()
    tmodel = TModel(tcfg, device="cpu")
    tparams = from_jax_params(
        jax.tree.map(lambda pv: np.asarray(pv.v), jparams,
                     is_leaf=lambda x: isinstance(x, Pv)), tcfg, "cpu")
    ts = [t.requires_grad_(True) for _, t in leaves(tmodel.plan, tparams)]
    tloss, _ = tmodel.loss_fn(tparams, {k: torch.from_numpy(np.array(v))
                                        for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, ts)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jg = [np.asarray(pv.v) for pv in jax.tree_util.tree_leaves(
        jgrads, is_leaf=lambda x: isinstance(x, Pv))]
    assert len(jg) == len(tgrads)
    for a, b in zip(jg, tgrads):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


def test_pipeline_takes_mrope_at_pp1_and_refuses_it_at_pp2():
    """As the reference's pipeline: gradient accumulation (pp 1) runs
    qwen2-vl's vision merge and M-RoPE ids microbatch by microbatch, to the
    flat loss within rtol 1e-6 (the two microbatches' sums, then their
    ratio); a stage mesh refuses M-RoPE, whose ids are cross-stage
    context (the reference asserts the same)."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.models.params import MeshInfo
    from repro_torch.train.pipeline import pipeline_loss_fn

    cfg = tconfigs.get("qwen2-vl-72b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(1)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in _make_batch(cfg).items()}
    # sections that differ (make_batch's are equal: the plain rope)
    s = torch.arange(batch["tokens"].shape[1], dtype=torch.int32)
    batch["pos3"] = torch.stack([s, s // 2, s % 4], -1)[None].expand(
        batch["tokens"].shape[0], -1, -1)
    want, _ = model.loss_fn(params, batch)
    got, _, _ = pipeline_loss_fn(model, 2)(params, batch)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    # without pos3 the plain rope runs: another loss (the ids are used)
    plain, _ = model.loss_fn(params, {k: v for k, v in batch.items()
                                      if k != "pos3"})
    assert plain.item() != want.item()
    with pytest.raises(ValueError, match="not pipelineable"):
        pipeline_loss_fn(Model(cfg, MeshInfo(pp=2), device="cpu"), 2)
