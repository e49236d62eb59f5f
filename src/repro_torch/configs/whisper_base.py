"""whisper-base [audio] — enc-dec 6L+6L d=512 8H ff=2048 vocab=51865
(the reference's config).

Transformer backbone only; the conv audio frontend is a stub: the batch
carries precomputed frame embeddings (``frames``).  Vocab 51865 is padded
to 51968 (a multiple of 128) for vocab-parallel sharding; the logical
size stays in the config.  [arXiv:2212.04356; unverified]
"""

from repro_torch.models.config import ArchConfig, encdec_groups

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,              # decoder layers
    encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    groups=encdec_groups(6, 6),
    norm="ln",
    mlp_kind="gelu",
    tie_embeddings=True,
    long_context_ok=False,
    notes="backbone uses RoPE in place of whisper's learned positions "
          "(frontend/positions are stubbed per the assignment); "
          "8 heads < tp=16 -> ring attention",
)
