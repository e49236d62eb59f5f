"""kimi-k2-1t-a32b [moe] — 61L d=7168 64H (GQA kv=8) expert-ff=2048
vocab=163840, MoE 384 experts top-8 + shared expert; first layer dense.

Trillion-parameter MoE (paper-table config).  [arXiv:2501.kimi2; unverified]
"""

from repro_torch.models.config import ArchConfig, moe_groups

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,              # dense first layer
    moe_d_ff=2048,           # per-expert hidden
    vocab_size=163840,
    groups=moe_groups(61, first_dense=1),
    n_experts=384,
    top_k=8,
    shared_expert=True,
    capacity_factor=1.25,
    rope_theta=50_000.0,
    tie_embeddings=False,
    fsdp_params=True,        # ~1T params: full ZeRO-3 over the data axis
    long_context_ok=False,
    notes="EP=16 over 'model' (24 experts/chip) + ZeRO-3 over 'data'; "
          "kv=8 < tp=16 -> ring attention",
)
