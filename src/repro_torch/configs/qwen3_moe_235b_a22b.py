"""qwen3-moe-235b-a22b [moe] — 94L d=4096 64H (GQA kv=4) expert-ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-*; hf]
"""

from repro_torch.models.config import ArchConfig, moe_groups

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                  # all layers MoE
    moe_d_ff=1536,
    vocab_size=151936,
    groups=moe_groups(94),
    n_experts=128,
    top_k=8,
    qk_norm=True,
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    fsdp_params=True,
    long_context_ok=False,
    notes="EP=16 over 'model' (8 experts/chip); kv=4 < tp=16 -> ring attention",
)
