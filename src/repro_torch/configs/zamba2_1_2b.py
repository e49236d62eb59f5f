"""zamba2-1.2b [hybrid] — 38L d=2048 32H ff=8192 vocab=32000, ssm_state=64.

Mamba2 blocks + one *shared* attention block applied every 6 mamba layers.
[arXiv:2411.15242; hf]
"""

from repro_torch.models.config import ArchConfig, hybrid_groups

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,             # mamba2 layers
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,               # shared attn block's MLP
    vocab_size=32000,
    groups=hybrid_groups(38, attn_every=6),
    attn_every=6,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    tie_embeddings=True,
    long_context_ok=True,    # hybrid: mamba state is O(1); shared attn windows
    notes="32 q/kv heads divide tp=16 -> head-sharded TP for the shared "
          "attention block; mamba channels sharded over model",
)
