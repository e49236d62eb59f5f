"""gemma3-4b [dense] — 34L d=2560 8H (GQA kv=4) ff=10240 vocab=262144.

5:1 local:global sliding-window pattern.  [hf:google/gemma-3-*-pt; unverified]
"""

from repro_torch.models.config import ArchConfig, local_global_groups

_WINDOW = 1024

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    groups=local_global_groups(34, pattern=5, window=_WINDOW),
    sliding_window=_WINDOW,
    qk_norm=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    mlp_kind="geglu",
    tie_embeddings=True,
    scale_embed=True,
    long_context_ok=True,
    notes="8 q-heads < tp=16 -> ring/SP attention mode",
)
