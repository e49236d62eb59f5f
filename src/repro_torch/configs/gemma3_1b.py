"""gemma3-1b [dense] — 26L d=1152 4H (GQA kv=1) ff=6912 vocab=262144.

5:1 local(sliding-window):global attention, separate RoPE base for global
layers, 128k-class context.  [hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.models.config import ArchConfig, local_global_groups

_WINDOW = 512

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    groups=local_global_groups(26, pattern=5, window=_WINDOW),
    sliding_window=_WINDOW,
    qk_norm=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    mlp_kind="geglu",
    tie_embeddings=True,
    scale_embed=True,
    long_context_ok=True,
    notes="4 q-heads < tp=16 -> ring/SP attention mode on the production mesh",
)
