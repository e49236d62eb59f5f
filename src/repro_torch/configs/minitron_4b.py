"""minitron-4b [dense] — 32L d=3072 24H (GQA kv=8) ff=9216 vocab=256000.

Pruned Nemotron.  [arXiv:2407.14679; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10_000.0,
    mlp_kind="relu2",
    tie_embeddings=False,
    long_context_ok=False,
    notes="24 q-heads % 16 != 0 -> ring/SP attention mode",
)
