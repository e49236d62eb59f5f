"""qwen2-72b [dense] — 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064.

GQA with QKV bias.  [arXiv:2407.10671; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    fsdp_params=True,        # 72B bf16 params don't fit replicated over dp
    long_context_ok=False,   # pure full attention: long_500k skipped
    notes="kv=8 < tp=16 -> ring attention (no KV-head duplication); "
          "ZeRO-3 param sharding over the data axis",
)
