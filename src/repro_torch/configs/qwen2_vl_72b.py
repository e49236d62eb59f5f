"""qwen2-vl-72b [vlm] — 80L d=8192 64H (GQA kv=8) ff=29568 vocab=152064.

M-RoPE (3-section t/h/w rotary positions) + dynamic-resolution vision.
Backbone only: the patch-embedding frontend is a STUB — ``input_specs()``
provides precomputed patch embeddings merged into the token stream.
[arXiv:2409.12191; hf]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    fsdp_params=True,
    long_context_ok=False,
    notes="M-RoPE position ids [3, B, S] come from input_specs; vision "
          "frontend stubbed; kv=8 < tp=16 -> ring attention",
)
