"""xlstm-1.3b [ssm] — 48L d=2048 4H ff=0 vocab=50304, sLSTM + mLSTM blocks.

7:1 mLSTM:sLSTM block ratio.  [arXiv:2405.04517; unverified]
"""

from repro_torch.models.config import ArchConfig, xlstm_groups

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,                  # no MLP; m/sLSTM blocks carry the capacity
    vocab_size=50304,
    groups=xlstm_groups(48, slstm_every=8),
    slstm_every=8,
    proj_factor=2.0,
    norm="ln",
    tie_embeddings=True,
    long_context_ok=True,    # O(1)-state recurrent decode
    notes="recurrent family: 'MP' codec governs projection AG/RS and "
          "cross-shard state ppermute (DESIGN.md §5)",
)
