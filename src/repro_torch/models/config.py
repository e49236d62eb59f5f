"""Architecture configuration (copy of ``repro.models.config`` for the
fields and group plans this package uses)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BlockGroup:
    """A run of ``n`` identical layers.

    kind: attn | moe | mamba | mlstm | slstm | enc_attn | dec_attn | shared_attn
    window: sliding-window size for attention (0 = full)
    """

    kind: str
    n: int
    window: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # layer plan; empty -> [BlockGroup("attn", n_layers)]
    groups: tuple = ()

    # attention
    attn_mode: str = "auto"          # auto | head | ring
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0   # gemma3: separate theta for global layers
    mrope: bool = False              # qwen2-vl M-RoPE (3-section positions)
    sliding_window: int = 0
    causal: bool = True

    # embeddings / head
    tie_embeddings: bool = True
    scale_embed: bool = False        # gemma3: x *= sqrt(d_model)
    vocab_round_to: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    moe_d_ff: int = 0                # per-expert hidden (kimi/qwen3 style)

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0              # zamba2: shared attn after every k mamba layers

    # xLSTM
    slstm_every: int = 0             # 1 sLSTM per k blocks (rest mLSTM)
    proj_factor: float = 2.0

    # enc-dec (whisper backbone)
    encoder_layers: int = 0
    encoder_seq: int = 0             # 0 -> same as seq

    # norm / numerics
    norm: str = "rms"                # rms | ln
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu | relu2
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True

    # distribution
    fsdp_params: bool = False
    moe_ws: bool = False             # weight-stationary experts: expert F
    #                                  sharded over 'data'; decode moves
    #                                  tokens (AG/RS), not expert weights
    long_context_ok: bool = False
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round_to
        return -(-self.vocab_size // r) * r

    @property
    def layer_groups(self) -> tuple:
        if self.groups:
            return self.groups
        return (BlockGroup("attn", self.n_layers),)

    @property
    def d_inner(self) -> int:
        """SSM / xLSTM inner width."""
        return self.ssm_expand * self.d_model

    def attn_mode_for(self, tp: int) -> str:
        """head-sharded TP needs q and kv heads divisible by tp; else ring/SP."""
        if self.attn_mode != "auto":
            return self.attn_mode
        if self.n_heads % tp == 0 and self.n_kv_heads % tp == 0:
            return "head"
        return "ring"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def truncated(self, n_layers: int) -> "ArchConfig":
        """The first ``n_layers`` layers of the stack, its layer groups
        (gemma3's local:global pattern, their windows) kept: a cut of
        depth for memory, where the launcher's ``layers`` resets the
        stack to uniform layers.  A ``shared_attn`` insertion is not a
        layer of ``n_layers`` (zamba2 counts its mamba layers): it is kept
        where the group before it is kept whole, so zamba2's first 12
        layers are two whole ``[6 x mamba, shared_attn]`` blocks.  Nor is
        an ``enc_attn`` layer (whisper's ``n_layers`` counts its decoder):
        the encoder stack is kept whole."""
        if not 0 < n_layers <= self.n_layers:
            raise ValueError(f"cannot keep {n_layers} of {self.n_layers} "
                             "layers")
        out, left, whole = [], n_layers, True
        for g in self.layer_groups:
            if g.kind == "enc_attn":
                out.append(g)
                continue
            if g.kind == "shared_attn":
                if whole and out:
                    out.append(g)
                continue
            whole = left >= g.n
            if left:
                out.append(dataclasses.replace(g, n=min(g.n, left)))
                left -= out[-1].n
        return self.replace(n_layers=n_layers, groups=tuple(out))

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke-test variant (same as the reference's)."""
        kw = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128, vocab_size=512, head_dim=16, dtype="float32", remat=False,
            fsdp_params=False, groups=(),
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=2, moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=8, ssm_head_dim=8)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        if self.sliding_window:
            kw.update(sliding_window=8)
        cfg = self.replace(**kw)
        object.__setattr__(cfg, "groups", _reduced_groups(self, cfg))
        return cfg


def _reduced_groups(full: ArchConfig, small: ArchConfig) -> tuple:
    kinds = {g.kind for g in full.layer_groups}
    g = []
    if "mamba" in kinds:
        g += [BlockGroup("mamba", 2)]
    if "shared_attn" in kinds:
        g += [BlockGroup("shared_attn", 1)]
    if "mlstm" in kinds:
        g += [BlockGroup("mlstm", 1)]
    if "slstm" in kinds:
        g += [BlockGroup("slstm", 1)]
    if "moe" in kinds:
        g += [BlockGroup("moe", 2)]
    if "enc_attn" in kinds:
        g += [BlockGroup("dec_attn", 2)]
    if not g:
        w = small.sliding_window
        if full.rope_theta_global:  # gemma3-style local/global pattern
            g = [BlockGroup("attn", 1, window=w), BlockGroup("attn", 1, window=0)]
        else:
            g = [BlockGroup("attn", 2, window=0)]
    return tuple(g)


def local_global_groups(n_layers: int, pattern: int, window: int) -> tuple:
    """gemma3-style repeating [pattern x local, 1 x global] plan."""
    per = pattern + 1
    out = []
    full_blocks, rem = divmod(n_layers, per)
    for _ in range(full_blocks):
        out.append(BlockGroup("attn", pattern, window=window))
        out.append(BlockGroup("attn", 1, window=0))
    if rem:
        out.append(BlockGroup("attn", rem, window=window))
    return tuple(out)


def hybrid_groups(n_mamba: int, attn_every: int) -> tuple:
    """zamba2-style [attn_every x mamba, shared attn] plan."""
    out = []
    full_blocks, rem = divmod(n_mamba, attn_every)
    for _ in range(full_blocks):
        out.append(BlockGroup("mamba", attn_every))
        out.append(BlockGroup("shared_attn", 1))
    if rem:
        out.append(BlockGroup("mamba", rem))
    return tuple(out)


def xlstm_groups(n_layers: int, slstm_every: int) -> tuple:
    """xLSTM's repeating [slstm_every - 1 x mLSTM, 1 x sLSTM] plan."""
    out = []
    full_blocks, rem = divmod(n_layers, slstm_every)
    for _ in range(full_blocks):
        out.append(BlockGroup("mlstm", slstm_every - 1))
        out.append(BlockGroup("slstm", 1))
    if rem:
        out.append(BlockGroup("mlstm", rem))
    return tuple(out)


def encdec_groups(enc: int, dec: int) -> tuple:
    """whisper's plan: ``enc`` encoder layers, then ``dec`` decoder layers
    (self-attention, cross-attention to the encoder's output, MLP)."""
    return (BlockGroup("enc_attn", enc), BlockGroup("dec_attn", dec))


def moe_groups(n_layers: int, first_dense: int = 0) -> tuple:
    """``first_dense`` dense attention layers, then MoE layers."""
    out = []
    if first_dense:
        out.append(BlockGroup("attn", first_dense))
    out.append(BlockGroup("moe", n_layers - first_dense))
    return tuple(out)
