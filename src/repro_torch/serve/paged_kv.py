"""Paged KV cache with bq storage codecs (quantized at rest).

Port of ``repro.serve.paged_kv``.  KV state lives in a shared pool of
fixed-size blocks of ``block_tokens`` tokens; every request owns an
ordered block table.  The pool stores either raw model-dtype K/V
(``codec="none"``) or bq wire planes quantized at rest: each token's
feature vector (``KV x hd``) is padded to ``R`` rows of 128 lanes and
encoded per row, so

  * appending one token encodes only its own rows (the bq kernel);
  * an attention read decodes only the blocks its table names, straight
    from the compressed planes (the gather-decode kernel).

Pool layout of one rank (head attention mode; the reference's global
pool has its blocks sharded over the data ways and its heads, or its
token rows, over the model ways)::

  none  k/v   [L, nb, bt, KV_loc, hd]
  bq*   q_hi  [L, nb, bt, R, hi_w]
        q_lo  [L, nb, bt, R, 128]      (rate 24 only)
        scale [L, nb, bt, R, 1]

with ``nb = n_blocks / batch_ways`` this rank's blocks, ``KV_loc = KV /
tp`` its KV heads and ``R = ceil(KV_loc * hd / 128)``.  Unlike the
reference, whose arrays are immutable, :func:`write_token` updates the
pool in place: a step would otherwise copy every layer's pool.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import codecs
from repro_torch.kernels import ops
from repro_torch.kernels.bq import TILE_M
from repro_torch.kernels.ref import BLOCK
from repro_torch.models.config import ArchConfig, BlockGroup
from repro_torch.models.params import MeshInfo, torch_dtype

DEFAULT_BLOCK_TOKENS = 16

# the kinds whose caches page (the reference's list): a recurrent state
# has no KV cache to page, so those stacks keep the dense Server
_PAGED_KINDS = ("attn", "moe", "shared_attn")


def storage_bits(codec: str) -> int | None:
    """KV storage codec -> bq mantissa bits (None = dense, bit-exact).

    Only ``none`` and the stateless fixed-rate ``bq*`` family are valid
    at-rest codecs: storage needs random-access decode of single rows."""
    if codec in (None, "none"):
        return None
    c = codecs.get(codec)
    if not isinstance(c, codecs.BqCodec):
        raise ValueError(
            f"kv storage codec must be 'none' or a bq* codec (random-access"
            f" per-row decode); got {codec!r}")
    return c.bits


def blocks_needed(n_tokens: int, block_tokens: int) -> int:
    return -(-n_tokens // block_tokens)


def token_rows(kv_heads_loc: int, head_dim: int) -> int:
    """Quantized rows per token for one shard's feature vector."""
    return -(-kv_heads_loc * head_dim // BLOCK)


# --------------------------------------------------------------------------
# host-side block allocator
# --------------------------------------------------------------------------

class OutOfBlocks(RuntimeError):
    pass


class BlockAllocator:
    """Host-side free-list allocator over one block pool.

    Invariants: a live block has exactly one owner; ``alloc`` never hands
    out a block already owned; ``free`` returns blocks to the free list and
    double-frees raise."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, -1, -1))   # pop() -> 0 first
        self._owner: dict[int, object] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, owner) -> int:
        if not self._free:
            raise OutOfBlocks(f"all {self.n_blocks} KV blocks are live")
        b = self._free.pop()
        assert b not in self._owner, b
        self._owner[b] = owner
        return b

    def alloc_many(self, owner, k: int) -> list[int]:
        if k > self.n_free:
            raise OutOfBlocks(f"need {k} KV blocks, have {self.n_free}")
        return [self.alloc(owner) for _ in range(k)]

    def free(self, blocks) -> None:
        for b in blocks:
            if b not in self._owner:
                raise KeyError(f"block {b} is not live (double free?)")
            del self._owner[b]
            self._free.append(b)

    def owner(self, block: int):
        return self._owner.get(block)


# --------------------------------------------------------------------------
# pool structs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Struct:
    """Shape and dtype of one pool tensor (allocated by :func:`zero_pool`)."""

    shape: tuple
    dtype: torch.dtype


def pool_group(cfg: ArchConfig, mi: MeshInfo, g: BlockGroup, n_blocks: int,
               block_tokens: int, codec: str = "none"):
    """-> struct tree for this rank's share of one layer group's paged
    pool (``n_blocks`` is the GLOBAL pool size, as in the reference); a
    ``shared_attn`` group's pool is unstacked (one insertion point)."""
    if g.kind not in _PAGED_KINDS:
        raise NotImplementedError(
            f"paged KV cache supports attention-style groups "
            f"{_PAGED_KINDS}; group kind {g.kind!r} needs the dense-cache "
            f"Server")
    dt = torch_dtype(cfg.dtype)
    hd, KV = cfg.head_dim_, cfg.n_kv_heads
    if KV % mi.tp:
        raise ValueError(f"paged head-mode cache needs n_kv_heads ({KV}) "
                         f"divisible by tp ({mi.tp})")
    if n_blocks % mi.batch_ways:
        raise ValueError(f"n_blocks ({n_blocks}) must divide by the data "
                         f"ways ({mi.batch_ways})")
    bits = storage_bits(codec)
    bt, nb, kv = block_tokens, n_blocks // mi.batch_ways, KV // mi.tp
    L = () if g.kind == "shared_attn" else (g.n,)
    if bits is None:
        return {"k": Struct(L + (nb, bt, kv, hd), dt),
                "v": Struct(L + (nb, bt, kv, hd), dt)}
    r = token_rows(kv, hd)
    layout = codecs.get(codec).storage_row_layout()
    plane = {pl: Struct(L + (nb, bt, r, w), d)
             for pl, (w, d) in layout.items()}
    plane.setdefault("q_lo", None)
    return {"k": dict(plane), "v": dict(plane)}


def pool_structs(cfg: ArchConfig, mi: MeshInfo, n_blocks: int,
                 block_tokens: int = DEFAULT_BLOCK_TOKENS,
                 codec: str = "none"):
    """This rank's paged pool: a list of struct trees aligned with
    ``cfg.layer_groups`` (``n_blocks`` global)."""
    if cfg.attn_mode_for(mi.tp) != "head":
        raise NotImplementedError(
            "paged decode reads gather whole-sequence KV per slot, which "
            "requires the head-sharded attention mode")
    return [pool_group(cfg, mi, g, n_blocks, block_tokens, codec)
            for g in cfg.layer_groups]


def zero_pool(structs, device):
    """Allocate zeroed tensors for a struct tree on ``device``."""
    if structs is None:
        return None
    if isinstance(structs, Struct):
        return torch.zeros(structs.shape, dtype=structs.dtype, device=device)
    if isinstance(structs, dict):
        return {k: zero_pool(v, device) for k, v in structs.items()}
    return [zero_pool(v, device) for v in structs]


# --------------------------------------------------------------------------
# device-side read/write (one layer's pool)
# --------------------------------------------------------------------------

def _encode_token_rows(tok: torch.Tensor, bits: int, backend=None):
    """[N, KV, hd] -> per-token quantized row planes
    {q_hi [N,R,w], q_lo [N,R,128]|None, scale [N,R,1]}."""
    n = tok.shape[0]
    f = tok.shape[-2] * tok.shape[-1]
    r = -(-f // BLOCK)
    flat = tok.reshape(n, f).to(torch.float32)
    flat = torch.nn.functional.pad(flat, (0, r * BLOCK - f))
    rows = flat.reshape(n * r, BLOCK)
    m_pad = -(-rows.shape[0] // TILE_M) * TILE_M
    rows = torch.nn.functional.pad(rows, (0, 0, 0, m_pad - rows.shape[0]))
    wire = ops.bq_encode_blocks(rows, bits, backend)
    cut = lambda a: None if a is None else \
        a[:n * r].reshape(n, r, a.shape[-1])  # noqa: E731
    return {"q_hi": cut(wire["q_hi"]), "q_lo": cut(wire["q_lo"]),
            "scale": cut(wire["scale"])}


def write_token(pool: dict, blk: torch.Tensor, off: torch.Tensor,
                k_tok: torch.Tensor, v_tok: torch.Tensor,
                bits: int | None, backend=None) -> dict:
    """Write one new token per slot into its current block, in place.

    ``pool`` is one layer's pool; ``blk``/``off`` are [N] block ids and
    in-block offsets; a block id outside ``[0, n_blocks)`` drops that slot's
    write (how inactive slots are masked).  ``k_tok``/``v_tok`` are
    [N, KV, hd].  Returns ``pool``."""
    nb = (pool["k"] if bits is None else pool["k"]["q_hi"]).shape[0]
    live = torch.nonzero((blk >= 0) & (blk < nb)).squeeze(1)
    b, o = blk[live].long(), off[live].long()
    if bits is None:
        for nm, tok in (("k", k_tok), ("v", v_tok)):
            pool[nm][b, o] = tok[live].to(pool[nm].dtype)
        return pool
    for nm, tok in (("k", k_tok), ("v", v_tok)):
        planes = _encode_token_rows(tok, bits, backend)
        for pl, val in planes.items():
            if val is not None:
                pool[nm][pl][b, o] = val[live]
    return pool


def read_tables(pool: dict, tables: torch.Tensor, bits: int | None,
                kv_heads_loc: int, head_dim: int, out_dtype, backend=None):
    """Gather every slot's block table into contiguous per-slot K/V.

    ``tables`` [N, max_blocks] int32 block ids (padding entries may be any
    in-range id; the attention validity mask kills them).  Returns
    ``(k, v)`` of shape [N, max_blocks * bt, KV, hd]; under a bq storage
    codec the read decodes straight from the compressed planes, and on the
    card writes each token's ``KV * hd`` values in ``out_dtype`` in the same
    launch."""
    out = []
    for nm in ("k", "v"):
        if bits is None:
            g = pool[nm][tables.long()]               # [N, mb, bt, KV, hd]
            out.append(g.reshape(g.shape[0], -1, *g.shape[-2:]))
            continue
        dec = ops.bq_gather_decode(pool[nm], tables, bits, backend,
                                   dtype=out_dtype,
                                   width=kv_heads_loc * head_dim)
        out.append(dec.reshape(dec.shape[0], -1, kv_heads_loc, head_dim))
    return tuple(out)
