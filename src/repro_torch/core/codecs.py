"""Codec registry, stateless part: ``none`` and the fixed-rate ``bq*`` family.

Mirrors ``repro.core.codecs`` for what the paged serving path needs: the
codec names, their wire rate, and the per-row plane layout that the paged
KV pool stores at rest.  The other families of the reference (``mpc``,
``gq*``, ``tq*``, ``ef:<codec>``, ``plr<rank>``) are not yet ported;
:func:`get` names them as such.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import bq
from repro_torch.kernels.ref import BLOCK


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: identity (uncompressed) wire, no carried state."""

    name: str = "none"
    lossless: bool = True

    def wire_bits_per_value(self, dtype=torch.float32) -> float:
        return torch.empty((), dtype=dtype).element_size() * 8


@dataclasses.dataclass(frozen=True)
class BqCodec(Codec):
    """Fixed-rate block quantization at ``bits`` bits/value."""

    name: str = "bq"
    lossless: bool = False
    bits: int = 8

    def __post_init__(self):
        object.__setattr__(self, "name", f"bq{self.bits}")

    def wire_bits_per_value(self, dtype=torch.float32) -> float:
        return self.bits + 32.0 / BLOCK  # mantissa + per-row f32 scale

    def storage_row_layout(self):
        """``{plane: (lane_width, dtype)}`` for one BLOCK-wide row stored at
        rest: ``q_hi`` (nibble-packed to 64 lanes at rate 4), ``q_lo`` only
        at rate 24, and the per-row f32 ``scale``."""
        out = {"q_hi": (bq.hi_width(self.bits), bq.hi_dtype(self.bits)),
               "scale": (1, torch.float32)}
        if self.bits == 24:
            out["q_lo"] = (BLOCK, torch.uint8)
        return out


NONE = Codec()
BQ4 = BqCodec(bits=4)
BQ8 = BqCodec(bits=8)
BQ16 = BqCodec(bits=16)
BQ24 = BqCodec(bits=24)

_REGISTRY = {c.name: c for c in (NONE, BQ4, BQ8, BQ16, BQ24)}

# registered in the reference, not yet in this package
_NOT_YET = ("mpc", "gq8", "tq8", "tq4")


def names() -> list[str]:
    """Registered codec names."""
    return sorted(_REGISTRY)


def get(name) -> Codec:
    if isinstance(name, Codec):
        return name
    c = _REGISTRY.get(name)
    if c is not None:
        return c
    if isinstance(name, str) and (name in _NOT_YET or name.startswith("ef:")
                                  or name.startswith("plr")):
        raise NotImplementedError(f"codec {name!r} is not yet ported; "
                                  f"have {names()}")
    raise KeyError(f"unknown codec {name!r}; have {names()}")
