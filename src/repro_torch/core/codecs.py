"""Codec registry: the wire-compression schemes collectives can carry (port
of ``repro.core.codecs``).

* ``none`` — uncompressed baseline.
* ``mpc`` — the lossless MPC analogue: a full-size, bit-exact wire.
* ``bq4/bq8/bq16/bq24`` — fixed-rate block quantization (the ZFP-rate
  analogue), on the Hopper kernels of :mod:`repro_torch.kernels.bq`.
* ``gq8``, ``tq8``, ``tq4`` — the per-tensor-scale and truncating ablation
  codecs, in plain PyTorch as in the reference.
* ``ef:<codec>`` — error feedback around any lossy codec: compensate with
  the stashed residual, encode, stash the new quantization error.
* ``plr<rank>`` — PowerSGD-style low-rank projection with a warm-started
  factor; wire ``r*(m+n)`` floats instead of ``m*n``, on the Hopper
  kernels of :mod:`repro_torch.kernels.lowrank`.

Stateful protocol, as in the reference::

    state  = codec.init_state(shape, dtype, device)   # None: stateless
    wire, state = codec.encode(x, state)
    x~     = codec.decode(wire, shape, dtype)

``ef:*`` carries the residual (plus the inner codec's state: ``ef:plr8``
is PowerSGD with error feedback); ``plr*`` carries the factor ``Q``.  The
trainer threads a dict of these states through its step (template:
``CommPlan.codec_state_template``) and the comms entry points read and
write it through ``comms.codec_state_io``.

A codec turns a tensor into a *wire dict* whose tensors are what crosses
between ranks; :mod:`repro_torch.core.comms` moves those tensors.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

from repro_torch.kernels import bq, lowrank, ops
from repro_torch.kernels.ref import BLOCK


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: identity (uncompressed) wire, no carried state."""

    name: str = "none"
    lossless: bool = True

    # dispatch key of the stateful families ("ef" / "lowrank"); None for
    # stateless codecs
    kind: str | None = dataclasses.field(default=None, init=False, repr=False)

    @property
    def stateful(self) -> bool:
        return False

    def init_state(self, shape, dtype, device="cpu"):
        """Per-site state for a payload of ``shape``/``dtype`` on
        ``device``; ``None`` for stateless codecs."""
        return None

    def encode(self, x, state=None):
        return {"raw": x}, None

    def decode(self, wire, shape, dtype):
        return wire["raw"].reshape(shape).to(dtype)

    def decode_gathered(self, wire, shape, dtype, axis_dim: int):
        """Wire of S shards' encodes stacked on a leading axis (the
        all-gather's) -> the S decoded tensors of ``shape`` joined along
        ``axis_dim``: block decode, then :func:`ops.ungather`."""
        return ops.ungather(self.decode_blocks(wire), shape, dtype, axis_dim)

    def view_forms(self, x) -> bool:
        """Whether the ring reduce-scatter of ``x`` runs on the shard-view
        forms (``encode_view``, ``decode_add_encode_view``,
        ``decode_add_view``), reading each chunk in place, instead of the
        block forms on ``comms._split_for_scatter``'s f32 copy."""
        return False

    def wire_bits_per_value(self, dtype=torch.float32) -> float:
        return torch.empty((), dtype=dtype).element_size() * 8

    def wire_nbytes_for(self, n_elems: int) -> float:
        return n_elems * self.wire_bits_per_value() / 8.0

    @property
    def is_identity(self) -> bool:
        return True

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class MpcCodec(Codec):
    """Lossless MPC analogue: bit-exact wire, ratio 1.0."""

    name: str = "mpc"
    lossless: bool = True


@dataclasses.dataclass(frozen=True)
class BqCodec(Codec):
    """Fixed-rate block quantization at ``bits`` bits/value."""

    name: str = "bq"
    lossless: bool = False
    bits: int = 8

    def __post_init__(self):
        object.__setattr__(self, "name", f"bq{self.bits}")

    def encode(self, x, state=None):
        return ops.bq_encode(x, self.bits), None

    def decode(self, wire, shape, dtype):
        return ops.bq_decode(wire, self.bits, shape, dtype)

    def decode_gathered(self, wire, shape, dtype, axis_dim: int):
        """One kernel launch on the card (``bq.bq_decode_flat``)."""
        return ops.bq_decode_gathered(wire, self.bits, shape, dtype, axis_dim)

    # block-matrix fast path for the ring collectives
    def encode_blocks(self, x2d):
        return ops.bq_encode_blocks(x2d, self.bits)

    def decode_blocks(self, wire):
        return ops.bq_decode_blocks(wire, self.bits)

    def decode_add_encode_blocks(self, wire, local2d, want_sum=True):
        return ops.bq_decode_add_encode_blocks(wire, local2d, self.bits,
                                               want_sum=want_sum)

    def decode_add_blocks(self, wire, local2d):
        """Last ring hop: local + decode(wire), no re-encode."""
        return ops.bq_decode_add_blocks(wire, local2d, self.bits)

    # shard-view forms of the ring: the kernels, on the card
    def view_forms(self, x) -> bool:
        return ops.on_kernels(x) and x.dtype in (
            torch.float32, torch.bfloat16, torch.float16)

    def encode_view(self, view):
        return ops.bq_encode_view(view, self.bits)

    def decode_add_encode_view(self, wire, view):
        return ops.bq_decode_add_encode_view(wire, view, self.bits)

    def decode_add_view(self, wire, view, out):
        return ops.bq_decode_add_view(wire, view, self.bits, out)

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

    @property
    def is_identity(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class GqCodec(Codec):
    """Ablation codec: fixed-rate quantization with ONE scale per block
    matrix (per-tensor granularity), broadcast per 128-lane row on the
    wire so gathered wires keep the bq layout."""

    name: str = "gq"
    lossless: bool = False
    bits: int = 8

    def __post_init__(self):
        object.__setattr__(self, "name", f"gq{self.bits}")

    def _qmax(self):
        return float(2 ** (self.bits - 1) - 1)

    def encode(self, x, state=None):
        return self.encode_blocks(ops.to_blocks(x)), None

    def decode(self, wire, shape, dtype):
        return ops.from_blocks(self.decode_blocks(wire), shape, dtype)

    def encode_blocks(self, x2d):
        x2d = x2d.to(torch.float32)
        amax = x2d.abs().amax(dim=(-1, -2), keepdim=True)
        scale = torch.where(amax == 0.0, torch.ones_like(amax), amax)
        q = torch.clamp(torch.round(x2d / scale * self._qmax()),
                        -self._qmax(), self._qmax()).to(torch.int8)
        scale_b = scale.expand(*q.shape[:-1], 1).contiguous()
        return {"q_hi": q, "q_lo": None, "scale": scale_b}

    def decode_blocks(self, wire):
        return wire["q_hi"].to(torch.float32) * (wire["scale"] / self._qmax())

    def decode_add_encode_blocks(self, wire, local2d, want_sum=True):
        s = self.decode_blocks(wire) + local2d.to(torch.float32)
        return self.encode_blocks(s), s if want_sum else None

    def decode_add_blocks(self, wire, local2d):
        return self.decode_blocks(wire) + local2d.to(torch.float32)

    def wire_bits_per_value(self, dtype=torch.float32) -> float:
        return self.bits + 32.0 / BLOCK

    @property
    def is_identity(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class TqCodec(GqCodec):
    """Ablation codec: block-scaled quantization that truncates toward
    zero (the error profile of dropped bitplanes)."""

    name: str = "tq"

    def __post_init__(self):
        object.__setattr__(self, "name", f"tq{self.bits}")

    def encode_blocks(self, x2d):
        x2d = x2d.to(torch.float32)
        amax = x2d.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax == 0.0, torch.ones_like(amax), amax)
        q = torch.trunc(x2d / scale * self._qmax())
        q = torch.clamp(q, -self._qmax(), self._qmax()).to(torch.int8)
        return {"q_hi": q, "q_lo": None, "scale": scale}


# --------------------------------------------------------------------------
# carried-state families
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EfCodec(Codec):
    """Error-feedback wrapper: carry the inner codec's quantization error
    as a residual and re-inject it before the next encode (EF-SGD):
    ``xc = x + e_t``; transmit ``C(xc)``; ``e_{t+1} = xc - D(C(xc))``.
    Wire and rate are exactly the inner codec's; the carried residual is
    one f32 per payload element.  ``ef:plr<r>`` nests the low-rank
    codec's factor state under ``state["inner"]``.

    Memory: :meth:`compensate` can add the residual into a payload its
    caller gives up (``inplace``), and :meth:`next_state` can write the new
    residual into the old residual's buffer (``out``), whose value is spent
    once ``xc`` is formed.  At gemma3-1b's per-rank gradient each saves a
    2.15 GB copy."""

    name: str = "ef"
    lossless: bool = False
    inner: Codec = None

    kind = "ef"

    def __post_init__(self):
        if not isinstance(self.inner, Codec):
            raise KeyError("ef codec needs an inner codec ('ef:<codec>')")
        if self.inner.is_identity:
            raise KeyError(
                f"ef wraps *lossy* codecs (there is no error to feed back "
                f"for {self.inner.name!r})")
        if isinstance(self.inner, EfCodec):
            raise KeyError("ef:ef:* is redundant — one residual suffices")
        object.__setattr__(self, "name", f"ef:{self.inner.name}")

    @property
    def stateful(self) -> bool:
        return True

    def init_state(self, shape, dtype, device="cpu"):
        st = {"residual": torch.zeros(shape, dtype=torch.float32,
                                      device=device)}
        inner_st = self.inner.init_state(shape, dtype, device)
        if inner_st is not None:
            st["inner"] = inner_st
        return st

    def compensate(self, x, state, inplace: bool = False):
        """x + stashed residual, in f32; into ``x`` itself when
        ``inplace`` and ``x`` is f32."""
        r = state["residual"].reshape(x.shape)
        if inplace and x.dtype == torch.float32:
            return x.add_(r)
        return x.to(torch.float32) + r

    def _residual_state(self, xc, wire, inner_state, out=None):
        """State after transmitting ``wire`` for compensated ``xc``: the
        roundtrip error is the new residual (written into ``out`` when
        given)."""
        dec = self.inner.decode(wire, xc.shape, torch.float32)
        res = xc - dec if out is None else torch.sub(
            xc.reshape(out.shape), dec.reshape(out.shape), out=out)
        st = {"residual": res}
        if inner_state is not None:
            st["inner"] = inner_state
        return st

    def next_state(self, xc, inner_state=None, out=None):
        """New state after transmitting ``xc``: the local roundtrip error
        of the inner codec (the local-quantization-error proxy for ring
        collectives, whose hop re-encodes are not observable)."""
        wire, inner_state = self.inner.encode(xc, inner_state)
        return self._residual_state(xc, wire, inner_state, out)

    def encode(self, x, state=None):
        if state is None:
            state = self.init_state(x.shape, x.dtype, x.device)
        xc = self.compensate(x, state)
        wire, inner_st = self.inner.encode(xc, state.get("inner"))
        return wire, self._residual_state(xc, wire, inner_st)

    def decode(self, wire, shape, dtype):
        return self.inner.decode(wire, shape, dtype)

    def wire_bits_per_value(self, dtype=torch.float32) -> float:
        return self.inner.wire_bits_per_value(dtype)

    def wire_nbytes_for(self, n_elems: int) -> float:
        return self.inner.wire_nbytes_for(n_elems)

    @property
    def is_identity(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class PlrCodec(Codec):
    """PowerSGD-style low-rank projection with a warm-started factor.

    The payload is viewed as a near-square matrix ``M (m, n)``
    (:func:`repro_torch.kernels.lowrank.mat_shape`); the wire is the factor
    pair ``(P^, Q') = (orth(M Q), M^T P^)`` — ``r*(m+n)`` floats vs
    ``m*n`` — and the carried state is ``Q``.  Both wire factors are
    linear in ``M``, which lets the comms layer all-reduce them raw and
    reconstruct the summed gradient."""

    name: str = "plr"
    lossless: bool = False
    rank: int = 8

    kind = "lowrank"
    MAX_RANK = lowrank.MAX_RANK

    def __post_init__(self):
        if not 1 <= self.rank <= self.MAX_RANK:
            raise KeyError(f"plr rank must be in [1, {self.MAX_RANK}], "
                           f"got {self.rank}")
        object.__setattr__(self, "name", f"plr{self.rank}")

    @property
    def stateful(self) -> bool:
        return True

    def init_state(self, shape, dtype, device="cpu"):
        n = math.prod(shape)
        _, ncols = lowrank.mat_shape(n)
        return {"q": lowrank.init_factor(ncols, lowrank.rank_for(n, self.rank),
                                         device)}

    def encode(self, x, state=None):
        if state is None:
            state = self.init_state(x.shape, x.dtype, x.device)
        mat = lowrank.to_mat(x.reshape(-1))
        phat = lowrank.orthonormalize(lowrank.matmul(mat, state["q"]))
        q_new = lowrank.matmul(mat.T, phat)
        return {"p": phat, "q": q_new}, {"q": lowrank.orthonormalize(q_new)}

    def decode(self, wire, shape, dtype):
        out = lowrank.matmul(wire["p"], wire["q"].T)
        return lowrank.from_mat(out, math.prod(shape)).reshape(shape).to(dtype)

    def wire_nbytes_for(self, n_elems: int) -> float:
        m, ncols = lowrank.mat_shape(n_elems)
        return float(lowrank.rank_for(n_elems, self.rank) * (m + ncols) * 4)

    def wire_bits_per_value(self, dtype=torch.float32) -> float:
        # nominal asymptotic rate (m >> n): 32 * r / ncols bits per value;
        # the exact, shape-aware pricing is wire_nbytes_for
        return 32.0 * self.rank / lowrank.NCOLS_MAX

    @property
    def is_identity(self) -> bool:
        return False


# --------------------------------------------------------------------------
# carried-state introspection: read residual energy or warm-factor rank out
# of a slot without knowing which codec family owns it
# --------------------------------------------------------------------------

def state_residual_sq(state):
    """``||residual||^2`` of one codec-state slot (0.0 when the slot
    carries no error-feedback residual, e.g. a pure ``plr`` factor)."""
    if not isinstance(state, dict) or "residual" not in state:
        return 0.0
    return (state["residual"].to(torch.float32) ** 2).sum()


def state_rank(state):
    """Column count of the warm low-rank factor in a codec-state slot
    (``plr*`` directly, ``ef:plr*`` through the nested inner state);
    ``None`` for slots without one."""
    if not isinstance(state, dict):
        return None
    if "q" in state:
        return int(state["q"].shape[-1])
    inner = state.get("inner")
    if isinstance(inner, dict) and "q" in inner:
        return int(inner["q"].shape[-1])
    return None


NONE = Codec()
MPC = MpcCodec()
GQ8 = GqCodec(bits=8)
TQ8 = TqCodec(bits=8)
TQ4 = TqCodec(bits=4)
BQ4 = BqCodec(bits=4)
BQ8 = BqCodec(bits=8)
BQ16 = BqCodec(bits=16)
BQ24 = BqCodec(bits=24)

_REGISTRY = {c.name: c for c in (NONE, MPC, GQ8, TQ8, TQ4, BQ4, BQ8, BQ16,
                                 BQ24)}
_PARAMETRIC: dict = {}
_PLR_RE = re.compile(r"plr(\d+)$")


def names() -> list[str]:
    """Registered concrete codec names (``ef:<codec>`` and ``plr<rank>``
    are parsed on demand by :func:`get`)."""
    return sorted(_REGISTRY)


def _parse(name: str) -> Codec:
    if name.startswith("ef:"):
        return EfCodec(inner=get(name[3:]))
    m = _PLR_RE.match(name)
    if m:
        return PlrCodec(rank=int(m.group(1)))
    raise KeyError(
        f"unknown codec {name!r}; registered: {names()}; parameterized "
        f"forms: 'ef:<lossy codec>' and 'plr<rank>'")


def get(name) -> Codec:
    if isinstance(name, Codec):
        return name
    c = _REGISTRY.get(name)
    if c is not None:
        return c
    c = _PARAMETRIC.get(name)
    if c is None:
        if not isinstance(name, str):
            raise KeyError(f"unknown codec {name!r}; have {names()}")
        c = _parse(name)
        _PARAMETRIC[name] = c
    return c
