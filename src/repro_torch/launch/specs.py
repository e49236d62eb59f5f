"""The 40 (architecture x input shape) dry-run cells (port of
``repro.launch.specs``).

``input_specs(cfg, shape_name, mi)`` returns a stand-in for every model
input (:class:`Spec`: the GLOBAL shape and dtype, no storage), the
sharding of each input's dims, and which step the cell traces:

  train_4k     seq 4096   gb 256  -> the training step
  prefill_32k  seq 32768  gb 32   -> prefill (forward and cache emission)
  decode_32k   seq 32768  gb 128  -> one decode step (1 token, 32k cache)
  long_500k    seq 524288 gb 1    -> one decode step, the cache's sequence
                                     sharded over (data, model); only for
                                     architectures with a sub-quadratic
                                     story (``long_context_ok``)

An encoder-decoder (whisper) runs the decode shapes on its decoder; the
pure full-attention architectures skip ``long_500k``.

The reference's ``PartitionSpec`` becomes a tuple with one entry per dim:
``None`` (replicated) or a tuple of the mesh axis names the dim is sharded
over, outermost first, as the reference's entries name them.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import MeshInfo, torch_dtype

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode_long", seq=524288, batch=1),
}


@dataclasses.dataclass(frozen=True)
class Spec:
    """An input's global shape and dtype (the reference's
    ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def cell_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.long_context_ok:
        return False, ("skipped: pure full-attention arch (quadratic "
                       "long-context); see DESIGN.md §5")
    return True, ""


def axis_names(axis) -> tuple:
    """The mesh axis names of a comms axis (or pair), outermost first."""
    name = getattr(axis, "joint", axis).name
    return name if isinstance(name, tuple) else (name,)


def _sds(shape, dtype=torch.int32) -> Spec:
    return Spec(tuple(shape), dtype)


def input_specs(cfg: ArchConfig, shape_name: str, mi: MeshInfo) -> dict:
    """-> ``dict(kind=..., inputs={name: Spec}, specs={name: per-dim
    axes}, meta={...})``, as the reference's."""
    sh = SHAPES[shape_name]
    S, B = sh["seq"], sh["batch"]
    kind = sh["kind"]
    act = torch_dtype(cfg.dtype)
    batch, tp = axis_names(mi.batch_axes), axis_names(mi.tp_axes)

    if kind in ("train", "prefill"):
        inputs = {"tokens": _sds((B, S)), "labels": _sds((B, S))}
        specs = {"tokens": (batch, None), "labels": (batch, None)}
        if cfg.encoder_layers:
            inputs["frames"] = _sds((B, S, cfg.d_model), act)
            specs["frames"] = (batch, tp, None)
        if cfg.mrope:
            inputs["vision"] = _sds((B, S, cfg.d_model), act)
            inputs["vis_mask"] = _sds((B, S), torch.bool)
            inputs["pos3"] = _sds((B, S, 3))
            specs["vision"] = (batch, tp, None)
            specs["vis_mask"] = (batch, tp)
            specs["pos3"] = (batch, tp, None)
        return dict(kind=kind, inputs=inputs, specs=specs,
                    meta=dict(seq=S, batch=B))

    # decode shapes: one new token against an S-token cache
    seq_axes = ("model",) if kind == "decode" else ("data", "model")
    tok_sp = (batch if (B > 1 and "data" not in seq_axes) else None, None)
    inputs = {"token": _sds((B, 1))}
    specs = {"token": tok_sp}
    s_enc = 0
    if cfg.encoder_layers:
        s_enc = 4096  # stub frame count for the cross cache
    return dict(kind="decode", inputs=inputs, specs=specs,
                meta=dict(seq=S, batch=B, seq_axes=seq_axes, s_enc=s_enc))


def local_shape(spec: Spec, dims: tuple, mi: MeshInfo) -> tuple:
    """This rank's shape of an input whose dims shard over ``dims`` (one
    entry per dim, as :func:`input_specs` gives them)."""
    sizes = {axis_names(mi.batch_axes): mi.batch_ways,
             axis_names(mi.tp_axes): mi.tp}
    out = []
    for s, d in zip(spec.shape, dims):
        n = 1 if d is None else sizes[tuple(d)]
        if s % n:
            raise ValueError(f"dim of size {s} does not split over {d} "
                             f"({n} ways)")
        out.append(s // n)
    return tuple(out)
