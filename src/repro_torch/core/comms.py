"""Collectives, single-device stub.

The model code calls :func:`psum` and :func:`pmax` where the reference
(``repro.core.comms``) does, so the collectives slice only has to fill
them in.  On a one-way axis they return their input; over a wider axis
they raise, since the compressed ring collectives are not yet ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Axis:
    """A named mesh axis and its size (the reference reads the size from
    the enclosing ``shard_map``; here the caller carries it)."""

    name: str
    size: int = 1


def _one_way(op: str, axis: Axis, tag) -> None:
    if axis.size != 1:
        site = f" at site {tag!r}" if tag else ""
        raise NotImplementedError(
            f"{op} over axis {axis.name!r} of size {axis.size}{site} is not "
            f"yet ported")


def psum(x, axis: Axis, tag=None):
    """All-reduce-sum over ``axis`` (identity on a one-way axis)."""
    _one_way("psum", axis, tag)
    return x


def pmax(x, axis: Axis):
    """Max-reduce over ``axis`` (identity on a one-way axis)."""
    _one_way("pmax", axis, None)
    return x
