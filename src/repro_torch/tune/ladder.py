"""The codec promotion ladder (port of ``repro.tune.ladder``, verbatim in
its values) — single source of truth.

Both the offline ``roofline.suggest_scheme`` walk and the
in-training :class:`~repro_torch.tune.controller.CompressionController` move
along the same mild -> aggressive ladder; a new codec registers HERE and
both consumers pick it up.  Two granularities share the ordering:

* :data:`LADDER` — the canonical per-site promote order.  The low-rank
  rung appears once at its max tunable rank; the controller narrows the
  rank separately from measured spectral decay (:data:`PLR_RANKS`).
* :data:`RUNGS` — the executable rungs a tuned comms site dispatches
  over (``comms._tuned_collective``, in this order): the ladder with the
  low-rank rung expanded over its tunable ranks, so a rank change is a
  host integer, not a rebuild.

The rate-4 rung is the error-feedback wrapped ``ef:bq4`` — identical
wire bytes to raw ``bq4`` but convergence-safe (the carried residual
re-injects the quantization error), so raw ``bq4`` never appears on the
ladder.
"""

from __future__ import annotations

#: Max rank of the low-rank rung (and the warm-factor width the tuned
#: sites carry, so any narrower rank is a column slice of its factor).
PLR_MAX_RANK = 8

#: Ranks the controller may assign to the low-rank rung, ascending.
PLR_RANKS = (2, 4, 8)

#: Canonical promote order, mild -> aggressive (site granularity).
LADDER = ("bq16", "bq8", "ef:bq4", f"plr{PLR_MAX_RANK}")

#: Executable rungs of the tuned sites' dispatch (its branch order).
RUNGS = ("bq16", "bq8", "ef:bq4") + tuple(f"plr{r}" for r in PLR_RANKS)

#: Registered scheme realizing each ladder rung as a whole-mesh policy —
#: the offline ``--suggest`` walk is scheme-granular (plr sub-ranks
#: share the plr scheme's shape, so only the max rank is listed).
SCHEME_FOR = {
    "bq16": "hier_zpp_16_16",
    "bq8": "hier_zpp_8_16",
    "ef:bq4": "hier_zpp_ef4_16",
    f"plr{PLR_MAX_RANK}": f"hier_zpp_plr{PLR_MAX_RANK}_16",
}

#: ((scheme_name, outer_codec), ...) — the exact shape
#: ``roofline.suggest_scheme`` walks.
SUGGEST_LADDER = tuple((SCHEME_FOR[c], c) for c in LADDER)


def plr_rank(codec: str) -> int | None:
    """``plr<r>``/``ef:plr<r>`` -> r; None for non-low-rank codecs."""
    base = codec.split(":")[-1]
    if base.startswith("plr"):
        return int(base[3:])
    return None


def rung_index(codec: str) -> int:
    """Position of ``codec`` on :data:`RUNGS` (exact match only)."""
    try:
        return RUNGS.index(codec)
    except ValueError:
        raise KeyError(f"codec {codec!r} is not a ladder rung; have "
                       f"{list(RUNGS)}") from None


def rung_or_default(codec: str, default: int = 0) -> int:
    """Starting rung for a site whose static plan codec is ``codec``:
    its exact rung when it is one, else ``default`` (off-ladder start
    codecs — ``none``, ``mpc`` — enter at the mild end)."""
    if codec in RUNGS:
        return RUNGS.index(codec)
    r = plr_rank(codec)
    if r is not None:       # off-ladder rank: nearest registered rank
        best = min(PLR_RANKS, key=lambda p: abs(p - r))
        return RUNGS.index(f"plr{best}")
    return default


def promote(codec: str, rank: int = PLR_MAX_RANK) -> str:
    """Next rung up the :data:`LADDER` (more aggressive).  Entering the
    low-rank rung lands at ``plr<rank>`` (the controller passes the rank
    it autotuned from the measured spectrum); the top rung is a
    fixpoint — within it only the rank may change."""
    if plr_rank(codec) is not None:
        return f"plr{rank}"
    i = LADDER.index(codec)
    if i + 1 == len(LADDER):
        return codec
    nxt = LADDER[i + 1]
    return f"plr{rank}" if plr_rank(nxt) is not None else nxt


def demote(codec: str) -> str:
    """Next rung down the :data:`LADDER` (milder).  Any ``plr<r>``
    demotes to the rung below the low-rank one; the bottom rung is a
    fixpoint."""
    if plr_rank(codec) is not None:
        return LADDER[-2]
    i = LADDER.index(codec)
    return LADDER[max(i - 1, 0)]
