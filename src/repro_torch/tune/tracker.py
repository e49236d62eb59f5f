"""Per-site tuning signals: the in-step layout and its host-side reader
(port of ``repro.tune.tracker``).

The cheap per-site statistics the controller needs are packed into ONE
fixed-width f32 vector per tunable site, accumulated across steps by the
tuned comms sites (each step's increment summed over the whole world and
divided by its size, so every rank holds the same vector) and carried in
the ``tune_state`` next to ``codec_state``.  Layout (:data:`SIG_LEN`
slots):

====  =========  ====================================================
idx   name       accumulates
====  =========  ====================================================
0     count      steps observed since the controller last drained
1     payload    sum over steps/ranks of ``||payload||^2``
2     err        sum of the realized (or probed next-rung) squared
                 compression error ``||x - D(E(x))||^2``
3     spec_n     steps that contributed a spectral probe
4..   spec_j     sum of ``||P_j||^2`` — energy of the (all-reduced)
                 payload along warm factor column ``j`` (j < PLR_MAX_RANK)
====  =========  ====================================================

Ratios of sums cancel the rank/step normalization, so the host-side
:class:`SignalTracker` exposes exactly the two quantities the ladder
walk needs: ``err_ratio = sqrt(err / payload)`` (the EF-residual /
probe-to-payload norm ratio) and the cumulative spectral energy
fractions that autotune the ``plr`` rank.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.tune.ladder import PLR_MAX_RANK

I_COUNT, I_PAYLOAD, I_ERR, I_SPECN, I_SPEC0 = 0, 1, 2, 3, 4
SIG_LEN = I_SPEC0 + PLR_MAX_RANK


def sig_template():
    """Host-side zero vector of the accumulator (one per tunable site)."""
    import numpy as np
    return np.zeros((SIG_LEN,), np.float32)


def pack(count, payload_sq, err_sq, spec=None):
    """One step's increment vector (f32, on the device of the tensor
    inputs).  ``spec`` is a length-:data:`PLR_MAX_RANK` column-energy
    vector or ``None`` (rungs without a warm factor probe contribute no
    spectral mass)."""
    import torch
    dev = next((t.device for t in (payload_sq, err_sq, spec)
                if isinstance(t, torch.Tensor)), "cpu")

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
    head = torch.stack([f32(count), f32(payload_sq), f32(err_sq),
                        f32(0.0 if spec is None else 1.0)])
    tail = torch.zeros((PLR_MAX_RANK,), dtype=torch.float32, device=dev) \
        if spec is None else torch.as_tensor(
            spec, dtype=torch.float32, device=dev).reshape(PLR_MAX_RANK)
    return torch.cat([head, tail])


@dataclasses.dataclass(frozen=True)
class SiteSignals:
    """One site's drained statistics, in controller-ready form."""

    count: float
    payload_sq: float
    err_sq: float
    spec_n: float
    spec: tuple

    @property
    def err_ratio(self) -> float:
        """sqrt(err / payload): the relative compression error.  Bounded
        (< promote tolerance) means the current rung is comfortable;
        blowing up (> demote tolerance) means back off."""
        if self.payload_sq <= 0.0:
            return 0.0
        return math.sqrt(max(self.err_sq, 0.0) / self.payload_sq)

    def spectral_rank(self, frac: float, ranks) -> int:
        """Smallest rank in ``ranks`` whose leading columns capture
        ``frac`` of the probed rank-:data:`PLR_MAX_RANK` subspace energy
        (the measured spectral decay); the max rank when the spectrum is
        flat or no probe ran."""
        total = sum(self.spec)
        ranks = sorted(ranks)
        if self.spec_n <= 0 or total <= 0.0:
            return ranks[-1]
        for r in ranks:
            if sum(self.spec[:r]) >= frac * total:
                return r
        return ranks[-1]


class SignalTracker:
    """Host-side reader of the accumulated ``tune_state['sig']`` dict.

    ``drain(sig)`` converts each site's vector (a tensor on any device, or
    an array) into :class:`SiteSignals` and returns the zeroed accumulator
    dict (numpy) to thread into the next step — one controller interval's
    worth of statistics per drain."""

    def drain(self, sig: dict):
        import numpy as np
        out = {}
        zeroed = {}
        for key, vec in sig.items():
            if hasattr(vec, "detach"):
                vec = vec.detach().cpu().numpy()
            v = np.asarray(vec, np.float32).reshape(-1)
            if v.shape[0] != SIG_LEN:
                raise ValueError(
                    f"signal vector for site {key!r} has {v.shape[0]} "
                    f"slots, expected {SIG_LEN} — tune_state predates the "
                    "current signal layout; restart tuning fresh")
            out[key] = SiteSignals(
                count=float(v[I_COUNT]), payload_sq=float(v[I_PAYLOAD]),
                err_sq=float(v[I_ERR]), spec_n=float(v[I_SPECN]),
                spec=tuple(float(x) for x in v[I_SPEC0:]))
            zeroed[key] = sig_template()
        return out, zeroed
