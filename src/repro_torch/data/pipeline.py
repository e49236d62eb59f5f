"""Deterministic synthetic corpus (port of ``repro.data.pipeline``).

A seeded *teacher* process with learnable structure:

    with prob (1 - noise): next = (a * tok + b) mod V      (affine map)
    with prob noise:       next ~ Uniform(V)

Batches are a pure function of (seed, step), drawn with numpy exactly as
the reference draws them, so both packages train on identical tokens; an
encoder-decoder's stub frames (:meth:`SyntheticCorpus.frames`) are too.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    noise: float = 0.10


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        g = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # affine teacher; `a` odd so the map is a bijection mod 2^k-ish vocabs
        self.a = int(g.integers(1, v) | 1)
        self.b = int(g.integers(0, v))

    def _stream(self, rng, n, length):
        v = self.cfg.vocab_size
        toks = np.empty((n, length), np.int64)
        toks[:, 0] = rng.integers(0, v, n)
        noise = rng.random((n, length)) < self.cfg.noise
        rand = rng.integers(0, v, (n, length))
        for t in range(1, length):
            nxt = (self.a * toks[:, t - 1] + self.b) % v
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def batch(self, step: int, host_slice: slice | None = None):
        """-> dict(tokens [GB, S] int32, labels [GB, S] int32)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = self._stream(rng, cfg.global_batch, cfg.seq_len + 1)
        if host_slice is not None:
            toks = toks[host_slice]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def frames(self, step: int, d_model: int) -> np.ndarray:
        """An encoder-decoder's stub encoder input for ``step``: [GB, S,
        d_model] f32 normals from (seed, step), drawn as the reference's
        serving launcher draws its frames.  The reference's batch has no
        frames, so its training launcher cannot train whisper (fault
        C.22); this stream is the port's own."""
        cfg = self.cfg
        return np.random.default_rng((cfg.seed, step)).normal(
            size=(cfg.global_batch, cfg.seq_len, d_model)).astype(np.float32)

    def optimal_xent(self) -> float:
        """Entropy floor of the teacher (nats/token)."""
        p = self.cfg.noise
        v = self.cfg.vocab_size
        # next token: (1-p+p/v) mass on the affine target, p/v elsewhere
        q_hit = (1 - p) + p / v
        q_other = p / v
        return float(-(q_hit * np.log(q_hit)
                       + (v - 1) * q_other * np.log(q_other)))
