"""Host-side continuous-batching scheduler for the paged decode step.

Pure Python/numpy, copied from ``repro.serve.scheduler``.  The step of
:meth:`repro_torch.serve.serve_step.PagedServer.decode_step` advances a
FIXED set of ``n_slots`` decode slots; this scheduler owns the host arrays
that parameterize it (per-slot token / position / block table / active
mask), admitting queued requests into free slots and reclaiming blocks the
moment a request finishes.  Admission and eviction only rewrite host
arrays, so the device step keeps its shapes.

Prompts STREAM through the decode step (prompt-as-decode): an admitted
request's slot feeds ``prompt[pos]`` while ``pos`` is inside the prompt
(the model's prediction is discarded) and its own last sampled token
after — one unified step function, and paged attention sees the exact
same write-then-read ordering for prompt and generated tokens.

Block accounting is up-front: admission reserves
``ceil((len(prompt) + max_new) / block_tokens)`` blocks from the slot's
data-shard :class:`~repro_torch.serve.paged_kv.BlockAllocator`, so an admitted
request can never die of pool OOM mid-decode.  Slots (and their block
ids) are partitioned across ``dp`` data shards — slot ``s`` lives on
shard ``s // (n_slots/dp)`` and its table holds that shard's LOCAL
block ids, matching the pool's data-sharded block axis.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve import paged_kv


@dataclass
class Request:
    rid: object
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    blocks: list[int] = field(default_factory=list)
    slot: int = -1
    pos: int = 0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class Scheduler:
    """Continuous batching over ``n_slots`` fixed decode slots."""

    def __init__(self, n_slots: int, n_blocks: int, block_tokens: int,
                 max_blocks: int, dp: int = 1):
        if n_slots % dp or n_blocks % dp:
            raise ValueError(f"n_slots ({n_slots}) and n_blocks "
                             f"({n_blocks}) must divide by dp ({dp})")
        self.n_slots = n_slots
        self.block_tokens = block_tokens
        self.max_blocks = max_blocks
        self.dp = dp
        self.slots_per_shard = n_slots // dp
        self.allocators = [paged_kv.BlockAllocator(n_blocks // dp)
                           for _ in range(dp)]
        self._queue: deque[Request] = deque()
        self._slots: list[Request | None] = [None] * n_slots
        self.finished: dict[object, list[int]] = {}

    # ------------------------------------------------------------------
    def submit(self, rid, prompt, max_new: int) -> None:
        prompt = list(prompt)
        if not prompt or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if (rid in self.finished
                or any(r.rid == rid for r in self._queue)
                or any(r is not None and r.rid == rid
                       for r in self._slots)):
            raise ValueError(f"duplicate request id {rid!r}")
        need = paged_kv.blocks_needed(len(prompt) + max_new,
                                      self.block_tokens)
        if need > self.max_blocks:
            raise ValueError(
                f"request {rid!r} needs {need} blocks "
                f"({len(prompt)}+{max_new} tokens), table width is "
                f"{self.max_blocks}")
        self._queue.append(Request(rid, prompt, max_new))

    def _shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def admit(self) -> int:
        """Move queued requests into free slots (FIFO); -> number admitted."""
        n = 0
        for slot in range(self.n_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue[0]
            alloc = self.allocators[self._shard_of(slot)]
            need = paged_kv.blocks_needed(len(req.prompt) + req.max_new,
                                          self.block_tokens)
            if need > alloc.n_free:
                continue   # a later slot may sit on a shard with room
            self._queue.popleft()
            req.blocks = alloc.alloc_many(req.rid, need)
            req.slot, req.pos = slot, 0
            req.out = []
            self._slots[slot] = req
            n += 1
        return n

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)

    def pending(self) -> int:
        return len(self._queue)

    def active_slots(self) -> int:
        return sum(r is not None for r in self._slots)

    def step_arrays(self):
        """-> (tok [N,1] i32, tables [N,max_blocks] i32, pos [N] i32,
        active [N] bool) for the next device step."""
        n, mb = self.n_slots, self.max_blocks
        tok = np.zeros((n, 1), np.int32)
        tables = np.zeros((n, mb), np.int32)
        pos = np.zeros(n, np.int32)
        active = np.zeros(n, bool)
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            active[s] = True
            pos[s] = req.pos
            tables[s, :len(req.blocks)] = req.blocks
            if req.pos < len(req.prompt):
                tok[s, 0] = req.prompt[req.pos]
            else:
                tok[s, 0] = req.out[-1]
        return tok, tables, pos, active

    def commit(self, next_tok) -> list:
        """Fold one device step's sampled tokens [N] back in; -> rids that
        finished this step (their blocks and slots are already free)."""
        next_tok = np.asarray(next_tok).reshape(-1)
        done = []
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            if req.pos >= len(req.prompt) - 1:   # prediction is real output
                req.out.append(int(next_tok[s]))
            req.pos += 1
            if req.done:
                self.allocators[self._shard_of(s)].free(req.blocks)
                req.blocks = []
                self._slots[s] = None
                self.finished[req.rid] = req.out
                done.append(req.rid)
        return done

    # ------------------------------------------------------------------
    def run(self, step_fn, params, pool, max_steps: int = 100_000):
        """Drive the loop to completion; -> (finished dict, pool, n_steps)."""
        steps = 0
        while self.has_work():
            if steps >= max_steps:
                raise RuntimeError(f"scheduler did not drain in "
                                   f"{max_steps} steps")
            self.admit()
            if not self.active_slots():
                raise RuntimeError(
                    "queued requests cannot be admitted: every shard is "
                    "short of blocks even with all slots free")
            tok, tables, pos, active = self.step_arrays()
            next_tok, pool = step_fn(params, tok, pool, tables, pos, active)
            self.commit(np.asarray(next_tok))
            steps += 1
        return self.finished, pool, steps
