"""Prefill/decode disaggregation with a compressed KV handoff (port of
``repro.serve.disagg``).

Production serving splits prefill (compute-bound, long sequences) and
decode (memory-bound, one token) onto distinct pools of devices; the
prompt's KV cache then crosses the pool interconnect once per request.
That transfer is bulk, loss-tolerant traffic, so it rides the same policy
machinery as every training collective: a ``pool`` mesh axis outermost
(prefill = pool rank 0, decode = pool rank 1,
:func:`repro_torch.launch.mesh.make_disagg_mesh`), a
:func:`repro_torch.core.comms.pool_handoff` per cache leaf at
``kv@prefill_handoff``, and a ``kv`` policy dimension whose codec
``--kv-codec`` (or a scheme's ``kv`` rule) selects.  The ledger
attributes the handoff to ``kv`` and
:func:`repro_torch.analysis.roofline.kv_handoff_seconds` prices it.

The SPMD shape is the reference's: every rank of both pools runs the
prefill and decode programs of one shared
:class:`~repro_torch.serve.serve_step.Server`, with its pool's own
``dp x tp`` collectives.  Only the prefill pool's batch is real (the
decode pool prefills zeros); the handoff sends every float cache leaf
``0 -> 1`` (the prefill pool receives zeros: it drops its KV), integer
leaves uncompressed; decode then runs with real state on the decode pool,
where the tokens are read.
"""

from __future__ import annotations

import torch

from repro_torch.core import comms
from repro_torch.core import policy as policy_lib
from repro_torch.models.model import Model
from repro_torch.serve.serve_step import Server

POOL_AXIS = "pool"
PREFILL, DECODE = 0, 1   # pool ranks


class DisaggServer:
    """Two-pool serving: prefill pool -> compressed KV handoff -> decode
    pool, sharing one :class:`Server`'s prefill and decode programs."""

    def __init__(self, model: Model, scheme="baseline",
                 kv_codec: str = "none", ring_bidir: bool = False,
                 ring_chunks: int = 1):
        mi = model.mi
        if mi.pool != 2 or mi.pool_axis is None or \
                mi.pool_axis.name != POOL_AXIS:
            raise ValueError("DisaggServer needs a mesh with a 2-way 'pool' "
                             "axis (make_disagg_mesh)")
        self.model = model
        self.kv_codec = kv_codec
        pol = policy_lib.as_policy(scheme)
        if kv_codec != "none":
            pol = pol.with_rules(policy_lib.Rule(kv_codec, dim="kv"),
                                 name=f"{pol.name}+kv:{kv_codec}")
        self.plan = policy_lib.compile_plan(pol, mi)
        # the inner prefill/decode programs emit no kv traffic, so the
        # shared Server binds the same plan
        self.srv = Server(model, scheme=pol, ring_bidir=ring_bidir,
                          ring_chunks=ring_chunks)

    @property
    def pool_index(self) -> int:
        """This rank's pool: PREFILL or DECODE."""
        return self.model.mi.pool_axis.index

    def stage_batch(self, batch: dict) -> dict:
        """This rank's batch: the real one on the prefill pool, zeros on
        the decode pool."""
        if self.pool_index == PREFILL:
            return batch
        return {k: torch.zeros_like(v) for k, v in batch.items()}

    def prefill(self, params, batch):
        """The Server's prefill on this rank's (staged) batch; -> (first
        tokens, prefill-layout caches)."""
        return self.srv.prefill(params, batch)

    def pad_prefill_caches(self, caches, B: int, s_max: int,
                           s_enc: int = 0):
        return self.srv.pad_prefill_caches(caches, B, s_max, s_enc)

    def handoff(self, caches):
        """Decode-layout caches -> the same, the decode pool now holding
        the prefill pool's KV (the prefill pool zeros).  Float leaves ride
        :func:`comms.pool_handoff` (compressed under the plan's ``kv``
        codec, ledgered under ``kv``; whisper's cross-attention ``xk`` /
        ``xv`` too); integer leaves (its ``xlen``) rotate uncompressed; an
        encoder group has no cache (``None``)."""
        ax = self.model.mi.pool_axis

        def hand(a):
            if a.is_floating_point():
                return comms.pool_handoff(a, ax, src=PREFILL, dst=DECODE)
            return comms.raw_ppermute(a, ax, [(PREFILL, DECODE)])

        with torch.no_grad(), policy_lib.use_plan(self.plan), \
                comms.scope_facts(phase="kv_handoff",
                                  kv_codec=self.kv_codec):
            return [None if c is None else
                    {k: hand(v) for k, v in sorted(c.items())}
                    for c in caches]

    def first_tokens(self, tok):
        """The prefill pool's first tokens, handed to the decode pool
        uncompressed and outside the ledger (the reference's host copy);
        the prefill pool gets zeros."""
        return comms.raw_ppermute(tok, self.model.mi.pool_axis,
                                  [(PREFILL, DECODE)])

    def decode(self, params, token, caches, index: int):
        """The Server's decode step; tokens are meaningful on the decode
        pool only (the prefill pool decodes zeros)."""
        if self.pool_index != DECODE:
            token = torch.zeros_like(token)
        return self.srv.decode(params, token, caches, index)
