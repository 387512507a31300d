"""Entry kind ``batch``: one call is ``BatchPOA(params, device)
.run_consensus(batch)`` on one batch of the pool, a new BatchPOA per call
as a user's process makes one per batch."""
from __future__ import annotations

SPAN = "run_consensus"
SEEDED = False


def port_params(fields: dict):
    """The port's Params with a configuration's fields, post-set."""
    from abpoa_tpu_torch.params import Params
    p = Params()
    for k, v in fields.items():
        if not hasattr(p, k):
            raise KeyError(f"unknown abPOA parameter {k!r}")
        setattr(p, k, v)
    return p.post_set()


class Driver:
    span = SPAN

    def __init__(self, fields: dict, device: str, workdir, seeded=SEEDED):
        from abpoa_tpu_torch.parallel.batch import BatchPOA
        self.params = port_params(fields)
        self.device = device
        self.seeded = seeded
        self._batch_poa = BatchPOA

    def units(self, pool):
        """[(cluster ids, call input)]: one unit per batch of the pool."""
        return [([(b, k) for k in range(len(batch))], batch)
                for b, batch in enumerate(pool)]

    def call(self, batch):
        """(answers, counters): each cluster's consensus strings, and the
        BatchPOA's counters (its own count of DP cells is printed, never
        a metric's work: that is the reference's)."""
        bp = self._batch_poa(self.params, device=self.device)
        cons = bp.run_consensus(batch, seeded=self.seeded)
        return cons, {"fallbacks": bp.fallbacks, "dp_cells": bp.dp_cells}

    @staticmethod
    def render(cons):
        """The answer a correct call gives for a cluster whose reference
        consensus strings are `cons`."""
        return list(cons)
