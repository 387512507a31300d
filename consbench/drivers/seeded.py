"""Entry kind ``seeded``: one call is ``BatchPOA(params, device)
.run_consensus(batch, seeded=True)`` (minimizer-seeded windows, ``-S``)
on one batch of the pool."""
from __future__ import annotations

from . import batch

SPAN = batch.SPAN


class Driver(batch.Driver):
    def __init__(self, fields: dict, device: str, workdir):
        super().__init__(fields, device, workdir, seeded=True)
