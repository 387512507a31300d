"""Entry kind ``batch_x4``: the ``batch`` kind over the four cards of
one host. One call is ``BatchPOA(params, devices=["cuda:0", ...,
"cuda:3"]).run_consensus(batch)`` on one batch of the pool: each card
runs one contiguous shard of the batch (``devices=["cpu"] * 4`` on the
CPU, in the tests). A new BatchPOA per call.

Besides the ``batch`` kind's counters, each call reports every card's
record of ``BatchPOA.shards`` as ``instances.<i>``, ``busy_s.<i>`` and
``launched_s.<i>`` for card i; an entry the port does not record is
left out (``consbench/cards.py`` reads them)."""
from __future__ import annotations

from . import batch

SPAN = batch.SPAN
CARDS = 4
PER_CARD = ("instances", "busy_s", "launched_s")


class Driver(batch.Driver):
    def __init__(self, fields: dict, device: str, workdir):
        super().__init__(fields, device, workdir)
        kind = device.split(":")[0]
        self.devices = ([f"cuda:{i}" for i in range(CARDS)] if kind == "cuda"
                        else [kind] * CARDS)

    def call(self, batch_):
        bp = self._batch_poa(self.params, devices=self.devices)
        cons = bp.run_consensus(batch_)
        counters = {"fallbacks": bp.fallbacks, "dp_cells": bp.dp_cells}
        for i, card in enumerate(bp.shards):
            for key in PER_CARD:
                v = card.get(key)
                if v is not None:
                    counters[f"{key}.{i}"] = v
        return cons, counters
