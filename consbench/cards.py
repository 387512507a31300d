"""The per-card counters of the ``batch_x4`` entry kind
(``drivers/batch_x4.py``: ``<name>.<i>`` for card i), for the ``.x4``
per-layer metrics. Each gives None where a call has no such counter (a
port whose ``BatchPOA.shards`` lacks the entry)."""
from __future__ import annotations


def per_card(counters: dict, name: str):
    """[card 0's value, card 1's, ...] of counter `name` in one call's
    counters, or None where the call has none."""
    keys = [k for k in counters if k.rpartition(".")[0] == name]
    if not keys:
        return None
    return [counters[k] for k in sorted(keys, key=lambda k: int(
        k.rpartition(".")[2]))]


def calls(w, name: str):
    """Per call of the window, its per-card values of `name`; None where
    any call lacks them."""
    out = [per_card(c.counters, name) for c in w.calls]
    return None if any(v is None for v in out) else out
