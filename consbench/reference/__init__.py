"""The benchmark's plain reference: a frozen plain-Python and NumPy copy
of the port's host oracle, abPOA v1.4.1's POA and consensus bit for bit
(sanitized-reference semantics). It imports nothing of the port. It is
kept whole (local and extension modes, linear and affine gaps, qv
weights, multi-allele consensus) so that a later cell under other flags
finds its reference here.

``check_cluster`` is what the harness's worker processes run."""
from __future__ import annotations


def make_params(fields: dict, score_bits: int = 0):
    """Params of a configuration's ``params`` fields, post-set as abPOA's
    command line would; score_bits 8 makes the control."""
    from .params import Params
    p = Params()
    for k, v in fields.items():
        if not hasattr(p, k):
            raise KeyError(f"unknown abPOA parameter {k!r}")
        setattr(p, k, v)
    p.score_bits = score_bits
    return p.post_set()


def check_cluster(job):
    """job = (params fields, score_bits, reads): (consensus strings, band
    cells), or (None, 0) where the DP raised (the control's int8 scores
    can dead-end the backtrack)."""
    from .poa import cluster_consensus
    fields, score_bits, reads = job
    try:
        return cluster_consensus(make_params(fields, score_bits), reads)
    except (RuntimeError, IndexError, ValueError):
        return None, 0
