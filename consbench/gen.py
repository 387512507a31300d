"""The benchmark's cluster generator (frozen: later changes to the port
cannot move it).

A traffic file fixes the shape of every cluster: entry k of its
``schedule`` is ``[template_length, depth]`` for cluster k of each batch,
and ``errors`` gives the per-base rates of substitutions, insertions and
deletions. The seed draws only the template bases and where each read's
errors fall: every read of a template of length L carries exactly
round(rate * L) errors of each kind, so every seed and every run makes
the same reads' lengths and the same amount of alignment work.
"""
from __future__ import annotations

import numpy as np

BASES = "ACGT"


def error_counts(length: int, errors: dict) -> tuple[int, int, int]:
    """(substitutions, insertions, deletions) of one read of a template of
    `length` bases."""
    return tuple(int(round(errors[k] * length)) for k in ("sub", "ins", "del"))


def make_read(rng, template: np.ndarray, errors: dict) -> np.ndarray:
    """One read of `template` (codes 0-3) with its errors at positions
    drawn from `rng`."""
    n = len(template)
    n_sub, n_ins, n_del = error_counts(n, errors)
    pos = rng.choice(n, n_sub + n_del, replace=False)
    read = template.copy()
    sub = pos[:n_sub]
    read[sub] = (read[sub] + rng.integers(1, 4, n_sub)) % 4
    keep = np.ones(n, bool)
    keep[pos[n_sub:]] = False
    # an insertion goes before template position p (p == n: at the end),
    # that is before the kept bases that follow p
    ins_at = rng.integers(0, n + 1, n_ins)
    ins_base = rng.integers(0, 4, n_ins).astype(np.uint8)
    kept_before = np.concatenate(([0], np.cumsum(keep)))
    return np.insert(read[keep], kept_before[ins_at], ins_base)


def make_cluster(rng, length: int, depth: int, errors: dict):
    """`depth` reads of one random template of `length` bases."""
    template = rng.integers(0, 4, length).astype(np.uint8)
    return [make_read(rng, template, errors) for _ in range(depth)]


def make_batch(seed: int, b: int, traffic: dict):
    """Batch b of the pool of `traffic` under `seed`: one cluster per
    schedule entry, each a list of encoded reads (uint8 codes 0-3)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), b])
    return [make_cluster(rng, int(length), int(depth), traffic["errors"])
            for length, depth in traffic["schedule"]]


def make_pool(seed: int, traffic: dict):
    """The traffic's pool: `batches` distinct batches."""
    return [make_batch(seed, b, traffic) for b in range(traffic["batches"])]


def to_fasta(reads) -> str:
    """A cluster as FASTA text, one record per read."""
    return "".join(f">read{i}\n{''.join(BASES[c] for c in r)}\n"
                   for i, r in enumerate(reads))
