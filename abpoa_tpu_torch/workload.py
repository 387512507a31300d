"""The workloads of the port's card checks: a fixture's reads and the
config-5 instances built from them. The scaling harness
(``parallel/scaling.py``) and ``chip_smoke.py`` read them from here."""
from __future__ import annotations

import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent.parent / "tests" / "data"


def load_reads(fixture):
    """The reads of `fixture` (a path, else a file of tests/data) as
    nucleotide codes."""
    from .alphabet import encode_table
    from .seqio import read_seqs
    path = pathlib.Path(fixture)
    if not path.exists():
        path = DATA / fixture
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(path))]


def seeded_instances(reads, n: int):
    """Config-5-shaped workload (the root bench.py's): n seeded amplicon
    windows with varied read lengths, instance k's reads trimmed at the
    end by (k % 5) * 120 bases (at least 64 kept)."""
    return [[q[:max(64, len(q) - (k % 5) * 120)] for q in reads]
            for k in range(n)]
