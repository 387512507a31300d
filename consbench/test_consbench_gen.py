"""The cluster generator: the traffic file fixes every shape, the seed
only the bases and where the errors fall."""
import json
import pathlib

import numpy as np
import pytest

from consbench import gen

TRAFFIC = pathlib.Path(__file__).resolve().parent / "traffic"
ERRORS = {"sub": 0.004, "ins": 0.002, "del": 0.004}
SMALL = {"errors": ERRORS, "batches": 2,
         "schedule": [[650, 3], [800, 5], [1500, 2], [4000, 2]]}


def shapes(pool):
    return [[[len(r) for r in c] for c in batch] for batch in pool]


@pytest.mark.parametrize("seeds", [(1, 2), (0, 2**31 + 17)])
def test_same_shapes_for_every_seed(seeds):
    a, b = (gen.make_pool(s, SMALL) for s in seeds)
    assert shapes(a) == shapes(b)
    assert any(not np.array_equal(x[0], y[0])
               for x, y in zip(a[0], b[0]))


def test_same_bases_for_the_same_seed():
    a, b = gen.make_pool(2**31 + 3, SMALL), gen.make_pool(2**31 + 3, SMALL)
    for ba, bb in zip(a, b):
        for ca, cb in zip(ba, bb):
            assert all(np.array_equal(x, y) for x, y in zip(ca, cb))
    # batches of one pool differ
    assert not np.array_equal(a[0][0][0], a[1][0][0])


@pytest.mark.parametrize("length", [650, 800, 1537, 5500])
def test_exact_error_counts(length):
    n_sub, n_ins, n_del = gen.error_counts(length, ERRORS)
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, length).astype(np.uint8)
    for _ in range(20):
        r = gen.make_read(rng, t, ERRORS)
        assert len(r) == length + n_ins - n_del
        assert r.dtype == np.uint8 and r.max() < 4


@pytest.mark.parametrize("name", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_traffic_files(name):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    assert t["batches"] >= 1 and t["check_clusters"] >= 1
    assert all(len(e) == 2 and min(e) > 0 for e in t["schedule"])
    # a pool of at least 4 distinct calls: batches, or a CLI's files
    per_batch = len(t["schedule"]) if t["driver"] == "cli" else 1
    assert t["batches"] * per_batch >= 4


def test_fasta():
    assert gen.to_fasta([np.array([0, 1, 2, 3], np.uint8)]) == ">read0\nACGT\n"
