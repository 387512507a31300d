"""End-to-end dry run of the port's data parallelism over a device list.

Counterpart of the end-to-end parts of ``__graft_entry__.
dryrun_multichip``, over ``BatchPOA(devices=...)``:

1. the golden consensus of each fixture over 2·D instances (D = the
   length of the device list);
2. heterogeneous instances of seq.fa (all reads, the first 8, 6 and 9),
   rendered as consensus, MSA and GFA, each byte-equal to the port's
   serial ``ABPOA.poa`` of its variant on the oracle: order and gather
   faults that identical copies cancel out show up here;
3. seeded windows (-S) over the last fixture and its first reads, each
   equal to the serial ``anchor_poa``.

The JAX version's single ``dp_xla`` step over the mesh has no
counterpart: the XLA tier is not ported.

    python -m abpoa_tpu_torch.parallel.dryrun cuda:0 cuda:0
    python -m abpoa_tpu_torch.parallel.dryrun cpu cpu --fixtures seq.fa
"""
from __future__ import annotations

import dataclasses
import io
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
DATA = REPO / "tests" / "data"
GOLDEN = {"seq.fa": "seq_cons.fa", "heter.fa": "heter_cons.fa"}


def _reads(fixture):
    from ..alphabet import encode_table
    from ..seqio import read_seqs
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fixture))]


def _serial(params, reads):
    """The port's serial pipeline of one instance on the oracle."""
    from ..api import ABPOA
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    ab.poa(dataclasses.replace(params, engine="numpy"), reads,
           [[1] * len(q) for q in reads], 0)
    return ab


def _serial_seeded(params, reads):
    """The port's serial seeded pipeline (anchor_poa) on the oracle."""
    from ..api import ABPOA
    from ..seed import build_guide_tree_partition
    host = dataclasses.replace(params, engine="numpy")
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    lens = [len(q) for q in reads]
    rmap, anchors, par_c = build_guide_tree_partition(reads, lens, host)
    ab.anchor_poa(host, reads, [[1] * n for n in lens], lens, anchors,
                  par_c, rmap, 0)
    return ab


def _cons(ab, params):
    from ..alphabet import decode_table
    from ..consensus import generate_consensus
    generate_consensus(ab, params)
    dt = decode_table(params.m)
    return [bytes(dt[b] for b in s).decode()
            for s in ab.cons.cons_base[:ab.cons.n_cons]]


def _render(ab, params):
    buf = io.StringIO()
    ab.output(params, buf)
    return buf.getvalue()


def dryrun_multidevice(devices, fixtures=("seq.fa", "heter.fa")) -> dict:
    """Run the three parts over `devices`; raises AssertionError on the
    first mismatch. Returns a summary of what ran."""
    from ..params import Params
    from .batch import BatchPOA
    D = len(devices)
    summary = {"devices": [str(d) for d in devices]}

    # 1. golden consensus, 2·D identical instances a fixture
    for fixture in fixtures:
        reads = _reads(fixture)
        bp = BatchPOA(Params().post_set(), devices=devices)
        cons = bp.run_consensus([reads] * (2 * D))
        gold = (REPO / "tests" / "golden_sanitized" / GOLDEN[fixture]
                ).read_text().splitlines()[1]
        assert all(c == [gold] for c in cons), f"golden {fixture}"
        assert bp.fallbacks == 0, f"golden {fixture}: fallbacks"
        summary[f"golden_{fixture}"] = 2 * D

    # 2. heterogeneous instances, consensus + MSA + GFA
    def full():
        p = Params()
        p.out_cons = p.out_msa = p.out_gfa = 1
        return p.post_set()
    reads = _reads("seq.fa")
    variants = [reads, reads[:8], reads[:6], reads[:9]]
    insts = [variants[k % len(variants)] for k in range(2 * D)]
    serial = [_render(_serial(full(), v), full()) for v in variants]
    bp = BatchPOA(full(), devices=devices)
    for k, ab in enumerate(bp.run(insts)):
        assert _render(ab, full()) == serial[k % len(variants)], \
            f"full output of instance {k}"
    summary["heterogeneous"] = len(insts)

    # 3. seeded windows over the last fixture and its first reads
    def seeded():
        p = Params()
        p.disable_seeding = 0
        return p.post_set()
    sreads = _reads(fixtures[-1])
    svars = [sreads, sreads[:min(12, len(sreads) - 2)]]
    exp = [_cons(_serial_seeded(seeded(), v), seeded()) for v in svars]
    sinsts = [svars[k % 2] for k in range(max(D, 2))]
    bp = BatchPOA(seeded(), devices=devices)
    abs_ = bp.run_seeded(sinsts)
    assert bp.dp_cells > 0 and bp.windows > 0, "seeded: no device window"
    for k, ab in enumerate(abs_):
        assert _cons(ab, seeded()) == exp[k % 2], f"seeded instance {k}"
    summary["seeded"] = len(sinsts)
    return summary


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="python -m abpoa_tpu_torch.parallel"
                                 ".dryrun")
    ap.add_argument("devices", nargs="*", default=["cuda:0", "cuda:0"])
    ap.add_argument("--fixtures", nargs="+", default=["seq.fa", "heter.fa"])
    a = ap.parse_args(argv)
    print(dryrun_multidevice(a.devices, fixtures=tuple(a.fixtures)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
