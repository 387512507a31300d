#!/usr/bin/env python
"""Batched and sharded usage example through the port, the counterpart
of ``examples/batch_example.py``: many independent POA problems batch
into device launches (``BatchPOA``), and a device list spreads the batch
over cards in contiguous shards (pure data parallelism: instances are
independent), where the JAX example used a ``jax.sharding.Mesh``.

    python -m abpoa_tpu_torch.examples.batch_example [--device cpu]
        [--devices cuda:0,cuda:1]

The device list defaults to every visible card (``["cpu"]`` with
``--device cpu``; an entry may repeat, each on its own stream).
"""
import argparse
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def seq_fa_reads():
    from abpoa_tpu_torch.alphabet import encode_table
    from abpoa_tpu_torch.seqio import read_seqs
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(REPO / "tests" / "data" / "seq.fa"))]


def run(device="cuda", devices=None, out=sys.stdout):
    """The example's three runs; returns their consensus lists (one
    device, the device list, seeded over the device list)."""
    import torch
    from abpoa_tpu_torch import BatchPOA
    from abpoa_tpu_torch.params import Params
    reads = seq_fa_reads()
    # a "problem" is one read set; real workloads batch thousands of
    # amplicon/UMI windows -- every instance is independent
    instances = [reads, reads[:8], reads[:6]] * 4

    # one device
    bp = BatchPOA(Params().post_set(), device=device)
    cons = bp.run_consensus(instances)
    print(f"batched: {len(cons)} consensus sequences, "
          f"{bp.dp_cells} DP cells on device, {bp.rounds} rounds", file=out)

    # sharded over a device list
    if devices is None:
        devices = (["cpu"] if device == "cpu" else
                   [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    bpm = BatchPOA(Params().post_set(), devices=devices)
    cons_m = bpm.run_consensus(instances)
    assert cons_m == cons
    print(f"devices({len(devices)}): identical consensus "
          f"({len(cons_m)} instances sharded data-parallel)", file=out)

    # the seeded/windowed (-S) pipeline shards the same way
    p = Params()
    p.disable_seeding = 0
    cons_s = BatchPOA(p.post_set(), devices=devices).run_consensus(
        instances, seeded=True)
    print(f"seeded over devices: {len(cons_s)} consensus sequences",
          file=out)
    return cons, cons_m, cons_s


def main(argv=None):
    ap = argparse.ArgumentParser(description="batched and sharded POA")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernels on the card (default); cpu: "
                         "their plain PyTorch versions")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device list of the sharded runs "
                         "(default: every visible card, or cpu)")
    args = ap.parse_args(argv)
    run(args.device, args.devices.split(",") if args.devices else None)


if __name__ == "__main__":
    main()
