#!/usr/bin/env python
"""Library usage example through the port, the counterpart of
``examples/example.py`` (the reference's example.c): multi-consensus
(two consensus sequences at min_freq 0.3) and the MSA of ten reads,
written to stdout.

Runs on the card (the serial device engine) unless asked for the CPU:

    python -m abpoa_tpu_torch.examples.example [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from abpoa_tpu_torch.api import ABPOA          # noqa: E402
from abpoa_tpu_torch.params import Params      # noqa: E402

SEQS = [
    "CGATCGATCGATCGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATAAAAAAAAAAAAAAAAAAACGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATCGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATCGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATAAAAAAAAAAAAAAAAAAACGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATAAAAAAAAAAAAAAAAAAACGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATAAAAAAAAAAAAAAAAAAACGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATCGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATCGATGCATGCATCGATGCATCGATCGATGCATGCAT",
    "CGATCGATCGATCGATGCATGCATCGATGCATCGATCGATGCATGCAT",
]


def device_arg(argv, description):
    """The examples' one option: --device cuda (the default) or cpu."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernels on the card (default); cpu: "
                         "their plain PyTorch versions")
    return ap.parse_args(argv).device


def main(argv=None, out=sys.stdout):
    device = device_arg(argv, "multi-consensus and MSA of ten reads")
    params = Params(out_cons=True, out_msa=True, max_n_cons=2,
                    min_freq=0.3, device=device).post_set()
    ab = ABPOA()
    ab.msa(params, SEQS, out=out,
           names=[f"seq{i+1}" for i in range(len(SEQS))])


if __name__ == "__main__":
    main()
