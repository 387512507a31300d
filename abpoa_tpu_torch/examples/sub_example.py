#!/usr/bin/env python
"""Subgraph alignment example through the port, the counterpart of
``examples/sub_example.py`` (the reference's sub_example.c): reads align
to a node range of the graph the first read built instead of the whole
DAG (the primitive behind anchored, windowed POA); the consensus goes to
stdout.

Runs on the card (the serial device engine: B5 for whole-graph calls, B4
for windows) unless asked for the CPU:

    python -m abpoa_tpu_torch.examples.sub_example [--device cpu]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from abpoa_tpu_torch import align as aln                 # noqa: E402
from abpoa_tpu_torch.alphabet import encode_seq          # noqa: E402
from abpoa_tpu_torch.api import ABPOA                    # noqa: E402
from abpoa_tpu_torch.consensus import generate_consensus  # noqa: E402
from abpoa_tpu_torch.examples.example import device_arg  # noqa: E402
from abpoa_tpu_torch.msa import output_fx_consensus      # noqa: E402
from abpoa_tpu_torch.params import (Params, SRC_NODE_ID,  # noqa: E402
                                    SINK_NODE_ID)

SEQS = [
    "CGTCAATCTATCGAAGCATACGCGGGCAGAGC",
    "CCACGTCAATCTATCGAAGCATACGCGGCAGC",
    "AATCTATCGAAGCATACG",
    "CAATGCTAGTCGAAGCAGCTGCGGCAG",
    "CGTCAATCTATCGAAGCATTCTACGCGGCAGAGC",
]
# inclusive (beg, end) query offsets mapped onto the first read's nodes;
# (0, 1) means whole-graph SRC..SINK like the reference's sentinel
BEG_END = [(0, 1), (2, 31), (6, 23), (5, 26), (0, 1)]


def main(argv=None, out=sys.stdout):
    device = device_arg(argv, "align reads to subgraphs of a POA graph")
    params = Params(out_cons=True, device=device).post_set()
    ab = ABPOA()
    ab.n_seq = len(SEQS)
    ab.names = [""] * len(SEQS)
    ab.is_rc = [0] * len(SEQS)
    qpos_to_node_id = [0] * max(len(s) for s in SEQS)
    for i, s in enumerate(SEQS):
        bseq = encode_seq(s)
        beg_q, end_q = BEG_END[i]
        if i == 0 or (beg_q, end_q) == (0, 1):
            beg_id, end_id = SRC_NODE_ID, SINK_NODE_ID
        else:
            # expand the anchor node range to a closed subgraph interval
            # (ref abpoa_subgraph_nodes, src/abpoa_graph.c:573-585)
            beg_id, end_id = ab.graph.subgraph_nodes(
                params, qpos_to_node_id[beg_q], qpos_to_node_id[end_q])
        res = aln.align_sequence_to_subgraph(ab.graph, params, beg_id,
                                             end_id, bseq, arena=ab.arena)
        cigar = res.cigar if res is not None else []
        ab.graph.add_subgraph_alignment(params, beg_id, end_id, bseq,
                                        [1] * len(bseq), cigar,
                                        qpos_to_node_id if i == 0 else None,
                                        i, True)
    generate_consensus(ab, params)
    output_fx_consensus(ab, params, out)


if __name__ == "__main__":
    main()
