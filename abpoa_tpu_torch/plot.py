"""Graphviz .dot dump of the POA graph (+ optional png/pdf via `dot`).

reference: abPOA src/abpoa_plot.c:33-121.
"""
from __future__ import annotations

import shutil
import subprocess
import sys

from .alphabet import decode_table
from .params import SRC_NODE_ID, SINK_NODE_ID

NODE_COLOR = ["pink1", "red1", "gold2", "seagreen4", "gray"]  # ACGTN


def dump_pog(ab, params):
    graph = ab.graph
    if not graph.is_topological_sorted:
        graph.topological_sort(params)
    out_pog = params.out_pog
    dot_fn = out_pog + ".dot"
    font_size = 24
    tab = decode_table(params.m)
    n = graph.node_n
    labels = [""] * n
    with open(dot_fn, "w") as fp:
        # byte-parity with the reference .dot output
        fp.write(f"// abpoa graph dot file.\n// {n} nodes.\n")
        fp.write('digraph ABPOA_graph {\n\tgraph [rankdir="LR"];\n'
                 "\tnode [width=1.000000, style=filled, fixedsize=true, "
                 "shape=circle];\n")
        for i in range(n):
            nid = int(graph.index_to_node_id[i])
            if nid == SRC_NODE_ID:
                base, color = "S", NODE_COLOR[4]
            elif nid == SINK_NODE_ID:
                base, color = "E", NODE_COLOR[4]
            else:
                base = chr(tab[graph.node[nid].base])
                color = NODE_COLOR[min(graph.node[nid].base, 4)]
            labels[nid] = f'"{base}\n{i}"'  # literal newline (ref)
            fp.write(f"{labels[nid]} [color={color}, fontsize={font_size}]\n")
        x_index = -1
        for i in range(n):
            nid = int(graph.index_to_node_id[i])
            nd = graph.node[nid]
            for out_id, w in zip(nd.out_id, nd.out_weight):
                fp.write(f'\t{labels[nid]} -> {labels[out_id]} '
                         f'[label="{w}", penwidth={w+1}]\n')
            if nd.aligned_node_id:
                fp.write("\t{rank=same; " + labels[nid] + " "
                         + " ".join(labels[a] for a in nd.aligned_node_id)
                         + " };\n")
                if i > x_index:
                    x_index = i
                    fp.write("\t{ edge [style=dashed, arrowhead=none]; "
                             + labels[nid] + " ")
                    for a in nd.aligned_node_id:
                        fp.write(f"-> {labels[a]} ")
                        x_index = max(x_index,
                                      int(graph.node_id_to_index[a]))
                    fp.write("}\n")
        fp.write("}\n")
    suffix = out_pog.rsplit(".", 1)[-1]
    if suffix not in ("pdf", "png"):
        raise ValueError("POG can only be dumped to .pdf/.png file")
    if shutil.which("dot"):
        subprocess.run(["dot", dot_fn, f"-T{suffix}", "-o", out_pog],
                       check=True)
    else:
        print(f"[dump_pog] graphviz 'dot' not found; wrote {dot_fn} only",
              file=sys.stderr)
