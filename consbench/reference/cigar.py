"""Graph-CIGAR representation.

Mirrors abPOA's packed 64-bit graph cigar semantics
(reference: abPOA include/abpoa.h:41-46, src/abpoa_align.h:54-96)
but stores entries as plain tuples ``(op, id, len_or_qid)``:

  CMATCH/CDIFF : (op, node_id, query_id)        1 column each
  CINS/CLIPs   : (op, query_id, length)
  CDEL         : (op, node_id, length)

push order and run-merging behavior are identical to abpoa_push_cigar:
only insertions/clips merge with a preceding entry of the same op.
"""

CMATCH = 0
CINS = 1
CDEL = 2
CDIFF = 3
CSOFT_CLIP = 4
CHARD_CLIP = 5

CIGAR_STR = "MIDXSH"


def push_cigar(cigar: list, op: int, length: int, node_id: int, query_id: int) -> list:
    """ref abpoa_push_cigar (src/abpoa_align.h:54-73)."""
    if (not cigar) or (op not in (CINS, CSOFT_CLIP, CHARD_CLIP)) or op != cigar[-1][0]:
        if op in (CMATCH, CDIFF):
            cigar.append((op, node_id, query_id))
        elif op in (CINS, CSOFT_CLIP, CHARD_CLIP):
            cigar.append((op, query_id, length))
        elif op == CDEL:
            cigar.append((op, node_id, length))
        else:
            raise ValueError(f"Unknown cigar op {op}")
    else:
        last = cigar[-1]
        cigar[-1] = (last[0], last[1], last[2] + length)
    return cigar
