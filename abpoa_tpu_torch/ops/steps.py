"""The step words of the DP walks, and the steps16 wire stream: decode
on the host, and the encoder the tests use to hand-build streams.

A step word is an int64 ``op | row<<2 | col<<32`` (``pack_steps``;
``step_fields`` takes it apart): 30 row bits and 31 column bits, so no
graph, window or query that fits the card's memory outgrows it. The
walks of B3 (topo mode), B4 and B5 emit it; the host fusion
(``native/poagraph.c`` ``pg_fuse_steps``) and ``replay_steps`` read it.

The device loop's walk emits one 16-bit half per backtrack step
instead, in push (reverse) order: ``op | dj<<2 | di<<3``, where (di,
dj) are the topo-row and column decrements from the previous emission
(the first step's are from (M_BI, M_BJ)); its 13-bit row decrement
holds any predecessor jump of a graph up to 8192 rows. The device
loop's host replay decodes it in C as it fuses (``native/poagraph.c``
``pg_replay_loop``); ``unpack_steps16`` decodes one stream for the
per-read route. Re-hosted from
``abpoa_tpu/ops/bt_xla.py`` (``unpack_steps16``, ``replay_steps``),
``parallel/batch.py`` (the whole-batch decode) and ``ops/poa_loop.py``
(``steps32_to_s16w``, here ``steps_to_s16w``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import layout as L

ROW_MASK = (1 << 30) - 1
COL_SHIFT = 32


def pack_steps(op, row, col):
    """Int64 step words of (op, row, col): numpy arrays or integers, or
    torch tensors."""
    if isinstance(op, torch.Tensor):
        return (op.to(torch.int64) | (row.to(torch.int64) << 2)
                | (col.to(torch.int64) << COL_SHIFT))
    return (np.asarray(op, np.int64) | (np.asarray(row, np.int64) << 2)
            | (np.asarray(col, np.int64) << COL_SHIFT))


def step_fields(enc):
    """(op, row, col) of step words (numpy or torch int64)."""
    return enc & 3, (enc >> 2) & ROW_MASK, enc >> COL_SHIFT


def unpack_steps16(s16, n_steps: int, best_i: int, best_j: int):
    """Rebuild step words from one instance's int16 delta stream: the
    walk starts at (best_i, best_j), and i/j are non-increasing along
    it."""
    raw = np.asarray(s16[:n_steps]).astype(np.int64) & 0xFFFF
    i = best_i - np.cumsum((raw >> 3) & 0x1FFF)
    j = best_j - np.cumsum((raw >> 2) & 1)
    return pack_steps(raw & 3, i, j)


def decode_steps_batch(s16, misc):
    """All rounds' and instances' step words in one vectorized pass (the
    tests' reference for pg_replay_loop's decode). s16: int16 [NR, B,
    cap]; misc: int32 [NR, B, M_NMISC]. Entries past an instance's
    M_NSTEPS are garbage and are never read."""
    raw = np.asarray(s16).astype(np.int64) & 0xFFFF
    misc = np.asarray(misc).astype(np.int64)
    iall = (misc[:, :, L.M_BI:L.M_BI + 1]
            - np.cumsum((raw >> 3) & 0x1FFF, axis=2))
    jall = (misc[:, :, L.M_BJ:L.M_BJ + 1]
            - np.cumsum((raw >> 2) & 1, axis=2))
    return pack_steps(raw & 3, iall, jall)


def steps_to_s16w(steps: torch.Tensor, misc: torch.Tensor):
    """Step words [B, LS] + misc -> (wire words [B, LS//2], misc with
    M_LASTI set). For tests that hand-build step streams; the DP kernel
    emits the wire format itself."""
    i32 = torch.int32
    op, iseq, jseq = (f.to(i32)
                      for f in step_fields(steps.to(torch.int64)))
    prev_i = torch.cat([misc[:, L.M_BI:L.M_BI + 1], iseq[:, :-1]], 1)
    prev_j = torch.cat([misc[:, L.M_BJ:L.M_BJ + 1], jseq[:, :-1]], 1)
    s16 = (op | ((prev_j - jseq) << 2)
           | ((prev_i - iseq) << 3)) & 0xFFFF
    s16w = s16[:, 0::2] | (s16[:, 1::2] << 16)
    nst = misc[:, L.M_NSTEPS:L.M_NSTEPS + 1].to(torch.int64)
    lasti = iseq.gather(1, (nst - 1).clamp(min=0))[:, 0]
    misc2 = misc.clone()
    misc2[:, L.M_LASTI] = lasti
    return s16w.contiguous(), misc2


def replay_steps(graph, params, query, steps, n_steps, best_i, best_j,
                 end_i, end_j, res, row0=0):
    """Host replay of decoded step words -> the reference cigar list and
    res fields (used when the pure-Python graph store is active, when
    the cigar itself is the result, and for subgraph windows; the native
    store fuses whole-graph words directly). row0: the topo index of DP
    row 0 (a window's beg_index). push_cigar merging applies only to runs
    of CINS (ref abpoa_align.h:54-73)."""
    from ..cigar import CMATCH, CINS, CDEL
    qlen = len(query)
    i2n = np.asarray(graph.index_to_node_id, dtype=np.int64)[row0:]
    n = int(n_steps)
    ops, rows, cols = step_fields(np.asarray(steps[:n]).astype(np.int64))
    nids = i2n[rows] if n else np.zeros(0, np.int64)
    cigar: list = []
    if best_j < qlen:
        cigar.append((CINS, qlen - 1, qlen - best_j))
    if n:
        m_mask = ops == 0
        res.n_aln_bases += int(m_mask.sum() + (ops == 1).sum())
        if m_mask.any():
            mrows = nids[m_mask]
            bases = graph.build_csr()["bases"][mrows].astype(np.int64)
            res.n_matched_bases += int(
                (bases == np.asarray(query)[cols[m_mask] - 1]).sum())
        brk = np.nonzero(np.diff(ops))[0] + 1
        starts = np.concatenate(([0], brk))
        ends = np.concatenate((brk, [n]))
        for s0, s1 in zip(starts, ends):
            op = int(ops[s0])
            if op == 0:    # one CMATCH entry per column
                cigar.extend(zip([CMATCH] * (s1 - s0),
                                 nids[s0:s1].tolist(),
                                 (cols[s0:s1] - 1).tolist()))
            elif op == 2:  # one CDEL entry per step (CDEL never merges)
                cigar.extend(zip([CDEL] * (s1 - s0), nids[s0:s1].tolist(),
                                 [1] * (s1 - s0)))
            else:          # CINS runs merge, keeping the first pushed qid
                if cigar and cigar[-1][0] == CINS:
                    last = cigar[-1]
                    cigar[-1] = (CINS, last[1], last[2] + (s1 - s0))
                else:
                    cigar.append((CINS, int(cols[s0]) - 1, s1 - s0))
    if int(end_j) > 0:
        if cigar and cigar[-1][0] == CINS:
            last = cigar[-1]
            cigar[-1] = (CINS, last[1], last[2] + int(end_j))
        else:
            cigar.append((CINS, int(end_j) - 1, int(end_j)))
    if not params.rev_cigar:
        cigar.reverse()
    res.cigar = cigar
    res.node_e = int(i2n[int(best_i)])
    res.query_e = int(best_j) - 1
    start_i = int(rows[n - 1]) if n else int(best_i)
    start_j = int(cols[n - 1]) if n else int(best_j)
    res.node_s = int(i2n[start_i])
    res.query_s = start_j - 1
    return res
