"""pyabpoa-compatible Python API.

Drop-in mirror of the reference Cython bindings
(ref abPOA python/pyabpoa.pyx:9-226): `msa_aligner(...)` with the
same constructor defaults and `.msa(seqs, out_cons, out_msa, max_n_cons,
min_freq, out_pog, incr_fn)` returning an `msa_result` with the same
fields and `print_msa()` formatting. Like the reference bindings, the
aligner loops align/add per sequence with seeding and progressive POA
disabled (ref pyabpoa.pyx:133-134) and end_bonus/zdrop disabled
(ref :131-132).

The port's aligner runs on a device: ``msa_aligner(..., device="cuda")``
(the default; "cpu" runs the kernels' plain versions). ``.msa`` aligns
each read through the serial device engine (``align/engine_torch.py``);
``.msa_batch`` runs many problems through ``BatchPOA`` on that device.

    import abpoa_tpu_torch.pyabpoa as pa
    a = pa.msa_aligner()
    res = a.msa(seqs, out_cons=True, out_msa=True)
    res.print_msa()
"""
from __future__ import annotations

import sys

import numpy as np

from .alphabet import decode_table, encode_table
from .api import ABPOA
from .consensus import generate_consensus
from .gfa import restore_graph
from .msa import generate_rc_msa
from .params import (EXTEND_MODE, GLOBAL_MODE, LOCAL_MODE, Params)


class msa_result:
    def __init__(self, n_seq, n_cons, clu_n_seq, clu_read_ids, cons_len,
                 cons_seq, cons_cov, msa_len, msa_seq):
        self.n_seq = n_seq
        self.n_cons = n_cons
        self.clu_n_seq = clu_n_seq
        self.clu_read_ids = clu_read_ids
        self.cons_len = cons_len
        self.cons_seq = cons_seq
        self.cons_cov = cons_cov
        self.msa_len = msa_len
        self.msa_seq = msa_seq

    def print_msa(self):
        """ref pyabpoa.pyx:54-67."""
        if not self.msa_seq:
            return
        for i, s in enumerate(self.msa_seq):
            if i < self.n_seq:
                sys.stdout.write(">Seq_{}\n{}\n".format(i + 1, s))
            else:
                cons_id = ''
                if self.n_cons > 1:
                    cons_id = '_{} {}'.format(
                        i - self.n_seq + 1,
                        ','.join(map(str, self.clu_read_ids[i - self.n_seq])))
                sys.stdout.write(">Consensus_sequence{}\n{}\n"
                                 .format(cons_id, s))


class msa_aligner:
    """ref pyabpoa.pyx msa_aligner (:88-226)."""

    def __init__(self, aln_mode='g', is_aa=False, match=2, mismatch=4,
                 score_matrix='', gap_open1=4, gap_open2=24, gap_ext1=2,
                 gap_ext2=1, extra_b=10, extra_f=0.01, device="cuda"):
        from .device import resolve_device
        resolve_device(device)
        p = Params()
        p.device = device
        modes = {'g': GLOBAL_MODE, 'l': LOCAL_MODE, 'e': EXTEND_MODE}
        if aln_mode not in modes:
            raise ValueError(f"Unknown alignment mode: {aln_mode}")
        p.align_mode = modes[aln_mode]
        p.m = 27 if is_aa else 5
        p.match = match
        p.mismatch = mismatch
        if score_matrix:
            p.use_score_matrix = True
            p.mat_fn = score_matrix if isinstance(score_matrix, str) \
                else score_matrix.decode()
        p.gap_open1 = gap_open1
        p.gap_open2 = gap_open2
        p.gap_ext1 = gap_ext1
        p.gap_ext2 = gap_ext2
        p.ret_cigar = True
        p.wb = extra_b
        p.wf = extra_f
        p.use_qv = False
        p.end_bonus = -1
        p.zdrop = -1
        p.disable_seeding = True
        p.progressive_poa = False
        self.params = p
        self.ab = ABPOA()

    def msa(self, seqs, out_cons, out_msa, max_n_cons=1, min_freq=0.25,
            out_pog='', incr_fn=''):
        from . import align as aln
        p = self.params
        p.out_cons = bool(out_cons)
        p.out_msa = bool(out_msa)
        p.max_n_cons = max_n_cons
        p.min_freq = min_freq
        p.out_pog = (out_pog.decode() if isinstance(out_pog, bytes)
                     else out_pog) or None
        p.incr_fn = (incr_fn.decode() if isinstance(incr_fn, bytes)
                     else incr_fn) or None
        p.post_set()
        ab = self.ab
        ab.reset()
        exist_n = 0
        if p.incr_fn:
            restore_graph(ab, p)
            exist_n = ab.n_seq
        seq_n = len(seqs)
        tot_n = seq_n + exist_n
        ab.n_seq = tot_n
        ab.names.extend([""] * seq_n)
        ab.is_rc.extend([0] * seq_n)
        tab = encode_table(p.m)
        for read_i, seq in enumerate(seqs):
            raw = seq.encode() if isinstance(seq, str) else bytes(seq)
            bseq = tab[np.frombuffer(raw, dtype=np.uint8)]
            res = aln.align_sequence_to_graph(ab.graph, p, bseq,
                                              arena=ab.arena)
            cigar = res.cigar if res is not None else []
            ab.graph.add_graph_alignment(p, bseq, [1] * len(bseq), cigar,
                                         None, exist_n + read_i, True)
        if p.out_msa:
            generate_rc_msa(ab, p)
        elif p.out_cons:
            generate_consensus(ab, p)
        if p.out_pog:
            from .plot import dump_pog
            dump_pog(ab, p)
        return self._collect_result(ab, p, tot_n)

    def _collect_result(self, ab, p, tot_n):
        abc = ab.cons
        dec = decode_table(p.m)
        n_cons = abc.n_cons
        clu_n_seq, clu_read_ids = [], []
        cons_len, cons_seq, cons_cov, msa_seq = [], [], [], []
        for i in range(n_cons):
            clu_n_seq.append(abc.clu_n_seq[i])
            cons_len.append(abc.cons_len[i])
            clu_read_ids.append(list(abc.clu_read_ids[i]))
            cons_seq.append(bytes(dec[c] for c in abc.cons_base[i])
                            .decode())
            cons_cov.append(list(abc.cons_cov[i]))
        msa_len = abc.msa_len
        if msa_len > 0:
            for i in range(abc.n_seq + n_cons):
                msa_seq.append(bytes(dec[c] for c in abc.msa_base[i]
                                     [:msa_len]).decode())
        return msa_result(tot_n, n_cons, clu_n_seq, clu_read_ids,
                          cons_len, cons_seq, cons_cov, msa_len, msa_seq)

    def msa_batch(self, seqs_list, out_cons, out_msa, max_n_cons=1,
                  min_freq=0.25):
        """Extension with no reference analog: run many independent MSA
        problems through the batched device pipeline
        (parallel/batch.BatchPOA, on the aligner's device) and return one
        msa_result per input, each identical to what .msa() returns for
        that input alone."""
        from .parallel.batch import BatchPOA
        p = self.params
        p.out_cons = bool(out_cons)
        p.out_msa = bool(out_msa)
        p.max_n_cons = max_n_cons
        p.min_freq = min_freq
        p.out_pog = None
        p.incr_fn = None
        p.post_set()
        tab = encode_table(p.m)
        instances = []
        for seqs in seqs_list:
            enc = []
            for seq in seqs:
                raw = seq.encode() if isinstance(seq, str) else bytes(seq)
                enc.append(tab[np.frombuffer(raw, dtype=np.uint8)])
            instances.append(enc)
        abs_ = BatchPOA(p, p.device).run(instances)
        outs = []
        for ab in abs_:
            if p.out_msa:
                generate_rc_msa(ab, p)
            elif p.out_cons:
                generate_consensus(ab, p)
            outs.append(self._collect_result(ab, p, ab.n_seq))
        return outs

