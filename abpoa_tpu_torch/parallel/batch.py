"""Batched POA through the device-resident loop.

Counterpart of ``abpoa_tpu/parallel/batch.py`` (``BatchPOA``,
``_loop_geometry``, ``_DeviceLoop``, ``batch_msa_from_files``) for the
device-loop path. Read 0 of every instance is fused on the host; the
remaining reads run as rounds of the device loop (``ops/poa_loop.py``);
the host then replays the per-round step streams through the native C
fusion (``NativeGraph.fuse_steps``) to rebuild the authoritative graph
for consensus/MSA/GFA. An instance whose sticky fail flag is set (band
overflow, walk dead end, graph capacity) is rebuilt on the bit-exact
oracle: that is the algorithm's capacity rule and is counted in
``fallbacks``. A device or kernel fault is never caught.

Scope: global mode, banded, m == 5, unit weights, any gap mode,
amb_strand (applied in the replay). Other batches raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from abpoa_tpu.api import ABPOA
from abpoa_tpu.params import Params, GLOBAL_MODE

from ..device import resolve_device
from ..ops import graph_update
from ..ops import layout as L
from ..ops import poa_loop as pl
from ..ops.steps import decode_steps_batch, replay_steps, unpack_steps16

# two sub-batches pipeline the device loop against the host replay once
# the batch has at least this many live instances
SPLIT_MIN = 16

_HOST_POOL = None


def _host_pool():
    """Shared pool for per-instance host work (replay fusion, consensus):
    the hot paths are C calls through ctypes, which release the GIL."""
    global _HOST_POOL
    if _HOST_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor
        _HOST_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 4),
            thread_name_prefix="abpoa-torch-host")
    return _HOST_POOL


def _make_aligners(instances):
    """One ABPOA per instance, graph store backed by the native C core
    when available; read r of an instance has read id r."""
    from abpoa_tpu.graph import NativeGraph
    native = NativeGraph.available()
    abs_ = [ABPOA() for _ in instances]
    for ab, reads in zip(abs_, instances):
        ab.n_seq = len(reads)
        ab.names = [""] * len(reads)
        ab.is_rc = [0] * len(reads)
        if native:
            ab.graph = NativeGraph()
            ab.graph.ensure_reads(ab.n_seq)
    return abs_


def _unit(q):
    """Unit per-base weights (qv weights are ROADMAP A4q)."""
    return [1] * len(q)


def _loop_geometry(params, instances):
    """Static LoopConfig (B unset) for a batch, or None when the batch is
    outside the device loop's envelope."""
    from abpoa_tpu.align.engine_np import score_width_dispatch
    from abpoa_tpu.align.engine_jax import pick_WB
    lens = [len(q) for reads in instances for q in reads]
    if not lens:
        return None
    maxlen = max(lens)
    NR = max(len(reads) for reads in instances) - 1
    if NR < 1 or maxlen < 1:
        return None
    # node capacity: progressive graphs grow to ~maxlen + variants;
    # instances that outgrow it fail sticky and go to the oracle
    R = min(4096, (int(maxlen + max(96, maxlen // 4)) + 63) // 64 * 64)
    R = max(R, 128)
    bits, pn, _ln, inf_min = score_width_dispatch(params, R, maxlen)
    if bits != 16:
        return None       # pn would vary per round
    WB = pick_WB(params, maxlen, pn)
    Wq = ((maxlen // 128) + 1) * 128
    Wq = (Wq + WB - 1) // WB * WB
    LS = (R + Wq + 63) // 64 * 64
    # one CUDA thread per band lane
    if Wq >= 32000 or R > 4096 or WB > 1024:
        return None
    # out-edge weights pack above the node-id bits in 16-bit halves:
    # unit weights bound an edge's weight by the reads per instance
    max_reads = max(len(reads) for reads in instances)
    wbits = max(4, int(max_reads).bit_length())
    if wbits > 6 or R > (1 << (16 - wbits)):
        return None
    cfg = pl.LoopConfig(R=R, E=12, P=8, A=4, Wq=Wq, WB=WB, LS=LS, NR=NR,
                        B=0, pn=pn, inf_min=inf_min,
                        gap_mode=params.gap_mode, wbits=wbits)
    # the graph kernel keeps an instance's state in shared memory
    if graph_update.smem_bytes(cfg) > graph_update.MAX_SMEM_BYTES:
        return None
    return cfg


class BatchPOA:
    """Run many independent POA problems through the device loop.

    instances: list of problems; each problem is a list of encoded reads
    (uint8 codes). ``run`` returns the ABPOA aligner states (call
    generate_consensus / output on them like the single-instance API).
    device: "cuda" (the kernels) or "cpu" (their plain versions); there
    is no default and no fallback from one to the other.
    """

    def __init__(self, params: Params, device):
        self.params = params
        self.device = resolve_device(device)
        self.dp_cells = 0          # band cells computed on the device
        self.dp_seconds = 0.0      # wall time of the device-loop phase
        self.dp_intervals = []     # (t0, t1) per sub-batch fetch
        self.fallbacks = 0         # instances rebuilt on the oracle
        self.rounds = 0
        self.used_device_loop = False
        self.precompute_cons = False   # consensus inside the replay pool
        self.s16_cap = None        # forced step-stream fetch cap (tests:
        #                            exercises the over-cap refetch)

    def _amb_flagged(self, ab, q, score: int) -> bool:
        """Ambiguous-strand retry threshold (ref abpoa_align.c:315)."""
        thres = (min(len(q), ab.graph.node_n - 2)
                 * self.params.max_mat * .3333)
        return score < thres

    def _scope_error(self, weights, init):
        p = self.params
        if weights is not None:
            return ("qv weights (wmode=1) are not ported yet: ROADMAP A4q")
        if init is not None:
            return ("incremental graphs (-i) run on the round-based path, "
                    "not ported yet: ROADMAP A6")
        if p.align_mode != GLOBAL_MODE or p.wb < 0 or p.m != 5 \
                or p.rev_cigar:
            return ("local/extend, unbanded and protein batches run on "
                    "the round-based path, not ported yet: ROADMAP A6")
        return None

    def run(self, instances, weights=None, init=None) -> list[ABPOA]:
        reason = self._scope_error(weights, init)
        if reason is not None:
            raise NotImplementedError(reason)
        params = self.params
        abs_ = _make_aligners(instances)
        if max((len(r) for r in instances), default=0) <= 1:
            # nothing to align: read 0 fuses straight into the graph
            for ab, reads in zip(abs_, instances):
                if reads:
                    ab.graph.add_graph_alignment(params, reads[0],
                                                 _unit(reads[0]), [], None,
                                                 0, True)
            return abs_
        cfg = _loop_geometry(params, instances)
        if cfg is None:
            raise NotImplementedError(
                "batch outside the device loop's envelope (32-bit scores, "
                "band wider than 1024 lanes, graph state over the shared "
                "memory of a block, or more than 63 reads per instance) "
                "runs on the round-based path, not ported yet: ROADMAP A6")
        _DeviceLoop(self, abs_, instances, cfg).run()
        return abs_

    def dp_busy_seconds(self) -> float:
        """Union length of the device-phase intervals."""
        total = 0.0
        end = float("-inf")
        for t0, t1 in sorted(self.dp_intervals):
            if t0 > end:
                total += t1 - t0
                end = t1
            elif t1 > end:
                total += t1 - end
                end = t1
        return total

    def run_consensus(self, instances, weights=None):
        """Batched POA then consensus per instance; returns the list of
        consensus strings per instance (heaviest bundling)."""
        from abpoa_tpu.consensus import generate_consensus
        from abpoa_tpu.alphabet import decode_table
        self.precompute_cons = True
        abs_ = self.run(instances, weights=weights)
        tab = decode_table(self.params.m)

        def cons_one(ab):
            generate_consensus(ab, self.params)
            c = ab.cons
            return [bytes(tab[b] for b in seq).decode()
                    for seq in c.cons_base[:c.n_cons]]
        return list(_host_pool().map(cons_one, abs_))


def batch_msa_from_files(params, fns, out, device):
    """Batched CLI list mode (-l): one POA instance per input file, outputs
    rendered in file order, byte-identical to running abpoa_msa1 serially
    per file (ref src/abpoa_align.c:439-503)."""
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table
    if params.use_qv:
        raise NotImplementedError("qv weights (-Q) are not ported yet: "
                                  "ROADMAP A4q")
    if params.incr_fn:
        raise NotImplementedError("incremental graphs (-i) run on the "
                                  "round-based path, not ported yet: "
                                  "ROADMAP A6")
    if not (params.disable_seeding and not params.progressive_poa) \
            and params.align_mode == GLOBAL_MODE:
        raise NotImplementedError("seeded windows (-S/-p) are not ported "
                                  "yet: ROADMAP A7")
    tab = encode_table(params.m)
    instances = []
    names = []
    for fn in fns:
        recs = read_seqs(fn)
        if not recs:
            # serial parity: an empty input file produces no output
            continue
        names.append([r.name for r in recs])
        instances.append([tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
                          for r in recs])
    if not instances:
        return
    abs_ = BatchPOA(params, device).run(instances)
    for ab, nm in zip(abs_, names):
        ab.names = nm
        ab.output(params, out)


class _DeviceLoop:
    """One batched device-loop execution (state build, loop, replay)."""

    def __init__(self, bp: BatchPOA, abs_, instances, cfg):
        self.bp = bp
        self.abs_ = abs_
        self.instances = instances
        self.cfg = cfg

    def _launch(self, part):
        """Build one sub-batch's inputs, enqueue its loop and the copies of
        its results to pinned host memory. Returns the pending handle."""
        bp, params = self.bp, self.bp.params
        dev = bp.device
        cfg = self.cfg._replace(B=len(part))
        graphs = [self.abs_[k].graph for k in part]
        st, i2n, n2i, remain = pl.init_state_np(graphs, cfg)
        qc = np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int8)
        ql = np.zeros((cfg.NR, cfg.B), np.int32)
        for b, k in enumerate(part):
            for r, q in enumerate(self.instances[k][1:]):
                qc[r, b, 1:len(q) + 1] = q
                ql[r, b] = len(q)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                dev, non_blocking=True)
        st_d = pl.GState(*(put(x) for x in st))
        psF, misc_d, s16_d = pl.poa_device_loop(
            cfg, st_d, put(i2n), put(n2i), put(remain), put(qc), put(ql),
            put(pl.make_scal_base(params, cfg)), int(params.wb),
            int(round(params.wf * 1000)))
        maxlen = int(ql.max())
        cap = min(cfg.LS, (maxlen + max(96, maxlen // 4) + 63) // 64 * 64)
        if bp.s16_cap is not None:
            cap = max(2, min(cap, int(bp.s16_cap)))
        s16_cap_d = s16_d[:, :, :cap // 2].contiguous()
        if dev.type == "cuda":
            # copies into pinned memory right after this part's last
            # kernel, so the host waits for this part alone
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (misc_d, s16_cap_d, psF.fail)]
            for h, t in zip(host, (misc_d, s16_cap_d, psF.fail)):
                h.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host = [misc_d, s16_cap_d, psF.fail]
            ev = None
        return part, cfg, host, ev, s16_d

    def run(self):
        bp, params = self.bp, self.bp.params
        abs_, instances = self.abs_, self.instances
        for ab, reads in zip(abs_, instances):
            if reads:
                ab.graph.add_graph_alignment(params, reads[0],
                                             _unit(reads[0]), [], None, 0,
                                             True)
                ab.graph.topological_sort(params)
        live = [k for k, reads in enumerate(instances) if len(reads) >= 2]
        if len(live) >= SPLIT_MIN:
            mid = (len(live) + 1) // 2
            parts = [live[:mid], live[mid:]]
        else:
            parts = [live]
        bp.used_device_loop = True
        t_prev = time.perf_counter()
        pends = [self._launch(part) for part in parts]
        for part, cfg, host, ev, s16_d in pends:
            if ev is not None:
                ev.synchronize()
            misc, s16w, failv = (h.numpy() for h in host)
            s16 = s16w.view(np.int16)
            t1 = time.perf_counter()
            bp.dp_seconds += t1 - t_prev
            bp.dp_intervals.append((t_prev, t1))
            t_prev = t1
            bp.rounds += cfg.NR
            ok_mask = failv == 0
            bp.fallbacks += int((~ok_mask).sum())
            for b, k in enumerate(part):
                if ok_mask[b]:
                    nr_k = len(instances[k]) - 1
                    bp.dp_cells += int(misc[:nr_k, b, L.M_CELLS].sum())
            self._replay(part, misc, s16, s16_d, ok_mask)
        return True

    def _replay(self, live, misc, s16, s16_d, ok_mask):
        bp, params = self.bp, self.bp.params
        abs_, instances = self.abs_, self.instances
        from abpoa_tpu.graph import NativeGraph
        steps_all = decode_steps_batch(s16, misc)

        def replay_one(b_k):
            b, k = b_k
            ab = abs_[k]
            reads = instances[k]
            if not ok_mask[b]:
                # sticky device failure: rebuild on the bit-exact oracle
                ab.graph.reset()
                for r, q in enumerate(reads):
                    ab.poa_one(params, q, _unit(q), r)
            else:
                g = ab.graph
                for r, q in enumerate(reads[1:]):
                    mi = misc[r, b]
                    if params.amb_strand and bp._amb_flagged(
                            ab, q, int(mi[L.M_BEST])):
                        # ambiguous-strand retry (ref abpoa_align.c:315):
                        # the device ran fw-only, so from the first flagged
                        # round the sequential fwd+rc body finishes
                        for rr in range(r + 1, len(reads)):
                            ab.poa_one(params, reads[rr], _unit(reads[rr]),
                                       rr)
                        break
                    nst = int(mi[L.M_NSTEPS])
                    if nst > s16.shape[2]:   # over the fetch cap: refetch
                        w = s16_d[r, b, :(nst + 1) // 2].cpu().numpy()
                        steps32 = unpack_steps16(
                            np.ascontiguousarray(w).view(np.int16)[:nst],
                            nst, int(mi[L.M_BI]), int(mi[L.M_BJ]))
                    else:
                        steps32 = steps_all[r, b]
                    if not g.is_topological_sorted:
                        g.topological_sort(params)
                    if isinstance(g, NativeGraph):
                        g.fuse_steps(params, 0, steps32, nst,
                                     int(mi[L.M_BJ]), int(mi[L.M_ENDJ]),
                                     q, r + 1, True)
                    else:
                        from abpoa_tpu.align.engine_np import AlignResult
                        res = AlignResult()
                        replay_steps(g, params, np.asarray(q), steps32, nst,
                                     int(mi[L.M_BI]), int(mi[L.M_BJ]),
                                     int(mi[L.M_ENDI]), int(mi[L.M_ENDJ]),
                                     res)
                        g.add_graph_alignment(params, q, _unit(q),
                                              res.cigar, None, r + 1, True)
            if bp.precompute_cons:
                from abpoa_tpu.consensus import generate_consensus
                generate_consensus(ab, params)

        for fut in [_host_pool().submit(replay_one, bk)
                    for bk in enumerate(live)]:
            fut.result()
        return True
