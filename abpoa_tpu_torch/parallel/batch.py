"""Batched POA across many independent instances, on the device.

Counterpart of ``abpoa_tpu/parallel/batch.py`` (``BatchPOA``,
``_loop_geometry``, ``_DeviceLoop``, the round-based path,
``run_seeded``, ``batch_msa_from_files``). ``BatchPOA.run`` sends a
batch down one of two paths, decided by eligibility alone:

* the device-resident loop (``_DeviceLoop``), when ``_loop_geometry``
  accepts the batch: global mode, banded, nucleotides, no ``-i``
  restore, 16-bit scores, graphs of at most 4096 nodes and bands of at
  most 2048 lanes (the JAX package's envelope where its R is uncapped).
  Read 0 of every instance is fused on the host;
  the remaining reads run as rounds of the device loop
  (``ops/poa_loop.py``: band DP + graph update kernels, no host round
  trip); the host then replays the per-round step streams through the
  native C fusion to rebuild the authoritative graph.
* the round-based path (``_Rounds``) for every other batch: local and
  extend mode, unbanded (``-b -1``), protein, ``-i`` restores, 32-bit
  scores, and batches outside the loop's envelope. Each round the host
  sorts and exports every live instance's graph (``align/export.py``),
  groups the instances by score width, and one DP kernel per group runs
  the DP and the walk on the device: the topo-mode band kernel
  (``ops/band_dp.py``) when the band fits a block, else the full-width
  kernel (``ops/fw_dp.py``) when its planes fit the memory budget, else
  the banded-tile kernel (``ops/tile_dp.py``). The host fuses the step
  streams.

``BatchPOA.run_seeded`` runs seeded/progressive POA (``-S``/``-p``):
seeding, the guide tree and chaining per instance on the host, then
window rounds: each instance's next window (the read between two
anchors against the subgraph between their nodes) is exported with its
reachability row mask, and one kernel per score-width group aligns them
all: the topo-mode band kernel in its non-fresh mode (the window's band
state in) when the band fits a block, else the full-width kernel. Both
gate dead rows by the row mask; the band state is written back for the
live rows only.

An instance whose device result is unusable (band overflow, walk dead
end, graph capacity) is rebuilt on the bit-exact oracle: that is the
algorithm's capacity rule and is counted in ``fallbacks``. So is every
instance of a round group whose one instance needs more plane memory
than the budget (``device.plane_budget``): the group has no launch (the
JAX package runs its XLA tier there). A device or kernel fault is never
caught.

Data parallelism (``BatchPOA(devices=[...])``, the counterpart of the
JAX package's ``mesh=``): the path and its geometry are decided once for
the whole batch (the device loop's ``LoopConfig``, each round group's
``round_plan``); the live instances then split into contiguous shards
in global order (``multihost.shard_bounds``), one per entry of the
device list, and every shard runs that plan with its own batch size.
Each shard launches on a CUDA stream of its own (entries may repeat a
card), all shards are launched before any result is fetched, and all
launches come from the calling thread (the wrappers' launch counts are
plain integers). The outputs equal the single-device run byte for byte.

Host/device pipeline (``BatchPOA(pipeline=True)``, the default, as in
the JAX package): a round-path batch of 4 or more instances splits
round-robin into ``min(N_SHARDS, n // 4)`` shards, and a seeded batch
of 8 or more into two groups (instance k in group k % 2). Each shard
keeps its own round counter, re-pads to its own maxima and plans its
own rounds; every idle shard's round is prepared and launched on
streams of its own, then the oldest shard in flight is collected and
fused while the others' rounds are on the device (``_pipeline``,
``_Job``). ``pipeline=False``, or a smaller batch, runs every round in
lockstep: the one-shard case of the same code. The outputs equal the
lockstep run byte for byte; launch counts follow each shard's plan.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..api import ABPOA
from ..params import Params, GLOBAL_MODE, SRC_NODE_ID, SINK_NODE_ID

from ..device import plane_budget, resolve_device
from ..ops import band_dp
from ..ops import layout as L
from ..ops import poa_loop as pl
from ..ops.steps import replay_steps, unpack_steps16
from ..align.export import repad_dense
from .multihost import shard_bounds

# two sub-batches pipeline the device loop against the host replay once
# the batch has at least this many live instances
SPLIT_MIN = 16

_HOST_POOL = None


def _host_pool():
    """Shared pool for per-instance host work (graph fusion, toposort,
    export, consensus): the hot paths are C calls through ctypes, which
    release the GIL."""
    global _HOST_POOL
    if _HOST_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor
        _HOST_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 4),
            thread_name_prefix="abpoa-torch-host")
    return _HOST_POOL


def _make_aligners(instances, params, init=None):
    """One ABPOA per instance, graph store backed by the native C core
    when available.

    init(ab), when given, seeds each aligner's starting state before any
    read fuses (the batched analog of the serial loop's incremental
    restore, -i, ref abpoa_restore_graph src/abpoa_seq.c:595-660).
    Returns (aligners, read_id_offsets): new reads number from each
    instance's existing read count, exactly like the serial msa()."""
    from ..graph import NativeGraph
    native = NativeGraph.available()
    abs_ = [ABPOA() for _ in instances]
    if native:
        for ab in abs_:
            ab.graph = NativeGraph()
    rid0 = []
    for ab, reads in zip(abs_, instances):
        if init is not None:
            init(ab)
        exist = ab.n_seq
        rid0.append(exist)
        ab.n_seq = exist + len(reads)
        ab.names = list(ab.names) + [""] * len(reads)
        ab.is_rc = list(ab.is_rc) + [0] * len(reads)
        if native:
            ab.graph.ensure_reads(ab.n_seq)
    return abs_, rid0


def _step_stream(pend, steps, b, nst):
    """Instance b's step words. A stream longer than the fetch cap (long
    deletion runs) is refetched from the device tensor kept in the
    pending handle, on the stream of the shard that wrote it (another
    shard's kernel may be in flight on its own stream)."""
    srow = steps[b]
    if nst > srow.shape[0]:
        with _on(pend["shard"]):
            srow = pend["steps_dev"][b, :nst].cpu().numpy()
    return srow


def _loop_geometry(params, instances, wmax=None):
    """Static LoopConfig (B unset) for a batch, or None when the batch is
    outside the device loop's envelope. wmax: with qv weights, the bound
    on any edge's weight; it selects the wide-weight graph kernel
    (wmode 1) when it fits 15 bits."""
    from ..align.engine_np import score_width_dispatch
    from ..align.export import pick_WB
    lens = [len(q) for reads in instances for q in reads]
    if not lens:
        return None
    maxlen = max(lens)
    NR = max(len(reads) for reads in instances) - 1
    if NR < 1 or maxlen < 1:
        return None
    # node capacity: progressive graphs grow to ~maxlen + variants;
    # instances that outgrow it fail sticky and go to the oracle. The
    # JAX package caps R at 4096 and sends every instance whose graph
    # outgrows it to the host oracle; here such a batch (reads past
    # about 3,276 bp) takes the round path instead, which runs it on the
    # card with no fallback and gives the same bytes
    R = (int(maxlen + max(96, maxlen // 4)) + 63) // 64 * 64
    if R > 4096:
        return None
    R = max(R, 128)
    bits, pn, _ln, inf_min = score_width_dispatch(params, R, maxlen)
    if bits != 16:
        return None       # pn would vary per round
    WB = pick_WB(params, maxlen, pn)
    Wq = ((maxlen // 128) + 1) * 128
    Wq = (Wq + WB - 1) // WB * WB
    LS = (R + Wq + 63) // 64 * 64
    # the band kernel's block: up to 512 threads of 2 or 4 lanes each
    if Wq >= 32000 or WB > band_dp.MAX_WB:
        return None
    if wmax is not None:
        # qv weights: out-edge entries are full words id | w<<16, so
        # every edge's weight sum must fit 15 bits
        if wmax >= (1 << 15):
            return None
        wmode, wbits = 1, 4          # wbits is unused in wmode 1
    else:
        # out-edge weights pack above the node-id bits in 16-bit halves:
        # unit weights bound an edge's weight by the reads per instance
        max_reads = max(len(reads) for reads in instances)
        wmode, wbits = 0, max(4, int(max_reads).bit_length())
        if wbits > 6 or R > (1 << (16 - wbits)):
            return None
    # the graph kernel keeps an instance's state in shared memory where
    # it fits, else in global memory (graph_update.state_in_global)
    return pl.LoopConfig(R=R, E=12, P=8, A=4, Wq=Wq, WB=WB, LS=LS, NR=NR,
                         B=0, pn=pn, inf_min=inf_min,
                         gap_mode=params.gap_mode, wbits=wbits, wmode=wmode)


class _Shard(NamedTuple):
    """One entry of a BatchPOA's device list."""
    dev: torch.device
    stream: object     # its own torch.cuda.Stream; None: the device's
    #                    current stream (one device, no list) or the CPU
    in_flight: int     # shards of the list on the same card
    entry: int         # its index in the list (``BatchPOA.shards``)


@contextlib.contextmanager
def _on(shard: _Shard):
    """Make the shard's device and stream current (nothing on the CPU):
    the wrappers launch on torch.cuda.current_stream(dev), and tensors
    allocated here belong to the shard's stream."""
    if shard.dev.type != "cuda":
        yield
        return
    with torch.cuda.device(shard.dev):
        stream = shard.stream or torch.cuda.current_stream(shard.dev)
        with torch.cuda.stream(stream):
            yield


def _union_s(intervals) -> float:
    """Length of the union of (t0, t1) intervals."""
    total = 0.0
    end = float("-inf")
    for t0, t1 in sorted(intervals):
        if t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def _enqueue_fetch(shard: _Shard, tensors):
    """Enqueue copies of `tensors` to pinned host memory on the shard's
    stream and record an event (one that can be timed) on that same
    stream after them. Returns (host tensors, event); on the CPU (the
    tensors, None)."""
    if shard.dev.type != "cuda":
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    with _on(shard):
        stream = torch.cuda.current_stream(shard.dev)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
    return host, ev


class _EventClock:
    """Places device phases timed by CUDA events on the host clock. The
    first timing event recorded on a card is that card's anchor, with
    the host clock read just before it; a phase between two events on
    that card is the anchor's host time plus the device time from the
    anchor to each. Phases queued on one stream follow each other as on
    the card, and a phase does not grow while the host works on
    something else."""

    def __init__(self):
        self.anchors = {}

    def mark(self, dev):
        """A timing event recorded now on dev's current stream."""
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev.record(torch.cuda.current_stream(dev))
        self.anchors.setdefault(dev, (t0, ev))
        return ev

    def interval(self, dev, start, end):
        """(t0, t1) on the host clock of the phase from `start` to `end`,
        two completed events of `dev`."""
        t_a, anchor = self.anchors[dev]
        anchor.synchronize()
        return (t_a + anchor.elapsed_time(start) / 1e3,
                t_a + anchor.elapsed_time(end) / 1e3)


class RoundPlan(NamedTuple):
    """How one round's score-width group runs on the device."""
    band: bool        # topo-mode band kernel
    name: str         # "band_dp_topo", "fw_dp" or "tile_dp"
    kernel: object    # band_poa_dp_batch, fw_poa_dp_batch,
    #                   tile_poa_dp_batch, or None ("oracle")
    cfg: object       # its BandConfig / FWConfig / PallasDPConfig
    arrs: list        # per instance, the make_pallas_inputs tuple
    chunk: int        # instances per launch (the plane-memory budget;
    #                   0: one instance exceeds it)
    step_cap: int     # step-stream fetch cap
    per: int          # plane bytes an instance

    def stack(self, part, dev):
        """The kernel's stacked input tensors for instances `part`."""
        return [torch.from_numpy(np.stack([a[i] for a in self.arrs[part]]))
                .to(dev) for i in range(len(self.arrs[0]))]


def band_refusal(params, R: int, P: int, WB: int, Wq: int, pn: int):
    """The first limit of the topo-mode band kernel (B3) that a round
    group of this geometry crosses, or None where B3 takes it: "unbanded"
    (``-b -1``), the 16-bit packings ("query": columns below 32000,
    "rows": predecessor rows below 2^16), "lanes" (WB past ``MAX_WB``,
    512 threads of four lanes), "slots" (P past ``MAX_P``), "segments"
    (the query's band segments, 10-bit fields, past 1023) and "shared
    memory" (``band_smem_bytes`` past a block's). P is the kernel's slot
    count (``band_slots``). Where the JAX package's round and seeded
    paths take their band kernel (abpoa_tpu/parallel/batch.py: ``Gb > 0
    and Wq < 32000 and R <= 4096 and P < 32 and wb >= 0``) this takes
    B3 but for these limits; it also takes B3 past 4096 rows, where the
    JAX package runs its XLA tier."""
    WqB = (Wq + WB - 1) // WB * WB
    for limit, crossed in (
            ("unbanded", params.wb < 0), ("query", Wq >= 32000),
            ("rows", R >= 1 << 16), ("lanes", WB > band_dp.MAX_WB),
            ("slots", P > band_dp.MAX_P), ("segments", WqB // pn >= 1024),
            ("shared memory", band_dp.band_smem_bytes(False, R, P, WB)
             > band_dp.MAX_SMEM_BYTES)):
        if crossed:
            return limit
    return None


def band_slots(dgs) -> int:
    """B3's predecessor slots for a round group: the exports' slot count
    (a power of two, ``export_dense``) up to 16; past it the even cover
    of the group's largest in-degree, so that nodes of 17-30
    predecessors stay within ``MAX_P``."""
    P_ = max(d.P for d in dgs)
    if P_ <= 16:
        return P_
    need = max(int(d.pre_n[:d.n_rows].max(initial=1)) for d in dgs)
    return max(2, (need + 1) // 2 * 2)


def round_plan(params, dgs, dev, seeded=False, budget=None) -> RoundPlan:
    """The dispatch rule of one round's group of exports (re-padded to
    one geometry): the topo-mode band kernel where ``band_refusal``
    names no limit (bands of up to 2048 lanes, up to 30 predecessor
    slots, ``band_slots``); else the full-width kernel when one
    instance's planes fit the memory budget (``device.plane_budget``);
    else the banded-tile kernel, whose [R, WB] tiles are chunked to the
    same budget (an instance whose band outgrows its tile goes to the
    oracle through M_OVFL).

    seeded: the exports are subgraph windows; the band kernel runs
    non-fresh (band state and row mask from the export), and there is no
    third branch: the banded-tile kernel has no row mask.

    budget: the plane bytes a launch may take (default
    ``plane_budget(dev)``). A group whose one instance's planes or tiles
    exceed the budget gets the plan "oracle" (no kernel, chunk 0): its
    instances go to the oracle."""
    import dataclasses
    from ..align.export import make_pallas_inputs, pick_WB
    from ..ops import fw_dp, tile_dp
    R = dgs[0].R
    P_ = max(d.P for d in dgs)
    pn = dgs[0].pn
    WB = max(pick_WB(params, dg.qlen, dg.pn) for dg in dgs)
    Wq = max((dg.qlen // 128 + 1) * 128 for dg in dgs)
    LMAX = (R + Wq + 63) // 64 * 64
    WqB = (Wq + WB - 1) // WB * WB
    Pb = band_slots(dgs)
    band = band_refusal(params, R, Pb, WB, Wq, pn) is None
    if band and Pb < P_:
        # the slots past the largest in-degree hold no predecessor
        dgs = [dataclasses.replace(d, P=Pb, pre_idx=d.pre_idx[:, :Pb])
               for d in dgs]
        P_ = Pb
    made = [make_pallas_inputs(dg, params, WB, force_Wq=WqB if band else Wq,
                               bt_lmax=LMAX) for dg in dgs]
    c0 = made[0][0]
    if budget is None:
        budget = plane_budget(dev)
    if band:
        cfg = band_dp.BandConfig(
            gap_mode=c0.gap_mode, pn=c0.pn, R=R, WB=WB, Wq=WqB, P=P_,
            m=c0.m, bt_lmax=LMAX, align_mode=c0.align_mode,
            use_zdrop=c0.use_zdrop, fresh=not seeded, nid=False)
        per = band_dp.band_nplanes(cfg.gap_mode) * R * WB * 4
        kernel, name = band_dp.band_poa_dp_batch, "band_dp_topo"
    else:
        cfg = fw_dp.FWConfig(c0.gap_mode, c0.align_mode, c0.pn, R, Wq, P_,
                             dgs[0].O, c0.m, c0.use_zdrop, LMAX,
                             banded=params.wb >= 0)
        per = fw_dp.fw_plane_bytes(cfg)
        kernel, name = fw_dp.fw_poa_dp_batch, "fw_dp"
        if per > budget and not seeded:
            cfg = c0
            per = tile_dp.tile_plane_bytes(cfg)
            kernel, name = tile_dp.tile_poa_dp_batch, "tile_dp"
    chunk = budget // per
    if chunk < 1:
        kernel, name, chunk = None, "oracle", 0
    # adaptive fetch cap: the walk is bounded by rows + qlen, but the
    # typical path is ~qlen + a few deletions; the rare longer stream is
    # refetched from the device tensor
    hard_cap = min(LMAX, (max(d.n_rows for d in dgs)
                          + max(d.qlen for d in dgs) + 71) // 64 * 64)
    qmax = max(d.qlen for d in dgs)
    step_cap = min(hard_cap, (qmax + max(96, qmax // 4) + 63) // 64 * 64)
    return RoundPlan(band, name, kernel, cfg, [m[1] for m in made], chunk,
                     step_cap, per)


class BatchPOA:
    """Run many independent POA problems on the device.

    instances: list of problems; each problem is a list of encoded reads
    (uint8 codes). ``run`` returns the ABPOA aligner states (call
    generate_consensus / output on them like the single-instance API).
    device: "cuda" (the kernels, the default) or "cpu" (their plain
    versions); there is no fallback from one to the other.
    devices: a device list ("cuda:i" strings, torch.devices or "cpu";
    entries may repeat) that replaces `device`: the batch's instances
    split into one contiguous shard per entry, each launched on a stream
    of its own (see the module docstring).
    pipeline: overlap host work with device rounds, as the JAX package
    does (see the module docstring); False runs every round in lockstep.

    Device time has one clock. ``dp_intervals`` holds each launch's
    device phase as (t0, t1) on the host clock: on a card the time
    between the timing event before its upload and its fetch's event,
    placed by ``clock``; on the CPU the host clock around the plain
    versions. A phase spans the whole launch, so it also counts the time
    the card waits for the host to enqueue the launch's kernels.
    ``dp_busy_seconds()`` is the length of their union.

    ``shards`` holds one record per entry of the device list, summed over
    the runs of this BatchPOA: ``device``; ``instances``, the instances
    its launches carried (a round group counts once per round, a seeded
    window round once per window); ``busy_s``, the union of the entry's
    own device phases (of ``dp_intervals``); ``launched_s``, host
    seconds from the start of the run's rounds (on the device loop its
    first sub-batch's export) to the end of the entry's last enqueue, 0
    for an entry with no launch. They are read from what the paths
    already record: no event, synchronisation or launch is added for
    them.

    Counters, summed over the runs: ``fallbacks``, the instances rebuilt
    on the host oracle (see the module docstring); on the device loop,
    ``replayed_native``, the reads of the instances that did not fail
    there fused on the host by one native call an instance
    (``NativeGraph.replay_loop``; a step stream past the fetch cap by a
    call of its own), and ``replayed_python``, those fused one at a time
    (an amb_strand retry, the pure-Python graph store).
    """

    N_SHARDS = 4      # pipeline shards of the round path at most

    def __init__(self, params: Params, device="cuda", devices=None,
                 pipeline=True):
        import dataclasses
        from collections import Counter
        self.params = params
        # the oracle rebuilds (capacity fallbacks, amb_strand retries)
        # run on the host oracle whatever engine params names
        self.host_params = dataclasses.replace(params, engine="numpy")
        if devices is None:
            devs = [resolve_device(device)]
        else:
            devs = [resolve_device(d) for d in devices]
            if not devs:
                raise ValueError("BatchPOA: devices is an empty list")
        self.device = devs[0]
        self.pipeline = pipeline
        on_card = Counter(d for d in devs if d.type == "cuda")
        self._shards = [_Shard(d, torch.cuda.Stream(d)
                               if devices is not None and d.type == "cuda"
                               else None, on_card.get(d, 1), i)
                        for i, d in enumerate(devs)]
        self.shards = [{"device": str(d), "instances": 0, "busy_s": 0.0,
                        "launched_s": 0.0} for d in devs]
        # during a run (_entry_run): per entry its device phases and the
        # host clock at the end of its last enqueue
        self._phases = self._ends = None
        # per pipeline shard of the last round-path or seeded run: its
        # instances, its rounds and its launches by kernel (one entry in
        # lockstep)
        self.pipeline_shards = []
        self._lane_sets = {}
        self.dp_cells = 0          # DP cells computed on the device
        self.dp_intervals = []     # (t0, t1) per device phase
        self.clock = _EventClock()  # places event-timed phases
        self.fallbacks = 0         # instances rebuilt on the oracle
        self.replayed_native = 0   # loop reads fused by replay_loop
        self.replayed_python = 0   # loop reads fused one at a time
        self.rounds = 0
        self.windows = 0           # seeded windows aligned on the device
        self.empty_windows = 0     # seeded windows with no bases (no DP)
        self.used_device_loop = False
        self.launches = {"band_dp_topo": 0, "fw_dp": 0,  # round-path plan
                         "tile_dp": 0}
        self.precompute_cons = False   # consensus inside the replay pool
        self.s16_cap = None        # forced step-stream fetch cap (tests:
        #                            exercises the over-cap refetch)
        # per lane: the pinned buffer its band launches stage their inputs
        # in and fetch their results to, and the event of its last launch
        self._staging = {}
        self._weights = None       # per-instance per-read qv weights
        self._rid0 = []
        self._lock = threading.Lock()

    def _stage_buffer(self, sh, nbytes):
        """Lane `sh`'s staging buffer of at least nbytes (pinned on the
        card's path), once the lane's last launch is done (its fetched
        arrays are read before the lane launches again)."""
        if sh.dev.type != "cuda":
            return torch.empty(nbytes, dtype=torch.uint8)
        buf, ev = self._staging.get(sh, (None, None))
        if ev is not None:
            ev.synchronize()
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 2 * buf.numel() if buf is not None else 0)
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        return buf

    def _lanes(self, n_shards):
        """The device entries of each of `n_shards` pipeline shards. One
        shard runs on the device list itself; with more, every shard has
        a stream of its own on each entry, and a launch's plane budget is
        divided among the launches that may share a card at once."""
        if n_shards == 1:
            return [self._shards]
        if n_shards not in self._lane_sets:
            self._lane_sets[n_shards] = [
                [_Shard(sh.dev, torch.cuda.Stream(sh.dev)
                        if sh.dev.type == "cuda" else None,
                        sh.in_flight * n_shards, sh.entry)
                 for sh in self._shards]
                for _ in range(n_shards)]
        return self._lane_sets[n_shards]

    @contextlib.contextmanager
    def _entry_run(self):
        """Record a run's device phases and last enqueue per entry, then
        add its busy time and launch skew to ``shards``."""
        t0 = time.perf_counter()
        self._phases = [[] for _ in self._shards]
        self._ends = [None] * len(self._shards)
        yield
        for rec, iv, end in zip(self.shards, self._phases, self._ends):
            rec["busy_s"] += _union_s(iv)
            if end is not None:
                rec["launched_s"] += end - t0

    def _enqueued(self, sh):
        """Lane `sh` has enqueued a launch and its fetch."""
        self._ends[sh.entry] = time.perf_counter()

    def _device_phase(self, sh, interval):
        """A launch's device phase on lane `sh`, (t0, t1) on the host
        clock."""
        self.dp_intervals.append(interval)
        self._phases[sh.entry].append(interval)

    def _pipeline_records(self, members):
        self.pipeline_shards = [
            {"instances": len(m), "rounds": 0,
             "launches": dict.fromkeys(self.launches, 0)} for m in members]
        return self.pipeline_shards

    def _amb_flagged(self, ab, q, score: int) -> bool:
        """Ambiguous-strand retry threshold (ref abpoa_align.c:315)."""
        thres = (min(len(q), ab.graph.node_n - 2)
                 * self.params.max_mat * .3333)
        return score < thres

    def _weight(self, k, r, q):
        """Per-base fusion weights of instance k's read r: its qv weights
        when given (ref abpoa_msa src/abpoa_align.c:373-437), else unit."""
        if self._weights is not None and self._weights[k] is not None:
            return self._weights[k][r]
        return [1] * len(q)

    def _rid(self, k, r) -> int:
        """Global read id: instance k's existing reads (incremental
        restore) come first, new reads number after them."""
        return self._rid0[k] + r

    def _loop_eligible(self, instances):
        """The device loop's LoopConfig for this batch, or None."""
        p = self.params
        if (p.align_mode != GLOBAL_MODE or p.wb < 0 or p.rev_cigar
                or p.m != 5 or any(r0 != 0 for r0 in self._rid0)):
            return None
        wmax = None
        if self._weights is not None:
            # qv weights: the device keeps the true edge weights (the
            # heaviest-edge chase of max_remain moves the band), so bound
            # any edge's weight by the per-instance sum of the per-read
            # weight maxima
            ws = [[self._weight(k, r, q) for r, q in enumerate(reads)]
                  for k, reads in enumerate(instances)]
            if any(len(w) == 0 for wk in ws for w in wk):
                return None
            wmax = max((sum(max(w) for w in wk) for wk in ws if wk),
                       default=0)
            if wmax < 0:
                return None
        return _loop_geometry(p, instances, wmax)

    def run(self, instances, weights=None, init=None) -> list[ABPOA]:
        """Batched POA of `instances`; weights: per instance, per read,
        the per-base qv weights (None: unit weights)."""
        with trace.root("abpoa.batch", len(instances)):
            self._weights = weights
            abs_, self._rid0 = _make_aligners(instances, self.params, init)
            cfg = self._loop_eligible(instances)
            if cfg is not None:
                _DeviceLoop(self, abs_, instances, cfg).run()
            else:
                _Rounds(self, abs_, instances).run()
        return abs_

    def run_seeded(self, instances, weights=None, init=None) -> list[ABPOA]:
        """Batched seeded/progressive POA (-S/-p, ref abpoa_anchor_poa
        src/abpoa_align.c:192-299): each instance drives the serial
        path's own request generator (``ABPOA.anchor_poa_requests``), and
        every round of windows runs on the device across instances."""
        with trace.root("abpoa.batch", len(instances)):
            self._weights = weights
            abs_, self._rid0 = _make_aligners(instances, self.params, init)
            _Windows(self, abs_, instances).run()
        return abs_

    def dp_busy_seconds(self) -> float:
        """Seconds the device was busy: the union length of
        ``dp_intervals``."""
        return _union_s(self.dp_intervals)

    def run_consensus(self, instances, weights=None, seeded=False):
        """Batched POA (seeded: ``run_seeded``) then consensus per
        instance; returns the list of consensus strings per instance
        (heaviest bundling)."""
        from ..consensus import generate_consensus
        from ..alphabet import decode_table
        tab = decode_table(self.params.m)

        def cons_one(ab):
            generate_consensus(ab, self.params)
            c = ab.cons
            return [bytes(tab[b] for b in seq).decode()
                    for seq in c.cons_base[:c.n_cons]]
        with trace.root("abpoa.batch", len(instances)):
            self.precompute_cons = True
            abs_ = (self.run_seeded(instances, weights=weights) if seeded
                    else self.run(instances, weights=weights))
            with trace.span("abpoa.consensus", len(abs_)):
                return list(_host_pool().map(cons_one, abs_))


def batch_msa_from_files(params, fns, out, device="cuda", pipeline=True):
    """Batched CLI list mode (-l): one POA instance per input file, outputs
    rendered in file order, byte-identical to running abpoa_msa1 serially
    per file (ref src/abpoa_align.c:439-503). Incremental graphs (-i):
    every instance restores the same initial graph before its reads
    fuse. pipeline: BatchPOA's. Returns the BatchPOA that ran (its
    counters), or None when no file had a record."""
    with trace.root("abpoa.batch", len(fns)):
        return _batch_msa(params, fns, out, device, pipeline)


def _batch_msa(params, fns, out, device, pipeline):
    from ..seqio import read_seqs
    from ..alphabet import encode_table
    tab = encode_table(params.m)
    instances = []
    names = []
    # qv weights (-Q): ord(qual) - 32 per base, unit for a record without
    # qualities (ref abpoa.c:135-138)
    weights = [] if params.use_qv else None
    for fn in fns:
        recs = read_seqs(fn)
        if not recs:
            # serial parity: an empty input file produces no output
            continue
        names.append([r.name for r in recs])
        instances.append([tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
                          for r in recs])
        if weights is not None:
            weights.append([[ord(c) - 32 for c in r.qual] if r.qual
                            else [1] * len(r.seq) for r in recs])
    if not instances:
        return None
    init = None
    if params.incr_fn:
        from ..gfa import restore_graph

        def init(ab):
            restore_graph(ab, params)
    bp = BatchPOA(params, device, pipeline=pipeline)
    # -S/-p in global mode: seeded window rounds (ref abpoa_msa)
    seeded = (not (params.disable_seeding and not params.progressive_poa)
              and params.align_mode == GLOBAL_MODE)
    run = bp.run_seeded if seeded else bp.run
    abs_ = run(instances, weights=weights, init=init)
    for ab, nm in zip(abs_, names):
        # restored reads (incremental) keep their names; new reads take
        # the input file's record names
        ab.names = list(ab.names[:ab.n_seq - len(nm)]) + nm
        ab.output(params, out)
    return bp


def _pipeline(n_shards, prepare, finish):
    """The host/device schedule of the JAX package's ``_run_pipelined``
    (and of its two seeded groups): every idle shard with rounds left is
    prepared and launched (``prepare(s)``: the shard's next round with
    its launch half done, or None when it has no round left); then the
    oldest shard in flight is collected and fused (``finish(s,
    pending)``) and its slot freed. One shard is lockstep: each round is
    launched, then collected at once."""
    pending = [None] * n_shards
    done = [False] * n_shards
    fifo = collections.deque()
    while True:
        for s in range(n_shards):
            if pending[s] is None and not done[s]:
                pending[s] = prepare(s)
                if pending[s] is None:
                    done[s] = True
                else:
                    fifo.append(s)
        if not fifo:
            return
        s = fifo.popleft()
        finish(s, pending[s])
        pending[s] = None


class _Job:
    """The device work of one round (or window round) of one pipeline
    shard: the DP + walk of each score-width group, split over the
    shard's device entries (``lanes``) and chunked by their memory
    budgets.

    Constructing a job is the launch half: the first group's plan
    (kernel, geometry, fetch cap) is decided under the smallest budget
    of the lanes' cards, the group splits into one contiguous share per
    lane, and the first wave (one chunk of every lane) is launched, its
    results copied to pinned host memory behind an event on each lane's
    stream; nothing waits. ``collect`` is the collect half: it waits on
    each launch's event and yields what the fusion reads (misc, the
    capped step words, for seeded windows the band state of each
    window's rows), then launches the next wave or group. Each launch
    handle keeps its inputs and outputs until its wave has been
    collected. A group planned "oracle" (one instance's planes over the
    budget) launches nothing: collect yields its instances flagged
    M_OVFL, which the fusion sends to the oracle and counts in
    ``fallbacks``. The int64 words are fetched, not the band kernel's int16
    delta stream: at 64 instances the words' copy took 0.19 ms and the
    stream's copy and host decode 2.91 ms (chip_smoke.py phase 3f,
    NVIDIA H100 80GB HBM3, 700.00 W).

    A launch's device phase (upload, kernel, fetch) is on a card the
    device time between an event before the upload and the fetch's
    event, placed on the host clock by ``BatchPOA.clock``; on the CPU
    the host clock from before the upload to the end of the plain
    version. Either way the interval does not grow while the host fuses
    another shard."""

    def __init__(self, bp, lanes, groups, r, rec, seeded=False):
        self.bp, self.lanes, self.r = bp, lanes, r
        self.rec, self.seeded = rec, seeded
        self.groups = iter(groups)     # (instances, exports) per pn
        self.waves = iter(())
        self.handles = self._launch_next()

    def _plan(self, group, dgs):
        bp = self.bp
        budgets = [plane_budget(sh.dev, sh.in_flight) for sh in self.lanes]
        with trace.span("abpoa.export", len(dgs)):
            plan = round_plan(bp.params, dgs, self.lanes[0].dev, self.seeded,
                              budget=min(budgets))
        self.step_cap = plan.step_cap
        if bp.s16_cap is not None:
            self.step_cap = max(2, min(self.step_cap, int(bp.s16_cap)))
        self.plan, self.group, self.dgs = plan, group, dgs
        if plan.kernel is None:
            self.waves = iter(())
            return
        shares = []
        for i, sh in enumerate(self.lanes):
            lo, hi = shard_bounds(len(dgs), len(self.lanes), i)
            bp.shards[i]["instances"] += hi - lo
            chunk = budgets[i] // plan.per
            shares.append([(sh, slice(c0, min(c0 + chunk, hi)))
                           for c0 in range(lo, hi, chunk)])
        self.waves = itertools.zip_longest(*shares)

    def _launch_next(self):
        wave = next(self.waves, None)
        if wave is None:
            nxt = next(self.groups, None)
            if nxt is None:
                return []
            self._plan(*nxt)
            if self.plan.kernel is None:
                return [dict(group=self.group, oracle=True)]
            wave = next(self.waves)
        return [self._launch(sh, part) for sh, part in filter(None, wave)]

    def _launch(self, sh, part):
        if self.plan.band:
            return self._launch_band(sh, part)
        with trace.span("abpoa.dispatch", part.stop - part.start):
            bp, plan = self.bp, self.plan
            t0 = time.perf_counter()
            start = None
            with _on(sh):
                if sh.dev.type == "cuda":
                    start = bp.clock.mark(sh.dev)
                inputs = plan.stack(part, sh.dev)
                out = plan.kernel(plan.cfg, *inputs)
                fetch = [out.misc, out.steps[:, :self.step_cap]]
                if self.seeded:
                    nmax = max(d.n_rows for d in self.dgs[part])
                    fetch += [out.mpl[:, :nmax], out.mpr[:, :nmax]]
            bp.launches[plan.name] += 1
            self.rec["launches"][plan.name] += 1
            host, ev = _enqueue_fetch(sh, fetch)
            bp._enqueued(sh)
            return dict(shard=sh, group=self.group[part], host=host, ev=ev,
                        start=start, t0=t0, t_done=time.perf_counter(),
                        out=out, inputs=inputs)

    def _launch_band(self, sh, part):
        """A band plan's launch: the export columns of instances `part`
        written into the lane's pinned buffer in the staged layout
        (``band_dp.TopoStage``), one upload, the prologue and B3
        (``band_dp.band_poa_dp_staged``), then one call that enqueues the
        fetch of misc, the capped step words and, for windows, the packed
        band state into the same buffer past the staged bytes
        (``band_dp.fetch_topo``), and the launch's event."""
        with trace.span("abpoa.dispatch", part.stop - part.start):
            bp, plan = self.bp, self.plan
            t0 = time.perf_counter()
            start = ev = None
            arrs = plan.arrs[part]
            nmax = (max(d.n_rows for d in self.dgs[part]) if self.seeded
                    else 0)
            st = band_dp.topo_stage(plan.cfg, len(arrs),
                                    arrs[0][2].dtype == np.uint8)
            at = (st.nbytes + 7) // 8 * 8
            with _on(sh):
                if sh.dev.type == "cuda":
                    start = bp.clock.mark(sh.dev)
                staged = bp._stage_buffer(sh, at + band_dp.fetch_bytes(
                    len(arrs), self.step_cap, nmax))
                band_dp.stage_topo(plan.cfg, st, arrs, staged.numpy())
                out = band_dp.band_poa_dp_staged(plan.cfg, st, staged,
                                                 sh.dev)
                host = band_dp.fetch_topo(out, self.step_cap, nmax, staged,
                                          at)
                if sh.dev.type == "cuda":
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(torch.cuda.current_stream(sh.dev))
                    bp._staging[sh] = (staged, ev)
            bp._enqueued(sh)
            bp.launches[plan.name] += 1
            self.rec["launches"][plan.name] += 1
            return dict(shard=sh, group=self.group[part], host=host, ev=ev,
                        start=start, t0=t0, t_done=time.perf_counter(),
                        out=out, inputs=staged, band=True)

    def collect(self):
        while self.handles:
            for h in self.handles:
                yield self._fetched(h)
            self.handles = []          # free the wave before the next plan
            self.handles = self._launch_next()

    def _fetched(self, h):
        bp = self.bp
        if h.get("oracle"):
            # no launch: each instance comes back with the capacity flag
            # M_OVFL, which sends it to the oracle
            n = len(h["group"])
            misc = np.zeros((n, L.M_NMISC), np.int32)
            misc[:, L.M_OVFL] = 1
            empty = np.zeros((n, 0), np.int64)
            return dict(group=h["group"], r=self.r, misc=misc, steps=empty,
                        steps_dev=None, shard=None, mpl=empty, mpr=empty)
        band = h.get("band", False)
        with trace.span("abpoa.wait"):
            if h["ev"] is not None:
                h["ev"].synchronize()
            host = h["host"] if band else [x.numpy() for x in h["host"]]
        if h["ev"] is not None:
            t0, t1 = bp.clock.interval(h["shard"].dev, h["start"], h["ev"])
        else:
            t0, t1 = h["t0"], h["t_done"]
        pend = dict(group=h["group"], r=self.r, misc=host[0], steps=host[1],
                    steps_dev=h["out"].steps, shard=h["shard"])
        if self.seeded and band:
            # the band kernel's packed state, mpl | mpr<<16
            pend["mpl"], pend["mpr"] = host[2] & L.H16, host[2] >> 16
        elif self.seeded:
            pend["mpl"], pend["mpr"] = host[2], host[3]
        bp._device_phase(h["shard"], (t0, t1))
        bp.dp_cells += int(host[0][:, L.M_CELLS].sum())
        return pend


class _Rounds:
    """One batched round-based execution: per round, host sort + export,
    one DP kernel launch per score-width group (and memory chunk), host
    fusion of the step streams."""

    def __init__(self, bp: BatchPOA, abs_, instances):
        self.bp = bp
        self.abs_ = abs_
        self.instances = instances

    def run(self):
        """The rounds of every instance. From 4 instances on (pipeline
        on) the instances split round-robin into S = min(N_SHARDS, n //
        4) shards, each with its own round counter, and ``_pipeline``
        overlaps one shard's host work with the others' device rounds;
        every prepared shard round counts in ``rounds``, as in the JAX
        package. Else one shard in lockstep, where a round with no DP
        (read 0 only) is not counted."""
        bp, instances = self.bp, self.instances
        n = len(instances)
        pipelined = bp.pipeline and n >= 4
        S = min(bp.N_SHARDS, max(1, n // 4)) if pipelined else 1
        members = [list(range(s, n, S)) for s in range(S)]
        lanes = bp._lanes(S)
        recs = bp._pipeline_records(members)
        n_rounds = [max((len(instances[k]) for k in m), default=0)
                    for m in members]
        next_r = [0] * S

        def prepare(s):
            if next_r[s] >= n_rounds[s]:
                return None
            next_r[s] += 1
            return self._prepare(members[s], next_r[s] - 1, lanes[s],
                                 recs[s], pipelined)

        def finish(_s, job):
            for pend in job.collect():
                self._collect(pend)
        with bp._entry_run():
            _pipeline(S, prepare, finish)

    def _prepare(self, members, r, lanes, rec, count_empty):
        """Round r of one shard's instances, up to its launch: read-0
        fusion, then sort + export on the host pool, a re-pad to this
        shard's R/W/P/O maxima and one plan per score-width group."""
        bp, params = self.bp, self.bp.params
        abs_, instances = self.abs_, self.instances
        todo = []
        for k in members:
            if r >= len(instances[k]):
                continue
            ab, q = abs_[k], instances[k][r]
            # first read / empty graph: straight fusion, no DP
            if ab.graph.node_n <= 2:
                ab.graph.add_graph_alignment(params, q, bp._weight(k, r, q),
                                             [], None, bp._rid(k, r), True)
            else:
                todo.append(k)
        if todo or count_empty:
            bp.rounds += 1
            rec["rounds"] += 1
        groups = []
        if todo:
            # two-pass export: natural buckets, then re-pad to shard max
            from ..align.export import export_dense

            def sort(k):
                g = abs_[k].graph
                if not g.is_topological_sorted:
                    g.topological_sort(params)

            def export(k):
                return export_dense(abs_[k].graph, params, instances[k][r])
            with trace.span("abpoa.sort", len(todo)):
                list(_host_pool().map(sort, todo))
            with trace.span("abpoa.export", len(todo)):
                nat = dict(zip(todo, _host_pool().map(export, todo)))
                R = max(d.R for d in nat.values())
                W = max(d.W for d in nat.values())
                P_ = max(d.P for d in nat.values())
                O_ = max(d.O for d in nat.values())
                for pn in sorted({d.pn for d in nat.values()}):
                    group = [k for k in todo if nat[k].pn == pn]
                    groups.append((group, [repad_dense(nat[k], R, W, P_, O_)
                                           for k in group]))
        return _Job(bp, lanes, groups, r, rec)

    def _collect(self, pend):
        """Fuse a launch's results into the host graphs (per instance, on
        the host pool): the native step fusion, or the step replay into a
        cigar for rev_cigar or a non-native graph store; amb_strand
        candidates and unusable device results go through the oracle."""
        from ..align.engine_np import AlignResult, align_sequence_to_subgraph
        from ..graph import NativeGraph
        bp, params = self.bp, self.bp.params
        abs_, instances = self.abs_, self.instances
        misc, steps, r = pend["misc"], pend["steps"], pend["r"]

        def fuse_one(b_k):
            b, k = b_k
            ab = abs_[k]
            q = instances[k][r]
            w = bp._weight(k, r, q)
            rid = bp._rid(k, r)
            mi = misc[b]
            bad = bool(mi[L.M_OVFL] or mi[L.M_FAIL])
            nst = int(mi[L.M_NSTEPS])

            def step_stream():
                # deferred past the early-outs that never read the steps
                return _step_stream(pend, steps, b, nst)
            if params.amb_strand and (
                    bad or bp._amb_flagged(ab, q, int(mi[L.M_BEST]))):
                # rc-retry candidate: the sequential fwd+rc body (the
                # device fwd equals its fwd), ref abpoa_align.c:315
                ab.poa_one(bp.host_params, q, w, rid)
                return
            if bad:
                with bp._lock:
                    bp.fallbacks += 1
                res = align_sequence_to_subgraph(
                    ab.graph, params, SRC_NODE_ID, SINK_NODE_ID, q,
                    arena=ab.arena)
            elif isinstance(ab.graph, NativeGraph) and not params.rev_cigar:
                ab.graph.fuse_steps(params, 0, step_stream(), nst,
                                    int(mi[L.M_BJ]), int(mi[L.M_ENDJ]), q,
                                    rid, True, weight=w)
                return
            else:
                res = AlignResult()
                res.best_score = int(mi[L.M_BEST])
                replay_steps(ab.graph, params, np.asarray(q), step_stream(),
                             nst, int(mi[L.M_BI]), int(mi[L.M_BJ]),
                             int(mi[L.M_ENDI]), int(mi[L.M_ENDJ]), res)
            ab.graph.add_graph_alignment(params, q, w, res.cigar, None, rid,
                                         True)

        # each instance mutates its own graph; the hot path is one C call
        with trace.span("abpoa.fuse", len(pend["group"])):
            list(_host_pool().map(fuse_one, enumerate(pend["group"])))


class _Windows:
    """One batched seeded execution: per instance the guide-tree
    partition and its request generator; per round, every instance's
    pending window exported (subgraph + row mask) and aligned by one
    kernel launch per score-width group and memory chunk, then each
    generator advanced with its window's result."""

    def __init__(self, bp: BatchPOA, abs_, instances):
        self.bp = bp
        self.abs_ = abs_
        self.instances = instances
        self.gens = []

    def _start(self, k):
        """Seeding, guide tree and chaining of instance k (host); returns
        (its request generator, the first request or None)."""
        from ..seed import build_guide_tree_partition
        bp, params = self.bp, self.bp.params
        reads = self.instances[k]
        seq_lens = [len(q) for q in reads]
        ws = [bp._weight(k, r, q) for r, q in enumerate(reads)]
        rmap, par_anchors, par_c = build_guide_tree_partition(
            reads, seq_lens, params)
        gen = self.abs_[k].anchor_poa_requests(
            params, reads, ws, seq_lens, par_anchors, par_c, rmap,
            bp._rid0[k])
        return gen, next(gen, None)

    def _export(self, k, req):
        """The device export of instance k's window, or None when the
        window has no DP on the device (an empty graph, or no bases)."""
        from ..align.export import export_dense
        params = self.bp.params
        beg_id, end_id, window = req
        g = self.abs_[k].graph
        if g.node_n <= 2 or len(window) == 0:
            return None
        if not g.is_topological_sorted:
            with trace.span("abpoa.sort", 1):
                g.topological_sort(params)
        bi = int(g.node_id_to_index[beg_id])
        ei = int(g.node_id_to_index[end_id])
        return export_dense(g, params, window, beg_index=bi, end_index=ei)

    def _oracle(self, k, req):
        """Instance k's window on the host oracle (None on an empty
        graph: the first read fuses with no alignment)."""
        from ..align.engine_np import align_sequence_to_subgraph
        beg_id, end_id, window = req
        ab = self.abs_[k]
        if ab.graph.node_n <= 2:
            return None
        if not ab.graph.is_topological_sorted:
            ab.graph.topological_sort(self.bp.params)
        return align_sequence_to_subgraph(ab.graph, self.bp.host_params,
                                          beg_id, end_id, window,
                                          arena=ab.arena)

    def run(self):
        """Window rounds until every generator is done. From 8 instances
        on (pipeline on) two groups, instance k in group k % 2, take
        turns through ``_pipeline``: while one group's window round is
        on the device, the other's results are applied, its generators
        advance and its next windows are exported. The host work runs on
        the calling thread: it is short Python and numpy steps per
        window, which a thread pool only serialises on the GIL (3-4x
        slower per window, measured)."""
        bp = self.bp
        n = len(self.instances)
        S = 2 if bp.pipeline and n >= 8 else 1
        members = [[k for k in range(n) if k % S == s] for s in range(S)]
        with trace.span("abpoa.seed", n):
            started = [self._start(k) for k in range(n)]
        self.gens = [gen for gen, _ in started]
        reqs = [{k: started[k][1] for k in m if started[k][1] is not None}
                for m in members]
        lanes = bp._lanes(S)
        recs = bp._pipeline_records(members)

        def prepare(s):
            return self._prepare(reqs[s], lanes[s], recs[s]) if reqs[s] \
                else None

        def finish(s, state):
            reqs[s] = self._finish(reqs[s], *state)
        with bp._entry_run():
            _pipeline(S, prepare, finish)

    def _prepare(self, reqs, lanes, rec):
        """One group's window round up to its launch: each pending
        window exported (subgraph + row mask), re-padded to the round's
        maxima, one plan per score-width group. Returns (instances,
        exports, host-only instances, job)."""
        bp = self.bp
        todo = sorted(reqs)
        groups = []
        with trace.span("abpoa.export", len(todo)):
            dgs = {k: self._export(k, reqs[k]) for k in todo}
            host_only = [k for k in todo if dgs[k] is None]
            live = [k for k in todo if dgs[k] is not None]
            if live:
                R = max(dgs[k].R for k in live)
                W = max(dgs[k].W for k in live)
                P_ = max(dgs[k].P for k in live)
                O_ = max(dgs[k].O for k in live)
                for pn in sorted({dgs[k].pn for k in live}):
                    group = [k for k in live if dgs[k].pn == pn]
                    groups.append((group, [repad_dense(dgs[k], R, W, P_, O_)
                                           for k in group]))
        # an empty window has no DP: the oracle, as in the JAX package
        # (an empty graph aligns nothing)
        bp.empty_windows += sum(self.abs_[k].graph.node_n > 2
                                for k in host_only)
        bp.windows += len(live)
        job = _Job(bp, lanes, groups, rec["rounds"], rec, seeded=True)
        bp.rounds += 1
        rec["rounds"] += 1
        return todo, dgs, host_only, job

    def _finish(self, reqs, todo, dgs, host_only, job):
        """Collect one group's window round: the oracle for its
        host-only windows, the device results applied, each generator
        advanced. Returns the group's next requests."""
        results = {k: self._oracle(k, reqs[k]) for k in host_only}
        for pend in job.collect():
            with trace.span("abpoa.replay", len(pend["group"])):
                results.update(self._apply(pend, reqs, dgs))
        with trace.span("abpoa.advance", len(todo)):
            return {k: req for k in todo
                    if (req := self._advance(k, results[k])) is not None}

    def _advance(self, k, result):
        """Send instance k's window result to its generator (which fuses
        the read once its last window is in); its next request or None."""
        try:
            return self.gens[k].send(result)
        except StopIteration:
            return None

    def _apply(self, pend, reqs, dgs):
        """One launch's window results: the band state written back for
        each window's live rows and the steps replayed into its cigar; a
        band overflow or walk dead end goes to the oracle (counted in
        fallbacks). Returns {instance: AlignResult}."""
        from ..align.engine_np import AlignResult
        bp, params = self.bp, self.bp.params
        misc, steps = pend["misc"], pend["steps"]
        results = {}
        for b, k in enumerate(pend["group"]):
            mi = misc[b]
            if mi[L.M_FAIL] or mi[L.M_OVFL]:
                # re-runs from the pre-call band state: nothing was
                # written back for this window
                bp.fallbacks += 1
                results[k] = self._oracle(k, reqs[k])
                continue
            g = self.abs_[k].graph
            dg = dgs[k]
            n, bi = dg.n_rows, dg.beg_index
            if params.wb >= 0:
                live = dg.rowmask[:n] > 0
                ids = np.asarray(g.index_to_node_id[bi:bi + n],
                                 dtype=np.int64)[live]
                g.node_id_to_max_pos_left[ids] = pend["mpl"][b, :n][live]
                g.node_id_to_max_pos_right[ids] = pend["mpr"][b, :n][live]
            res = AlignResult()
            res.best_score = int(mi[L.M_BEST])
            nst = int(mi[L.M_NSTEPS])
            stp = _step_stream(pend, steps, b, nst)
            results[k] = replay_steps(
                g, params, np.asarray(reqs[k][2]), stp, nst, int(mi[L.M_BI]),
                int(mi[L.M_BJ]), int(mi[L.M_ENDI]), int(mi[L.M_ENDJ]), res,
                row0=bi)
        return results


class _DeviceLoop:
    """One batched device-loop execution (state build, loop, replay)."""

    def __init__(self, bp: BatchPOA, abs_, instances, cfg):
        self.bp = bp
        self.abs_ = abs_
        self.instances = instances
        self.cfg = cfg

    def _launch(self, shard, part):
        """Build one sub-batch's inputs on the shard's device and stream,
        enqueue its loop and the copies of its results to pinned host
        memory there, with an event recorded on that stream after them
        and a timing event (``BatchPOA.clock``) before its upload.
        Returns the pending handle, which
        holds the inputs until the event has completed, so no input's
        memory goes back to the caching allocator while the loop may
        still read it."""
        bp, params = self.bp, self.bp.params
        dev = shard.dev
        cfg = self.cfg._replace(B=len(part))
        graphs = [self.abs_[k].graph for k in part]
        with trace.span("abpoa.export", len(part)):
            st, i2n, n2i, remain = pl.init_state_np(graphs, cfg)
            qc = np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int8)
            ql = np.zeros((cfg.NR, cfg.B), np.int32)
            # wmode 1: the per-base weight stream, 0-based (ref weight[q])
            qw = (np.zeros((cfg.NR, cfg.B, cfg.Wq), np.int32)
                  if cfg.wmode else None)
            for b, k in enumerate(part):
                for r, q in enumerate(self.instances[k][1:]):
                    qc[r, b, 1:len(q) + 1] = q
                    ql[r, b] = len(q)
                    if cfg.wmode:
                        qw[r, b, :len(q)] = bp._weight(k, r + 1, q)
        maxlen = int(ql.max())
        cap = min(cfg.LS, (maxlen + max(96, maxlen // 4) + 63) // 64 * 64)
        if bp.s16_cap is not None:
            cap = max(2, min(cap, int(bp.s16_cap)))

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                dev, non_blocking=True)
        start = None
        with trace.span("abpoa.dispatch", len(part)):
            with _on(shard):
                if dev.type == "cuda":
                    start = bp.clock.mark(dev)
                inputs = [pl.GState(*(put(x) for x in st))] + [
                    put(x) for x in (i2n, n2i, remain, qc, ql,
                                     pl.make_scal_base(params, cfg))]
                qw_d = put(qw) if cfg.wmode else None
                psF, misc_d, s16_d = pl.poa_device_loop(
                    cfg, *inputs, int(params.wb),
                    int(round(params.wf * 1000)), qw_rounds=qw_d)
                s16_cap_d = s16_d[:, :, :cap // 2].contiguous()
            # the copies run on the shard's stream right after this
            # part's last kernel, so the host waits for this part alone
            host, ev = _enqueue_fetch(shard, (misc_d, s16_cap_d, psF.fail))
        bp._enqueued(shard)
        return part, cfg, host, (start, ev), s16_d, (inputs, qw_d)

    def run(self):
        bp, params = self.bp, self.bp.params
        abs_, instances = self.abs_, self.instances
        for k, (ab, reads) in enumerate(zip(abs_, instances)):
            if reads:
                ab.graph.add_graph_alignment(params, reads[0],
                                             bp._weight(k, 0, reads[0]), [],
                                             None, 0, True)
                ab.graph.topological_sort(params)
        live = [k for k, reads in enumerate(instances) if len(reads) >= 2]
        # one contiguous shard of the live instances per device entry;
        # two sub-batches within a shard pipeline its loop against the
        # host replay
        parts = []
        for i, shard in enumerate(bp._shards):
            lo, hi = shard_bounds(len(live), len(bp._shards), i)
            mine = live[lo:hi]
            bp.shards[i]["instances"] += len(mine)
            if len(mine) >= SPLIT_MIN:
                mid = (len(mine) + 1) // 2
                parts += [(shard, mine[:mid]), (shard, mine[mid:])]
            elif mine:
                parts.append((shard, mine))
        bp.used_device_loop = True
        bp.rounds += self.cfg.NR
        # dp_intervals: on a card the event-timed device phase of each
        # sub-batch (BatchPOA.clock); on the CPU, where a sub-batch's
        # loop runs in its launch, the host clock from the previous fetch
        # (or the launches) to its own
        with bp._entry_run():
            t_prev = time.perf_counter()
            pends = [(shard, self._launch(shard, part))
                     for shard, part in parts]
            for shard, (part, cfg, host, (start, ev), s16_d, _inputs) in pends:
                with trace.span("abpoa.wait"):
                    if ev is not None:
                        ev.synchronize()
                    misc, s16w, failv = (h.numpy() for h in host)
                s16 = s16w.view(np.int16)
                t1 = time.perf_counter()
                bp._device_phase(shard, (t_prev, t1) if ev is None
                                 else bp.clock.interval(shard.dev, start, ev))
                t_prev = t1
                ok_mask = failv == 0
                bp.fallbacks += int((~ok_mask).sum())
                for b, k in enumerate(part):
                    if ok_mask[b]:
                        nr_k = len(instances[k]) - 1
                        bp.dp_cells += int(misc[:nr_k, b, L.M_CELLS].sum())
                with trace.span("abpoa.fuse",
                                sum(len(instances[k]) - 1 for k in part)):
                    self._replay(part, misc, s16, s16_d, ok_mask)
        return True

    def _replay(self, live, misc, s16, s16_d, ok_mask):
        """Rebuild the graphs of a sub-batch's instances from their rounds
        on the host pool. On the native store one call an instance fuses
        its rounds with the GIL released (NativeGraph.replay_loop); a
        stream past the fetch cap is refetched and fused by a call of its
        own. An amb_strand retry, and every round on the pure-Python
        store, takes the per-read route. An instance that failed on the
        device is rebuilt on the oracle."""
        bp, params = self.bp, self.bp.params
        abs_, instances = self.abs_, self.instances
        from ..graph import NativeGraph
        meta = np.ascontiguousarray(
            misc[:, :, (L.M_NSTEPS, L.M_BI, L.M_BJ, L.M_ENDJ, L.M_BEST)]
            .transpose(1, 0, 2), dtype=np.int32)

        def replay_one(b_k):
            b, k = b_k
            ab = abs_[k]
            reads = instances[k]
            n_native = n_python = 0
            if not ok_mask[b]:
                # sticky device failure: rebuild on the bit-exact oracle
                ab.graph.reset()
                for r, q in enumerate(reads):
                    ab.poa_one(bp.host_params, q, bp._weight(k, r, q), r)
            else:
                g = ab.graph
                native = isinstance(g, NativeGraph)
                weights = bp._weights[k] if bp._weights is not None else None
                r, nr = 0, len(reads) - 1
                while r < nr:
                    if native:
                        r1 = g.replay_loop(params, meta[b], s16[r:, b],
                                           reads, weights, r)
                        n_native += r1 - r
                        r = r1
                        if r == nr:
                            break
                    q = reads[r + 1]
                    mi = misc[r, b]
                    if params.amb_strand and bp._amb_flagged(
                            ab, q, int(mi[L.M_BEST])):
                        # ambiguous-strand retry (ref abpoa_align.c:315):
                        # the device ran fw-only, so from the first flagged
                        # round the sequential fwd+rc body finishes
                        for rr in range(r + 1, len(reads)):
                            ab.poa_one(bp.host_params, reads[rr],
                                       bp._weight(k, rr, reads[rr]), rr)
                        n_python += nr - r
                        break
                    nst = int(mi[L.M_NSTEPS])
                    if nst > s16.shape[2]:   # over the fetch cap: refetch
                        w = s16_d[r, b, :(nst + 1) // 2].cpu().numpy()
                        row16 = np.ascontiguousarray(w).view(np.int16)
                    else:
                        row16 = s16[r, b]
                    if native:
                        if g.replay_loop(params, meta[b], row16[None], reads,
                                         weights, r, r + 1) != r + 1:
                            raise RuntimeError(
                                "replay_loop left a refetched round")
                        n_native += 1
                    else:
                        from ..align.engine_np import AlignResult
                        words = unpack_steps16(row16, nst, int(mi[L.M_BI]),
                                               int(mi[L.M_BJ]))
                        if not g.is_topological_sorted:
                            g.topological_sort(params)
                        res = AlignResult()
                        replay_steps(g, params, np.asarray(q), words, nst,
                                     int(mi[L.M_BI]), int(mi[L.M_BJ]),
                                     int(mi[L.M_ENDI]), int(mi[L.M_ENDJ]),
                                     res)
                        g.add_graph_alignment(params, q,
                                              bp._weight(k, r + 1, q),
                                              res.cigar, None, r + 1, True)
                        n_python += 1
                    r += 1
            if bp.precompute_cons:
                from ..consensus import generate_consensus
                generate_consensus(ab, params)
            return n_native, n_python

        for fut in [_host_pool().submit(replay_one, bk)
                    for bk in enumerate(live)]:
            n_native, n_python = fut.result()
            bp.replayed_native += n_native
            bp.replayed_python += n_python
        return True
