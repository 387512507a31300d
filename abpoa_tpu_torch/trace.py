"""Phase spans of the port's host work, kept in memory.

One fixed set of phase names (every name starts with ``abpoa.``):

    abpoa.batch      root: BatchPOA.run, run_seeded, run_consensus,
                     batch_msa_from_files (n: instances)
    abpoa.cli        root: the whole body of cli.main (n: 1 a run)
    abpoa.seed       seeding, guide tree and chaining (n: instances)
    abpoa.sort       a topological sort before an export (n: graphs)
    abpoa.export     the dense DP inputs of graphs and windows (n: graphs
                     or windows)
    abpoa.dispatch   uploads, kernel enqueue, fetch enqueue (n: instances
                     or windows in the launch)
    abpoa.wait       the host blocked on a launch's results
    abpoa.replay     step words to a cigar, band state written back (n:
                     windows or reads)
    abpoa.advance    the seeded request generators' bookkeeping (n:
                     windows)
    abpoa.fuse       graph fusion (n: reads)
    abpoa.consensus  generate_consensus (n: instances)

Tracing is off by default. It is on while a ``torch.profiler`` session
records, or inside ``recording()``. Off, ``span`` and ``root`` return
one shared no-op context after a single check. On, a span appends a
record ``[name, t0_ns, t1_ns, parent, n]`` to ``BUFFER`` (times on
``time.perf_counter_ns``; ``t1_ns`` is 0 while the span is open;
``parent`` is the index in ``BUFFER.records`` of the enclosing span on
the same thread, -1 for a root), and while the profiler records it also
opens ``torch.profiler.record_function(name)``, so the span shows on the
profiler's timeline beside the kernels.

A root records only where its thread has no open span, and any other
span only inside a root on its own thread: the spans of one thread nest
in its roots, and a worker thread of the host pool records nothing.
The buffer holds at most ``CAP`` records; spans past it count in
``BUFFER.dropped``.

The spans do not say which card a phase served. Per entry of a device
list, ``BatchPOA.shards[i]`` counts it, tracing on or off: ``instances``
(the instances its launches carried), ``busy_s`` (the union of its
launches' device phases, the ``dp_intervals`` values: event-timed on a
card, the host clock on the CPU; a phase runs from a launch's upload to
its fetch, gaps in which the card waits for the host's enqueue
included) and ``launched_s`` (host seconds from
the start of the run's rounds to the end of its last enqueue, so the
spread of the entries' values is how much later the last card got its
work than the first).
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

CAP = 1 << 20

_profiler_enabled = torch.autograd._profiler_enabled
_record_function = torch.autograd.profiler.record_function
_lock = threading.Lock()
_local = threading.local()
_recording = 0       # open recording() contexts


class Buffer:
    """The records of every span since the last clear, and how many
    spans the cap left out."""

    def __init__(self):
        self.records = []
        self.dropped = 0

    def clear(self):
        self.records = []
        self.dropped = 0


BUFFER = Buffer()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "n", "rec", "fn", "stack")

    def __init__(self, name, n, stack):
        self.name, self.n, self.stack = name, n, stack
        self.fn = None

    def __enter__(self):
        rec = [self.name, 0, 0, self.stack[-1] if self.stack else -1,
               self.n]
        with _lock:
            if len(BUFFER.records) < CAP:
                idx = len(BUFFER.records)
                BUFFER.records.append(rec)
            else:
                BUFFER.dropped += 1
                idx = -1
        self.rec = rec
        self.stack.append(idx)
        if _profiler_enabled():
            self.fn = _record_function(self.name)
            self.fn.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        self.stack.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def span(name: str, n: int = 0):
    """A phase span inside the thread's open root; `n`: the work units
    it handles."""
    if not (_recording or _profiler_enabled()):
        return _NOOP
    st = _stack()
    return _Span(name, n, st) if st else _NOOP


def root(name: str, n: int = 0):
    """The root span of a public entry: opened only where the thread has
    no open span (an entry called from another records nothing of its
    own)."""
    if not (_recording or _profiler_enabled()):
        return _NOOP
    st = _stack()
    return _NOOP if st else _Span(name, n, st)


@contextlib.contextmanager
def recording():
    """Turn tracing on without a profiler. The outermost of nested or
    concurrent recording() contexts clears the buffer; each yields it."""
    global _recording
    with _lock:
        if _recording == 0:
            BUFFER.clear()
        _recording += 1
    try:
        yield BUFFER
    finally:
        with _lock:
            _recording -= 1


def summary(records, t0_ns=None, t1_ns=None) -> dict:
    """Per span name: ``self_ns`` (each span's duration less the time
    its child spans cover, summed), ``total_ns``, ``count`` and ``n``
    (the summed work units), over the closed records that lie wholly in
    [t0_ns, t1_ns] (all closed records by default). `records`:
    ``BUFFER.records`` or a list in its format (parents index it)."""
    lo = float("-inf") if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    picked = [i for i, r in enumerate(records)
              if r[2] and lo <= r[1] and r[2] <= hi]
    child = {}
    for i in picked:
        p = records[i][3]
        if p >= 0:
            child[p] = child.get(p, 0) + records[i][2] - records[i][1]
    out = {}
    for i in picked:
        name, t0, t1, _p, n = records[i]
        s = out.setdefault(name, {"self_ns": 0, "total_ns": 0, "count": 0,
                                  "n": 0})
        s["self_ns"] += t1 - t0 - child.get(i, 0)
        s["total_ns"] += t1 - t0
        s["count"] += 1
        s["n"] += n
    return out
