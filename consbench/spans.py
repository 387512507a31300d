"""The port's phase spans in a measured window, for the per-layer
metrics of ``--trace 1`` runs: ``abpoa_tpu_torch.trace``'s records from
the first call's start to the last call's return, summed by span name
(``trace.summary``: self time, total time, count, work units). The
profiler over the window turns the port's tracing on.

Each reader gets None, never 0, where the port has no ``trace`` module,
where the window holds no record of its span, or where the buffer's cap
dropped a span."""
from __future__ import annotations


def summary(w):
    """``trace.summary`` of the window's records, or None where the port
    has no tracer or the buffer dropped spans."""
    if not hasattr(w, "_spans"):
        try:
            from abpoa_tpu_torch import trace
        except ImportError:
            w._spans = None
        else:
            buf = trace.BUFFER
            w._spans = None if buf.dropped else trace.summary(
                buf.records, w.calls[0].t0 * 1e9, w.calls[-1].t1 * 1e9)
    return w._spans


def self_ms(w, name):
    """Self time of span `name` in the window, ms."""
    s = (summary(w) or {}).get(name)
    return None if s is None else s["self_ns"] / 1e6


def mean_n(w, name):
    """Work units a span of `name` handled, on average over the window."""
    s = (summary(w) or {}).get(name)
    return None if s is None else s["n"] / s["count"]
