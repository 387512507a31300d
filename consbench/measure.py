"""What a measured window leaves for the metric readers
(``consbench/metrics/<name>.py``, each ``read(window) -> value or
None``): every call's host-clock times, its answers and the program's
counters, the set-up time, the reduced trace of a traced run and the DP
cells of the window's work."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Call:
    t0: float            # host clock (perf_counter) at the call's start
    t1: float            # ... and at its return
    ids: list            # the clusters submitted, (batch, index) each
    answers: list        # what the call returned, one entry a cluster
    counters: dict       # the program's counters for the call


@dataclasses.dataclass
class Window:
    calls: list
    setup_s: float
    gap_mode: int
    trace: dict | None = None    # trace.reduce's numbers (--trace 1)
    dp_cells: float | None = None  # band cells of all the window's work

    @property
    def elapsed_s(self) -> float:
        """From the first call's start to the last call's return."""
        return self.calls[-1].t1 - self.calls[0].t0

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def clusters(self) -> int:
        return sum(len(c.ids) for c in self.calls)

    def counter(self, key):
        """A counter summed over the calls, or None where no call has it."""
        vals = [c.counters[key] for c in self.calls if key in c.counters]
        return sum(vals) if vals else None


def per_cluster(w: Window, x):
    return None if x is None else x / w.clusters


def per_call(w: Window, x):
    return None if x is None else x / w.n_calls


def host_ms(w: Window):
    """Traced window time in which no operation ran on the device, ms."""
    t = w.trace
    return None if t is None else (t["window_s"] - t["busy_s"]) * 1e3


def kernel_ms(w: Window):
    return None if w.trace is None else w.trace["kernel_s"] * 1e3


def launches(w: Window):
    return None if w.trace is None else w.trace["launches"]


def idle_share(w: Window):
    t = w.trace
    return None if t is None else 1 - t["busy_s"] / t["window_s"]


def dp_roofline_pct(w: Window):
    """The least time the DP kernels' work needs on the card
    (``roofline.dp_bound_s`` of the window's band cells) as a share of
    their traced time, %. Nothing where the trace holds no DP kernel."""
    from consbench import roofline
    t = w.trace
    if t is None or not t["dp_kernel_s"] or not w.dp_cells:
        return None
    return 100 * roofline.dp_bound_s(w.dp_cells, w.gap_mode) / t["dp_kernel_s"]
