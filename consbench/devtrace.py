"""Reduction of a ``torch.profiler`` trace of the measured window to the
numbers the per-layer metrics read: device busy time, kernel time and
launches, the DP kernels' time, the device operations that took most
time, and the longest idle gaps named by what the host was doing.

The window is the host span ``WINDOW``; the harness's spans around its
calls into the port (each driver's ``SPAN``) name the gaps they cover.
"""
from __future__ import annotations

import bisect

from consbench import roofline

WINDOW = "consbench.window"
HARNESS = "harness"   # a gap outside every call into the port
TOP = 10


def events(prof):
    """(name, is_device, is_annotation, start_ns, end_ns) of every event."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        ann = e.is_user_annotation() if hasattr(e, "is_user_annotation") \
            else "annotation" in str(getattr(e, "activity_type", lambda: "")())
        s = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, bool(ann),
                    s, s + e.duration_ns()))
    return out


def _union(intervals):
    """Merged, sorted intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events, spans) -> dict:
    """The trace's numbers over the window. `events` as ``events`` gives
    them; `spans`: the names of the harness's calls into the port."""
    win = [(s, e) for n, dev, ann, s, e in events
           if ann and not dev and n == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} window spans in the trace")
    w0, w1 = win[0]
    dev_ops = [(n, max(s, w0), min(e, w1)) for n, dev, ann, s, e in events
               if dev and not ann and e > s and e > w0 and s < w1]
    calls = sorted((s, e, n) for n, dev, ann, s, e in events
                   if ann and not dev and n in spans)
    busy = _union((s, e) for _n, s, e in dev_ops)
    by_name = {}
    kernel_ns = dp_ns = launches = 0
    for n, s, e in dev_ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if not n.startswith(("Memcpy", "Memset")):
            kernel_ns += e - s
            launches += 1
            if roofline.is_dp_kernel(n):
                dp_ns += e - s
    gaps = []
    t = w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((s - t, (t + s) / 2))
        t = max(t, e)
    starts = [c[0] for c in calls]

    def label(mid):
        i = bisect.bisect_right(starts, mid) - 1
        return calls[i][2] if i >= 0 and calls[i][1] >= mid else HARNESS
    gaps = [[label(mid), g / 1e9]
            for g, mid in sorted(gaps, reverse=True)[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "dp_kernel_s": dp_ns / 1e9,
        "launches": launches,
        "device_ops": [[n, v / 1e9] for n, v in ops],
        "idle_gaps": gaps,
    }
