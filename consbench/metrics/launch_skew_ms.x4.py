"""launch_skew_ms.x4: how much later the last card gets its work than
the first, the mean over the window's calls of the largest card's
``launched_s`` less the smallest, ms."""
from consbench.cards import calls


def read(w):
    launched = calls(w, "launched_s")
    if launched is None:
        return None
    return sum(max(v) - min(v) for v in launched) / len(launched) * 1e3
