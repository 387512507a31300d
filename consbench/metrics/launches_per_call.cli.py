"""launches_per_call.cli: device kernel launches in the trace, per call."""
from consbench.measure import launches, per_call


def read(w):
    return per_call(w, launches(w))
