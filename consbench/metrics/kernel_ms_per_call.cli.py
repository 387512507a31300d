"""kernel_ms_per_call.cli: device kernel time in the trace, per call, ms."""
from consbench.measure import kernel_ms, per_call


def read(w):
    return per_call(w, kernel_ms(w))
