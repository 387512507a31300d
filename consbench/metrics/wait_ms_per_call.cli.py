"""wait_ms_per_call.cli: self time of the port's ``abpoa.wait`` spans
in the traced window, per call, ms."""
from consbench.measure import per_call
from consbench.spans import self_ms


def read(w):
    return per_call(w, self_ms(w, "abpoa.wait"))
