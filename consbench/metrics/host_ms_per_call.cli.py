"""host_ms_per_call.cli: traced window time with no device activity, per
call, ms."""
from consbench.measure import host_ms, per_call


def read(w):
    return per_call(w, host_ms(w))
