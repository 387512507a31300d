"""other_ms_per_call.cli: self time of the port's root span ``abpoa.cli``
in the traced window (argument parsing, reading and writing files, the
telemetry line), per call, ms."""
from consbench.measure import per_call
from consbench.spans import self_ms


def read(w):
    return per_call(w, self_ms(w, "abpoa.cli"))
