"""device_idle_share.batch: 1 - the union of device intervals over the
traced window."""
from consbench.measure import idle_share


def read(w):
    return idle_share(w)
