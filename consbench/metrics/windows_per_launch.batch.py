"""windows_per_launch.batch: windows (or instances) a DP launch of the
batch paths carried, on average over the traced window: the summed work
units of the port's ``abpoa.dispatch`` spans over their count."""
from consbench.spans import mean_n


def read(w):
    return mean_n(w, "abpoa.dispatch")
