"""kernel_ms_per_cluster.batch: device kernel time in the trace, per
cluster, ms."""
from consbench.measure import kernel_ms, per_cluster


def read(w):
    return per_cluster(w, kernel_ms(w))
