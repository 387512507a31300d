"""host_ms_per_cluster.batch: traced window time with no device activity,
per cluster, ms."""
from consbench.measure import host_ms, per_cluster


def read(w):
    return per_cluster(w, host_ms(w))
