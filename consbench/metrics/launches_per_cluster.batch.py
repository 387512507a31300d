"""launches_per_cluster.batch: device kernel launches in the trace, per
cluster."""
from consbench.measure import launches, per_cluster


def read(w):
    return per_cluster(w, launches(w))
