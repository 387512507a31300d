"""consensus_ms_per_cluster.batch: self time of the port's ``abpoa.consensus``
spans in the traced window, per cluster, ms."""
from consbench.measure import per_cluster
from consbench.spans import self_ms


def read(w):
    return per_cluster(w, self_ms(w, "abpoa.consensus"))
