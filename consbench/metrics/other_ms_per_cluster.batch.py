"""other_ms_per_cluster.batch: self time of the port's root span
``abpoa.batch`` in the traced window (the batch entry's work outside
every phase span: aligner set-up, read-0 fusion, oracle windows), per
cluster, ms."""
from consbench.measure import per_cluster
from consbench.spans import self_ms


def read(w):
    return per_cluster(w, self_ms(w, "abpoa.batch"))
