"""fallbacks_per_call.batch: instances that BatchPOA rebuilt on its host
oracle (BatchPOA.fallbacks), per call."""
from consbench.measure import per_call


def read(w):
    return per_call(w, w.counter("fallbacks"))
