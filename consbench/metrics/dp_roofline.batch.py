"""dp_roofline.batch: the DP work's bound over the DP kernels' traced
time, % (measure.dp_roofline_pct)."""
from consbench.measure import dp_roofline_pct


def read(w):
    return dp_roofline_pct(w)
