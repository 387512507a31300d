"""clusters_per_s: consensus sequences returned by the window's calls over
the elapsed time of those calls (whole calls only)."""


def read(w):
    return sum(len(cons) for c in w.calls for cons in c.answers) / w.elapsed_s
