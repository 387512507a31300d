"""cli_call_ms: elapsed time of the window's calls over their count, ms."""


def read(w):
    return w.elapsed_s / w.n_calls * 1e3
