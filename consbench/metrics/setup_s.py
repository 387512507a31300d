"""setup_s: seconds from the start of the process to the first timed
call: imports, CUDA start, kernel load (a build in a fresh checkout), the
data and the warm call."""


def read(w):
    return w.setup_s
