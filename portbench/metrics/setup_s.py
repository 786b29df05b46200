"""setup_s: process start to the first timed call, on the host clock:
imports, drawing the weights, building the program (compiling its
kernels on a checkout's first run) and the warm-up."""


def read(run):
    return run["setup_s"]
