"""setup_s: from the process's start to the end of the warm-up: imports,
the inputs from the seed, the build and bulk load, the ring, the
warm-up batches (and, in a checkout's first run, the kernels' build)."""


def read(run):
    return run["setup_s"]
