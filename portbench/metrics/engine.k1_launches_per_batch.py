"""engine.k1_launches_per_batch: K1 ``descent_round`` launches (the
``kernels`` collector's ``descent_round_launches``) per batch sent: the
descent's rounds a batch."""

from portbench import readers


def read(run):
    return readers.per_batch(run, "kernels.descent_round_launches")
