"""kernel.k3_roofline: K3 ``writeback``'s bytes while tracing
(:func:`portbench.roofline.k3_bytes`: the rows it covered, the
``kernels`` collector's ``writeback_rows``; the applied updates and the
words a row writes, from the DSM's write counters) at the HBM peak, over
its device time in the trace, in %."""

from portbench import readers, roofline, trace


def read(run):
    rows = readers.counter(run, "kernels.writeback_rows", "traced")
    ops = readers.counter(run, "dsm.write_ops", "traced")
    words = readers.counter(run, "dsm.write_words", "traced")
    s = trace.kernel_seconds(run["trace"], "writeback_kernel")
    if not rows or not ops:
        return None
    return roofline.share_pct(
        roofline.k3_bytes(rows, ops, words // ops), s, run["device_kind"])
