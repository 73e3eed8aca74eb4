"""kernel.k1_roofline: K1 ``descent_round``'s bytes while tracing
(:func:`portbench.roofline.k1_bytes`: the rows it covered, the ``kernels``
collector's ``descent_round_rows``; its active rows, the DSM's page-read
count, every read of the one-node paths being K1's; and the leaf pages
the traced batches need, ``run["leaf_pages"]``) at the HBM peak, over its
device time in the trace, in %."""

from portbench import readers, roofline, trace


def read(run):
    rows = readers.counter(run, "kernels.descent_round_rows", "traced")
    active = readers.counter(run, "dsm.read_pages", "traced")
    s = trace.kernel_seconds(run["trace"], "descent_round_kernel")
    if not rows:
        return None
    return roofline.share_pct(
        roofline.k1_bytes(rows, active, run["leaf_pages"]), s,
        run["device_kind"])
