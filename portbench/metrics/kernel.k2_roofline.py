"""kernel.k2_roofline: K2 ``gather_pages``' bytes while tracing
(:func:`portbench.roofline.k2_bytes`: an index for every row it covered,
the ``kernels`` collector's ``gather_pages_rows``; a page written for
every row that reads a real page, the DSM's page-read count, every read
of the multi-node paths being an owner's K2 row; and as the pages it
reads, the leaf pages the traced batches need, ``run["leaf_pages"]``) at
the HBM peak, over its device time in the trace, in %.  The bucket rows
that carry no request count their index only."""

from portbench import readers, roofline, trace


def read(run):
    rows = readers.counter(run, "kernels.gather_pages_rows", "traced")
    real = readers.counter(run, "dsm.read_pages", "traced")
    s = trace.kernel_seconds(run["trace"], "gather_pages_kernel")
    if not rows:
        return None
    return roofline.share_pct(
        roofline.k2_bytes(rows, run["leaf_pages"], written=real), s,
        run["device_kind"])
