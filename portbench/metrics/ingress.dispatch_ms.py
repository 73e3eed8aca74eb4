"""ingress.dispatch_ms: the mean of the port's ``prep.device_dispatch_ms``
histogram (recorded by ``make_ingress_step``'s device-prep dispatch: the
pair split, the copies, the prep and the fan-out's launch) over the
window's untraced batches."""

from portbench import readers


def read(run):
    which = readers.part(run)
    n = readers.counter(run, "prep.device_dispatch_ms.count", which)
    if not n:
        return None
    return readers.counter(run, "prep.device_dispatch_ms.sum", which) / n
