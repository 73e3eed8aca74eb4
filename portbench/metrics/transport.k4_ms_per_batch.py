"""transport.k4_ms_per_batch: device time of the exchange kernel K4
(``exchange_kernel``) in the trace per batch sent while tracing."""

from portbench import trace


def read(run):
    s = trace.kernel_seconds(run["trace"], "exchange_kernel")
    n = run["batches"]["traced"]
    return s * 1e3 / n if s > 0 and n else None
