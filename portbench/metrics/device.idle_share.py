"""device.idle_share: 100 x (1 - the union of the device's activity /
the traced window), from the trace."""


def read(run):
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
