"""ops_s: the client ops answered in the window (every op sent but the
updates refused with a lock timeout) over the window's length (first
send to last answer), on the host's clock."""


def read(run):
    w = run["window"]
    return (w.ops - w.n_refused) / w.seconds
