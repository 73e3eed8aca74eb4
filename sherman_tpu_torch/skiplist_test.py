"""Native skiplist micro-bench, ``test/skiplist_test.cpp`` parity (the
port's counterpart of ``tools/skiplist_test.py``).

The reference's one host-only unit test: insert 100 K keys into the
concurrent skiplist, then time 10 K seeks (``skiplist_test.cpp:54-95``).
It exercises the native tier's ``SkipList`` (the index cache's ordered
core; ``sherman_tpu_torch/native``), which runs on the host only.

    python -m sherman_tpu_torch.skiplist_test [--inserts N] [--seeks N]

Prints ``skiplist_test PASS``; ``main(argv)`` returns ``{"metric":
"skiplist_test", "ok": true, "inserts", "seeks", "insert_ns",
"seek_ns"}``.  Exits 1 when the native tier is unavailable, as the
reference does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from sherman_tpu_torch import tools_common as TC


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="skiplist_test of the port")
    p.add_argument("--inserts", type=int, default=100_000)
    p.add_argument("--seeks", type=int, default=10_000)
    a = p.parse_args(argv)

    from sherman_tpu_torch import native
    from sherman_tpu_torch.utils import Timer

    if not native.available():
        print(f"native library unavailable: {native.load_error()}")
        raise SystemExit(1)

    sl = native.SkipList(a.inserts + 16)
    rng = np.random.default_rng(5)
    keys = rng.permutation(np.arange(1, a.inserts + 1, dtype=np.uint64))

    t = Timer()
    t.begin()
    for k in keys:
        sl.insert(int(k), int(k) * 2)
    ins_ns = t.end(a.inserts)
    assert len(sl) == a.inserts

    probe = rng.integers(1, a.inserts, a.seeks, dtype=np.uint64)
    t.begin()
    for k in probe:
        kv = sl.seek_ge(int(k))
        assert kv is not None and kv[0] >= int(k)
    seek_ns = t.end(a.seeks)

    # correctness spot check: seek_ge returns the exact key when present
    for k in (1, a.inserts // 2, a.inserts):
        kv = sl.seek_ge(k)
        assert kv == (k, k * 2), kv

    print(f"skiplist: insert {ins_ns:.0f} ns/op, seek_ge {seek_ns:.0f} ns/op "
          f"({a.inserts} inserts, {a.seeks} seeks)")
    print("skiplist_test PASS", flush=True)
    return {"metric": "skiplist_test", "ok": True, "inserts": a.inserts,
            "seeks": a.seeks, "insert_ns": ins_ns, "seek_ns": seek_ns}


if __name__ == "__main__":
    sys.exit(TC.run_cli(main))
