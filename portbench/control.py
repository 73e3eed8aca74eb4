"""The control of the check: the plain reference put in the program's
place with one of the configuration's guarantees broken, driven through
the same loop, ring and comparison as a run.  The comparison has to find
it wrong; it sets each limit's upper reading (PERF.md).

The guarantee broken is the read's: a read answers its own key's latest
value.  The control answers reads from a hot-key cache that checks no
key tag and that no update invalidates (:class:`portbench.system.
ControlSystem`), the shortcut a faster read path could take.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --batches <as many as a run's window sends>

One JSON line a seed: the numbers compared, their limits, ``correct``.
It needs no card: the reference runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, required=True)
    a = ap.parse_args(argv)

    from portbench import harness
    from portbench.spec import Spec
    spec = Spec()
    for seed in (int(s) for s in a.seeds.split(",")):
        out = harness.run_cell(spec, a.workload, seed, 0.0, False, "cpu",
                               t_start=time.perf_counter(), control=True,
                               window_batches=a.batches)
        r = out["result"]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "batches": a.batches, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "check": out["check"], "parts": out["parts"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
