"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace
1`` ``breakdown``, and last ``check``: each number compared beside its
limit, which are also the last lines of standard error.

It exits with code 2 and prints no result where the card is missing or
has fewer devices than the cell asks for (it never runs on the CPU), and
with code 3 where the process holds JAX or the JAX package once the
window has closed.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".portbench_cache"
# checked by whole top-level module name: the port's own name begins with
# the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "sherman_tpu")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list[str]:
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def assemble(out: dict, kind: str, count: int) -> dict:
    """The result line: the run's keys, ``device`` with the card's name
    and count, and ``check`` last."""
    result = dict(out["result"])
    result["device"] = {"platform": "gpu", "kind": kind, "count": count,
                        **result["device"]}
    result["check"] = out["check"]
    return result


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _fixed_caches()

    import torch

    from portbench import harness
    from portbench.spec import Spec

    spec = Spec()
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available():
        _say("portbench: no CUDA device; the benchmark runs on the card "
             "only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        _say(f"portbench: {a.workload} needs {cell['chips']} devices, "
             f"{torch.cuda.device_count()} present")
        return 2
    out = harness.run_cell(spec, a.workload, a.seed, a.seconds,
                           bool(a.trace), "cuda", t_start=_T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        _say(f"portbench: the process holds {', '.join(bad)}")
        return 3
    result = assemble(out, torch.cuda.get_device_name(0),
                      int(cell["chips"]))
    for name, v in out["check"].items():
        _say(f"check {name} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
