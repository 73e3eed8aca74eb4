"""shermanlint — run the port's invariant checker (counterpart of
``tools/shermanlint.py``).

Usage::

    python -m sherman_tpu_torch.shermanlint               # default tree
    python -m sherman_tpu_torch.shermanlint --json ...    # machine-readable
    python -m sherman_tpu_torch.shermanlint --write-baseline ...
    python -m sherman_tpu_torch.shermanlint --no-baseline ...  # raw

The default paths are ``sherman_tpu_torch/`` and ``chip_smoke.py``;
relative paths are taken from the repo root, whatever the caller's
working directory.  Exit codes: 0 clean, 1 findings, 2 infrastructure
error (stale baseline entry, malformed pragma, unreadable baseline, a
path that lints nothing).  Stale baseline entries are ERRORS by design
— a baseline that rots keeps suppressing whatever new violation drifts
onto its line.  The committed baseline,
``sherman_tpu_torch/shermanlint-baseline.json``, is empty by policy.

The rule set, the port's registry and the pragma grammar live in
``sherman_tpu_torch/analysis/``; the README's "Static analysis (the
port)" part has the rule catalog.  Stdlib only: the linter imports
neither torch nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from collections import Counter
from pathlib import Path

from sherman_tpu_torch import analysis

REPO = Path(__file__).resolve().parent.parent
DEFAULT_BASELINE = REPO / "sherman_tpu_torch" / "shermanlint-baseline.json"
DEFAULT_PATHS = ["sherman_tpu_torch/", "chip_smoke.py"]


def lint(paths=None, baseline=None) -> analysis.LintResult:
    """Lint ``paths`` (default :data:`DEFAULT_PATHS`; relative ones taken
    from the repo root) with the port's registry, its doc paths anchored
    at the repo root so SL007 reads the repo's README from any working
    directory."""
    reg = analysis.DEFAULT_REGISTRY
    reg = dataclasses.replace(
        reg, readme=str(REPO / reg.readme),
        knob_docs=[str(REPO / d) for d in reg.knob_docs])
    paths = [REPO / p for p in (paths or DEFAULT_PATHS)]
    return analysis.run(paths, registry=reg, baseline=baseline, root=REPO)


def pragmas_by_rule(res: analysis.LintResult) -> dict[str, int]:
    """The pragmas that suppressed a finding, by rule code: one a
    suppressed (rule, file, line), however many findings it covers."""
    sites = {(f.rule, f.path, f.line) for f, _ in res.suppressed}
    return dict(sorted(Counter(rule for rule, _, _ in sites).items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="AST invariant checker for the sherman_tpu_torch port")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline; report raw findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline "
                         "(bootstrap path for a new rule; the committed "
                         "target is an empty baseline)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="one JSON object on stdout")
    ap.add_argument("--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)

    baseline = None
    if not args.no_baseline and not args.write_baseline:
        try:
            baseline = analysis.load_baseline(args.baseline)
        except analysis.BaselineError as e:
            print(f"shermanlint: {e}", file=sys.stderr)
            return 2

    res = lint(args.paths, baseline=baseline)

    if args.write_baseline:
        analysis.write_baseline(args.baseline, res.findings)
        print(f"shermanlint: wrote {len(res.findings)} entries to "
              f"{args.baseline}")
        return 0

    if args.as_json:
        print(json.dumps({
            "clean": res.clean,
            "files_checked": res.files_checked,
            "findings": [f.__dict__ for f in res.findings],
            "pragma_errors": [f.__dict__ for f in res.pragma_errors],
            "baseline_errors": res.baseline_errors,
            "suppressed": len(res.suppressed),
            "pragmas_by_rule": pragmas_by_rule(res),
            "suppressed_sites": [
                {**f.__dict__, "reason": why} for f, why in res.suppressed],
            "baselined": len(res.baselined),
        }, indent=1))
    else:
        for f in res.findings:
            print(f.render())
        for f in res.pragma_errors:
            print(f.render())
        for msg in res.baseline_errors:
            print(f"ERROR: {msg}")
        if not args.quiet:
            print(f"shermanlint: {res.files_checked} files, "
                  f"{len(res.findings)} finding(s), "
                  f"{len(res.suppressed)} suppressed, "
                  f"{len(res.baselined)} baselined, "
                  f"{len(res.pragma_errors)} pragma error(s), "
                  f"{len(res.baseline_errors)} baseline error(s)")

    if res.baseline_errors or res.pragma_errors:
        return 2
    return 0 if not res.findings else 1


if __name__ == "__main__":
    sys.exit(main())
