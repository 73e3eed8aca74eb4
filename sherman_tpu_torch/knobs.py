"""knobs — generate the port's SHERMAN_* env-knob inventory table
(counterpart of ``tools/knobs.py``).

The SL007 rule requires every knob READ in the code to appear in the
README; this tool generates the table the README's port section embeds,
so the docs cannot drift from the code: ``--check`` fails when the
committed table no longer matches the tree.

Usage::

    python -m sherman_tpu_torch.knobs            # print the markdown table
    python -m sherman_tpu_torch.knobs --write    # splice it into README.md
    python -m sherman_tpu_torch.knobs --check    # exit 1 if the table is stale
    python -m sherman_tpu_torch.knobs --json     # machine-readable inventory

The default paths are ``sherman_tpu_torch/`` and ``chip_smoke.py``
(relative paths are taken from the repo root).  The table is spliced
between the port's own markers in README.md, which the reference's
table tool does not match::

    <!-- shermanlint-torch-knobs:begin -->
    <!-- shermanlint-torch-knobs:end -->
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

from sherman_tpu_torch.analysis.core import SourceFile, iter_py_files
from sherman_tpu_torch.analysis.rules import env_reads

REPO = Path(__file__).resolve().parent.parent
DEFAULT_PATHS = ["sherman_tpu_torch/", "chip_smoke.py"]
BEGIN = "<!-- shermanlint-torch-knobs:begin -->"
END = "<!-- shermanlint-torch-knobs:end -->"
GENERATED_NOTE = ("<!-- generated by `python -m sherman_tpu_torch.knobs "
                  "--write` — do not edit by hand -->")


def inventory(paths=None, prefix: str = "SHERMAN_") -> dict[str, dict]:
    """{knob: {"default": str, "sites": [path:line, ...], "via": str}}
    aggregated over every env read (and helper-indirected literal) in
    ``paths``."""
    knobs: dict[str, dict] = {}
    for f in iter_py_files([REPO / p for p in (paths or DEFAULT_PATHS)]):
        try:
            rel = f.resolve().relative_to(REPO).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            sf = SourceFile(f, rel, f.read_text())
        except (OSError, SyntaxError):
            continue
        for read in env_reads(sf, prefix):
            k = knobs.setdefault(read["name"], {
                "default": "", "sites": [], "via": read["via"]})
            k["sites"].append(f"{read['path']}:{read['line']}")
            if read["via"] == "env-read":
                k["via"] = "env-read"
                d = read["default"]
                if d and not k["default"]:
                    k["default"] = d
                elif d and k["default"] not in ("", d):
                    k["default"] = "(varies by site)"
    for k in knobs.values():
        k["sites"].sort()
    return dict(sorted(knobs.items()))


def _md_escape(s: str) -> str:
    return s.replace("|", "\\|").replace("`", "")


def table(knobs: dict[str, dict]) -> str:
    lines = [GENERATED_NOTE, "",
             "| Knob | Default | Read at |",
             "|---|---|---|"]
    for name, k in knobs.items():
        sites = k["sites"]
        shown = ", ".join(f"`{s}`" for s in sites[:3])
        if len(sites) > 3:
            shown += f" (+{len(sites) - 3} more)"
        default = f"`{_md_escape(k['default'])}`" if k["default"] else "—"
        lines.append(f"| `{name}` | {default} | {shown} |")
    lines.append("")
    lines.append(f"({len(knobs)} knobs; line numbers refresh with "
                 "`python -m sherman_tpu_torch.knobs --write`)")
    return "\n".join(lines)


def splice(readme: Path, text: str) -> str:
    content = readme.read_text()
    pat = re.compile(re.escape(BEGIN) + r".*?" + re.escape(END), re.S)
    if not pat.search(content):
        raise SystemExit(
            f"knobs: {readme} has no {BEGIN} / {END} markers — add them "
            "where the table belongs")
    return pat.sub(lambda _: BEGIN + "\n" + text + "\n" + END, content)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None)
    ap.add_argument("--write", action="store_true",
                    help="splice the table into README.md")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when the README table is stale")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--readme", default=str(REPO / "README.md"))
    args = ap.parse_args(argv)

    knobs = inventory(args.paths or None)
    if args.as_json:
        print(json.dumps(knobs, indent=1))
        return 0
    md = table(knobs)
    readme = Path(args.readme)
    if args.write:
        readme.write_text(splice(readme, md))
        print(f"knobs: wrote {len(knobs)}-knob table into {readme}")
        return 0
    if args.check:
        want = splice(readme, md)
        if want != readme.read_text():
            print("knobs: README port knob table is STALE — run "
                  "`python -m sherman_tpu_torch.knobs --write`",
                  file=sys.stderr)
            return 1
        print(f"knobs: README port table fresh ({len(knobs)} knobs)")
        return 0
    print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
