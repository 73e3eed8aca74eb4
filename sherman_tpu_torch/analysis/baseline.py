"""Grandfathered-finding baseline with a freshness contract (counterpart
of ``sherman_tpu/analysis/baseline.py``).

A baseline lets a new rule land while pre-existing violations are
worked off — but a baseline that silently rots is worse than none: an
entry pointing at code that moved keeps suppressing whatever NEW
violation drifts onto that line.  So matching here is exact (rule +
path + line + stripped line content), and every entry that fails to
match both the file content and a live finding is an ERROR (lint exit
2), never a skip.  The committed repo target is an EMPTY baseline:
deliberate exceptions belong in inline pragmas WITH reasons, where the
diff that adds them carries the justification.

Format (JSON, one object)::

    {"version": 1,
     "entries": [{"rule": "SL003", "path": "sherman_tpu_torch/x.py",
                  "line": 12, "snippet": "raise ValueError(...)",
                  "reason": "why this is grandfathered"}]}
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from sherman_tpu_torch.analysis.core import Finding
from sherman_tpu_torch.errors import ShermanError

FORMAT_VERSION = 1


class BaselineError(ShermanError, ValueError):
    """The baseline file itself is unusable (bad JSON/shape/version)."""


@dataclass
class Baseline:
    entries: list[dict] = field(default_factory=list)

    def apply(self, findings: list[Finding], root: Path):
        """-> (kept_findings, absorbed_findings, stale_errors).

        An entry is FRESH iff the file still has exactly its snippet at
        its line AND a live finding matches it; otherwise it is stale
        and reported.  Findings not covered by a fresh entry are kept.
        """
        by_key = {}
        for e in self.entries:
            by_key[(e["rule"], e["path"], int(e["line"]),
                    e["snippet"])] = e
        kept, absorbed, stale = [], [], []
        matched: set[tuple] = set()
        for f in findings:
            if f.key() in by_key:
                absorbed.append(f)
                matched.add(f.key())
            else:
                kept.append(f)
        for key, e in by_key.items():
            if key in matched:
                continue
            rule, path, line, snippet = key
            p = root / path
            if not p.is_file():
                stale.append(f"baseline entry {rule} {path}:{line}: "
                             "file no longer exists — remove the entry")
                continue
            lines = p.read_text().splitlines()
            actual = lines[line - 1].strip() if 0 < line <= len(lines) \
                else "<past end of file>"
            if actual != snippet:
                stale.append(
                    f"baseline entry {rule} {path}:{line}: line content "
                    f"changed ({actual!r} != {snippet!r}) — re-anchor or "
                    "remove the entry")
            else:
                stale.append(
                    f"baseline entry {rule} {path}:{line}: no finding is "
                    "produced there any more — the violation was fixed, "
                    "remove the entry")
        return kept, absorbed, stale


def load_baseline(path) -> Baseline:
    path = Path(path)
    if not path.is_file():
        return Baseline(entries=[])
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise BaselineError(f"baseline {path} is not valid JSON: {e}") \
            from None
    if not isinstance(data, dict) or data.get("version") != FORMAT_VERSION:
        raise BaselineError(
            f"baseline {path}: want {{'version': {FORMAT_VERSION}, "
            "'entries': [...]}")
    entries = data.get("entries")
    if not isinstance(entries, list):
        raise BaselineError(f"baseline {path}: 'entries' must be a list")
    for e in entries:
        missing = {"rule", "path", "line", "snippet"} - set(e)
        if missing:
            raise BaselineError(
                f"baseline {path}: entry {e!r} missing {sorted(missing)}")
        if not str(e.get("reason", "")).strip():
            raise BaselineError(
                f"baseline {path}: entry {e['rule']} {e['path']}:"
                f"{e['line']} has no reason — grandfathering without a "
                "recorded why is how conventions rot")
    return Baseline(entries=entries)


def write_baseline(path, findings: list[Finding],
                   reason: str = "grandfathered at baseline creation"
                   ) -> None:
    """Serialize ``findings`` as a fresh baseline (the bootstrap path a
    new rule uses; the committed target is still to fix and empty it)."""
    data = {
        "version": FORMAT_VERSION,
        "entries": [{"rule": f.rule, "path": f.path, "line": f.line,
                     "snippet": f.snippet, "reason": reason}
                    for f in sorted(findings, key=lambda f: f.key())],
    }
    Path(path).write_text(json.dumps(data, indent=1) + "\n")
