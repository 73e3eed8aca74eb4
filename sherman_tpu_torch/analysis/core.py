"""The shermanlint framework of the port: findings, parsed sources,
pragmas, runner (counterpart of ``sherman_tpu/analysis/core.py``).

Everything here is rule-agnostic.  A :class:`Rule` gets a
:class:`SourceFile` (AST with parent links + dotted qualnames + the
pragma table) and a registry object, and returns :class:`Finding`\\ s;
the runner applies pragma suppression and (optionally) a baseline.

Suppression contract: ``# shermanlint: disable=SL003 <reason>`` on the
finding's line, or on a comment-only line directly above it.  The
reason is MANDATORY — a pragma without one does not suppress and is
itself reported (SL000), so every deliberate exception carries its
justification in the diff that introduces it.
"""

from __future__ import annotations

import ast
import fnmatch
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

PRAGMA_CODE = "SL000"
_PRAGMA_RE = re.compile(
    r"#\s*shermanlint:\s*disable=([A-Za-z0-9,\s]+?)(?:\s+(\S.*))?$")
_CODE_RE = re.compile(r"^SL\d{3}$")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line.

    ``snippet`` is the stripped source text of that line — the content
    fingerprint the baseline uses, so a baseline entry goes stale the
    moment the line it grandfathers changes.
    """

    rule: str
    path: str       # repo-relative, POSIX separators
    line: int       # 1-indexed
    message: str
    snippet: str

    def key(self) -> tuple:
        return (self.rule, self.path, self.line, self.snippet)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[tuple[Finding, str]] = field(default_factory=list)
    pragma_errors: list[Finding] = field(default_factory=list)
    baseline_errors: list[str] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    files_checked: int = 0

    @property
    def clean(self) -> bool:
        return not (self.findings or self.pragma_errors
                    or self.baseline_errors)


class SourceFile:
    """A parsed module: AST with parent links, qualnames, pragmas.

    ``rel`` is the repo-relative POSIX path every rule and registry
    pattern matches against (``sherman_tpu_torch/parallel/dsm.py``).
    """

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._sherman_parent = node  # type: ignore[attr-defined]
        # line -> (codes, reason); codes empty-string reason == invalid
        self.pragmas: dict[int, tuple[set[str], str]] = {}
        self.pragma_errors: list[Finding] = []
        self._scan_pragmas()

    # -- pragmas -------------------------------------------------------------

    def _scan_pragmas(self) -> None:
        # real COMMENT tokens only — a pragma spelled inside a
        # docstring or regex literal is prose, not a suppression
        comments: list[tuple[int, str]] = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    comments.append((tok.start[0], tok.string))
        except tokenize.TokenError:
            pass
        for i, comment in comments:
            if "shermanlint:" not in comment:
                continue
            m = _PRAGMA_RE.search(comment)
            if m is None:
                self.pragma_errors.append(self._finding(
                    PRAGMA_CODE, i,
                    "malformed shermanlint pragma (want '# shermanlint: "
                    "disable=SLxxx <reason>')"))
                continue
            codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
            reason = (m.group(2) or "").strip()
            bad = sorted(c for c in codes if not _CODE_RE.match(c))
            if bad:
                self.pragma_errors.append(self._finding(
                    PRAGMA_CODE, i,
                    f"pragma names invalid rule id(s) {bad} (want SLxxx)"))
                continue
            if not reason:
                self.pragma_errors.append(self._finding(
                    PRAGMA_CODE, i,
                    "pragma has no reason — every suppression must say "
                    "why (disable=SLxxx <reason>)"))
                continue
            self.pragmas[i] = (codes, reason)

    def suppression(self, rule: str, line: int) -> str | None:
        """Reason text if ``rule`` is suppressed at ``line``, else None.

        A pragma applies to its own line, or — when it sits alone on a
        comment line — to the first following non-comment line.
        """
        hit = self.pragmas.get(line)
        if hit and rule in hit[0]:
            return hit[1]
        for back in range(line - 1, 0, -1):
            txt = self.lines[back - 1].strip() if back <= len(self.lines) \
                else ""
            if not txt.startswith("#"):
                break
            hit = self.pragmas.get(back)
            if hit and rule in hit[0]:
                return hit[1]
        return None

    # -- helpers for rules ---------------------------------------------------

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def _finding(self, rule: str, line: int, message: str) -> Finding:
        return Finding(rule=rule, path=self.rel, line=line,
                       message=message, snippet=self.snippet(line))

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return self._finding(rule, getattr(node, "lineno", 1), message)

    def qualname(self, node: ast.AST) -> str:
        """Dotted enclosing-scope name: ``Journal.append``,
        ``make_staged_step.step`` (no ``<locals>`` noise — lint
        patterns should read like the code does)."""
        parts: list[str] = []
        cur: ast.AST | None = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = getattr(cur, "_sherman_parent", None)
        return ".".join(reversed(parts))

    def functions(self) -> list[ast.FunctionDef | ast.AsyncFunctionDef]:
        return [n for n in ast.walk(self.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def enclosing_function(self, node: ast.AST):
        cur = getattr(node, "_sherman_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = getattr(cur, "_sherman_parent", None)
        return None


def match_scope(patterns, rel: str, qual: str) -> bool:
    """True when any ``(path_glob, qualname_glob)`` pair matches."""
    return any(fnmatch.fnmatch(rel, pp) and fnmatch.fnmatch(qual, qp)
               for pp, qp in patterns)


def callee_name(call: ast.Call) -> str:
    """Terminal name of a call target: ``a.b.c(...)`` -> ``c``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` for the matching Attribute/Name chain,
    ``""`` when the expression is not a plain dotted name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class Rule:
    """Base class: subclasses set ``code``/``name``/``doc`` and
    implement ``check``.  ``doc`` is the one-line lesson the rule
    encodes — it feeds the README catalog via :func:`rule_catalog`."""

    code = "SL999"
    name = "unnamed"
    doc = ""

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        raise NotImplementedError


def iter_py_files(paths) -> list[Path]:
    """Expand files/directories into a sorted, de-duplicated ``.py``
    list; skips ``__pycache__`` and hidden directories BELOW each
    argument (ancestors of the argument are the caller's business — a
    checkout under ``~/.cache`` must still lint)."""
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.relative_to(p).parts
                and not any(part.startswith(".")
                            for part in f.relative_to(p).parts)))
        elif p.suffix == ".py":
            out.append(p)
    seen: set[Path] = set()
    uniq = []
    for f in out:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            uniq.append(f)
    return uniq


def _rel(path: Path, root: Path | None) -> str:
    p = path.resolve()
    if root is not None:
        try:
            return p.relative_to(root.resolve()).as_posix()
        except ValueError:
            pass
    return path.as_posix()


def run(paths, rules=None, registry=None, baseline=None,
        root: Path | None = None) -> LintResult:
    """Lint ``paths`` -> :class:`LintResult`.

    ``baseline`` (a
    :class:`~sherman_tpu_torch.analysis.baseline.Baseline`)
    absorbs grandfathered findings; stale entries — file gone, line
    moved, content changed, or the finding no longer produced — land in
    ``baseline_errors`` (the freshness contract).
    """
    from sherman_tpu_torch.analysis.registry import DEFAULT_REGISTRY
    from sherman_tpu_torch.analysis.rules import ALL_RULES

    rules = ALL_RULES if rules is None else rules
    registry = DEFAULT_REGISTRY if registry is None else registry
    if root is None:
        root = Path.cwd()

    result = LintResult()
    # a path that lints NOTHING is an infrastructure error, never a
    # silent green: a typo'd directory in CI must not read as clean
    for p in paths:
        if not Path(p).exists():
            result.baseline_errors.append(
                f"{p}: input path does not exist — nothing was linted")
    sources: list[SourceFile] = []
    for path in iter_py_files(paths):
        rel = _rel(path, root)
        try:
            sf = SourceFile(path, rel, path.read_text())
        except (OSError, SyntaxError) as e:
            result.baseline_errors.append(f"{rel}: unreadable: {e}")
            continue
        sources.append(sf)
        result.files_checked += 1
    if result.files_checked == 0:
        result.baseline_errors.append(
            "no Python files found under the given paths — a lint run "
            "that checks nothing cannot vouch for anything")

    raw: list[Finding] = []
    for sf in sources:
        result.pragma_errors.extend(sf.pragma_errors)
        for rule in rules:
            for f in rule.check(sf, registry):
                reason = sf.suppression(f.rule, f.line)
                if reason is not None:
                    result.suppressed.append((f, reason))
                else:
                    raw.append(f)

    if baseline is not None:
        kept, absorbed, stale = baseline.apply(raw, root)
        result.baselined = absorbed
        result.baseline_errors.extend(stale)
        result.findings.extend(kept)
    else:
        result.findings.extend(raw)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result
