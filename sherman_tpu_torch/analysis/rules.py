"""The seven shermanlint rules of the port — each encodes a lesson the
reference paid for, restated for PyTorch where the framework differs.
See the README "Static analysis (the port)" catalog; each rule's
``doc`` is the one-line version.

Rules deliberately check REGISTERED scopes (see registry.py) rather
than guessing hotness or mutation from code shape: a static pass that
cries wolf gets pragma'd into silence, so precision beats recall here —
growing the registry is a one-line diff, read like any other.

Two rules depend on the framework.  SL001's sync tables live in the
:class:`~sherman_tpu_torch.analysis.registry.Registry` (torch's explicit
syncs by default), so one engine runs with either package's table.
SL004's dispatch sites are the port's ``_get_*`` program factories and
``obs.device.wrap_program``, whose ledger keys a Python scalar by its
type.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from pathlib import Path

from sherman_tpu_torch.analysis.core import (Finding, Rule, SourceFile,
                                             callee_name, dotted_name,
                                             match_scope)

# ---------------------------------------------------------------------------
# SL001 — host sync in a hot path
# ---------------------------------------------------------------------------

_CONCRETIZERS = {"float", "int", "bool"}
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "sharding"}


def _is_static_expr(node: ast.AST, static_roots: set[str]) -> bool:
    """True when evaluating ``node`` cannot touch device data: literals,
    config-attribute chains, shapes/dtypes, ``len()``, and arithmetic
    over those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id.isupper() or node.id in static_roots
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return True
        root = node.value
        while isinstance(root, ast.Attribute):
            root = root.value
        return isinstance(root, ast.Name) and (
            root.id in static_roots or root.id.isupper())
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value, static_roots)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand, static_roots)
    if isinstance(node, ast.BinOp):
        return (_is_static_expr(node.left, static_roots)
                and _is_static_expr(node.right, static_roots))
    if isinstance(node, ast.Call):
        return (callee_name(node) in {"len", "min", "max", "abs", "round"}
                and all(_is_static_expr(a, static_roots)
                        for a in node.args))
    return False


class HostSyncInHotPath(Rule):
    code = "SL001"
    name = "host-sync-in-hot-path"
    doc = ("No `.item()`/`.tolist()`/`.cpu()`/`.numpy()`/`.synchronize()`/"
           "`float()`/`np.asarray` inside registered hot step functions "
           "or kernel launch wrappers — one stray sync is a per-step "
           "device round-trip (the staged loops' whole design is that "
           "nothing ships per step).  Blind spot: implicit syncs "
           "(`if t.any():`, boolean-mask indexing, `torch.nonzero`) are "
           "not seen.")

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        out: list[Finding] = []
        for fn in sf.functions():
            if not match_scope(reg.hot_functions, sf.rel, sf.qualname(fn)):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                dotted = dotted_name(node.func)
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in reg.sync_attr_calls):
                    out.append(sf.finding(
                        self.code, node,
                        f"`.{node.func.attr}()` in hot function "
                        f"`{sf.qualname(fn)}` forces a device->host sync"))
                elif dotted in reg.sync_dotted or dotted == "device_get":
                    out.append(sf.finding(
                        self.code, node,
                        f"`{dotted}` in hot function `{sf.qualname(fn)}` "
                        "materializes device data on the host"))
                elif (isinstance(node.func, ast.Name)
                      and node.func.id in _CONCRETIZERS
                      and len(node.args) == 1
                      and not _is_static_expr(node.args[0],
                                              reg.static_roots)):
                    out.append(sf.finding(
                        self.code, node,
                        f"`{node.func.id}(...)` on a possibly-device "
                        f"value in hot function `{sf.qualname(fn)}` "
                        "reads it on the host (a device sync); keep "
                        "it a tensor or hoist it to prep"))
        return out


# ---------------------------------------------------------------------------
# SL002 — pool mutation without dirty= threading
# ---------------------------------------------------------------------------

def _own_nodes(fn: ast.AST):
    """Walk ``fn`` excluding nested function bodies (those are checked
    as their own scopes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class UntrackedPoolWrite(Rule):
    code = "SL002"
    name = "untracked-pool-write"
    doc = ("Functions composing pool-mutating primitives must accept and "
           "thread `dirty=` (kw-only at the library surface) or sit on "
           "the explicit allowlist — delta checkpoints are only "
           "sound if every tracked write path marks its pages.")

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        out: list[Finding] = []
        for fn in sf.functions():
            if fn.name in reg.pool_mutators:
                continue
            qual = sf.qualname(fn)
            if match_scope(reg.dirty_allowlist, sf.rel, qual):
                continue
            used = sorted({
                name for node in _own_nodes(fn)
                for name in (
                    [node.id] if isinstance(node, ast.Name)
                    else [node.attr] if isinstance(node, ast.Attribute)
                    else [])
                if name in reg.pool_mutators})
            if not used:
                continue
            a = fn.args
            kwonly = {x.arg for x in a.kwonlyargs}
            positional = {x.arg for x in a.args + a.posonlyargs}
            parent = getattr(fn, "_sherman_parent", None)
            nested = isinstance(parent, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) or \
                isinstance(getattr(parent, "_sherman_parent", None),
                           (ast.FunctionDef, ast.AsyncFunctionDef))
            if "dirty" in kwonly or (nested and "dirty" in positional):
                continue
            if "dirty" in positional:
                out.append(sf.finding(
                    self.code, fn,
                    f"`{qual}` threads `dirty` positionally; the library "
                    "contract is KEYWORD-ONLY (`*, dirty=None`) so legacy "
                    "callers stay valid"))
            else:
                out.append(sf.finding(
                    self.code, fn,
                    f"`{qual}` composes pool mutator(s) {used} without a "
                    "kw-only `dirty=` parameter — its writes are "
                    "invisible to delta checkpoints; thread `dirty=` or "
                    "allowlist it with a reason"))
        return out


# ---------------------------------------------------------------------------
# SL003 — bare stdlib raises in library code
# ---------------------------------------------------------------------------

class BareStdlibRaise(Rule):
    code = "SL003"
    name = "bare-stdlib-raise"
    doc = ("Library code raises the typed classes in "
           "`sherman_tpu_torch/errors.py`, never bare ValueError/"
           "RuntimeError/"
           "AssertionError — callers branch on types, not message "
           "strings.")

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        if not any(fnmatch.fnmatch(sf.rel, p) for p in reg.library_paths):
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = ""
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in reg.banned_raises:
                out.append(sf.finding(
                    self.code, node,
                    f"bare `raise {name}` in library code — use a typed "
                    "class from sherman_tpu_torch/errors.py (subclassing "
                    f"{name} keeps existing callers working)"))
        return out


# ---------------------------------------------------------------------------
# SL004 — retrace hazard at a program dispatch site
# ---------------------------------------------------------------------------

def _matches_factory(name: str, patterns) -> bool:
    return bool(name) and any(fnmatch.fnmatch(name, p) for p in patterns)


def _scalar_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return _scalar_literal(node.operand)
    if isinstance(node, ast.Call) and callee_name(node) in ("int", "float"):
        return True
    return False


class RetraceHazard(Rule):
    code = "SL004"
    name = "retrace-hazard"
    doc = ("No Python scalars positionally at program dispatch sites "
           "(`_get_*` factories, `obs.device.wrap_program`) — the "
           "program ledger keys a scalar by its type, so `int`, `float` "
           "and a numpy scalar at one position are three signatures and, "
           "after `seal()`, a retrace; pass one fixed type (a tensor) or "
           "make it a static factory arg (the static twin of the sealed "
           "ledger's retrace detector).")

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        out: list[Finding] = []
        for fn in sf.functions():
            program_names: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call) \
                        and _matches_factory(callee_name(node.value),
                                             reg.jit_factory_patterns):
                    program_names.add(node.targets[0].id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                # dispatch through a bound program (fn = self._get_x(...);
                # fn(...)) or immediately (self._get_x(...)(...))
                direct = isinstance(node.func, ast.Name) \
                    and node.func.id in program_names
                immediate = isinstance(node.func, ast.Call) \
                    and _matches_factory(callee_name(node.func),
                                         reg.jit_factory_patterns)
                if not (direct or immediate):
                    continue
                for i, arg in enumerate(node.args):
                    if _scalar_literal(arg):
                        out.append(sf.finding(
                            self.code, arg,
                            f"positional arg {i} of a program dispatch is "
                            "a Python scalar — the ledger keys it by its "
                            "type, so `int`/`float`/numpy scalars at this "
                            "position are distinct signatures (a retrace "
                            "once sealed); pass one fixed type (a tensor), "
                            "or make it a static arg of the program "
                            "factory"))
        return out


# ---------------------------------------------------------------------------
# SL005 — ack released before the covering fsync
# ---------------------------------------------------------------------------

class AckBeforeFsync(Rule):
    code = "SL005"
    name = "ack-before-fsync"
    doc = ("On registered journal append paths, every return after the "
           "record write must be preceded by an fsync-domain call "
           "(`_fsync`/`_commit`) — an ack that outruns its fsync is "
           "silent RPO > 0 (the whole durability story).")

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        out: list[Finding] = []
        for fn in sf.functions():
            if not match_scope(reg.append_paths, sf.rel, sf.qualname(fn)):
                continue
            events: list[tuple[tuple[int, int], str, ast.AST]] = []
            for node in ast.walk(fn):
                pos = (getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0))
                if isinstance(node, ast.Call):
                    if isinstance(node.func, ast.Attribute) \
                            and node.func.attr in reg.durable_write_names:
                        events.append((pos, "write", node))
                    elif callee_name(node) in reg.fsync_names:
                        events.append((pos, "sync", node))
                elif isinstance(node, ast.Return):
                    events.append((pos, "return", node))
            events.sort(key=lambda e: e[0])
            first_write = next((pos for pos, kind, _ in events
                                if kind == "write"), None)
            if first_write is None:
                continue
            for pos, kind, node in events:
                if kind != "return" or pos <= first_write:
                    continue
                covered = any(k == "sync" and first_write < p < pos
                              for p, k, _ in events)
                if not covered:
                    out.append(sf.finding(
                        self.code, node,
                        f"`{sf.qualname(fn)}` returns after writing a "
                        "record with no fsync-domain call "
                        f"({sorted(reg.fsync_names)}) between write and "
                        "return — the ack can outrun durability"))
        return out


# ---------------------------------------------------------------------------
# SL006 — allocation/formatting in an obs increment path
# ---------------------------------------------------------------------------

_ALLOC_CALLS = {"str", "repr", "dict", "list", "set", "sorted", "format"}


class ObsHotAllocation(Rule):
    code = "SL006"
    name = "obs-hot-allocation"
    doc = ("Registered obs increment paths (`Counter.inc`, "
           "`Histogram.record`, the SLO observers) build no "
           "dicts/lists/f-strings — they run per step inside timed "
           "windows, and their cost is pinned < 2% of the staged "
           "wall.")

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        out: list[Finding] = []
        for fn in sf.functions():
            qual = sf.qualname(fn)
            if not match_scope(reg.obs_hot_functions, sf.rel, qual):
                continue
            for node in _own_nodes(fn):
                bad = None
                if isinstance(node, ast.JoinedStr):
                    bad = "f-string construction"
                elif isinstance(node, ast.Dict) and node.keys:
                    bad = "dict construction"
                elif isinstance(node, (ast.DictComp, ast.ListComp,
                                       ast.SetComp, ast.GeneratorExp)):
                    bad = "comprehension"
                elif isinstance(node, (ast.List, ast.Set)) and node.elts:
                    bad = "list/set construction"
                elif isinstance(node, ast.Call) and (
                        callee_name(node) in _ALLOC_CALLS
                        or (isinstance(node.func, ast.Attribute)
                            and node.func.attr == "format")):
                    bad = f"`{callee_name(node)}(...)` allocation"
                if bad:
                    out.append(sf.finding(
                        self.code, node,
                        f"{bad} in obs hot path `{qual}` — this runs "
                        "per step inside timed windows; precompute at "
                        "registration or move to the snapshot side"))
        return out


# ---------------------------------------------------------------------------
# SL007 — undocumented SHERMAN_* knob
# ---------------------------------------------------------------------------

def module_str_constants(sf: SourceFile) -> dict[str, str]:
    consts: dict[str, str] = {}
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            consts[node.targets[0].id] = node.value.value
    return consts


def env_reads(sf: SourceFile, prefix: str) -> list[dict]:
    """Every ``os.environ.get / os.getenv / os.environ[...]`` read of a
    ``prefix``-named variable in ``sf`` — plus bare string literals
    matching the prefix (helper-indirected reads like
    ``_env("SHERMAN_PEAK_GBPS", 1e9)``), marked ``via="literal"``.
    The knob-inventory tool consumes the full list; rule SL007 gates on
    the resolved reads only.
    """
    consts = module_str_constants(sf)
    reads: list[dict] = []
    seen_lines: set[tuple[str, int]] = set()

    def _resolve(node: ast.AST) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        return None

    def _add(name: str | None, node: ast.AST, via: str, default: str):
        if not name or not name.startswith(prefix):
            return
        key = (name, getattr(node, "lineno", 0))
        if key in seen_lines:
            return
        seen_lines.add(key)
        reads.append({"name": name, "path": sf.rel,
                      "line": getattr(node, "lineno", 0),
                      "via": via, "default": default})

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            dotted = dotted_name(node.func)
            if dotted.endswith("environ.get") or dotted.endswith(".getenv") \
                    or dotted == "getenv":
                if node.args:
                    default = ast.unparse(node.args[1]) \
                        if len(node.args) > 1 else "(unset -> None)"
                    _add(_resolve(node.args[0]), node, "env-read", default)
        elif isinstance(node, ast.Subscript):
            if dotted_name(node.value).endswith("environ"):
                _add(_resolve(node.slice), node, "env-read", "(required)")
    resolved_names = {r["name"] for r in reads}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith(prefix) \
                and node.value[len(prefix):].replace("_", "").isalnum() \
                and node.value not in resolved_names:
            _add(node.value, node, "literal", "")
    return reads


class UndocumentedKnob(Rule):
    code = "SL007"
    name = "undocumented-knob"
    doc = ("Every `SHERMAN_*` env read must appear in the README knob "
           "docs (the generated inventory table keeps them from "
           "drifting) — a sampler mode nobody could look up is what an "
           "undocumented knob costs.")

    def __init__(self):
        self._doc_cache: dict[tuple, str] = {}

    def _doc_text(self, reg) -> str:
        if reg.knob_doc_text is not None:
            return reg.knob_doc_text
        key = (reg.readme, tuple(reg.knob_docs))
        if key not in self._doc_cache:
            text = []
            for p in [reg.readme, *reg.knob_docs]:
                p = Path(p)
                if p.is_file():
                    text.append(p.read_text())
            self._doc_cache[key] = "\n".join(text)
        return self._doc_cache[key]

    def check(self, sf: SourceFile, reg) -> list[Finding]:
        docs = self._doc_text(reg)
        out: list[Finding] = []
        for read in env_reads(sf, reg.knob_prefix):
            if read["via"] != "env-read":
                continue  # literals gate nothing; the inventory lists them
            # word-boundary match: SHERMAN_BENCH must not pass because
            # SHERMAN_BENCH_KEYS is documented (prefix collisions are
            # guaranteed in this namespace)
            if not re.search(rf"\b{re.escape(read['name'])}\b", docs):
                out.append(Finding(
                    rule=self.code, path=sf.rel, line=read["line"],
                    message=(f"env knob `{read['name']}` is read here but "
                             f"appears nowhere in {reg.readme} — run "
                             "`python -m sherman_tpu_torch.knobs --write` "
                             "and describe it"),
                    snippet=sf.snippet(read["line"])))
        return out


ALL_RULES: list[Rule] = [
    HostSyncInHotPath(), UntrackedPoolWrite(), BareStdlibRaise(),
    RetraceHazard(), AckBeforeFsync(), ObsHotAllocation(),
    UndocumentedKnob(),
]


def rule_catalog() -> list[tuple[str, str, str]]:
    """[(code, name, one-line lesson)] — feeds the README catalog."""
    return [(r.code, r.name, r.doc) for r in ALL_RULES]
