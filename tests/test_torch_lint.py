"""The port's shermanlint (``sherman_tpu_torch/analysis``) against the JAX
package's (``sherman_tpu/analysis``), on the CPU.

(a) every fixture case of ``tests/test_lint.py`` through both linters
with equal registries: the same (rule, path, line, snippet) findings,
pragma errors, suppressions, baseline outcomes and CLI exit codes;
(b) the port's engine, given the reference's registry values and SL001
table, over the JAX tree: the reference's result; (c) the same knob
inventory over the JAX tree; (d) torch's additions to SL001; (e) the
port's tree lints clean with its empty baseline, its knob table is
fresh and every registry scope names a function of the port; (f) the
SL003 repairs raise the reference's ``AssertionError`` type; (g) the
bench's ``lint_clean`` stamp.  The whole-tree runs are module-scoped
fixtures, four in the file.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import sys
import textwrap
import types

import pytest

from sherman_tpu import analysis as RA
from sherman_tpu.analysis.core import SourceFile as RSourceFile
from sherman_tpu.analysis.rules import env_reads as r_env_reads
from sherman_tpu_torch import analysis as PA
from sherman_tpu_torch import knobs as PK
from sherman_tpu_torch import shermanlint as PL
from sherman_tpu_torch.analysis import registry as PREG
from sherman_tpu_torch.analysis.core import SourceFile as PSourceFile
from sherman_tpu_torch.analysis.rules import env_reads as p_env_reads

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TREE = ["sherman_tpu/", "tools/", "bench.py"]
REF_TABLE = dict(sync_attr_calls=set(PREG.REFERENCE_SYNC_ATTR_CALLS),
                 sync_dotted=set(PREG.REFERENCE_SYNC_DOTTED))


def _load_tool(name):
    """A reference tool of ``tools/`` loaded by path under its own name."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _base(**overrides):
    base = dict(
        hot_functions=[("fixture.py", "hot_fn")],
        static_roots={"cfg", "C"},
        pool_mutators={"mutate_pool"},
        dirty_allowlist=[("fixture.py", "blessed")],
        library_paths=["fixture.py"],
        jit_factory_patterns=["_get_*", "*_jit"],
        append_paths=[("fixture.py", "J.append")],
        obs_hot_functions=[("fixture.py", "Ctr.inc")],
        knob_doc_text="SHERMAN_DOCUMENTED is described here",
    )
    base.update(overrides)
    return base


def _regs(table=None, **overrides):
    """(reference registry, port registry) with equal values; the port's
    SL001 table is ``table`` (default: the reference's)."""
    base = _base(**overrides)
    return (RA.Registry(**base),
            PA.Registry(**base, **(REF_TABLE if table is None else table)))


def _outcome(res):
    return {
        "findings": sorted(f.key() for f in res.findings),
        "pragma_errors": sorted(f.key() for f in res.pragma_errors),
        "suppressed": sorted((f.key(), why) for f, why in res.suppressed),
        "baselined": sorted(f.key() for f in res.baselined),
        "baseline_errors": list(res.baseline_errors),
        "files_checked": res.files_checked,
        "clean": res.clean,
    }


def _both(tmp_path, src, name="fixture.py", **overrides):
    """Lint one fixture file with both packages -> (ref, port, port with
    torch's SL001 table) outcomes."""
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    r_reg, p_reg = _regs(**overrides)
    t_reg = _regs(table={}, **overrides)[1]
    return tuple(_outcome(mod.run([p], registry=reg, root=tmp_path))
                 for mod, reg in ((RA, r_reg), (PA, p_reg), (PA, t_reg)))


# ---------------------------------------------------------------------------
# (a) the reference's fixtures through both linters
# ---------------------------------------------------------------------------

# (case, source, registry overrides, the rules its findings carry)
FIXTURES = [
    ("sl001_violation", """
        import numpy as np
        def hot_fn(x, cfg):
            a = x.item()
            b = np.asarray(x)
            c = float(x[0])
            d = jax.device_get(x)
            return a, b, c, d
        """, {}, ["SL001"]),
    ("sl001_clean", """
        import jax.numpy as jnp
        def hot_fn(x, cfg):
            n = int(cfg.machine_nr)          # static config: fine
            w = float(x.shape[0])            # shapes are static: fine
            k = int(LEAF_CAP)                # module constant: fine
            return jnp.where(x > n, x, w + k)
        def cold_fn(x):
            return x.item()                  # not registered hot: fine
        """, {}, []),
    ("sl001_item_with_args", """
        def hot_fn(x, cfg):
            return x.item(0)
        """, {}, ["SL001"]),
    ("sl002_violation", """
        def composes(pool):
            return mutate_pool(pool)
        """, {}, ["SL002"]),
    ("sl002_clean", """
        def threaded(pool, *, dirty=None):
            return mutate_pool(pool, dirty)
        def blessed(pool):
            return mutate_pool(pool)
        def mutate_pool(pool, dirty=None):
            return pool
        """, {}, []),
    ("sl002_positional_surface", """
        def surface(pool, dirty):
            return mutate_pool(pool, dirty)
        """, {}, ["SL002"]),
    ("sl002_nested_positional", """
        def factory(pool):
            def kernel(pool, dirty):
                return mutate_pool(pool, dirty)
            return kernel
        """, {}, []),
    ("sl003_violation", """
        def f():
            raise ValueError("boom")
        def g():
            raise RuntimeError("boom")
        def h():
            raise AssertionError
        """, {}, ["SL003"]),
    ("sl003_typed_clean", """
        from sherman_tpu.errors import ConfigError
        def f():
            raise ConfigError("typed: fine")
        def g(e):
            raise  # re-raise: fine
        """, {}, []),
    ("sl003_out_of_scope", """
        def f():
            raise ValueError("tools code")
        """, {"library_paths": ["sherman_tpu/*"]}, []),
    ("sl004_violation", """
        def dispatch(self, pool):
            fn = self._get_search(4, True)
            return fn(pool, 3)
        def immediate(pool):
            return _install_pages_jit()(pool, 2.5)
        """, {}, ["SL004"]),
    ("sl004_clean", """
        import numpy as np
        def dispatch(self, pool, root):
            fn = self._get_search(4, True)
            return fn(pool, np.int32(root))
        """, {}, []),
    ("sl005_violation", """
        class J:
            def append(self, rec):
                self._f.write(rec)
                return len(rec)
        """, {}, ["SL005"]),
    ("sl005_clean", """
        import os
        class J:
            def append(self, rec):
                if not rec:
                    return 0          # nothing written: no ack to gate
                self._f.write(rec)
                if self.sync:
                    os.fsync(self._f.fileno())
                else:
                    self._commit(1)
                return len(rec)
        """, {}, []),
    ("sl006_violation", """
        class Ctr:
            def inc(self, n):
                self.tags = {"n": n}
                self.label = f"x{n}"
                self.parts = [str(n)]
        """, {}, ["SL006"]),
    ("sl006_clean", """
        class Ctr:
            def inc(self, n):
                self.value += n
                self.buckets[3] += n
        """, {}, []),
    ("sl007_violation", """
        import os
        def knobby():
            return os.environ.get("SHERMAN_UNDOCUMENTED", "1")
        """, {}, ["SL007"]),
    ("sl007_clean", """
        import os
        KNOB = "SHERMAN_DOCUMENTED"
        def a():
            return os.environ.get("SHERMAN_DOCUMENTED")
        def b():
            return os.environ.get(KNOB, "0")   # module-constant indirection
        def c(env="SHERMAN_NOT_A_READ"):
            return env                         # bare literal gates nothing
        """, {}, []),
    ("sl007_prefix_of_documented", """
        import os
        v = os.environ.get("SHERMAN_DOCU")
        """, {"knob_doc_text": "SHERMAN_DOCUMENTED only"}, ["SL007"]),
    ("pragma_with_reason", """
        def f():
            raise ValueError("x")  # shermanlint: disable=SL003 legacy shim
        """, {}, []),
    ("pragma_on_preceding_line", """
        def f():
            # shermanlint: disable=SL003 message spans the line below
            raise ValueError("x")
        """, {}, []),
    ("pragma_without_reason", """
        def f():
            raise ValueError("x")  # shermanlint: disable=SL003
        """, {}, ["SL003"]),
    ("pragma_wrong_rule", """
        def f():
            raise ValueError("x")  # shermanlint: disable=SL001 wrong rule
        """, {}, ["SL003"]),
    ("pragma_malformed_and_bad_code", """
        def f():
            x = 1  # shermanlint: enable=SL003 what
            y = 2  # shermanlint: disable=XX12 not a rule id
            return x + y
        """, {}, []),
]


@pytest.mark.parametrize("case,src,overrides,want",
                         FIXTURES, ids=[c[0] for c in FIXTURES])
def test_fixture_findings_match_reference(tmp_path, case, src, overrides,
                                          want):
    ref, port, port_torch = _both(tmp_path, src, **overrides)
    assert sorted({k[0] for k in ref["findings"]}) == want
    assert port == ref
    # torch's additions to SL001 change nothing on the reference's
    # fixtures, whose syncs are all in the reference's table
    assert port_torch == ref


def test_env_reads_inventory_matches_reference(tmp_path):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent("""
        import os
        K = "SHERMAN_BY_CONST"
        a = os.environ.get("SHERMAN_DIRECT", 42)
        b = os.getenv("SHERMAN_GETENV")
        c = os.environ["SHERMAN_REQUIRED"]
        d = os.environ.get(K)
        e = helper("SHERMAN_INDIRECT", 1.0)
        """))
    text = p.read_text()
    ref = r_env_reads(RSourceFile(p, "fixture.py", text), "SHERMAN_")
    port = p_env_reads(PSourceFile(p, "fixture.py", text), "SHERMAN_")
    assert port == ref
    reads = {r["name"]: r for r in port}
    assert reads["SHERMAN_DIRECT"]["default"] == "42"
    assert reads["SHERMAN_REQUIRED"]["default"] == "(required)"
    assert reads["SHERMAN_INDIRECT"]["via"] == "literal"


BASELINE_SRC = """
    def f():
        raise ValueError("grandfathered")
"""


def _baseline_case(mod, d, case):
    """One baseline scenario of ``tests/test_lint.py`` run with package
    ``mod`` in directory ``d`` -> its outcome."""
    p = d / "fixture.py"
    p.write_text(textwrap.dedent(BASELINE_SRC))
    reg = mod.Registry(**_base())
    bpath = d / "baseline.json"
    mod.write_baseline(bpath, mod.run([p], registry=reg, root=d).findings,
                       reason="pre-existing; fixed later")
    if case == "stale_line":
        p.write_text("x = 1\n" + textwrap.dedent(BASELINE_SRC))
    elif case == "fixed":
        p.write_text("def f():\n    return 0\n")
    return _outcome(mod.run([p], registry=reg,
                            baseline=mod.load_baseline(bpath), root=d))


@pytest.mark.parametrize("case", ["round_trip", "stale_line", "fixed"])
def test_baseline_contract_matches_reference(tmp_path, case):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = _baseline_case(RA, tmp_path / "r", case)
    port = _baseline_case(PA, tmp_path / "p", case)
    assert port == ref
    if case == "round_trip":
        assert port["clean"] and len(port["baselined"]) == 1
    else:
        assert port["baseline_errors"] and not port["clean"]


def test_baseline_entry_without_reason_refused_by_both(tmp_path):
    bpath = tmp_path / "baseline.json"
    bpath.write_text(json.dumps({
        "version": 1,
        "entries": [{"rule": "SL003", "path": "x.py", "line": 1,
                     "snippet": "raise ValueError()"}]}))
    for mod in (RA, PA):
        with pytest.raises(mod.BaselineError, match="reason"):
            mod.load_baseline(bpath)


def test_missing_and_empty_paths_are_errors_in_both(tmp_path):
    (tmp_path / "empty").mkdir()
    for target in (tmp_path / "no_such_dir", tmp_path / "empty"):
        ref = _outcome(RA.run([target], registry=RA.Registry(**_base()),
                              root=tmp_path))
        port = _outcome(PA.run([target], registry=PA.Registry(**_base()),
                               root=tmp_path))
        assert port == ref and not port["clean"]


def test_dot_directory_ancestor_still_lints(tmp_path):
    d = tmp_path / ".hidden" / "repo"
    d.mkdir(parents=True)
    (d / "x.py").write_text("x = 1\n")
    (d / ".skip").mkdir()
    (d / ".skip" / "y.py").write_text("y = 1\n")
    assert PA.iter_py_files([d]) == RA.iter_py_files([d]) == [d / "x.py"]


@pytest.mark.parametrize("case", ["undocumented_knob", "clean_file",
                                  "missing_path", "pragma_without_reason"])
def test_cli_exit_codes_match_reference(tmp_path, monkeypatch, capsys, case):
    ref_cli = _load_tool("shermanlint")
    monkeypatch.chdir(tmp_path)   # restored after the reference's chdir
    f = tmp_path / "cli.py"
    if case == "undocumented_knob":
        f.write_text("import os\n"
                     "v = os.environ.get('SHERMAN_NOPE_NOT_DOCUMENTED')\n")
    elif case == "clean_file":
        f.write_text("x = 1\n")
    elif case == "pragma_without_reason":
        f.write_text("x = 1  # shermanlint: disable=SL003\n")
    argv = [str(tmp_path / "absent" if case == "missing_path" else f),
            "--no-baseline"]
    rc_ref = ref_cli.main(argv)
    out_ref = capsys.readouterr().out
    rc_port = PL.main(argv)
    out_port = capsys.readouterr().out
    assert rc_port == rc_ref == {"undocumented_knob": 1, "clean_file": 0,
                                 "missing_path": 2,
                                 "pragma_without_reason": 2}[case]
    if case == "undocumented_knob":
        assert "SL007" in out_ref and "SL007" in out_port


def test_rule_catalog_and_readme():
    cat = PA.rule_catalog()
    assert [c for c, _, _ in cat] == [c for c, _, _ in RA.rule_catalog()]
    assert [n for _, n, _ in cat] == [n for _, n, _ in RA.rule_catalog()]
    readme = (REPO / "README.md").read_text()
    part = readme[readme.index("### Static analysis (the port)"):
                  readme.index(PK.BEGIN)]
    for code, name, _ in cat:
        assert f"`{code}` {name}" in part, code
    # the reference's table tool splices at its own markers only
    assert readme.index(_load_tool("knobs").BEGIN) > readme.index(PK.END)


# ---------------------------------------------------------------------------
# (b) the port's engine on the JAX tree, (c) the same knob inventory
# ---------------------------------------------------------------------------

def _anchored(reg):
    return dataclasses.replace(
        reg, readme=str(REPO / reg.readme),
        knob_docs=[str(REPO / d) for d in reg.knob_docs])


@pytest.fixture(scope="module")
def jax_tree_results():
    """The JAX tree linted by the reference, and by the port's engine with
    the reference's registry values and SL001 table."""
    ref_reg = _anchored(RA.DEFAULT_REGISTRY)
    port_reg = PA.Registry(
        **{f.name: getattr(ref_reg, f.name)
           for f in dataclasses.fields(ref_reg)}, **REF_TABLE)
    paths = [REPO / p for p in JAX_TREE]
    return (RA.run(paths, registry=ref_reg, root=REPO),
            PA.run(paths, registry=port_reg, root=REPO))


def test_port_engine_on_the_jax_tree_matches_reference(jax_tree_results):
    ref, port = jax_tree_results
    assert ref.files_checked > 50
    assert _outcome(port) == _outcome(ref)


def test_knob_inventory_of_the_jax_tree_matches_reference(monkeypatch):
    monkeypatch.chdir(REPO)       # the reference's default paths are cwd's
    ref = _load_tool("knobs").inventory()
    port = PK.inventory(JAX_TREE)
    assert port == ref and "SHERMAN_STAGED_FUSION" in port


# ---------------------------------------------------------------------------
# (d) torch's additions to SL001
# ---------------------------------------------------------------------------

TORCH_SYNCS = """
    import torch
    def hot_fn(x, cfg, stream):
        a = x.tolist()
        b = x.cpu()
        c = x.numpy()
        torch.cuda.synchronize()
        stream.synchronize()
        return a, b, c
"""

TORCH_CLEAN = """
    import torch
    def hot_fn(x, cfg):
        n = int(cfg.machine_nr)
        w = int(x.shape[0]) + x.ndim
        y = x.to(torch.int32).view(-1)
        return torch.where(y > n, y, w)
"""


def test_torch_syncs_are_sl001_findings(tmp_path):
    ref, port_ref_table, port = _both(tmp_path, TORCH_SYNCS)
    assert [k[2] for k in port["findings"]] == [4, 5, 6, 7, 8]
    assert {k[0] for k in port["findings"]} == {"SL001"}
    # the reference's table sees none of them
    assert ref["findings"] == port_ref_table["findings"] == []


def test_torch_static_reads_are_clean(tmp_path):
    for out in _both(tmp_path, TORCH_CLEAN):
        assert out["findings"] == []


def test_port_registry_holds_torch_sync_table():
    reg = PA.DEFAULT_REGISTRY
    assert {"item", "tolist", "cpu", "numpy", "synchronize"} \
        <= reg.sync_attr_calls
    assert "torch.cuda.synchronize" in reg.sync_dotted
    assert PREG.REFERENCE_SYNC_DOTTED <= reg.sync_dotted


# ---------------------------------------------------------------------------
# (e) the port's tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_tree_cli():
    """``python -m sherman_tpu_torch.shermanlint --json`` on the committed
    tree, from another working directory -> (exit code, its JSON)."""
    import contextlib
    import io
    buf = io.StringIO()
    cwd = os.getcwd()
    try:
        os.chdir(REPO / "tests")
        with contextlib.redirect_stdout(buf):
            rc = PL.main(["--json"])
    finally:
        os.chdir(cwd)
    return rc, json.loads(buf.getvalue())


def test_port_tree_lints_clean_with_empty_baseline(port_tree_cli):
    rc, out = port_tree_cli
    assert rc == 0 and out["clean"]
    assert out["files_checked"] > 80
    assert out["findings"] == out["pragma_errors"] == []
    assert out["baseline_errors"] == [] and out["baselined"] == 0
    assert all(s["reason"].strip() for s in out["suppressed_sites"])
    data = json.loads(PL.DEFAULT_BASELINE.read_text())
    assert data == {"version": 1, "entries": []}


def test_launch_wrappers_carry_no_excused_sync(port_tree_cli):
    """A pragma in a K1-K4 launch wrapper may only excuse ``int()`` of a
    Python int, never a sync call."""
    wrappers = {q for p, q in PA.DEFAULT_REGISTRY.hot_functions
                if p.endswith(("ops/page_kernels.py",
                               "parallel/transport_kernel.py"))}
    assert {"descent_round", "gather_pages", "read_pages_local",
            "writeback", "block_transpose", "all_to_all"} <= wrappers
    excused = [s for s in port_tree_cli[1]["suppressed_sites"]
               if any(f"hot function `{w}`" in s["message"]
                      for w in wrappers)]
    assert excused
    for s in excused:
        assert s["message"].startswith("`int(...)`"), s


@functools.lru_cache(maxsize=None)
def _port_functions(rel: str) -> list[str]:
    p = REPO / rel
    sf = PSourceFile(p, rel, p.read_text())
    return [sf.qualname(fn) for fn in sf.functions()]


def test_every_registry_scope_matches_a_port_function():
    import fnmatch
    reg = PA.DEFAULT_REGISTRY
    files = {f.resolve().relative_to(REPO).as_posix()
             for f in PA.iter_py_files([REPO / p for p in PL.DEFAULT_PATHS])}
    for field in ("hot_functions", "append_paths", "obs_hot_functions",
                  "dirty_allowlist"):
        for pp, qp in getattr(reg, field):
            hits = [f for f in files if fnmatch.fnmatch(f, pp)]
            assert hits, (field, pp)
            assert any(fnmatch.fnmatch(q, qp)
                       for f in hits for q in _port_functions(f)), \
                (field, pp, qp)
    for pat in reg.library_paths:
        assert any(fnmatch.fnmatch(f, pat) for f in files), pat
    defined = {q.rsplit(".", 1)[-1] for f in files
               if f.startswith("sherman_tpu_torch/")
               for q in _port_functions(f)}
    assert reg.pool_mutators <= defined
    # the command-line tools are left out of SL003, as the reference's
    # tools/ are
    tools = ("bench.py", "ycsb_bench.py", "failover_drill.py",
             "profile_prep.py", "tools_common.py", "shermanlint.py",
             "knobs.py")
    for d in tools:
        assert not any(fnmatch.fnmatch(f"sherman_tpu_torch/{d}", pat)
                       for pat in reg.library_paths), d


def test_port_knob_table_is_fresh(capsys):
    assert PK.main(["--check"]) == 0
    assert "README port table fresh" in capsys.readouterr().out
    readme = (REPO / "README.md").read_text()
    table = readme[readme.index(PK.BEGIN):readme.index(PK.END)]
    assert "`SHERMAN_STAGED_FUSION`" in table and "`chip_smoke.py:" in table


# ---------------------------------------------------------------------------
# (f) the SL003 repairs raise the reference's AssertionError type
# ---------------------------------------------------------------------------

def test_sl003_repairs_raise_the_reference_type():
    from sherman_tpu import config as JC
    from sherman_tpu.models import batched as JB
    from sherman_tpu.models import router as JR
    from sherman_tpu.ops import bits as JBits
    from sherman_tpu.workload import zipf as JZ
    from sherman_tpu_torch import errors as E
    from sherman_tpu_torch.models import batched as TB
    from sherman_tpu_torch.models import router as TR
    from sherman_tpu_torch.ops import bits as TBits
    from sherman_tpu_torch.workload import zipf as TZ

    eng = types.SimpleNamespace(tree=None, cfg=None, router=None)
    past = [(1, JC.KEY_POS_INF + 1)]
    cases = [
        (lambda: JR.LeafRouter(None, 0), lambda: TR.LeafRouter(None, 0)),
        (lambda: JBits.lease_word(0), lambda: TBits.lease_word(0)),
        (lambda: JZ.ZipfGen(0), lambda: TZ.ZipfGen(0)),
        (lambda: JB.range_query_many(eng, past),
         lambda: TB.range_query_many(eng, past)),
    ]
    for ref, port in cases:
        with pytest.raises(AssertionError):
            ref()
        with pytest.raises(AssertionError) as got:
            port()
        assert isinstance(got.value, E.ShermanError)
    for cls in (E.PreconditionError, E.InvariantError):
        assert issubclass(cls, AssertionError)
        assert issubclass(cls, E.ShermanError)
    assert issubclass(E.PreconditionError, ValueError)
    assert issubclass(PA.BaselineError, E.ShermanError)


def test_exchange_field_shapes_raise_assertion_type():
    import torch
    from sherman_tpu_torch import errors as E
    from sherman_tpu_torch.parallel import transport as T
    fields = {"a": torch.zeros((2, 4), dtype=torch.int32),
              "b": torch.zeros((2, 6), dtype=torch.int32)}
    with pytest.raises(AssertionError) as got:
        T.exchange(fields)
    assert isinstance(got.value, E.PreconditionError)


# ---------------------------------------------------------------------------
# (g) the bench's stamp
# ---------------------------------------------------------------------------

def test_bench_stamps_lint_clean():
    from sherman_tpu_torch import bench
    assert bench._lint_clean() is True
    src = (REPO / "sherman_tpu_torch" / "bench.py").read_text()
    assert '"lint_clean": _lint_clean()' in src


def test_linter_imports_neither_torch_nor_jax():
    """The analysis package, the CLI and the knob tool import the stdlib
    and each other only."""
    import ast
    allowed = {"sherman_tpu_torch", "__future__", "argparse", "ast",
               "collections", "dataclasses", "fnmatch", "io", "json", "re",
               "sys", "tokenize", "pathlib"}
    files = [*(REPO / "sherman_tpu_torch" / "analysis").glob("*.py"),
             REPO / "sherman_tpu_torch" / "shermanlint.py",
             REPO / "sherman_tpu_torch" / "knobs.py",
             REPO / "sherman_tpu_torch" / "errors.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in allowed, (f.name, n)
    assert sys.modules.get("sherman_tpu_torch.analysis") is not None
