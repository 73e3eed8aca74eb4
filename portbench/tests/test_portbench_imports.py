"""Nothing under portbench/ imports JAX or the JAX package, and nothing of
the reference imports the program: top-level module names compared whole
(the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

from portbench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parent.parent


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "reference").rglob("*.py")):
        got = _imports(f) - {"__future__"}
        assert got <= {"numpy", "portbench"}, f"{f.name} imports {got}"
        assert "sherman_tpu_torch" not in got


def test_module_check_compares_whole_top_level_names():
    assert forbidden_modules(["sherman_tpu_torch", "sherman_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "sherman_tpu.ops", "flax",
                              "jaxlib"]) == ["flax", "jax.numpy", "jaxlib",
                                             "sherman_tpu.ops"]
