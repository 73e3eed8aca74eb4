"""The roofline byte functions are ``chip_smoke.py``'s bound arithmetic:
its ``nbytes`` expressions, read from its source, give the same bytes at
shapes its kernel table recorded (PR 21's proof run, H100)."""

import ast
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import roofline

SMOKE = Path(__file__).resolve().parent.parent.parent / "chip_smoke.py"
C = SimpleNamespace(PAGE_BYTES=roofline.PAGE_BYTES)


def _nbytes(fn_name: str):
    tree = ast.parse(SMOKE.read_text())
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
              and f.name == fn_name)
    expr = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "nbytes")
    code = compile(ast.Expression(expr), str(SMOKE), "eval")
    return lambda **kw: eval(code, {"C": C}, kw)


# (rows, active rows, distinct pages, the recorded bytes)
K1 = [(4194304, 1509671, 1170781, 1288298964),
      (262144, 73105, 72405, 79476428)]
# (rows, distinct pages, masked, the recorded bytes)
K2 = [(1048576, 420999, False, 1509039104),
      (262144, 238724, False, 513937408)]
# (rows, lanes, applied rows, the recorded bytes)
K3 = [(1048576, 5, 247337, 12920752), (262144, 3, 249314, 8240192)]


@pytest.mark.parametrize("rows,active,pages,recorded", K1)
def test_k1_bytes(rows, active, pages, recorded):
    smoke = _nbytes("replay_descent_round")(B=rows, n_act=active,
                                            pages=pages)
    assert roofline.k1_bytes(rows, active, pages) == smoke == recorded


@pytest.mark.parametrize("rows,pages,masked,recorded", K2)
def test_k2_bytes(rows, pages, masked, recorded):
    smoke = _nbytes("replay_gather_pages")(M=rows, pages=pages,
                                           ok=object() if masked else None)
    assert roofline.k2_bytes(rows, pages, masked) == smoke == recorded


def test_k2_counts_padding_rows_by_their_index_only():
    full = roofline.k2_bytes(4096, 100)
    assert roofline.k2_bytes(4096, 100, written=4096) == full
    assert full - roofline.k2_bytes(4096, 100, written=96) \
        == 4000 * roofline.PAGE_BYTES


@pytest.mark.parametrize("rows,lanes,applied,recorded", K3)
def test_k3_bytes(rows, lanes, applied, recorded):
    smoke = _nbytes("replay_writeback")(M=rows, L=lanes, n_app=applied)
    assert roofline.k3_bytes(rows, applied, lanes) == smoke == recorded


def test_peak_is_the_data_sheets():
    assert roofline.peak("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError):
        roofline.peak("cpu")
