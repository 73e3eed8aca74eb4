"""BENCHMARK.json keeps to the contract's shapes: keys, names, units,
bounds, files; every cell, configuration, mix and metric has its file."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT.parent / p).is_dir()
    assert len((ROOT.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metric_names = [m["name"] for k in ("end_to_end", "per_layer")
                    for m in BENCH[k]]
    assert len(metric_names) == len(set(metric_names))


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_and_another_e2e_and_a_layer_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in m.get("workloads",
                                                           [cell])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert layer
        for m in layer:
            assert m["moves"] in mine
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_name_has_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT.parent / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT.parent / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        cell = json.loads((ROOT / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips")} == \
            {k: w[k] for k in ("config", "traffic", "chips")}
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert (ROOT / "e2e" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_use_name_characters():
    ok = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for f in ROOT.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        assert ok.match(str(f.relative_to(ROOT.parent))), f
