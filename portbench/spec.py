"""Finds everything by name: the benchmark's entries in ``BENCHMARK.json``
and, under the benchmark's folder, one file each:

- ``configs/<config>.json``: a configuration (a deployment: sizes,
  layout, guarantees), as run;
- ``traffic/<traffic>.json``: a traffic mix's parameters, read by the one
  generator (``portbench/gen.py``);
- ``workloads/<cell>.json``: a cell (its configuration and mix);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run) ->
  number | None``;
- ``e2e/<metric>.py``: an end-to-end metric's reader, the same.

A later change adds a configuration, mix, cell or metric by adding its
file and its entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, bench_path: Path | None = None,
                 root: Path | None = None):
        self.root = Path(root) if root is not None else HERE
        path = (Path(bench_path) if bench_path is not None
                else self.root.parent / "BENCHMARK.json")
        self.bench = json.loads(path.read_text())
        self._readers = {}

    def _load(self, sub: str, name: str) -> dict:
        return json.loads((self.root / sub / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        entry = next((w for w in self.bench["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        cell = self._load("workloads", name)
        for k in ("config", "traffic", "chips"):
            if cell[k] != entry[k]:
                raise ValueError(f"cell {name}: {k} is {cell[k]!r} in its "
                                 f"file and {entry[k]!r} in BENCHMARK.json")
        return {**cell, "name": name}

    def config(self, name: str) -> dict:
        return {**self._load("configs", name), "name": name}

    def traffic(self, name: str) -> dict:
        return {**self._load("traffic", name), "name": name}

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's metrics of one kind: end-to-end with ``trace``
        off, per-layer with it on (an entry without ``workloads``
        belongs to every cell)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: dict, trace: bool):
        sub = "metrics" if trace else "e2e"
        key = (sub, metric["name"])
        fn = self._readers.get(key)
        if fn is None:
            path = self.root / sub / f"{metric['name']}.py"
            mod_name = f"_portbench_{sub}_" + "".join(
                c if c.isalnum() else "_" for c in metric["name"])
            s = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(s)
            s.loader.exec_module(mod)
            fn = self._readers[key] = mod.read
        return fn
