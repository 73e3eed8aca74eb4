"""The benchmark's own tests (``python -m pytest portbench/tests -q``):
on the CPU at a tiny size, the card's only under the ``cuda`` marker."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
# 20,000 keys, 4,096-op batches: every width as configured, the scale cut
TINY = {"n_keys": 20_000, "batch": 4096, "pool_pages": 2048,
        "locks_per_node": 4096, "chunk_pages": 64}
TINY_TRAFFIC = {"ring_batches": 4, "warmup_batches": 2, "check_share": 1.0,
                "check_cap": 64}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where "
        "torch.cuda.is_available() is false")


def make_tiny(root: Path) -> Path:
    """A copy of the benchmark's data files under ``root/portbench`` with
    every configuration cut to :data:`TINY`, and ``root/BENCHMARK.json``
    with an entry for every cell file (those kept out of the benchmark's
    own list too, so that their path stays tested).  -> the copy's
    folder."""
    dst = root / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "e2e"):
        shutil.copytree(HERE / sub, dst / sub)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    for p in sorted((dst / "workloads").glob("*.json")):
        if p.stem not in listed:
            c = json.loads(p.read_text())
            bench["workloads"].append({"name": p.stem, "why": c["why"],
                                       **{k: c[k] for k in
                                          ("config", "traffic", "chips")}})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in (dst / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(TINY)
        p.write_text(json.dumps(c))
    for p in (dst / "traffic").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(TINY_TRAFFIC)
        p.write_text(json.dumps(c))
    return dst


@pytest.fixture
def tiny(tmp_path):
    from portbench.spec import Spec
    return Spec(root=make_tiny(tmp_path))
