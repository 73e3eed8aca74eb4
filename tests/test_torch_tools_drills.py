"""The port's chaos and recovery drills (``sherman_tpu_torch/
chaos_drill.py``, ``recovery_drill.py``; ``python -m sherman_tpu_torch.bench
--chaos-drill`` / ``--recovery-drill``) against the JAX package's
(``tools/chaos_drill.py``, ``tools/recovery_drill.py``) on the CPU at 2,500
keys on 4 nodes: every deterministic receipt field (revocations, the typed
lock timeouts, the scrub's classes, the degraded reason, the restored
structure, the replay counts, RPO 0, the repaired pages) exactly equal;
times, paths and compressed sizes held by presence.  Also: every driver of
the port exits 2 without a card unless given ``--device cpu``.
"""

import importlib
import json
import os
import sys

import pytest
import torch

from sherman_tpu_torch import bench
from sherman_tpu_torch import chaos_drill as CD
from sherman_tpu_torch import obs
from sherman_tpu_torch import recovery_drill as RD

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

ARGV = ["--keys", "2500", "--nodes", "4"]


@pytest.fixture
def fresh_obs():
    """Both packages' recorders and registries reset around a drill."""
    import sherman_tpu.obs as jobs
    for m in (obs, jobs):
        m.get_recorder().clear()
    yield
    for m in (obs, jobs):
        m.get_recorder().clear()


def test_chaos_drill_matches_jax(eight_devices, capsys, fresh_obs,
                                 tmp_path, monkeypatch):
    import chaos_drill as JCD
    monkeypatch.setenv("SHERMAN_BLACKBOX_DIR", str(tmp_path / "bb"))
    want = JCD.main(ARGV)
    got = CD.main(ARGV + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert err.count("CHAOS-DRILL PASS") == 2
    assert got["ok"] and want["ok"]
    for k in ("seed", "host_revoked", "engine_revoked", "engine_insert",
              "lock_timeouts", "scrub", "degraded_reason",
              "degraded_reads_served", "restored", "chaos_injected"):
        assert got[k] == want[k], k
    assert got["lock_timeouts"] == 4
    assert got["blackbox"]["ordered"] and os.path.exists(
        got["blackbox"]["path"])
    o = got["blackbox"]["order"]
    assert o["inject"] < o["degraded"] < o["restore"]


def test_recovery_drill_matches_jax(eight_devices, capsys, fresh_obs):
    import recovery_drill as JRD
    want = JRD.main(ARGV)
    got = RD.main(ARGV + ["--device", "cpu"])
    assert capsys.readouterr().err.count("RECOVERY-DRILL PASS") == 2
    assert got["ok"] and got["rpo_ops"] == 0 == want["rpo_ops"]
    for k in ("seed", "group_commit_ms", "chain"):
        assert got[k] == want[k], k
    assert got["delta1"]["pages"] == want["delta1"]["pages"]
    assert got["recover"]["replay"] == want["recover"]["replay"]
    assert got["recover"]["chain"]["deltas"] == \
        want["recover"]["chain"]["deltas"]
    for k in ("replayed_records", "replayed_rows", "truncated_tails",
              "appends"):
        assert got["journal"][k] == want["journal"][k], k
    assert got["journal"]["appends"] >= got["journal"]["fsyncs"] > 0
    for k in ("pages", "replayed"):
        assert got["repair"][k] == want["repair"][k], k
    assert got["rto_ms"] > 0 and got["repair"]["repair_ms"] > 0


def test_bench_forwards_the_drills(capsys, fresh_obs, tmp_path,
                                   monkeypatch):
    """``bench --chaos-drill`` / ``--recovery-drill`` run the drills with
    their own arguments and JSON lines."""
    monkeypatch.setenv("SHERMAN_RECOVERY_RECEIPT", str(tmp_path / "r.json"))
    argv = ["--keys", "1200", "--nodes", "2", "--device", "cpu"]
    assert bench.main(["--chaos-drill"] + argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "metric"] == "chaos_drill"
    assert bench.main(["--recovery-drill"] + argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    r = json.loads(line)
    assert r["metric"] == "recovery_drill" and r["rpo_ops"] == 0
    assert (tmp_path / "r.json").read_text().strip() == line


DRIVERS = [
    ("insert_bench", []), ("churn_bench", []), ("chaos_drill", []),
    ("recovery_drill", []), ("tree_test", ["2"]), ("write_test", ["8"]),
    ("benchmark", ["8", "50", "26"]), ("latency_bench", []),
    ("profile_gather", []), ("profile_insert", []), ("profile_prep", []),
    ("profile_staged2", ["aligned"]), ("device_report", []),
]


@pytest.mark.parametrize("name,argv", DRIVERS)
def test_drivers_exit_2_without_a_card(monkeypatch, capsys, name, argv):
    """No CUDA device and no ``--device cpu``: exit 2 before any work, on
    one node or N (never a CPU mesh in place of the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"sherman_tpu_torch.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", [n for n, _ in DRIVERS] + [
    "skiplist_test"])
def test_drivers_dispatch_as_modules(name):
    """Each driver runs as ``python -m sherman_tpu_torch.<driver>``: its
    ``main(argv)`` returns the receipt dict, and its ``__main__`` block
    hands it to ``run_cli``."""
    import inspect
    mod = importlib.import_module(f"sherman_tpu_torch.{name}")
    src = inspect.getsource(mod)
    assert 'if __name__ == "__main__":\n    sys.exit(TC.run_cli(main))' \
        in src
    assert inspect.signature(mod.main).parameters["argv"].default is None
