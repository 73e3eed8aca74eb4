"""The port's profilers and device report (``sherman_tpu_torch/
profile_gather.py``, ``profile_insert.py``, ``profile_prep.py``,
``profile_staged2.py``, ``device_report.py``) against the JAX package's
(``tools/profile_*.py``, ``tools/device_report.py``) on the CPU at small
sizes: the receipts' shapes (phases, impls, programs, modes) and every
count in them (the write-combining groups, the sealed loop's retraces, the
staged receipts) exactly equal; times are compared by presence.  The
reference's "pallas vs xla" columns are the port's "kernel vs twin" (and
"library"); ``chained`` and ``fused`` are refused with ``ConfigError``.
"""

import json
import os
import sys

import pytest
import torch

from sherman_tpu_torch import obs
from sherman_tpu_torch import profile_gather as PG
from sherman_tpu_torch import profile_insert as PI
from sherman_tpu_torch import profile_prep as PP
from sherman_tpu_torch import profile_staged2 as PS
from sherman_tpu_torch import device_report as DR

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

STAGED_ENV = (("KEYS", "20000"), ("B", "8192"), ("DEVB", "8192"),
              ("K", "2"), ("STEPS", "4"), ("W", "2"), ("FUSION", "aligned"))


def _last(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_gather_matches_jax(eight_devices, capsys):
    import profile_gather as JPG
    argv = ["--rows", "1024", "--keys", "2000", "--k", "1"]
    want = JPG.main(argv)
    capsys.readouterr()
    got = PG.main(argv + ["--device", "cpu"])
    assert _last(capsys) == got
    assert set(got["phases"]) == set(want["phases"])
    assert got["kernel_on_card"] is False and want["pallas_interpreted"]
    for ph, by in got["phases"].items():
        assert {"twin", "kernel", "ratio"} <= set(by), ph
        assert ("library" in by) == (ph != "descent_round")
        for impl in ("twin", "kernel"):
            h = obs.snapshot()[f"kernels.{ph}_{impl}_ms"]
            assert h["count"] >= 1
    # the writes went to a copy: the tree is intact
    assert got["rows"] == 1024


def test_profile_gather_impls_subset(capsys):
    got = PG.main(["--rows", "256", "--keys", "2000", "--k", "1",
                   "--impls", "kernel", "--device", "cpu"])
    capsys.readouterr()
    assert all(set(by) == {"kernel"} for by in got["phases"].values())
    with pytest.raises(SystemExit):
        PG.main(["--impls", "pallas", "--device", "cpu"])


def test_profile_insert_matches_jax(eight_devices, capsys):
    import profile_insert as JPI
    argv = ["--rows", "1024", "--keys", "2000", "--k", "1"]
    want = JPI.main(argv)
    capsys.readouterr()
    got = PI.main(argv + ["--device", "cpu"])
    assert _last(capsys) == got
    assert set(got) - {"metric", "rows", "keys"} == set(want)
    assert got["insert_step_update_only"] > 0


def test_profile_prep_matches_jax(eight_devices, capsys, monkeypatch):
    import profile_prep as JPP
    for k, v in (("KEYS", "4000"), ("W", "512"), ("K", "2"), ("DUP", "8")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", ["profile_prep.py"])
    want = JPP.main()
    capsys.readouterr()
    got = PP.main(["--device", "cpu"])
    assert _last(capsys) == got
    assert got["combine"] == want["combine"]
    assert got["combine"]["locks_saved"] > 0
    for k in ("metric", "keys", "width", "reps"):
        assert got[k] == want[k], k
    for impl in ("host", "device"):
        assert got["impls"][impl]["phase_key"] == \
            want["impls"][impl]["phase_key"]
        assert got["impls"][impl]["step_ms"] > 0


def test_profile_prep_stages(capsys, monkeypatch):
    for k, v in (("KEYS", "20000"), ("B", "4096"), ("DEVB", "4096"),
                 ("K", "2"), ("RT", "4096")):
        monkeypatch.setenv(k, v)
    got = PP.main(["--stages", "--device", "cpu"])
    assert _last(capsys) == got
    assert list(got["stages"]) == [
        "prng(2xB)", "+zipf gather", "+mix64", "+pair sort",
        "+flag compact", "+router probe", "ranksort FULL"]


@pytest.mark.parametrize("modes", [None, "aligned,pipelined,aligned+cache"])
def test_profile_staged2_matches_jax(eight_devices, capsys, monkeypatch,
                                     modes):
    import profile_staged2 as JPS
    for k, v in STAGED_ENV:
        monkeypatch.setenv(k, v)
    if modes:
        monkeypatch.setenv("MODES", modes)
    monkeypatch.setattr(sys, "argv", ["profile_staged2.py"])
    want = JPS.main()
    capsys.readouterr()
    got = PS.main(["--device", "cpu"])
    assert _last(capsys)["phase_ms"] == got["phase_ms"]
    for k in ("metric", "fusion", "sampler", "n_programs", "pipeline_depth",
              "keys", "batch", "dev_b", "window", "delta_reps"):
        assert got[k] == want[k], k
    assert set(got["phase_ms"]) == set(want["phase_ms"])
    assert set(got["modes"]) == set(want["modes"])
    for m, row in got["modes"].items():
        assert set(row) == set(want["modes"][m]), m
    assert got["serve_host_staged_ms"] > 0 and got["full_step_ms"] > 0


@pytest.mark.parametrize("fusion", ["chained", "fused"])
def test_profile_staged2_refuses_the_xla_forms(capsys, monkeypatch, fusion):
    from sherman_tpu_torch.errors import ConfigError
    monkeypatch.setenv("KEYS", "2000")
    with pytest.raises(ConfigError, match="XLA program-structure form"):
        PS.main([fusion, "--device", "cpu"])
    r = _last(capsys)
    assert r["fusion"] == fusion and r["refused"].startswith("ConfigError")


def test_device_report_matches_jax(eight_devices, capsys, monkeypatch,
                                   tmp_path):
    import importlib

    import device_report as JDR
    # the reference's print_tables binds sys.stderr when its module is
    # imported: import it afresh, so that it writes to this test's stream
    # and not to one an earlier test in this process closed
    JDR = importlib.reload(JDR)
    for k, v in STAGED_ENV:
        if k not in ("W",):
            monkeypatch.setenv(k, v)
    want = JDR.main([])
    capsys.readouterr()
    got = DR.main(["--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == got
    for k in ("metric", "fusion", "keys", "batch", "steps", "retraces",
              "cache"):
        assert got[k] == want[k], k
    assert got["retraces"] == 0
    led, jled = got["device"]["ledger"], want["device"]["ledger"]
    assert led["retraces"] == 0 == jled["retraces"]
    assert {e["label"] for e in led["entries"]} == {
        "staged.prep", "staged.verify", "engine.search_fanout"}
    roofs = got["device"]["rooflines"]["staged"]
    assert set(roofs) == set(want["device"]["rooflines"]["staged"])
    for rec in roofs.values():
        assert rec["program"] and rec["wall_ms"] >= 0
        assert rec["available"] is False     # no invented byte counts
    assert "# roofline receipts [staged]" in out.err
    assert "unavailable" in out.err
    assert got["device"]["memory"]["hbm_pool_bytes"] > 0

    # receipt mode: a wrapped receipt round-trips; an old one is a typed
    # error, the reference's text
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"n": 99, "parsed": {
        "schema_version": 3, "device": got["device"]}}))
    r2 = DR.main(["--receipt", str(p)])
    assert r2["retraces"] == 0 and r2["schema_version"] == 3
    assert "# compile ledger" in capsys.readouterr().err
    p2 = tmp_path / "old.json"
    p2.write_text(json.dumps({"schema_version": 2, "value": 1}))
    r3 = DR.main(["--receipt", str(p2)])
    j3 = JDR.main(["--receipt", str(p2)])
    capsys.readouterr()
    assert r3["error"] == j3["error"] and "no device section" in r3["error"]
