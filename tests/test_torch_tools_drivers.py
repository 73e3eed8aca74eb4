"""The port's ``test/*.cpp`` parity drivers and its YCSB-style benchmark
driver (``sherman_tpu_torch/tree_test.py``, ``write_test.py``,
``skiplist_test.py``, ``benchmark.py``) against the JAX package's
(``tools/tree_test.py``, ...) on the CPU at small sizes: the tree's
structure and the host path, the read accounting and every op counter of
the upsert pass, the skiplist's answers, and the DSM op counters of the
benchmark's transport drill exactly equal; the benchmark's windows held to
the reference tests' pins (throughput is a time, compared by presence).
"""

import ast
import json
import os
import signal
import sys
import threading

import pytest
import torch

from sherman_tpu_torch import benchmark as BM
from sherman_tpu_torch import skiplist_test as SK
from sherman_tpu_torch import tree_test as TT
from sherman_tpu_torch import write_test as WT

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)


def _lines(out: str, *drop) -> list:
    """Stdout lines without the ones that carry a time."""
    return [x for x in out.strip().splitlines()
            if not any(d in x for d in drop)]


@pytest.mark.parametrize("argv", [["1", "--n", "600"], ["4", "--n", "2000"]])
def test_tree_test_matches_jax(eight_devices, capsys, argv):
    import tree_test as JTT
    JTT.main(argv)
    want = capsys.readouterr().out
    got = TT.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got["ok"] and f"tree_test PASS ({got['keys']} keys" in out
    # the same lines but for the timer's: overwrite, delete, structure
    assert _lines(out, "insert+overwrite") == _lines(want, "insert+overwrite")
    line = next(x for x in out.splitlines() if x.startswith("structure:"))
    assert ast.literal_eval(line.split(":", 1)[1].strip()) == \
        got["structure"]
    hp = next(x for x in want.splitlines() if "insert+overwrite" in x)
    assert f"host_path={got['host_path']})" in hp


@pytest.mark.parametrize("argv", [["1", "--n", "2000", "--batch", "1024"],
                                  ["2", "--n", "3000", "--batch", "1024"]])
def test_write_test_matches_jax(eight_devices, capsys, argv):
    import write_test as JWT
    JWT.main(argv)
    want = capsys.readouterr().out
    got = WT.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got["ok"] and "write_test PASS" in out
    # read accounting, every counter of the upsert pass and the write
    # amplification line equal; the rates and the lock round trip are times
    timed = ("upserts in", "lock_bench")
    assert _lines(out, *timed) == _lines(want, *timed)
    assert 0 < got["write_amplification_b"] < 1024


def test_skiplist_test_matches_jax(capsys):
    import skiplist_test as JSK
    JSK.main(["--inserts", "2000", "--seeks", "200"])
    assert "skiplist_test PASS" in capsys.readouterr().out
    got = SK.main(["--inserts", "2000", "--seeks", "200"])
    assert got["ok"] and "skiplist_test PASS" in capsys.readouterr().out
    assert got["insert_ns"] > 0 and got["seek_ns"] > 0


def test_benchmark_transport_drill_matches_jax(eight_devices):
    """``--exchange pallas``'s engine drill: the port's DSM counters (on
    the CPU, K4's twin) equal the JAX package's on its XLA exchange."""
    import benchmark as JBM
    want = JBM.exchange_counter_diff(2)["xla"]
    got = BM.exchange_counter_diff(2, "cpu")
    assert got["device"] == got["cpu"] == want
    assert not any(got["diff"].values())


BENCH = ["--keys", "20000", "--secs", "1", "--ops-per-coro", "8",
         "--window", "0.5", "--device", "cpu"]


@pytest.mark.parametrize("argv,says", [
    (["2", "50", "1"], "cluster tp"),
    (["1", "0", "1"], "cluster tp"),
    (["1", "100", "1", "--combine", "on"], "combine"),
    (["1", "50", "1", "--combine", "on"], "fan-out"),
    (["4", "100", "1", "--combine", "on"], "in-step fan-out"),
    (["4", "95", "1"], "cluster tp"),
    (["4", "50", "1", "--scans", "2", "--scan-span", "50"], "scans 2 x"),
])
def test_benchmark_driver(capsys, argv, says):
    """The reference tests' cases (tests/test_tools.py), each with its
    pin."""
    r = BM.main(argv + BENCH)
    assert r["peak_ops"] > 0 and len(r["windows"]) == 2
    assert says in capsys.readouterr().out


def test_benchmark_exchange_choices(capsys):
    r = BM.main(["1", "100", "1", "--keys", "5000", "--secs", "1",
                 "--exchange", "pallas", "--device", "cpu"])
    assert "skipped" in r and "multi-device" in r["skipped"]
    r = BM.main(["2", "100", "1", "--keys", "5000", "--secs", "1",
                 "--ops-per-coro", "4", "--exchange", "pallas",
                 "--device", "cpu"])
    assert r["peak_ops"] > 0
    assert "counter diff vs xla: none (exact match)" in \
        capsys.readouterr().out


def test_benchmark_percentiles_every_third_window(capsys):
    r = BM.main(["1", "95", "1", "--keys", "20000", "--secs", "1.5",
                 "--window", "0.5", "--ops-per-coro", "8", "--device",
                 "cpu"])
    assert len(r["windows"]) == 3
    (lat,) = r["latency_us"]
    assert lat["window"] == 2 and "lat(us)" in capsys.readouterr().out


def test_benchmark_preemption_checkpoints(capsys, tmp_path):
    """``--preempt-ckpt``: a SIGTERM mid-run checkpoints the cluster at the
    next block boundary and stops; the checkpoint restores."""
    from sherman_tpu_torch.utils import checkpoint as CK
    path = str(tmp_path / "pre.npz")
    prev = signal.getsignal(signal.SIGTERM)
    t = threading.Timer(1.0, os.kill, (os.getpid(), signal.SIGTERM))
    t.start()
    try:
        r = BM.main(["1", "50", "1", "--keys", "20000", "--secs", "30",
                     "--window", "0.5", "--ops-per-coro", "8",
                     "--preempt-ckpt", path, "--device", "cpu"])
    finally:
        t.cancel()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert r["preempted"] and len(r["windows"]) < 60
    assert "preemption notice: checkpointed" in capsys.readouterr().out
    cluster = CK.restore(path, device="cpu")
    assert cluster.cfg.machine_nr == 1


def test_utils_and_common_match_jax(capsys):
    """``utils`` (Timer, the leveled log, spin_sleep_ns) and
    ``tools_common`` (pages_for_keys, the keyspace) against the JAX
    package's ``utils`` and ``tools/common.py``."""
    import numpy as np

    import common as JC
    from sherman_tpu import utils as JU
    from sherman_tpu_torch import tools_common as TC
    from sherman_tpu_torch import utils as U
    from sherman_tpu_torch.utils.timer import device_ms
    assert set(JU.__all__) - {"StepTrace", "SpanTracer", "device_trace"} \
        <= set(U.__all__)
    for m in (JU, U):
        m.set_level("debug")
        m.notify_info("a %d", 1)
        m.debug_item("b %s", "x")
        m.set_level("error")
        m.notify_info("hidden")
        m.notify_error("c")
        m.set_level("info")
        t = m.Timer()
        t.begin()
        m.spin_sleep_ns(200_000)
        assert t.end() >= 200_000 and t.end_us(2) >= 100
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert lines[:2] == lines[2:] == ["a 1", "b x"]
    assert out.err.splitlines() == ["c", "c"]
    for n, f in ((1, 0.75), (10_239, 0.75), (2_000_000, 0.9)):
        assert TC.pages_for_keys(n, f) == JC.pages_for_keys(n, f)
    rng = np.random.default_rng(7)
    want = np.unique(rng.integers(1, 1 << 63, 1050, dtype=np.uint64))[:1000]
    np.testing.assert_array_equal(TC.unique_keys(1000, 7), want)
    assert device_ms(lambda: None, "cpu", reps=3) >= 0
