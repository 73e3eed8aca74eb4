"""The harness's pieces at a tiny size on the CPU: cells, metrics and
readers found by name (a dummy cell added from files alone), the ring,
the comparison, the metric arithmetic, and the result line's keys."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from portbench import harness, readers, roofline, run, trace
from portbench.spec import Spec

REPO = Path(__file__).resolve().parent.parent.parent
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def test_result_line_has_the_contracts_keys(tiny):
    out = harness.run_cell(tiny, "ycsb-100m.c-zipf", 11, 0.3, False, "cpu",
                           t_start=time.perf_counter())
    line = run.assemble(out, "NVIDIA H100 80GB HBM3", 1)
    assert set(line) == LINE_KEYS and list(line)[-1] == "check"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"ops_s", "batch_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.loads(json.dumps(line))


def test_traced_line_has_busy_window_and_breakdown(tiny):
    out = harness.run_cell(tiny, "ycsb-100m.a-zipf", 12, 0.3, True, "cpu",
                           t_start=time.perf_counter())
    line = run.assemble(out, "x", 1)
    assert set(line) == LINE_KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # the CPU has no device activity, no kernel launches: the readers
    # of launches and rooflines find nothing and are left out
    assert set(line["metrics"]) == {"device.idle_share"}


def test_a_cell_added_from_files_alone(tmp_path):
    from portbench.tests.conftest import make_tiny
    root = make_tiny(tmp_path)
    (root / "traffic" / "b-zipf.json").write_text(json.dumps({
        "entry": "mixed", "read_proportion": 0.95,
        "update_proportion": 0.05, "request_distribution": "zipfian",
        "zipf_theta": 0.99, "ring_batches": 3, "warmup_batches": 1,
        "check_share": 0.5, "check_cap": 16}))
    (root / "workloads" / "ycsb-100m.b-zipf.json").write_text(json.dumps(
        {"config": "ycsb-100m", "traffic": "b-zipf", "chips": 1}))
    (root / "metrics" / "dummy.update_share.py").write_text(
        "def read(run):\n"
        "    return 100.0 * run['window'].ops / max(run['window'].ops, 1)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ycsb-100m.b-zipf",
                               "config": "ycsb-100m", "traffic": "b-zipf",
                               "chips": 1, "why": "YCSB-B"})
    bench["per_layer"].append({"name": "dummy.update_share", "unit": "%",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "client entry and request prep",
                               "moves": "ops_s",
                               "workloads": ["ycsb-100m.b-zipf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root=root)
    out = harness.run_cell(spec, "ycsb-100m.b-zipf", 5, 0.3, True, "cpu",
                           t_start=time.perf_counter())
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["dummy.update_share"]["value"] == 100.0


def test_the_command_without_a_card_fails_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sherman-64m-8mn.a-zipf", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": "/tmp"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_counter_delta_wraps_per_node():
    b = {"dsm.read_pages": np.array([2**32 - 5, 10]), "kernels.x": 3}
    a = {"dsm.read_pages": np.array([4, 30]), "kernels.x": 10}
    assert harness.counter_delta(b, a) == {"dsm.read_pages": 29,
                                           "kernels.x": 7}


def test_trace_reduction_on_made_events():
    class E:
        def __init__(self, kind, name, s, d):
            self.k, self.n, self.s, self.d = kind, name, s, d

        def activity_type(self):
            return self.k

        def name(self):
            return self.n

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

    ev = [E("user_annotation", "portbench.window", 0, 1000),
          E("user_annotation", "portbench.dispatch", 0, 400),
          E("cpu_op", "aten::sort", 0, 100),
          E("kernel", "void descent_round_kernel<4>", 100, 200),
          E("kernel", "exchange_kernel", 250, 100),
          E("gpu_memcpy", "Memcpy DtoH", 900, 200)]
    r = trace.reduce(ev)
    assert r["window_s"] == 1e-6
    assert abs(r["busy_s"] - 350e-9) < 1e-15     # 100-350 and 900-1000
    assert trace.kernel_seconds(r, "descent_round_kernel") == 200e-9
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert abs(gaps["dispatch/aten::sort"] - 100e-9) < 1e-15
    assert abs(sum(gaps.values()) - 650e-9) < 1e-15


def test_metric_arithmetic():
    run_ = {"batches": {"traced": 4, "untraced": 10},
            "counters": {"traced": {"kernels.descent_round_launches": 8},
                         "untraced": {"kernels.descent_round_launches": 20}}}
    assert readers.per_batch(run_, "kernels.descent_round_launches") == 2
    run_["batches"]["untraced"] = 0
    assert readers.per_batch(run_, "kernels.descent_round_launches") == 2
    assert readers.per_batch(run_, "kernels.none") is None
    # 3.35 GB at the peak in one second is 100%
    assert abs(roofline.share_pct(3.35e9, 1e-3, "NVIDIA H100 80GB HBM3")
               - 100.0) < 1e-9
    assert roofline.share_pct(0, 1.0, "NVIDIA H100 80GB HBM3") is None
