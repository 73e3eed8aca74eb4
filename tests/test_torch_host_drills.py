"""The port's multihost and hostfail drills (``sherman_tpu_torch/
multihost_drill.py``, ``hostfail_drill.py``; ``python -m
sherman_tpu_torch.bench --multihost-drill`` / ``--hostfail-drill``) on the
CPU at the reference drills' 4,000 keys, each held to every pin of its
reference (``tools/multihost_drill.py``, ``tools/hostfail_drill.py``): no
acked op lost across union recovery or the adoption, the torn tail local
to its host, the cross-host tail converged and serving replica reads, the
per-host journals' ack bandwidth at least 1.5x the shared stream's, no
duplicate ack, no fenced ack merged, no dead host left unadopted, and a
linearizable history.
"""

import json

import numpy as np
import pytest
import torch

from sherman_tpu_torch import bench
from sherman_tpu_torch import hostfail_drill as HD
from sherman_tpu_torch import multihost_drill as MD

torch.set_num_threads(1)


def test_ledger_misses_takes_inflight_writes():
    """A key's state is its last acked outcome or a write's in flight at
    the crash; anything else is a miss."""
    keys = np.asarray([1, 2, 3, 4, 5], np.uint64)
    merged = {1: (True, 10), 2: (True, 20), 3: (False, None),
              4: (True, 40), 5: (False, None)}
    open_w = {2: [(True, 21)], 5: [(True, 55)]}
    got = np.asarray([10, 21, 0, 41, 55], np.uint64)
    found = np.asarray([True, True, False, True, True])
    assert MD.ledger_misses(keys, got, found, merged, open_w) == (1, 2)
    assert MD.ledger_misses(keys[:1], got[:1], found[:1], merged,
                            {}) == (0, 0)


def test_multihost_drill_pins_at_4000_keys(tmp_path, capsys):
    assert MD.main(["--keys", "4000", "--device", "cpu", "--dir",
                    str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "multihost_drill" and out["ok"]
    assert out["rpo_ops"] == 0 and out["lost_acks"] == 0
    assert out["linearizable"] and out["audit"]["violations"] == 0
    assert out["audit"]["reads_checked"] > 0
    assert out["ack_bandwidth"]["speedup"] >= 1.5
    assert all(n > 0 for n in out["key_split"])
    assert all(p > 0 for p in out["delta_pages"])
    assert "-h0-" in out["torn"]
    assert [c["host"] for c in out["union"]["chains"]] == [0, 1]
    assert out["union"]["replay"]["records"] > 0
    assert out["tail"]["applied_records"] > 0
    assert out["tail"]["reads_served"] > 0
    assert out["service"]["acked_writes"] > 0
    assert out["obs"]["multihost.split_submits"] > 0
    assert set(out["phase_s"]) == {"build", "traffic", "crash",
                                   "recover_union", "audit_rpo", "tail",
                                   "audit", "ack_ab"}


def test_hostfail_drill_pins_at_4000_keys(tmp_path, capsys):
    assert HD.main(["--keys", "4000", "--device", "cpu", "--dir",
                    str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "hostfail_drill" and out["ok"]
    assert out["lease_s"] == 0.5
    assert out["lost_acks"] == 0 and out["duplicate_acks"] == 0
    assert out["fenced_acks_merged"] == 0
    assert out["unadopted_dead_hosts"] == 0
    assert out["linearizable"] and out["audit"]["violations"] == 0
    assert out["fenced_suffix_frames"] >= 3
    assert out["fenced_acks"] > 0
    assert out["zombie_typed_rejections"] == 1
    assert out["adoption"]["seeded"] > 0
    assert out["adoption"]["epoch"] == 2
    assert out["service"]["overlay"] == {"0": 1}
    assert out["detect_ms"] > 0 and out["adoption_ms"] > 0
    assert out["availability_gap_ms"] >= out["detect_ms"]
    assert out["obs"]["hostfail.adoptions"] == 1
    assert out["obs"]["hostfail.fenced_host_acks"] >= 1


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_bench_dispatches_the_host_drills_and_refuses_without_a_card():
    assert bench.main(["--multihost-drill", "--keys", "1000"]) == 2
    assert bench.main(["--hostfail-drill", "--keys", "1000"]) == 2
