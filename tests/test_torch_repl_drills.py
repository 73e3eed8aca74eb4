"""The port's failover and partition drills (``sherman_tpu_torch/
failover_drill.py``, ``partition_drill.py``; ``python -m
sherman_tpu_torch.bench --failover-drill`` / ``--partition-drill``) on the
CPU at 3,000 keys, each held to the pins of its reference drill
(``tools/failover_drill.py``, ``tools/partition_drill.py``): no lost or
duplicate ack, a linearizable history, the stale primary fenced, the sweep
re-bootstrapping every follower, the fenced suffix never merged, and the
diverged follower repaired.  Their keyspace is the reference drills' keys,
held here against ``np.unique`` of the same draw.
"""

import json

import numpy as np
import pytest
import torch

from sherman_tpu_torch import bench
from sherman_tpu_torch import failover_drill as FD
from sherman_tpu_torch import partition_drill as PD

torch.set_num_threads(1)


def test_drill_keyspace_is_the_reference_draw():
    for n, seed in ((3000, 3), (4000, 3), (1000, 7)):
        rng = np.random.default_rng(seed)
        want = np.unique(rng.integers(1, 1 << 56, int(n * 1.05),
                                      dtype=np.uint64))[:n]
        np.testing.assert_array_equal(FD.drill_keyspace(n, seed), want)
    keys = FD.drill_keyspace(500)
    probe = np.concatenate([keys[::7], keys[:5] + np.uint64(1)])
    np.testing.assert_array_equal(FD.in_sorted(probe, keys[::3]),
                                  np.isin(probe, keys[::3]))
    assert not FD.in_sorted(probe, keys[:0]).any()


def test_failover_drill_pins_at_3000_keys(tmp_path, capsys):
    assert FD.main(["--keys", "3000", "--device", "cpu", "--dir",
                    str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "failover_drill" and out["ok"]
    assert out["lost_acks"] == 0 and out["duplicate_acks"] == 0
    assert out["linearizable"] and out["audit"]["violations"] == 0
    assert out["fenced_writes"] >= 1
    assert out["repl"]["rebootstraps"] == 2
    assert out["repl"]["reads_served"] > 0
    assert out["repl"]["applied_records"] > 0
    assert out["dedup"]["adopted"] > 0
    assert out["retry_across_failover"]["retried"] > 0
    assert out["promote"]["epoch"] == {"old": 1, "new": 2}
    assert {"repl.lag_ms", "repl.availability_gap_ms",
            "repl.promotions"} <= set(out["obs"])
    assert all(len(b) == 2 for b in out["bootstrap_s"])


def test_partition_drill_pins_at_3000_keys(tmp_path, capsys):
    assert PD.main(["--keys", "3000", "--device", "cpu", "--dir",
                    str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "partition_drill" and out["ok"]
    assert out["lost_acks"] == 0 and out["duplicate_acks"] == 0
    assert out["linearizable"]
    assert out["fenced_acks_merged"] == 0
    assert out["diverged_followers_unrepaired"] == 0
    assert out["fenced_suffix_records"] > 0
    assert out["quorum_timeout"]["typed"] and out["quorum_retry_deduped"]
    assert out["stale_rejected_typed"]
    assert out["anti_entropy"]["divergences"] >= 1
    assert out["repl"]["quorum"]["acks"] > 0
    assert set(out["quorum_latency"]) == {"p50_ms_primary_only",
                                          "p50_ms_quorum", "delta_ms"}
    # every scheduled window fired; the reordered views were refused
    assert all(f["fired"] for f in out["chaos"]["faults"])
    assert out["chaos"]["detected"] >= 1 and out["chaos"]["injected"] >= 3


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_bench_dispatches_the_drills_and_refuses_without_a_card():
    assert bench.main(["--failover-drill", "--keys", "1000"]) == 2
    assert bench.main(["--partition-drill", "--keys", "1000"]) == 2
