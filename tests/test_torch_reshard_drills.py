"""The port's reshard and client-contract drills
(``sherman_tpu_torch/reshard_drill.py``, ``contract_drill.py``; ``python -m
sherman_tpu_torch.bench --reshard-drill`` / ``--contract-drill``) on the CPU
at the reference drills' sizes (tests/test_tools.py: 2,500 keys 4 -> 6,
and the contract drill's 4,000 keys 2 -> 3), each held to the pins of its
reference drill: no lost ack, RPO 0, the online cutover bit-identical to
the offline reshard, the resume re-verifying its batches; no duplicate or
lost ack, a linearizable history, no retrace in the sealed window.
"""

import json

import pytest
import torch

from sherman_tpu_torch import bench
from sherman_tpu_torch import contract_drill as CD
from sherman_tpu_torch import reshard_drill as RD

torch.set_num_threads(1)


def test_reshard_drill_pins_at_2500_keys(tmp_path, capsys):
    assert RD.main(["--keys", "2500", "--nodes", "4", "--target-nodes", "6",
                    "--batch-pages", "24", "--device", "cpu", "--dir",
                    str(tmp_path)]) == 0
    cap = capsys.readouterr()
    r = json.loads(cap.out.strip().splitlines()[-1])
    assert r["metric"] == "reshard_drill" and r["ok"]
    assert r["lost_acks"] == 0 and r["rpo_ops"] == 0
    assert r["bit_identical"] is True
    assert r["resume"]["resume_count"] == 1
    assert r["cutover"]["resume_verified"] > 0
    assert r["cutover"]["pages_moved"] > 0
    assert r["cutover"]["live_pages"] > 0
    assert r["batch"]["batches"] > 0 and r["batch"]["host_steps_mean"] >= 1
    assert set(r["cutover"]["cutover_parts_ms"]) >= {
        "flush_parents", "restage", "certify", "transform_write"}
    assert r["obs"]["migrate.resume_count"] == 1
    assert "RESHARD-DRILL PASS" in cap.err


def test_reshard_drill_grows_one_node_to_four(tmp_path):
    """The queued chip capture's node counts (1 -> 4) at a CPU size."""
    r = RD.run(RD.parse_args(["--keys", "3000", "--nodes", "1",
                              "--target-nodes", "4", "--device", "cpu",
                              "--dir", str(tmp_path)]))
    assert r["ok"] and r["lost_acks"] == 0 and r["rpo_ops"] == 0
    assert r["bit_identical"] and r["cutover"]["resume_verified"] > 0


def test_contract_drill_pins_at_4000_keys(tmp_path, capsys):
    assert CD.main(["--keys", "4000", "--device", "cpu", "--dir",
                    str(tmp_path)]) == 0
    cap = capsys.readouterr()
    r = json.loads(cap.out.strip().splitlines()[-1])
    assert r["metric"] == "contract_drill" and r["ok"]
    assert r["nodes"] == 2 and r["target_nodes"] == 3
    assert r["duplicate_acks"] == 0 and r["lost_acks"] == 0
    assert r["rpo_ops"] == 0 and r["linearizable"] is True
    assert r["retraces"] == 0
    assert r["audit"]["violations"] == 0 and r["audit"]["reads_checked"] > 0
    assert r["retry_across_crash"]["retried"] > 0
    assert r["dedup"]["adopted"] > 0
    assert r["deadline"]["shed_typed"] > 0
    assert r["chaos"]["faults_fired"] > 0
    assert r["migration"]["pages_moved"] > 0
    assert r["phase_a"]["audit_cost_frac"] < 0.02
    assert "CONTRACT-DRILL PASS" in cap.err


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
@pytest.mark.parametrize("flag", ["--reshard-drill", "--contract-drill"])
def test_bench_dispatches_the_resize_drills_and_refuses_without_a_card(
        flag, capsys):
    assert bench.main([flag, "--keys", "100"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
