"""The port's split-storm and churn drivers (``sherman_tpu_torch/
insert_bench.py``, ``churn_bench.py``) against the JAX package's
(``tools/insert_bench.py``, ``tools/churn_bench.py``) on the CPU at small
sizes: every deterministic receipt field (counts, splits, rounds, pool
occupancy, reclaim counts, the tree's keys) exactly equal; times held by
presence.  The churn's no-reclaim control ends in ``MemoryError`` on both.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from sherman_tpu_torch import churn_bench as CB
from sherman_tpu_torch import insert_bench as IB

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)


def _jax_main(mod_name, argv, capsys, monkeypatch):
    """A reference driver's ``main`` (which reads ``sys.argv``) -> the
    JSON of its last stdout line."""
    import importlib
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(sys, "argv", [mod_name + ".py"] + list(argv))
    mod.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


STORM_TIMES = ("value", "elapsed_s", "fresh_insert_ops_s", "splits_s")


@pytest.mark.parametrize("argv", [
    ["--keys", "20000", "--fresh", "6000", "--chunk", "2048",
     "--split-slots", "256", "--verify"],
    ["--keys", "12000", "--fresh", "5000", "--chunk", "512",
     "--split-slots", "128", "--nodes", "4"],
])
def test_insert_bench_matches_jax(eight_devices, capsys, monkeypatch, argv):
    want = _jax_main("insert_bench", argv, capsys, monkeypatch)
    got = IB.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    for k, v in want.items():
        if k in STORM_TIMES:
            assert k in got and got[k] > 0
        else:
            assert got[k] == v, k
    # the port's additions: the flushes and the wall split
    assert got["parent_flushes"] >= 1
    assert set(got["wall_s"]) == {"device_rounds", "drain_split_log",
                                  "flush_parents", "other_host"}


def test_insert_bench_keyspace_is_the_reference_keyspace():
    """The storm's keys are ``native.synthetic_keyspace``'s by rank, the
    warm ranks sorted, the fresh ranks shuffled with numpy seed 13."""
    from sherman_tpu import native as JN
    ctx = IB.storm_build(3000, 1000, "cpu", batch=1024, split_slots=64,
                         log=lambda m: None)
    _, want = JN.synthetic_keyspace(4000, IB.STORM_SALT)
    np.testing.assert_array_equal(ctx["keys"], want)
    fresh = want[3000:].copy()
    np.random.default_rng(13).shuffle(fresh)
    np.testing.assert_array_equal(ctx["fresh"], fresh)


CHURN_TIMES = ("value", "churn_ops_s", "elapsed_s", "reclaim_ms_mean",
               "reclaim_ms_max")


@pytest.mark.parametrize("argv", [
    ["--keys", "30000", "--window", "2500", "--iters", "6", "--chunk",
     "8192"],
    ["--keys", "20000", "--window", "2000", "--iters", "5", "--chunk",
     "4096", "--reclaim-every", "1", "--fill", "0.5", "--streams", "16"],
])
def test_churn_bench_matches_jax(eight_devices, capsys, monkeypatch, argv):
    import churn_bench as JC
    monkeypatch.setattr(sys, "argv", ["churn_bench.py"])
    JC.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = CB.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    for k, v in want.items():
        if k in CHURN_TIMES:
            assert k in got
        else:
            assert got[k] == v, k
    assert got["freed"] > 0 and got["pool_flat"]
    assert got["tree_keys"] == got["keys_live"]


def test_churn_no_reclaim_runs_the_pool_dry():
    """The control on a small pool (64-page leases): without reclaim
    passes the loop ends in ``MemoryError`` within a few iterations."""
    ctx = CB.churn_build(8000, 2000, "cpu", chunk=2048, streams=16,
                         slack=0.0, locks_per_node=4096, chunk_pages=64,
                         log=lambda m: None)
    with pytest.raises(MemoryError):
        CB.churn(ctx, 40, no_reclaim=True)
    assert 0 < ctx["hi"] - 8000 < 40 * 2000


@pytest.mark.slow
def test_churn_no_reclaim_ends_in_memory_error(eight_devices, capsys,
                                               monkeypatch):
    """The control through both whole drivers (~50 s: slow): without
    reclaim passes the bounded pool runs dry on both sides, at the same
    iteration."""
    import churn_bench as JC
    argv = ["--keys", "20000", "--window", "2000", "--iters", "40",
            "--chunk", "4096", "--reclaim-every", "1", "--slack", "0",
            "--no-reclaim"]
    monkeypatch.setattr(sys, "argv", ["churn_bench.py"])
    with pytest.raises(MemoryError):
        JC.main(argv)
    jax_iters = capsys.readouterr().err.count("#   iter ")
    with pytest.raises(MemoryError):
        CB.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().err.count("#   iter ") == jax_iters


def test_storm_and_churn_records_match_the_tool():
    """The smoke's entry points (``storm``, ``churn``) on small trees:
    the record's counts add up, the verification passes."""
    ctx = IB.storm_build(8000, 6000, "cpu", batch=1024, split_slots=128,
                         log=lambda m: None)
    rec = IB.storm(ctx, 1024)
    # the warm-up chunk (4,096 keys) is outside the timed storm
    assert rec["keys_fresh"] == 6000 - 4096 and rec["chunks"] == 2
    assert rec["host_path"] == 0 and rec["lock_timeouts"] == 0
    IB.verify(ctx)
    cctx = CB.churn_build(10_000, 1000, "cpu", chunk=1024, streams=16,
                          locks_per_node=4096, chunk_pages=64,
                          log=lambda m: None)
    crec = CB.churn(cctx, 6)
    assert crec["iters"] == 6 and len(crec["pool_live"]) == 7
    assert crec["freed"] > 0 and crec["host_path"] == 0
    assert CB.verify(cctx) == cctx["hi"] - cctx["lo"] == 10_000
