"""The reference agrees with the port (``sherman_tpu_torch`` on the CPU)
at 20,000 keys on both mixes, at 1 and 8 nodes, through the harness's own
path; and its pieces (key map, sampler, batch semantics) hold alone."""

import time

import numpy as np
import pytest
import torch

from portbench import gen, harness
from portbench.reference import kv

CELLS = ["ycsb-100m.c-zipf", "ycsb-100m.a-zipf", "sherman-64m-8mn.c-zipf",
         "sherman-64m-8mn.a-zipf", "sherman-64m-8mn.b-zipf"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(tiny, cell):
    out = harness.run_cell(tiny, cell, 2**31 + 7, 0.5, False, "cpu",
                           t_start=time.perf_counter())
    r = out["result"]
    assert r["correct"], out["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert out["check"] == {"wrong_answers": {"value": 0, "limit": 0}}
    assert set(out["parts"]) == {"wrong_reads", "wrong_acks", "lost_updates",
                                 "unanswered"}


def test_mix64_on_torch_matches_the_reference():
    x = np.concatenate([np.arange(5000, dtype=np.uint64),
                        np.array([0, 1, (1 << 63), (1 << 64) - 1],
                                 np.uint64),
                        gen.rng(5, 0).integers(0, 1 << 64, 5000,
                                               dtype=np.uint64)])
    t = torch.from_numpy(x.view(np.int64).copy())
    got = gen.mix64_torch(t).numpy().view(np.uint64)
    assert np.array_equal(got, kv.mix64(x))


def test_mix64_matches_the_ports_key_map():
    from sherman_tpu_torch.ops import bits
    x = np.arange(10_000, dtype=np.uint64) ^ np.uint64(0x5E17AB1E5A17)
    assert np.array_equal(kv.mix64(x), bits.mix64_np(x))


@pytest.mark.cuda
def test_keys_made_on_the_card_match_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    salt, keys = gen.make_keys(0x5E17AB1E5A17, 1 << 20, "cuda", seed=9)
    want = kv.mix64(np.arange(1 << 20, dtype=np.uint64) ^ np.uint64(salt))
    assert np.array_equal(keys, want)


def test_keys_are_distinct_and_in_range():
    salt, keys = gen.make_keys(3**20, 50_000, "cpu", seed=4)
    assert np.unique(keys).shape[0] == 50_000
    assert keys.min() >= kv.KEY_MIN and keys.max() <= kv.KEY_MAX
    assert np.array_equal(keys, kv.mix64(np.arange(50_000, dtype=np.uint64)
                                         ^ np.uint64(salt)))


def test_same_seed_same_inputs_and_large_seeds():
    seed = 2**40 + 3
    t = {"request_distribution": "zipfian", "zipf_theta": 0.99,
         "read_proportion": 0.5, "update_proportion": 0.5,
         "ring_batches": 2}
    keys = np.arange(1000, dtype=np.uint64) + 1
    a = gen.make_ring(t, 1000, 512, seed, keys)
    b = gen.make_ring(t, 1000, 512, seed, keys)
    c = gen.make_ring(t, 1000, 512, seed + 1, keys)
    for x, y in zip(a, b):
        assert np.array_equal(x.ranks, y.ranks)
        assert np.array_equal(x.values, y.values)
        assert np.array_equal(x.is_read, y.is_read)
    assert not np.array_equal(a[0].ranks, c[0].ranks)
    assert np.array_equal(gen.make_values(-5, 10), gen.make_values(-5, 10))


def test_zeta_tail_matches_the_exact_sum():
    n = (1 << 22) + 12345
    exact = float(np.sum(np.arange(1, n + 1, dtype=np.float64) ** -0.99))
    # the Euler-Maclaurin path is taken above 2**22 terms
    assert abs(kv.zeta(n, 0.99) - exact) < 1e-9 * exact


def test_zipf_sampler_is_skewed_as_its_cdf_says():
    z = kv.ZipfRanks(100_000, 0.99)
    r = z.sample(gen.rng(1, 9), 400_000)
    assert r.min() >= 0 and r.max() < 100_000
    # the hottest rank's share is 1 / zeta(n)
    assert abs(np.mean(r == 0) - 1 / z.zetan) < 0.01
    u = kv.ZipfRanks(1000, 0.0).sample(gen.rng(1, 9), 200_000)
    assert abs(np.mean(u < 500) - 0.5) < 0.01


def test_first_write_of_a_key_applies():
    ranks = np.array([5, 7, 5, 5, 9, 7])
    is_read = np.array([False, True, False, True, False, False])
    applied, ack = kv.first_writes(ranks, is_read)
    assert sorted(applied.tolist()) == [0, 4, 5]
    assert ack.tolist() == [kv.ST_APPLIED, 0, kv.ST_SUPERSEDED, 0,
                            kv.ST_APPLIED, kv.ST_APPLIED]
    ref = kv.KVReference(np.zeros(10, np.uint64))
    ref.apply(ranks, np.arange(6, dtype=np.uint64) + 100, applied)
    assert ref.read(np.array([5, 7, 9])).tolist() == [100, 105, 104]


def test_status_numbers_match_the_port():
    from sherman_tpu_torch.models import batched
    assert kv.ST_APPLIED == batched.ST_APPLIED
    assert kv.ST_SUPERSEDED == batched.ST_SUPERSEDED


def _check(ref, ranks, is_read, values, vals, found, acks):
    return ref.check_batch(np.array(ranks), np.array(is_read),
                           np.array(values, np.uint64),
                           np.array(vals, np.uint64), np.array(found),
                           np.array(acks, np.int32))


def test_a_batch_is_held_to_the_first_update_applying():
    A, S = kv.ST_APPLIED, kv.ST_SUPERSEDED
    ref = kv.KVReference(np.array([10, 20, 30], np.uint64))
    # rank 1 read before (20) and after (7) its update; rank 0 updated
    # twice, the second superseded
    c = _check(ref, [1, 1, 1, 0, 0], [True, False, True, False, False],
               [0, 7, 0, 5, 6], [20, 0, 7, 0, 0], [True] * 5,
               [0, A, 0, A, S])
    assert c == {"wrong_reads": 0, "wrong_acks": 0, "refused": 0,
                 "multi_applied": 0}
    assert ref.read(np.array([0, 1, 2])).tolist() == [5, 7, 30]
    # a stale value, a value no update gave, an applied update acked
    # SUPERSEDED
    c = _check(ref, [0, 2, 1], [True, True, False], [0, 0, 9], [10, 31, 0],
               [True, True, True], [0, 0, S])
    assert c["wrong_reads"] == 2 and c["wrong_acks"] == 1


def test_a_later_duplicate_applied_is_wrong():
    """The second update of a key acknowledged APPLIED, its value kept:
    a wrong ack, and a read of the later value is wrong too."""
    A = kv.ST_APPLIED
    ref = kv.KVReference(np.zeros(2, np.uint64))
    c = _check(ref, [0, 0, 0], [False, False, True], [4, 9, 0], [0, 0, 9],
               [True] * 3, [A, A, 0])
    assert c == {"wrong_reads": 1, "wrong_acks": 1, "refused": 0,
                 "multi_applied": 1}
    assert ref.read(np.array([0]))[0] == 4
    assert ref.check_readback(np.array([0]), np.array([9], np.uint64),
                              np.array([True])) == 1


def test_a_refused_first_update_leaves_the_key():
    A, S, T = kv.ST_APPLIED, kv.ST_SUPERSEDED, kv.ST_LOCK_TIMEOUT
    ref = kv.KVReference(np.array([3, 3], np.uint64))
    c = _check(ref, [0, 0, 1], [False, False, False], [4, 9, 6], [0] * 3,
               [True] * 3, [T, S, A])
    assert c == {"wrong_reads": 0, "wrong_acks": 0, "refused": 1,
                 "multi_applied": 0}
    assert ref.read(np.array([0, 1])).tolist() == [3, 6]
    # a later duplicate may not apply in its place
    c = _check(ref, [0, 0], [False, False], [4, 9], [0, 0], [True] * 2,
               [T, A])
    assert c["wrong_acks"] == 1 and ref.read(np.array([0]))[0] == 3


def test_a_batch_not_kept_advances_the_table_by_the_same_rule():
    ranks = np.array([0, 0, 1, 2, 2])
    is_read = np.array([False, False, False, True, False])
    values = np.array([4, 9, 6, 0, 8], np.uint64)
    ref = kv.KVReference(np.zeros(3, np.uint64))
    ref.apply_batch(ranks, is_read, values, refused=np.array([4]))
    assert ref.read(np.array([0, 1, 2])).tolist() == [4, 6, 0]
    # an update lost in it shows at the next read
    c = _check(ref, [0, 1], [True, True], [0, 0], [9, 6], [True, True],
               [0, 0])
    assert c["wrong_reads"] == 1
