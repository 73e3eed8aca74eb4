"""Port parity: the YCSB A-F matrix (``sherman_tpu_torch.workload.ycsb``
and ``sherman_tpu_torch.ycsb_bench``) against the JAX package's
``workload/ycsb.py`` and ``tools/ycsb_bench.py``.

- The generators: the same batches, frontiers and expectations from the
  same seed for all six workloads.  JAX's ``ZipfGen`` draws from its
  native sampler when the native library loads, the port's from the
  numpy path, so the JAX generator of each test is put on its numpy
  fallback (this instance only; a stated difference, ROADMAP.md §3).
- The payload constructor for both value-size distributions.
- The driver: ``build`` and ``run_workload`` for A-F at 20,000 keys on
  CPU tensors, one batch stream drawn by the port's generator and played
  through both packages' drivers, at one node and at eight: equal op
  counts, every scan's (keys, values) equal and equal to a host mirror
  of the live set, pools, locks and counters bit-identical.
- ``main`` refuses to run without a card (exit code 2, also through
  ``bench --ycsb``), and a value heap asked for through
  ``SHERMAN_VALUE_HEAP`` is built with the records out of line.

Every tolerance is exact equality.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from sherman_tpu.workload import ycsb as JY
from sherman_tpu_torch import bench as TBench
from sherman_tpu_torch import ycsb_bench as TYB
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.workload import ycsb as TY

torch.set_num_threads(1)

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "ycsb_bench.py")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_tools_ycsb_bench",
                                                  _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_zipf(gen):
    """Put a JAX generator's sampler on its numpy fallback."""
    gen.zipf._native = None
    gen.zipf._init_fallback()
    return gen


def _eq_batch(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            assert a[k] == b[k], (what, k)


@pytest.mark.parametrize("w", sorted(TY.WORKLOADS))
def test_ycsb_gen_matches_jax(w):
    assert TY.WORKLOADS == JY.WORKLOADS
    kw = dict(theta=0.99, seed=17, salt=TYB.SALT)
    t = TY.YcsbGen(w, 50_000, **kw)
    j = _numpy_zipf(JY.YcsbGen(w, 50_000, **kw))
    for i, n in enumerate((1, 777, 4096, 4096)):
        _eq_batch(t.batch(n), j.batch(n), f"{w} batch {i}")
        assert (t.frontier, t.ops_drawn) == (j.frontier, j.ops_drawn)
    assert t.expectations() == j.expectations()
    for ln in (1, 50, 100):
        assert t.scan_span(ln) == j.scan_span(ln)
    r = np.array([0, 1, 2**40, 2**63], np.uint64)
    np.testing.assert_array_equal(t.keys_of_ranks(r), j.keys_of_ranks(r))
    with pytest.raises(ConfigError):
        TY.YcsbGen("G", 10)


def test_payload_for_key_matches_jax():
    keys = [1, 2, 0xD00D, 2**63 + 5, 2**64 - 2] + list(
        np.random.default_rng(3).integers(1, 2**63, 40).tolist())
    for dist in ("fixed", "uniform"):
        for nb in (1, 8, 28, 64, 252, 1000):
            for k in keys:
                got = TY.payload_for_key(k, nb, dist)
                assert got == JY.payload_for_key(k, nb, dist)
                assert (len(got) == nb) if dist == "fixed" \
                    else 1 <= len(got) <= nb
            # the vectorized constructor: the same bytes for every key
            assert TY.payloads_of(np.asarray(keys, np.uint64), nb, dist) \
                == [JY.payload_for_key(k, nb, dist) for k in keys]
    gen = TY.YcsbGen("A", 100, value_bytes=12, value_dist="uniform")
    assert gen.payloads_for_keys([5, 6]) == [
        JY.payload_for_key(5, 12, "uniform"),
        JY.payload_for_key(6, 12, "uniform")]
    with pytest.raises(ConfigError):
        TY.payload_for_key(1, 8, "zipf")
    with pytest.raises(ConfigError):
        TY.payloads_of(np.ones(2, np.uint64), 8, "zipf")
    assert TY.payloads_of(np.zeros(0, np.uint64), 8) == []


class _Replay:
    """A generator that hands out pre-drawn batches (the one stream both
    drivers play)."""

    def __init__(self, batches, gen):
        self.batches = list(batches)
        self.gen = gen
        self.value_bytes, self.value_dist = gen.value_bytes, gen.value_dist

    def batch(self, n):
        return self.batches.pop(0)

    def expectations(self):
        return self.gen.expectations()

    def payloads_for_keys(self, keys):
        return self.gen.payloads_for_keys(keys)


def _recording(eng, out: list):
    """Record every ``range_query_many`` result of ``eng``."""
    scan = eng.range_query_many

    def rec(ranges):
        res = scan(ranges)
        out.append((list(ranges), res))
        return res

    eng.range_query_many = rec


class _Mirror:
    """The live set the matrix leaves: bulk keys (``key ^ 0xD00D``), the
    updates of A/B (``key ^ 0xBEEF``), the D/E inserts (``key ^ 0xD00D``)
    and F's read-modify-writes (the value xor 1, once a key a batch)."""

    def __init__(self, keys):
        self.live = dict(zip(keys.tolist(),
                             (keys ^ np.uint64(0xD00D)).tolist()))

    def play(self, b):
        for k in (np.unique(b["update"]) if "update" in b else ()):
            self.live[int(k)] = int(k) ^ 0xBEEF
        for k in (np.unique(b["insert"]) if "insert" in b else ()):
            self.live[int(k)] = int(k) ^ 0xD00D
        for k in (np.unique(b["rmw"]) if "rmw" in b else ()):
            self.live[int(k)] ^= 1

    def check(self, ranges, res):
        ks = np.array(sorted(self.live), np.uint64)
        for (lo, hi), (k, v) in zip(ranges, res):
            want = ks[(ks >= np.uint64(lo)) & (ks < np.uint64(hi))]
            np.testing.assert_array_equal(k, want)
            np.testing.assert_array_equal(
                v, np.array([self.live[int(x)] for x in want], np.uint64))


@pytest.mark.parametrize("nodes", [1, 8])
def test_matrix_driver_matches_jax(eight_devices, nodes):
    """``build`` + ``run_workload`` for A-F on one tree, both packages
    playing one batch stream: the rows' counts and analytic blocks, every
    scan, the pools, locks and counters equal; every scan equal to the
    mirror of the live set."""
    n_keys, ops, steps = 20_000, 1024, 2
    jt = _jax_tool()
    jc, _, je, _, jkeys = jt.build(n_keys, ops, nodes, 0, 64, "fixed")
    pc, _, pe, pkeys = TYB.build(n_keys, ops, nodes, "cpu",
                                 log=lambda m: None)
    np.testing.assert_array_equal(pkeys, jkeys)
    assert pc.cfg.pages_per_node == jc.cfg.pages_per_node
    assert pc.cfg.step_capacity == jc.cfg.step_capacity
    assert (pe.B, pe.tcfg.sibling_chase_budget) == \
        (je.B, je.tcfg.sibling_chase_budget)
    np.testing.assert_array_equal(pe.router.table_np, je.router.table_np)
    scans_p, scans_j = [], []
    _recording(pe, scans_p)
    _recording(je, scans_j)
    mirror = _Mirror(pkeys)
    n_scans = 0
    for w in "ABCDEF":
        gen = TY.YcsbGen(w, n_keys, theta=0.99, seed=17, salt=TYB.SALT)
        batches = [gen.batch(ops) for _ in range(steps + 1)]
        rp = TYB.run_workload(pe, _Replay(batches, gen), ops=ops,
                              steps=steps)
        rj = jt.run_workload(je, None, _Replay(batches, gen), ops=ops,
                             steps=steps)
        assert rp["counts"] == rj["counts"], w
        assert rp["analytic"] == rj["analytic"], w
        assert rp["ops"] == rj["ops"] == ops * steps
        for b in batches:
            mirror.play(b)
            if "scan" in b:
                ranges, res = scans_p[n_scans]
                assert ranges == b["scan"]
                mirror.check(ranges, res)
                n_scans += 1
        if w == "E":
            assert round(rp["scan_rows_per_scan"], 2) == \
                rj["scan_rows_per_scan"]
            assert rp["scan_rows_expected_per_scan"] == pytest.approx(
                rj["scan_rows_expected_per_scan"], abs=0.005)
    assert n_scans == len(scans_p) == len(scans_j) == steps + 1
    for (rp_, sp), (rj_, sj) in zip(scans_p, scans_j):
        assert rp_ == rj_
        for (a, b), (c, d) in zip(sp, sj):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    for name in ("pool", "locks", "counters"):
        np.testing.assert_array_equal(getattr(pc.dsm, name).numpy(),
                                      np.asarray(getattr(jc.dsm, name)),
                                      err_msg=name)


def test_main_refuses_without_a_card_and_a_value_heap(monkeypatch):
    """Without a CUDA device ``main`` exits with code 2 before building
    anything, also through ``bench --ycsb``; a value heap asked for
    through ``SHERMAN_VALUE_HEAP`` is built (the records moved out of
    line), never run inline."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TYB.main(["--keys", "1000", "--workloads", "E"]) == 2
    assert TBench.main(["--ycsb", "--keys", "1000"]) == 2
    for v in ("1", "4096", "on"):
        monkeypatch.setenv("SHERMAN_VALUE_HEAP", v)
        c, _, eng, keys = TYB.build(1000, 256, 1, "cpu", log=lambda m: None)
        assert c.cfg.heap_pages_per_node == 4096
        got, found = eng.value_heap.get(keys[:5])
        assert found.all() and got == TY.payloads_of(keys[:5], 64)
    monkeypatch.setenv("SHERMAN_VALUE_HEAP", "0")
    _, _, eng, keys = TYB.build(1000, 256, 1, "cpu", log=lambda m: None)
    k, v = eng.range_query(int(keys[10]), int(keys[20]))
    np.testing.assert_array_equal(k, keys[10:20])
    np.testing.assert_array_equal(v, keys[10:20] ^ np.uint64(0xD00D))
