"""Port parity: the online scrubber and degraded mode
(``sherman_tpu_torch/models/scrub.py``: ``Scrubber``; ``BatchedEngine``'s
``enter_degraded``/``exit_degraded``/``_require_writable`` and
``DegradedError``), and the engine's lock-lease recovery under wedged
locks, against the JAX package, at one node and at four.

Both packages load the same tree (tests/test_chaos.py's ``small_cluster``),
fire the same faults and drive the same engine calls.  The scrub results,
quarantine lease words, degraded flags and reasons, insert stats, search
answers and statuses must be equal, and the pools, lock tables, counters
and dirty rows bit-identical after every call.  The checkpoint-restore
exit of tests/test_chaos.py waits for the port's checkpoint module; here
the exit is ``FaultPlan.undo``, a green validation and ``exit_degraded``,
as tests/test_fuzz.py repairs.  The JAX side runs as its own tests run it
(``gather_impl="xla"``, the ``eight_devices`` fixture).  Every tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import validate as JV
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.models.scrub import Scrubber as JScrubber
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import KeyRangeError, TreeCorruptError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import validate as TV
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.models.scrub import Scrubber
from sherman_tpu_torch.ops import layout
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)


class Side:
    """One package's cluster, tree, engine and module handles."""

    def __init__(self, jax_side: bool, n: int, **kw):
        self.jax = jax_side
        self.B, self.CH, self.V = (JB, JCH, JV) if jax_side else (TB, CH, TV)
        self.Scrubber = JScrubber if jax_side else Scrubber
        cfg = (JDSMConfig(gather_impl="xla", machine_nr=n, **kw)
               if jax_side else DSMConfig(device="cpu", machine_nr=n, **kw))
        self.c = (JCluster if jax_side else Cluster)(cfg)
        self.t = (JTree if jax_side else Tree)(self.c)
        tcfg = (JTreeConfig if jax_side else TreeConfig)(lock_retry_rounds=2)
        self.e = self.B.BatchedEngine(self.t, batch_per_node=128, tcfg=tcfg,
                                      write_combine=False)
        self.d = self.c.dsm

    def fire(self, faults):
        """Install a plan of ``faults`` (dicts, or a plan), run one host
        step so step-0 faults land, uninstall.  -> the plan."""
        plan = (faults if isinstance(faults, self.CH.FaultPlan)
                else self.CH.FaultPlan([dict(f) for f in faults]))
        self.d.install_chaos(plan)
        self.d.read_word(0, 0)
        self.d.install_chaos(None)
        assert plan.exhausted
        return plan


def _small(n):
    """tests/test_chaos.py's small_cluster on both sides (one node: the
    same 1,024-page node)."""
    kw = dict(pages_per_node=1024, locks_per_node=256, step_capacity=256,
              chunk_pages=32)
    keys = np.arange(1, 1501, dtype=np.uint64) * np.uint64(17)
    sides = (Side(True, n, **kw), Side(False, n, **kw))
    for s in sides:
        s.B.bulk_load(s.t, keys, keys ^ np.uint64(0xBEEF))
        s.e.attach_router()
    return sides, keys


def _same(j, p, what=""):
    np.testing.assert_array_equal(p.d.pool.numpy(), np.asarray(j.d.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(p.d.locks.numpy(), np.asarray(j.d.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(p.d.counters_np(), np.asarray(j.d.counters),
                                  err_msg=what + " counters")
    np.testing.assert_array_equal(p.d.dirty_rows(), j.d.dirty_rows(),
                                  err_msg=what + " dirty")
    assert p.e.degraded_reason == j.e.degraded_reason, what


def _outcome(fn):
    """-> ("ok", result) or ("raised", class name, reason or message)."""
    try:
        return ("ok", fn())
    except (RuntimeError, ValueError) as e:
        return ("raised", type(e).__name__, getattr(e, "reason", str(e)))


def _eq(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a)
    elif isinstance(a, (tuple, list)):
        assert type(b) is type(a) and len(b) == len(a)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        assert b == a


def _both(sides, fn, what=""):
    """``fn(side)`` on both sides: equal outcomes, then equal state.
    -> the port's outcome."""
    j, p = sides
    out = [_outcome(lambda s=s: fn(s)) for s in sides]
    _eq(out[0], out[1])
    _same(j, p, what)
    return out[1]


def _victim(s, keys, at=None):
    at = keys.size // 2 if at is None else at
    addr = int(s.t._descend(int(keys[at]))[0])
    return addr, s.t._lock_word_addr(addr)


def _page_keys(s, addr):
    """The live keys of a leaf (one host page read)."""
    return np.array([k for k, _, _ in
                     layout.np_leaf_entries(s.d.read_page(addr))], np.uint64)


def _scrubbers(sides, **kw):
    return {s.jax: s.Scrubber(s.e, **kw) for s in sides}


# -- scrubbing, quarantine and degraded mode ---------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_scrub_detects_quarantines_and_degrades(eight_devices, n):
    sides, keys = _small(n)
    j, p = sides
    victim, la = _both(sides, lambda s: _victim(s, keys))[1]
    scr = _scrubbers(sides, interval=1)
    _both(sides, lambda s: scr[s.jax].scrub())
    _both(sides, lambda s: s.fire([
        {"kind": "torn_page", "step": 0, "addr": victim},
        {"kind": "flip_entry_ver", "step": 0, "addr": victim,
         "slot": 1}]).describe())
    res = _both(sides, lambda s: scr[s.jax].scrub())[1]
    assert res["violations"] == 1 and res["degraded"]
    assert res["classes"]["bad_version"] == 1
    assert res["classes"]["torn_slot"] == 1 and res["quarantined"] >= 1
    assert _both(sides, lambda s: s.d.read_word(la, 0, space=D.SPACE_LOCK)
                 )[1] == scr[False].ctx.lease == scr[True].ctx.lease
    assert scr[False].damaged_addrs() == [victim]
    # every write entry point is refused, in both packages
    for what, fn in (
            ("insert", lambda s: s.e.insert(keys[:2], keys[:2])),
            ("delete", lambda s: s.e.delete(keys[:2])),
            ("mixed", lambda s: s.e.mixed(keys[:2], keys[:2],
                                          np.array([True, False]))),
            ("reclaim", lambda s: s.e.reclaim_empty_leaves())):
        out = _both(sides, fn, what)
        assert out[:2] == ("raised", "DegradedError"), what
    # the range check comes first
    bad = np.array([0, 5], np.uint64)
    assert _both(sides, lambda s: s.e.mixed(bad, bad, np.array(
        [True, False])))[1] == "KeyRangeError"
    with pytest.raises(KeyRangeError):
        p.e.mixed(bad, bad, np.array([True, False]))
    # reads keep serving, all-read mixed batches too
    v, f = _both(sides, lambda s: s.e.search(keys[:64]))[1]
    assert f.all()
    _both(sides, lambda s: s.e.search_combined(keys[:64]))
    _, fnd, _ = _both(sides, lambda s: s.e.mixed(keys[:4], keys[:4],
                                                 np.ones(4, bool)))[1]
    assert fnd.all()
    # a search of the flagged page's own keys answers as the reference's
    pk = _both(sides, lambda s: _page_keys(s, victim))[1]
    _both(sides, lambda s: s.e.search(pk))
    _both(sides, lambda s: s.e.search_combined(pk))
    # the full validator agrees, with the reference's message
    assert _both(sides, lambda s: s.V.check_structure_device(s.t)
                 )[1] == "TreeCorruptError"
    with pytest.raises(TreeCorruptError, match="bad_version"):
        TV.check_structure_device(p.t)


@pytest.mark.parametrize("n", [1, 4])
def test_entry_level_violation_quarantines_without_degrading(
        eight_devices, n):
    sides, keys = _small(n)
    victim, la = _both(sides, lambda s: _victim(s, keys))[1]
    _both(sides, lambda s: s.fire([{"kind": "flip_entry_ver", "step": 0,
                                    "addr": victim, "slot": 0}]).describe())
    scr = _scrubbers(sides, interval=1)
    res = _both(sides, lambda s: scr[s.jax].scrub())[1]
    assert res["violations"] == 1 and res["classes"]["torn_slot"] == 1
    assert res["classes"]["bad_version"] == 0 and not res["degraded"]
    st = _both(sides, lambda s: s.e.insert(keys[:8], keys[:8]))[1]
    assert st["applied"] + st["superseded"] == 8
    # a write to the quarantined page ends in the typed lock timeout
    pk = _both(sides, lambda s: _page_keys(s, victim))[1]
    st = _both(sides, lambda s: s.e.insert(pk[:3], pk[:3]))[1]
    assert st["lock_timeouts"] == 3
    status = _both(sides, lambda s: s.e.mixed(
        pk[:2], pk[:2], np.zeros(2, bool)))[1][2]
    assert (status == TB.ST_LOCK_TIMEOUT).all()
    # its keys read as the reference reads them
    _both(sides, lambda s: s.e.search(pk))
    with pytest.raises(TreeCorruptError, match="bad_torn_slot"):
        TV.check_structure_device(sides[1].t)


@pytest.mark.parametrize("n", [1, 4])
def test_quarantine_revokes_a_dead_holder_and_degrades_on_a_live_one(
        eight_devices, n):
    sides, keys = _small(n)
    victim, la = _both(sides, lambda s: _victim(s, keys))[1]
    # a dead lease wedged on the page's lock: revoked, then taken
    _both(sides, lambda s: s.fire([
        {"kind": "flip_entry_ver", "step": 0, "addr": victim, "slot": 2},
        {"kind": "wedge_lock", "step": 0, "addr": la}]).describe())
    scr = _scrubbers(sides, interval=1)
    res = _both(sides, lambda s: scr[s.jax].scrub())[1]
    assert res["quarantined"] == 1 and not res["degraded"]
    # a live holder on another page's lock: containment fails, degrade
    other, la2 = _both(sides, lambda s: _victim(s, keys, at=100))[1]
    assert la2 != la
    _both(sides, lambda s: s.d.write_word(
        la2, 0, s.c.register_client().lease, space=D.SPACE_LOCK))
    _both(sides, lambda s: s.fire([{"kind": "flip_entry_ver", "step": 0,
                                    "addr": other, "slot": 4}]).describe())
    res = _both(sides, lambda s: scr[s.jax].scrub())[1]
    assert res["new_violations"] == 1 and res["degraded"]
    assert "could not take its lock" in sides[1].e.degraded_reason


@pytest.mark.parametrize("n", [1, 4])
def test_repair_release_and_exit(eight_devices, n):
    """The exit used in place of the checkpoint restore: undo the faults,
    validate green, scrub clean, release the quarantine, exit degraded
    mode; writes land again."""
    sides, keys = _small(n)
    victim, la = _both(sides, lambda s: _victim(s, keys))[1]
    plans = {s.jax: s.fire([{"kind": "torn_page", "step": 0,
                             "addr": victim}]) for s in sides}
    _same(*sides)
    scr = _scrubbers(sides, interval=1)
    assert _both(sides, lambda s: scr[s.jax].scrub())[1]["degraded"]
    assert _both(sides, lambda s: plans[s.jax].undo(s.d))[1] == 1
    assert _both(sides, lambda s: s.V.check_structure_device(s.t)
                 )[1]["keys"] == keys.size
    assert _both(sides, lambda s: s.V.scrub_pass(s.t))[1]["violations"] == 0
    assert _both(sides, lambda s: scr[s.jax].release_quarantine())[1] == 1
    assert scr[False].damaged_addrs() == []
    _both(sides, lambda s: s.e.exit_degraded())
    assert not sides[1].e.degraded
    st = _both(sides, lambda s: s.e.insert(keys[740:760], keys[740:760]))[1]
    assert st["applied"] + st["superseded"] == 20


def test_scrubber_tick_interval(eight_devices):
    sides, _ = _small(1)
    scr = Scrubber(sides[1].e, interval=3, quarantine=False)
    assert scr.tick() is None and scr.tick() is None
    assert scr.tick() is not None


# -- lock-lease recovery under wedged locks -----------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_engine_bounded_retry_revokes_a_dead_lease(eight_devices, n):
    sides, keys = _small(n)
    victim, la = _both(sides, lambda s: _victim(s, keys))[1]
    _both(sides, lambda s: s.fire([{"kind": "wedge_lock", "step": 0,
                                    "addr": la}]).describe())
    band = keys[keys.size // 2: keys.size // 2 + 6]
    st = _both(sides, lambda s: s.e.insert(band, band))[1]
    assert st["lock_timeouts"] == 0
    assert st["applied"] + st["superseded"] + st["host_path"] == band.size
    assert _both(sides, lambda s: s.d.read_word(la, 0, space=D.SPACE_LOCK)
                 )[1] == 0
    assert _both(sides, lambda s: s.e.search(band))[1][1].all()


@pytest.mark.parametrize("n", [1, 4])
def test_engine_lock_timeout_is_typed(eight_devices, n):
    sides, keys = _small(n)
    victim, la = _both(sides, lambda s: _victim(s, keys))[1]
    _both(sides, lambda s: s.d.write_word(
        la, 0, s.c.register_client().lease, space=D.SPACE_LOCK))
    band = keys[keys.size // 2: keys.size // 2 + 4]
    st = _both(sides, lambda s: s.e.insert(band, band))[1]
    assert st["lock_timeouts"] == band.size
    assert sorted(st["lock_timeout_keys"]) == sorted(int(k) for k in band)
    status = _both(sides, lambda s: s.e.mixed(
        band, band ^ np.uint64(1), np.zeros(band.size, bool)))[1][2]
    assert (status == TB.ST_LOCK_TIMEOUT).all()
    _both(sides, lambda s: s.d.write_word(la, 0, 0, space=D.SPACE_LOCK))
    st = _both(sides, lambda s: s.e.insert(band, band))[1]
    assert st["applied"] + st["superseded"] == band.size


# -- the chaos fuzz -------------------------------------------------------------

def test_fuzz_chaos_detection_in_lockstep(eight_devices):
    """tests/test_fuzz.py's chaos fuzz, both packages in lockstep: every
    iteration fires a fresh seeded plan, scrubs (detection), inserts 100
    keys (typed outcomes or DegradedError), repairs (undo, exit degraded)
    and checks 200 searches against the model; the scrub results, stats,
    answers and state equal at every iteration."""
    rng = np.random.default_rng(42)
    kw = dict(pages_per_node=2048, locks_per_node=512, step_capacity=512,
              chunk_pages=64)
    sides = (Side(True, 4, **kw), Side(False, 4, **kw))
    keyspace = np.unique(rng.integers(1, 1 << 56, 4000, dtype=np.uint64))
    k0 = keyspace[: keyspace.shape[0] // 2]
    model = dict(zip(k0.tolist(), (k0 * np.uint64(3)).tolist()))
    for s in sides:
        s.B.bulk_load(s.t, k0, k0 * np.uint64(3))
        s.e.attach_router()
    scr = _scrubbers(sides, interval=1, quarantine=False)
    for it in range(8):
        plans = {s.jax: s.fire(s.CH.FaultPlan.random(1000 + it, n_faults=2,
                                                     step_hi=1))
                 for s in sides}
        assert plans[False].describe() == plans[True].describe()
        assert plans[False]._undo == plans[True]._undo
        _same(*sides, f"it {it} fire")
        res = _both(sides, lambda s: scr[s.jax].scrub(), f"it {it} scrub")[1]
        if any(f.kind in ("torn_page", "flip_entry_ver")
               for f in plans[False].faults):
            assert res["violations"] >= 1, (it, plans[False].describe())
        ks = rng.choice(keyspace, size=100, replace=True)
        vs = ks ^ np.uint64(it * 31 + 7)
        out = _both(sides, lambda s: s.e.insert(ks, vs), f"it {it} insert")
        if out[0] == "ok":
            st = out[1]
            assert (st["applied"] + st["superseded"] + st["host_path"]
                    + st["lock_timeouts"]) == ks.size, st
            timed_out = set(st["lock_timeout_keys"])
            for i in sorted(np.unique(ks, return_index=True)[1]):
                if int(ks[i]) not in timed_out:
                    model[int(ks[i])] = int(vs[i])
        else:
            assert out[1] == "DegradedError", out
        _both(sides, lambda s: plans[s.jax].undo(s.d), f"it {it} undo")
        for s in sides:
            scr[s.jax].flagged.clear()
            s.e.exit_degraded()
        probe = rng.choice(keyspace, size=200, replace=False)
        v, f = _both(sides, lambda s: s.e.search(probe), f"it {it} probe")[1]
        np.testing.assert_array_equal(f, [int(k) in model for k in probe])
        np.testing.assert_array_equal(
            v[f], np.array([model[int(k)] for k in probe[f]], np.uint64))
    assert _both(sides, lambda s: scr[s.jax].scrub())[1]["violations"] == 0
    assert _both(sides, lambda s: s.V.check_structure_device(s.t)
                 )[1]["keys"] == len(model)
