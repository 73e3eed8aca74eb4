"""Port parity: the recovery plane (``sherman_tpu_torch/recovery.py``),
the engine's journal hooks and the state hand-over's free pools, against
the JAX package, at one node and at four.

Both packages run one op sequence through a ``RecoveryPlane`` each: the
journal segments they write are byte-identical, their deltas carry equal
rows and pages, and after a crash with a torn tail ``recover`` gives RPO
0 with recovered pools, lock tables, counters and directories
bit-identical to each other's — also when each package recovers the
other's directory.  ``targeted_repair`` runs the reference's three cases
(a restorable page, a page split since the chain tip, a lowered version)
and its typed failure in lockstep, and the crash-before-save retired
segment, the ack-carry bound and group commit keep the reference's
contracts.  The JAX side runs as its own tests run it
(``gather_impl="xla"``, the ``eight_devices`` fixture).  Every
comparison is exact.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu import recovery as JRC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models import validate as JV
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.models.scrub import Scrubber as JScrubber
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.utils import checkpoint as JCK
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch import state
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models import validate as TV
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.models.scrub import Scrubber
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import journal as J

torch.set_num_threads(1)

U64 = np.uint64


class Side:
    """One package's cluster, tree, engine and module handles."""

    def __init__(self, jax_side: bool, n: int, pages: int = 512):
        self.jax = jax_side
        (self.B, self.RC, self.J, self.CK, self.CH, self.V,
         self.Scrubber) = ((JB, JRC, JJ, JCK, JCH, JV, JScrubber) if jax_side
                           else (TB, RC, J, CK, CH, TV, Scrubber))
        self.TreeConfig = JTreeConfig if jax_side else TreeConfig
        kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=256,
                  step_capacity=256, chunk_pages=64)
        self.c = (JCluster(JDSMConfig(gather_impl="xla", **kw)) if jax_side
                  else Cluster(DSMConfig(device="cpu", **kw)))
        self.t = (JTree if jax_side else Tree)(self.c)
        self.e = self.B.BatchedEngine(
            self.t, batch_per_node=128, write_combine=False,
            tcfg=self.TreeConfig(sibling_chase_budget=1,
                                 lock_retry_rounds=2))
        self.d = self.c.dsm
        self.plane = None

    def adopt(self, ctx):
        """Take a recovered (plane, cluster, tree, engine, receipt)."""
        self.plane, self.c, self.t, self.e, receipt = ctx
        self.d = self.c.dsm
        return receipt

    def recover(self, rdir):
        kw = {} if self.jax else {"device": "cpu"}
        return self.RC.RecoveryPlane.recover(
            rdir, batch_per_node=128,
            tcfg=self.TreeConfig(sibling_chase_budget=1,
                                 lock_retry_rounds=2), **kw)

    def fire(self, faults):
        plan = self.CH.FaultPlan([dict(f) for f in faults])
        self.d.install_chaos(plan)
        self.d.read_word(0, 0)
        self.d.install_chaos(None)
        assert plan.exhausted
        return plan


def _dirs(c):
    return [(d.node_id, d.allocator._next, d.root_ptr, d.root_level,
             d.allocator.free_pages_list) for d in c.directories]


def _same(j, p, what=""):
    np.testing.assert_array_equal(p.d.pool.numpy(), np.asarray(j.d.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(p.d.locks.numpy(), np.asarray(j.d.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(p.d.counters_np(), np.asarray(j.d.counters),
                                  err_msg=what + " counters")
    np.testing.assert_array_equal(p.d.dirty_rows(), j.d.dirty_rows(),
                                  err_msg=what + " dirty")
    assert _dirs(p.c) == _dirs(j.c), what
    assert p.e.degraded_reason == j.e.degraded_reason, what


def _eq(a, b, what=""):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(b, a, err_msg=what)
    elif isinstance(a, (tuple, list)):
        assert len(b) == len(a), what
        for x, y in zip(a, b):
            _eq(x, y, what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}[{k}]")
    else:
        assert b == a, what


def _outcome(fn):
    try:
        return ("ok", fn())
    except (RuntimeError, ValueError) as e:
        return ("raised", type(e).__name__)


def _both(sides, fn, what=""):
    """``fn(side)`` on both sides: equal outcomes, then equal state.
    -> the port's outcome."""
    out = [_outcome(lambda s=s: fn(s)) for s in sides]
    _eq(out[0], out[1], what)
    _same(*sides, what)
    return out[1]


def _build(n, pages=512, seed=5, nkeys=700, reclaim=True):
    """Both sides: bulk-load, delete every fifth key and a band, three
    reclaim passes (free pools filled).  -> (sides, keys, live model)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 56, int(nkeys * 1.1),
                                  dtype=U64))[:nkeys]
    vals = keys ^ U64(0xABCD)
    sides = (Side(True, n, pages), Side(False, n, pages))
    dead = np.union1d(keys[::5], keys[200:320]) if reclaim \
        else np.zeros(0, U64)
    for s in sides:
        s.B.bulk_load(s.t, keys, vals)
        s.e.attach_router()
        if reclaim:
            s.e.delete(dead)
            for _ in range(3):
                s.e.reclaim_empty_leaves()
    if reclaim:
        assert any(d.allocator.free_pages_list for d in sides[1].c.directories)
    model = dict(zip(keys.tolist(), vals.tolist()))
    for k in dead.tolist():
        del model[k]
    _same(*sides, "built")
    return sides, keys, model


def _rpo(side, model, absent=()):
    """Acknowledged ops missing from the side's tree: keys absent or with
    another value, deleted or never-acked keys present."""
    lk = np.asarray(sorted(model), U64)
    got, found = side.e.search(lk)
    want = np.asarray([model[int(k)] for k in lk], U64)
    missing = int((~found).sum()) + int((got[found] != want[found]).sum())
    gone = np.asarray(sorted(set(absent) - set(model)), U64)
    if gone.size:
        missing += int(side.e.search(gone)[1].sum())
    return missing


def _segments(rdir):
    return sorted(glob.glob(os.path.join(rdir, "journal-*.wal")))


# ---------------------------------------------------------------------------
# The state hand-over's free pools.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_from_jax_arrays_carries_the_free_pools(eight_devices, n):
    """A reclaimed JAX tree handed to the port: with ``free_pages`` the
    allocators' pools carry over and an insert batch that splits leaves
    allocates exactly as JAX does; without them the port takes fresh bump
    space where JAX pops its pool, and the pools diverge at the first
    split."""
    sides, keys, _ = _build(n)
    j = sides[0]
    free = [JBITS.make_addr(d.node_id, p) & 0xFFFFFFFF
            for d in j.c.directories for p in d.allocator.free_pages_list]
    assert free
    arrays = (np.asarray(j.d.pool), np.asarray(j.d.locks),
              np.asarray(j.d.counters), j.t._root_addr, j.t._root_level,
              [d.allocator.pages_used for d in j.c.directories])
    kw = dict(device="cpu", batch_per_node=128, step_capacity=256,
              chunk_pages=64, tcfg=TreeConfig(sibling_chase_budget=1))
    fresh = np.arange(1, 600, dtype=U64) * U64(1 << 40) + U64(3)
    outs = {}
    for carry in (True, False):
        pc, pt, pe = state.from_jax_arrays(
            *arrays, free_pages=free if carry else (), **kw)
        assert _dirs(pc)[0][4] == (_dirs(j.c)[0][4] if carry else [])
        pe.attach_router()
        outs[carry] = (pc, pe.insert(fresh, fresh ^ U64(1)))
    # a fresh JAX client: chunk leases are client state, not carried
    je = JB.BatchedEngine(JTree(j.c), batch_per_node=128,
                          write_combine=False,
                          tcfg=JTreeConfig(sibling_chase_budget=1))
    je.attach_router()
    st = je.insert(fresh, fresh ^ U64(1))
    pc, pst = outs[True]
    assert pst == st and st["device_splits"] > 0
    np.testing.assert_array_equal(pc.dsm.pool.numpy(), np.asarray(j.d.pool))
    assert _dirs(pc) == _dirs(j.c)
    # the fault the argument closes: no carry, another allocation order
    assert not np.array_equal(outs[False][0].dsm.pool.numpy(),
                              np.asarray(j.d.pool))


# ---------------------------------------------------------------------------
# Engine journaling, the recovery plane, crash recovery.
# ---------------------------------------------------------------------------

def test_engine_journaling_matches_applied(eight_devices, tmp_path):
    """insert/delete/mixed append exactly their applied rows, in the
    reference's record order, byte for byte; lock-timeout rejections and
    not-found deletes stay out; replay onto a fresh tree converges."""
    sides, keys, model = _build(4, reclaim=False)
    for s in sides:
        s.e.attach_journal(s.J.Journal(str(tmp_path / f"{s.jax}.wal")))
    v2 = keys[:40] ^ U64(1)
    _both(sides, lambda s: s.e.insert(keys[:40], v2))
    _both(sides, lambda s: s.e.delete(np.append(keys[:10], U64(12345))))
    is_read = np.zeros(60, bool)
    is_read[:15] = True
    # write rows that need the split path retry through insert()
    mk = np.concatenate([keys[40:70], np.arange(1, 31, dtype=U64)
                         * U64(1 << 50)])
    _both(sides, lambda s: s.e.mixed(mk, mk ^ U64(2), is_read))
    # a held lock: its key is rejected with the typed timeout, unjournaled
    la = _both(sides, lambda s: s.t._lock_word_addr(
        int(s.t._descend(int(keys[500]))[0])))[1]
    _both(sides, lambda s: s.d.write_word(
        la, 0, s.c.register_client().lease, space=1))
    st = _both(sides, lambda s: s.e.insert(keys[495:505], keys[495:505]))[1]
    assert st["lock_timeouts"] >= 1
    for s in sides:
        s.e.journal.close()
    blobs = [open(str(tmp_path / f"{s.jax}.wal"), "rb").read()
             for s in sides]
    assert blobs[0] == blobs[1]
    recs = J.read_records(str(tmp_path / "False.wal"))
    kinds = [r[0] for r in recs]
    assert kinds[:2] == [J.J_UPSERT, J.J_DELETE] and len(recs) >= 4
    np.testing.assert_array_equal(recs[1][1], keys[:10])
    last = recs[-1][1]
    assert not np.isin(np.asarray(st["lock_timeout_keys"], U64), last).any()
    mixed_keys = np.concatenate([r[1] for r in recs[2:-1]])
    np.testing.assert_array_equal(np.sort(mixed_keys), np.sort(mk[~is_read]))
    # replay onto a fresh tree reproduces the journaled writes
    fresh = Side(False, 4)
    TB.bulk_load(fresh.t, keys, keys ^ U64(0xABCD))
    fresh.e.attach_router()
    J.replay(str(tmp_path / "False.wal"), fresh.e)
    w = ~is_read
    for e in (sides[1].e, fresh.e):
        assert not e.search(keys[:10])[1].any()
        np.testing.assert_array_equal(e.search(keys[10:40])[0], v2[10:])
        np.testing.assert_array_equal(e.search(mk[w])[0], mk[w] ^ U64(2))


@pytest.mark.parametrize("n", [1, 4])
def test_recovery_plane_crash_rpo_zero(eight_devices, tmp_path, n):
    """One op sequence through both packages' planes: byte-identical
    segments, equal deltas; after a crash with a torn tail each package
    recovers its own directory and the other's with RPO 0, bit-identical
    recovered state, the torn record absent, and journaling goes on."""
    sides, keys, model = _build(n)
    dirs = {s.jax: str(tmp_path / ("jax" if s.jax else "port"))
            for s in sides}
    for s in sides:
        s.plane = s.RC.RecoveryPlane(s.c, s.t, s.e, dirs[s.jax],
                                     group_commit_ms=0.5)
    _both(sides, lambda s: s.plane.checkpoint_base()["bytes"] > 0)
    absent = set()

    def ins(ks, vs):
        st = _both(sides, lambda s: s.e.insert(ks, vs))[1]
        assert st["lock_timeouts"] == 0
        model.update(zip(ks.tolist(), vs.tolist()))

    def dele(ks):
        found = _both(sides, lambda s: s.e.delete(ks))[1]
        for k in ks[found].tolist():
            model.pop(k)
            absent.add(k)

    ins(keys[:64], keys[:64] ^ U64(0x11))
    dele(keys[64:90])
    mk = np.concatenate([keys[100:140], np.arange(1, 41, dtype=U64)
                         * U64(1 << 48)])
    rd = np.zeros(mk.size, bool)
    rd[::3] = True
    _both(sides, lambda s: s.e.mixed(mk, mk ^ U64(0x33), rd))
    model.update(zip(mk[~rd].tolist(), (mk[~rd] ^ U64(0x33)).tolist()))
    _both(sides, lambda s: s.e.reclaim_empty_leaves())
    info = _both(sides, lambda s: {k: v for k, v in
                                   s.plane.checkpoint_delta().items()
                                   if k in ("pages",)})[1]
    assert info["pages"] > 0
    zs = [np.load(s.plane.delta_paths[0]) for s in sides]
    for k in ("delta_rows", "delta_pages", "locks", "counters", "dir_free"):
        np.testing.assert_array_equal(zs[1][k], zs[0][k], err_msg=k)
    ins(keys[150:214], keys[150:214] ^ U64(0x22))
    dele(np.append(keys[400:410], U64(7)))
    segs = [_segments(dirs[s.jax]) for s in sides]
    assert len(segs[0]) == len(segs[1]) == 1
    assert open(segs[1][0], "rb").read() == open(segs[0][0], "rb").read()
    torn = 1 << 40
    for s, seg in zip(sides, segs):
        s.plane.close()
        rec = s.J.encode_record(s.J.J_UPSERT, np.asarray([torn], U64),
                                np.asarray([1], U64))
        with open(seg[0], "ab") as f:
            f.write(rec[: len(rec) - 3])
    absent.add(torn)
    # each package recovers a copy of the other's directory too
    for s in sides:
        shutil.copytree(dirs[s.jax], dirs[s.jax] + "-x")
    crossed = {s.jax: Side(s.jax, n) for s in sides}
    rec = [s.adopt(s.recover(dirs[s.jax])) for s in sides]
    # (the chain ids are the bases' random nonces)
    _eq([(r["chain"]["deltas"], r["replay"]) for r in rec[0:1]],
        [(r["chain"]["deltas"], r["replay"]) for r in rec[1:2]])
    assert rec[1]["replay"]["records"] >= 2
    assert rec[1]["chain"]["deltas"] == 1
    _same(*sides, "recovered")
    x = (crossed[True], crossed[False])
    for s in x:
        s.adopt(s.recover(dirs[not s.jax] + "-x"))
    _same(x[0], sides[1], "JAX recovering the port's directory")
    _same(sides[0], x[1], "the port recovering JAX's directory")
    for s in sides:
        assert _rpo(s, model, absent) == 0
    assert _both(sides, lambda s: s.V.check_structure_device(s.t)
                 )[1]["keys"] == len(model)
    st = _both(sides, lambda s: s.e.insert(keys[:8], keys[:8]))[1]
    assert st["applied"] == 8
    assert len(J.read_records(sides[1].e.journal.path)) == 1
    assert sides[1].e.journal.group_commit_ms == 0.0
    for s in sides:
        s.plane.close()


# ---------------------------------------------------------------------------
# Targeted repair.
# ---------------------------------------------------------------------------

def _dense_split(sides, keys, at, xor):
    """Insert a dense run inside the leaf holding ``keys[at]`` until it
    splits after the chain tip.  -> (victim, dense keys)."""
    victim = _both(sides, lambda s: int(s.t._descend(int(keys[at]))[0]))[1]
    pg = _both(sides, lambda s: s.d.read_page(victim))[1]
    from sherman_tpu_torch.ops import layout
    lo, hi = layout.np_lowest(pg), layout.np_highest(pg)
    dense = np.arange(max(1, lo), min(hi, max(1, lo) + 80), dtype=U64)[:64]
    st = _both(sides, lambda s: s.e.insert(dense, dense ^ U64(xor)))[1]
    assert st["lock_timeouts"] == 0
    assert int(_both(sides, lambda s: s.d.read_page(victim))[1][0]) \
        > int(pg[0]), "no split"
    return victim, dense


@pytest.mark.parametrize("case", ["restorable", "split_since_tip",
                                  "lowered_version"])
def test_targeted_repair_cases(eight_devices, tmp_path, monkeypatch, case):
    """The reference's three repair cases, both packages in lockstep: the
    repair's receipt and every state after it equal, no full restore,
    degraded mode left, every key right, writes accepted again."""
    sides, keys, model = _build(4, pages=1024, seed=13, nkeys=800,
                                reclaim=False)
    for s in sides:
        s.plane = s.RC.RecoveryPlane(s.c, s.t, s.e,
                                     str(tmp_path / str(s.jax)))
    _both(sides, lambda s: s.plane.checkpoint_base()["cid"] is not None)
    restores = []
    for mod in (CK, JCK):
        for name in ("restore", "restore_chain"):
            monkeypatch.setattr(mod, name, lambda *a, **kw: restores.append(
                a))
    if True:
        v1 = keys[:64] ^ U64(0x31)
        _both(sides, lambda s: s.e.insert(keys[:64], v1))
        model.update(zip(keys[:64].tolist(), v1.tolist()))
        scr = {s.jax: s.Scrubber(s.e, interval=1) for s in sides}
        assert _both(sides, lambda s: scr[s.jax].scrub())[1][
            "violations"] == 0
        if case == "restorable":
            victim = _both(sides, lambda s: int(s.t._descend(
                int(keys[400]))[0]))[1]
            faults = [{"kind": "torn_page", "step": 0, "addr": victim},
                      {"kind": "flip_entry_ver", "step": 0, "addr": victim,
                       "slot": 1}]
        else:
            victim, dense = _dense_split(sides, keys, 400 if case ==
                                         "split_since_tip" else 300, 0x5050)
            model.update(zip(dense.tolist(),
                             (dense ^ U64(0x5050)).tolist()))
            faults = [{"kind": "torn_page", "step": 0, "addr": victim},
                      {"kind": "flip_entry_ver", "step": 0, "addr": victim,
                       "slot": 3}]
        if case == "lowered_version":
            # version-LOWERING damage: zero the front half (the scrubber
            # sees an unwritten page; ground-truth addrs route the repair)
            _both(sides, lambda s: s.d.write_words(
                victim, 0, np.zeros(1, np.int32)))
            _both(sides, lambda s: s.e.enter_degraded(
                "test: zeroed front version on split page"))
            rep = _both(sides, lambda s: {
                k: v for k, v in s.plane.targeted_repair(
                    addrs=[victim]).items() if k != "repair_ms"})[1]
        else:
            _both(sides, lambda s: s.fire(faults).describe())
            res = _both(sides, lambda s: scr[s.jax].scrub())[1]
            assert res["violations"] >= 1 and sides[1].e.degraded
            rep = _both(sides, lambda s: {
                k: v for k, v in s.plane.targeted_repair(scr[s.jax]).items()
                if k != "repair_ms"})[1]
        assert rep["pages"] >= 1 and not sides[1].e.degraded
        assert (rep["stale_pages"] >= 1) == (case != "restorable")
        assert not restores
    monkeypatch.undo()
    assert _both(sides, lambda s: s.V.check_structure_device(s.t)
                 )[1]["keys"] == len(model)
    for s in sides:
        assert _rpo(s, model) == 0
    st = _both(sides, lambda s: s.e.insert(keys[:8], keys[:8]))[1]
    assert st["applied"] + st["superseded"] == 8
    for s in sides:
        s.plane.close()


def test_targeted_repair_failure_is_typed(eight_devices, tmp_path):
    """Damage outside the repaired set fails typed in both packages and
    the engine stays degraded."""
    sides, keys, _ = _build(4, seed=17, nkeys=400, reclaim=False)
    for s in sides:
        s.plane = s.RC.RecoveryPlane(s.c, s.t, s.e,
                                     str(tmp_path / str(s.jax)))
        s.plane.checkpoint_base()
    v1, v2 = (_both(sides, lambda s: int(s.t._descend(int(keys[i]))[0]))[1]
              for i in (100, 300))
    assert v1 != v2
    _both(sides, lambda s: s.fire([
        {"kind": "torn_page", "step": 0, "addr": v1},
        {"kind": "torn_page", "step": 0, "addr": v2}]).describe())
    scr = {s.jax: s.Scrubber(s.e, interval=1) for s in sides}
    assert _both(sides, lambda s: scr[s.jax].scrub())[1]["degraded"]
    for s in sides:
        scr[s.jax].flagged.pop(v2, None)
    out = _both(sides, lambda s: s.plane.targeted_repair(scr[s.jax],
                                                          addrs=[v1]))
    assert out == ("raised", "TargetedRepairFailed")
    assert issubclass(RC.TargetedRepairFailed, RC.ShermanError)
    assert sides[1].e.degraded
    assert _both(sides, lambda s: s.plane.targeted_repair()) == \
        ("ok", {"pages": 0, "ok": True, "repair_ms": 0.0})
    for s in sides:
        s.plane.close()


# ---------------------------------------------------------------------------
# Journal rotation contracts.
# ---------------------------------------------------------------------------

def test_delta_crash_before_save_keeps_retired_segment(eight_devices,
                                                       tmp_path,
                                                       monkeypatch):
    """checkpoint_delta rotates BEFORE the snapshot, and the retired
    segment survives until the delta is durable: a crash inside the save
    leaves both segments, which recover replays convergently, the ack
    window included; a successful delta sweeps to the live segment."""
    sides, keys, model = _build(4, seed=19, nkeys=500, reclaim=False)
    s = sides[1]
    rdir = str(tmp_path / "r")
    s.plane = RC.RecoveryPlane(s.c, s.t, s.e, rdir)
    s.plane.checkpoint_base()
    v1 = keys[:64] ^ U64(0x77)
    s.e.insert(keys[:64], v1)
    s.e.journal.append_acks([(901, "t", J.J_UPSERT, np.ones(64, bool))])

    def exploding_delta(*a, **kw):
        raise OSError("disk full mid-save (simulated crash)")

    monkeypatch.setattr(CK, "checkpoint_delta", exploding_delta)
    with pytest.raises(OSError):
        s.plane.checkpoint_delta()
    monkeypatch.undo()
    assert len(_segments(rdir)) == 2
    s.plane.close()
    r = Side(False, 4)
    r.adopt(r.recover(rdir))
    got, found = r.e.search(keys[:64])
    assert found.all()
    np.testing.assert_array_equal(got, v1)
    assert ("t", 901) in r.plane.dedup_window
    r.e.insert(keys[:16], v1[:16])
    r.plane.checkpoint_delta()
    assert len(_segments(rdir)) == 1
    r.plane.close()


@pytest.mark.parametrize("carry, want", [(2, [2, 3]), (0, [])])
def test_ack_carry_bound_and_disable(eight_devices, tmp_path, carry, want):
    """ack_carry bounds the re-forwarded window (most-recent wins), 0
    disables the carry; the carried segment is byte-identical to JAX's."""
    sides, keys, _ = _build(1, seed=23, nkeys=400, reclaim=False)
    blobs = []
    for s in sides:
        s.plane = s.RC.RecoveryPlane(s.c, s.t, s.e,
                                     str(tmp_path / str(s.jax)),
                                     ack_carry=carry)
        s.plane.checkpoint_base()
        for rid in (1, 2, 3):
            s.e.journal.append_acks([(rid, "t", s.J.J_UPSERT,
                                      np.ones(2, bool))])
        s.e.insert(keys[:8], keys[:8] ^ U64(carry + 1))
        s.plane.checkpoint_delta()
        sink: list = []
        s.J.replay(s.e.journal.path, s.e, ack_sink=sink)
        assert [r for r, *_ in sink] == want
        blobs.append(open(s.e.journal.path, "rb").read())
        s.plane.close()
    assert blobs[0] == blobs[1]
    _same(*sides)


def test_multihost_plane_is_not_ported(eight_devices, tmp_path):
    """The per-host chain namespaces, once refused, now held against JAX:
    a ``hosts=2`` plane a package writes host-tagged names and the same
    journal bytes, and both packages' ``recover_union`` over the two
    directories give equal receipts and pools; the typed refusals (no
    chain, no frontier, no repair before a base, a host outside the
    plane) are the reference's."""
    keys = np.unique(np.random.default_rng(9).integers(
        1, 1 << 56, 400, dtype=U64))[:300]
    sides, outs = [], []
    for jax_side in (True, False):
        rdir = str(tmp_path / ("j" if jax_side else "p"))
        cids, jbytes = [], []
        for h in (0, 1):
            s = Side(jax_side, 1)
            kh = keys[h::2]
            s.B.bulk_load(s.t, kh, kh ^ U64(0xABCD))
            s.e.attach_router()
            p = s.RC.RecoveryPlane(s.c, s.t, s.e, rdir, host_id=h, hosts=2)
            assert p._htag == h
            p.checkpoint_base()
            s.e.insert(kh[:20], kh[:20] ^ U64(0x5))
            p.checkpoint_delta()
            s.e.delete(kh[20:30])
            jbytes.append(open(s.e.journal.path, "rb").read())
            cids.append(p.cid)
            p.close()
        names = sorted(n.replace(cids[0], "C0").replace(cids[1], "C1")
                       for n in os.listdir(rdir))
        kw = {} if jax_side else {"device": "cpu"}
        ctxs, receipt = s.RC.RecoveryPlane.recover_union(
            rdir, hosts=2, batch_per_node=128, **kw)
        sides.append(ctxs)
        outs.append((names, jbytes, receipt["hosts"],
                     [c["host"] for c in receipt["chains"]],
                     [c["deltas"] for c in receipt["chains"]],
                     receipt["replay"]))
        for ctx in ctxs:
            ctx[0].close()
    assert outs[1] == outs[0]
    assert outs[1][0] == ["base-h0.npz", "base-h1.npz",
                          "delta-h0-C0-000001.npz", "delta-h1-C1-000001.npz",
                          "journal-h0-C0-000002.wal",
                          "journal-h1-C1-000002.wal"]
    assert outs[1][2:5] == (2, [0, 1], [1, 1])
    for (jc, pc) in zip(*sides):
        np.testing.assert_array_equal(pc[1].dsm.pool.numpy(),
                                      np.asarray(jc[1].dsm.pool))
        got, found = pc[3].search(keys)
        want = jc[3].search(keys)
        np.testing.assert_array_equal(found, want[1])
        np.testing.assert_array_equal(got, want[0])
    s = Side(False, 1)
    empty = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        RC.RecoveryPlane.recover(empty, device="cpu")
    with pytest.raises(FileNotFoundError):
        RC.RecoveryPlane.recover_union(empty, hosts=2, device="cpu")
    with pytest.raises(RC.StateError):
        RC.RecoveryPlane.recover_union(empty, hosts=1, device="cpu")
    with pytest.raises(RC.StateError):
        RC.RecoveryPlane(s.c, s.t, s.e, empty, host_id=2, hosts=2)
    p = RC.RecoveryPlane(s.c, s.t, s.e, empty)
    with pytest.raises(RC.StateError):
        p.journal_frontier()
    with pytest.raises(RC.StateError):
        p.targeted_repair(addrs=[1])
