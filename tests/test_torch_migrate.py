"""Port parity: the online migrator (``sherman_tpu_torch/migrate.py``) and
the DSM's dirty sinks, against the JAX package.

The ten cases of tests/test_migrate.py run once through each package on
the same seeded tree and op sequence: grow 4 -> 6 under traffic, shrink
4 -> 2, a crash and resume, a corrupt artifact dropped at resume, a lock
conflict deferred and a writer refused typed, a degraded abort, hot-key
cache coherence, the dirty sink riding a checkpoint's clear, an undersized
target refused at start, the ``migrate.`` collector.  Each side holds the
reference's own assertions; then the emitted checkpoint arrays, the
``migrate.*`` counters, the artifacts by ``seq`` (the migration id is a
nonce) and the restored tree's answers and pool must be equal.  Phase 27a's
sequence (``chip_smoke.resize_run``: grow under traffic, a delta with the
sink, a crash, ``resume``, the cutover, the offline reshard and the
restore, with and without a value heap) runs at 1 -> 4 and 4 -> 6 nodes in
both packages, every result equal.  The JAX side runs as its own tests run
it (``gather_impl="xla"``, the ``eight_devices`` fixture).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from sherman_tpu import migrate as JMG
from sherman_tpu import obs as JOBS
from sherman_tpu import recovery as JRC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.errors import ConfigError as JConfigError
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.models.validate import check_structure_device as JCSD
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.parallel import dsm as JD
from sherman_tpu.utils import checkpoint as JCK
from sherman_tpu.utils import journal as JJ
from sherman_tpu.utils import reshard as JRS
from sherman_tpu_torch import migrate as MG
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models.validate import check_structure_device
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import dsm as D

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402

torch.set_num_threads(1)

IDENT_KEYS = ("pool", "locks", "counters", "dir_nodes", "dir_next",
              "dir_root", "dir_free")


def _mods(jax_side: bool):
    """One package's handles (the ``chip_smoke.resize_run`` namespace plus
    what the cases use)."""
    if jax_side:
        return types.SimpleNamespace(
            Cluster=JCluster,
            cfg=lambda **kw: JDSMConfig(gather_impl="xla", **kw),
            TreeConfig=JTreeConfig, Tree=JTree, batched=JB, obs=JOBS,
            Migrator=JMG.Migrator, Aborted=JMG.MigrationAborted, CK=JCK,
            J=JJ, RS=JRS, D=JD, bits=JBITS, ConfigError=JConfigError,
            csd=JCSD, plane=JRC.RecoveryPlane,
            recover=lambda d, **kw: JRC.RecoveryPlane.recover(d, **kw),
            restore=lambda p: JCK.restore(p))
    ns = S.port_resize_mods("cpu")
    ns.Aborted = MG.MigrationAborted
    ns.D = D
    ns.bits = bits
    ns.ConfigError = ConfigError
    ns.csd = check_structure_device
    return ns


SIDES = (True, False)


def _cluster(m, nodes=4, pages=256, batch=64, **tc):
    cluster = m.Cluster(m.cfg(machine_nr=nodes, pages_per_node=pages,
                              locks_per_node=128, step_capacity=128,
                              chunk_pages=16))
    tree = m.Tree(cluster)
    eng = m.batched.BatchedEngine(
        tree, batch_per_node=batch,
        tcfg=m.TreeConfig(sibling_chase_budget=1, **tc))
    return cluster, tree, eng


def _load(m, tree, eng, n=1500, seed=3):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 48, int(n * 1.2),
                                  dtype=np.uint64))[:n]
    vals = keys * np.uint64(5)
    m.batched.bulk_load(tree, keys, vals)
    eng.attach_router()
    return keys, vals


def _summary(s: dict) -> dict:
    return {k: v for k, v in s.items()
            if k not in ("mid", "cutover_ms", "cutover_parts_ms", "dst")}


def _finish_and_pin(m, cluster, mig, tmp, target_nodes, ppn):
    """finish(), then the offline transform of the same final state:
    bit-identical.  -> (online path, summary, emitted arrays)."""
    online = os.path.join(tmp, "online.npz")
    summary = mig.finish(online)
    src = os.path.join(tmp, "final_src.npz")
    m.CK.checkpoint(cluster, src)
    offline = os.path.join(tmp, "offline.npz")
    m.RS.reshard(src, offline, target_nodes, pages_per_node=ppn)
    on, off = S._npz(online), S._npz(offline)
    for k in IDENT_KEYS:
        assert np.array_equal(on[k], off[k]), \
            f"online vs offline reshard differ on {k!r}"
    return online, _summary(summary), on


def _restore_and_verify(m, online, target_nodes, keys, val_of):
    cluster = m.restore(online)
    assert cluster.cfg.machine_nr == target_nodes
    tree = m.Tree(cluster)
    eng = m.batched.BatchedEngine(tree, batch_per_node=64)
    eng.attach_router()
    got, found = eng.search(keys)
    assert found.all(), f"lost {int((~found).sum())} keys in live reshard"
    np.testing.assert_array_equal(
        got, np.asarray([val_of[int(k)] for k in keys], np.uint64))
    m.csd(tree)
    return cluster, tree, eng


def _arts(mig) -> list:
    import glob
    out = {}
    for p in glob.glob(os.path.join(mig.dir, "migbatch-*.npz")):
        z = S._npz(p, drop=("mid", "integrity"))
        out[int(z["seq"][0])] = z
    return [out[k] for k in sorted(out)]


# -- the ten cases of tests/test_migrate.py, each a function of a side -------

def case_grow_under_traffic(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, vals = _load(m, tree, eng, n=1500)
    rng = np.random.default_rng(11)
    extra = np.unique(rng.integers(1 << 50, 1 << 51, 700,
                                   dtype=np.uint64))[:600]
    mig = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig"),
                     target_pages_per_node=256, batch_pages=16)
    info = mig.start()
    assert info["live_pages"] > 10
    val_of = dict(zip(keys.tolist(), vals.tolist()))
    out = [info["live_pages"]]
    i = 0
    while i < extra.size or not mig.copied_all:
        out.append(mig.step())
        if i < extra.size:
            b = extra[i:i + 100]
            eng.insert(b, b ^ np.uint64(0xAB))
            val_of.update((int(k), int(k ^ np.uint64(0xAB))) for k in b)
            i += 100
    dropped = keys[::9]
    gone = eng.delete(dropped)
    assert gone.all()
    for k in dropped.tolist():
        val_of.pop(int(k))
    assert mig.batches > 3 and mig.pages_moved >= info["live_pages"]
    online, summary, emitted = _finish_and_pin(m, cluster, mig, tmp, 6, 256)
    assert summary["retries"] > 0
    live_keys = np.asarray(sorted(val_of), np.uint64)
    c2, _, e2 = _restore_and_verify(m, online, 6, live_keys, val_of)
    _, fdel = e2.search(dropped)
    assert not fdel.any()
    fresh = np.unique(np.random.default_rng(7).integers(
        1 << 52, 1 << 53, 300, dtype=np.uint64))[:256]
    st = e2.insert(fresh, fresh)
    assert st["applied"] + st["superseded"] == fresh.size
    return out + [summary, S._mig_counters(mig), emitted, _arts(mig),
                  st["applied"], S._np(c2.dsm.pool), S._np(c2.dsm.counters)]


def case_shrink(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, vals = _load(m, tree, eng, n=1200)
    mig = m.Migrator(cluster, tree, eng, 2, os.path.join(tmp, "mig"),
                     batch_pages=32)
    mig.start()
    n = mig.run_to_copied()
    online, summary, emitted = _finish_and_pin(m, cluster, mig, tmp, 2, None)
    c2, _, _ = _restore_and_verify(m, online, 2, keys,
                                   dict(zip(keys.tolist(), vals.tolist())))
    return [n, summary, S._mig_counters(mig), emitted, _arts(mig),
            S._np(c2.dsm.pool)]


def case_crash_resume(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, vals = _load(m, tree, eng, n=1200)
    rdir = os.path.join(tmp, "rec")
    mdir = os.path.join(tmp, "mig")
    plane = m.plane(cluster, tree, eng, rdir)
    plane.checkpoint_base()
    acked = dict(zip(keys.tolist(), vals.tolist()))
    mig = m.Migrator(cluster, tree, eng, 6, mdir,
                     target_pages_per_node=256, batch_pages=16)
    mig.start()
    rng = np.random.default_rng(5)
    extra = np.unique(rng.integers(1 << 50, 1 << 51, 500,
                                   dtype=np.uint64))[:400]
    out = []
    for r in range(4):
        out.append(mig.step())
        b = extra[r * 100:(r + 1) * 100]
        st = eng.insert(b, b ^ np.uint64(0xCD))
        assert st["lock_timeouts"] == 0
        acked.update((int(k), int(k ^ np.uint64(0xCD))) for k in b)
        if r == 1:
            plane.checkpoint_delta()  # the dirty sink rides the clear
    staged_before = mig.staged_pages
    assert staged_before > 0 and mig.seq >= 4
    out.append(S._mig_counters(mig))
    jpath = eng.journal.path
    plane.close()
    mig.close()
    with open(jpath, "ab") as f:
        rec = m.J.encode_record(m.J.J_UPSERT, np.asarray([1], np.uint64),
                                np.asarray([2], np.uint64))
        f.write(rec[: len(rec) // 2])
    del cluster, tree, eng, mig
    plane, cluster, tree, eng, _ = m.recover(
        rdir, batch_per_node=64, tcfg=m.TreeConfig(sibling_chase_budget=1))
    mig = m.Migrator.resume(cluster, tree, eng, mdir, batch_pages=16)
    assert mig.resume_count == 1
    assert mig.staged_pages == staged_before
    out.append(S._mig_counters(mig))
    mig.run_to_copied()
    online, summary, emitted = _finish_and_pin(m, cluster, mig, tmp, 6, 256)
    assert summary["resume_verified"] > 0
    lk = np.asarray(sorted(acked), np.uint64)
    c2, _, _ = _restore_and_verify(m, online, 6, lk, acked)
    plane.close()
    return out + [summary, S._mig_counters(mig), emitted, _arts(mig),
                  S._np(c2.dsm.pool)]


def case_resume_drops_corrupt_artifact(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, vals = _load(m, tree, eng, n=800)
    mdir = os.path.join(tmp, "mig")
    mig = m.Migrator(cluster, tree, eng, 6, mdir,
                     target_pages_per_node=256, batch_pages=16)
    mig.start()
    mig.step()
    mig.step()
    art = mig._batch_path(1)
    blob = bytearray(open(art, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    open(art, "wb").write(bytes(blob))
    mig.close()
    m2 = m.Migrator.resume(cluster, tree, eng, mdir, batch_pages=16)
    out = [S._mig_counters(m2)]
    m2.run_to_copied()
    online, summary, emitted = _finish_and_pin(m, cluster, m2, tmp, 6, 256)
    _restore_and_verify(m, online, 6, keys,
                        dict(zip(keys.tolist(), vals.tolist())))
    return out + [summary, S._mig_counters(m2), emitted]


def case_lock_conflict(m, tmp):
    cluster, tree, eng = _cluster(m, lock_retry_rounds=2)
    keys, vals = _load(m, tree, eng, n=800)
    mig = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig"),
                     target_pages_per_node=256, batch_pages=1024)
    # (a) a foreign live client holds one leaf's lock word
    victim_key = int(keys[400])
    victim = int(tree._descend(victim_key)[0])
    holder = cluster.register_client()
    la = tree._lock_word_addr(victim)
    _, won = tree.dsm.cas(la, 0, 0, holder.lease, space=m.D.SPACE_LOCK)
    assert won
    mig.start()
    mig.run_to_copied(max_batches=3)
    P = cluster.cfg.pages_per_node
    vrow = m.bits.addr_node(victim) * P + m.bits.addr_page(victim)
    assert mig.lock_conflicts >= 1
    assert not mig.is_staged(vrow)
    out = [S._mig_counters(mig)]
    tree.dsm.write_word(la, 0, 0, space=m.D.SPACE_LOCK)
    mig.run_to_copied(max_batches=3)
    assert mig.is_staged(vrow)
    # (b) the migrator holds a batch; a writer to it is refused typed
    addrs, held = mig._acquire_locks([victim])
    assert addrs == [victim]
    st = eng.insert(np.asarray([victim_key], np.uint64),
                    np.asarray([123], np.uint64), max_rounds=3)
    assert st["lock_timeouts"] == 1
    assert st["lock_timeout_keys"] == [victim_key]
    mig._release_locks(held)
    st2 = eng.insert(np.asarray([victim_key], np.uint64),
                     np.asarray([123], np.uint64))
    assert st2["applied"] == 1
    got, found = eng.search(np.asarray([victim_key], np.uint64))
    assert found.all() and int(got[0]) == 123
    return out + [S._mig_counters(mig), st["lock_timeouts"],
                  S._np(cluster.dsm.pool), S._np(cluster.dsm.locks)]


def case_degraded_aborts(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, _ = _load(m, tree, eng, n=600)
    mig = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig"),
                     batch_pages=8)
    mig.start()
    mig.step()
    eng.enter_degraded("test damage")
    with pytest.raises(m.Aborted):
        mig.step()
    assert mig.aborted is not None
    ev = [e for e in m.obs.get_recorder().events()
          if e.get("kind") == "migrate.abort"]
    assert ev, "migrate.abort flight event missing"
    with pytest.raises(m.Aborted):
        mig.finish(os.path.join(tmp, "x.npz"))
    _, found = eng.search(keys[:32])
    assert found.all()
    eng.exit_degraded()
    m2 = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig2"),
                    batch_pages=8)
    eng.enter_degraded("still broken")
    with pytest.raises(m.Aborted):
        m2.start()
    return [mig.aborted, S._mig_counters(mig), len(ev)]


def case_leaf_cache_coherence(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, vals = _load(m, tree, eng, n=1000)
    cache = eng.attach_leaf_cache(slots=1024)
    hot = keys[::10][:200]
    cache.fill(hot)
    snap0 = m.obs.snapshot()
    mig = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig"),
                     target_pages_per_node=256, batch_pages=16)
    mig.start()
    rng = np.random.default_rng(9)
    answers = []
    while not mig.copied_all:
        mig.step()
        probe = rng.choice(hot, size=64, replace=True)
        got, found = eng.search(probe)
        assert found.all()
        np.testing.assert_array_equal(got, probe * np.uint64(5))
        answers.append(S._np(got))
        b = keys[rng.integers(0, keys.size, 20)]
        eng.insert(b, b * np.uint64(5))
    d = m.obs.delta(snap0, m.obs.snapshot())
    assert d.get("cache.invalidations", 0) > 0
    online, summary, emitted = _finish_and_pin(m, cluster, mig, tmp, 6, 256)
    _restore_and_verify(m, online, 6, keys,
                        dict(zip(keys.tolist(), vals.tolist())))
    return [answers, d["cache.invalidations"], summary,
            S._mig_counters(mig), emitted]


def case_dirty_sink_rides_clear(m, tmp):
    cluster, tree, eng = _cluster(m)
    keys, vals = _load(m, tree, eng, n=800)
    plane = m.plane(cluster, tree, eng, os.path.join(tmp, "rec"))
    plane.checkpoint_base()
    mig = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig"),
                     target_pages_per_node=256, batch_pages=2048)
    mig.start()
    mig.run_to_copied()
    st = eng.insert(keys[:64], keys[:64] ^ np.uint64(0x77))
    assert st["lock_timeouts"] == 0
    plane.checkpoint_delta()
    assert mig._dirt, "clear hid the post-copy writes from the migrator"
    dirt = sorted(mig._dirt)
    online, summary, emitted = _finish_and_pin(m, cluster, mig, tmp, 6, 256)
    val_of = dict(zip(keys.tolist(), vals.tolist()))
    val_of.update((int(k), int(k ^ np.uint64(0x77))) for k in keys[:64])
    _restore_and_verify(m, online, 6, keys, val_of)
    plane.close()
    return [dirt, summary, S._mig_counters(mig), emitted]


def case_undersized_target(m, tmp):
    cluster, tree, eng = _cluster(m)
    _load(m, tree, eng, n=1200)
    mig = m.Migrator(cluster, tree, eng, 2, os.path.join(tmp, "mig"),
                     target_pages_per_node=8, batch_pages=16)
    with pytest.raises(m.ConfigError, match="cannot fit") as ei:
        mig.start()
    assert not mig.started and mig.batches == 0
    assert not os.path.exists(mig._manifest_path())
    return [str(ei.value)]


def case_collector_snapshot(m, tmp):
    cluster, tree, eng = _cluster(m)
    _load(m, tree, eng, n=500)
    mig = m.Migrator(cluster, tree, eng, 6, os.path.join(tmp, "mig"),
                     batch_pages=8)
    mig.start()
    mig.step()
    snap = m.obs.snapshot()
    names = ("migrate.pages_moved", "migrate.batches", "migrate.retries",
             "migrate.lock_conflicts", "migrate.resume_count",
             "migrate.epoch", "migrate.in_progress",
             "migrate.resume_verified", "migrate.recopies_clean",
             "migrate.staged_pages", "migrate.dirt_backlog")
    for k in names:
        assert k in snap, k
    assert snap["migrate.pages_moved"] > 0
    assert snap["migrate.in_progress"] == 1
    return [{k: snap[k] for k in names}]


CASES = {
    "grow_under_traffic": case_grow_under_traffic,
    "shrink": case_shrink,
    "crash_resume": case_crash_resume,
    "resume_drops_corrupt_artifact": case_resume_drops_corrupt_artifact,
    "lock_conflict_defers_and_writer_rejects_typed": case_lock_conflict,
    "degraded_aborts_typed": case_degraded_aborts,
    "leaf_cache_coherence": case_leaf_cache_coherence,
    "dirty_sink_rides_checkpoint_clear": case_dirty_sink_rides_clear,
    "undersized_target_rejected_at_start": case_undersized_target,
    "collector_snapshot": case_collector_snapshot,
}


def _both(fn, tmp_path):
    """-> (jax result, port result) of one case."""
    out = []
    for jax_side in SIDES:
        d = tmp_path / ("jax" if jax_side else "torch")
        d.mkdir()
        out.append(fn(_mods(jax_side), str(d)))
    return out


def _assert_same(a, b, what):
    assert S._same_obj(a, b), f"{what}: {S._diff(a, b)}"


@pytest.mark.parametrize("name", list(CASES))
def test_migrate_case_matches_jax(eight_devices, tmp_path, name):
    want, got = _both(CASES[name], tmp_path)
    _assert_same(want, got, name)


@pytest.mark.parametrize("src,dst", S.RESIZE_CASES,
                         ids=[f"{a}to{b}" for a, b in S.RESIZE_CASES])
@pytest.mark.parametrize("heap", [False, True], ids=["heap_off", "heap_on"])
def test_resize_sequence_matches_jax(eight_devices, tmp_path, src, dst,
                                     heap):
    """Phase 27a's sequence at 1 -> 4 and 4 -> 6 nodes: the emitted arrays,
    the artifacts by seq, the migrate counters and dirt at every step, the
    offline reshard and the restored tree (with the heap: the rebuilt
    allocator, spare pages included) equal to the JAX package's."""
    runs = []
    for jax_side in SIDES:
        d = tmp_path / ("jax" if jax_side else "torch")
        d.mkdir()
        runs.append(S.resize_run(_mods(jax_side), src, dst, heap, str(d)))
    a, b = runs
    assert [x for x, _ in a] == [x for x, _ in b]
    for (label, x), (_, y) in zip(a, b):
        _assert_same(x, y, f"{src}->{dst} heap={heap}: {label}")
    if heap:
        assert dict(b)["heap rebuild"][0]["pages_carved"] > 0


# -- the dirty sinks ---------------------------------------------------------

def _sink_run(m):
    cluster, tree, eng = _cluster(m, nodes=2)
    keys, _ = _load(m, tree, eng, n=600)
    cluster.dsm.clear_dirty()
    seen, gone = [], []
    sink_a = lambda rows: seen.append(np.asarray(rows).copy())
    sink_b = lambda rows: gone.append(np.asarray(rows).copy())
    cluster.dsm.add_dirty_sink(sink_a)
    cluster.dsm.add_dirty_sink(sink_b)
    cluster.dsm.remove_dirty_sink(sink_b)
    cluster.dsm.remove_dirty_sink(sink_b)       # idempotent
    eng.insert(keys[:100], keys[:100] ^ np.uint64(1))
    tree.insert(int(keys[200]), 9)
    before = S._np(cluster.dsm.dirty_rows())
    cluster.dsm.clear_dirty()
    after = S._np(cluster.dsm.dirty_rows())
    cluster.dsm.clear_dirty()                   # nothing dirty: no call
    return [before, after, seen, gone]


def test_dirty_sink_sees_the_rows_before_the_reset(eight_devices):
    want, got = (_sink_run(_mods(j)) for j in SIDES)
    before, after, seen, gone = got
    assert before.size and not after.size
    assert len(seen) == 1 and np.array_equal(seen[0], before)
    assert gone == []
    _assert_same(want, got, "dirty sinks")


def test_migrator_refuses_a_multihost_dsm(tmp_path):
    cluster, tree, eng = _cluster(_mods(False), nodes=1)
    cluster.dsm.multihost = True
    from sherman_tpu_torch.errors import MultiprocessUnsupportedError
    with pytest.raises(MultiprocessUnsupportedError):
        MG.Migrator(cluster, tree, eng, 2, str(tmp_path / "mig"))


def test_batch_pages_knob(monkeypatch):
    for v, want in (("", 256), ("64", 64)):
        monkeypatch.setenv("SHERMAN_MIGRATE_BATCH_PAGES", v)
        assert MG._batch_pages_default() == want == \
            JMG._batch_pages_default()
    for v in ("0", "x"):
        monkeypatch.setenv("SHERMAN_MIGRATE_BATCH_PAGES", v)
        with pytest.raises(ConfigError):
            MG._batch_pages_default()
        with pytest.raises(JConfigError):
            JMG._batch_pages_default()
