"""Port parity: write combining (``BatchedEngine(write_combine=True)``,
``leaf_apply_spmd(combine=True)``) against the JAX package, and against
the port's own uncombined apply.

Combining consults a page group's lock word once, at the group's head,
and hands the verdict down the group.  With it on, the port must match
the JAX package bit for bit: statuses, pools, lock tables and every
counter, the ``combine_*`` slots included.  Against the port with it off,
everything but those two counter slots must be equal.  The JAX side runs
as its own tests run it (``gather_impl="xla"``, the ``eight_devices``
fixture).  Every tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu import config as JC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.ops import bits as JBits
from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)

COMBINE_SLOTS = [D.CNT_COMBINE_GROUPS, D.CNT_COMBINE_SAVED]


def _trio(n, B, keys, vals, *, pages=512, fill=0.9, router=True):
    """JAX with combining, the port with it, the port without it; each
    bulk-loaded with the same keys.  -> [(cluster, tree, engine)] * 3."""
    kw = dict(machine_nr=n, pages_per_node=pages, locks_per_node=256,
              step_capacity=B, chunk_pages=16)
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    out = [(jc, jt, JB.BatchedEngine(jt, batch_per_node=B,
                                     write_combine=True))]
    for combine in (True, False):
        pc = Cluster(DSMConfig(device="cpu", **kw))
        pt = Tree(pc)
        out.append((pc, pt, TB.BatchedEngine(pt, batch_per_node=B,
                                             write_combine=combine)))
    want = JB.bulk_load(jt, keys, vals, fill=fill)
    for _, t, _ in out[1:]:
        assert TB.bulk_load(t, keys, vals, fill=fill) == want
    if router:
        for _, _, e in out:
            e.attach_router()
    return out


def _state(c):
    d = c.dsm
    if hasattr(d.pool, "numpy"):
        return (d.pool.numpy(), d.locks.numpy(),
                d.counters_np().reshape(-1, D.N_COUNTERS), d.dirty_rows())
    return (np.asarray(d.pool), np.asarray(d.locks),
            np.asarray(d.counters).reshape(-1, D.N_COUNTERS),
            d.dirty_rows())


def _check(trio, what):
    """JAX-on == port-on in everything; port-on == port-off but for the
    combine counter slots, which the combined port must have moved."""
    j, on, off = (_state(x[0]) for x in trio)
    for a, b, name in zip(on, j, ("pool", "locks", "counters", "dirty")):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name} vs JAX")
    for a, b, name in zip(on, off, ("pool", "locks", "counters", "dirty")):
        if name == "counters":
            a, b = a.copy(), b.copy()
            assert not b[:, COMBINE_SLOTS].any(), what
            a[:, COMBINE_SLOTS] = 0
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name} vs off")
    assert (trio[1][2]._combine_steps, trio[1][2]._combine_rows) == \
        (trio[0][2]._combine_steps, trio[0][2]._combine_rows), what
    assert trio[2][2]._combine_steps == 0


def _raw(eng, keys, vals, use_router):
    """One insert step with no grants (the engine's round 0) -> status."""
    n = keys.shape[0]
    jax_side = isinstance(eng, JB.BatchedEngine)
    b = JBits if jax_side else bits
    khi, klo = b.keys_to_pairs(keys)
    vhi, vlo = b.keys_to_pairs(vals)
    pad = (lambda x: eng._pad(x)[0]) if jax_side else eng._pad
    put = eng._shard if jax_side else eng._dev
    khi, klo, vhi, vlo = (pad(x) for x in (khi, klo, vhi, vlo))
    fn = eng._get_insert(eng._iters(), use_router, with_fresh=False)
    args = [put(x) for x in (khi, klo, vhi, vlo)]
    args += [np.int32(eng.tree._root_addr) if jax_side
             else eng.tree._root_addr, put(pad(np.ones(n, bool)))]
    if use_router:
        args.append(put(eng.router.host_start(khi, klo)))
    d = eng.dsm
    if jax_side:
        d.pool, d.counters, d.dirty, st = fn(d.pool, d.locks, d.counters,
                                             d.dirty, *args)
        return np.asarray(st)[:n]
    return fn(d.pool, d.locks, d.counters, d.dirty, *args).numpy()[:n]


def test_write_combine_knob(monkeypatch):
    """``SHERMAN_WRITE_COMBINE`` parses as the JAX package's knob: off by
    default, the same spellings of on and off, a typed error otherwise;
    the engine reads it when ``write_combine`` is None."""
    for v, want in (("", False), ("0", False), (" off ", False),
                    ("False", False), ("no", False), ("1", True),
                    ("TRUE", True), ("on", True), (" yes", True)):
        monkeypatch.setenv("SHERMAN_WRITE_COMBINE", v)
        assert C.write_combine() is JC.write_combine() is want, v
    for v in ("2", "maybe"):
        monkeypatch.setenv("SHERMAN_WRITE_COMBINE", v)
        with pytest.raises(ConfigError):
            C.write_combine()
        with pytest.raises(ValueError):
            JC.write_combine()
    monkeypatch.delenv("SHERMAN_WRITE_COMBINE")
    assert C.write_combine() is False
    t = Tree(Cluster(DSMConfig(device="cpu", pages_per_node=64,
                               locks_per_node=64, step_capacity=64)))
    assert TB.BatchedEngine(t, 64)._write_combine is False
    monkeypatch.setenv("SHERMAN_WRITE_COMBINE", "1")
    assert TB.BatchedEngine(t, 64)._write_combine is True
    assert TB.BatchedEngine(t, 64, write_combine=False)._write_combine \
        is False


@pytest.mark.parametrize("n", [1, 8])
def test_insert_with_write_combine(eight_devices, n):
    """Same-leaf groups, singles and fresh keys into full leaves: one raw
    step, then ``insert`` with its split rounds."""
    B = 256 if n == 1 else 64
    keys = np.arange(100, 100 + 3000 * 3, 3, dtype=np.uint64)
    trio = _trio(n, B, keys, keys * np.uint64(7), pages=512 if n == 1
                 else 128)
    upd = np.concatenate([np.repeat(keys[100:140], 4), keys[500:520],
                          np.arange(keys[-1] + 10, keys[-1] + 190, 3,
                                    dtype=np.uint64)])[:n * B]
    v = upd ^ np.uint64(0xBEEF)
    sts = [_raw(x[2], upd, v, True) for x in trio]
    np.testing.assert_array_equal(sts[1], sts[0])
    np.testing.assert_array_equal(sts[2], sts[0])
    assert {TB.ST_APPLIED, TB.ST_SUPERSEDED} <= set(sts[1].tolist())
    _check(trio, "raw step")
    snap = trio[1][0].dsm.counter_snapshot()
    assert snap["combine_groups"] > 0 and snap["combine_locks_saved"] > 0
    rng = np.random.default_rng(n)
    q = np.concatenate([upd, rng.choice(keys, 300), np.arange(
        keys[-1] + 200, keys[-1] + 200 + 3 * 400, 3, dtype=np.uint64)])
    rng.shuffle(q)
    stats = [x[2].insert(q, q + np.uint64(1)) for x in trio]
    assert stats[1] == stats[0] == stats[2]
    assert stats[1]["device_splits"] > 0 and stats[1]["host_path"] == 0
    _check(trio, "insert")


@pytest.mark.parametrize("n", [1, 8])
def test_mixed_with_write_combine(eight_devices, n):
    """A duplicate-heavy 50/50 read/write batch, twice, then writes that
    need the split path (retried through ``insert``)."""
    B = 256 if n == 1 else 64
    keys = np.arange(100, 100 + 3000 * 3, 3, dtype=np.uint64)
    trio = _trio(n, B, keys, keys * np.uint64(7), pages=512 if n == 1
                 else 128)
    rng = np.random.default_rng(9 + n)
    for step in range(3):
        k = np.repeat(rng.choice(keys, n * B // 4, replace=False), 3)
        if step == 2:
            k[::7] = np.arange(k[::7].size, dtype=np.uint64) * 3 + 1
        is_read = (np.arange(k.size) % 2) == 0
        val = k ^ np.uint64(0x1234 + step)
        outs = [x[2].mixed(k, val, is_read) for x in trio]
        for o in outs[1:]:
            for a, b in zip(o, outs[0]):
                np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        _check(trio, f"mixed {step}")
    assert trio[1][2]._combine_steps == trio[0][2]._combine_steps > 3


def test_locked_group_under_write_combine(eight_devices):
    """A lock held by another client inside a combined group: every row of
    that page's group reports ST_LOCKED, exactly as uncombined, and the
    rows of other groups apply; after the unlock the same batch lands."""
    keys = np.arange(100, 100 + 3000 * 3, 3, dtype=np.uint64)
    trio = _trio(1, 256, keys, keys * np.uint64(7), pages=512)
    addrs, lows = trio[1][1]._bulk_leaf_dir
    leaf, lo, hi = int(addrs[32]), lows[32], lows[33]
    upd = keys[(keys >= lo - np.uint64(120)) & (keys < hi + np.uint64(90))]
    on_leaf = (upd >= lo) & (upd < hi)
    assert on_leaf.any() and (~on_leaf).any()
    for c, t, _ in trio:
        o = c.register_client()
        la = t._lock_word_addr(leaf)
        assert c.dsm.cas(la, 0, 0, o.lease, space=D.SPACE_LOCK)[1]
    nv = upd + np.uint64(9)
    sts = [_raw(x[2], upd, nv, False) for x in trio]
    for s in sts:
        np.testing.assert_array_equal(s, sts[0])
    np.testing.assert_array_equal(sts[1][on_leaf], TB.ST_LOCKED)
    np.testing.assert_array_equal(sts[1][~on_leaf], TB.ST_APPLIED)
    _check(trio, "locked group")
    for c, t, _ in trio:
        c.dsm.write_rows([t._unlock_row(t._lock_word_addr(leaf))])
    sts = [_raw(x[2], upd, nv, False) for x in trio]
    np.testing.assert_array_equal(sts[1], TB.ST_APPLIED)
    np.testing.assert_array_equal(sts[1], sts[0])
    _check(trio, "after the unlock")
    vals, found = trio[1][2].search(upd)
    assert found.all() and (vals == nv).all()
