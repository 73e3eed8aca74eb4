"""Port parity: the offline resize (``sherman_tpu_torch/utils/reshard.py``)
against the JAX package's ``sherman_tpu/utils/reshard.py``.

On one JAX-written checkpoint (4 nodes with device splits, root growth and
deletes, after tests/test_reshard.py) both transforms emit equal arrays and
summaries: 4 -> 8, 4 -> 2, the identity, a target too small (typed), the
unwritten lease tails dropped, a value heap carried (global rows kept, the
node split padded; the port's restore rebuilds the reference's allocator,
spare pages included) and ``hosts=2`` shard files array for array (the
epoch's nonce aside).  A port checkpoint resharded and restored at M
nodes serves every key, passes the structure check and scans, then takes
fresh inserts with splits, its pool equal to JAX's after the same
sequence.  Corrupt sources fail typed in both, and the CLI prints the
same summary.  The JAX side runs as its own tests run it (the
``eight_devices`` fixture).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sherman_tpu import config as JC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.errors import ReshardError as JReshardError
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.utils import checkpoint as JCK
from sherman_tpu.utils import reshard as JRS
from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import (CheckpointFormatError, ConfigError,
                                      ReshardError)
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.models.validate import check_structure_device
from sherman_tpu_torch.utils import checkpoint as CK
from sherman_tpu_torch.utils import reshard as RS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _npz(path):
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def _assert_files_equal(a, b, skip=()):
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        if k in skip:
            continue
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k


def _sequence(cluster, tree, eng):
    """tests/test_reshard.py's source: bulk load, device inserts with
    splits, deletes.  -> (kept keys, value map)."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1 << 48, 3000, dtype=np.uint64))[:2500]
    vals = keys * np.uint64(5)
    (JB if isinstance(tree, JTree) else TB).bulk_load(tree, keys[:1500],
                                                      vals[:1500])
    eng.attach_router()
    stats = eng.insert(keys[1500:], vals[1500:])
    assert stats.get("device_splits", 0) > 0, stats
    dropped = keys[::7]
    eng.delete(dropped)
    kept = np.setdiff1d(keys, dropped)
    return kept, dict(zip(keys.tolist(), vals.tolist()))


KW = dict(machine_nr=4, pages_per_node=256, locks_per_node=128,
          step_capacity=128, chunk_pages=16)


@pytest.fixture(scope="module")
def source(eight_devices, tmp_path_factory):
    """A JAX-written 4-node checkpoint -> (path, kept keys, value map)."""
    cluster = JCluster(JDSMConfig(**KW))
    tree = JTree(cluster)
    eng = JB.BatchedEngine(tree, batch_per_node=64)
    kept, val_of = _sequence(cluster, tree, eng)
    src = str(tmp_path_factory.mktemp("reshard_src") / "src.npz")
    JCK.checkpoint(cluster, src)
    return src, kept, val_of


def _restored_port(dst, n_nodes, kept, val_of):
    """tests/test_reshard.py's ``_verify_restored`` on the port."""
    cluster = CK.restore(dst, device="cpu")
    assert cluster.cfg.machine_nr == n_nodes
    tree = Tree(cluster)
    eng = TB.BatchedEngine(tree, batch_per_node=64)
    eng.attach_router()
    got, found = eng.search(kept)
    assert found.all(), f"lost {int((~found).sum())} keys in reshard"
    np.testing.assert_array_equal(
        got, np.asarray([val_of[int(k)] for k in kept], np.uint64))
    info = tree.check_structure()
    assert info["keys"] == kept.size
    lo, hi = int(kept[10]), int(kept[200])
    ks, _ = eng.range_query(lo, hi + 1)
    np.testing.assert_array_equal(np.sort(ks),
                                  kept[(kept >= lo) & (kept <= hi)])
    fresh = np.unique(np.random.default_rng(9).integers(
        1 << 50, 1 << 51, 450, dtype=np.uint64))[:400]
    stats = eng.insert(fresh, fresh ^ np.uint64(0xAB))
    got2, found2 = eng.search(fresh)
    assert found2.all()
    np.testing.assert_array_equal(got2, fresh ^ np.uint64(0xAB))
    tree.check_structure()
    return cluster, stats


@pytest.mark.parametrize("nodes,ppn", [(8, 256), (2, None), (4, None),
                                       (6, 256)],
                         ids=["up_4to8", "down_4to2", "identity", "4to6"])
def test_reshard_matches_jax(source, tmp_path, nodes, ppn):
    src, kept, val_of = source
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    want = JRS.reshard(src, a, nodes, pages_per_node=ppn)
    got = RS.reshard(src, b, nodes, pages_per_node=ppn)
    assert got == want
    assert sum(got["pages_per_new_node"]) == got["live_pages"]
    _assert_files_equal(a, b)
    _restored_port(b, nodes, kept, val_of)


def test_reshard_too_small_rejected(source, tmp_path):
    src, _, _ = source
    with pytest.raises(ValueError, match="too small") as want:
        JRS.reshard(src, str(tmp_path / "x.npz"), 2, pages_per_node=16)
    with pytest.raises(ConfigError, match="too small") as got:
        RS.reshard(src, str(tmp_path / "y.npz"), 2, pages_per_node=16)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "y.npz")


def test_reshard_drops_unwritten_lease_tails(source, tmp_path):
    src, _, _ = source
    out = RS.reshard(src, str(tmp_path / "packed.npz"), 4)
    with np.load(src) as z:
        src_span = int(np.sum(z["dir_next"] - 1))
        fv = z["pool"][:, C.W_FRONT_VER]
        nxt, ppn = z["dir_next"], z["pool"].shape[0] // 4
    assert out["live_pages"] < src_span
    # the live set is exactly the written rows below each mark
    rows = RS.live_rows(fv, nxt, None, ppn, 4)
    assert rows.size == out["live_pages"]
    assert np.array_equal(rows, JRS.live_rows(fv, nxt, None, ppn, 4))
    with np.load(str(tmp_path / "packed.npz")) as z:
        pool, nxt2 = z["pool"], z["dir_next"]
    for n in range(4):
        seg = pool[n * ppn + 1: n * ppn + int(nxt2[n])]
        assert (seg[:, C.W_FRONT_VER] != 0).all(), n


def test_live_rows_drops_the_free_pool():
    rng = np.random.default_rng(1)
    P, N = 64, 3
    fv = rng.integers(0, 3, N * P).astype(np.int32)
    nxt = np.asarray([40, 1, 64])
    free = np.asarray([JBITS.make_addr(0, 5), JBITS.make_addr(2, 63),
                       JBITS.make_addr(2, 7), JBITS.make_addr(1, 3)],
                      np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(RS.live_rows(fv, nxt, free, P, N),
                                  JRS.live_rows(fv, nxt, free, P, N))


def _jax_heap_source(tmp_path):
    """test_value_heap.py's ``loaded(nr=2, heap_pages=48, n=300)``,
    flushed and checkpointed by the JAX package."""
    cluster = JCluster(JDSMConfig(machine_nr=2, pages_per_node=1024,
                                  locks_per_node=512, step_capacity=512,
                                  chunk_pages=32, heap_pages_per_node=48))
    tree = JTree(cluster)
    eng = JB.BatchedEngine(tree, batch_per_node=256)
    keys = np.unique(JBITS.mix64_np(np.arange(300, dtype=np.uint64)
                                    ^ np.uint64(0x5E17_AB1E_5A17)))
    JB.bulk_load(tree, keys, keys ^ np.uint64(0xD00D))
    eng.attach_router()
    vh = eng.attach_value_heap()
    rng = np.random.default_rng(int(keys[0]) & 0xFFFF)
    pay = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
           for n in rng.integers(1, 250, keys.size)]
    vh.put(keys, pay)
    eng.flush_parents()
    src = str(tmp_path / "heap_src.npz")
    JCK.checkpoint(cluster, src)
    return src, keys, pay


def _alloc(vh):
    return [vh._page_cls.copy(), vh._ver.copy(), vh._next_page.copy(),
            list(vh._spare_pages),
            [(k, sorted(s)) for k, s in vh._free.items()]]


def test_reshard_carries_the_heap(eight_devices, tmp_path):
    """2 -> 3 nodes with a value heap: equal arrays (the heap's global rows
    kept, the split padded to 3 x 32 pages); restored at 3 nodes the port
    rebuilds the reference's allocator, spare pages included, and serves
    every payload; back to 2 nodes the original rows are bit-identical."""
    src, keys, pay = _jax_heap_source(tmp_path)
    a, b = str(tmp_path / "jax3.npz"), str(tmp_path / "port3.npz")
    assert RS.reshard(src, b, 3) == JRS.reshard(src, a, 3)
    _assert_files_equal(a, b)
    jc = JCK.restore(a)
    je = JB.BatchedEngine(JTree(jc), batch_per_node=256)
    je.attach_router()
    jvh = je.attach_value_heap()
    want = jvh.rebuild()
    pc = CK.restore(b, device="cpu")
    pe = TB.BatchedEngine(Tree(pc), batch_per_node=256)
    pe.attach_router()
    pvh = pe.attach_value_heap()
    assert pvh.rebuild() == want
    wa, pa = _alloc(jvh), _alloc(pvh)
    for x, y in zip(wa, pa):
        assert (np.array_equal(x, y) if isinstance(x, np.ndarray)
                else x == y)
    # the padded split: 96 rows for 96, the second node's bump mark
    assert pvh.rows_total == 96
    got, found = pvh.get(keys)
    assert found.all() and all(got[i] == pay[i] for i in range(keys.size))
    back_a, back_b = str(tmp_path / "jax2.npz"), str(tmp_path / "port2.npz")
    JRS.reshard(a, back_a, 2)
    RS.reshard(b, back_b, 2)
    _assert_files_equal(back_a, back_b)
    h1, h2 = _npz(src)["heap"], _npz(back_b)["heap"]
    n = min(h1.shape[0], h2.shape[0])
    assert np.array_equal(h1[:n], h2[:n]) and not h2[n:].any()


def test_reshard_multihost_format_matches_jax(source, tmp_path):
    """hosts=2: the manifest and both shard files equal JAX's array for
    array (the epoch's nonce aside: its seq and manifest CRC equal, and
    each shard carries its manifest's epoch); both packages' restore
    refuse the artifact with ``CheckpointFormatError`` (the port names
    ROADMAP.md item 7c-iv), and a heap is refused."""
    src, _, _ = source
    a, b = str(tmp_path / "jmh.npz"), str(tmp_path / "pmh.npz")
    want = JRS.reshard(src, a, 4, hosts=2)
    got = RS.reshard(src, b, 4, hosts=2)
    assert got == want and got["new"]["hosts"] == 2
    for suffix in ("", ".host0.npz", ".host1.npz"):
        _assert_files_equal(a + suffix, b + suffix, skip=("epoch",))
    ep = _npz(b)["epoch"]
    assert np.array_equal(ep[1:], _npz(a)["epoch"][1:])
    for h in (0, 1):
        assert np.array_equal(_npz(f"{b}.host{h}.npz")["epoch"], ep)
    with pytest.raises(CheckpointFormatError, match="7c-iv"):
        CK.restore(b, device="cpu")
    with pytest.raises(JCK.CheckpointFormatError):
        JCK.restore(b)
    # a multihost source reshards back to one file, equal in both
    a1, b1 = str(tmp_path / "j1.npz"), str(tmp_path / "p1.npz")
    assert RS.reshard(b, b1, 8) == JRS.reshard(a, a1, 8)
    _assert_files_equal(a1, b1)
    arrays = {k: np.zeros(1, np.int64) for k in CK._MANIFEST_FIELDS}
    arrays["heap"] = np.zeros((4, C.PAGE_WORDS), np.int32)
    with pytest.raises(ConfigError, match="single-process"):
        RS.write_resharded(str(tmp_path / "h.npz"), arrays,
                           DSMConfig(machine_nr=4, device="cpu"), hosts=2)
    with pytest.raises(ConfigError, match="divide"):
        RS.reshard(src, str(tmp_path / "odd.npz"), 3, hosts=2)


def test_reshard_refuses_corrupt_sources_typed(source, tmp_path):
    src, _, _ = source
    z = _npz(src)
    # a dangling sibling pointer: a page outside the live set
    bad = dict(z)
    bad["pool"] = z["pool"].copy()
    live = JRS.live_rows(z["pool"][:, JC.W_FRONT_VER], z["dir_next"],
                         z["dir_free"], 256, 4)
    r = int(live[3])
    bad["pool"][r, C.W_SIBLING] = JBITS.make_addr(3, 255)
    p = str(tmp_path / "dangling.npz")
    np.savez(p, **bad)
    with pytest.raises(JReshardError) as want:
        JRS.reshard(p, str(tmp_path / "j.npz"), 2)
    with pytest.raises(ReshardError) as got:
        RS.reshard(p, str(tmp_path / "t.npz"), 2)
    assert str(got.value) == str(want.value)
    # a pool that does not match the manifest's shape
    short = dict(z)
    short["pool"] = z["pool"][:-1]
    p2 = str(tmp_path / "short.npz")
    np.savez(p2, **short)
    with pytest.raises(ReshardError, match="does not match"):
        RS.reshard(p2, str(tmp_path / "t2.npz"), 2)
    # a torn multihost pair: shard epochs from another checkpoint
    mh = str(tmp_path / "mh.npz")
    RS.reshard(src, mh, 4, hosts=2)
    h1 = _npz(mh + ".host1.npz")
    h1["epoch"] = h1["epoch"] + 1
    np.savez(mh + ".host1.npz", **h1)
    with pytest.raises(ReshardError, match="different checkpoint epoch"):
        RS.reshard(mh, str(tmp_path / "t3.npz"), 2)
    with pytest.raises(JReshardError, match="different checkpoint epoch"):
        JRS.reshard(mh, str(tmp_path / "j3.npz"), 2)


@pytest.mark.parametrize("target", [8, 6])
def test_port_checkpoint_resharded_serves_and_grows(eight_devices, tmp_path,
                                                    target):
    """The reference's workflow on the port (checkpoint -> reshard ->
    restore at M nodes), side by side with JAX's: every key served, the
    structure checked, scans, fresh inserts with splits, and the pools
    equal to JAX's after the same sequence."""
    pc = Cluster(DSMConfig(device="cpu", **KW))
    pt = Tree(pc)
    kept, val_of = _sequence(pc, pt, TB.BatchedEngine(pt, batch_per_node=64))
    jc = JCluster(JDSMConfig(**KW))
    jt = JTree(jc)
    _sequence(jc, jt, JB.BatchedEngine(jt, batch_per_node=64))
    ps, js = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    CK.checkpoint(pc, ps)
    JCK.checkpoint(jc, js)
    pd, jd = str(tmp_path / "pm.npz"), str(tmp_path / "jm.npz")
    assert RS.reshard(ps, pd, target, pages_per_node=256) == \
        JRS.reshard(js, jd, target, pages_per_node=256)
    _assert_files_equal(pd, jd)
    cluster, stats = _restored_port(pd, target, kept, val_of)
    assert stats.get("device_splits", 0) > 0, stats
    info = check_structure_device(Tree(cluster))
    assert info["keys"] == kept.size + 400
    # JAX's restore through the same sequence
    jc2 = JCK.restore(jd)
    jt2 = JTree(jc2)
    je2 = JB.BatchedEngine(jt2, batch_per_node=64)
    je2.attach_router()
    je2.search(kept)
    jt2.check_structure()
    lo, hi = int(kept[10]), int(kept[200])
    je2.range_query(lo, hi + 1)
    fresh = np.unique(np.random.default_rng(9).integers(
        1 << 50, 1 << 51, 450, dtype=np.uint64))[:400]
    je2.insert(fresh, fresh ^ np.uint64(0xAB))
    je2.search(fresh)
    jt2.check_structure()
    assert np.array_equal(cluster.dsm.pool.numpy(), np.asarray(jc2.dsm.pool))


def test_reshard_cli(source, tmp_path):
    src, kept, val_of = source
    dst = str(tmp_path / "cli.npz")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-m", "sherman_tpu_torch.utils.reshard", src, dst,
         "--nodes", "8", "--pages-per-node", "256"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    jdst = str(tmp_path / "jcli.npz")
    q = subprocess.run(
        [sys.executable, "tools/reshard.py", src, jdst, "--nodes", "8",
         "--pages-per-node", "256"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert q.returncode == 0, q.stderr
    assert out == json.loads(q.stdout.strip().splitlines()[-1])
    assert out["new"]["machine_nr"] == 8
    _assert_files_equal(dst, jdst)
    _restored_port(dst, 8, kept, val_of)
