"""Port parity: checkpoints in the JAX package's npz format
(``sherman_tpu_torch/utils/checkpoint.py`` against
``sherman_tpu/utils/checkpoint.py``), at one node and at four.

A checkpoint written by either package restores into the other: the
same tree (bulk-loaded, a band deleted, three reclaim passes so the
allocators' free pools hold pages) is saved by one package and restored
by both, and the restored pools, lock tables, counters, directories
(bump marks, roots, free pools) and the answers to a search batch must
be equal.  Delta chains go both ways too, and the two packages' deltas
of the same ops carry equal rows and pages.  The config JSON, the
layout tag, the typed rejections of bad chain links, ``read_chain_rows``
and the tmp-orphan sweep are pinned as well.  The JAX side runs as its
own tests run it (``gather_impl="xla"``, the ``eight_devices``
fixture).  Every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import checkpoint as JCK
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import CheckpointFormatError, ConfigError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import checkpoint as CK

torch.set_num_threads(1)

U64 = np.uint64


def _kw(n):
    return dict(machine_nr=n, pages_per_node=1024 if n == 1 else 512,
                locks_per_node=256, step_capacity=128, chunk_pages=32)


def _side(jax_side: bool, n: int):
    kw = _kw(n)
    c = (JCluster(JDSMConfig(gather_impl="xla", **kw)) if jax_side
         else Cluster(DSMConfig(device="cpu", **kw)))
    t = (JTree if jax_side else Tree)(c)
    e = (JB if jax_side else TB).BatchedEngine(t, batch_per_node=128,
                                               write_combine=False)
    return c, t, e


def _grow(side, keys, jax_side):
    """Bulk-load, delete a band and every fifth key, three reclaim
    passes: retired, parked and freed pages."""
    c, t, e = side
    B = JB if jax_side else TB
    B.bulk_load(t, keys, keys ^ U64(0xABCD), fill=0.9)
    e.attach_router()
    e.delete(np.union1d(keys[::5], keys[300:700]))
    for _ in range(3):
        e.reclaim_empty_leaves()


def _keys(seed=5, n=1500):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 1 << 56, int(n * 1.1), dtype=U64))[:n]


def _dirs(c):
    return [(d.node_id, d.allocator._next, d.root_ptr, d.root_level,
             d.allocator.free_pages_list) for d in c.directories]


def _same_cluster(jc, pc, what=""):
    np.testing.assert_array_equal(pc.dsm.pool.numpy(), np.asarray(jc.dsm.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(pc.dsm.locks.numpy(),
                                  np.asarray(jc.dsm.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(pc.dsm.counters_np(),
                                  np.asarray(jc.dsm.counters),
                                  err_msg=what + " counters")
    assert _dirs(pc) == _dirs(jc), what
    np.testing.assert_array_equal(pc.dsm.dirty_rows(), jc.dsm.dirty_rows(),
                                  err_msg=what + " dirty")


def _serve_alike(jc, pc, keys, what=""):
    """Trees and engines on both restored clusters answer a search batch
    (present, deleted and absent keys) alike, then take one insert batch
    that needs fresh pages alike."""
    jt, pt = JTree(jc), Tree(pc)
    je = JB.BatchedEngine(jt, batch_per_node=128, write_combine=False)
    pe = TB.BatchedEngine(pt, batch_per_node=128, write_combine=False)
    je.attach_router()
    pe.attach_router()
    q = np.concatenate([keys[::3], keys[::7] + U64(1)])
    for a, b in zip(pe.search(q), je.search(q)):
        np.testing.assert_array_equal(a, b, err_msg=what)
    fresh = np.arange(1, 400, dtype=U64) * U64(1 << 40)
    assert pe.insert(fresh, fresh) == je.insert(fresh, fresh), what
    _same_cluster(jc, pc, what + " after inserts")


def test_layout_tag_and_cfg_json_match():
    assert CK.LAYOUT_TAG == JCK.LAYOUT_TAG
    assert CK._CFG_FIELDS == JCK._CFG_FIELDS
    for n in (1, 4):
        kw = _kw(n)
        raw = CK.cfg_to_json(DSMConfig(device="cpu", **kw))
        assert raw == JCK.cfg_to_json(JDSMConfig(**kw))
        d = json.loads(raw)
        assert "device" not in d and d["exchange_impl"] == "xla" \
            and d["gather_impl"] == "xla" and d["heap_pages_per_node"] == 0
        assert CK.cfg_from_json(raw, "cpu") == DSMConfig(device="cpu", **kw)
        assert JCK.cfg_from_json(raw) == JDSMConfig(**kw)


def _cfg_raw(**edit):
    d = json.loads(CK.cfg_to_json(DSMConfig(device="cpu", **_kw(1))))
    d.update(edit)
    for k in [k for k, v in edit.items() if v is None]:
        del d[k]
    return json.dumps(d).encode()


@pytest.mark.parametrize("edit, want", [
    ({"exchange_impl": "pallas", "gather_impl": "pallas"}, None),
    ({"chunk_pages": None, "host_step_capacity": None}, None),
    ({"heap_pages_per_node": (1 << 24) + 1}, ConfigError),
    ({"heap_pages_per_node": 0}, None),
    ({"heap_pages_per_node": 64}, None),
    ({"device": "cpu"}, CheckpointFormatError),
    ({"fancy_knob": 1}, CheckpointFormatError),
    ({"_layout": "pw256+leaf5x48+int3x82"}, CheckpointFormatError),
    ({"_layout": None}, CheckpointFormatError),
], ids=["impls_ignored", "missing_defaults", "heap_refused", "heap_zero",
        "heap_accepted",
        "device_unknown", "unknown_field", "wrong_layout", "unstamped"])
def test_cfg_from_json_rules(edit, want):
    raw = _cfg_raw(**edit)
    if want is None:
        cfg = CK.cfg_from_json(raw, "cpu")
        base = DSMConfig(device="cpu", **_kw(1))
        if "chunk_pages" in edit:
            assert cfg.chunk_pages == DSMConfig.chunk_pages
            assert cfg.machine_nr == base.machine_nr
        elif edit.get("heap_pages_per_node"):
            assert cfg == DSMConfig(device="cpu", **_kw(1),
                                    heap_pages_per_node=64)
        else:
            assert cfg == base
    else:
        with pytest.raises(want):
            CK.cfg_from_json(raw, "cpu")


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_full_checkpoint_restores_across_packages(eight_devices, tmp_path,
                                                  n, writer):
    keys = _keys()
    side = _side(writer == "jax", n)
    _grow(side, keys, writer == "jax")
    c = side[0]
    assert any(d.allocator.free_pages_list for d in c.directories)
    path = str(tmp_path / "ckpt.npz")
    epoch = (JCK if writer == "jax" else CK).checkpoint(c, path)
    assert epoch.dtype == np.int32 and epoch.shape == (3,)
    assert c.dsm.dirty_rows().size == 0
    z = np.load(path)
    assert z["counters"].dtype == np.uint32 and z["pool"].dtype == np.int32
    assert z["locks"].dtype == np.int32 and z["epoch"].dtype == np.int32
    np.testing.assert_array_equal(z["dir_free"], np.sort(z["dir_free"]))
    jc = JCK.restore(path)
    pc = CK.restore(path, device="cpu")
    _same_cluster(jc, pc, f"{writer} checkpoint")
    _serve_alike(jc, pc, keys, f"{writer} checkpoint")


def _delta_ops(side, keys, k):
    c, t, e = side
    e.insert(keys[k * 40:(k + 1) * 40], keys[k * 40:(k + 1) * 40] ^ U64(k))
    e.delete(keys[1000 + k * 10:1000 + (k + 1) * 10])
    fresh = np.arange(1, 60, dtype=U64) * U64(1 << 44) + U64(k)
    e.insert(fresh, fresh)


@pytest.mark.parametrize("n", [1, 4])
def test_delta_chains_restore_across_packages(eight_devices, tmp_path, n):
    """Both packages run the same ops between chain links: their deltas
    hold equal rows, pages, locks, counters and manifests; each chain
    restores into the other package; ``read_chain_rows`` agrees."""
    keys = _keys(seed=7)
    sides = {w: _side(w == "jax", n) for w in ("jax", "port")}
    mods = {"jax": JCK, "port": CK}
    chains = {}
    for w, side in sides.items():
        _grow(side, keys, w == "jax")
        d = tmp_path / w
        d.mkdir()
        base = str(d / "base.npz")
        ep = mods[w].checkpoint(side[0], base)
        deltas = []
        for k in range(2):
            _delta_ops(side, keys, k)
            p = str(d / f"d{k}.npz")
            info = mods[w].checkpoint_delta(side[0], p, parent_epoch=ep)
            ep = info["epoch"]
            deltas.append((p, info))
        chains[w] = (base, deltas)
    for (pj, ij), (pp, ip) in zip(chains["jax"][1], chains["port"][1]):
        assert ij["pages"] == ip["pages"] > 0
        zj, zp = np.load(pj), np.load(pp)
        for k in ("delta_rows", "delta_pages", "locks", "counters", "cfg",
                  "dir_nodes", "dir_next", "dir_root", "dir_free", "delta"):
            np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)
            assert zp[k].dtype == zj[k].dtype, k
    for w, (base, deltas) in chains.items():
        paths = [p for p, _ in deltas]
        jc = JCK.restore_chain(base, paths)
        pc = CK.restore_chain(base, paths, device="cpu")
        _same_cluster(jc, pc, f"{w} chain")
        _same_cluster(sides["jax"][0], pc, f"{w} chain vs live")
        rows = np.array([0, 3, 17, pc.dsm.pool.shape[0] - 1, 40, 3])
        np.testing.assert_array_equal(CK.read_chain_rows(base, paths, rows),
                                      JCK.read_chain_rows(base, paths, rows))
        _serve_alike(jc, pc, keys, f"{w} chain")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bad_links_are_refused_typed(eight_devices, tmp_path, writer):
    """Out-of-order, skipped, foreign and tampered links, a delta handed
    to ``restore`` and a corrupt base fail typed in both packages."""
    mod = JCK if writer == "jax" else CK
    keys = _keys(seed=11, n=600)
    c, t, e = side = _side(writer == "jax", 1)
    (JB if writer == "jax" else TB).bulk_load(t, keys, keys)
    e.attach_router()
    base = str(tmp_path / "base.npz")
    epoch = mod.checkpoint(c, base)
    e.insert(keys[:32], keys[:32] ^ U64(1))
    d1 = str(tmp_path / "d1.npz")
    e1 = mod.checkpoint_delta(c, d1, parent_epoch=epoch)["epoch"]
    e.insert(keys[32:64], keys[32:64] ^ U64(2))
    d2 = str(tmp_path / "d2.npz")
    mod.checkpoint_delta(c, d2, parent_epoch=e1)
    # a foreign chain: another base, its own first delta
    other = str(tmp_path / "other.npz")
    eo = mod.checkpoint(c, other)
    e.insert(keys[64:70], keys[64:70])
    dx = str(tmp_path / "dx.npz")
    mod.checkpoint_delta(c, dx, parent_epoch=eo)
    for rmod in (CK, JCK):
        kw = {"device": "cpu"} if rmod is CK else {}
        for chain in ([d2, d1], [d2], [d1, dx], [dx]):
            with pytest.raises(rmod.CheckpointCorruptError):
                rmod.restore_chain(base, chain, **kw)
            with pytest.raises(rmod.CheckpointCorruptError):
                rmod.read_chain_rows(base, chain, [1, 2])
        with pytest.raises(rmod.CheckpointCorruptError):
            rmod.restore(d1, **kw)
    # tampered delta content: re-saved with its stale integrity map
    z = dict(np.load(d1))
    z["delta_pages"] = np.array(z["delta_pages"])
    z["delta_pages"][0, 12] ^= 1
    np.savez_compressed(d1, **z)
    # a torn base (truncated file)
    torn = str(tmp_path / "torn.npz")
    open(torn, "wb").write(open(base, "rb").read()[:4096])
    for rmod in (CK, JCK):
        kw = {"device": "cpu"} if rmod is CK else {}
        with pytest.raises(rmod.CheckpointCorruptError, match="delta_pages"):
            rmod.restore_chain(base, [d1, d2], **kw)
        with pytest.raises(rmod.CheckpointCorruptError):
            rmod.restore(torn, **kw)
        # the base alone still restores
        assert rmod.restore_chain(base, [], **kw).dsm.pool.shape == \
            c.dsm.pool.shape


def test_multihost_manifest_refused(tmp_path):
    """A collective checkpoint's manifest (the ``multihost`` flag) needs a
    multi-host cluster: both packages refuse it with
    ``CheckpointFormatError`` (the port names item 7c-iv)."""
    c, t, e = _side(False, 1)
    TB.bulk_load(t, _keys(n=200), _keys(n=200))
    path = str(tmp_path / "m.npz")
    man = CK._manifest(c)
    arrays = dict(multihost=np.asarray([2], np.int64),
                  epoch=CK.make_epoch(man, 0), **man)
    arrays["integrity"] = CK._integrity(arrays)
    CK._savez_atomic(path, 0, **arrays)
    with pytest.raises(CheckpointFormatError, match="7c-iv"):
        CK.restore(path, device="cpu")
    with pytest.raises(JCK.CheckpointFormatError):
        JCK.restore(path)


def test_clear_locks_and_epoch_sequence(tmp_path):
    """``restore(clear_locks=False)`` keeps the saved lock words; the
    epoch's seq counts the cluster's checkpoints and its crc is the
    manifest's, as the reference builds it."""
    c, t, e = _side(False, 1)
    TB.bulk_load(t, _keys(n=300), _keys(n=300))
    c.dsm.write_word(5, 0, 77, space=1)
    path = str(tmp_path / "c.npz")
    e0 = CK.checkpoint(c, path)
    e1 = CK.checkpoint(c, path)
    assert (e0[1], e1[1]) == (0, 1)
    man = CK._manifest(c)
    np.testing.assert_array_equal(
        CK.make_epoch(man, 1, nonce=int(e1[0])),
        JCK.make_epoch(man, 1, nonce=int(e1[0])))
    assert int(CK.restore(path, "cpu").dsm.locks[5]) == 0
    assert int(CK.restore(path, "cpu", clear_locks=False).dsm.locks[5]) \
        == 77


def test_savez_atomic_fsyncs_and_sweeps_orphans(tmp_path, monkeypatch):
    """A crash mid-save leaves a tmp orphan, which the next save sweeps;
    every save fsyncs the file and its directory."""
    calls = []
    real = CK._fsync
    monkeypatch.setattr(CK, "_fsync", lambda fd: (calls.append(fd),
                                                  real(fd)))
    c, t, e = _side(False, 1)
    TB.bulk_load(t, _keys(n=300), _keys(n=300))
    path = str(tmp_path / "c.npz")
    for orphan in (path + ".tmp0.npz", path + ".tmp3.npz"):
        open(orphan, "wb").write(b"partial")
    assert CK._sweep_tmp_orphans(str(tmp_path / "none.npz")) == 0
    CK.checkpoint(c, path)
    assert sorted(os.listdir(tmp_path)) == ["c.npz"]
    assert len(calls) == 2
    assert CK._sweep_tmp_orphans(path) == 0
    # a path without the suffix gets it, as np.savez would
    CK.checkpoint(c, str(tmp_path / "d"))
    assert os.path.exists(str(tmp_path / "d.npz"))
    assert CK.restore(str(tmp_path / "d"), "cpu").dsm.pool.shape == \
        c.dsm.pool.shape


def test_parallel_deflate_joins_chunks_into_one_stream():
    """Chunks deflated apart, each closed by a sync flush, inflate as one
    raw deflate stream to the input, in order (empty and one-byte chunks
    included)."""
    import zlib
    rng = np.random.default_rng(3)
    chunks = []
    for i in range(41):
        n = int(rng.integers(0, 50_000)) if i % 7 else i % 2
        c = rng.integers(0, 4, n, dtype=np.uint8) if i % 3 else \
            rng.integers(0, 256, n, dtype=np.uint8)
        chunks.append(c.tobytes())
    d = CK._ParallelDeflate(4)
    out = b"".join(d.compress(c) for c in chunks) + d.flush()
    inf = zlib.decompressobj(-15)
    assert inf.decompress(out) + inf.flush() == b"".join(chunks)
    assert inf.eof


@pytest.mark.parametrize("n", [1, 4])
def test_parallel_deflate_checkpoint_restores_across_packages(
        eight_devices, tmp_path, monkeypatch, n):
    """With every array over the parallel deflater's threshold, a port
    checkpoint is a valid zip (member CRCs checked) that both packages
    restore alike."""
    import zipfile
    monkeypatch.setattr(CK, "_PARALLEL_DEFLATE_BYTES", 0)
    keys = _keys()
    side = _side(False, n)
    _grow(side, keys, False)
    c = side[0]
    path = str(tmp_path / "ckpt.npz")
    CK.checkpoint(c, path)
    with zipfile.ZipFile(path) as zf:
        assert zf.testzip() is None
    jc = JCK.restore(path)
    pc = CK.restore(path, device="cpu")
    _same_cluster(jc, pc, "parallel deflate")
    _serve_alike(jc, pc, keys, "parallel deflate")


# ---------------------------------------------------------------------------
# The collective checkpoint of two ranks (the process-spanning transport).
# ---------------------------------------------------------------------------

_MH_CFG = dict(machine_nr=4, pages_per_node=128, locks_per_node=64,
               step_capacity=32, host_step_capacity=16, chunk_pages=8)
_MH_KEYS = np.arange(1, 601, dtype=np.uint64) * np.uint64(7)

_MH_RANK = r'''
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.models import batched
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import checkpoint as CK
import json
cfg_kw = json.loads(args[0])
keys = np.arange(1, 601, dtype=np.uint64) * np.uint64(7)
keeper = bootstrap.init_multihost()
cluster = Cluster(DSMConfig(device="cpu", **cfg_kw), keeper=keeper)
tree = Tree(cluster)
batched.bulk_load(tree, keys, keys * np.uint64(3))
assert CK.checkpoint(cluster, os.path.join(tmp, "port.npz")) is None
# the reference's two-host artifact (its resharder's) restores here
c2 = CK.restore(os.path.join(tmp, "jax2.npz"), device="cpu", keeper=keeper)
np.savez(os.path.join(tmp, f"restored{pid}.npz"), pool=c2.dsm.pool.numpy(),
         locks=c2.dsm.locks.numpy(), counters=c2.dsm.counters_np())
eng = batched.BatchedEngine(Tree(c2), batch_per_node=64)
got, found = eng.search(keys)
assert found.all() and (got == keys * np.uint64(3)).all()
try:
    CK.restore(os.path.join(tmp, "single.npz"), device="cpu", keeper=keeper)
    raise SystemExit("a one-file artifact restored into two ranks")
except CK.CheckpointFormatError as e:
    assert "host count" in str(e) or "failed to load" in str(e), e
keeper.barrier("done")
print(f"[{pid}] CK-PASS", flush=True)
'''


def test_collective_save_matches_jax_format_and_restores_two_hosts(
        tmp_path, eight_devices):
    """Two ranks save collectively: the manifest and both shard files
    hold the JAX format's fields, array for array (the epoch's nonce and
    the integrity map that covers it aside), as the reference's own
    ``reshard --hosts 2`` writes them for the same state; and that
    reference artifact restores into the two ranks, the restored blocks
    equal to the JAX cluster's."""
    import torch_ranks as RK
    from sherman_tpu.utils import reshard as JRS
    jc = JCluster(JDSMConfig(**_MH_CFG))
    jt = JTree(jc)
    JB.bulk_load(jt, _MH_KEYS, _MH_KEYS * np.uint64(3))
    single = str(tmp_path / "single.npz")
    JCK.checkpoint(jc, single)
    JRS.reshard(single, str(tmp_path / "jax2.npz"), 4, hosts=2)
    RK.run(tmp_path, _MH_RANK, "CK-PASS", timeout=120,
           args=(json.dumps(_MH_CFG),))
    one = dict(np.load(single))
    P, L = _MH_CFG["pages_per_node"], _MH_CFG["locks_per_node"]
    for h, suffix in enumerate(("", ".host0.npz", ".host1.npz")):
        got = dict(np.load(str(tmp_path / "port.npz") + suffix))
        want = dict(np.load(str(tmp_path / "jax2.npz") + suffix))
        # the reference's collective save adds its integrity map, which
        # its resharder's artifact leaves out
        assert sorted(got) == sorted(set(want) | {"integrity"}), suffix
        crcs = json.loads(bytes(got["integrity"]).decode())
        assert sorted(crcs) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, (suffix, k)
            assert got[k].ndim == want[k].ndim, (suffix, k)
        # the values: the JAX one-process save of the same state, split
        if not suffix:
            assert got["multihost"].tolist() == [2]
            for k in ("cfg", "dir_nodes", "dir_next", "dir_root",
                      "dir_free"):
                np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        else:
            r = h - 1
            assert got["nodes"].tolist() == [2 * r, 2 * r + 1]
            np.testing.assert_array_equal(
                got["pool"], one["pool"][2 * r * P:(2 * r + 2) * P])
            np.testing.assert_array_equal(
                got["locks"], one["locks"][2 * r * L:(2 * r + 2) * L])
            np.testing.assert_array_equal(
                got["counters"], one["counters"][20 * r:20 * r + 20])
        assert got["epoch"].shape == want["epoch"].shape == (3,)
    eps = {tuple(np.load(str(tmp_path / "port.npz") + s)["epoch"])
           for s in ("", ".host0.npz", ".host1.npz")}
    assert len(eps) == 1, "shards and manifest carry one epoch"
    joined = [np.concatenate([np.load(str(tmp_path / f"restored{p}.npz"))[k]
                              for p in range(2)])
              for k in ("pool", "locks", "counters")]
    shards = [dict(np.load(str(tmp_path / f"jax2.npz.host{h}.npz")))
              for h in range(2)]
    np.testing.assert_array_equal(
        joined[0], np.concatenate([z["pool"] for z in shards]))
    assert not joined[1].any(), "a restore clears the lock table"
    np.testing.assert_array_equal(
        joined[2], np.concatenate([z["counters"] for z in shards]))
