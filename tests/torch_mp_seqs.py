"""The reference's five two-process worker sequences
(``tests/test_multihost.py``: cluster, engine, reclaim, staged loop and
split storm), written once over a package namespace so that the port's
two ranks and the JAX package's one process run the same calls.

``m`` carries the package's modules and three helpers: ``m.restore(path,
keeper)``, ``m.sync(x)`` (a device value to numpy) and ``m.is_port``.
Every sequence returns a dict of host results (answers and receipts);
the runner compares them and the cluster state across packages.
"""

import os

import numpy as np

CFGS = {
    "cluster": dict(machine_nr=4, pages_per_node=64, locks_per_node=64,
                    step_capacity=32, host_step_capacity=16, chunk_pages=8),
    "engine": dict(machine_nr=4, pages_per_node=256, locks_per_node=256,
                   step_capacity=64, host_step_capacity=16, chunk_pages=4),
    "reclaim": dict(machine_nr=4, pages_per_node=512, locks_per_node=256,
                    step_capacity=128, host_step_capacity=16,
                    chunk_pages=8),
    "staged": dict(machine_nr=4, pages_per_node=2048, locks_per_node=512,
                   step_capacity=1024, host_step_capacity=16,
                   chunk_pages=32),
    "storm": dict(machine_nr=4, pages_per_node=1024, locks_per_node=256,
                  step_capacity=256, host_step_capacity=16, chunk_pages=16),
}


def seq_cluster(m, cluster, keeper, tmp) -> dict:
    """Host-API writes, reads, CAS contention and FAA through the
    cluster's host handle (each op executes once cluster-wide)."""
    PW = m.PAGE_WORDS
    dsm, D, bits = cluster.host_dsm, m.D, m.bits
    out = {}
    for i, (node, pg) in enumerate(((2, 5), (1, 7), (3, 9), (0, 11))):
        page = (np.arange(PW) + 1000 * (i + 1)).astype(np.int32)
        dsm.write_page(bits.make_addr(node, pg), page)
    out["read"] = np.stack([dsm.read_page(bits.make_addr(n, p))
                            for n, p in ((2, 5), (1, 7), (3, 9))])
    lock = bits.make_addr(3, 9)
    wins = [dsm.cas(lock, 0, 0, 100 + i, space=D.SPACE_LOCK)[1]
            for i in range(2)]
    out["wins"] = np.asarray(wins)
    out["holder"] = np.asarray([dsm.read_word(lock, 0, space=D.SPACE_LOCK)])
    out["faa"] = np.asarray([dsm.faa(bits.make_addr(2, 5), 3, 7)
                             for _ in range(3)])
    out["pages"] = dsm.read_pages([bits.make_addr(n % 4, 5 + n)
                                   for n in range(20)])
    return out


def seq_engine(m, cluster, keeper, tmp) -> dict:
    """Bulk load spread over all nodes, insert with device splits, search,
    delete, the device validator, ``mixed``, the checkpoint and its
    restore into a fresh cluster."""
    tree = m.Tree(cluster)
    eng = m.batched.BatchedEngine(tree, batch_per_node=32)
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(1, 1 << 48, 1700, dtype=np.uint64))[:1500]
    vals = keys * np.uint64(3)
    bulk, rest = keys[:1100], keys[1100:]
    m.batched.bulk_load(tree, bulk, bulk * np.uint64(3))
    leaf_nodes = set(int(a) >> 24 for a in tree._bulk_leaf_dir[0].tolist())
    assert leaf_nodes == {0, 1, 2, 3}, f"leaves not spread: {leaf_nodes}"
    eng.attach_router()
    stats = eng.insert(rest, rest * np.uint64(3))
    assert stats.get("device_splits", 0) > 0, f"no device splits: {stats}"
    got, found = eng.search(keys)
    assert found.all(), f"missing {int((~found).sum())} keys"
    np.testing.assert_array_equal(got, vals)
    dropped = keys[::10]
    fnd = eng.delete(dropped)
    assert fnd.all()
    _, found2 = eng.search(dropped)
    assert not found2.any()
    dev = m.validate.check_structure_device(tree)
    info = tree.check_structure()
    assert dev["keys"] == info["keys"] and dev["leaves"] == info["leaves"]
    kept = np.setdiff1d(keys, dropped)
    mk = kept[:64]
    newv = mk ^ np.uint64(0xABC)
    is_read = np.arange(mk.size) % 2 == 0
    ov, fm, st = eng.mixed(mk, newv, is_read)
    assert fm[is_read].all()
    ck = os.path.join(tmp, f"engine_{m.name}.npz")
    m.CK.checkpoint(cluster, ck)
    cluster2 = m.restore(ck, keeper)
    eng2 = m.batched.BatchedEngine(m.Tree(cluster2), batch_per_node=32)
    got4, found4 = eng2.search(kept)
    assert found4.all(), "restored cluster lost keys"
    exp = kept * np.uint64(3)
    w = np.isin(kept, mk[~is_read])
    exp[w] = kept[w] ^ np.uint64(0xABC)
    np.testing.assert_array_equal(got4, exp)
    _, found5 = eng2.search(dropped)
    assert not found5.any()
    m.restored = cluster2
    return {"stats": np.asarray([stats[k] for k in (
                "applied", "superseded", "host_path", "rounds",
                "device_splits")]),
            "got": got, "found": found, "fnd": fnd,
            "dev": np.asarray([dev[k] for k in sorted(dev)]),
            "ov": ov, "fm": fm, "st": st, "got4": got4}


def seq_reclaim(m, cluster, keeper, tmp) -> dict:
    """Reclamation as a replicated collective: unlink, quarantine, free,
    the freed pages granted again."""
    tree = m.Tree(cluster)
    eng = m.batched.BatchedEngine(tree, batch_per_node=128)
    keys = np.arange(1, 3001, dtype=np.uint64) * np.uint64(7)
    m.batched.bulk_load(tree, keys, keys + np.uint64(1), fill=0.9)
    eng.attach_router()
    dead = keys[(keys > 700) & (keys < 9000)]
    eng.delete(dead)
    per = []
    for _ in range(4):
        st = eng.reclaim_empty_leaves()
        per.append([st[k] for k in ("unlinked", "freed", "candidates")])
    per = np.asarray(per)
    assert per[:, 0].sum() > 0 and per[:, 1].sum() > 0, per
    kept = np.setdiff1d(keys, dead)
    got, found = eng.search(kept)
    assert found.all(), f"lost {int((~found).sum())} keys after reclaim"
    np.testing.assert_array_equal(got, kept + np.uint64(1))
    _, f2 = eng.search(dead[:300])
    assert not f2.any()
    fresh = np.arange(1, 1501, dtype=np.uint64) * np.uint64(7) \
        + np.uint64(50000)
    eng.insert(fresh, fresh)
    got3, found3 = eng.search(fresh)
    assert found3.all()
    info = tree.check_structure()
    free = [d.allocator.pages_free for d in cluster.directories]
    return {"per": per, "got": got, "got3": got3,
            "keys": np.asarray([info["keys"]]), "free": np.asarray(free)}


def seq_staged(m, cluster, keeper, tmp, steps: int = 3) -> dict:
    """The staged aligned read loop and the staged mixed loop: every op
    verified on the device, the receipts summed over the ranks."""
    tree = m.Tree(cluster)
    B = 1024
    eng = m.batched.BatchedEngine(tree, batch_per_node=B)
    salt = 0x5E17_AB1E_5A17
    n_keys = 20000
    ranks = np.arange(n_keys, dtype=np.uint64)
    keys = m.bits.mix64_np(ranks ^ np.uint64(salt))
    order = np.argsort(keys)
    m.batched.bulk_load(tree, keys[order],
                        (keys ^ np.uint64(0xDEADBEEF))[order], fill=0.8)
    eng.attach_router()
    step, (new_carry, tb, rt, rk) = m.DP.make_staged_step(
        eng, n_keys=n_keys, theta=0.99, salt=salt, batch=B, dev_b=B,
        log2_bins=16, fusion="aligned")
    dsm = eng.dsm
    carry = new_carry()
    counters = dsm.counters
    for _ in range(steps):
        counters, carry = step(dsm.pool, counters, tb, rt, rk, carry)
    dsm.counters = counters
    ro = m.receipts(step, carry)
    assert ro[:2] == [steps, 1] and ro[2] == steps * B * 4, ro
    mstep, (new_mc, mtb, mrt, mrk) = m.DP.make_staged_mixed_step(
        eng, n_keys=n_keys, theta=0.99, salt=salt, batch=B, read_ratio=0.5,
        dev_rb=512, dev_wb=512, log2_bins=16)
    mc = new_mc()
    pool, counters = dsm.pool, dsm.counters
    for _ in range(steps):
        pool, counters, mc = mstep(pool, dsm.locks, counters, mtb, mrt,
                                   mrk, mc)
    mc = mstep.drain(mc)
    dsm.pool, dsm.counters = pool, counters
    mx = m.receipts(mstep, mc)
    assert mx[:4] == [steps, 1, steps * 512 * 4, steps * 512 * 4], mx
    return {"ro": np.asarray(ro), "mx": np.asarray(mx)}


def seq_storm(m, cluster, keeper, tmp) -> dict:
    """Hundreds of device leaf splits whose parent entries flush through
    the chunked replicated host path."""
    tree = m.Tree(cluster)
    eng = m.batched.BatchedEngine(tree, batch_per_node=128)
    base = np.arange(1, 401, dtype=np.uint64) * 1000
    m.batched.bulk_load(tree, base, base)
    eng.attach_router()
    rng = np.random.default_rng(5)
    dense = np.unique((base[:, None] + rng.integers(
        1, 1000, (400, 8), dtype=np.uint64)).reshape(-1))
    stats = eng.insert(dense, dense ^ np.uint64(0xF00))
    assert stats["device_splits"] >= 100, f"storm too small: {stats}"
    assert stats["host_path"] == 0, f"storm spilled to host path: {stats}"
    assert stats["rounds"] <= 80, f"unbounded retry: {stats}"
    got, found = eng.search(dense)
    assert found.all()
    np.testing.assert_array_equal(got, dense ^ np.uint64(0xF00))
    got2, found2 = eng.search(base)
    assert found2.all()
    info = tree.check_structure()
    assert info["keys"] == base.size + dense.size
    return {"stats": np.asarray([stats[k] for k in (
                "applied", "superseded", "host_path", "rounds",
                "device_splits")]),
            "got": got}


SEQS = {"cluster": seq_cluster, "engine": seq_engine,
        "reclaim": seq_reclaim, "staged": seq_staged, "storm": seq_storm}


# ---------------------------------------------------------------------------
# The two sides.
# ---------------------------------------------------------------------------

class PortMods:
    """The port's namespace for one rank on the CPU."""

    name = "port"
    is_port = True

    def _init(self):
        from sherman_tpu_torch.config import PAGE_WORDS
        from sherman_tpu_torch.models import batched, validate
        from sherman_tpu_torch.models.btree import Tree
        from sherman_tpu_torch.ops import bits
        from sherman_tpu_torch.parallel import dsm as D
        from sherman_tpu_torch.utils import checkpoint as CK
        from sherman_tpu_torch.workload import device_prep as DP
        self.PAGE_WORDS, self.batched, self.validate = \
            PAGE_WORDS, batched, validate
        self.Tree, self.bits, self.D, self.CK, self.DP = \
            Tree, bits, D, CK, DP
        self.restored = None

    def __init__(self, device: str = "cpu"):
        self._init()
        self.device = device

    def restore(self, path, keeper):
        return self.CK.restore(path, device=self.device, keeper=keeper)

    @staticmethod
    def receipts(step, carry) -> list:
        return list(step.receipts(carry))


class JaxMods:
    """The JAX package's namespace for its one process."""

    name = "jax"
    is_port = False

    def __init__(self):
        from sherman_tpu.config import PAGE_WORDS
        from sherman_tpu.models import batched, validate
        from sherman_tpu.models.btree import Tree
        from sherman_tpu.ops import bits
        from sherman_tpu.parallel import dsm as D
        from sherman_tpu.utils import checkpoint as CK
        from sherman_tpu.workload import device_prep as DP
        self.PAGE_WORDS, self.batched, self.validate = \
            PAGE_WORDS, batched, validate
        self.Tree, self.bits, self.D, self.CK, self.DP = \
            Tree, bits, D, CK, DP
        self.restored = None

    def restore(self, path, keeper):
        return self.CK.restore(path)

    @staticmethod
    def receipts(step, carry) -> list:
        return [int(np.asarray(x)) for x in carry]


def _port_dump(m, cluster, res) -> dict:
    out = {f"res_{k}": np.asarray(v) for k, v in res.items()}
    for tag, c in (("", cluster), ("restored_", m.restored)):
        if c is None:
            continue
        d = c.dsm
        out[tag + "pool"] = d.pool.cpu().numpy()
        out[tag + "locks"] = d.locks.cpu().numpy()
        out[tag + "counters"] = d.counters_np()
    return out


def port_rank(name: str, pid: int, tmp: str, device: str = "cpu") -> None:
    """One rank of a sequence on ``device``; dumps its blocks and results
    to ``<tmp>/<name>_r<pid>.npz``."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.parallel import bootstrap
    keeper = bootstrap.init_multihost()
    cluster = Cluster(DSMConfig(device=device, **CFGS[name]), keeper=keeper)
    assert cluster.dsm.multihost
    m = PortMods(device)
    res = SEQS[name](m, cluster, keeper, tmp)
    np.savez(os.path.join(tmp, f"{name}_r{pid}.npz"),
             **_port_dump(m, cluster, res))
    keeper.barrier("done")


def port_one(name: str, tmp: str, device: str = "cpu") -> dict:
    """The sequence on the port in this one process (every node)."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    m = PortMods(device)
    cluster = Cluster(DSMConfig(device=device, **CFGS[name]))
    m.name = "port_one"
    res = SEQS[name](m, cluster, cluster.keeper, tmp)
    return _port_dump(m, cluster, res)


def jax_run(name: str, tmp: str) -> dict:
    """The sequence on the JAX package in this process (``machine_nr``
    nodes of the test's CPU devices)."""
    from sherman_tpu.cluster import Cluster
    from sherman_tpu.config import DSMConfig
    m = JaxMods()
    cluster = Cluster(DSMConfig(**CFGS[name]))
    res = SEQS[name](m, cluster, cluster.keeper, tmp)
    out = {f"res_{k}": np.asarray(v) for k, v in res.items()}
    for tag, c in (("", cluster), ("restored_", m.restored)):
        if c is None:
            continue
        d = c.dsm
        out[tag + "pool"] = np.asarray(d.pool)
        out[tag + "locks"] = np.asarray(d.locks)
        out[tag + "counters"] = np.asarray(d.counters)
    return out
