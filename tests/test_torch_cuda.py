"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Garbage pools and addresses of every validity class, real pages of a
bulk-loaded tree, both stop levels and batch sizes that are not block
multiples; descent rounds with no, every, or a leading run of rows
active; write-back masks of every class at sizes on either side of 16
rows, also through views that are not 16-byte aligned; the exchange
all-to-all at vector-copy and word-copy widths and through its packer;
the multi-node serving path; the scan prefetch and the YCSB A-F matrix;
the structure validator, the scrub pass and the chaos pokes on a pool on
the card; the observability plane's card readings (the memory
accountant's CUDA allocator gauges, ``obs.device_trace`` naming the page
kernels, the kernel build's ledger entry); the hot-key tier and the
value heap against the CPU (the smoke's phase 23a/24a sequences), the
cached staged loop and the heap resolve on garbage handles; the serving
front door against the CPU (phase 25a's sequence) and the device prep on
garbage pairs; the replication plane against the CPU (phase 26a's
sequence) and a follower's apply and replica reads on the card; elastic
resize against the CPU (phase 27a's sequence); the multihost service plane
and host failover against the CPU (phase 28a's sequences) and both host
drills on the card at 4,000 keys with their pins; the native host tier
(the host-staged fan-out from ``BatchPrep`` buffers, the threaded local
lock counter and the index-cache descent on a pool on the card) against
the CPU.  Every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import transport as T
from sherman_tpu_torch.parallel import transport_kernel as TK

pytestmark = pytest.mark.cuda

UPDATE_LANES = (C.L_VER_W, C.L_VHI_W, C.L_VLO_W)
INSERT_LANES = (C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W, C.L_VLO_W)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    return torch.device("cuda")


def _words(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                         dtype=np.int64).astype(np.int32))


def _inputs(seed, B, P):
    rng = np.random.default_rng(seed)
    pool = _words(rng, (P, C.PAGE_WORDS))
    addr = _words(rng, B)
    k = B // 3     # in-range pages, pages past the pool, garbage words
    addr[:k] = torch.from_numpy(rng.integers(0, P, k).astype(np.int32))
    addr[k:2 * k] = torch.from_numpy(rng.integers(0, 2 * P, k)
                                      .astype(np.int32))
    khi, klo = _words(rng, B), _words(rng, B)
    # several rows find their key in their page's leaf and internal blocks
    n = min(B, P)
    addr[:n] = torch.arange(n, dtype=torch.int32)
    for i in range(n):
        hits = torch.from_numpy(rng.integers(0, C.LEAF_CAP, 3))
        pool[i, C.L_KHI_W + hits] = khi[i]
        pool[i, C.L_KLO_W + hits] = klo[i]
        pool[i, C.L_VER_W + hits] = (1 << 16) | 1
        ent = torch.from_numpy(rng.integers(0, C.INTERNAL_CAP, 4))
        pool[i, C.I_KHI_W + ent] = khi[i]
        pool[i, C.I_KLO_W + ent] = klo[i]
    pool[:, C.W_NKEYS] = torch.from_numpy(
        rng.integers(-4, C.INTERNAL_CAP + 4, P).astype(np.int32))
    active = torch.from_numpy(rng.integers(0, 2, B).astype(bool))
    return pool, addr, khi, klo, active


def _unique_targets(page, slot):
    key = page.long() * C.LEAF_CAP + slot.long()
    _, first = np.unique(key.numpy(), return_index=True)
    keep = torch.zeros(page.shape[0], dtype=torch.bool)
    keep[torch.from_numpy(first)] = True
    return keep


@pytest.mark.parametrize("seed,B,P,stop_level", [
    (0, 777, 32, 0), (1, 4099, 64, 1), (2, 8, 16, 0), (3, 100_003, 4096, 0)])
def test_kernels_match_plain_on_garbage(dev, seed, B, P, stop_level):
    pool, addr, khi, klo, active = _inputs(seed, B, P)
    on = lambda *ts: [t.to(dev) for t in ts]
    got = PK.descent_round(*on(pool, addr, khi, klo, active),
                           stop_level=stop_level)
    want = PK.descent_round_ref(pool, addr, khi, klo, active,
                                stop_level=stop_level)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[4].any()                      # multi-hit sums exercised
    pages, ok = PK.read_pages_local(*on(pool, addr, active))
    want_pages, want_ok = PK.read_pages_local(pool, addr, active)
    assert torch.equal(pages.cpu(), want_pages)
    assert torch.equal(ok.cpu(), want_ok)
    assert torch.equal(PK.gather_pages(*on(pool, addr)).cpu(),
                       PK.gather_pages_ref(pool, addr))
    rng = np.random.default_rng(seed + 100)
    page = torch.from_numpy(rng.integers(0, P, B).astype(np.int32))
    slot = torch.from_numpy(rng.integers(0, C.LEAF_CAP, B).astype(np.int32))
    applied = _unique_targets(page, slot) & active
    for lanes in (UPDATE_LANES, INSERT_LANES, (C.L_VER_W,)):
        ent = _words(rng, (B, len(lanes)))
        got = PK.writeback(*on(pool.clone(), page, slot, applied, ent),
                           lanes)
        want = PK.writeback_ref(pool.clone(), page, slot, applied, ent,
                                lanes)
        assert torch.equal(got.cpu(), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["inactive", "active", "head"])
@pytest.mark.parametrize("B", [1, 31, 33, 255, 257, 100_003])
def test_descent_round_batches_on_the_card(dev, B, kind):
    """Batches with no row, every row, or only a leading run of rows
    active (``search_combined`` pads its distinct keys so: key 0, inactive)
    on either side of the kernel's 256-row blocks."""
    P = 512
    pool, addr, khi, klo, active = _inputs(B, B, P)
    if kind == "inactive":
        active[:] = False
    elif kind == "active":
        active[:] = True
    else:
        head = max(1, B * 36 // 100)
        active[:head] = True
        active[head:] = False
        khi[head:] = 0
        klo[head:] = 0
        addr[head:] = addr[0] & C.ADDR_PAGE_MASK
    stop = B % 2
    PK.reset_launches()
    got = PK.descent_round(*[t.to(dev) for t in (pool, addr, khi, klo,
                                                 active)], stop_level=stop)
    want = PK.descent_round_ref(pool, addr, khi, klo, active,
                                stop_level=stop)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["descent_round"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


WB_MASKS = ("none", "all", "sparse", "group_first", "group_last")


def _wb_mask(kind, M, rng):
    r = torch.arange(M)
    return {"none": torch.zeros(M, dtype=torch.bool),
            "all": torch.ones(M, dtype=torch.bool),
            "sparse": torch.from_numpy(rng.random(M) < 0.03),
            "group_first": r % 16 == 0, "group_last": r % 16 == 15}[kind]


@pytest.mark.parametrize("offset", [0, 1, 15])
@pytest.mark.parametrize("kind", WB_MASKS)
@pytest.mark.parametrize("M", [1, 15, 16, 17, 1000, 100_003])
def test_writeback_mask_classes_on_the_card(dev, M, kind, offset):
    """Every mask class at sizes on either side of 16 rows and of a block,
    with ``applied`` as a view ``offset`` bytes into its buffer (not
    16-byte aligned unless offset is 0)."""
    rng = np.random.default_rng(M + offset)
    P = max(32, M // 16)
    lanes = (INSERT_LANES, UPDATE_LANES, (C.L_VER_W,))[M % 3]
    pool = _words(rng, (P, C.PAGE_WORDS))
    tgt = torch.from_numpy(rng.permutation(P * C.LEAF_CAP)[:M])
    page = (tgt // C.LEAF_CAP).to(torch.int32)
    slot = (tgt % C.LEAF_CAP).to(torch.int32)
    applied = _wb_mask(kind, M, rng)
    full = torch.zeros(M + offset, dtype=torch.bool)
    full[offset:] = applied
    applied_dev = full.to(dev)[offset:]
    assert applied_dev.data_ptr() % 16 == offset
    ent = _words(rng, (M, len(lanes)))
    PK.reset_launches()
    got = PK.writeback(pool.to(dev), page.to(dev), slot.to(dev), applied_dev,
                       ent.to(dev), lanes)
    want = PK.writeback_ref(pool.clone(), page, slot, applied, ent, lanes)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["writeback"] == 1
    assert torch.equal(got.cpu(), want)


def test_serving_path_on_the_card_matches_the_plain_path(dev):
    """Bulk load, routed lookups and fused read/update steps on the card
    leave the same pool, counters and answers as on the CPU."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 1 << 63, 20_000, dtype=np.uint64))
    q = keys[rng.integers(0, keys.size, 1024)]
    is_read = rng.random(1024) < 0.5
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(pages_per_node=2048, locks_per_node=1024,
                               step_capacity=1024, chunk_pages=64, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=1024,
                                    tcfg=TreeConfig(sibling_chase_budget=1))
        batched.bulk_load(tree, keys, keys ^ np.uint64(7))
        eng.attach_router()
        PK.reset_launches()
        out = [eng.search_combined(q), eng.mixed(q, q ^ np.uint64(9),
                                                 is_read), eng.search(q)]
        runs[d] = (cl.dsm.pool.cpu(), cl.dsm.counters.cpu(), out,
                   dict(PK.LAUNCHES))
    assert torch.equal(runs["cuda"][0], runs["cpu"][0])
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert all(v > 0 for v in runs["cuda"][3].values())
    assert not any(runs["cpu"][3].values())


# (N, C, W): the vector path, the word path (C*W % 4 != 0) and the size of
# a round-1 page reply (W = 257)
EXCHANGE_SHAPES = [(8, 4, 1), (4, 8, 16), (8, 1024, 257), (3, 5, 3),
                   (1, 7, 2)]


@pytest.mark.parametrize("n,c,w", EXCHANGE_SHAPES)
def test_exchange_matches_plain_on_garbage(dev, n, c, w):
    rng = np.random.default_rng(n * c + w)
    x = _words(rng, (n, n * c, w))
    TK.reset_launches()
    got = TK.all_to_all(x.to(dev))
    torch.cuda.synchronize()
    assert TK.LAUNCHES["exchange"] == 1
    assert torch.equal(got.cpu(), TK.all_to_all_ref(x))
    # a view one word into its buffer: the kernel takes its word path on
    # a base that is not 16-byte aligned
    buf = _words(rng, (n * n * c * w + 1,)).to(dev)
    y = buf[1:].view(n, n * c, w)
    assert torch.equal(TK.all_to_all(y).cpu(), TK.all_to_all_ref(y.cpu()))


def test_exchange_packer_on_the_card(dev):
    """Bools, float32 (NaN payloads) and int32 pages in one launch."""
    n, c = 8, 16
    rng = np.random.default_rng(5)
    tree = {"page": _words(rng, (n, n * c, 256)),
            "ok": torch.from_numpy(rng.integers(0, 2, (n, n * c))
                                   .astype(bool)),
            "f": _words(rng, (n, n * c)).view(torch.float32)}
    TK.reset_launches()
    got = T.exchange({k: v.to(dev) for k, v in tree.items()})
    want = T.exchange(tree)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["exchange"] == 1
    for k in tree:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k].cpu().contiguous().view(torch.uint8),
                           want[k].contiguous().view(torch.uint8)), k


def test_multinode_path_on_the_card_matches_the_plain_path(dev):
    """Eight nodes on the card: bulk load, routed lookups and fused
    read/update steps leave the same pool, counters and answers as on
    the CPU, through the exchange kernel."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(1, 1 << 63, 20_000, dtype=np.uint64))
    q = keys[rng.integers(0, keys.size, 4096)]
    is_read = rng.random(4096) < 0.5
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(machine_nr=8, pages_per_node=256,
                               locks_per_node=1024, step_capacity=256,
                               chunk_pages=16, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=512,
                                    tcfg=TreeConfig(sibling_chase_budget=1))
        batched.bulk_load(tree, keys, keys ^ np.uint64(7))
        eng.attach_router()
        PK.reset_launches()
        TK.reset_launches()
        out = [eng.search_combined(q), eng.mixed(q, q ^ np.uint64(9),
                                                 is_read), eng.search(q)]
        runs[d] = (cl.dsm.pool.cpu(), cl.dsm.counters.cpu(), out,
                   {**PK.LAUNCHES, **TK.LAUNCHES})
    assert torch.equal(runs["cuda"][0], runs["cpu"][0])
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    launched = runs["cuda"][3]
    assert launched["exchange"] > 0 and launched["gather_pages"] > 0
    assert launched["writeback"] > 0
    assert not any(runs["cpu"][3].values())


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_staged_loops_on_the_card_match_the_plain_path(dev, machine_nr):
    """The device-staged read loop (aligned, pipelined) and mixed loop
    (chained, pipelined) at 20,000 keys with the quantile-table sampler:
    the card and the CPU leave the same carries, pool, locks and
    counters, the card through its kernels."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig, TreeConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import device_prep as DP

    N, n_keys, salt = machine_nr, 20_000, 0x5E17AB1E5A17
    B = 2048 if N == 1 else 512
    keys = bits.mix64_np(np.arange(n_keys, dtype=np.uint64)
                         ^ np.uint64(salt))
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(machine_nr=N, pages_per_node=2048 // N * 2,
                               locks_per_node=1024, step_capacity=B,
                               chunk_pages=16, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=B,
                                    tcfg=TreeConfig(sibling_chase_budget=1))
        batched.bulk_load(tree, keys, keys ^ np.uint64(0xDEADBEEF), fill=0.8)
        eng.attach_router()
        dsm = cl.dsm
        PK.reset_launches()
        TK.reset_launches()
        carries = []
        for fusion in ("aligned", "pipelined"):
            step, (nc, tb, rt, rk) = DP.make_staged_step(
                eng, n_keys=n_keys, theta=0.99, salt=salt, batch=B,
                dev_b=B, log2_bins=16, fusion=fusion)
            assert step.jserve is eng._get_search_fanout(eng._iters())
            c = nc()
            for _ in range(3):
                _, c = step(dsm.pool, dsm.counters, tb, rt, rk, c)
            carries.append([int(x) for x in step.drain(c)])
        c = None
        for fusion in ("chained", "pipelined"):
            step, (nc, tb, rt, rk) = DP.make_staged_mixed_step(
                eng, n_keys=n_keys, theta=0.99, salt=salt, batch=B,
                read_ratio=0.5, dev_rb=B // 2, dev_wb=B // 2, log2_bins=16,
                fusion=fusion)
            c = nc() if c is None else c
            for _ in range(3):
                _, _, c = step(dsm.pool, dsm.locks, dsm.counters, tb, rt, rk,
                               c)
            c = step.drain(c)
            carries.append([int(x) for x in c])
        runs[d] = (carries, dsm.pool.cpu(), dsm.locks.cpu(),
                   dsm.counters.cpu(), {**PK.LAUNCHES, **TK.LAUNCHES})
    (ca, *sa, la), (cb, *sb, lb) = runs["cuda"], runs["cpu"]
    assert ca == cb
    assert ca[0][:3] == ca[1][:3] == [3, 1, 3 * B * N]
    assert ca[3][:4] == [6, 1, 6 * B // 2 * N, 6 * B // 2 * N]
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert la["gather_pages"] > 0 and la["writeback"] > 0
    assert la["descent_round" if N == 1 else "exchange"] > 0
    assert not any(lb.values())


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_insert_path_on_the_card_matches_the_plain_path(dev, machine_nr):
    """A small split storm through ``BatchedEngine.insert`` (5,000 warm
    keys at fill 0.9, 5,000 fresh, 64 grants a node a round, parents
    flushed every round): the card and the CPU leave the same stats,
    pool, locks and counters, the card through its kernels."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits

    N = machine_nr
    keys = bits.mix64_np(np.arange(10_000, dtype=np.uint64)
                         ^ np.uint64(0x5E17AB1E5A17))
    warm, fresh = np.sort(keys[:5000]), keys[5000:]
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(machine_nr=N, pages_per_node=1024,
                               locks_per_node=1024, step_capacity=512,
                               chunk_pages=16, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=512, split_slots=64)
        batched.bulk_load(tree, warm, warm, fill=0.9)
        eng.attach_router()
        PK.reset_launches()
        TK.reset_launches()
        st = eng.insert(fresh, fresh)
        launched = {**PK.LAUNCHES, **TK.LAUNCHES}
        v, f = eng.search_combined(keys)
        assert f.all() and (v == keys).all()
        runs[d] = (st, [t.cpu() for t in (cl.dsm.pool, cl.dsm.locks,
                                           cl.dsm.counters)], launched)
    assert runs["cuda"][0] == runs["cpu"][0]
    assert runs["cuda"][0]["device_splits"] > 0
    for x, y in zip(runs["cuda"][1], runs["cpu"][1]):
        assert torch.equal(x, y)
    launched = runs["cuda"][2]
    assert launched["gather_pages"] > 0 and launched["writeback"] > 0
    assert launched["descent_round" if N == 1 else "exchange"] > 0
    assert not any(runs["cpu"][2].values())


@pytest.mark.parametrize("M,P", [(64, 8), (100_003, 2048)])
def test_writeback_one_lane_duplicate_targets_on_the_card(dev, M, P):
    """The delete's one-lane clear: applied rows sharing a target word
    with equal values (every same-key row writes 0 to its version word)
    against the plain version."""
    rng = np.random.default_rng(M)
    pool = _words(rng, (P, C.PAGE_WORDS))
    n_t = max(2, M // 4)
    tgt = torch.from_numpy(rng.integers(0, P * C.LEAF_CAP, n_t)[
        rng.integers(0, n_t, M)])
    page = (tgt // C.LEAF_CAP).to(torch.int32)
    slot = (tgt % C.LEAF_CAP).to(torch.int32)
    applied = torch.from_numpy(rng.random(M) < 0.7)
    ent = torch.zeros((M, 1), dtype=torch.int32)
    lanes = (C.L_VER_W,)
    PK.reset_launches()
    got = PK.writeback(pool.to(dev), page.to(dev), slot.to(dev),
                       applied.to(dev), ent.to(dev), lanes)
    want = PK.writeback_ref(pool.clone(), page, slot, applied, ent, lanes)
    torch.cuda.synchronize()
    assert PK.LAUNCHES["writeback"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_delete_and_reclaim_on_the_card_match_the_plain_path(dev,
                                                             machine_nr):
    """Deletes of two key bands (duplicates and absent keys among them),
    three reclaim passes and inserts whose splits take the freed pages:
    the card and the CPU leave the same found masks, stats, pool, locks,
    counters, free lists and reclaim state, the card through its
    kernels."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    N = machine_nr
    keys = np.arange(1, 10_001, dtype=np.uint64) * np.uint64(7)
    i = np.arange(keys.size)
    dead = keys[((i > 100) & (i < 3500)) | ((i > 7000) & (i < 8000))]
    q = np.concatenate([dead, dead[:300], keys[-200:] + np.uint64(1)])
    fresh = np.concatenate([keys[-400:] + np.uint64(2),
                            keys[-400:] + np.uint64(4)])
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(machine_nr=N, pages_per_node=512,
                               locks_per_node=1024, step_capacity=512,
                               chunk_pages=16, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=512, split_slots=16)
        batched.bulk_load(tree, keys, keys, fill=0.9)
        eng.attach_router()
        PK.reset_launches()
        TK.reset_launches()
        found = eng.delete(q)
        stats = [eng.reclaim_empty_leaves() for _ in range(3)]
        stats.append(eng.insert(fresh, fresh))
        launched = {**PK.LAUNCHES, **TK.LAUNCHES}
        live = np.concatenate([np.setdiff1d(keys, dead), fresh])
        v, f = eng.search_combined(live)
        assert f.all() and (v == live).all()
        assert not eng.search(dead)[1].any()
        runs[d] = (found, stats, [t.cpu() for t in (
            cl.dsm.pool, cl.dsm.locks, cl.dsm.counters)],
            [x.allocator.free_pages_list for x in cl.directories],
            eng._reclaim_state, launched)
    a, b = runs["cuda"], runs["cpu"]
    assert (a[0] == b[0]).all() and a[0][:dead.size].all()
    assert a[1] == b[1] and sum(s["freed"] for s in a[1][:3]) > 0
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    assert a[3] == b[3] and a[4] == b[4]
    launched = a[5]
    assert launched["gather_pages"] > 0 and launched["writeback"] > 0
    assert launched["descent_round" if N == 1 else "exchange"] > 0
    assert not any(b[5].values())


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_scan_prefetch_on_the_card_matches_the_plain_path(dev, machine_nr):
    """``range_query_many`` on a tree that has split, with the router and
    with its bulk-load table put back (stale): the prefetch is one K2
    launch a call on the card, its pages equal the plain gather's, and
    the scans equal the CPU's."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits

    N = machine_nr
    keys = np.unique(bits.mix64_np(np.arange(8000, dtype=np.uint64)))
    keys = keys[keys > 0]
    rng = np.random.default_rng(2)
    lo = np.sort(rng.choice(keys, 300))
    ranges = [(int(a), min(int(a) + int(w), 2**64 - 1)) for a, w in zip(
        lo, rng.integers(1, 2**56, lo.size))] + [(1, 2**64 - 1)]
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(machine_nr=N, pages_per_node=2048,
                               locks_per_node=1024, step_capacity=512,
                               chunk_pages=16, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=512)
        batched.bulk_load(tree, keys, keys ^ np.uint64(5))
        eng.attach_router()
        stale = eng.router.table_np.copy()
        eng.insert(keys[::2] + np.uint64(1), keys[::2])
        cand = batched._scan_candidates(eng.router, ranges)
        pages = batched._scan_prefetch(eng, cand)
        PK.reset_launches()
        out = [eng.range_query_many(ranges)]
        launched = PK.LAUNCHES["gather_pages"]
        eng.router.table_np = stale
        out.append(eng.range_query_many(ranges))
        runs[d] = (pages, out, launched, [t.cpu() for t in (
            cl.dsm.pool, cl.dsm.counters)])
    a, b = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].shape[0] > 8 * N
    for xs, ys in zip(a[1], b[1]):
        for (k1, v1), (k2, v2) in zip(xs, ys):
            np.testing.assert_array_equal(k1, k2)
            np.testing.assert_array_equal(v1, v2)
    assert a[2] == 1 and b[2] == 0
    assert sum(k.size for k, _ in a[1][0]) > keys.size
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_ycsb_matrix_on_the_card_matches_the_plain_path(dev, machine_nr):
    """``ycsb_bench.build`` at 5,000 keys and A-F, 512 ops a step, 2
    steps each, one batch stream played on the card and on the CPU: the
    same counts, scans, pool, locks and counters; the card launched K2
    and K3 (and K1 on one node, K4 on eight)."""
    from sherman_tpu_torch import ycsb_bench as YB
    from sherman_tpu_torch.workload.ycsb import YcsbGen

    class Replay:
        def __init__(self, batches, gen):
            self.batches, self.gen = list(batches), gen

        def batch(self, n):
            return self.batches.pop(0)

        def expectations(self):
            return self.gen.expectations()

    n_keys, ops, steps = 5000, 512, 2
    stream = {}
    for w in "ABCDEF":
        gen = YcsbGen(w, n_keys, seed=17, salt=YB.SALT)
        stream[w] = ([gen.batch(ops) for _ in range(steps + 1)], gen)
    runs = {}
    for d in ("cuda", "cpu"):
        cl, _, eng, _ = YB.build(n_keys, ops, machine_nr, d,
                                 log=lambda m: None)
        scans, scan = [], eng.range_query_many
        eng.range_query_many = lambda r: scans.append(scan(r)) or scans[-1]
        PK.reset_launches()
        TK.reset_launches()
        counts = {w: YB.run_workload(eng, Replay(*s), ops=ops,
                                     steps=steps)["counts"]
                  for w, s in stream.items()}
        runs[d] = (counts, scans, [t.cpu() for t in (
            cl.dsm.pool, cl.dsm.locks, cl.dsm.counters)],
            {**PK.LAUNCHES, **TK.LAUNCHES})
    a, b = runs["cuda"], runs["cpu"]
    assert a[0] == b[0] and a[0]["E"]["scan"] > 0
    assert len(a[1]) == len(b[1]) == steps + 1
    for xs, ys in zip(a[1], b[1]):
        for (k1, v1), (k2, v2) in zip(xs, ys):
            np.testing.assert_array_equal(k1, k2)
            np.testing.assert_array_equal(v1, v2)
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    assert a[3]["gather_pages"] > 0 and a[3]["writeback"] > 0
    assert a[3]["descent_round" if machine_nr == 1 else "exchange"] > 0
    assert not any(b[3].values())


def _integrity_tree(device, N):
    """A bulk-loaded tree with inserts, deletes of every sixth key and of
    a band, and three reclaim passes: retired, parked and freed pages."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree

    keys = np.arange(1, 8001, dtype=np.uint64) * np.uint64(7)
    cl = Cluster(DSMConfig(machine_nr=N, pages_per_node=1024,
                           locks_per_node=512, step_capacity=256,
                           chunk_pages=16, device=device))
    tree = Tree(cl)
    eng = batched.BatchedEngine(tree, batch_per_node=256)
    batched.bulk_load(tree, keys[::2], keys[::2], fill=0.9)
    eng.attach_router()
    eng.insert(keys[1::2], keys[1::2])
    eng.delete(np.concatenate([keys[::6], keys[1000:3000]]))
    for _ in range(3):
        eng.reclaim_empty_leaves()
    return tree, eng


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_validator_and_scrub_on_the_card_match_the_cpu(dev, machine_nr):
    """check_structure_device and scrub_pass on a grown, reclaimed tree,
    then the raw counts and masks on a garbage image of its pool: the
    card's equal the CPU's."""
    from sherman_tpu_torch.models import validate as V

    runs = {}
    for d in ("cuda", "cpu"):
        tree, _ = _integrity_tree(d, machine_nr)
        runs[d] = (V.check_structure_device(tree), V.scrub_pass(tree),
                   tree.dsm.pool.cpu(),
                   [x.allocator.pages_used for x in tree.cluster.directories])
    a, b = runs["cuda"], runs["cpu"]
    assert a[0] == b[0] and a[1] == b[1] and torch.equal(a[2], b[2])
    assert a[1]["violations"] == 0 and a[0]["retired"] > 1
    rng = np.random.default_rng(7)
    pool = a[2].clone()
    rows = torch.from_numpy(rng.choice(pool.shape[0], pool.shape[0] // 3,
                                       replace=False))
    for w in (C.W_SIBLING, C.W_LEFTMOST, C.W_FRONT_VER, C.W_LEVEL):
        pool[rows, w] = _words(rng, rows.numel())
    pool[rows, C.I_PTR_W:C.I_PTR_W + C.INTERNAL_CAP] = _words(
        rng, (rows.numel(), C.INTERNAL_CAP))
    N, P = machine_nr, pool.shape[0] // machine_nr
    nxt = torch.tensor(a[3], dtype=torch.int64)
    freed = torch.from_numpy(rng.random(N * P) < 0.1)
    out = {}
    for d in ("cuda", "cpu"):
        args = (pool.to(d), nxt.to(d))
        out[d] = (V._validate_kernel(*args, freed.to(d), P, N),
                  *(x.cpu() for x in V._scrub_kernel(*args, P, N)))
    assert out["cuda"][0] == out["cpu"][0]
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert int(out["cuda"][2]) == int(out["cpu"][2])
    assert out["cpu"][1].any()


def test_fault_kinds_on_a_cuda_pool(dev):
    """Every fault kind fired through install_chaos on a pool on the card
    and on the CPU: the replies, pools, locks and dirty rows equal, and
    undo restores both."""
    from sherman_tpu_torch import chaos as CH
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.parallel import dsm as D

    faults = [{"kind": "torn_page", "step": 0},
              {"kind": "flip_entry_ver", "step": 0, "slot": 5},
              {"kind": "wedge_lock", "step": 1},
              {"kind": "drop_cas", "step": 2},
              {"kind": "stale_read", "step": 4}]
    runs = {}
    for d in ("cuda", "cpu"):
        tree, _ = _integrity_tree(d, 1)
        dsm = tree.dsm
        before = dsm.pool.cpu().clone()
        plan = CH.FaultPlan([dict(f) for f in faults], seed=3)
        dsm.install_chaos(plan)
        addr = tree._root_addr
        rep = [dsm.read_word(0, 0), dsm.read_word(0, 0),
               dsm.cas(bits.make_addr(0, 5), 0, 0, tree.ctx.lease,
                       space=D.SPACE_LOCK),
               dsm.write_words(addr, 200, np.array([77], np.int32)),
               dsm.read_page(addr)]
        dsm.install_chaos(None)
        state = [dsm.pool.cpu().clone(), dsm.locks.cpu().clone(),
                 dsm.dirty_rows(), plan.describe(), list(plan._undo)]
        plan.undo(dsm)
        state.append(dsm.pool.cpu().clone())
        runs[d] = (rep, state, before)
    (ra, sa, ba), (rb, sb, bb) = runs["cuda"], runs["cpu"]
    assert ra[:3] == rb[:3]
    assert np.array_equal(ra[4], rb[4])
    assert all(torch.equal(x, y) for x, y in zip(sa[:2], sb[:2]))
    assert np.array_equal(sa[2], sb[2]) and sa[3:5] == sb[3:5]
    assert all(f["fired"] for f in sa[3])
    # the write of step 3 is not undone, the corruptions are
    restored = sa[5].clone()
    restored[:, 200] = ba[:, 200]
    assert torch.equal(sa[5], sb[5]) and torch.equal(restored, ba)


def test_delta_gather_on_the_card_matches_the_plain_twin(dev):
    """The delta checkpoint's dirty-page gather: one ``gather_pages``
    launch on the card, equal to the plain version and to ``pool[rows]``
    on the CPU."""
    from sherman_tpu_torch.utils import checkpoint as CK

    tree, _ = _integrity_tree("cuda", 1)
    pool = tree.dsm.pool
    rows = tree.dsm.dirty_rows()
    assert rows.size > 0
    PK.reset_launches()
    got = CK._gather_rows(pool, rows)
    assert PK.LAUNCHES["gather_pages"] == 1
    host = pool.cpu()
    want = PK.gather_pages_ref(host, torch.from_numpy(rows.astype(np.int32)))
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got, host.numpy()[rows])
    assert CK._gather_rows(pool, np.zeros(0, np.int64)).shape == \
        (0, C.PAGE_WORDS)


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_recovery_plane_on_the_card_matches_the_cpu(dev, tmp_path,
                                                     machine_nr):
    """One journaled op sequence, a delta, a torn tail and ``recover`` on
    the card and on the CPU: byte-identical journal segments, equal delta
    rows and pages, equal recovered pools, locks, counters and free
    pools."""
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.utils import journal as J

    runs = {}
    for d in ("cuda", "cpu"):
        tree, eng = _integrity_tree(d, machine_nr)
        rdir = str(tmp_path / d)
        plane = RecoveryPlane(tree.cluster, tree, eng, rdir)
        plane.checkpoint_base()
        fresh = np.arange(1, 201, dtype=np.uint64) * np.uint64(1 << 40)
        eng.insert(fresh, fresh)
        eng.delete(np.arange(7, 700, 7, dtype=np.uint64) * np.uint64(7))
        eng.mixed(fresh[:50], fresh[:50] ^ np.uint64(3),
                  np.arange(50) % 2 == 0)
        with np.load(plane.checkpoint_delta()["path"]) as z:
            delta = (z["delta_rows"], z["delta_pages"])
        eng.insert(fresh[100:], fresh[100:] ^ np.uint64(5))
        seg = eng.journal.path
        plane.close()
        blob = open(seg, "rb").read()
        rec = J.encode_record(J.J_DELETE, fresh[:4])
        with open(seg, "ab") as f:
            f.write(rec[:-2])
        _, c2, _, _, receipt = RecoveryPlane.recover(
            rdir, device=d, batch_per_node=256)
        runs[d] = (blob, delta, receipt["replay"],
                   [t.cpu().clone() for t in (c2.dsm.pool, c2.dsm.locks,
                                              c2.dsm.counters)],
                   [x.allocator.free_pages_list for x in c2.directories])
    a, b = runs["cuda"], runs["cpu"]
    assert a[0] == b[0] and a[2] == b[2] and a[4] == b[4]
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert all(torch.equal(x, y) for x, y in zip(a[3], b[3]))


def test_accountant_reports_the_cuda_allocator_beside_the_pool(dev):
    """The memory accountant's pool source and the CUDA allocator's own
    figures, read without a sync."""
    from sherman_tpu_torch import obs

    tree, _ = _integrity_tree("cuda", 1)
    snap = obs.snapshot()
    pool_bytes = tree.dsm.pool.numel() * 4
    assert snap["device.hbm_pool_bytes"] == pool_bytes
    assert snap["device.cuda_allocated_bytes"] >= pool_bytes
    assert snap["device.cuda_max_allocated_bytes"] \
        >= snap["device.cuda_allocated_bytes"]
    assert snap["device.cuda_reserved_bytes"] \
        >= snap["device.cuda_allocated_bytes"]


def test_device_trace_names_the_page_kernels(dev, tmp_path):
    """``obs.device_trace`` over a CUDA search and a write step: the
    torch profiler's Chrome trace names K1, K2 and K3."""
    import json
    import os

    from sherman_tpu_torch.obs import spans

    tree, eng = _integrity_tree("cuda", 1)
    keys = np.arange(1, 8001, 2, dtype=np.uint64) * np.uint64(7)
    eng.search_combined(keys[:256])
    with spans.device_trace(str(tmp_path / "prof")):
        eng.search_combined(keys[:256])
        eng.mixed(keys[:64], keys[:64] ^ np.uint64(1),
                  np.arange(64) % 2 == 0)
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        names = " ".join(e.get("name", "")
                         for e in json.load(f)["traceEvents"])
    for k in ("descent_round_kernel", "gather_pages_kernel",
              "writeback_kernel"):
        assert k in names, k


def test_kernel_build_is_a_ledger_entry(dev):
    """The build of ``ops/csrc`` and ``parallel/csrc`` is the port's one
    real compile: a ``build.page_kernels`` ledger entry with its wall and
    its sources."""
    from sherman_tpu_torch.obs import device as DEV

    PK.load_library()
    e = DEV.get_ledger().entry("build.page_kernels")
    assert e is not None and e.compiles >= 1 and e.compile_ms > 0
    (sig,) = e.signatures
    for src in ("sherman_tpu_torch/ops/csrc/page_kernels.cu",
                "sherman_tpu_torch/parallel/csrc/exchange.cu"):
        assert src in sig


def _smoke():
    """``chip_smoke.py`` (the repo root's), whose phase 23a/24a sequences
    these card tests share."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_leaf_cache_on_the_card_matches_the_cpu(dev, machine_nr):
    """The hot-key tier's sequence (probes, fills, the write paths'
    invalidations, reclaim, auto-admission, a quarantine, the degraded
    flush, the sidecar) on the card and on the CPU: answers, the cache's
    mirror, stats and device tables, pools and counters bit-identical."""
    PK.reset_launches()
    _smoke().cache_reference_check(machine_nr)
    assert PK.LAUNCHES["gather_pages"] > 0


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_value_heap_on_the_card_matches_the_cpu(dev, machine_nr):
    """The value heap's sequence (puts, gets with and without the cache,
    scans, overwrites, removes, the double free, scrub, rebuild, a
    checkpoint chain, a crash and ``recover``) on the card and on the CPU:
    payloads, heap regions, allocators, journal bytes and the recovered
    state bit-identical."""
    PK.reset_launches()
    _smoke().heap_reference_check(machine_nr)
    assert PK.LAUNCHES["gather_pages"] > 0 and PK.LAUNCHES["writeback"] > 0


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_cached_staged_loop_on_the_card_matches_the_cpu(dev, machine_nr):
    """The staged read loop with the cache probe (aligned and pipelined, a
    tight residual cap and a starved one) leaves the same carries on the
    card and on the CPU, and the same as the loop without the cache."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits
    from sherman_tpu_torch.workload import device_prep as DP

    N, n_keys, salt = machine_nr, 20_000, 0x5E17AB1E5A17
    B = 2048 if N == 1 else 512
    keys = bits.mix64_np(np.arange(n_keys, dtype=np.uint64)
                         ^ np.uint64(salt))
    runs = {}
    for d in ("cuda", "cpu"):
        cl = Cluster(DSMConfig(machine_nr=N, pages_per_node=2048 // N * 2,
                               locks_per_node=1024, step_capacity=B,
                               chunk_pages=16, device=d))
        tree = Tree(cl)
        eng = batched.BatchedEngine(tree, batch_per_node=B)
        batched.bulk_load(tree, keys, keys ^ np.uint64(0xDEADBEEF), fill=0.8)
        eng.attach_router()
        lc = eng.attach_leaf_cache(slots=2048)
        lc.fill(bits.mix64_np(np.arange(lc.capacity, dtype=np.uint64)
                              ^ np.uint64(salt)))
        carries = []
        for fusion, resid, cache in (("aligned", None, None),
                                     ("aligned", None, lc),
                                     ("pipelined", B // 2, lc),
                                     ("aligned", 16, lc)):
            step, (nc, tb, rt, rk) = DP.make_staged_step(
                eng, n_keys=n_keys, theta=0.99, salt=salt, batch=B,
                dev_b=B, log2_bins=16, fusion=fusion, leaf_cache=cache,
                dev_b_resid=resid)
            c = nc()
            for _ in range(3):
                _, c = step(cl.dsm.pool, cl.dsm.counters, tb, rt, rk, c)
            carries.append([int(x) for x in step.drain(c)])
        runs[d] = (carries, cl.dsm.counters.cpu())
    (ca, na), (cb, nb) = runs["cuda"], runs["cpu"]
    assert ca == cb and torch.equal(na, nb)
    assert ca[0] == ca[1][:5] == ca[2][:5] and ca[1][1] == 1
    assert ca[1][5] > 0 and ca[3][1] == 0


def test_heap_resolve_on_garbage_matches_the_cpu(dev):
    """``resolve_rows`` over a heap of random words and handles of every
    validity class (rows out of range, negative rows, wrong classes,
    version 0, versions of 0x8000 and above): payloads, lengths and
    ``ver_ok`` equal on the card and on the CPU."""
    from sherman_tpu_torch.config import DSMConfig
    from sherman_tpu_torch.models.value_heap import resolve_rows

    rng = np.random.default_rng(12)
    H, M = 777, 100_003
    heap = rng.integers(-2**31, 2**31, (H, C.PAGE_WORDS), dtype=np.int64)
    heap = heap.astype(np.int32)
    rows = rng.integers(-5, H + 5, M).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, M, dtype=np.int64).astype(np.int32)
    act = rng.random(M) < 0.9
    # a third of the rows made valid: their headers carry the handles'
    # versions, some with the version's top bit set
    v = rng.integers(0, M, M // 3)
    r = rng.integers(0, H, v.size).astype(np.int32)
    cls = rng.integers(0, 4, v.size)
    slab = rng.integers(0, 7, v.size) % (255 // np.array([8, 16, 32, 64])
                                         [cls])
    ver = rng.integers(1, 0x10000, v.size)
    rows[v] = r
    lo[v] = ((slab << 24) | (cls << 20) | ver).astype(np.uint32).view(
        np.int32)
    off = slab * np.array([8, 16, 32, 64])[cls]
    heap[r, off] = ((ver << 16) | rng.integers(0, 300, v.size)).astype(
        np.uint32).view(np.int32)
    hcfg = DSMConfig(pages_per_node=H, step_capacity=M, device="cpu")
    outs = []
    for d in ("cuda", "cpu"):
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(d)
        outs.append([x.cpu() for x in resolve_rows(
            t(heap), t(rows), t(lo), t(act), hcfg=hcfg)])
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert outs[1][2].sum() > M // 20


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_front_door_on_the_card_matches_the_cpu(dev, machine_nr):
    """The front door's sequence (the ingress step on host and device
    prep at three rungs, a serial ShermanServer sequence with rids, a
    scan, a degraded entry, a deadline shed, payloads through the value
    heap) on the card and on the CPU: answers, device prep outputs,
    pools, journal bytes, dedup windows and the heap bit-identical, the
    auditor clean."""
    PK.reset_launches()
    _smoke().front_reference_check(machine_nr)
    assert PK.LAUNCHES["writeback"] > 0
    if machine_nr == 1:
        assert PK.LAUNCHES["descent_round"] > 0


@pytest.mark.parametrize("W", [1, 257, 4096, 100_003])
def test_device_prep_on_garbage_matches_the_cpu(dev, W):
    """``make_device_prep`` on random raw pairs (the sentinel pair among
    them, duplicates, every partial count) and random router tables and
    shifts: the six outputs equal on the card and on the CPU."""
    import types
    from sherman_tpu_torch.workload.device_prep import make_device_prep

    rng = np.random.default_rng(W)
    for trial in range(3):
        n = int(rng.integers(1, W + 1))
        pool = rng.integers(-2**31, 2**31, max(2, n // 3), dtype=np.int64)
        kh = rng.choice(pool, W).astype(np.int32)
        kl = rng.choice(pool, W).astype(np.int32)
        kh[n:] = -1
        kl[n:] = -1
        nb = 1 << int(rng.integers(1, 20))
        table = rng.integers(-2**31, 2**31, nb, dtype=np.int64).astype(
            np.int32)
        shift = int(rng.integers(0, 64))
        outs = []
        for d in ("cuda", "cpu"):
            fn = make_device_prep(types.SimpleNamespace(
                device=torch.device(d)), width=W)
            t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(d)
            outs.append([x.cpu() for x in fn(
                t(kh), t(kl), n, t(table),
                torch.tensor(shift, dtype=torch.int64, device=d))])
        for x, y in zip(*outs):
            assert torch.equal(x, y), (trial, n, shift)


@pytest.mark.parametrize("machine_nr", [1, 8])
def test_replication_on_the_card_matches_the_cpu(dev, machine_nr):
    """The replication plane's sequence (phase 26a: ship, a sweeping
    delta, replica reads, a chaos storm, quorum waits, an anti-entropy
    repair, the split-brain fence and the promotion with its retried
    rids) on the card and on the CPU: pools, watermarks, windows, tails
    and counters bit-identical."""
    PK.reset_launches()
    _smoke().repl_reference_check(machine_nr)
    assert PK.LAUNCHES["writeback"] > 0
    if machine_nr == 1:
        assert PK.LAUNCHES["descent_round"] > 0


def test_follower_apply_and_replica_read_on_the_card(dev, tmp_path):
    """A follower on the card applies shipped upserts and deletes through
    the page kernels and serves certified replica reads; its pool, its
    answers and its counters equal a CPU follower's on the same journal."""
    from sherman_tpu_torch.failover_drill import build_cluster
    from sherman_tpu_torch.models import batched
    from sherman_tpu_torch.recovery import RecoveryPlane
    from sherman_tpu_torch.replica import ReplicaGroup

    out = []
    for d in ("cuda", "cpu"):
        cluster, tree, eng = build_cluster(1, 1024, 128, device=d,
                                           locks_per_node=256,
                                           chunk_pages=32)
        keys = np.arange(1, 2001, dtype=np.uint64) * np.uint64(97)
        batched.bulk_load(tree, keys, keys ^ np.uint64(0xFA11))
        eng.attach_router()
        plane = RecoveryPlane(cluster, tree, eng, str(tmp_path / d))
        plane.checkpoint_base()
        group = ReplicaGroup(plane, 1, cache_slots=256, poll_ms=1e9)
        f = group.followers[0]
        assert f.cluster.dsm.pool.device.type == d
        eng.insert(keys[:300], keys[:300] ^ np.uint64(0x77))
        eng.delete(keys[300:340])
        PK.reset_launches()
        applied = group.pump()
        launched = dict(PK.LAUNCHES)
        f.admit(keys[:64])
        got = group.read(np.concatenate([keys[:64], keys[300:310]]))
        out.append([applied, f.cluster.dsm.pool.cpu(), got,
                    group.reads_served, group.reads_forwarded,
                    dict(f.stats)])
        if d == "cuda":
            assert launched["writeback"] > 0 and launched["descent_round"] > 0
        group.close()
        plane.close()
    a, b = out
    assert a[0] == b[0] == 2
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)
    assert a[3:] == b[3:] and a[3] > 0


@pytest.mark.parametrize("src,dst", [(1, 4), (4, 6)])
def test_migration_on_the_card_matches_the_cpu(dev, tmp_path, src, dst):
    """Phase 27a's resize sequence (grow under traffic, a delta with the
    dirty sink, a crash, ``resume``, the cutover through the certification
    gather, the offline reshard and the restore at the target) with the
    heap off and on, on the card and on the CPU: the emitted arrays, the
    artifacts by seq, the migrate counters and the restored tree
    bit-identical."""
    PK.reset_launches()
    S = _smoke()
    S.resize_reference_check(cases=((src, dst),), replay_shapes=False)
    assert PK.LAUNCHES["gather_pages"] > 0 and PK.LAUNCHES["writeback"] > 0
    if src == 1:
        assert PK.LAUNCHES["descent_round"] > 0


def test_host_planes_on_the_card_match_the_cpu(dev):
    """Phase 28a's sequences (the routed door, per-host deltas, a torn
    tail, ``recover_union``, the cross-host tail; leases, a freeze,
    detection, the adoption, the zombie's suffix, the hand-back) on the
    card and on the CPU: answers, pools, artifact names and journal bytes
    (chain ids by role), receipts, counters and merged stats
    bit-identical."""
    PK.reset_launches()
    _smoke().host_reference_check(replay_shapes=False)
    for k in ("descent_round", "gather_pages", "writeback"):
        assert PK.LAUNCHES[k] > 0, k


@pytest.mark.parametrize("drill", ["multihost", "hostfail"])
def test_host_drill_on_the_card(dev, tmp_path, drill):
    """The multihost and hostfail drills on the card at the reference's
    4,000 keys, every pin held, the page kernels launched."""
    import importlib
    mod = importlib.import_module(f"sherman_tpu_torch.{drill}_drill")
    PK.reset_launches()
    out = mod.run(mod.parse_args(["--keys", "4000", "--dir",
                                  str(tmp_path)]))
    assert out["ok"] and out["lost_acks"] == 0 and out["linearizable"]
    if drill == "multihost":
        assert out["rpo_ops"] == 0
        assert out["ack_bandwidth"]["speedup"] >= 1.5
    else:
        assert out["duplicate_acks"] == out["fenced_acks_merged"] == 0
        assert out["unadopted_dead_hosts"] == 0
    for k in ("descent_round", "gather_pages", "writeback"):
        assert PK.LAUNCHES[k] > 0, k


def _native_tree(device, n_keys=20_000, batch=4096):
    from sherman_tpu_torch import bench
    return bench.build(n_keys, batch, batch, device, log=lambda m: None)


def test_host_staged_fanout_on_the_card_matches_the_cpu(dev):
    """``BatchPrep`` buffers (``bench.HostStager``: page-locked, uploaded
    on the current stream) through ``_get_search_fanout`` on the card and
    on the CPU from one seed: the prep buffers, ``done``, ``found``,
    ``vhi`` and ``vlo``, the pools and the counters equal; every answer
    ``key ^ 0xDEADBEEF``."""
    from sherman_tpu_torch import bench
    PK.reset_launches()
    side = {}
    for d in ("cuda", "cpu"):
        b = _native_tree(d)
        eng = b["eng_c"]
        dev_b, _ = bench.size_host_dev_b(20_000, 0.99, b["salt"], 4096)
        st = bench.HostStager(eng, 20_000, 0.99, b["salt"], 4096, dev_b)
        assert st.cuda == (d == "cuda")
        out = []
        for k in range(4):
            buf = st.prep(k % 2, want_keys=True)
            x = st.upload(k % 2)
            res = st.serve(x)
            assert int(st.wrong(x, res)) == 0
            out.append([buf.keys.copy(), buf.inv.copy(), buf.start.copy()]
                       + [r.cpu().numpy() for r in res])
        side[d] = (out, [t.cpu() for t in (eng.dsm.pool, eng.dsm.counters)])
    for a, b in zip(side["cuda"][0], side["cpu"][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(side["cuda"][1], side["cpu"][1]):
        assert torch.equal(x, y)
    assert PK.LAUNCHES["descent_round"] > 0


def test_threaded_local_locks_on_a_cuda_pool(dev):
    """Four host ``Tree`` clients increment one word of a pool on the card
    under one lock word: the counter exact, and the local tier's hand-over
    keeps the global CAS and unlocks under half the ops."""
    rec = _smoke().native_lock_counter("cuda")
    assert rec["counter"] == rec["ops"] == 160
    assert rec["cas"] < 80 and rec["unlocks"] < 80


def test_index_cache_descent_on_a_cuda_pool(dev):
    """A host ``Tree`` with the index cache over a pool on the card and
    over one on the CPU: probes, fresh inserts that split leaves, reads
    back; answers and cache stats equal."""
    from sherman_tpu_torch.models.btree import Tree
    from sherman_tpu_torch.ops import bits
    out = []
    for d in ("cuda", "cpu"):
        b = _native_tree(d)
        t = Tree(b["cluster"])
        t.enable_index_cache(1024)
        keys = b["vals"][:200] ^ np.uint64(0xDEADBEEF)
        fresh = bits.mix64_np(np.arange(20_000, 20_200, dtype=np.uint64)
                              ^ np.uint64(b["salt"]))
        got = [t.search(int(k)) for k in keys]
        got += [t.search(int(k)) for k in keys]
        for k in fresh:
            t.insert(int(k), int(k) + 1)
        got += [t.search(int(k)) for k in fresh]
        out.append((got, t.index_cache.stats()))
    assert out[0] == out[1]
    assert out[0][1]["hits"] > 0 and out[0][1]["adds"] > 0
    assert out[0][0][:200] == [int(v) for v in b["vals"][:200]]


# -- the drivers (python -m sherman_tpu_torch.<driver>) on the card ----------

def _drive(mod, argv, device, capsys=None):
    out = mod.main(list(argv) + ["--device", device])
    if capsys is not None:
        capsys.readouterr()
    return out


def _same(a, b, drop):
    """Two receipts equal but for their wall-clock fields, their paths and
    the compressed sizes of checkpoint files (whose epochs hold nonces)."""
    strip = lambda d: {k: v for k, v in d.items() if k not in drop}
    assert strip(a) == strip(b)
    if "delta1" in a:
        assert a["delta1"]["pages"] == b["delta1"]["pages"]
        assert a["repair"]["pages"] == b["repair"]["pages"]


_TIMES = ("value", "elapsed_s", "fresh_insert_ops_s", "splits_s", "wall_s",
          "churn_ops_s", "reclaim_ms_mean", "reclaim_ms_max", "dir",
          "rto_ms", "recover", "repair", "blackbox", "upsert_ops_s",
          "lock_us", "delta1")


@pytest.mark.parametrize("name,argv", [
    ("insert_bench", ["--keys", "20000", "--fresh", "6000", "--chunk",
                      "2048", "--split-slots", "256", "--verify"]),
    ("insert_bench", ["--keys", "20000", "--fresh", "6000", "--chunk",
                      "1024", "--split-slots", "256", "--nodes", "4"]),
    ("churn_bench", ["--keys", "30000", "--window", "2500", "--iters", "6",
                     "--chunk", "8192"]),
    ("chaos_drill", ["--keys", "2500", "--nodes", "4"]),
    ("recovery_drill", ["--keys", "2500", "--nodes", "4"]),
    ("tree_test", ["4", "--n", "2000"]),
    ("write_test", ["2", "--n", "4000", "--batch", "1024"]),
])
def test_driver_on_the_card_matches_the_cpu(dev, capsys, name, argv):
    import importlib
    mod = importlib.import_module(f"sherman_tpu_torch.{name}")
    card = _drive(mod, argv, "cuda", capsys)
    cpu = _drive(mod, argv, "cpu", capsys)
    _same(card, cpu, _TIMES)
    assert card.get("ok", True)


def test_skiplist_test_driver(dev, capsys):
    from sherman_tpu_torch import skiplist_test
    r = skiplist_test.main(["--inserts", "2000", "--seeks", "200"])
    assert r["ok"] and "PASS" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["1", "95", "2", "--theta", "0.99"],
    ["8", "50", "2"],
    ["2", "100", "1", "--combine", "on", "--scans", "2", "--scan-span",
     "50"],
    ["2", "100", "1", "--ops-per-coro", "4", "--exchange", "pallas"],
])
def test_benchmark_driver_on_the_card(dev, capsys, argv):
    from sherman_tpu_torch import benchmark
    r = benchmark.main(argv + ["--keys", "20000", "--secs", "1.5",
                               "--window", "0.5", "--device", "cuda"])
    out = capsys.readouterr().out
    assert r["peak_ops"] > 0 and len(r["windows"]) == 3
    assert r["latency_us"] and "cluster tp" in out
    if "pallas" in argv:
        assert "counter diff vs xla: none (exact match)" in out


def test_latency_bench_driver_on_the_card(dev, capsys):
    from sherman_tpu_torch import latency_bench
    r = latency_bench.main(["--keys", "50000", "--widths", "1024,4096",
                            "--blocks", "4", "--kblk", "2", "--device",
                            "cuda"])
    capsys.readouterr()
    assert [x["width"] for x in r["rows"]] == [1024, 4096]
    assert all(x["ops_s"] > 0 and x["span_clock"] == "cuda_events"
               and x["ol_samples"] == 4 for x in r["rows"])


def test_profile_gather_driver_on_the_card(dev, capsys):
    from sherman_tpu_torch import profile_gather
    r = profile_gather.main(["--rows", "4096", "--keys", "20000", "--k",
                             "1", "--device", "cuda"])
    capsys.readouterr()
    assert r["kernel_on_card"]
    assert set(r["phases"]) == {"descent_round", "snapshot_gather",
                                "writeback_3w", "writeback_5w"}
    for ph, by in r["phases"].items():
        assert {"twin", "kernel", "ratio"} <= set(by), ph
        assert ("library" in by) == (ph != "descent_round")


def test_profile_insert_driver_on_the_card(dev, capsys):
    from sherman_tpu_torch import profile_insert
    r = profile_insert.main(["--rows", "4096", "--keys", "20000", "--k",
                             "1", "--device", "cuda"])
    capsys.readouterr()
    assert r["insert_step_update_only"] > 0 and r["page_snapshot_gather"] > 0


def test_profile_prep_driver_on_the_card(dev, capsys):
    from sherman_tpu_torch import profile_prep
    card = profile_prep.main(["--device", "cuda"])
    cpu = profile_prep.main(["--device", "cpu"])
    capsys.readouterr()
    assert card["combine"] == cpu["combine"]
    assert card["combine"]["locks_saved"] > 0


def test_profile_staged2_driver_on_the_card(dev, capsys, monkeypatch):
    from sherman_tpu_torch import profile_staged2
    from sherman_tpu_torch.errors import ConfigError
    for k, v in (("KEYS", "20000"), ("B", "8192"), ("DEVB", "8192"),
                 ("K", "2"), ("STEPS", "4"), ("W", "2")):
        monkeypatch.setenv(k, v)
    r = profile_staged2.main(["aligned", "--device", "cuda"])
    assert r["n_programs"] == 3 and r["timer"] == "cuda_events"
    assert set(r["modes"]) == {"aligned", "pipelined"}
    with pytest.raises(ConfigError):
        profile_staged2.main(["chained", "--device", "cuda"])
    assert '"refused"' in capsys.readouterr().out


def test_device_report_driver_on_the_card(dev, capsys, tmp_path):
    import json
    from sherman_tpu_torch import device_report
    r = device_report.main(["--device", "cuda"])
    out = capsys.readouterr()
    assert r["retraces"] == 0 and r["device"]["ledger"]["programs"] >= 3
    assert "unavailable" in out.err
    assert r["device"]["memory"]["cuda_allocated_bytes"] > 0
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"parsed": {"schema_version": 3,
                                        "device": r["device"]}}))
    assert device_report.main(["--receipt", str(p)])["retraces"] == 0


# ---------------------------------------------------------------------------
# The process-spanning transport: K4's rank layout and two ranks on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,L,c,w", [(2, 4, 3, 257), (2, 4, 128, 6),
                                      (4, 2, 5, 1), (8, 1, 16, 4),
                                      (2, 1, 7, 3), (2, 2, 1024, 257)])
def test_rank_layout_kernels_match_plain(dev, R, L, c, w):
    """K4's two launches around a cross-rank collective (the layout by
    destination rank and the placement of the received blocks) against
    their plain versions, and the ranks' outputs joined equal to the
    one-process exchange of the whole buffer."""
    N = R * L
    rng = np.random.default_rng(R * 1000 + c)
    xs = [_words(rng, (L, N * c, w)) for _ in range(R)]
    sends = []
    for x in xs:
        TK.reset_launches()
        got = TK.pack_for_ranks(x.to(dev), R)
        assert TK.LAUNCHES["exchange"] == 1
        want = TK.pack_for_ranks(x, R)
        assert torch.equal(got.cpu(), want)
        sends.append(want)
    outs = []
    for r in range(R):
        recv = torch.stack([sends[p][r] for p in range(R)])
        TK.reset_launches()
        got = TK.unpack_from_ranks(recv.to(dev), L, (L, N * c, w))
        assert TK.LAUNCHES["exchange"] == 1
        want = TK.unpack_from_ranks(recv, L, (L, N * c, w))
        assert torch.equal(got.cpu(), want)
        outs.append(want)
    whole = torch.cat(xs)
    assert torch.equal(torch.cat(outs), TK.all_to_all_ref(whole))
    assert torch.equal(TK.all_to_all(whole.to(dev)).cpu(),
                       TK.all_to_all_ref(whole))


_CARD_RANK = r'''
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import torch_mp_seqs as S
S.port_rank(args[0], pid, tmp, device="cuda")
print(f"[{pid}] SEQ-PASS", flush=True)
'''


@pytest.mark.parametrize("name", ["cluster", "engine", "staged"])
def test_two_ranks_on_the_card_match_one_cpu_process(dev, tmp_path, name):
    """Two rank processes share the card (gloo between them, the pools on
    the card): their blocks joined, answers and receipts are bit-identical
    to one port process of 4 nodes on the CPU (phase 31a's check at the
    reference workers' sizes)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mp_seqs as S
    import torch_ranks as RK
    PK.load_library()      # the ranks load this build, not a second one
    RK.run(tmp_path, _CARD_RANK, "SEQ-PASS", timeout=600, args=(name,))
    parts = [dict(np.load(tmp_path / f"{name}_r{p}.npz")) for p in range(2)]
    want = S.port_one(name, str(tmp_path), device="cpu")
    assert sorted(parts[0]) == sorted(want)
    for k, v in want.items():
        got = parts[0][k] if k.startswith("res_") else np.concatenate(
            [p[k] for p in parts])
        np.testing.assert_array_equal(got, v, err_msg=f"{name}: {k}")
