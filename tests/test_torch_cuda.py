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
the multi-node serving path.  Every comparison is exact equality.
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
