"""Port parity: ``sherman_tpu_torch.ops.bits``/``layout`` against the JAX
package's ``ops.bits``/``layout`` on the same seeded numpy inputs.

Random words cover the sign bit (keys and addresses above 2^31 are
negative int32 patterns, where torch's arithmetic shift differs from the
reference's logical uint32 shift), and garbage pages make several slots
match so the int32-wrapping sums are exercised.  Every output is an
integer: every tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherman_tpu import config as JC
from sherman_tpu.ops import bits as JB
from sherman_tpu.ops import layout as JL
from sherman_tpu_torch import config as C
from sherman_tpu_torch.ops import bits as TB
from sherman_tpu_torch.ops import layout as TL

torch.set_num_threads(1)

SEEDS = [0, 1, 2]


def _words(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _eq(t, j, what=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=what)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _garbage_pages(rng, n, khi, klo):
    """Garbage pages whose entry keys, versions and counts are salted so
    that compares, liveness and hits all take both values."""
    pg = _words(rng, (n, C.PAGE_WORDS))
    for i in range(n):
        hits = rng.integers(0, C.LEAF_CAP, 3)
        pg[i, C.L_KHI_W + hits] = khi[i]
        pg[i, C.L_KLO_W + hits] = klo[i]
        v = rng.integers(0, 1 << 16, 3)
        pg[i, C.L_VER_W + hits] = (v << 16) | v    # live where v != 0
        ent = rng.integers(0, C.INTERNAL_CAP, 4)
        pg[i, C.I_KHI_W + ent] = khi[i]
        pg[i, C.I_KLO_W + ent] = klo[i] + rng.integers(-2, 3, 4)
    pg[:, C.W_NKEYS] = rng.integers(-4, C.INTERNAL_CAP + 4, n)
    pg[::3, C.W_REAR_VER] = pg[::3, C.W_FRONT_VER]
    return pg


def test_layout_constants_match():
    for name in ("PAGE_WORDS", "ADDR_PAGE_BITS", "ADDR_PAGE_MASK",
                 "META_ROOT_ADDR_W", "W_FRONT_VER", "W_LEFTMOST",
                 "W_SIBLING", "W_LEVEL", "W_NKEYS", "W_LOW_HI", "W_LOW_LO",
                 "W_HIGH_HI", "W_HIGH_LO", "W_ENTRIES", "W_REAR_VER",
                 "INTERNAL_CAP", "LEAF_CAP", "I_KHI_W", "I_KLO_W",
                 "I_PTR_W", "L_VER_W", "L_KHI_W", "L_KLO_W", "L_VHI_W",
                 "L_VLO_W", "ENTRY_VER_MASK", "KEY_MIN", "KEY_MAX",
                 "KEY_POS_INF", "LEAF_ENTRY_WORDS", "KEY_NEG_INF",
                 "PAGE_BYTES", "ADDR_NODE_BITS"):
        assert getattr(C, name) == getattr(JC, name), name


@pytest.mark.parametrize("seed", SEEDS)
def test_key_pairs_roundtrip(seed):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, 2**64, 500, dtype=np.uint64)
    ks[:3] = [0, 2**63, 2**64 - 1]
    th, tl = TB.keys_to_pairs(ks)
    jh, jl = JB.keys_to_pairs(ks)
    _eq(th, jh)
    _eq(tl, jl)
    _eq(TB.pairs_to_keys(th, tl), ks)
    for k in ks[:20]:
        assert TB.key_to_pair(int(k)) == JB.key_to_pair(int(k))
        assert TB.pair_to_key(*TB.key_to_pair(int(k))) == int(k)


@pytest.mark.parametrize("seed", SEEDS)
def test_unsigned_compares(seed):
    rng = np.random.default_rng(seed)
    n = 2000
    ahi, alo, bhi, blo = (_words(rng, n) for _ in range(4))
    bhi[: n // 2] = ahi[: n // 2]              # force the low-word branch
    blo[: n // 8] = alo[: n // 8]              # and equal keys
    ahi[-4:] = [-2**31, 2**31 - 1, 0, -1]
    tj = [_t(x) for x in (ahi, alo, bhi, blo)]
    jj = [jnp.asarray(x) for x in (ahi, alo, bhi, blo)]
    _eq(TB._ux(tj[0]), JB._ux(jj[0]))
    for fn in ("key_lt", "key_le", "key_eq"):
        _eq(getattr(TB, fn)(*tj), getattr(JB, fn)(*jj), fn)
    _eq(TB.u32_lt(tj[0], tj[2]), JB.u32_lt(jj[0], jj[2]))
    _eq(TB.u32_le(tj[0], tj[2]), JB.u32_le(jj[0], jj[2]))


@pytest.mark.parametrize("seed", SEEDS)
def test_addresses_and_lock_hash(seed):
    rng = np.random.default_rng(seed)
    a = _words(rng, 3000)
    a[:4] = [-2**31, -1, 0, (255 << 24) - 2**32 + 5]
    node = rng.integers(0, 256, 3000).astype(np.int32)
    page = _words(rng, 3000)
    _eq(TB.addr_node(_t(a)), JB.addr_node(jnp.asarray(a)), "addr_node")
    _eq(TB.addr_page(_t(a)), JB.addr_page(jnp.asarray(a)), "addr_page")
    _eq(TB.make_addr(_t(node), _t(page)),
        JB.make_addr(jnp.asarray(node), jnp.asarray(page)), "make_addr")
    _eq(TB.hash32(_t(a)), np.asarray(JB.hash32(jnp.asarray(a)))
        .astype(np.int64), "hash32")
    for L in (64, 1000, 16384):
        _eq(TB.lock_index(_t(a), L), JB.lock_index(jnp.asarray(a), L),
            f"lock_index {L}")
    for x, n_, p_ in zip(a[:50], node[:50], page[:50]):
        assert TB.addr_node(int(x)) == JB.addr_node(int(x))
        assert TB.addr_page(int(x)) == JB.addr_page(int(x))
        assert TB.make_addr(int(n_), int(p_)) == JB.make_addr(int(n_), int(p_))
        assert TB.hash32_host(int(x)) == JB.hash32_host(int(x))
        assert TB.lock_index_host(int(x), 977) == JB.lock_index_host(
            int(x), 977)
    assert TB.lease_word(7, 3) == JB.lease_word(7, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_mix64(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    _eq(TB.mix64_np(x), JB.mix64_np(x))
    for v in [0, 1, 2**64 - 1, 2**63, *x[:50].tolist()]:
        assert TB.mix64_host(v) == JB.mix64_host(v) == int(TB.mix64_np(v))


@pytest.mark.parametrize("seed", SEEDS)
def test_leaf_entries_batch_on_garbage_pages(seed):
    """The scan's vectorized extraction: keys, values and liveness of every
    slot, garbage version words included (fver == rver != 0 is live)."""
    rng = np.random.default_rng(seed)
    n = 200
    khi, klo = _words(rng, n), _words(rng, n)
    pg = _garbage_pages(rng, n, khi, klo)
    got, want = TL.np_leaf_entries_batch(pg), JL.np_leaf_entries_batch(pg)
    for x, y, name in zip(got, want, ("keys", "vals", "live")):
        assert x.dtype == y.dtype, name
        _eq(x, y, name)
    live = got[2]
    assert 0 < int(live.sum()) < live.size
    # the per-page host scan agrees slot by slot
    for i in range(0, n, 17):
        ents = TL.np_leaf_entries(pg[i])
        assert [s for _, _, s in ents] == np.nonzero(live[i])[0].tolist()
        assert [(k, v) for k, v, _ in ents] == \
            list(zip(got[0][i][live[i]].tolist(), got[1][i][live[i]].tolist()))


@pytest.mark.parametrize("seed", SEEDS)
def test_page_search_on_garbage_pages(seed):
    rng = np.random.default_rng(seed)
    n = 300
    khi, klo = _words(rng, n), _words(rng, n)
    pg = _garbage_pages(rng, n, khi, klo)
    tp, jp = _t(pg), jnp.asarray(pg)
    tk, jk = (_t(khi), _t(klo)), (jnp.asarray(khi), jnp.asarray(klo))
    for fn in ("h_front_ver", "h_rear_ver", "h_leftmost", "h_sibling",
               "h_level", "h_nkeys", "page_consistent", "leaf_slot_used"):
        _eq(getattr(TL, fn)(tp), getattr(JL, fn)(jp), fn)
    for fn in ("h_lowest", "h_highest"):
        for x, y in zip(getattr(TL, fn)(tp), getattr(JL, fn)(jp)):
            _eq(x, y, fn)
    for fn in ("internal_pick_child", "in_fence", "needs_sibling_chase"):
        _eq(getattr(TL, fn)(tp, *tk), getattr(JL, fn)(jp, *jk), fn)
    for x, y, name in zip(TL.leaf_find_key(tp, *tk),
                          JL.leaf_find_key(jp, *jk),
                          ("found", "vhi", "vlo", "slot")):
        _eq(x, y, "leaf_find_key " + name)
    # several live hits per page: the value sums must wrap identically
    assert int(TL.leaf_slot_used(tp).sum()) > n


@pytest.mark.parametrize("seed", SEEDS)
def test_versions(seed):
    rng = np.random.default_rng(seed)
    v = _words(rng, 1000)
    for x, y in zip(TL.ver_unpack(_t(v)), JL.ver_unpack(jnp.asarray(v))):
        _eq(x, y)
    x = rng.integers(0, 1 << 16, 1000).astype(np.int32)
    _eq(TL.ver_pack(_t(x)), JL.ver_pack(jnp.asarray(x)))
    for s in x[:20]:
        assert TL.ver_pack_np(int(s)) == JL.ver_pack_np(int(s))


def test_numpy_page_builders():
    pg_t = TL.np_empty_page(2, 17, 2**64 - 5, sibling=9, leftmost=4,
                            version=3)
    pg_j = JL.np_empty_page(2, 17, 2**64 - 5, sibling=9, leftmost=4,
                            version=3)
    _eq(pg_t, pg_j)
    for slot, key, val, ver in ((0, 5, 2**63 + 1, 1), (48, 2**64 - 2, 7,
                                                       65535)):
        TL.np_leaf_set_entry(pg_t, slot, key, val, ver)
        JL.np_leaf_set_entry(pg_j, slot, key, val, ver)
    TL.np_internal_set_entry(pg_t, 3, 2**40, -17)
    JL.np_internal_set_entry(pg_j, 3, 2**40, -17)
    _eq(pg_t, pg_j)
    assert TL.np_leaf_entries(pg_t) == JL.np_leaf_entries(pg_j)
    assert TL.np_lowest(pg_t) == JL.np_lowest(pg_j)
    assert TL.np_highest(pg_t) == JL.np_highest(pg_j)
    assert TL.leaf_slot_words(5) == JL.leaf_slot_words(5)
