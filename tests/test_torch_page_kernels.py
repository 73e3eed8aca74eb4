"""Port parity: the page kernels' plain PyTorch versions
(``sherman_tpu_torch.ops.page_kernels.*_ref``) against the JAX package's
Pallas kernels, on the same seeded numpy inputs.

At B <= 512 the reference is the Pallas kernel itself in interpret mode,
as tests/test_pallas_page.py runs it on the CPU; at larger B it is the
``*_xla`` twin, which that file pins bit-identical to the kernel.  The
pools are garbage (uniform random words) and the addresses span every
validity class, so the int32-wrapping sums, the zeroed not-ok rows and
the multi-edge child pick are all held to the reference.  Every output
is an integer: every tolerance is exact equality.

The wrappers dispatch by device: on these CPU tensors they run the plain
version and count no launch.  ``tests/test_torch_cuda.py`` holds the
CUDA kernels against the plain versions where a card is present.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sherman_tpu.ops import pallas_page as PP
from sherman_tpu_torch import config as C
from sherman_tpu_torch.errors import KernelUnavailableError
from sherman_tpu_torch.ops import page_kernels as PK

torch.set_num_threads(1)

UPDATE_LANES = (C.L_VER_W, C.L_VHI_W, C.L_VLO_W)
INSERT_LANES = (C.L_VER_W, C.L_KHI_W, C.L_KLO_W, C.L_VHI_W, C.L_VLO_W)


def _words(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _mixed_addrs(rng, B, P):
    """In-range pages, pages past the pool, garbage words (node bits)."""
    addr = _words(rng, B)
    k = B // 3
    addr[:k] = rng.integers(0, P, k).astype(np.int32)
    addr[k:2 * k] = rng.integers(0, 2 * P, k).astype(np.int32)
    return addr


def _salted_pool(rng, P, khi, klo):
    """Garbage pool where some rows' keys sit in the leaf and internal
    blocks, so that hits, multi-hit wrapping sums and several child-pick
    edges all occur."""
    pool = _words(rng, (P, C.PAGE_WORDS))
    for i in range(min(P, khi.shape[0])):
        hits = rng.integers(0, C.LEAF_CAP, 3)
        pool[i, C.L_KHI_W + hits] = khi[i]
        pool[i, C.L_KLO_W + hits] = klo[i]
        v = rng.integers(0, 1 << 16, 3)
        pool[i, C.L_VER_W + hits] = (v << 16) | v
        ent = rng.integers(0, C.INTERNAL_CAP, 4)
        pool[i, C.I_KHI_W + ent] = khi[i]
        pool[i, C.I_KLO_W + ent] = klo[i] + rng.integers(-2, 3, 4)
    pool[:, C.W_NKEYS] = rng.integers(-4, C.INTERNAL_CAP + 4, P)
    return pool


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq_all(got, want, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


DR_NAMES = ("nxt", "is_leaf", "chase", "ok", "found", "vhi", "vlo")


def _descent_inputs(seed, B, P, salted):
    rng = np.random.default_rng(seed)
    khi, klo = _words(rng, B), _words(rng, B)
    addr = _mixed_addrs(rng, B, P)
    if salted:
        pool = _salted_pool(rng, P, khi, klo)
        # the salted rows read their own salted page
        n = min(B, P)
        addr[:n] = np.arange(n, dtype=np.int32)
    else:
        pool = _words(rng, (P, C.PAGE_WORDS))
    active = rng.integers(0, 2, B).astype(bool)
    return pool, addr, khi, klo, active


# ---------------------------------------------------------------------------
# K1: descent_round.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,B,P,stop_level,salted", [
    (0, 256, 64, 0, False),
    (1, 333, 32, 0, True),
    (2, 8, 16, 0, False),
    (3, 512, 64, 1, True),
])
def test_descent_round_ref_matches_pallas_interpret(seed, B, P, stop_level,
                                                    salted):
    pool, addr, khi, klo, active = _descent_inputs(seed, B, P, salted)
    want = PP.descent_round(jnp.asarray(pool), jnp.asarray(addr),
                            jnp.asarray(khi), jnp.asarray(klo),
                            jnp.asarray(active), stop_level=stop_level,
                            interpret=True)
    got = PK.descent_round_ref(_t(pool), _t(addr), _t(khi), _t(klo),
                               _t(active), stop_level=stop_level)
    _eq_all(got, want, DR_NAMES)
    if salted:  # the fuzz reaches the multi-hit leaf lookup
        assert np.asarray(want[4]).any()


@pytest.mark.parametrize("seed,B,P,stop_level", [
    (4, 4099, 256, 0),
    (5, 2048, 512, 1),
])
def test_descent_round_ref_matches_xla_twin(seed, B, P, stop_level):
    pool, addr, khi, klo, active = _descent_inputs(seed, B, P, True)
    want = jax.jit(lambda *a: PP.descent_round_xla(
        *a, stop_level=stop_level))(pool, addr, khi, klo, active)
    got = PK.descent_round_ref(_t(pool), _t(addr), _t(khi), _t(klo),
                               _t(active), stop_level=stop_level)
    _eq_all(got, want, DR_NAMES)


NOT_OK = (0, False, True, False, False, 0, 0)   # the search of a zero page


def _not_ok_inputs(seed, B, P, kind):
    """Garbage pool and keys; rows inactive ("inactive"), active on pages
    past the pool ("past_pool"), or each at random one of the two."""
    rng = np.random.default_rng(seed)
    pool = _words(rng, (P, C.PAGE_WORDS))
    khi, klo = _words(rng, B), _words(rng, B)
    addr = _mixed_addrs(rng, B, P)
    past = rng.integers(P, C.ADDR_PAGE_MASK + 1, B).astype(np.int32)
    past |= _words(rng, B) & ~np.int32(C.ADDR_PAGE_MASK)   # node bits
    inactive = {"inactive": np.ones(B, bool), "past_pool": np.zeros(B, bool),
                "both": rng.integers(0, 2, B).astype(bool)}[kind]
    addr = np.where(inactive, addr, past).astype(np.int32)
    return pool, addr, khi, klo, ~inactive


@pytest.mark.parametrize("kind", ["inactive", "past_pool", "both"])
@pytest.mark.parametrize("stop_level", [0, 1])
@pytest.mark.parametrize("seed,B,P,ref", [(8, 300, 32, "interpret"),
                                          (9, 2000, 64, "xla")])
def test_descent_round_ref_rows_not_ok_are_constant(seed, B, P, ref, kind,
                                                     stop_level):
    """A row that is not ok has the verdicts of a search of a zero page,
    whatever its page and key hold: the CUDA kernel writes these constants
    without searching."""
    pool, addr, khi, klo, active = _not_ok_inputs(seed + stop_level, B, P,
                                                  kind)
    if ref == "interpret":
        want = PP.descent_round(jnp.asarray(pool), jnp.asarray(addr),
                                jnp.asarray(khi), jnp.asarray(klo),
                                jnp.asarray(active), stop_level=stop_level,
                                interpret=True)
    else:
        want = jax.jit(lambda *a: PP.descent_round_xla(
            *a, stop_level=stop_level))(pool, addr, khi, klo, active)
    got = PK.descent_round_ref(_t(pool), _t(addr), _t(khi), _t(klo),
                               _t(active), stop_level=stop_level)
    _eq_all(got, want, DR_NAMES)
    for g, c, name in zip(got, NOT_OK, DR_NAMES):
        assert (g == c).all(), name


def test_descent_round_wrapper_on_cpu_is_the_plain_version():
    pool, addr, khi, klo, active = _descent_inputs(6, 300, 32, True)
    args = [_t(x) for x in (pool, addr, khi, klo, active)]
    PK.reset_launches()
    _eq_all(PK.descent_round(*args, stop_level=1),
            PK.descent_round_ref(*args, stop_level=1), DR_NAMES)
    assert PK.LAUNCHES["descent_round"] == 0


# ---------------------------------------------------------------------------
# K2: gather_pages / read_pages_local.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,M,P", [(0, 256, 32), (1, 300, 64),
                                      (2, 16, 16)])
def test_gather_pages_ref_matches_pallas_interpret(seed, M, P):
    rng = np.random.default_rng(seed)
    pool = _words(rng, (P, C.PAGE_WORDS))
    rows = _mixed_addrs(rng, M, P)
    want = PP.gather_pages(jnp.asarray(pool), jnp.asarray(rows),
                           interpret=True)
    np.testing.assert_array_equal(
        PK.gather_pages_ref(_t(pool), _t(rows)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        PK.gather_pages(_t(pool), _t(rows)).numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,M,P", [(3, 200, 32), (4, 3000, 128)])
def test_read_pages_local_matches_reference(seed, M, P):
    rng = np.random.default_rng(seed)
    pool = _words(rng, (P, C.PAGE_WORDS))
    addrs = _mixed_addrs(rng, M, P)
    active = rng.integers(0, 2, M).astype(bool)
    want_pages, want_ok = jax.jit(PP.read_pages_local)(pool, addrs, active)
    pages, ok = PK.read_pages_local(_t(pool), _t(addrs), _t(active))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(pages.numpy(), np.asarray(want_pages))
    if M > 512:
        np.testing.assert_array_equal(
            PK.gather_pages_ref(_t(pool), _t(addrs)).numpy(),
            np.asarray(jax.jit(PP.gather_pages_xla)(pool, addrs)))


# ---------------------------------------------------------------------------
# K3: writeback.
# ---------------------------------------------------------------------------

def _writeback_inputs(seed, M, P, L):
    """Applied rows carry unique (page, slot) targets: the apply path's
    contract (pallas_page.writeback)."""
    rng = np.random.default_rng(seed)
    pool = _words(rng, (P, C.PAGE_WORDS))
    page = rng.integers(0, P, M).astype(np.int32)
    slot = rng.integers(0, C.LEAF_CAP, M).astype(np.int32)
    applied = rng.integers(0, 2, M).astype(bool)
    key = page.astype(np.int64) * C.LEAF_CAP + slot
    _, first = np.unique(key, return_index=True)
    unique = np.zeros(M, bool)
    unique[first] = True
    applied &= unique
    ent = _words(rng, (M, L))
    return pool, page, slot, applied, ent


@pytest.mark.parametrize("seed,M,P,lanes", [
    (0, 256, 64, UPDATE_LANES),
    (1, 300, 32, INSERT_LANES),
    (2, 64, 16, (C.L_VER_W,)),
])
def test_writeback_ref_matches_pallas_interpret(seed, M, P, lanes):
    pool, page, slot, applied, ent = _writeback_inputs(seed, M, P,
                                                       len(lanes))
    want = np.asarray(PP.writeback(
        jnp.asarray(pool), jnp.asarray(page), jnp.asarray(slot),
        jnp.asarray(applied), jnp.asarray(ent), field_w=lanes,
        interpret=True))
    tp = _t(pool.copy())
    out = PK.writeback_ref(tp, _t(page), _t(slot), _t(applied), _t(ent),
                           lanes)
    assert out is tp                      # in place, like the aliased kernel
    np.testing.assert_array_equal(out.numpy(), want)
    assert applied.any() and not np.array_equal(want, pool)


@pytest.mark.parametrize("seed,M,P,lanes", [
    (3, 1024, 128, INSERT_LANES),
    (4, 4000, 512, UPDATE_LANES),
])
def test_writeback_ref_matches_xla_twin(seed, M, P, lanes):
    pool, page, slot, applied, ent = _writeback_inputs(seed, M, P,
                                                       len(lanes))
    want = np.asarray(jax.jit(lambda *a: PP.writeback_xla(
        *a, field_w=lanes))(pool, page, slot, applied, ent))
    PK.reset_launches()
    got = PK.writeback(_t(pool.copy()), _t(page), _t(slot), _t(applied),
                       _t(ent), lanes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert PK.LAUNCHES["writeback"] == 0


WB_MASKS = ("none", "all", "sparse", "group_first", "group_last")


def wb_mask(kind, M, rng):
    """Write-back mask classes: empty, full, ~3% set, and set only on the
    first or the last row of each 16-row group (the edges of a grouped
    pass over the mask)."""
    r = np.arange(M)
    return {"none": np.zeros(M, bool), "all": np.ones(M, bool),
            "sparse": rng.random(M) < 0.03,
            "group_first": r % 16 == 0, "group_last": r % 16 == 15}[kind]


@pytest.mark.parametrize("kind", WB_MASKS)
@pytest.mark.parametrize("M", [1, 15, 16, 17, 1000])
def test_writeback_ref_mask_classes(M, kind):
    """Every row carries its own (page, slot) target, so any mask keeps
    the write-back contract."""
    P = 32
    rng = np.random.default_rng(M * 7 + WB_MASKS.index(kind))
    lanes = INSERT_LANES if M % 2 else UPDATE_LANES
    pool = _words(rng, (P, C.PAGE_WORDS))
    tgt = rng.permutation(P * C.LEAF_CAP)[:M]
    page = (tgt // C.LEAF_CAP).astype(np.int32)
    slot = (tgt % C.LEAF_CAP).astype(np.int32)
    applied = wb_mask(kind, M, rng)
    ent = _words(rng, (M, len(lanes)))
    got = PK.writeback_ref(_t(pool.copy()), _t(page), _t(slot), _t(applied),
                           _t(ent), lanes).numpy()
    args = (pool, page, slot, applied, ent)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(
        lambda *a: PP.writeback_xla(*a, field_w=lanes))(*args)))
    if M <= 17:
        np.testing.assert_array_equal(got, np.asarray(PP.writeback(
            *map(jnp.asarray, args), field_w=lanes, interpret=True)))
    assert (got != pool).any(axis=1).sum() <= applied.sum()
    assert applied.any() == (not np.array_equal(got, pool))


# ---------------------------------------------------------------------------
# Build and launch failures are typed and name their cause.
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_library(monkeypatch):
    """Forget any built library for the duration of the test."""
    monkeypatch.setattr(PK, "_lib", None)


def test_build_failure_raises_kernel_unavailable(monkeypatch,
                                                 fresh_library):
    def no_nvcc():
        raise RuntimeError("Error building extension: nvcc: not found")

    monkeypatch.setattr(PK, "_build", no_nvcc)
    with pytest.raises(KernelUnavailableError) as ei:
        PK.load_library("gather_pages")
    assert ei.value.kernel == "gather_pages"
    assert "nvcc: not found" in ei.value.cause
    assert "page_kernels.cu" in ei.value.cause
    assert isinstance(ei.value, RuntimeError)


def test_cuda_path_never_falls_back_to_plain(monkeypatch, fresh_library):
    """A tensor that takes the CUDA path reaches the loader; a build
    failure there raises and counts no launch."""
    def no_extension():
        raise OSError("libsherman_page_kernels.so: cannot open shared "
                      "object file")

    monkeypatch.setattr(PK, "_build", no_extension)
    monkeypatch.setattr(PK, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(PK, "_dev_index", lambda dev: 0)
    pool, addr, khi, klo, active = _descent_inputs(7, 16, 16, False)
    PK.reset_launches()
    with pytest.raises(KernelUnavailableError, match="cannot open shared"):
        PK.descent_round(*[_t(x) for x in (pool, addr, khi, klo, active)])
    assert PK.LAUNCHES["descent_round"] == 0


def test_launch_failure_raises_kernel_unavailable(monkeypatch):
    """A launch the runtime refuses comes back as a nonzero return with
    the CUDA error text, which the wrapper raises."""
    class FakeLib:
        @staticmethod
        def sherman_gather_pages(*args):
            err = args[-2]
            ctypes.memmove(err, b"CUDA error: invalid configuration "
                                b"argument\x00", 43)
            return 1

    monkeypatch.setattr(PK, "load_library", lambda kernel="": FakeLib)
    PK.reset_launches()
    with pytest.raises(KernelUnavailableError,
                       match="launch failed: CUDA error: invalid config"):
        PK._call("gather_pages", "sherman_gather_pages", 0, None)
    assert PK.LAUNCHES["gather_pages"] == 0
