"""Port parity: the device-staged serving loops of ``sherman_tpu_torch``
(``workload/threefry.py``, ``workload/device_prep.py`` and the engine
pieces they call) against the JAX package on the CPU.

The same seeded inputs go through both packages: Threefry against
``jax.random`` itself, the uint64 word arithmetic, the zipf samplers,
request combining and the router probe, then the staged read loop
(``aligned``, ``pipelined``) and the staged mixed loop (``chained``,
``pipelined``) at 1 node and at 8 nodes (the JAX side on 8 virtual CPU
devices), and the update-only leaf apply.  Every tolerance is exact
equality except the analytic sampler's tail, whose f32 ``exp``/``log``
are not correctly rounded: its head ranks (< 64) are exact, and a tail
rank ``r`` may differ by at most ``1 + 5e-4 * r`` (measured at most
``1 + 3.7e-4 * r`` up to 10^8 keys), in fewer than half the draws.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.workload import device_prep as JP
from sherman_tpu_torch import config as C
from sherman_tpu_torch import state
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import transport_kernel as TK
from sherman_tpu_torch.workload import device_prep as TP
from sherman_tpu_torch.workload import threefry as TF

torch.set_num_threads(1)

SALT = 0x5E17_AB1E_5A17
CX = 0xDEADBEEF
N_KEYS = 4000
U64 = (1 << 64) - 1


def _jnp():
    import jax.numpy as jnp
    return jnp


def _words_of(x64):
    """uint64 numpy -> (hi, lo) uint32 numpy."""
    return ((x64 >> np.uint64(32)).astype(np.uint32),
            (x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _t(a):
    """uint32 numpy -> the port's int64 word tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _n(x):
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# Threefry and the uint64 word arithmetic.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1, 2**32 - 1, 2**32,
                                  2**40 + 5, 2**63 - 1, 123456789012])
def test_threefry_matches_jax_random(seed):
    import jax
    jk = jax.random.PRNGKey(seed)
    tk = TF.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _n(jk))
    for data in (0, 1, 7, 2**31, 2**32 - 2, 2**32 - 1):
        np.testing.assert_array_equal(
            TF.fold_in(tk, data).numpy(),
            _n(jax.random.fold_in(jk, np.uint32(data))))
    for n in (1, 2, 7, 64, 1001):
        k = jax.random.fold_in(jk, 5)
        np.testing.assert_array_equal(
            TF.bits(TF.fold_in(tk, 5), (2, n)).numpy(),
            _n(jax.random.bits(k, (2, n), dtype=_jnp().uint32)))
    # one fold per node, all streams in one pass
    nodes = torch.arange(8)
    got = TF.bits(TF.fold_in(tk, (nodes + 2**32 - 4) & TF.MASK), (2, 33))
    for i in range(8):
        k = jax.random.fold_in(jk, np.uint32((i + 2**32 - 4) % 2**32))
        np.testing.assert_array_equal(
            got[i].numpy(), _n(jax.random.bits(k, (2, 33),
                                               dtype=_jnp().uint32)))


def test_u64_word_arithmetic_matches():
    jnp = _jnp()
    rng = np.random.default_rng(3)
    a = rng.integers(0, U64, 4096, dtype=np.uint64)
    b = rng.integers(0, U64, 4096, dtype=np.uint64)
    a[:4] = [0, U64, 1 << 63, (1 << 32) - 1]
    b[:4] = [U64, U64, 1 << 63, (1 << 32) + 1]
    ahi, alo = _words_of(a)
    bhi, blo = _words_of(b)
    J = lambda x: jnp.asarray(x)
    for got, want in (
            (bits.u32_mul_full(_t(alo), _t(blo)),
             JBITS.u32_mul_full(J(alo), J(blo))),
            (bits.u64_mul(_t(ahi), _t(alo), _t(bhi), _t(blo)),
             JBITS.u64_mul(J(ahi), J(alo), J(bhi), J(blo))),
            (bits.mix64_pair(_t(ahi), _t(alo)),
             JBITS.mix64_pair(J(ahi), J(alo)))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _n(w))
    for s in (0, 1, 5, 31, 32, 33, 40, 63):
        for g, w in zip(bits.u64_shr(_t(ahi), _t(alo), s),
                        JBITS.u64_shr(J(ahi), J(alo), s)):
            np.testing.assert_array_equal(g.numpy(), _n(w))
    s = rng.integers(0, 64, 4096).astype(np.uint32)
    s[:8] = [0, 31, 32, 63, 1, 33, 0, 63]
    for g, w in zip(bits.u64_shr_dyn(_t(ahi), _t(alo), _t(s)),
                    JBITS.u64_shr_dyn(J(ahi), J(alo), J(s))):
        np.testing.assert_array_equal(g.numpy(), _n(w))
    np.testing.assert_array_equal(
        bits.u32(bits.i32(_t(alo))).numpy(), _n(alo))


# ---------------------------------------------------------------------------
# Samplers, combining, the router probe.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,theta,lb", [(20_000, 0.99, 16), (1000, 0.0, 12),
                                        (5_000_000, 0.99, 20), (77, 0.5, 8)])
def test_zipf_tables_match(n, theta, lb):
    np.testing.assert_array_equal(TP.zipf_table(n, theta, lb),
                                  JP.zipf_table(n, theta, lb))
    if 0 < theta and n > 64:
        a, b = TP.zipf_analytic_consts(n, theta), \
            JP.zipf_analytic_consts(n, theta)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _draws(seed, n):
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(2, n),
                                             dtype=np.uint64)
    return w.astype(np.uint32)


def test_gen_ranks_table_is_exact():
    import jax
    n, lb = 20_000, 16
    t = JP.zipf_table(n, 0.99, lb)
    tp = np.stack([t[:-1], t[1:]], axis=1)
    w = _draws(1, 200_000)
    want = jax.jit(lambda tp, w: JP._gen_ranks(tp, w, log2_bins=lb,
                                               n_keys=n))(tp, w)
    got = TP._gen_ranks(torch.from_numpy(tp), _t(w), log2_bins=lb,
                        n_keys=n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [20_000, 1_000_000])
def test_gen_ranks_analytic_head_exact_tail_within_tolerance(n):
    import jax
    zc = JP.zipf_analytic_consts(n, 0.99)
    w = _draws(2, 400_000)
    want = np.asarray(jax.jit(lambda w: JP._gen_ranks_analytic(
        zc, w, n_keys=n))(w)).astype(np.int64)
    got = TP._gen_ranks_analytic(TP.zipf_analytic_consts(n, 0.99), _t(w),
                                 n_keys=n).numpy().astype(np.int64)
    head = (want < 64) | (got < 64)
    np.testing.assert_array_equal(got[head], want[head])
    d = np.abs(got - want)
    assert (d <= 1 + 5e-4 * np.maximum(got, want)).all(), d.max()
    assert d.astype(bool).mean() < 0.5


def test_gen_ranks_analytic_matches_exact_cdf():
    from sherman_tpu.workload.zipf import _zeta
    n, theta = 100_000, 0.99
    r = TP._gen_ranks_analytic(TP.zipf_analytic_consts(n, theta),
                               _t(_draws(11, 1_000_000)),
                               n_keys=n).numpy()
    assert r.min() >= 0 and r.max() < n
    zetan = _zeta(n, theta)
    for rank in (0, 1, 2, 10, 63):
        p_true = (rank + 1.0) ** -theta / zetan
        assert abs((r == rank).mean() - p_true) < 0.15 * p_true + 1e-5
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -theta) / zetan
    for q in (0.5, 0.9, 0.99):
        true = int(np.searchsorted(cdf, q))
        assert abs(np.quantile(r, q) - true) <= max(0.05 * (true + 1), 2.0)
    t_band = cdf[71] - cdf[55]
    assert abs(((r >= 56) & (r < 72)).mean() - t_band) < 0.1 * t_band + 1e-5


def _keys_with_dups(seed, n):
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, U64, n // 3, dtype=np.uint64)
    ks[:4] = [U64 - 1, 1 << 63, (1 << 63) - 1, 1]       # sign bits of hi
    ks[4] = (1 << 32) - 1 | (0x80000000 << 32)
    return ks[rng.integers(0, ks.size, n)]


@pytest.mark.parametrize("cap", [257, 1024])
def test_sort_combine_matches_with_padding(cap):
    import jax
    k = _keys_with_dups(4, 1024)
    hi, lo = _words_of(k)
    want = jax.jit(lambda a, b: JP._sort_combine(a, b, cap))(hi, lo)
    got = TP._sort_combine(_t(hi), _t(lo), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _n(w))
    assert got[4].dtype == torch.int32 and got[5].dtype == torch.int32
    # node-major rows: each combines on its own
    k8 = np.stack([_keys_with_dups(s, 512) for s in range(8)])
    hi8, lo8 = _words_of(k8)
    got8 = TP._sort_combine(_t(hi8), _t(lo8), 200)
    for i in range(8):
        want_i = JP._sort_combine(hi8[i], lo8[i], 200)
        for g, w in zip(got8, want_i):
            np.testing.assert_array_equal(g[i].numpy(), _n(w))


@pytest.mark.parametrize("shift,lb", [(40, 10), (0, 12), (31, 16), (33, 8),
                                      (64 - 12, 12)])
def test_router_probe_matches(shift, lb):
    rng = np.random.default_rng(shift)
    k = _keys_with_dups(5, 3000)
    k[:3] = [0x80000000, (1 << 32) + 0x80000000, 0xFFFFFFFF]  # lo top bit
    hi, lo = _words_of(k)
    table = rng.integers(-2**31, 2**31, 1 << lb, dtype=np.int64
                         ).astype(np.int32)
    want = JP._router_probe(table, hi, lo, shift, 1 << lb)
    got = TP._router_probe(torch.from_numpy(table), _t(hi), _t(lo), shift,
                           1 << lb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The staged loops against the JAX package.
# ---------------------------------------------------------------------------

def _kw(n):
    return dict(machine_nr=n, pages_per_node=2048, locks_per_node=512,
                step_capacity=_batch(n), chunk_pages=32)


def _batch(n):
    return 2048 if n == 1 else 512


def _pair(n, n_keys=N_KEYS):
    """Both packages' engines over the same bulk-loaded tree, routers
    attached.  -> (jax engine, port engine)."""
    ranks = np.arange(n_keys, dtype=np.uint64)
    keys = bits.mix64_np(ranks ^ np.uint64(SALT))
    vals = keys ^ np.uint64(CX)
    order = np.argsort(keys)
    jt = JTree(JCluster(JDSMConfig(**_kw(n))))
    je = JB.BatchedEngine(jt, batch_per_node=_batch(n))
    JB.bulk_load(jt, keys[order], vals[order], fill=0.8)
    je.attach_router()
    pt = Tree(Cluster(DSMConfig(device="cpu", **_kw(n))))
    pe = TB.BatchedEngine(pt, batch_per_node=_batch(n))
    TB.bulk_load(pt, keys[order], vals[order], fill=0.8)
    pe.attach_router()
    _same_state(je, pe, "bulk load")
    return je, pe


def _same_state(je, pe, what):
    jd, td = je.dsm, pe.dsm
    np.testing.assert_array_equal(td.pool.numpy(), np.asarray(jd.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(td.locks.numpy(), np.asarray(jd.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(td.counters_np(), np.asarray(jd.counters),
                                  err_msg=what + " counters")


@pytest.fixture(scope="module", params=[1, 8], ids=["1node", "8nodes"])
def engines(request, eight_devices):
    return _pair(request.param)


def _run_read(eng, mod, fusion, S, sampler="table", **kw):
    """S staged read steps, drained -> the carry as ints."""
    n = eng.cfg.machine_nr
    step, (new_carry, tb, rt, rk) = mod.make_staged_step(
        eng, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=_batch(n),
        dev_b=_batch(n), log2_bins=16, fusion=fusion, sampler=sampler, **kw)
    carry = new_carry()
    counters = eng.dsm.counters
    for _ in range(S):
        counters, carry = step(eng.dsm.pool, counters, tb, rt, rk, carry)
    carry = step.drain(carry)
    eng.dsm.counters = counters
    return step, tuple(int(np.asarray(x)) for x in carry)


@pytest.mark.parametrize("fusion", ["aligned", "pipelined"])
def test_staged_step_matches_jax(engines, fusion):
    je, pe = engines
    n = pe.cfg.machine_nr
    _, want = _run_read(je, JP, fusion, 3)
    step, got = _run_read(pe, TP, fusion, 3)
    assert got == want
    assert got[:3] == (3, 1, 3 * _batch(n) * n)
    _same_state(je, pe, f"staged {fusion}")
    # the staged serve is the engine's host-staged serve
    assert step.jserve is pe._get_search_fanout(pe._iters())
    assert list(step.programs) == ["prep", "serve_fanout", "verify"]
    assert step.pipeline_depth == (2 if fusion == "pipelined" else 1)


def test_staged_analytic_receipts_match_jax(eight_devices):
    """The analytic sampler's tail may draw other ranks than the
    reference's (see the module docstring), but every answer is still
    verified: the receipts agree."""
    for n in (1, 8):
        je, pe = _pair(n)
        _, want = _run_read(je, JP, "aligned", 2, sampler="analytic")
        step, got = _run_read(pe, TP, "aligned", 2, sampler="analytic")
        assert step.sampler == "analytic"
        assert got[:3] == want[:3] == (2, 1, 2 * _batch(n) * n)


def _run_mixed(eng, mod, fusion, S):
    n = eng.cfg.machine_nr
    B = _batch(n)
    step, (new_carry, tb, rt, rk) = mod.make_staged_mixed_step(
        eng, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=B,
        read_ratio=0.5, dev_rb=B // 2, dev_wb=B // 2, log2_bins=16,
        fusion=fusion)
    carry = new_carry()
    dsm = eng.dsm
    pool, counters = dsm.pool, dsm.counters
    for _ in range(S):
        pool, counters, carry = step(pool, dsm.locks, counters, tb, rt, rk,
                                     carry)
    carry = step.drain(carry)
    dsm.pool, dsm.counters = pool, counters
    return step, tuple(int(np.asarray(x)) for x in carry)


@pytest.mark.parametrize("fusion", ["chained", "pipelined"])
def test_staged_mixed_matches_jax(fusion, eight_devices):
    for n in (1, 8):
        je, pe = _pair(n)
        _, want = _run_mixed(je, JP, fusion, 3)
        step, got = _run_mixed(pe, TP, fusion, 3)
        assert got == want, n
        B = _batch(n)
        assert got[:4] == (3, 1, 3 * B // 2 * n, 3 * B // 2 * n)
        assert got[7] == 3
        _same_state(je, pe, f"staged mixed {fusion} N={n}")


def _run_capped(eng, mod, kind, fusion, caps, S=2):
    """S staged steps with the given row caps, drained -> the carry."""
    n = eng.cfg.machine_nr
    B = _batch(n)
    if kind == "read":
        step, (new_carry, tb, rt, rk) = mod.make_staged_step(
            eng, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=B,
            dev_b=caps[0], log2_bins=16, fusion=fusion)
    else:
        step, (new_carry, tb, rt, rk) = mod.make_staged_mixed_step(
            eng, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=B,
            read_ratio=0.5, dev_rb=caps[0], dev_wb=caps[1], log2_bins=16,
            fusion=fusion)
    carry = new_carry()
    dsm = eng.dsm
    pool, counters = dsm.pool, dsm.counters
    for _ in range(S):
        if kind == "read":
            counters, carry = step(pool, counters, tb, rt, rk, carry)
        else:
            pool, counters, carry = step(pool, dsm.locks, counters, tb, rt,
                                         rk, carry)
    carry = step.drain(carry)
    dsm.pool, dsm.counters = pool, counters
    return tuple(int(np.asarray(x)) for x in carry)


@pytest.mark.parametrize("n", [1, 8])
def test_staged_cap_overflow_voids_like_jax(eight_devices, n):
    """Unique-row caps far below a step's unique counts: the read loop's
    ``dev_b`` and the mixed loop's ``dev_rb`` and ``dev_wb`` (each alone)
    overflow, every run is voided through ``ok = 0``, and every
    carry (the counts of the rows that were served too) and the state
    after it equal the JAX package's."""
    je, pe = _pair(n)
    B = _batch(n)
    runs = [("read", f, (B // 8,)) for f in ("aligned", "pipelined")]
    runs += [("mixed", "chained", (B // 16, B // 2)),
             ("mixed", "pipelined", (B // 2, B // 16))]
    for kind, fusion, caps in runs:
        want = _run_capped(je, JP, kind, fusion, caps)
        got = _run_capped(pe, TP, kind, fusion, caps)
        assert got == want, (kind, fusion, caps)
        assert got[1] == 0, (kind, fusion, caps)
        _same_state(je, pe, f"{kind} {fusion} {caps}")


def test_staged_pipelined_receipts_lag_then_drain():
    _, pe = _pair(1)
    B = _batch(1)
    step, (new_carry, tb, rt, rk) = TP.make_staged_step(
        pe, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=B, dev_b=B,
        log2_bins=16, fusion="pipelined")
    counters = pe.dsm.counters
    carry = new_carry()
    for k in range(3):
        counters, carry = step(pe.dsm.pool, counters, tb, rt, rk, carry)
        assert int(carry[2]) == k * B           # lags one batch
    carry = new_carry()                         # undrained: reset the slot
    for _ in range(2):
        counters, carry = step(pe.dsm.pool, counters, tb, rt, rk, carry)
    carry = step.drain(step.drain(carry))       # idempotent
    assert int(carry[2]) == 2 * B
    phases, _ = step.phase_profile(pe.dsm.pool, counters, tb, rt, rk,
                                   reps=1)
    assert set(phases) == {"prep", "serve_fanout", "verify", "wall_ms",
                           "bubble_ms", "overlap_efficiency"}
    assert phases["bubble_ms"] >= 0 and phases["overlap_efficiency"] <= 1


def test_staged_knobs_and_refusals(monkeypatch):
    _, pe = _pair(1, n_keys=500)
    kw = dict(n_keys=500, theta=0.99, salt=SALT, batch=256, dev_b=256,
              log2_bins=12)
    assert C.staged_fusion() == "aligned"
    for v in ("chained", "fused"):
        monkeypatch.setenv("SHERMAN_STAGED_FUSION", v)
        with pytest.raises(ConfigError, match="XLA program-structure"):
            C.staged_fusion()
        with pytest.raises(ConfigError, match="XLA program-structure"):
            TP.make_staged_step(pe, **kw)
    monkeypatch.setenv("SHERMAN_STAGED_FUSION", "pipelined")
    assert TP.make_staged_step(pe, **kw)[0].fusion == "pipelined"
    monkeypatch.setenv("SHERMAN_STAGED_FUSION", "bogus")
    with pytest.raises(ConfigError):
        C.staged_fusion()
    monkeypatch.delenv("SHERMAN_STAGED_FUSION")
    lc = pe.attach_leaf_cache(slots=256)
    step, _ = TP.make_staged_step(pe, leaf_cache=lc, **kw)
    assert step.cache and step.dev_b_resid == 256
    with pytest.raises(ConfigError):
        TP.make_staged_step(pe, leaf_cache=lc, fusion="chained", **kw)
    pe.detach_leaf_cache()
    with pytest.raises(ConfigError):
        TP.make_staged_step(pe, fusion="fused", **kw)
    with pytest.raises(ConfigError):
        TP.make_staged_mixed_step(pe, n_keys=500, theta=0.99, salt=SALT,
                                  batch=256, read_ratio=1.0, dev_rb=128,
                                  dev_wb=128)
    step, _ = TP.make_staged_step(pe, sampler="analytic", **kw)
    assert step.sampler == "analytic"
    step, _ = TP.make_staged_step(pe, sampler="analytic",
                                  **{**kw, "theta": 0.0})
    assert step.sampler == "table"              # analytic needs 0 < theta


def test_staged_paths_launch_no_kernel_on_cpu():
    _, pe = _pair(1, n_keys=1000)
    PK.reset_launches()
    TK.reset_launches()
    _run_read(pe, TP, "aligned", 1)
    _run_mixed(pe, TP, "pipelined", 1)
    assert PK.LAUNCHES == {"descent_round": 0, "gather_pages": 0,
                           "writeback": 0}
    assert TK.LAUNCHES == {"exchange": 0}


# ---------------------------------------------------------------------------
# The update-only apply, and a tree carried across with its router.
# ---------------------------------------------------------------------------

def test_update_only_apply_statuses_match(eight_devices):
    """Absent keys escalate (ST_FULL), same-key duplicates supersede, and
    on 8 nodes a key written from two nodes has one winner; statuses,
    pools and counters against the reference's update-only mixed step."""
    for n in (1, 8):
        je, pe = _pair(n, n_keys=3000)
        B = _batch(n)
        rng = np.random.default_rng(n)
        keys = bits.mix64_np(np.arange(3000, dtype=np.uint64)
                             ^ np.uint64(SALT))
        q = keys[rng.integers(0, 3000, n * B)]
        q[5:9] = q[4]                            # same-key run
        q[20:40] = rng.integers(1, U64, 20, dtype=np.uint64)   # absent
        if n > 1:
            q[B + 3] = q[4]                      # the same key, other node
        is_read = rng.random(n * B) < 0.3
        is_read[4:9] = False
        is_read[20:40] = False
        if n > 1:
            is_read[B + 3] = False
        v = q ^ np.uint64(0x1234567)
        khi, klo = bits.keys_to_pairs(q)
        vhi, vlo = bits.keys_to_pairs(v)
        start = je.router.host_start(khi, klo)
        fn = je._get_mixed(je._iters(), True, None, True)
        sh = je._shard
        (jpool, jcnt, jdirty, jst, jdr, jf, jvh, jvl) = fn(
            je.dsm.pool, je.dsm.locks, je.dsm.counters, je.dsm.dirty,
            sh(khi), sh(klo), sh(vhi), sh(vlo), np.int32(je.tree._root_addr),
            sh(is_read), sh(~is_read), sh(start))
        je.dsm.pool, je.dsm.counters = jpool, jcnt
        T = torch.from_numpy
        got = TB.mixed_step_spmd(
            pe.dsm.pool, pe.dsm.locks, pe.dsm.counters, T(khi), T(klo),
            T(vhi), T(vlo), pe.tree._root_addr, T(is_read), T(~is_read),
            T(start), cfg=pe.cfg, iters=pe._iters(), update_only=True)
        for g, w in zip(got, (jst, jdr, jf, jvh, jvl)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        st = got[0].numpy()
        assert (st[20:40] == TB.ST_FULL).all()
        assert st[4] == TB.ST_APPLIED and (st[5:9] == TB.ST_SUPERSEDED).all()
        if n > 1:
            assert st[B + 3] == TB.ST_SUPERSEDED
        _same_state(je, pe, f"update-only apply N={n}")


def test_from_jax_arrays_router_table_gives_the_same_staged_carry():
    je, _ = _pair(1)
    jt, jc, jr = je.tree, je.tree.cluster, je.router
    jr.table_np[::7] = np.int32(jt._root_addr)  # a table no leaf seed gives
    _run_read(je, JP, "aligned", 1)             # counters move first
    extra = {k: v for k, v in _kw(1).items()
             if k in ("step_capacity", "chunk_pages")}
    arrays = (np.asarray(jc.dsm.pool), np.asarray(jc.dsm.locks),
              np.asarray(jc.dsm.counters), jt._root_addr, jt._root_level,
              jc.directories[0].allocator.pages_used)
    _, _, pe = state.from_jax_arrays(
        *arrays, device="cpu", batch_per_node=_batch(1),
        router_table=jr.table_np, router_shift=jr.shift, **extra)
    np.testing.assert_array_equal(pe.router.table_np, jr.table_np)
    assert pe.router.shift == jr.shift
    _, want = _run_read(je, JP, "aligned", 2)
    _, got = _run_read(pe, TP, "aligned", 2)
    assert got == want
    _same_state(je, pe, "carried across")
    with pytest.raises(ConfigError, match="router_shift"):
        state.from_jax_arrays(*arrays, device="cpu",
                              router_table=jr.table_np, **extra)
