"""Port parity: the ingress step's request-plane prep
(``sherman_tpu_torch/workload/device_prep.py``: ``make_device_prep`` and
``make_ingress_step`` on host and on device prep), against the JAX package,
case by case after tests/test_prep.py (the knob, ``u64_shr_dyn``, device
prep bit-identity and its fuzz, host against device answers, the profile
and the cache fallback, the typed bad placement, the sealed zero-retrace
serving loop with both knobs on).

Both packages load the same tree.  The port's device prep must equal its
own host staging and JAX's device prep, output for output (``khi``,
``klo``, ``active``, ``start``, ``inv``, the unique count), at 1 and 8
nodes, on all-duplicate, full, partial and single-key batches, after an
insert storm's splits and across a router span grow; the ingress step's
answers must equal JAX's, ``search_combined``'s and the truth.  The JAX
side runs as its own tests run it (``gather_impl="xla"``, the
``eight_devices`` fixture).  Every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu import config as JC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.workload import device_prep as JP
from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.workload import device_prep as TP

torch.set_num_threads(1)

NAMES = ("khi", "klo", "active", "start", "inv")


def make(jax_side, nr=1, *, write_combine=False, n=3000, step=3):
    """The reference test's tree (keys ``100 + 3i``, values ``7 * key``)
    in one package: one node 2,048 pages and 256 rows, eight nodes 1,024
    pages and 32 rows a node.  -> (tree, eng, keys, vals)."""
    kw = dict(machine_nr=nr, pages_per_node=2048 if nr == 1 else 1024,
              locks_per_node=512, step_capacity=1024 if nr == 1 else 256,
              chunk_pages=32)
    cfg = (JDSMConfig(gather_impl="xla", **kw) if jax_side
           else DSMConfig(device="cpu", **kw))
    tree = (JTree if jax_side else Tree)(
        (JCluster if jax_side else Cluster)(cfg))
    keys = np.arange(100, 100 + n * step, step, dtype=np.uint64)
    vals = keys * np.uint64(7)
    B = JB if jax_side else TB
    B.bulk_load(tree, keys, vals)
    tcfg = (JTreeConfig if jax_side else TreeConfig)(sibling_chase_budget=2)
    eng = B.BatchedEngine(tree, batch_per_node=256 // nr, tcfg=tcfg,
                          write_combine=write_combine)
    eng.attach_router()
    return tree, eng, keys, vals


def host_staging(eng, keys, width):
    """The host ingress staging, as make_ingress_step's dispatch does it:
    np.unique + zero pad + router probe + padded inverse."""
    n = keys.shape[0]
    uk, inv = np.unique(keys, return_inverse=True)
    U = uk.shape[0]
    kh, kl = bits.keys_to_pairs(uk)
    khi = np.zeros(width, kh.dtype)
    klo = np.zeros(width, kl.dtype)
    khi[:U] = kh
    klo[:U] = kl
    active = np.zeros(width, bool)
    active[:U] = True
    start = eng.router.host_start(khi, klo)
    inv_p = np.zeros(width, np.int32)
    inv_p[:n] = inv.reshape(-1).astype(np.int32)
    return khi, klo, active, start, inv_p, U


def raw_pairs(keys, width):
    n = keys.shape[0]
    kh, kl = bits.keys_to_pairs(keys)
    khi_raw = np.full(width, -1, np.int32)
    klo_raw = np.full(width, -1, np.int32)
    khi_raw[:n] = kh
    klo_raw[:n] = kl
    return khi_raw, klo_raw


def port_device_staging(eng, prep_fn, keys, width):
    khi_raw, klo_raw = raw_pairs(keys, width)
    r = eng.router
    with r._read_locked():
        rtable = torch.from_numpy(np.array(r.table_np))
        shift = torch.tensor(int(r.shift), dtype=torch.int64)
    out = prep_fn(torch.from_numpy(khi_raw), torch.from_numpy(klo_raw),
                  keys.shape[0], rtable, shift)
    return tuple(t.numpy() for t in out[:5]) + (int(out[5]),)


def jax_device_staging(eng, prep_fn, upload, keys, width):
    import jax
    khi_raw, klo_raw = raw_pairs(keys, width)
    r = eng.router
    with r._read_locked():
        rtable = upload(np.array(r.table_np))
        shift = upload(np.uint32(r.shift))
    out = prep_fn(jax.device_put(khi_raw), jax.device_put(klo_raw),
                  jax.device_put(np.int32(keys.shape[0])), rtable, shift)
    return tuple(np.asarray(x) for x in eng._unshard(*out[:5])) \
        + (int(np.asarray(out[5])),)


def assert_staging_equal(a, b, what):
    for name, x, y in zip(NAMES, a[:5], b[:5]):
        np.testing.assert_array_equal(x, y, err_msg=f"{name} ({what})")
    assert a[5] == b[5], f"unique count ({what})"


class Both:
    """The same tree in both packages, with a device prep at ``width``."""

    def __init__(self, nr, width, **kw):
        self.jt, self.je, self.keys, self.vals = make(True, nr, **kw)
        self.pt, self.pe, _, _ = make(False, nr, **kw)
        self.width = width
        self.jprep, self.jup = JP.make_device_prep(self.je, width=width)
        self.pprep = TP.make_device_prep(self.pe, width=width)

    def check(self, batch, what):
        w = self.width
        batch = np.asarray(batch, np.uint64)
        host = host_staging(self.pe, batch, w)
        dev = port_device_staging(self.pe, self.pprep, batch, w)
        jdev = jax_device_staging(self.je, self.jprep, self.jup, batch, w)
        assert_staging_equal(dev, host, what + ": port device vs host")
        assert_staging_equal(dev, jdev, what + ": port vs JAX device")
        return host


# -- knob parsing --------------------------------------------------------------

def test_prep_impl_knob(monkeypatch):
    monkeypatch.delenv("SHERMAN_PREP_IMPL", raising=False)
    assert C.prep_impl() == JC.prep_impl() == "host"    # the default
    for v, want in (("device", "device"), ("HOST", "host"),
                    (" Device ", "device")):
        monkeypatch.setenv("SHERMAN_PREP_IMPL", v)
        assert C.prep_impl() == JC.prep_impl() == want
    monkeypatch.setenv("SHERMAN_PREP_IMPL", "gpu")
    with pytest.raises(ConfigError):
        C.prep_impl()


@pytest.mark.parametrize("v,want", [("", 1), ("1", 1), ("off", 1),
                                    ("3", 3)])
def test_ack_quorum_knob(monkeypatch, v, want):
    monkeypatch.setenv("SHERMAN_ACK_QUORUM", v)
    assert C.ack_quorum() == JC.ack_quorum() == want


@pytest.mark.parametrize("v", ["0.5", "-2", "many"])
def test_ack_quorum_knob_refuses_typed(monkeypatch, v):
    monkeypatch.setenv("SHERMAN_ACK_QUORUM", v)
    with pytest.raises(ConfigError):
        C.ack_quorum()


# -- u64_shr_dyn ---------------------------------------------------------------

def test_u64_shr_dyn_matches_static(eight_devices):
    """The tensor-shift logical right shift equals the static one and
    JAX's dynamic one for every shift 0..63."""
    import jax
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    hi[:3] = [0xFFFFFFFF, 0, 0x80000000]
    lo[:3] = [0xFFFFFFFF, 0, 1]
    th = torch.from_numpy(hi.astype(np.int64))
    tl = torch.from_numpy(lo.astype(np.int64))
    jdyn = jax.jit(JBITS.u64_shr_dyn)
    for s in range(64):
        eh, el = JBITS.u64_shr(hi, lo, s)
        jh, jl = jdyn(hi, lo, np.uint32(s))
        gh, gl = bits.u64_shr_dyn(th, tl, torch.tensor(s))
        sh, sl = bits.u64_shr(th, tl, s)
        for got in ((gh, gl), (sh, sl)):
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(eh).astype(np.int64),
                                          err_msg=f"hi word, shift {s}")
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(el).astype(np.int64),
                                          err_msg=f"lo word, shift {s}")
        np.testing.assert_array_equal(np.asarray(jh), np.asarray(eh))
        np.testing.assert_array_equal(np.asarray(jl), np.asarray(el))


# -- device prep bit-identity --------------------------------------------------

@pytest.mark.parametrize("nr", [1, 8])
@pytest.mark.parametrize("case", ["random_dup", "straggler", "all_dup",
                                  "single", "presorted", "full_unique"])
def test_device_prep_bit_identity(eight_devices, nr, case):
    """The port's device prep == its host staging == JAX's device prep,
    bit for bit, across the padding shape classes."""
    b = Both(nr, 128)
    keys = b.keys
    rng = np.random.default_rng(23)
    batch = {
        "random_dup": rng.choice(keys, 128, replace=True),
        "straggler": rng.choice(keys, 97, replace=True),
        "all_dup": np.full(33, keys[7], np.uint64),
        "single": keys[:1],
        "presorted": np.sort(rng.choice(keys, 120, replace=False)),
        "full_unique": rng.choice(keys, 128, replace=False),
    }[case]
    b.check(batch, case)


@pytest.mark.parametrize("nr", [1, 8])
def test_device_prep_bit_identity_fuzz(eight_devices, nr):
    """Random widths and duplication rates, including batches whose keys
    collide into few leaves, and keys absent from the tree."""
    b = Both(nr, 256)
    keys = b.keys
    rng = np.random.default_rng(41)
    for trial in range(10):
        n = int(rng.integers(1, 257))
        pool = keys[: int(rng.choice([4, 32, keys.size]))]
        batch = rng.choice(pool, n, replace=True).astype(np.uint64)
        if trial % 3 == 0:
            batch[: n // 4] += np.uint64(1)        # absent keys
        b.check(batch, f"trial {trial}, n={n}")


@pytest.mark.parametrize("nr", [1, 8])
def test_device_prep_after_splits_and_span_grow(eight_devices, nr):
    """After an insert storm's splits (the router's table moved), and
    after a split beyond the seeded span (the router's shift grew), the
    device prep still equals the host staging and JAX's; the ingress
    step's re-uploaded router snapshot follows the version counters, and
    its answers equal ``search_combined``'s and the truth."""
    b = Both(nr, 256)
    keys = b.keys
    fresh = keys[:1500] + np.uint64(1)              # between loaded keys
    b.je.insert(fresh, fresh * np.uint64(7))
    b.pe.insert(fresh, fresh * np.uint64(7))
    assert b.pe.router.splits_noted == b.je.router.splits_noted > 0
    rng = np.random.default_rng(3)
    allk = np.sort(np.concatenate([keys, fresh]))
    step = TP.make_ingress_step(b.pe, width=256, prep_impl="device")
    jstep = JP.make_ingress_step(b.je, width=256, prep_impl="device")
    batch = rng.choice(allk, 200).astype(np.uint64)
    b.check(batch, "after splits")
    v, f = step(batch)
    jv, jf = jstep(batch)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.all()
    np.testing.assert_array_equal(v, batch * np.uint64(7))
    # a split past the seeded span grows the router's shift
    big = np.arange(1, 600, dtype=np.uint64) << np.uint64(40)
    shift0 = b.pe.router.shift
    b.je.insert(big, big ^ np.uint64(5))
    b.pe.insert(big, big ^ np.uint64(5))
    assert b.pe.router.span_grows == b.je.router.span_grows > 0
    assert b.pe.router.shift > shift0
    batch = np.concatenate([rng.choice(allk, 100), rng.choice(big, 100)]
                           ).astype(np.uint64)
    b.check(batch, "after span grow")
    v, f = step(batch)
    jv, jf = jstep(batch)
    ev, ef = b.pe.search_combined(batch)
    for x, y in ((v, jv), (f, jf), (v, ev), (f, ef)):
        np.testing.assert_array_equal(x, y)
    assert f.all()


# -- end to end ----------------------------------------------------------------

@pytest.mark.parametrize("nr", [1, 8])
def test_ingress_step_host_vs_device_answers(eight_devices, nr):
    """The device-prep ingress step serves the same answers as the
    host-prep step, as JAX's two steps and as the truth, on partial,
    full and single-key batches."""
    _, je, keys, _ = make(True, nr)
    _, pe, _, _ = make(False, nr)
    h = TP.make_ingress_step(pe, width=128, prep_impl="host")
    d = TP.make_ingress_step(pe, width=128, prep_impl="device")
    jh = JP.make_ingress_step(je, width=128, prep_impl="host")
    jd = JP.make_ingress_step(je, width=128, prep_impl="device")
    assert h.prep_impl == "host" and d.prep_impl == "device"
    rng = np.random.default_rng(5)
    for n in (128, 97, 1):
        batch = rng.choice(keys, n, replace=True).astype(np.uint64)
        hv, hf = h(batch)
        for step in (d, jh, jd):
            v, f = step(batch)
            np.testing.assert_array_equal(v, hv)
            np.testing.assert_array_equal(f, hf)
        assert hf.all()
        np.testing.assert_array_equal(hv, batch * np.uint64(7))
    np.testing.assert_array_equal(np.asarray(je.dsm.counters).reshape(-1),
                                  pe.dsm.counters_np().reshape(-1))


def test_device_prep_profile_and_fallback():
    """prep_profile publishes the per-placement number; a leaf cache
    forces the documented fallback to host."""
    _, eng, keys, _ = make(False)
    d = TP.make_ingress_step(eng, width=128, prep_impl="device")
    p = d.prep_profile(keys[:100], reps=2)
    assert set(p) == {"prep_device_ms"} and p["prep_device_ms"] >= 0
    h = TP.make_ingress_step(eng, width=128, prep_impl="host")
    p = h.prep_profile(keys[:100], reps=2)
    assert set(p) == {"prep_host_ms"} and p["prep_host_ms"] >= 0
    assert "device_prep" in d.programs and "device_prep" not in h.programs
    assert d.phase_labels == {"serve_fanout": "engine.search_fanout",
                              "device_prep": "serve.device_prep"}
    # the serve is the engine's own fan-out object (the identity pin)
    assert h.programs["serve_fanout"] is eng._get_search_fanout(
        eng._iters())
    lc = eng.attach_leaf_cache(slots=256, admit_every=4)
    try:
        f = TP.make_ingress_step(eng, width=128, leaf_cache=lc,
                                 prep_impl="device")
        assert f.prep_impl == "host"
    finally:
        eng.detach_leaf_cache()


def test_ingress_step_bad_impl_typed():
    _, eng, _, _ = make(False)
    with pytest.raises(ConfigError):
        TP.make_ingress_step(eng, width=128, prep_impl="gpu")


@pytest.mark.parametrize("prep", ["host", "device"])
def test_sealed_zero_retrace_both_knobs(monkeypatch, prep):
    """Both placements with write combining on: the sealed serving loop
    stays zero-retrace through partial-width reads, rid-carrying writes
    and deletes (the router's shift is data, not a signature)."""
    monkeypatch.setenv("SHERMAN_PREP_IMPL", prep)
    from sherman_tpu_torch.serve import ServeConfig, ShermanServer
    _, eng, keys, vals = make(False, write_combine=True)
    scfg = ServeConfig(widths=(128, 512), max_queue_ops=16384,
                       p99_targets_ms={c: 1e9 for c in
                                       ("read", "scan", "insert",
                                        "delete")})
    srv = ShermanServer(eng, scfg)
    try:
        srv.start(calib_keys=keys, calib_writes=(keys[:64], vals[:64]),
                  calib_delete_keys=np.asarray([5], np.uint64))
        assert srv._sealed
        plane = srv.stats()["request_plane"]
        assert plane["write_combine"] is True
        assert set(plane["prep_impl"].values()) == {prep}
        rng = np.random.default_rng(3)
        futs = []
        for _ in range(16):
            n = int(rng.choice([120, 60, 7]))
            kreq = keys[rng.integers(0, keys.size, n)]
            futs.append((srv.submit("read", kreq), kreq))
        for f, kreq in futs:
            got, found = f.result(timeout=60)
            assert found.all()
            np.testing.assert_array_equal(got, kreq * np.uint64(7))
        srv.submit("insert", keys[:8], keys[:8] ^ np.uint64(2),
                   rid=601).result(timeout=60)
        srv.submit("delete", np.asarray([5], np.uint64),
                   rid=602).result(timeout=60)
        assert srv.retraces == 0, "a new signature inside the sealed loop"
    finally:
        srv.kill()
