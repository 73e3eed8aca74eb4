"""Port parity: the observability hooks of the engine, the staged loops,
the integrity plane and the durability plane against the JAX package, at
one node and at eight (the JAX side on the ``eight_devices`` CPU mesh).

Both packages run ``chip_smoke.obs_run``, the op sequence of the smoke's
phase 22a (staged YCSB-C and YCSB-A windows with ``record_slo``,
``search_combined``, ``mixed`` retried through ``insert``, ``insert``
with splits, ``delete``, reclaim, scans, a recovery plane's base and
delta, chaos, a scrubber's quarantine and degrade, a refused write,
``targeted_repair``, a revoked lease), from one seed.  Equal, under
exactly the stated differences (ROADMAP.md section 3):

- the registry deltas, without the ``kernels.*``, ``transport.*`` and
  ``device.*`` families (the port counts launches and per-execution
  bytes, the reference program builds and jit compiles) and without
  wall-time values; histograms and SLO classes by their counts; the
  delta artifact's deflated size by its presence (the chain's random
  nonce moves it by a few bytes);
- the flight events in order, timestamps, wall times and chain nonces
  dropped;
- the span names and counts, and the ``slo.*`` ops and batches per
  class;
- the ledger's programs that both packages wrap, with equal counts of
  signatures.

Then the port alone: the staged loops do no obs work a step (counted),
the retrace detector fires on a port program called at a new shape
after ``seal``, and a dropped DSM's collector and memory sources read
nothing.
"""

import gc
import os
import types
import weakref

import numpy as np
import pytest
import torch

import chip_smoke as S
from sherman_tpu import chaos as JCH
from sherman_tpu import obs as JOBS
from sherman_tpu import recovery as JRC
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.models.scrub import Scrubber as JScrubber
from sherman_tpu.obs import device as JDEV
from sherman_tpu.ops import bits as JBITS
from sherman_tpu.workload import device_prep as JP
from sherman_tpu_torch import obs
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.obs import device as TDEV
from sherman_tpu_torch.obs import recorder as TFR
from sherman_tpu_torch.ops import page_kernels as PK
from sherman_tpu_torch.parallel import transport_kernel as TK
from sherman_tpu_torch.recovery import RecoveryPlane
from sherman_tpu_torch.utils import journal as J
from sherman_tpu_torch.workload import device_prep as TP

torch.set_num_threads(1)

U64 = np.uint64


def _jax_mods():
    return types.SimpleNamespace(
        Cluster=JCluster,
        cfg=lambda **kw: JDSMConfig(gather_impl="xla", **kw),
        TreeConfig=JTreeConfig, Tree=JTree, batched=JB, obs=JOBS, DEV=JDEV,
        chaos=JCH, recovery=JRC, Scrubber=JScrubber, prep=JP,
        mix64=JBITS.mix64_np, DegradedError=JB.DegradedError)


@pytest.fixture(scope="module", params=[1, 8], ids=["1node", "8nodes"])
def runs(request, eight_devices, tmp_path_factory):
    """obs_run on both packages: -> (jax result, port result, dirs)."""
    n = request.param
    cap = 32 if n > 1 else None
    out, dirs = [], []
    for name, mods in (("jax", _jax_mods()),
                       ("torch", S.port_obs_mods("cpu"))):
        bb = str(tmp_path_factory.mktemp(f"bb_{name}_{n}"))
        rdir = str(tmp_path_factory.mktemp(f"chain_{name}_{n}"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SHERMAN_BLACKBOX_DIR", bb)
            mp.setenv("SHERMAN_SLO", "1")
            mp.setenv("SHERMAN_DEVICE_OBS", "1")
            out.append(S.obs_run(mods, n, cap, rdir))
        dirs.append(bb)
    return out[0], out[1], dirs


def test_obs_registry_delta_matches_jax(runs):
    j, p, _ = runs
    assert p["delta"] == j["delta"]
    # the sequence reaches every hooked family
    for fam in ("dsm.", "slo.", "journal.", "ckpt.", "recovery.",
                "scrub.", "chaos.", "lease.", "engine."):
        assert any(k.startswith(fam) for k in p["delta"]), fam


def test_obs_flight_events_match_jax(runs):
    j, p, _ = runs
    assert p["events"] == j["events"]
    kinds = {k for k, _ in p["events"]}
    assert {"chaos.inject", "scrub.violation", "scrub.quarantine",
            "engine.degraded_enter", "engine.typed_error",
            "engine.degraded_exit", "recovery.checkpoint_base",
            "recovery.checkpoint_delta", "checkpoint.save",
            "recovery.targeted_repair_begin", "recovery.targeted_repair",
            "lease.revoked", "span"} <= kinds


def test_flight_drill_inject_degrade_repair_in_order(runs):
    """The reference's drill order (tests/test_slo.py), on the port's
    recorder: inject -> violation -> degraded -> repair begin ->
    degraded exit -> repair."""
    _, p, _ = runs
    kinds = [k for k, _ in p["events"]]
    first = {k: kinds.index(k) for k in (
        "chaos.inject", "scrub.violation", "engine.degraded_enter",
        "recovery.targeted_repair_begin", "engine.degraded_exit",
        "recovery.targeted_repair")}
    assert first["chaos.inject"] < first["scrub.violation"] \
        < first["engine.degraded_enter"] \
        < first["recovery.targeted_repair_begin"] \
        < first["engine.degraded_exit"] < first["recovery.targeted_repair"]
    faults = {f["fault"] for k, f in p["events"] if k == "chaos.inject"}
    assert faults == {"torn_page", "flip_entry_ver", "wedge_lock"}


def test_obs_span_names_and_counts_match_jax(runs):
    j, p, _ = runs
    assert p["spans"] == j["spans"]
    assert {"engine.search.combine", "engine.search.descend",
            "engine.mixed.descend_lock_apply",
            "engine.insert.descend_lock_apply", "engine.insert.split_drain",
            "engine.insert.flush_parents",
            "engine.delete.descend_lock_apply", "scrub.pass"} \
        <= set(p["spans"])
    names = [e["name"] for e in p["chrome"]["traceEvents"]]
    assert sorted(set(names)) == sorted(p["spans"])


def test_obs_slo_counts_match_jax(runs):
    j, p, _ = runs
    assert p["slo"] == j["slo"]
    assert set(p["slo"]) == {"read", "insert", "delete", "mixed", "scan"}


def test_obs_ledger_programs_match_jax(runs):
    """The programs both packages wrap, and their counts of distinct
    signatures, are equal; the rest is the stated difference (the
    reference's chained mixed step is one program,
    ``staged_mixed.serve_fanout_verify``; its host jits land under
    ``<unattributed>``)."""
    j, p, _ = runs
    both = set(S.OBS_BOTH_LABELS)
    assert {k: v for k, v in p["ledger"].items() if k in both} \
        == {k: v for k, v in j["ledger"].items() if k in both}
    assert set(p["ledger"]) - both == {"staged_mixed.serve_fanout",
                                       "staged_mixed.verify"}
    assert "staged_mixed.serve_fanout_verify" in j["ledger"]


def test_obs_sequence_outcomes_match_jax(runs):
    j, p, _ = runs
    for k in ("staged_c", "staged_a", "refused", "repair", "delta",
              "insert", "insert 2", "revoked insert"):
        assert p[k] == j[k], k
    for a, b in zip(p["mixed"] + p["search_combined"],
                    j["mixed"] + j["search_combined"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(p["delete"], j["delete"])
    for (pk, pv), (jk, jv) in zip(p["scan"], j["scan"]):
        np.testing.assert_array_equal(pk, jk)
        np.testing.assert_array_equal(pv, jv)
    assert p["refused"] and p["staged_c"][1] == 1 and p["staged_a"][1] == 1


def test_degraded_entry_auto_dumps_in_both(runs):
    for d in runs[2]:
        assert any("degraded_entry" in f and f.endswith(".json")
                   for f in os.listdir(d)), d


# ---------------------------------------------------------------------------
# The port alone.
# ---------------------------------------------------------------------------

SALT = 0x5E17_AB1E_5A17
N_KEYS = 4000


def _engine(n=1, B=512):
    keys = np.sort(JBITS.mix64_np(np.arange(N_KEYS, dtype=U64)
                                  ^ U64(SALT)))
    t = Tree(Cluster(DSMConfig(device="cpu", machine_nr=n,
                               pages_per_node=2048, locks_per_node=512,
                               step_capacity=B, chunk_pages=32)))
    e = TB.BatchedEngine(t, batch_per_node=B)
    TB.bulk_load(t, keys, keys ^ U64(0xDEADBEEF), fill=0.8)
    e.attach_router()
    return e, keys


def _typed(reg):
    return {m.name: m.snapshot() for m in reg.metrics()}


def _slo_counts():
    return {c: (w["ops_total"], w["batches_total"])
            for c, w in obs.slo_window().items()}


def test_staged_loops_do_no_per_step_obs_work(monkeypatch):
    """After one warm call, S staged steps change no obs object: no
    typed metric, span, flight event, SLO sample or ledger entry.  Then
    ``record_slo`` attributes the drained window at once."""
    monkeypatch.setenv("SHERMAN_SLO", "1")
    monkeypatch.setenv("SHERMAN_DEVICE_OBS", "1")
    eng, _ = _engine()
    reg, tracer, rec = obs.get_registry(), obs.get_tracer(), \
        obs.get_recorder()
    led = TDEV.get_ledger()
    obs.get_slo().reset()
    B, S = 512, 4
    step, (new_carry, tb, rt, rk) = TP.make_staged_step(
        eng, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=B, dev_b=B,
        log2_bins=16, fusion="pipelined", sampler="table")
    assert step.slo_class == "read"
    assert step.phase_labels == {"prep": "staged.prep",
                                 "serve_fanout": "engine.search_fanout",
                                 "verify": "staged.verify"}
    pool, counters = eng.dsm.pool, eng.dsm.counters
    carry = step(pool, counters, tb, rt, rk, new_carry())[1]
    carry = step(pool, counters, tb, rt, rk, carry)[1]
    before = (_typed(reg), tracer.summary(), len(rec.events()),
              _slo_counts(), led.entries(), led.retraces)
    for _ in range(S):
        carry = step(pool, counters, tb, rt, rk, carry)[1]
    carry = step.drain(carry)
    assert (_typed(reg), tracer.summary(), len(rec.events()),
            _slo_counts(), led.entries(), led.retraces) == before
    assert int(carry[2]) == (S + 2) * B
    step.record_slo(S, 0.01)
    w = obs.slo_window()["read"]
    assert (w["ops_total"], w["batches_total"]) == (S * B, S)

    mstep, (new_carry, tb, rt, rk) = TP.make_staged_mixed_step(
        eng, n_keys=N_KEYS, theta=0.99, salt=SALT, batch=B,
        read_ratio=0.5, dev_rb=B // 2, dev_wb=B // 2, log2_bins=16)
    assert mstep.slo_class == "mixed"
    locks = eng.dsm.locks
    carry = mstep(pool, locks, counters, tb, rt, rk, new_carry())[2]
    before = (_typed(reg), tracer.summary(), len(rec.events()),
              _slo_counts(), led.entries())
    for _ in range(S):
        carry = mstep(pool, locks, counters, tb, rt, rk, carry)[2]
    assert (_typed(reg), tracer.summary(), len(rec.events()),
            _slo_counts(), led.entries()) == before
    mstep.record_slo(S, 0.01)
    assert obs.slo_window()["mixed"]["ops_total"] == S * B
    obs.get_slo().reset()


def test_record_phase_obs_routes_walls_and_overlap():
    reg = obs.get_registry()
    TP.record_phase_obs("t_staged", {"prep": 2.0, "wall_ms": 5.0,
                                     "overlap_efficiency": 0.25})
    snap = reg.snapshot()
    assert snap["t_staged.prep_ms"]["count"] >= 1
    assert snap["t_staged.wall_ms"]["count"] >= 1
    assert snap["t_staged.overlap_efficiency"] == 0.25


def test_retrace_detector_fires_on_a_new_shape_after_seal(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("SHERMAN_DEVICE_OBS", "1")
    monkeypatch.setenv(TFR.BLACKBOX_ENV, str(tmp_path))
    # an earlier case's dump must not debounce this one
    monkeypatch.setattr(obs.get_recorder(), "min_dump_interval_s", 0.0)
    eng, keys = _engine()
    led = TDEV.get_ledger()
    eng.search_combined(keys[:100])
    r0 = led.retraces
    with led.sealed_scope():
        eng.search_combined(keys[200:300])     # same shapes: nothing
        assert led.retraces == r0
        eng.search_combined(keys[:150])        # 150 clients: new shape
    assert led.retraces == r0 + 1
    assert obs.snapshot()["device.retraces"] == led.retraces
    ev = [e for e in obs.get_recorder().events()
          if e["kind"] == "compile.retrace"][-1]["fields"]
    assert ev["program"] == "engine.search_fanout"
    assert "int64[150]@cpu" in ev["signature"]
    assert any("compile_retrace" in f for f in os.listdir(tmp_path))


def test_dropped_dsm_collector_and_sources_read_nothing(tmp_path):
    """The weakref contract: collectors and memory sources never keep a
    DSM, a journal or a recovery plane alive."""
    eng, keys = _engine()
    tree = eng.tree
    plane = RecoveryPlane(tree.cluster, tree, eng, str(tmp_path / "r"))
    plane.checkpoint_base()
    eng.insert(keys[:8] + U64(1), keys[:8])
    snap = obs.snapshot()
    assert snap["dsm.read_ops"] > 0
    assert snap["device.hbm_pool_bytes"] == 2048 * 256 * 4
    assert snap["device.host_journal_bytes"] > 0
    assert snap["device.host_checkpoints_bytes"] > 0
    pool = weakref.ref(eng.dsm.pool)
    plane.close()
    del plane, tree, eng
    gc.collect()
    assert pool() is None
    snap = obs.snapshot()
    assert not any(k.startswith("dsm.") and k != "dsm.host_steps"
                   for k in snap)
    assert snap["device.hbm_pool_bytes"] == 0
    assert snap["device.host_journal_bytes"] == 0
    assert snap["device.host_checkpoints_bytes"] == 0


def test_kernels_collector_equals_launches_and_transport_counts():
    PK.reset_launches()
    TK.reset_launches()
    eng, keys = _engine(n=8, B=64)
    x0 = obs.snapshot()
    eng.search_combined(keys[:200])
    snap = obs.snapshot()
    for k, v in PK.LAUNCHES.items():
        assert snap[f"kernels.{k}_launches"] == v
        assert snap[f"kernels.{k}_rows"] == PK.ROWS[k]
    assert snap["kernels.exchange_launches"] == TK.LAUNCHES["exchange"]
    # on CPU tensors the plain twins run: nothing launches, and the
    # exchanges still count with their packed bytes
    assert sum(PK.LAUNCHES.values()) == 0
    n = snap["transport.exchanges"] - x0["transport.exchanges"]
    nbytes = snap["transport.exchange_bytes"] - x0["transport.exchange_bytes"]
    assert n > 0 and nbytes > 0 and nbytes % (4 * 8) == 0


def test_engine_ops_attributed_to_classes_two_nodes():
    obs.get_slo().reset()
    t = Tree(Cluster(DSMConfig(device="cpu", machine_nr=2,
                               pages_per_node=256, locks_per_node=128,
                               step_capacity=256)))
    eng = TB.BatchedEngine(t, batch_per_node=64)
    keys = np.arange(1, 65, dtype=U64)
    eng.insert(keys, keys + U64(1))
    eng.search(keys)
    eng.mixed(keys[:16], keys[:16], np.arange(16) % 2 == 0)
    eng.range_query(1, 10)
    eng.delete(keys[:8])
    w = obs.slo_window()
    assert w["insert"]["ops_total"] >= 64
    assert w["read"]["ops_total"] >= 64
    assert w["mixed"]["ops_total"] == 16
    assert w["scan"]["ops_total"] == 1
    assert w["delete"]["ops_total"] == 8
    for cls in ("read", "insert", "delete", "mixed", "scan"):
        assert w[cls]["p99_ms"] > 0
    obs.get_slo().reset()


def test_journal_counters_and_torn_tail_event(tmp_path):
    reg = obs.get_registry()
    s0 = reg.snapshot()
    path = str(tmp_path / "j.seg")
    with J.Journal(path) as jr:
        jr.append(J.J_UPSERT, np.arange(1, 5, dtype=U64),
                  np.arange(1, 5, dtype=U64))
    rec = J.encode_record(J.J_DELETE, np.arange(1, 3, dtype=U64))
    with open(path, "ab") as f:
        f.write(rec[:len(rec) // 2])
    J.read_records(path, truncate_torn=True)
    d = obs.delta(s0, reg.snapshot())
    assert d["journal.appends"] == 1 and d["journal.rows"] == 4
    assert d["journal.fsyncs"] == 1 and d["journal.truncated_tails"] == 1
    ev = [e for e in obs.get_recorder().events()
          if e["kind"] == "journal.torn_tail"][-1]["fields"]
    assert ev["path"] == path and ev["truncated"] is True


def test_register_obs_points_the_collector_back_at_a_dsm():
    """A newer DSM supersedes an older one in the ``dsm`` collector and
    the accountant; ``register_obs`` points them back."""
    a, _ = _engine()
    a.search(np.arange(1, 9, dtype=U64))
    b = Cluster(DSMConfig(device="cpu", machine_nr=1, pages_per_node=64,
                          locks_per_node=64, step_capacity=16)).dsm
    snap = obs.snapshot()
    assert snap["dsm.read_ops"] == b.counter_snapshot()["read_ops"] == 0
    assert snap["device.hbm_pool_bytes"] == 64 * 256 * 4
    a.dsm.register_obs()
    snap = obs.snapshot()
    assert snap["dsm.read_ops"] == a.dsm.counter_snapshot()["read_ops"] > 0
    assert snap["device.hbm_pool_bytes"] == 2048 * 256 * 4
    del b
