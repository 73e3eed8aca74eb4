"""Port parity: the data-plane chaos subsystem (``sherman_tpu_torch/
chaos.py``: ``FaultPlan``, ``Fault``, the DSM's ``install_chaos`` hook and
``SHERMAN_CHAOS``) against the JAX package, at one node and at four.

Both packages load the same tree (tests/test_chaos.py's ``small_cluster``)
and fire the same plans over the same host steps.  The replies, pools,
lock tables, counters and dirty rows must be bit-identical afterwards, and
the plans' bookkeeping (fired flags, undo log, injected count) equal.  The
JAX side runs as its own tests run it (``gather_impl="xla"``, the
``eight_devices`` fixture).  Every tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.parallel.dsm import DSM as JDSM
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import ConfigError, NotPortedError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import dsm as D
from sherman_tpu_torch.parallel.dsm import DSM

torch.set_num_threads(1)

FIELDS = ("kind", "step", "addr", "slot", "owner", "epoch", "fired")


def _faults(plan):
    return [tuple(getattr(f, k) for k in FIELDS) for f in plan.faults]


def _plans(faults, seed=0):
    """The same plan in both packages (fault dicts are copied)."""
    return (JCH.FaultPlan([dict(f) for f in faults], seed=seed),
            CH.FaultPlan([dict(f) for f in faults], seed=seed))


def _small(n):
    """tests/test_chaos.py's small_cluster on both sides: 1,500 keys
    ``17 * i`` bulk-loaded, values ``key ^ 0xBEEF``."""
    kw = dict(machine_nr=n, pages_per_node=1024, locks_per_node=256,
              step_capacity=256, chunk_pages=32)
    keys = np.arange(1, 1501, dtype=np.uint64) * np.uint64(17)
    jc = JCluster(JDSMConfig(gather_impl="xla", **kw))
    jt = JTree(jc)
    JB.bulk_load(jt, keys, keys ^ np.uint64(0xBEEF))
    pc = Cluster(DSMConfig(device="cpu", **kw))
    pt = Tree(pc)
    TB.bulk_load(pt, keys, keys ^ np.uint64(0xBEEF))
    return (jc, jt), (pc, pt), keys


def _same(jd, pd, what=""):
    np.testing.assert_array_equal(pd.pool.numpy(), np.asarray(jd.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(pd.locks.numpy(), np.asarray(jd.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(pd.counters_np(), np.asarray(jd.counters),
                                  err_msg=what + " counters")
    np.testing.assert_array_equal(pd.dirty_rows(), jd.dirty_rows(),
                                  err_msg=what + " dirty")


def _same_plan(jp, pp):
    assert _faults(pp) == _faults(jp)
    assert pp.describe() == jp.describe()
    assert pp._undo == jp._undo
    assert pp.injected == jp.injected


def _victim(tree, keys):
    addr = int(tree._descend(int(keys[keys.size // 2]))[0])
    return addr, tree._lock_word_addr(addr)


def _replies(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _replies(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _run_both(j, p, plans, ops):
    """Install the plans, run ``ops(dsm, tree)`` on each side, uninstall:
    equal replies, state and plan bookkeeping."""
    (jc, jt), (pc, pt) = j, p
    jp, pp = plans
    out = []
    for c, t, plan in ((jc, jt, jp), (pc, pt, pp)):
        c.dsm.install_chaos(plan)
        try:
            out.append(ops(c.dsm, t))
        finally:
            c.dsm.install_chaos(None)
    _replies(out[0], out[1])
    _same(jc.dsm, pc.dsm)
    _same_plan(jp, pp)
    return out[1]


def _one_step(dsm, tree):
    return dsm.read_word(0, 0)


# -- FaultPlan mechanics ------------------------------------------------------

def test_parse_random_storm_and_describe_match_jax():
    spec = '[{"kind": "wedge_lock", "step": 2, "addr": 5}]'
    assert _faults(CH.FaultPlan.parse(spec)) == \
        _faults(JCH.FaultPlan.parse(spec))
    for seed in range(6):
        for n in (1, 3, 8):
            for step_hi in (1, 8):
                a = JCH.FaultPlan.random(seed, n_faults=n, step_hi=step_hi)
                b = CH.FaultPlan.random(seed, n_faults=n, step_hi=step_hi)
                assert _faults(b) == _faults(a)
                assert b.describe() == a.describe()
        a, b = JCH.FaultPlan.storm(seed), CH.FaultPlan.storm(seed)
        assert _faults(b) == _faults(a) and b.describe() == a.describe()
        a = JCH.FaultPlan.parse(f"random:{seed}:4")
        b = CH.FaultPlan.parse(f"random:{seed}:4")
        assert _faults(b) == _faults(a) and b.seed == a.seed
    with pytest.raises(ConfigError):
        CH.FaultPlan.parse("bogus")
    with pytest.raises(ConfigError):
        CH.Fault(kind="nope")


def test_later_fault_layers_are_not_ported():
    """``repl_*`` kinds now parse as the JAX package's (split into the
    replication layer); the ``host_*`` kinds of the multihost plane still
    raise NotPortedError, naming item 7c."""
    spec = ('[{"kind": "wedge_lock", "step": 1, "addr": 5},'
            ' {"kind": "repl_drop", "poll": 2, "span": 3},'
            ' {"kind": "repl_partition", "poll": 4, "scope": "lease"}]')
    a, b = JCH.FaultPlan.parse(spec), CH.FaultPlan.parse(spec)
    assert _faults(b) == _faults(a) and b.describe() == a.describe()
    assert len(b.repl_faults) == len(a.repl_faults) == 2
    for kind in ("host_crash", "host_freeze", "host_zombie"):
        with pytest.raises(NotPortedError, match="item 7c"):
            CH.FaultPlan([{"kind": kind}])
        with pytest.raises(NotPortedError, match="item 7c"):
            CH.Fault(kind=kind)
        with pytest.raises(NotPortedError, match="item 7c"):
            CH.ReplFault(kind=kind)
    with pytest.raises(NotPortedError):
        CH.FaultPlan.parse('[{"kind": "wedge_lock", "step": 1, "addr": 5},'
                           ' {"kind": "host_freeze", "host": 0}]')


# -- the replication fault layer (tests/test_chaos.py:348-424) ----------------

REPL_FIELDS = ("kind", "poll", "span", "follower", "ms", "scope", "fired")


def _repl(layer):
    return [tuple(getattr(f, k) for k in REPL_FIELDS) for f in layer.faults]


def test_repl_fault_grammar_and_split():
    """``repl_*`` kinds ride the FaultPlan grammar but split into the
    replication layer, as in the JAX package; validation is typed."""
    spec = ('[{"kind": "repl_drop", "poll": 2, "span": 3},'
            ' {"kind": "wedge_lock", "step": 1, "addr": 5},'
            ' {"kind": "repl_partition", "poll": 4, "scope": "lease"}]')
    a, b = JCH.FaultPlan.parse(spec), CH.FaultPlan.parse(spec)
    assert len(b.faults) == 1 and len(b.repl_faults) == 2
    assert _faults(b) == _faults(a)
    layer = b.repl_layer()
    assert layer is not None and layer is b.repl_layer()  # cached
    assert _repl(layer) == _repl(a.repl_layer())
    assert b.describe() == a.describe()
    assert CH.FaultPlan([{"kind": "wedge_lock", "step": 0,
                          "addr": 1}]).repl_layer() is None
    for bad in ({"kind": "repl_nope"}, {"kind": "repl_drop", "span": 0},
                {"kind": "repl_partition", "scope": "wat"}):
        with pytest.raises(ConfigError):
            CH.ReplFault(**bad)
        with pytest.raises(Exception) as ej:
            JCH.ReplFault(**bad)
        assert type(ej.value).__name__ == "ConfigError"
    with pytest.raises(ConfigError):
        CH.ReplChaos([]).hold("sideways")


@pytest.mark.parametrize("seed", [5, 11])
def test_repl_chaos_directives_deterministic(seed):
    """The same (plan, seed) gives the JAX package's directive sequence,
    byte perturbations, injected counts and storm schedules."""
    faults = [dict(kind="repl_drop", poll=1, span=2),
              dict(kind="repl_delay", poll=4, span=1, follower=1),
              dict(kind="repl_reorder", poll=6, span=2),
              dict(kind="repl_slow", poll=9, span=1, ms=3.0),
              dict(kind="repl_partition", poll=12, span=2)]
    a = JCH.ReplChaos([dict(f) for f in faults], seed=seed)
    b = CH.ReplChaos([dict(f) for f in faults], seed=seed)
    for i in range(30):
        assert b.on_poll(i % 2) == a.on_poll(i % 2), i
    blob = bytes(range(200)) * 2
    for n in (400, 47, 1, 0):
        assert b.view(blob[:n]) == a.view(blob[:n]), n
    assert b.view(blob) != blob
    assert (b.injected, b.exhausted) == (a.injected, a.exhausted)
    assert b.describe() == a.describe()
    for s in range(seed, seed + 4):
        assert CH.ReplChaos.storm(s, n_faults=6).describe() \
            == JCH.ReplChaos.storm(s, n_faults=6).describe()
    assert all(f["scope"] == "ship"
               for f in CH.ReplChaos.storm(seed).describe())


def test_repl_chaos_hold_heal_and_lease_freeze():
    """Manual holds: a ship hold partitions every poll; a lease hold
    freezes the primary's lease view at the first observation until the
    heal; every step as in the JAX package."""
    layers = (JCH.ReplChaos([], seed=0), CH.ReplChaos([], seed=0))
    seen = []
    for layer in layers:
        out = [layer.on_poll(0)]
        layer.hold("ship")
        out += [layer.on_poll(0), layer.exhausted]
        layer.heal()
        out += [layer.on_poll(0), layer.exhausted]
        layer.hold("lease")
        out.append(layer.on_poll(1))
        live = {7: 1}
        out.append(dict(layer.lease_view(live)))
        live[7] = 2
        out.append(dict(layer.lease_view(live)))
        layer.heal()
        out.append(dict(layer.lease_view(live)))
        out += [layer.injected, layer.describe()]
        seen.append(out)
    assert seen[1] == seen[0]
    b = seen[1]
    assert b[0] is None and b[1]["partition"] and not b[2]
    assert b[3] is None and b[4]
    assert b[5] is None and b[6] == {7: 1} and b[7] == {7: 1}
    assert b[8] == {7: 2}


def test_env_spec_installs_on_the_dsm(eight_devices, monkeypatch):
    monkeypatch.setenv("SHERMAN_CHAOS", "random:3:2")
    kw = dict(machine_nr=2, pages_per_node=64, locks_per_node=32,
              step_capacity=32, chunk_pages=8)
    dsm = DSM(DSMConfig(device="cpu", **kw))
    want = JDSM(JDSMConfig(**kw)).chaos
    assert dsm.chaos is not None and len(dsm.chaos.faults) == 2
    assert _faults(dsm.chaos) == _faults(want)
    monkeypatch.delenv("SHERMAN_CHAOS")
    assert DSM(DSMConfig(device="cpu", **kw)).chaos is None


# -- every kind over one host step -------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_state_faults_fire_identically(eight_devices, n):
    """torn_page, flip_entry_ver and wedge_lock, each at an explicit
    target and deferred (drawn from the plan RNG), then seeded random
    plans: the same words corrupted, the same undo log."""
    j, p, keys = _small(n)
    victim, la = _victim(p[1], keys)
    assert _victim(j[1], keys) == (victim, la)
    cases = [
        [{"kind": "torn_page", "step": 0, "addr": victim}],
        [{"kind": "flip_entry_ver", "step": 0, "addr": victim, "slot": 3}],
        [{"kind": "wedge_lock", "step": 0, "addr": la}],
        [{"kind": "torn_page", "step": 0},
         {"kind": "flip_entry_ver", "step": 0, "slot": 60},
         {"kind": "wedge_lock", "step": 0}],
    ]
    for faults in cases:
        _run_both(j, p, _plans(faults, seed=11), _one_step)
    for seed in range(4):
        plans = (JCH.FaultPlan.random(1000 + seed, n_faults=3, step_hi=2),
                 CH.FaultPlan.random(1000 + seed, n_faults=3, step_hi=2))
        _run_both(j, p, plans,
                  lambda d, t: (d.read_word(0, 0), d.read_word(0, 0)))
        assert plans[1].exhausted


@pytest.mark.parametrize("n", [1, 4])
def test_drop_cas_loses_honestly(eight_devices, n):
    j, p, _ = _small(n)
    la = bits.make_addr(n - 1, 7)
    mask = bits.LEASE_MASK

    def ops(dsm, tree):
        lost = dsm.cas(la, 0, 0, tree.ctx.lease, space=D.SPACE_LOCK)
        word = dsm.read_word(la, 0, space=D.SPACE_LOCK)
        won = dsm.cas(la, 0, 0, tree.ctx.lease, space=D.SPACE_LOCK)
        dsm.write_word(la, 0, 0, space=D.SPACE_LOCK)
        return lost, word, won

    lost, word, won = _run_both(
        j, p, _plans([{"kind": "drop_cas", "step": 0}]), ops)
    assert not lost[1] and word == 0 and won[1]
    # the masked CAS branch: its expectation's masked bits flipped
    old, won = _run_both(j, p, _plans([{"kind": "drop_cas", "step": 0}]),
                         lambda d, t: d.masked_cas(la, 0, 0, t.ctx.lease,
                                                   mask, space=D.SPACE_LOCK))
    assert not won
    assert int(p[0].dsm.read_word(la, 0, space=D.SPACE_LOCK)) == 0


@pytest.mark.parametrize("n", [1, 4])
def test_stale_read_serves_the_old_snapshot(eight_devices, n):
    j, p, keys = _small(n)
    addr, _ = _victim(p[1], keys)
    assert _victim(j[1], keys)[0] == addr
    fresh = p[0].dsm.read_page(addr)
    j[0].dsm.read_page(addr)

    def ops(dsm, tree):
        dsm.read_word(0, 0)                     # step 0 arms the snapshot
        dsm.write_words(addr, 200, np.array([1234], np.int32))
        return dsm.read_page(addr), dsm.read_pages([addr, addr])

    got, both = _run_both(j, p, _plans([{"kind": "stale_read", "step": 2}]),
                          ops)
    # the stale reply is the pre-write page; the pool holds the write
    np.testing.assert_array_equal(got, fresh)
    assert int(p[0].dsm.read_page(addr)[200]) == 1234


def test_stale_snapshot_is_a_copy(eight_devices):
    """On the CPU the pool's numpy view shares memory with the live
    pool: the armed snapshot must not follow a later write."""
    j, p, keys = _small(1)
    addr, _ = _victim(p[1], keys)
    before = p[0].dsm.read_page(addr).copy()
    plan = CH.FaultPlan([CH.Fault(kind="stale_read", step=2)])
    p[0].dsm.install_chaos(plan)
    p[0].dsm.read_word(0, 0)
    p[0].dsm.write_words(addr, 200, np.array([1234], np.int32))
    got = p[0].dsm.read_page(addr)
    p[0].dsm.install_chaos(None)
    np.testing.assert_array_equal(got, before)


# -- repair ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_undo_restores_and_skips_rewritten_words(eight_devices, n):
    j, p, keys = _small(n)
    (jc, jt), (pc, pt) = j, p
    victim, la = _victim(pt, keys)
    assert _victim(jt, keys) == (victim, la)
    before = pc.dsm.pool.clone()
    faults = [{"kind": "torn_page", "step": 0, "addr": victim},
              {"kind": "flip_entry_ver", "step": 0, "addr": victim,
               "slot": 3},
              {"kind": "wedge_lock", "step": 0, "addr": la}]
    plans = _plans(faults)
    _run_both(j, p, plans, _one_step)
    assert plans[1].corrupted_pool_rows() == plans[0].corrupted_pool_rows()
    assert CH.FaultPlan.rows_to_addrs(plans[1].corrupted_pool_rows(),
                                      pc.cfg.pages_per_node) == [victim]
    assert plans[1].undo(pc.dsm) == plans[0].undo(jc.dsm) == 3
    assert torch.equal(pc.dsm.pool, before)
    _same(jc.dsm, pc.dsm)
    assert int(pc.dsm.read_word(la, 0, space=D.SPACE_LOCK)) == 0
    # a word rewritten after the injection is left as it was rewritten
    plans = _plans(faults)
    _run_both(j, p, plans, _one_step)
    for c, t in ((jc, jt), (pc, pt)):
        c.dsm.write_word(la, 0, t.ctx.lease, space=D.SPACE_LOCK)
    assert plans[1].undo(pc.dsm) == plans[0].undo(jc.dsm) == 2
    _same(jc.dsm, pc.dsm)
    assert int(pc.dsm.read_word(la, 0, space=D.SPACE_LOCK)) == pt.ctx.lease
    assert plans[1].corrupted_pool_rows() == []
