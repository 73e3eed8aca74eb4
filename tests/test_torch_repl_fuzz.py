"""Port parity: the replication and partition fuzz storms of
tests/test_fuzz.py (``test_fuzz_repl_storm``, ``test_fuzz_partition_storm``)
run through both packages from the same seeds.

Each package is held to the storm's own contract (every follower and every
promoted winner equals the acked model, the stale primary is fenced typed,
replica reads never lie, damage is detected or refused and the tail heals).
Across packages the primaries' pools, the followers' pools and the winners'
states must be equal; where the sequence has no wall-clock bound (the
replication storm, and the partition storm's quorum-off seeds) the whole
group state is compared too.  Seeded and small.
"""

import numpy as np
import pytest
import torch

from sherman_tpu import chaos as JCH
from sherman_tpu import recovery as JRC
from sherman_tpu import replica as JRP
from sherman_tpu.cluster import Cluster as JCluster
from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.config import TreeConfig as JTreeConfig
from sherman_tpu.errors import ShermanError as JShermanError
from sherman_tpu.models import batched as JB
from sherman_tpu.models.btree import Tree as JTree
from sherman_tpu.utils import journal as JJ
from sherman_tpu_torch import chaos as CH
from sherman_tpu_torch import recovery as RC
from sherman_tpu_torch import replica as RP
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, TreeConfig
from sherman_tpu_torch.errors import ShermanError
from sherman_tpu_torch.models import batched as TB
from sherman_tpu_torch.models.btree import Tree
from sherman_tpu_torch.utils import journal as J

from test_torch_replica import group_state, npool, same

torch.set_num_threads(1)


class Mods:
    def __init__(self, jax_side: bool):
        self.jax = jax_side
        (self.B, self.RC, self.RP, self.J, self.CH, self.Err) = (
            (JB, JRC, JRP, JJ, JCH, JShermanError) if jax_side
            else (TB, RC, RP, J, CH, ShermanError))
        self.TreeConfig = JTreeConfig if jax_side else TreeConfig
        self.Tree = JTree if jax_side else Tree

    def cluster(self, **kw):
        return (JCluster(JDSMConfig(gather_impl="xla", **kw)) if self.jax
                else Cluster(DSMConfig(device="cpu", **kw)))


def _repl_storm(m, d):
    """tests/test_fuzz.py::test_fuzz_repl_storm's sequence."""
    rng = np.random.default_rng(61)
    cluster = m.cluster(machine_nr=2, pages_per_node=1024,
                        locks_per_node=256, step_capacity=256,
                        chunk_pages=32)
    tcfg = m.TreeConfig(sibling_chase_budget=1)
    tree = m.Tree(cluster)
    keys = np.unique(rng.integers(1, 1 << 56, 700, dtype=np.uint64))[:600]
    vals = keys ^ np.uint64(0xFA2E)
    m.B.bulk_load(tree, keys, vals)
    eng = m.B.BatchedEngine(tree, batch_per_node=128, tcfg=tcfg)
    eng.attach_router()
    model = dict(zip(keys.tolist(), vals.tolist()))
    trace = []

    def check_converged(who, engine):
        ak = np.asarray(sorted(model), np.uint64)
        av = np.asarray([model[int(k)] for k in ak], np.uint64)
        got, found = engine.search(ak)
        assert found.all(), f"{who}: acked keys lost"
        np.testing.assert_array_equal(got, av, err_msg=who)
        gone = np.asarray([int(k) for k in keys.tolist()
                           if int(k) not in model][:64], np.uint64)
        if gone.size:
            _, f2 = engine.search(gone)
            assert not f2.any(), f"{who}: deleted keys resurrected"

    for cycle in range(2):
        plane = m.RC.RecoveryPlane(cluster, tree, eng,
                                   str(d / f"storm-{cycle}"))
        plane.checkpoint_base()
        group = m.RP.ReplicaGroup(plane, 2, batch_per_node=128, tcfg=tcfg,
                                  cache_slots=512, poll_ms=1e9)
        for rnd in range(3):
            for _ in range(3):
                kreq = np.unique(keys[rng.integers(0, keys.size, 48)])
                vreq = kreq ^ np.uint64(0xFA2E) \
                    ^ np.uint64((cycle << 20) | (rnd << 10) | 7)
                eng.insert(kreq, vreq)
                model.update(zip(kreq.tolist(), vreq.tolist()))
                if rng.random() < 0.5:
                    kd = np.unique(keys[rng.integers(0, keys.size, 8)])
                    fnd = eng.delete(kd)
                    for k, f in zip(kd.tolist(), np.asarray(fnd).tolist()):
                        if f:
                            model.pop(int(k), None)
            roll = rng.random()
            if roll < 0.3:
                plane._rotate_journal(plane._segment + 1)
            elif roll < 0.5 and rnd == 1:
                plane.checkpoint_delta()
            group.pump()
            for f in group.followers:
                check_converged(f"cycle {cycle} round {rnd} follower "
                                f"{f.idx}", f.eng)
            sample = keys[rng.integers(0, keys.size, 64)]
            group.followers[rnd % 2].admit(sample[:32])
            got, found = group.read(sample)
            for k, g, fd in zip(sample.tolist(), got.tolist(),
                                np.asarray(found).tolist()):
                if int(k) in model:
                    assert fd and g == model[int(k)]
                else:
                    assert not fd
            trace.append((np.asarray(got), np.asarray(found),
                          group_state(m, group)))
        rec = m.J.encode_record(m.J.J_UPSERT,
                                np.asarray([1 << 41], np.uint64),
                                np.asarray([9], np.uint64), rid=4)
        with open(eng.journal.path, "ab") as fh:
            fh.write(rec[: len(rec) // 2])
        rcpt = group.promote()
        assert rcpt["epoch"]["new"] == 2
        with pytest.raises(m.Err) as ei:
            eng.insert(keys[:2], keys[:2])
        exc = ei.value
        while exc is not None and not isinstance(exc,
                                                 m.RP.StalePrimaryError):
            exc = exc.__cause__
        assert isinstance(exc, m.RP.StalePrimaryError)
        win = group.promoted
        check_converged(f"cycle {cycle} promoted", win.eng)
        trace.append((rcpt["winner"], rcpt["watermarks"][0]["seq"],
                      npool(m.jax, win.cluster)))
        group.stop()
        plane.close()
        cluster, tree, eng = win.cluster, win.tree, win.eng
    return trace


def test_fuzz_repl_storm(eight_devices, tmp_path):
    """The replication storm: writes and deletes, rotations, a sweep under
    load, replica reads, two kills with torn tails and promotions; each
    package holds the contract and their states agree step by step."""
    out = []
    for jax_side in (True, False):
        d = tmp_path / ("jax" if jax_side else "port")
        d.mkdir()
        out.append(_repl_storm(Mods(jax_side), d))
    same(out[0], out[1])


def _partition_storm(m, d, seed):
    """tests/test_fuzz.py::test_fuzz_partition_storm's sequence, one
    seed."""
    rng = np.random.default_rng(seed)
    cluster = m.cluster(machine_nr=1, pages_per_node=1024,
                        locks_per_node=256, step_capacity=256,
                        chunk_pages=32)
    tree = m.Tree(cluster)
    keys = np.unique(rng.integers(1, 1 << 56, 500, dtype=np.uint64))[:400]
    vals = keys ^ np.uint64(0x5707)
    m.B.bulk_load(tree, keys, vals)
    eng = m.B.BatchedEngine(tree, batch_per_node=128,
                            tcfg=m.TreeConfig(sibling_chase_budget=1))
    eng.attach_router()
    model = dict(zip(keys.tolist(), vals.tolist()))
    plane = m.RC.RecoveryPlane(cluster, tree, eng, str(d / f"p{seed}"))
    plane.checkpoint_base()
    group = m.RP.ReplicaGroup(plane, 2, batch_per_node=128, cache_slots=512,
                              poll_ms=1e9)
    chaos = m.CH.ReplChaos.storm(seed, n_faults=8, poll_hi=20, span_hi=4,
                                 followers=2)
    group.attach_chaos(chaos)
    quorum_on = seed % 2 == 1
    timeouts = 0
    for rnd in range(6):
        kreq = np.unique(keys[rng.integers(0, keys.size, 48)])
        vreq = kreq ^ np.uint64(0x5707) \
            ^ np.uint64((seed << 12) | (rnd << 4) | 1)
        eng.insert(kreq, vreq)
        model.update(zip(kreq.tolist(), vreq.tolist()))
        if rng.random() < 0.4:
            kd = np.unique(keys[rng.integers(0, keys.size, 8)])
            fnd = eng.delete(kd)
            for k, f in zip(kd.tolist(), np.asarray(fnd).tolist()):
                if f:
                    model.pop(int(k), None)
        if rng.random() < 0.3:
            plane._rotate_journal(plane._segment + 1)
        if quorum_on:
            try:
                group.wait_quorum(1, timeout_s=0.4)
            except m.RP.QuorumTimeoutError:
                timeouts += 1
        else:
            group.pump()
    for _ in range(40):
        group.pump()
        if all(f.caught_up and not f.quarantined for f in group.followers):
            break
    assert chaos.injected >= 1, f"seed {seed}: storm was a no-op"
    st = group.stats()
    ak = np.asarray(sorted(model), np.uint64)
    av = np.asarray([model[int(k)] for k in ak], np.uint64)
    gone = np.asarray([int(k) for k in keys.tolist()
                       if int(k) not in model][:64], np.uint64)
    for f in group.followers:
        assert f.caught_up and not f.quarantined, (seed, f.idx, st)
        got, found = f.eng.search(ak)
        assert found.all(), f"seed {seed} follower {f.idx}: acked keys lost"
        np.testing.assert_array_equal(got, av,
                                      err_msg=f"seed {seed} f{f.idx}")
        if gone.size:
            _, f2 = f.eng.search(gone)
            assert not f2.any(), f"seed {seed} follower {f.idx}: resurrection"
    assert group.wait_quorum(1, timeout_s=30.0)["covered"] >= 1
    pools = [npool(m.jax, cluster)] + [npool(m.jax, f.cluster)
                                       for f in group.followers]
    whole = None if quorum_on else group_state(m, group)
    group.stop()
    plane.close()
    return pools, whole, chaos.describe()


@pytest.mark.parametrize("seed", [17, 43, 88])
def test_fuzz_partition_storm(eight_devices, tmp_path, seed):
    """Seeded replication-fault storms over the shipping tail, quorum acks
    on for odd seeds: damage detected or refused, never applied; after the
    windows every follower equals the acked model.  The pools (and, with
    the quorum off, the whole group state) equal JAX's."""
    out = []
    for jax_side in (True, False):
        d = tmp_path / ("jax" if jax_side else "port")
        d.mkdir()
        out.append(_partition_storm(Mods(jax_side), d, seed))
    same(out[0][0], out[1][0])
    for pool in out[1][0][1:]:
        np.testing.assert_array_equal(pool, out[1][0][0])
    same(out[0][1], out[1][1])
    if seed % 2 == 0:
        assert out[1][2] == out[0][2]
