"""Two ranks of the port on this CPU, over the ``gloo`` process group: the
keeper's rendezvous and collectives, the raw process-spanning DSM
(``tests/test_multihost.py``'s pins: cross-rank write/read and one CAS
winner cluster-wide), and the failure plane (``tests/test_failure.py``'s
process cases): the guarded barrier against a stalled peer, the heartbeat
ending a survivor, the liveness roll call and the preemption sync."""

import os
import re
import signal
import time

import pytest

import torch_ranks as RK

_KEEPER = r'''
keeper = bootstrap.init_multihost()
assert keeper.is_multihost and keeper.machine_nr == nproc
me = keeper.server_enter()
assert me == pid
keeper.barrier("start")
assert keeper.sum("one", 1) == nproc
assert keeper.sum("ranks", pid) == sum(range(nproc))
g = bootstrap.process_allgather(np.asarray([pid, 10 + pid], np.int32))
assert g.shape == (nproc, 2) and g[:, 0].tolist() == list(range(nproc))
g = bootstrap.process_allgather(np.full((2, 3), pid, np.uint8), tiled=True)
assert g.shape == (2 * nproc, 3) and g[::2, 0].tolist() == list(range(nproc))
a, b = bootstrap.process_allgather(
    (np.asarray([pid], np.int64), np.asarray([pid == 0])))
assert a.ravel().tolist() == list(range(nproc)) and b.ravel().tolist() == [
    True] + [False] * (nproc - 1)
x = np.arange(5, dtype=np.uint32) * 7 if pid == 0 else \
    np.zeros(5, np.uint32)
y, z = bootstrap.broadcast_one_to_all((x, np.asarray([pid], np.int64)))
assert y.tolist() == [0, 7, 14, 21, 28] and z.tolist() == [0]
assert bootstrap.allreduce_int(pid + 1, "max") == nproc
assert bootstrap.allgather_object({"r": pid}) == [{"r": r}
                                                  for r in range(nproc)]
from sherman_tpu_torch.parallel import mesh as MESH
m = MESH.make_mesh(4 * nproc)
assert m.spans and list(m.local_nodes) == list(range(4 * pid, 4 * pid + 4))
# the equal-split all-to-all of the ranks, whole and in chunks
import torch
from sherman_tpu_torch.parallel import transport as T
send = (torch.arange(2 * 7, dtype=torch.int32) + 100 * pid).view(2, 7)
want = torch.stack([torch.arange(7, dtype=torch.int32) + 7 * pid + 100 * p
                    for p in range(2)])
assert torch.equal(T.rank_all_to_all(send), want)
T._GLOO_CHUNK = 3
assert torch.equal(T.rank_all_to_all(send), want)
g = T.rank_all_gather(torch.tensor([[pid, -pid]], dtype=torch.int32), 2)
assert g.tolist() == [[0, 0], [1, -1]]
bootstrap.sync_global_devices("done")
print(f"[{pid}] KEEPER-PASS", flush=True)
'''

_DSM = r'''
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig, PAGE_WORDS
from sherman_tpu_torch.errors import MultiprocessUnsupportedError
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import dsm as D

keeper = bootstrap.init_multihost()
# 2 ranks x 2 nodes = 4 nodes; each rank serves its contiguous block of 2
cfg = DSMConfig(machine_nr=4, pages_per_node=64, locks_per_node=64,
                step_capacity=32, host_step_capacity=16, chunk_pages=8,
                device="cpu")
cluster = Cluster(cfg, keeper=keeper)
dsm = cluster.dsm
assert dsm.multihost and cluster.local_locks is None
assert list(dsm.local_nodes) == ([0, 1] if pid == 0 else [2, 3])
assert dsm.pool.shape == (2 * 64, PAGE_WORDS)
try:
    cluster.register_client()
    raise SystemExit("a raw client registered on a multihost cluster")
except MultiprocessUnsupportedError:
    pass

# every host-API call below is a COLLECTIVE: both ranks run the identical
# sequence, each from its own nodes.  Cross-rank write/read: each rank
# writes a page on a node the OTHER rank owns, then reads it back.
target = bits.make_addr(2, 5) if pid == 0 else bits.make_addr(1, 7)
page = (np.arange(PAGE_WORDS) + 1000 * (pid + 1)).astype(np.int32)
dsm.write_page(target, page)
keeper.barrier("written")
got = dsm.read_page(target)
np.testing.assert_array_equal(got, page)

# cross-rank CAS contention on ONE lock word: one winner cluster-wide
lock = bits.make_addr(3, 9)
old, won = dsm.cas(lock, 0, 0, 100 + pid, space=D.SPACE_LOCK)
wins = keeper.sum("cas_wins", int(won))
assert wins == 1, f"expected one cluster-wide CAS winner, got {wins}"
holder = dsm.read_word(lock, 0, space=D.SPACE_LOCK)
assert holder in (100, 101)

# the replicated host API: rank 0 posts, every rank learns the replies
rep = cluster.host_dsm.read_pages([target, bits.make_addr(2, 5)])
assert rep.shape == (2, PAGE_WORDS)

# counters: rank-local totals + keeper.sum aggregation
local_reads = dsm.counter_snapshot()["read_ops"]
total_reads = keeper.sum("reads", local_reads)
assert total_reads >= local_reads > 0

# ownership-filtered dirty tracking: a replicated write is marked by its
# owner rank, and a rank tracks only its own rows
cluster.host_dsm.write_page(bits.make_addr(3, 2), page)
lo, hi = dsm.local_row_range()
rows = dsm.dirty_rows()
assert ((rows >= lo) & (rows < hi)).all()
assert (3 * 64 + 2 in rows.tolist()) == (pid == 1)
keeper.barrier("done")
print(f"[{pid}] DSM-PASS", flush=True)
'''

_STALL = r'''
import time
from sherman_tpu_torch.utils import failure
keeper = bootstrap.init_multihost()
keeper.barrier("stall-sync", timeout_s=60)   # anchor both timelines
if pid == 1:
    time.sleep(6)   # the stall: misses the survivor's first deadline
    # late FIRST call: the burn marker fast-forwards it onto the retry
    keeper.barrier("stalled-peer", timeout_s=60)
    print(f"[{pid}] RESUME-PASS", flush=True)
    os._exit(0)
t0 = time.monotonic()
try:
    keeper.barrier("stalled-peer", timeout_s=2)
    print(f"[{pid}] barrier unexpectedly passed", flush=True)
    os._exit(3)
except failure.PeerFailure as e:
    took = time.monotonic() - t0
    assert took < 5, f"detection took {took:.1f}s"
    assert e.missing == [1], f"stall misattributed: {e.missing}"
    assert e.attempt == 0
    print(f"[{pid}] DETECT-STALL t={took:.1f}s missing={e.missing}",
          flush=True)
keeper.barrier("stalled-peer", timeout_s=60)   # the retry meets the peer
print(f"[{pid}] RESUME-PASS", flush=True)
os._exit(0)
'''

_DEATH = r'''
import time
keeper = bootstrap.init_multihost()
keeper.barrier("armed")
if pid == 1:
    os._exit(17)   # simulated crash: no shutdown, no cleanup
print(f"[{pid}] SURVIVOR-BLOCKING", flush=True)
keeper.barrier("after-crash", timeout_s=120)
print(f"[{pid}] barrier unexpectedly passed", flush=True)
os._exit(3)
'''

_LIVE = r'''
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.utils import failure
keeper = bootstrap.init_multihost()
cfg = DSMConfig(machine_nr=2, pages_per_node=64, locks_per_node=64,
                step_capacity=16, host_step_capacity=8, chunk_pages=8,
                device="cpu")
cluster = Cluster(cfg, keeper=keeper)
assert keeper.live_processes() == [0, 1]
assert failure.live_processes(2) == [0, 1]
ctx = cluster.register_client(replicated=True)
assert cluster.sweep_dead_processes({0: [ctx.tag], 1: [77]}) == []
assert cluster.lease_is_live(ctx.tag, ctx.epoch)
assert failure.heartbeat_monitor().stale() == []
# a process the roll call does not name: its non-replicated tags expire
# on every rank (the roll call's answer stubbed identically on both)
real = failure.live_processes
failure.live_processes = lambda n, client=None: [0]
try:
    assert cluster.sweep_dead_processes({0: [ctx.tag], 1: [77, 78]}) == [
        77, 78]
finally:
    failure.live_processes = real
assert cluster.lease_epochs[77] == cluster.lease_epochs[78] == 1
assert cluster.lease_is_live(ctx.tag, ctx.epoch)
assert failure.live_processes(2) == [0, 1]
keeper.barrier("done")
print(f"[{pid}] LIVE-PASS", flush=True)
'''

_PREEMPT = r'''
import time
from sherman_tpu_torch.utils import failure
keeper = bootstrap.init_multihost()
guard = failure.PreemptionGuard(keeper)
keeper.barrier("loop-start")
open(os.path.join(tmp, f"loop{pid}"), "w").close()   # the runner's cue
sync_at = -1
for step in range(2000):
    if guard.should_act(step):
        sync_at = step
        break
    time.sleep(0.02)
guard.close()
assert sync_at >= 0, "preemption notice never propagated"
total = keeper.sum("sync_at", sync_at)
assert total == nproc * sync_at, f"split boundary: {total} vs {sync_at}"
print(f"[{pid}] PREEMPT-PASS step={sync_at}", flush=True)
'''


_RANGE = r'''
from sherman_tpu_torch import config as C
from sherman_tpu_torch.cluster import Cluster
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import ProtocolError
from sherman_tpu_torch.models import batched
from sherman_tpu_torch.models.btree import Tree
keeper = bootstrap.init_multihost()
cfg = DSMConfig(machine_nr=4, pages_per_node=64, locks_per_node=64,
                step_capacity=32, host_step_capacity=16, chunk_pages=8,
                device="cpu")
tree = Tree(Cluster(cfg, keeper=keeper))
eng = batched.BatchedEngine(tree, batch_per_node=16)
keys = np.arange(1, 200, dtype=np.uint64)
batched.bulk_load(tree, keys, keys)
eng.attach_router()
k, v = eng.range_query(5, 9)
assert k.tolist() == [5, 6, 7, 8]
# a range past KEY_POS_INF: refused before any collective, on every rank
try:
    eng.range_query_many([(1, 3), (1, C.KEY_POS_INF + 1)])
    raise SystemExit("a range past KEY_POS_INF was served")
except AssertionError:
    pass
# the single-process tiers refuse a mesh that spans processes
from sherman_tpu_torch.errors import MultiprocessUnsupportedError
try:
    eng.attach_leaf_cache(slots=64)
    raise SystemExit("a leaf cache attached across processes")
except MultiprocessUnsupportedError:
    pass
# divergent drivers: the digest check raises on every rank
try:
    eng.search(keys[:8] + np.uint64(pid))
    raise SystemExit("skewed drivers were served")
except ProtocolError:
    pass
keeper.barrier("done")
print(f"[{pid}] RANGE-PASS", flush=True)
'''


def test_range_past_pos_inf_and_skewed_drivers_refused(tmp_path):
    """At two processes a range past KEY_POS_INF raises the port's
    AssertionError (as at one), and drivers that diverge raise
    ProtocolError on every rank instead of desynchronizing."""
    RK.run(tmp_path, _RANGE, "RANGE-PASS", timeout=90)


def test_keeper_rendezvous_and_collectives(tmp_path):
    RK.run(tmp_path, _KEEPER, "KEEPER-PASS", timeout=90)


def test_dsm_cross_rank_write_read_cas(tmp_path):
    RK.run(tmp_path, _DSM, "DSM-PASS", timeout=90)


def test_guarded_barrier_names_stalled_peer_then_realigns(tmp_path):
    outs = RK.run(tmp_path, _STALL, "RESUME-PASS", timeout=90)
    assert "[0] DETECT-STALL" in outs[0], outs[0][-4000:]


def test_heartbeat_ends_the_survivor_of_a_dead_peer(tmp_path):
    from sherman_tpu_torch.utils import failure
    t0 = time.monotonic()
    procs = RK.spawn(tmp_path, _DEATH, env={"SHERMAN_HEARTBEAT_S": "3"})
    outs = RK.collect(procs, 90)
    wall = time.monotonic() - t0
    assert procs[1].returncode == 17
    assert "[0] SURVIVOR-BLOCKING" in outs[0], outs[0][-4000:]
    assert procs[0].returncode == failure.HEARTBEAT_EXIT, outs[0][-4000:]
    assert re.search(r"peer process\(es\) \[1\] stopped heartbeating",
                     outs[0]), outs[0][-4000:]
    assert wall < 60, f"detection not bounded: {wall:.0f}s"


def test_live_processes_and_sweep(tmp_path):
    RK.run(tmp_path, _LIVE, "LIVE-PASS", timeout=90)


def test_preemption_sync_on_one_step(tmp_path):
    procs = RK.spawn(tmp_path, _PREEMPT)
    try:
        deadline = time.monotonic() + 60
        cues = [tmp_path / "loop0", tmp_path / "loop1"]
        while not all(c.exists() for c in cues):
            assert time.monotonic() < deadline, "workers never looped"
            assert all(p.poll() is None for p in procs), "a worker died"
            time.sleep(0.1)
        time.sleep(0.5)
        os.kill(procs[1].pid, signal.SIGTERM)
        outs = RK.collect(procs, 60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    steps = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid}:\n{out[-4000:]}"
        m = re.search(rf"\[{pid}\] PREEMPT-PASS step=(\d+)", out)
        assert m, out[-4000:]
        steps.append(int(m.group(1)))
    assert steps[0] == steps[1], f"ranks stopped at different steps: {steps}"


def test_multihost_capable_probe():
    from sherman_tpu_torch import multihost
    assert multihost.multihost_capable() == (True, "")


@pytest.mark.parametrize("bad", ["ten", "1.5"])
def test_heartbeat_knob_refused_with_the_reference_message(monkeypatch, bad):
    """A malformed ``SHERMAN_HEARTBEAT_S`` raises ConfigError with the
    reference's message, before any process group is opened."""
    from sherman_tpu.errors import ConfigError as JaxConfigError
    from sherman_tpu.parallel import bootstrap as JB

    from sherman_tpu_torch.errors import ConfigError
    from sherman_tpu_torch.parallel import bootstrap
    monkeypatch.setenv("SHERMAN_HEARTBEAT_S", bad)
    monkeypatch.delenv("SHERMAN_COORD", raising=False)
    with pytest.raises(ConfigError) as got:
        bootstrap.init_multihost()
    with pytest.raises(JaxConfigError) as want:
        JB.init_multihost()
    assert str(got.value) == str(want.value)


_BENCH = r'''
import signal, threading, time
from sherman_tpu_torch import benchmark
ck = os.path.join(tmp, "bench_preempt.npz")
if pid == 1:
    # the eviction notice lands on rank 1 only, a second into the run
    threading.Timer(6.0, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()
out = benchmark.main(["4", "50", "1", "--keys", "4000", "--secs", "60",
                      "--window", "1", "--ops-per-coro", "2",
                      "--preempt-ckpt", ck, "--device", "cpu"])
assert out["preempted"], out
assert os.path.exists(ck) and os.path.exists(ck + f".host{pid}.npz")
print(f"[{pid}] BENCH-PASS", flush=True)
'''


def test_benchmark_driver_across_ranks_preempts_together(tmp_path):
    """The benchmark driver on two ranks (the launcher's variables set):
    a SIGTERM on one rank stops both at one block boundary, and they
    write the collective checkpoint."""
    RK.run(tmp_path, _BENCH, "BENCH-PASS", timeout=120)
