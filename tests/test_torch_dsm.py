"""Port parity: the one-node DSM of ``sherman_tpu_torch.parallel.dsm``
against the JAX package's ``DSM`` (one node).

The same host-op sequence, made from seeded numpy, runs on both; after
every step the replies (data, old, ok), the pool, the lock table, the
counters and the dirty set must be equal.  The sequences include CAS
contention on one word within one step (one winner, the lowest request
index whose expected value matches), same-word FAA prefix values,
WRITE_WORD beating same-step CAS/FAA, masked ops, partial-page writes and
every refusal class (bad page, bad word offset, page spill, another
node, rows past the step capacity).  Every tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sherman_tpu.config import DSMConfig as JDSMConfig
from sherman_tpu.parallel import dsm as JD
from sherman_tpu_torch import config as C
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import ConfigError, ProtocolError
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import dsm as D

torch.set_num_threads(1)

P, L, CAP = 32, 64, 48
KW = dict(machine_nr=1, pages_per_node=P, locks_per_node=L,
          step_capacity=64, host_step_capacity=CAP, chunk_pages=8)


def _pair():
    return JD.DSM(JDSMConfig(**KW)), D.DSM(DSMConfig(device="cpu", **KW))


def _same_state(j, t, what):
    np.testing.assert_array_equal(t.pool.numpy(), np.asarray(j.pool),
                                  err_msg=what + " pool")
    np.testing.assert_array_equal(t.locks.numpy(), np.asarray(j.locks),
                                  err_msg=what + " locks")
    np.testing.assert_array_equal(t.counters_np(), np.asarray(j.counters),
                                  err_msg=what + " counters")
    assert t.counter_snapshot() == j.counter_snapshot(), what
    np.testing.assert_array_equal(t.dirty_rows(), j.dirty_rows(),
                                  err_msg=what + " dirty")


def _same_replies(rj, rt, what):
    for f in ("data", "old", "ok"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f),
                                      err_msg=f"{what} {f}")


def _both(j, t, rows, what):
    rj, rt = j._batch(rows), t._batch(rows)
    _same_replies(rj, rt, what)
    _same_state(j, t, what)
    return rt


def _rand_page(rng):
    return rng.integers(-2**31, 2**31, C.PAGE_WORDS,
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_page_writes_and_reads(seed):
    rng = np.random.default_rng(seed)
    j, t = _pair()
    addrs = [bits.make_addr(0, int(p)) for p in rng.permutation(P)[:6]]
    for a in addrs:
        pg = _rand_page(rng)
        j.write_page(a, pg)
        t.write_page(a, pg)
        _same_state(j, t, f"write_page {a}")
    np.testing.assert_array_equal(t.read_pages(addrs), j.read_pages(addrs))
    np.testing.assert_array_equal(t.read_page(addrs[0]),
                                  j.read_page(addrs[0]))
    assert t.read_word(addrs[1], 17) == j.read_word(addrs[1], 17)
    # partial writes at an offset, in one step
    rows = [{"op": D.OP_WRITE, "addr": addrs[2], "woff": 10, "nw": 5,
             "payload": rng.integers(0, 99, 5)},
            {"op": D.OP_WRITE, "addr": addrs[3], "woff": 0, "nw": 0,
             "payload": rng.integers(0, 99, 3)},
            {"op": D.OP_WRITE, "addr": addrs[4], "woff": 250, "nw": 6,
             "payload": rng.integers(0, 99, 6)}]
    j.write_rows(rows)
    t.write_rows(rows)
    _same_state(j, t, "write_rows")
    # a read in the same step as a write sees the pre-step page
    _both(j, t, [{"op": D.OP_WRITE, "addr": addrs[5], "woff": 0,
                  "nw": C.PAGE_WORDS, "payload": _rand_page(rng)},
                 {"op": D.OP_READ, "addr": addrs[5]}], "read vs write")


@pytest.mark.parametrize("space", [D.SPACE_POOL, D.SPACE_LOCK])
def test_cas_contention_one_winner_per_word(space):
    rng = np.random.default_rng(5 + space)
    j, t = _pair()
    a, b = bits.make_addr(0, 3), bits.make_addr(0, 7)
    w = 11 if space == D.SPACE_POOL else 0
    # 12 contenders on one word, all expecting 0, plus losers that
    # expect the wrong value, plus a second word with its own winner
    rows = []
    for i in range(12):
        rows.append({"op": D.OP_CAS, "addr": a, "woff": w, "arg0": 0,
                     "arg1": 100 + i, "space": space})
        rows.append({"op": D.OP_CAS, "addr": b, "woff": w,
                     "arg0": int(rng.integers(0, 2)), "arg1": 200 + i,
                     "space": space})
    rt = _both(j, t, rows, "cas contention")
    assert rt.ok[0::2].sum() == 1 and rt.ok[0]          # lowest index wins
    assert t.read_word(a, w, space) == j.read_word(a, w, space) == 100
    # the next step: expected values from the old replies
    rows = [{"op": D.OP_CAS, "addr": a, "woff": w, "arg0": 100,
             "arg1": 7, "space": space},
            {"op": D.OP_CAS, "addr": a, "woff": w, "arg0": 100,
             "arg1": 8, "space": space},
            {"op": D.OP_READ_WORD, "addr": a, "woff": w, "space": space}]
    _both(j, t, rows, "cas second round")
    old_t, ok_t = t.cas(a, w, 7, 9, space=space)
    old_j, ok_j = j.cas(a, w, 7, 9, space=space)
    assert (old_t, ok_t) == (old_j, ok_j) == (7, True)
    _same_state(j, t, "cas verb")


@pytest.mark.parametrize("space", [D.SPACE_POOL, D.SPACE_LOCK])
def test_faa_prefix_and_write_word_order(space):
    rng = np.random.default_rng(9 + space)
    j, t = _pair()
    a = bits.make_addr(0, 4)
    w = 30 if space == D.SPACE_POOL else 0
    deltas = rng.integers(-2**31, 2**31, 10, dtype=np.int64)
    deltas[:3] = [1, 2**31 - 1, 5]           # wraps through the sign bit
    rows = [{"op": D.OP_FAA, "addr": a, "woff": w, "arg0": int(d),
             "space": space} for d in deltas]
    rows += [{"op": D.OP_FAA, "addr": bits.make_addr(0, 9), "woff": w,
              "arg0": 3, "space": space}]
    rt = _both(j, t, rows, "faa prefix")
    # serial prefix: each FAA sees the sum of the earlier deltas
    want = np.cumsum(np.concatenate([[0], deltas[:-1]])).astype(np.int64)
    np.testing.assert_array_equal(rt.old[:10],
                                  (want & 0xFFFFFFFF).astype(np.uint32)
                                  .view(np.int32))
    # CAS, FAA and WRITE_WORD on one word in one step: CAS lands, FAAs add
    # to the post-CAS word, WRITE_WORD overwrites both
    cur = t.read_word(a, w, space)
    rows = [{"op": D.OP_WRITE_WORD, "addr": a, "woff": w, "arg1": 77,
             "space": space},
            {"op": D.OP_FAA, "addr": a, "woff": w, "arg0": 4,
             "space": space},
            {"op": D.OP_CAS, "addr": a, "woff": w, "arg0": cur,
             "arg1": 1000, "space": space},
            {"op": D.OP_FAA, "addr": a, "woff": w, "arg0": 6,
             "space": space}]
    rt = _both(j, t, rows, "cas/faa/write_word order")
    assert list(rt.old[[1, 3]]) == [1000, 1004]
    assert t.read_word(a, w, space) == 77


def test_masked_ops():
    j, t = _pair()
    a = bits.make_addr(0, 6)
    _both(j, t, [{"op": D.OP_WRITE_WORD, "addr": a, "woff": 2,
                  "arg1": 0x12345678}], "seed word")
    rows = [{"op": D.OP_MASKED_CAS, "addr": a, "woff": 2, "arg0": 0x5678,
             "arg1": 0x0042, "arg2": 0xFFFF},
            {"op": D.OP_MASKED_CAS, "addr": a, "woff": 2, "arg0": 0x5678,
             "arg1": 0x0043, "arg2": 0xFFFF},
            {"op": D.OP_MASKED_FAA, "addr": a, "woff": 3, "arg0": 0x10000,
             "arg2": 0xFFFF0000},
            {"op": D.OP_MASKED_FAA, "addr": a, "woff": 3, "arg0": 1,
             "arg2": 0xFFFF0000}]
    _both(j, t, rows, "masked ops")


def test_refusals_and_step_capacity():
    j, t = _pair()
    good = bits.make_addr(0, 2)
    rows = [{"op": D.OP_READ, "addr": bits.make_addr(0, P)},      # page
            {"op": D.OP_READ, "addr": bits.make_addr(1, 2)},      # node
            {"op": D.OP_READ_WORD, "addr": good, "woff": 256},    # word
            {"op": D.OP_WRITE, "addr": good, "woff": 200, "nw": 57,
             "payload": np.ones(57, np.int32)},                   # spill
            {"op": D.OP_CAS, "addr": bits.make_addr(0, L), "woff": 0,
             "arg0": 0, "arg1": 1, "space": D.SPACE_LOCK},        # lock idx
            {"op": D.OP_FAA, "addr": good, "woff": -1, "arg0": 1},
            {"op": D.OP_READ, "addr": good, "space": D.SPACE_LOCK},
            {"op": D.OP_READ, "addr": good}]
    rt = _both(j, t, rows, "refusals")
    assert not rt.ok[:7].any() and rt.ok[7]
    # a raw step with more active rows than the host capacity: the rows
    # past it are refused (the reference's bucket overflow)
    n = CAP + 10
    reqs = D.empty_requests(n)
    reqs["op"][:] = D.OP_FAA
    reqs["addr"][:] = bits.make_addr(0, 1)
    reqs["woff"][:] = np.arange(n) % 40
    reqs["arg0"][:] = 1
    reqs["op"][5] = D.OP_NOP
    rj, rt = j.step(reqs), t.step(reqs)
    _same_replies(rj, rt, "overflow")
    _same_state(j, t, "overflow")
    assert rt.ok[:CAP + 1].all() and not rt.ok[CAP + 1:].any()
    with pytest.raises(ProtocolError):
        t.read_page(bits.make_addr(0, P))


def test_long_batches_are_chunked_and_marked_dirty():
    rng = np.random.default_rng(3)
    j, t = _pair()
    rows = [{"op": D.OP_WRITE_WORD, "addr": bits.make_addr(0, int(p)),
             "woff": int(w), "arg1": int(v)}
            for p, w, v in zip(rng.integers(0, P, 130),
                               rng.integers(0, 256, 130),
                               rng.integers(-2**31, 2**31, 130))]
    _both(j, t, rows, "chunked")
    t.mark_dirty_rows([P - 1])
    j.mark_dirty_rows([P - 1])
    _same_state(j, t, "mark_dirty_rows")


def test_port_config_is_one_node_on_an_explicit_device():
    for bad in (0, 257):                 # the node field is 8 bits
        with pytest.raises(ConfigError, match="machine_nr"):
            DSMConfig(machine_nr=bad, device="cpu")
    assert DSMConfig(machine_nr=8, device="cpu").machine_nr == 8
    assert DSMConfig(machine_nr=256, device="cpu").machine_nr == 256
    with pytest.raises(ConfigError, match="device"):
        DSMConfig(device="tpu")
    assert DSMConfig().device == "cuda"
    if not torch.cuda.is_available():
        # the card is the default, and its absence is an error
        with pytest.raises(ConfigError, match="no CUDA device"):
            D.DSM(DSMConfig(pages_per_node=8, locks_per_node=8))


def _random_step(rng, n_nodes, rows, pages, locks):
    """Raw step requests drawn over a few words, so every op kind collides
    with every other in one step: reads, page writes (partial, spilling,
    empty), CAS / masked CAS / masked FAA racing on shared words, FAA
    chains, WRITE_WORD, READ_WORD, both spaces and an unknown one, bad
    pages, bad word offsets, other nodes and NOP gaps."""
    reqs = D.empty_requests(rows)
    op = rng.integers(0, 9, rows)
    space = rng.choice([D.SPACE_POOL, D.SPACE_LOCK, 2], rows,
                       p=[0.6, 0.35, 0.05])
    node = rng.integers(0, n_nodes + 1 if n_nodes > 1 else 2, rows)
    node = np.where(rng.random(rows) < 0.9, node % n_nodes, node)
    page = rng.choice([0, 1, 2, 3, pages - 1, pages, locks - 1, locks],
                      rows, p=[0.3, 0.25, 0.15, 0.1, 0.05, 0.05, 0.05, 0.05])
    woff = rng.choice([0, 1, 5, 255, 256, -1], rows,
                      p=[0.35, 0.3, 0.2, 0.05, 0.05, 0.05])
    reqs["op"][:] = op
    reqs["space"][:] = space
    reqs["addr"][:] = [bits.make_addr(int(d), int(p))
                       for d, p in zip(node, page)]
    reqs["woff"][:] = woff
    reqs["nw"][:] = rng.choice([0, 1, 3, 256, 300], rows)
    # small values, so expected values match often
    reqs["arg0"][:] = rng.integers(-2, 3, rows)
    reqs["arg1"][:] = rng.integers(-2**31, 2**31, rows, dtype=np.int64)
    reqs["arg2"][:] = rng.choice([0xFFFF, 0x0F0F0F0F, -1, 0], rows)
    reqs["payload"][:] = rng.integers(-2**31, 2**31, reqs["payload"].shape,
                                      dtype=np.int64).astype(np.int32)
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_raw_steps_match_jax(seed):
    """Seeded raw steps of every op kind colliding on a few words: the
    replies and the whole state equal the reference's after each step."""
    rng = np.random.default_rng(100 + seed)
    j, t = _pair()
    for s in range(12):
        reqs = _random_step(rng, 1, CAP + 8, P, L)
        rj, rt = j.step(reqs), t.step(reqs)
        _same_replies(rj, rt, f"seed {seed} step {s}")
        _same_state(j, t, f"seed {seed} step {s}")
