"""The comparison that decides ``correct``: the answers the run kept
(every warm-up batch's, a share of the window's batches drawn from the
seed, every read-back) against the plain reference
(``portbench/reference/kv.py``), which replays every batch sent, in
order.  One number is compared, ``wrong_answers``, with the limit 0: the
sum of

- ``wrong_reads``: reads not ``found``, or answering a value the key
  neither held before the batch nor was given by the batch's applied
  update of it;
- ``wrong_acks``: updates acknowledged otherwise than the configuration
  states: the first of a key in a batch ``APPLIED``, the later
  ``SUPERSEDED`` (a lock timeout is a refusal: it counts under
  ``failed``, not here, and ``ops_s`` leaves it out);
- ``lost_updates``: keys updated during the run whose value, read back
  through the cell's entry after the window, is not the key's latest;
- ``unanswered``: the ops of a call into the program that raised (the
  run stops sending there).

The parts go to the log.  The readings the limit was set from are in
PERF.md.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import kv

PARTS = ("wrong_reads", "wrong_acks", "lost_updates", "unanswered")
LIMIT = 0


class Checker:
    def __init__(self, values: np.ndarray, ring, entry: str):
        self.ref = kv.KVReference(values)
        self.ring = ring
        self.entry = entry
        self.n = dict.fromkeys(PARTS, 0)
        self.answers = 0
        self.batches = 0            # batches whose answers were checked
        self.multi_applied = 0      # later duplicates acknowledged APPLIED
        self._expect = {}

    def _read_expect(self, slot):
        """Read-only traffic: one slot's expected values (the table does
        not move)."""
        e = self._expect.get(slot)
        if e is None:
            e = self._expect[slot] = self.ref.read(self.ring[slot].ranks)
        return e

    def batch(self, slot: int, out, refused=()) -> None:
        """One batch sent, in order; ``out`` its kept answers or None
        (then ``refused``: the op indices it had refused)."""
        b = self.ring[slot]
        if out is None:
            if self.entry == "mixed":
                self.ref.apply_batch(b.ranks, b.is_read, b.values, refused)
            return
        if self.entry == "read":
            vals, found = out
            self.n["wrong_reads"] += int(np.count_nonzero(
                ~found | (vals != self._read_expect(slot))))
        else:
            c = self.ref.check_batch(b.ranks, b.is_read, b.values, *out)
            for k in ("wrong_reads", "wrong_acks"):
                self.n[k] += c[k]
            self.multi_applied += c["multi_applied"]
        self.answers += b.n
        self.batches += 1

    def written_ranks(self, sent) -> np.ndarray:
        """Every rank an update of the sent batches touched."""
        if self.entry == "read" or not sent:
            return np.zeros(0, np.int64)
        return kv.unique_sorted(np.concatenate(
            [self.ring[s].ranks[~self.ring[s].is_read] for s in set(sent)]))

    def readback(self, ranks, vals, found) -> None:
        self.n["lost_updates"] += self.ref.check_readback(ranks, vals, found)
        self.answers += ranks.shape[0]

    def numbers(self) -> dict:
        return {"wrong_answers": {"value": sum(self.n.values()),
                                  "limit": LIMIT}}

    def correct(self) -> bool:
        return sum(self.n.values()) <= LIMIT
