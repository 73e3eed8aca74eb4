"""Online scrubber — a periodic whole-pool integrity pass with quarantine
(counterpart of ``sherman_tpu/models/scrub.py``).

A :class:`Scrubber` runs the validator's per-page local predicates
(:func:`~sherman_tpu_torch.models.validate.scrub_pass`, the code the full
check uses) over the live pool between engine steps, on the pool's
device, and acts on what it finds:

- every violating page is **quarantined**: its global lock word is taken
  under the scrubber's own live lease, so no writer can touch the page
  (device inserts end in the typed lock-timeout status, host writers in
  the deadlock report) while reads keep flowing;
- a **structural** violation (torn page version pair, broken fence,
  unsorted internal page, broken B-link: ``validate.SCRUB_STRUCTURAL``)
  means the page cannot be trusted as a unit, and the engine flips to
  read-only degraded mode (:meth:`BatchedEngine.enter_degraded`);
- a quarantine that cannot take its lock (a live lease holds it and never
  drains) is a containment failure: the engine degrades as well.

Entry-level violations (a torn slot, an out-of-fence slot) stay
contained: the page is fenced off from writers and the engine keeps
serving.  The documented exit from degraded mode is TARGETED REPAIR
(:meth:`~sherman_tpu_torch.recovery.RecoveryPlane.targeted_repair`:
restore only the flagged pages from the checkpoint chain, re-certify
with a scrub pass, release the quarantine, leave degraded mode, replay
the op journal), with a full chain restore
(:meth:`~sherman_tpu_torch.recovery.RecoveryPlane.recover`) as the
fallback when the repair cannot re-certify.

Each pass runs in a ``scrub.pass`` span and counts ``scrub.passes``,
``scrub.pages_checked`` and ``scrub.violations``; ``scrub.quarantined``
gauges the held words, ``scrub.pages_quarantined`` counts them, and each
new violation and quarantine is a flight event.  Not here yet: the
leaf-cache invalidation of flagged pages (ROADMAP.md item 6a).
"""

from __future__ import annotations

from sherman_tpu_torch import obs
from sherman_tpu_torch.models.validate import (SCRUB_BITS, SCRUB_STRUCTURAL,
                                               scrub_pass)
from sherman_tpu_torch.parallel import dsm as D

# CAS attempts to take a violating page's lock word before the quarantine
# counts as failed (a legitimately held lock drains within a step or two;
# a word wedged by a live holder never does)
_QUARANTINE_TRIES = 8

_OBS_PASSES = obs.counter("scrub.passes")
_OBS_CHECKED = obs.counter("scrub.pages_checked")
_OBS_VIOLATIONS = obs.counter("scrub.violations")
_OBS_QUARANTINED = obs.gauge("scrub.quarantined")


class Scrubber:
    """Periodic data-plane integrity scrubbing over a BatchedEngine.

    Drivers call :meth:`tick` between engine steps (every
    ``interval``-th call runs a pass) or :meth:`scrub` directly.  The
    scrubber registers its own client, so its quarantine leases are live
    and lock-lease recovery never revokes them."""

    def __init__(self, engine, interval: int = 64,
                 quarantine: bool = True):
        self.eng = engine
        self.tree = engine.tree
        self.interval = max(1, int(interval))
        self.quarantine = quarantine
        self.ctx = self.tree.cluster.register_client(replicated=True)
        self._ticks = 0
        # addr -> violation mask of every page ever flagged; the lock words
        # this scrubber holds are kept apart, since two pages can hash onto
        # one word
        self.flagged: dict[int, int] = {}
        self._held_words: set[int] = set()

    # -- driving --------------------------------------------------------------

    def tick(self) -> dict | None:
        """Call between engine steps; runs a pass every ``interval`` calls
        and returns its result."""
        self._ticks += 1
        if self._ticks % self.interval == 0:
            return self.scrub()
        return None

    def scrub(self) -> dict:
        """One pass: check, quarantine new violations, degrade on
        structural damage or a failed containment.  -> {pages_checked,
        violations, bad, classes, new_violations, quarantined,
        degraded}."""
        with obs.span("scrub.pass"):
            res = scrub_pass(self.tree)
        _OBS_PASSES.inc()
        _OBS_CHECKED.inc(res["pages_checked"])
        # "new" = pages with violation bits not seen before, so a page
        # first flagged entry-level still escalates when a structural class
        # appears on it later
        new = [(a, mk) for a, mk in res["bad"]
               if mk & ~self.flagged.get(a, 0)]
        _OBS_VIOLATIONS.inc(len(new))
        for addr, mask in new:
            self.flagged[addr] = self.flagged.get(addr, 0) | mask
            obs.record_event("scrub.violation", addr=hex(addr),
                             mask=self._mask_names(mask),
                             structural=bool(mask & SCRUB_STRUCTURAL))
            # (the reference drops a flagged page's keys from its leaf
            # cache here: ROADMAP.md item 6a)
            contained = self._quarantine_page(addr) if self.quarantine \
                else False
            if mask & SCRUB_STRUCTURAL:
                self.eng.enter_degraded(
                    f"scrub: structural violation on page {addr:#x} "
                    f"(mask {self._mask_names(mask)})")
            elif self.quarantine and not contained:
                self.eng.enter_degraded(
                    f"scrub: page {addr:#x} violated "
                    f"({self._mask_names(mask)}) and quarantine could "
                    "not take its lock")
        _OBS_QUARANTINED.set(len(self._held_words))
        res["new_violations"] = len(new)
        res["quarantined"] = len(self._held_words)
        res["degraded"] = self.eng.degraded
        return res

    # -- quarantine -----------------------------------------------------------

    def _quarantine_page(self, addr: int) -> bool:
        """Fence writers off a violating page by holding its global lock
        word under the scrubber's live lease.  True when the word is held
        (newly, or already ours through a page sharing it)."""
        la = self.tree._lock_word_addr(addr)
        if la in self._held_words:
            return True
        for _ in range(_QUARANTINE_TRIES):
            old, won = self.tree.dsm.cas(la, 0, 0, self.ctx.lease,
                                         space=D.SPACE_LOCK)
            if won or old == self.ctx.lease:
                self._held_words.add(la)
                obs.counter("scrub.pages_quarantined").inc()
                obs.record_event("scrub.quarantine", addr=hex(addr),
                                 lock_word=int(la))
                return True
            # a dead holder (e.g. the fault that corrupted the page also
            # wedged its lock) is revoked, then the word is taken again
            self.tree._try_revoke_lease(la, old)
        return False

    def damaged_addrs(self) -> list[int]:
        """Every page address this scrubber has flagged: the repair's
        input set."""
        return sorted(self.flagged)

    def release_quarantine(self) -> int:
        """Drop every quarantine lock (only after repair and validation).
        -> words freed."""
        n = 0
        for la in sorted(self._held_words):
            self.tree.dsm.write_word(la, 0, 0, space=D.SPACE_LOCK)
            n += 1
        self._held_words.clear()
        self.flagged.clear()
        _OBS_QUARANTINED.set(0)
        return n

    @staticmethod
    def _mask_names(mask: int) -> str:
        return "|".join(n for n, b in SCRUB_BITS.items() if mask & b) \
            or hex(mask)
