"""Deterministic data-plane fault injection (counterpart of the data-plane
part of ``sherman_tpu/chaos.py``).

A seedable :class:`FaultPlan` is installed on the DSM
(``DSM.install_chaos``, or ``SHERMAN_CHAOS`` at construction) and fired at
the host-step boundary, under the step mutex (``DSM.step``, the single
injection hook).  It can

- **corrupt pool words**: tear a page's front/rear version pair
  (``torn_page``) or flip one half of a leaf slot's packed fver/rver pair
  (``flip_entry_ver``), the torn-read classes a legal write cannot leave
  behind; the online scrubber (``models/scrub.py``) must catch both;
- **wedge a lock word** as held by a dead client (``wedge_lock``): a lease
  no live client owns, which the lock paths must revoke instead of
  spinning on it;
- **drop a step's CAS winners** (``drop_cas``): every CAS and masked-CAS
  request of the step has its expectation perturbed so it loses honestly;
- **serve stale page reads** (``stale_read``): the step's page reads
  answer from a pool snapshot taken at the plan's first step.

State faults (torn, flip, wedge) record the words they overwrite, so
:meth:`FaultPlan.undo` can restore them.  Pokes write the pool or lock
tensor in place, on its device, and mark no page dirty.

Determinism: everything derives from the plan and, for ``random`` plans,
its seed; the step index counts ``DSM.step`` calls since installation.
``SHERMAN_CHAOS`` is a JSON list of fault dicts (``[{"kind":
"wedge_lock", "step": 2, "addr": 5}]``) or ``random:SEED[:N]``.

Every fired fault counts in ``chaos.faults_injected`` and
``chaos.<kind>`` and is a ``chaos.inject`` flight event, so a drill's
black box shows what was injected before what was detected.

**The replication fault layer.**  The ``repl_*`` kinds perturb the
replication plane's two message boundaries instead of pool state: the
journal-shipping tail a follower polls, and the lease-table view the
primary's durability fence reads (``replica.py``):

- ``repl_drop``: a poll's fetch is lost; the follower sees no new bytes
  this round (offset untouched, the next poll retries);
- ``repl_delay``: shipped bytes are in flight; the same observable as a
  drop in the pull model, counted apart;
- ``repl_reorder``: two chunks of the fetched byte view are swapped; the
  per-frame CRC must refuse it and the follower retry a clean view;
- ``repl_partition``: the follower (scope ``"ship"``) cannot reach the
  journal, and/or the primary (scope ``"lease"``) sees a frozen copy of
  the lease table, so it cannot watch its own epoch get bumped;
- ``repl_slow``: the follower's poll stalls ``ms`` before it fetches.

View faults never touch the journal file: they perturb one poll's read
of it.  ``ReplFault`` windows run on the layer's replication clock (one
tick a tailer poll across the group), so the same seed over the same
poll sequence fires the same faults; drills open partitions by hand
with :meth:`ReplChaos.hold` / :meth:`ReplChaos.heal`.  A plan's
``repl_*`` faults go to :meth:`FaultPlan.repl_layer`, not the DSM hook.
Counters ride ``chaos.repl_*``; every window start is a
``chaos.repl_inject`` flight event.

Not here yet: the host fault layer (``host_*``, ``HostChaos``), which
perturbs the multihost service plane's dispatch seam and host leases
(ROADMAP.md item 7c-iii, host failover).  A plan naming one of its kinds
raises :class:`NotPortedError`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError, NotPortedError
from sherman_tpu_torch.ops import bits

KINDS = ("torn_page", "flip_entry_ver", "wedge_lock", "drop_cas",
         "stale_read")
REPL_KINDS = ("repl_drop", "repl_delay", "repl_reorder", "repl_partition",
              "repl_slow")
# the kinds of the host layer, not ported yet
_LATER_KINDS = ("host_crash", "host_freeze", "host_zombie")

_OBS = {k: obs.counter(f"chaos.{k}") for k in KINDS}
_OBS_TOTAL = obs.counter("chaos.faults_injected")
_OBS_REPL = {k: obs.counter(f"chaos.{k}") for k in REPL_KINDS}
_OBS_REPL_TOTAL = obs.counter("chaos.repl_faults_injected")
_OBS_REPL_DETECTED = obs.counter("chaos.repl_detected")

# a lease word no live client can own: an unregistered owner tag and an
# epoch far from any real client's generation
DEAD_OWNER_TAG = 0xDEAD
DEAD_OWNER_EPOCH = 0x5A


def _refuse_later_kind(kind) -> None:
    if kind in _LATER_KINDS:
        raise NotPortedError(
            f"fault kind {kind!r} perturbs the multihost service plane "
            "(HostChaos), which the port does not have yet (ROADMAP.md "
            "item 7c-iii, host failover)")


@dataclasses.dataclass
class Fault:
    """One scheduled fault.  ``step`` is the host-step index (count of
    ``DSM.step`` calls after plan installation) at which it fires; a fault
    whose step has passed fires on the next step.  ``addr`` is a packed
    pool-page address (torn/flip) or a lock-space address
    ``make_addr(node, lock_index)`` (wedge); ``addr=-1`` picks a live page
    or a lock word from the plan's RNG at fire time, and a deferred
    corruption that finds no live page stays pending."""

    kind: str
    step: int = 0
    addr: int = -1
    slot: int = 0                  # flip_entry_ver: leaf slot
    owner: int = DEAD_OWNER_TAG    # wedge_lock: lease owner tag
    epoch: int = DEAD_OWNER_EPOCH  # wedge_lock: lease epoch
    fired: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        _refuse_later_kind(self.kind)
        if self.kind not in KINDS:
            raise ConfigError(f"unknown fault kind {self.kind!r}; "
                              f"want one of {KINDS}")


@dataclasses.dataclass
class ReplFault:
    """One scheduled replication fault.  ``poll`` is the window start on
    the layer's replication clock (one tick a tailer poll across the
    group), ``span`` the window length in ticks.  ``follower`` limits a
    ship-side fault to one follower index (-1 = all).  ``ms`` is the stall
    a poll of ``repl_slow``.  ``scope`` applies to ``repl_partition``
    only: ``"ship"`` cuts the follower's view of the journal tail,
    ``"lease"`` freezes the primary's view of the lease table, ``"both"``
    does both."""

    kind: str
    poll: int = 0
    span: int = 1
    follower: int = -1
    ms: float = 2.0
    scope: str = "ship"
    fired: bool = dataclasses.field(default=False, compare=False)

    def __post_init__(self):
        _refuse_later_kind(self.kind)
        if self.kind not in REPL_KINDS:
            raise ConfigError(f"unknown repl fault kind {self.kind!r}; "
                              f"want one of {REPL_KINDS}")
        if self.scope not in ("ship", "lease", "both"):
            raise ConfigError(f"repl fault scope {self.scope!r}: want "
                              "'ship', 'lease' or 'both'")
        if self.span < 1:
            raise ConfigError(f"repl fault span {self.span}: want >= 1")


class ReplChaos:
    """The replication fault layer a :class:`FaultPlan` exposes.

    Attached to a ``ReplicaGroup`` (``group.attach_chaos``): the journal
    tailer asks :meth:`on_poll` for the poll's directives and routes the
    fetched bytes through :meth:`view` when told to reorder; the primary's
    durability fence reads the lease table through :meth:`lease_view`.
    Deterministic in (plan, seed, poll sequence).  Scheduled windows and
    the manual :meth:`hold`/:meth:`heal` compose."""

    def __init__(self, faults, seed: int = 0):
        self.faults = [f if isinstance(f, ReplFault) else ReplFault(**f)
                       for f in faults]
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed ^ 0x5EA1)
        self._clock = 0             # replication time: one tick a poll
        self._held: set[str] = set()
        self._lease_frozen = None   # the snapshot while a lease cut lasts
        self.injected = 0
        self.detected = 0

    @classmethod
    def storm(cls, seed: int, n_faults: int = 8, poll_hi: int = 24,
              span_hi: int = 4, followers: int = 2,
              kinds=REPL_KINDS) -> "ReplChaos":
        """Seeded random storm over the shipping tail: windows of drop,
        delay, reorder, partition and slow over ``poll_hi`` ticks.  Ship
        scope only: lease cuts change who may ack and belong to the
        drills' manual holds."""
        rng = np.random.default_rng(int(seed))
        faults = [ReplFault(
            kind=str(rng.choice(list(kinds))),
            poll=int(rng.integers(0, max(poll_hi, 1))),
            span=1 + int(rng.integers(0, max(span_hi, 1))),
            follower=int(rng.integers(-1, max(followers, 1))),
            ms=float(rng.integers(1, 4)))
            for _ in range(n_faults)]
        return cls(faults, seed=seed)

    # -- scheduling -----------------------------------------------------------

    def _active(self, t: int, follower: int, side: str):
        """Faults whose window covers tick ``t`` for this follower and
        boundary (``side`` in {"ship", "lease"})."""
        out = []
        for f in self.faults:
            if not (f.poll <= t < f.poll + f.span):
                continue
            if side == "lease":
                if f.kind == "repl_partition" and f.scope in ("lease",
                                                             "both"):
                    out.append(f)
                continue
            if f.kind == "repl_partition" and f.scope == "lease":
                continue
            if f.follower not in (-1, follower):
                continue
            out.append(f)
        return out

    def _fire(self, f: ReplFault, t: int) -> None:
        if f.fired:
            return
        f.fired = True
        self.injected += 1
        _OBS_REPL_TOTAL.inc()
        _OBS_REPL[f.kind].inc()
        obs.record_event("chaos.repl_inject", fault=f.kind, poll=t,
                         span=int(f.span), follower=int(f.follower),
                         scope=f.scope)

    # -- the tailer hook (journal-shipping boundary) --------------------------

    def on_poll(self, follower: int = 0) -> dict | None:
        """Directives for this poll of ``follower``'s tailer, or None when
        nothing is active.  Ticks the replication clock."""
        t = self._clock
        self._clock += 1
        live = self._active(t, follower, "ship")
        held = "ship" in self._held or "both" in self._held
        if not live and not held:
            return None
        d = {"drop": False, "freeze": False, "reorder": False,
             "partition": held, "slow_ms": 0.0}
        for f in live:
            self._fire(f, t)
            if f.kind == "repl_drop":
                d["drop"] = True
            elif f.kind == "repl_delay":
                d["freeze"] = True
            elif f.kind == "repl_reorder":
                d["reorder"] = True
            elif f.kind == "repl_partition":
                d["partition"] = True
            else:  # repl_slow
                d["slow_ms"] = max(d["slow_ms"], float(f.ms))
        return d

    def view(self, blob: bytes) -> bytes:
        """The reorder perturbation: swap two chunks of one poll's fetched
        byte view (the file is never touched); too short to swap, flip one
        bit."""
        n = len(blob)
        b = bytearray(blob)
        if n < 48:
            if n:
                b[n // 2] ^= 0x01
            return bytes(b)
        ch = 16
        i = int(self._rng.integers(0, n - 2 * ch))
        j = int(self._rng.integers(i + ch, n - ch + 1))
        b[i:i + ch], b[j:j + ch] = b[j:j + ch], b[i:i + ch]
        if bytes(b) == blob:          # identical chunks: force a change
            b[i] ^= 0x01
        return bytes(b)

    def note_detected(self) -> None:
        """A perturbed view was refused: the detection half of an
        injection."""
        self.detected += 1
        _OBS_REPL_DETECTED.inc()

    # -- the fence hook (lease-table boundary) --------------------------------

    def lease_view(self, epochs: dict) -> dict:
        """The lease table as the primary's durability fence sees it.
        While a lease-scope partition is active the view stays frozen at
        the cut's first observation; healing restores the live table."""
        t = self._clock
        active = ("lease" in self._held or "both" in self._held
                  or bool(self._active(t, -1, "lease")))
        if not active:
            self._lease_frozen = None
            return epochs
        for f in self._active(t, -1, "lease"):
            self._fire(f, t)
        if self._lease_frozen is None:
            self._lease_frozen = dict(epochs)
        return self._lease_frozen

    # -- manual partition control (drills) ------------------------------------

    def hold(self, scope: str = "both") -> None:
        """Open a partition by hand (``scope`` in ship/lease/both) until
        :meth:`heal`; counted and recorded like a scheduled window."""
        if scope not in ("ship", "lease", "both"):
            raise ConfigError(f"hold scope {scope!r}: want 'ship', "
                              "'lease' or 'both'")
        self._held.add(scope)
        self.injected += 1
        _OBS_REPL_TOTAL.inc()
        _OBS_REPL["repl_partition"].inc()
        obs.record_event("chaos.repl_inject", fault="repl_partition",
                         poll=self._clock, span=-1, follower=-1,
                         scope=scope)

    def heal(self) -> None:
        """Close every manual partition."""
        self._held.clear()
        self._lease_frozen = None
        obs.record_event("chaos.repl_heal", poll=self._clock)

    @property
    def exhausted(self) -> bool:
        """Every scheduled window has passed and no hold is open."""
        return not self._held and all(
            f.poll + f.span <= self._clock for f in self.faults)

    def describe(self) -> list[dict]:
        return [{"kind": f.kind, "poll": f.poll, "span": f.span,
                 "follower": f.follower, "scope": f.scope,
                 "fired": f.fired} for f in self.faults]


class FaultPlan:
    """A deterministic schedule of data-plane faults over one DSM.
    ``repl_*`` kinds in the same grammar are split out into the
    replication layer (:meth:`repl_layer`) instead of the DSM hook."""

    def __init__(self, faults, seed: int = 0):
        self.faults = []
        repl = []
        for f in faults:
            if isinstance(f, ReplFault):
                repl.append(f)
            elif isinstance(f, Fault):
                self.faults.append(f)
            elif isinstance(f, dict) and f.get("kind") in REPL_KINDS:
                repl.append(ReplFault(**f))
            else:
                _refuse_later_kind(f.get("kind"))
                self.faults.append(Fault(**f))
        self.seed = int(seed)
        self.repl_faults = repl
        self._repl_layer: ReplChaos | None = None
        self._rng = np.random.default_rng(self.seed)
        self._steps = 0
        self._undo: list = []       # (space, row, col, old, injected)
        self._stale_pool = None     # host snapshot for stale_read
        self.injected = 0

    def repl_layer(self) -> "ReplChaos | None":
        """The plan's replication fault layer (None when the plan has no
        ``repl_*`` faults), built once and shared, so the replication
        clock is group-global."""
        if self._repl_layer is None and self.repl_faults:
            self._repl_layer = ReplChaos(self.repl_faults, seed=self.seed)
        return self._repl_layer

    # -- construction ---------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``SHERMAN_CHAOS`` grammar: a JSON list of fault dicts, or
        ``random:SEED[:N]``."""
        spec = spec.strip()
        if spec.startswith("["):
            return cls(json.loads(spec))
        if spec.startswith("random"):
            parts = spec.split(":")
            seed = int(parts[1]) if len(parts) > 1 else 0
            n = int(parts[2]) if len(parts) > 2 else 3
            return cls.random(seed, n_faults=n)
        raise ConfigError(
            f"SHERMAN_CHAOS={spec!r}: want a JSON fault list or "
            "'random:SEED[:N]'")

    @classmethod
    def from_env(cls, env: str = "SHERMAN_CHAOS") -> "FaultPlan | None":
        spec = os.environ.get(env)
        return cls.parse(spec) if spec else None

    @classmethod
    def random(cls, seed: int, n_faults: int = 3, step_lo: int = 0,
               step_hi: int = 8, kinds=("torn_page", "flip_entry_ver",
                                        "wedge_lock")) -> "FaultPlan":
        """Seeded random plan with deferred targets (``addr=-1``): the same
        seed over the same state sequence lands on the same words.  The
        default kinds are the persistent corruptions whose detection the
        chaos fuzz asserts."""
        rng = np.random.default_rng(int(seed))
        faults = [Fault(kind=str(rng.choice(list(kinds))),
                        step=int(rng.integers(step_lo, max(step_hi, 1))),
                        slot=int(rng.integers(0, C.LEAF_CAP)))
                  for _ in range(n_faults)]
        return cls(faults, seed=seed)

    @classmethod
    def storm(cls, seed: int, n_faults: int = 6, step_hi: int = 32
              ) -> "FaultPlan":
        """Seeded serving-storm plan: the persistent corruptions and the
        transient reply faults (``drop_cas``/``stale_read``) over a wider
        step range."""
        return cls.random(seed, n_faults=n_faults, step_hi=step_hi,
                          kinds=KINDS)

    # -- the DSM hook (called under the DSM step mutex) -----------------------

    def on_step(self, dsm, reqs):
        """Fire every due fault -> (reqs, post): ``post`` is truthy when
        :meth:`on_replies` must rewrite this step's replies (stale_read)."""
        step = self._steps
        self._steps += 1
        post = False
        # arm the stale snapshot at the plan's first step, so a stale reply
        # reaches back at least one mutation; a copy, since a CPU pool's
        # numpy view would follow the live pool
        if self._stale_pool is None and any(
                f.kind == "stale_read" and not f.fired
                for f in self.faults):
            self._stale_pool = dsm.pool.cpu().numpy().copy()
        for f in self.faults:
            if f.fired or f.step > step:
                continue
            if f.kind == "torn_page":
                landed = self._torn_page(dsm, f)
            elif f.kind == "flip_entry_ver":
                landed = self._flip_entry_ver(dsm, f)
            elif f.kind == "wedge_lock":
                self._wedge_lock(dsm, f)
                landed = True
            elif f.kind == "drop_cas":
                reqs = self._drop_cas(reqs)
                landed = True
            else:  # stale_read: the snapshot was armed at the first step
                post = True
                landed = True
            if not landed:
                continue  # nothing live to corrupt yet: defer the fault
            f.fired = True
            self.injected += 1
            _OBS_TOTAL.inc()
            _OBS[f.kind].inc()
            obs.record_event("chaos.inject", fault=f.kind, step=step,
                             addr=int(f.addr), slot=int(f.slot))
        return reqs, post

    def on_replies(self, dsm, reqs, rep):
        """stale_read: answer this step's page reads from the snapshot."""
        from sherman_tpu_torch.parallel import dsm as D
        P = self._stale_pool.shape[0] // dsm.cfg.machine_nr
        op = np.asarray(reqs["op"]).reshape(-1)
        addr = np.asarray(reqs["addr"]).reshape(-1)
        data = np.array(rep.data)
        for i in np.nonzero(op == D.OP_READ)[0]:
            row = (bits.addr_node(int(addr[i])) * P
                   + bits.addr_page(int(addr[i])))
            if 0 <= row < self._stale_pool.shape[0]:
                data[i] = self._stale_pool[row]
        return D.Replies(data=data, old=rep.old, ok=rep.ok)

    # -- fault bodies ---------------------------------------------------------

    def _pick_live_page(self, dsm) -> int:
        """A deferred target: a live, non-retired, non-meta page drawn from
        the plan RNG (0 when there is none)."""
        cols = dsm.pool[:, [C.W_FRONT_VER, C.W_HIGH_HI, C.W_HIGH_LO]]
        fv, hi, lo = cols.cpu().numpy().T
        P = fv.shape[0] // dsm.cfg.machine_nr
        rows = np.nonzero((fv != 0) & ~((hi == 0) & (lo == 0))
                          & (np.arange(fv.shape[0]) % P != 0))[0]
        if rows.size == 0:
            return 0
        r = int(rows[int(self._rng.integers(0, rows.size))])
        return bits.make_addr(r // P, r % P)

    def _poke_pool(self, dsm, row: int, col: int, value: int) -> None:
        old = int(dsm.pool[row, col])
        self._undo.append(("pool", row, col, old, int(np.int32(value))))
        dsm.pool[row, col] = int(np.int32(value))

    def _poke_lock(self, dsm, row: int, value: int) -> None:
        old = int(dsm.locks[row])
        self._undo.append(("lock", row, 0, old, int(np.int32(value))))
        dsm.locks[row] = int(np.int32(value))

    def _pool_row(self, dsm, addr: int) -> int:
        return (bits.addr_node(addr) * dsm.cfg.pages_per_node
                + bits.addr_page(addr))

    def _torn_page(self, dsm, f: Fault) -> bool:
        """rear := front + 1, the mid-write state a torn read would see.
        False when a deferred target found no live page yet."""
        addr = f.addr if f.addr != -1 else self._pick_live_page(dsm)
        if addr == 0:
            return False
        row = self._pool_row(dsm, addr)
        front = int(dsm.pool[row, C.W_FRONT_VER])
        self._poke_pool(dsm, row, C.W_REAR_VER, (front + 1) & 0x7FFFFFFF)
        return True

    def _flip_entry_ver(self, dsm, f: Fault) -> bool:
        """Flip the fver half of a leaf slot's packed version pair (bit
        16).  False when a deferred target found no live page yet."""
        addr = f.addr if f.addr != -1 else self._pick_live_page(dsm)
        if addr == 0:
            return False
        row = self._pool_row(dsm, addr)
        col = C.L_VER_W + (int(f.slot) % C.LEAF_CAP)
        old = int(dsm.pool[row, col])
        self._poke_pool(dsm, row, col, old ^ (1 << 16))
        return True

    def _wedge_lock(self, dsm, f: Fault) -> None:
        """Hold a lock word under a lease no live registration owns;
        ``addr`` addresses the lock space, -1 draws a word."""
        L = dsm.cfg.locks_per_node
        if f.addr != -1:
            row = bits.addr_node(f.addr) * L + bits.addr_page(f.addr)
        else:
            row = int(self._rng.integers(0, dsm.cfg.machine_nr * L))
        self._poke_lock(dsm, row,
                        bits.lease_word(f.owner or DEAD_OWNER_TAG, f.epoch))

    @staticmethod
    def _drop_cas(reqs):
        """Perturb every CAS/masked-CAS expectation of this step so the op
        loses honestly (ok=0)."""
        from sherman_tpu_torch.parallel import dsm as D
        reqs = dict(reqs)
        op = np.asarray(reqs["op"])
        arg0 = np.array(reqs["arg0"], np.int32, copy=True)
        arg2 = np.asarray(reqs["arg2"])
        cas = op == D.OP_CAS
        arg0[cas] ^= np.int32(0x40000000)
        mcas = op == D.OP_MASKED_CAS
        # flip the masked bits of the expectation (mask 0 has no winner to
        # drop anyway)
        arg0[mcas] ^= arg2[mcas]
        reqs["arg0"] = arg0
        return reqs

    # -- repair / bookkeeping -------------------------------------------------

    def undo(self, dsm) -> int:
        """Restore every corrupted word, newest first.  A word that no
        longer holds the injected value was rewritten legally since (a
        split rebuilt the page, a client took the lock), so it is left as
        it is.  -> words restored.  drop_cas and stale_read perturbed
        replies, not state, and have nothing to undo."""
        n = 0
        for space, row, col, old, injected in reversed(self._undo):
            if space == "pool":
                if int(dsm.pool[row, col]) != injected:
                    continue
                dsm.pool[row, col] = old
            else:
                if int(dsm.locks[row]) != injected:
                    continue
                dsm.locks[row] = old
            n += 1
        self._undo.clear()
        return n

    def corrupted_pool_rows(self) -> list[int]:
        """Global pool rows of every pool word this plan corrupted and has
        not undone (convert with :meth:`rows_to_addrs`)."""
        return sorted({row for space, row, *_ in self._undo
                       if space == "pool"})

    @staticmethod
    def rows_to_addrs(rows, pages_per_node: int) -> list[int]:
        """Global pool rows -> packed page addresses."""
        return [bits.make_addr(int(r) // pages_per_node,
                               int(r) % pages_per_node) for r in rows]

    @property
    def exhausted(self) -> bool:
        """Every data-plane fault has fired (repl windows are judged by
        :attr:`ReplChaos.exhausted` on the layer's own clock)."""
        return all(f.fired for f in self.faults)

    def describe(self) -> list[dict]:
        out = [{"kind": f.kind, "step": f.step, "addr": f.addr,
                "fired": f.fired} for f in self.faults]
        if self._repl_layer is not None:
            out.extend(self._repl_layer.describe())
        else:
            out.extend({"kind": f.kind, "poll": f.poll, "span": f.span,
                        "follower": f.follower, "scope": f.scope,
                        "fired": f.fired} for f in self.repl_faults)
        return out
