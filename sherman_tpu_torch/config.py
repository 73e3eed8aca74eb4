"""Configuration of the PyTorch/CUDA port: page layout constants and the
cluster/tree configs (counterpart of ``sherman_tpu/config.py``).

The layout constants are copied unchanged, so a pool built by either
package is byte-identical: 1 KB pages of 256 int32 words, 64-bit keys and
values as (hi, lo) int32 pairs, packed 32-bit page addresses
{node:8, page:24}.
"""

from __future__ import annotations

import dataclasses
import os

from sherman_tpu_torch.errors import ConfigError

# ---------------------------------------------------------------------------
# Word / page geometry.
# ---------------------------------------------------------------------------

PAGE_BYTES = 1024
PAGE_WORDS = PAGE_BYTES // 4  # 256 int32 words per page

ADDR_NODE_BITS = 8
ADDR_PAGE_BITS = 24
ADDR_PAGE_MASK = (1 << ADDR_PAGE_BITS) - 1
MAX_MACHINE = 1 << ADDR_NODE_BITS

# Meta words inside the reserved page 0 of node 0 (the root pointer).
META_ROOT_ADDR_W = 0


@dataclasses.dataclass(frozen=True)
class DSMConfig:
    """Cluster + memory-pool shape.  ``machine_nr`` nodes live on one
    card, each a node-major block of the cluster's tensors (the layout of
    the reference's global arrays); ``device`` is where every tensor
    lives.  The card is the default: only the tests pass
    ``device="cpu"``."""

    machine_nr: int = 1
    pages_per_node: int = 4096
    locks_per_node: int = 16384
    step_capacity: int = 512
    host_step_capacity: int = 64
    chunk_pages: int = 256
    # The out-of-line value heap (models/value_heap.py): a second region
    # of this many 1 KB pages a node, carved into size-class slabs of
    # variable-length payloads; leaf values then hold versioned handles.
    # 0 (default) = no heap, inline 64-bit values.
    heap_pages_per_node: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if not 1 <= self.machine_nr <= MAX_MACHINE:
            raise ConfigError(
                f"DSMConfig.machine_nr={self.machine_nr}: want "
                f"1..{MAX_MACHINE} (the node field of an address is "
                f"{ADDR_NODE_BITS} bits)")
        if not 1 <= self.pages_per_node <= (1 << ADDR_PAGE_BITS):
            raise ConfigError(
                f"DSMConfig.pages_per_node={self.pages_per_node}: want "
                f"1..{1 << ADDR_PAGE_BITS}")
        if self.pages_per_node * PAGE_WORDS >= (1 << 31):
            raise ConfigError(
                f"DSMConfig.pages_per_node={self.pages_per_node} exceeds "
                "the 8 GB per-node pool limit (int32 word addressing)")
        if self.locks_per_node < 1 or self.step_capacity < 1 \
                or self.host_step_capacity < 1 or self.chunk_pages < 1:
            raise ConfigError("DSMConfig sizes must be >= 1")
        if not 0 <= self.heap_pages_per_node <= (1 << ADDR_PAGE_BITS):
            raise ConfigError(
                f"DSMConfig.heap_pages_per_node={self.heap_pages_per_node}:"
                f" want 0..{1 << ADDR_PAGE_BITS}")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ConfigError(
                f"DSMConfig.device={self.device!r}: want 'cuda' (default), "
                "'cuda:N' or 'cpu'")

    def torch_device(self):
        """The ``torch.device`` every tensor of this cluster lives on.
        Raises when the card was asked for and none is present: the
        port never carries on quietly on the CPU."""
        import torch
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise ConfigError(
                f"DSMConfig.device={self.device!r} but no CUDA device is "
                "present: run on the GPU, or pass device='cpu' explicitly "
                "(the tests do)")
        return dev


# ---------------------------------------------------------------------------
# B+Tree page layout (word offsets inside a 256-word page), struct-of-
# arrays entry blocks — identical to sherman_tpu/config.py.
# ---------------------------------------------------------------------------

W_FRONT_VER = 0
W_LEFTMOST = 1
W_SIBLING = 2
W_LEVEL = 3
W_NKEYS = 4
W_LOW_HI = 5
W_LOW_LO = 6
W_HIGH_HI = 7
W_HIGH_LO = 8
W_ENTRIES = 9
W_REAR_VER = PAGE_WORDS - 1

ENTRY_WORDS_AVAIL = W_REAR_VER - W_ENTRIES  # 246

INTERNAL_ENTRY_WORDS = 3
LEAF_ENTRY_WORDS = 5

INTERNAL_CAP = ENTRY_WORDS_AVAIL // INTERNAL_ENTRY_WORDS  # 82
LEAF_CAP = ENTRY_WORDS_AVAIL // LEAF_ENTRY_WORDS          # 49

I_KHI_W = W_ENTRIES
I_KLO_W = I_KHI_W + INTERNAL_CAP
I_PTR_W = I_KLO_W + INTERNAL_CAP

L_VER_W = W_ENTRIES
L_KHI_W = L_VER_W + LEAF_CAP
L_KLO_W = L_KHI_W + LEAF_CAP
L_VHI_W = L_KLO_W + LEAF_CAP
L_VLO_W = L_VHI_W + LEAF_CAP

ENTRY_VER_MASK = 0xFFFF

KEY_NEG_INF = 0
KEY_POS_INF = (1 << 64) - 1
KEY_MIN = 1
KEY_MAX = KEY_POS_INF - 1


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Tree-level knobs of the batched engine."""

    # Max tree height the batched descents loop over.
    max_level: int = 8
    # Extra descent iterations budgeted for B-link sibling chases per op.
    sibling_chase_budget: int = 4
    # Rounds of the engine's insert retry loop before the host path (the
    # loop runs on while rounds make progress, up to 16x this).
    insert_rounds: int = 16
    # Bulk-load leaf fill fraction.
    bulk_fill: float = 0.75
    # Every this-many consecutive rounds an insert row stays blocked on a
    # held page lock, the engine probes the lease table and revokes a dead
    # holder's lock; rows still blocked by a live holder when the round
    # budget runs out are rejected with ST_LOCK_TIMEOUT.
    lock_retry_rounds: int = 3


def write_combine() -> bool:
    """Write-combining knob (``SHERMAN_WRITE_COMBINE``): when on, the leaf
    apply consults each page group's lock word once per group instead of
    once per row, the counterpart of Sherman's HOCL local-lock hand-over
    (many same-leaf writes ride one lock acquisition).  Statuses and pool
    bits stay identical by construction (the rows of one page hash to one
    lock word); only the lock-consult count and the ``combine_*``
    counters change.  Off by default."""
    v = os.environ.get("SHERMAN_WRITE_COMBINE", "0").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return False
    if v in ("1", "true", "on", "yes"):
        return True
    raise ConfigError(f"SHERMAN_WRITE_COMBINE={v!r}: want 0/1")


def prep_impl() -> str:
    """Request-plane placement knob (``SHERMAN_PREP_IMPL``): where the
    serving front door's ingress step
    (``workload.device_prep.make_ingress_step``) combines, dedups, sorts
    and routes each client batch.

    - ``host`` (default): ``np.unique`` and the host router probe, then
      the device fan-out.
    - ``device``: one device function (``make_device_prep``) sorts,
      dedups and router-probes the raw request pairs, with outputs
      bit-identical to the host path's.  A step built with a leaf cache
      falls back to ``host``: the cache probe is host-in/host-out."""
    v = os.environ.get("SHERMAN_PREP_IMPL", "host").strip().lower()
    if v not in ("host", "device"):
        raise ConfigError(f"SHERMAN_PREP_IMPL={v!r}: want host|device")
    return v


def replica_count() -> int:
    """Replication-plane knob (``SHERMAN_REPL``): the number of in-process
    follower engines of the journal-shipped replica group
    (``replica.ReplicaGroup.from_env``), 0 = off, the default: no
    follower is built, no tailer polls, and the primary's pool is
    bit-identical to a build without the plane.  ``1`` (or true/on/yes)
    runs one follower; a larger integer is the follower count."""
    v = os.environ.get("SHERMAN_REPL", "0").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return 0
    if v in ("1", "true", "on", "yes"):
        return 1
    try:
        n = int(v)
    except ValueError:
        raise ConfigError(
            f"SHERMAN_REPL={v!r}: want 0/1 or a follower count") from None
    if n < 0:
        raise ConfigError(f"SHERMAN_REPL={n}: want >= 0")
    return n


def replica_poll_ms() -> float:
    """Replication tail cadence (``SHERMAN_REPL_POLL_MS``, default 20):
    milliseconds between the background pump's polls of the primary's
    live journal segment (callers that pump by hand ignore it)."""
    v = os.environ.get("SHERMAN_REPL_POLL_MS", "20").strip()
    try:
        ms = float(v)
    except ValueError:
        raise ConfigError(f"SHERMAN_REPL_POLL_MS={v!r}: want a float of "
                          "milliseconds") from None
    if ms <= 0:
        raise ConfigError(f"SHERMAN_REPL_POLL_MS={ms}: want > 0")
    return ms


def ack_quorum() -> int:
    """Quorum-ack knob (``SHERMAN_ACK_QUORUM``): the durable copies a
    write needs before its ack resolves; the primary's fsync'd journal
    record counts as one, and every follower whose applied watermark
    covers the record adds one.  1, the default, acks on the primary's
    durability alone and never consults the replica group.  ``K > 1``
    gates each write ack on ``K - 1`` follower watermarks with a bounded
    wait (``replica.QuorumTimeoutError`` on expiry; the rid stays in the
    exactly-once window, so a retry re-acks)."""
    v = os.environ.get("SHERMAN_ACK_QUORUM", "1").strip().lower()
    if v in ("", "0", "1", "false", "off", "no"):
        return 1
    try:
        n = int(v)
    except ValueError:
        raise ConfigError(
            f"SHERMAN_ACK_QUORUM={v!r}: want a copy count >= 1") from None
    if n < 1:
        raise ConfigError(f"SHERMAN_ACK_QUORUM={n}: want >= 1")
    return n


def tail_wait_s() -> float:
    """Tailer stall watchdog (``SHERMAN_TAIL_WAIT_S``, default 5): how
    long a follower's journal tail may wait at one torn frame (an append
    in flight) before it asks the lease table.  With the primary's lease
    dead the tail raises ``replica.TailStalledError`` instead of waiting
    forever; with it live the wait goes on (evented once)."""
    v = os.environ.get("SHERMAN_TAIL_WAIT_S", "5").strip()
    try:
        s = float(v)
    except ValueError:
        raise ConfigError(f"SHERMAN_TAIL_WAIT_S={v!r}: want a float of "
                          "seconds") from None
    if s <= 0:
        raise ConfigError(f"SHERMAN_TAIL_WAIT_S={s}: want > 0")
    return s


def anti_entropy_s() -> float:
    """Anti-entropy cadence (``SHERMAN_ANTI_ENTROPY_S``): seconds between
    the background audits of ``replica.AntiEntropy`` (watermark
    freshness, the consumed-segment CRC, a sampled pool compare against
    the primary).  0, the default, starts no thread; drills call
    ``tick()``."""
    v = os.environ.get("SHERMAN_ANTI_ENTROPY_S", "0").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return 0.0
    try:
        s = float(v)
    except ValueError:
        raise ConfigError(f"SHERMAN_ANTI_ENTROPY_S={v!r}: want a float of "
                          "seconds") from None
    if s < 0:
        raise ConfigError(f"SHERMAN_ANTI_ENTROPY_S={s}: want >= 0")
    return s


def value_heap_pages() -> int:
    """Out-of-line value heap knob (``SHERMAN_VALUE_HEAP``): heap pages a
    node of the region that stores variable-length payloads, 0 (the
    default) for inline 64-bit values; ``1`` asks for the default region
    of 4,096 pages."""
    v = os.environ.get("SHERMAN_VALUE_HEAP", "0").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return 0
    if v in ("1", "true", "on", "yes"):
        return 4096
    try:
        n = int(v)
    except ValueError:
        raise ConfigError(f"SHERMAN_VALUE_HEAP={v!r}: want 0/1 or a "
                          "pages-per-node count") from None
    if n < 0:
        raise ConfigError(f"SHERMAN_VALUE_HEAP={n}: want >= 0")
    return n


def leaf_cache_slots() -> int:
    """Hot-key tier knob (``SHERMAN_LEAF_CACHE``): the physical slot count
    of the versioned leaf/value cache (``models/leaf_cache.py``), 0 (the
    default) = off; ``1`` asks for 65,536 slots, a larger integer is the
    slot count (rounded up to a power of two by the cache; it admits
    half as many keys)."""
    v = os.environ.get("SHERMAN_LEAF_CACHE", "0").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return 0
    if v in ("1", "true", "on", "yes"):
        return 65536
    try:
        n = int(v)
    except ValueError:
        raise ConfigError(f"SHERMAN_LEAF_CACHE={v!r}: want 0/1 or a slot "
                          "count") from None
    if n < 0:
        raise ConfigError(f"SHERMAN_LEAF_CACHE={n}: want >= 0")
    return n


# ---------------------------------------------------------------------------
# Staged serving loop.
# ---------------------------------------------------------------------------

STAGED_FUSIONS = ("aligned", "pipelined")
# Program-structure forms of the reference's staged step that the port
# does not build yet: "chained" folds the receipts into a fused serve
# program and "fused" compiles the whole step as one XLA program.
STAGED_FUSIONS_NOT_BUILT = ("chained", "fused")


def staged_fusion() -> str:
    """Structure of the device-staged read step
    (``workload.device_prep.make_staged_step``), from the
    ``SHERMAN_STAGED_FUSION`` environment variable:

    - ``aligned`` (default): prep -> serve -> verify, where the serve is
      the engine's combined-search fan-out (the host-staged serve);
    - ``pipelined``: the same three phases dispatched as a two-deep
      pipeline (verify k-1, prep k, serve k); after ``step.drain`` the
      receipts equal ``aligned``'s.

    ``chained`` and ``fused`` are XLA program-structure forms of the
    reference that the port does not build yet: they raise."""
    v = os.environ.get("SHERMAN_STAGED_FUSION", "aligned").lower()
    if v in STAGED_FUSIONS_NOT_BUILT:
        raise ConfigError(
            f"SHERMAN_STAGED_FUSION={v!r}: 'chained' and 'fused' are XLA "
            "program-structure forms (receipts fused into the serve "
            "program; the whole step as one program) that the port does "
            "not build yet; want aligned|pipelined")
    if v not in STAGED_FUSIONS:
        raise ConfigError(f"SHERMAN_STAGED_FUSION={v!r}: want "
                          "aligned|pipelined")
    return v
