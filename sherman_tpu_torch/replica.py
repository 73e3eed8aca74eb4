"""Replication plane (counterpart of ``sherman_tpu/replica.py``).

Only the error class that the serving front door raises and catches is
here; the replica group, the journal tailer and the quorum wait come with
ROADMAP.md item 7b.
"""

from __future__ import annotations

from sherman_tpu_torch.errors import StateError


class QuorumTimeoutError(StateError):
    """A quorum-ack wait expired: fewer than ``ack_quorum - 1`` follower
    watermarks covered the write's durable journal frontier within the
    bounded wait.  The write IS durable on the primary and its rid is
    already in the exactly-once dedup window: a client retry re-acks the
    original result once the quorum recovers."""
