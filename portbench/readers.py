"""What the metric readers share: the program's counters over a part of
the traced run, per batch sent in that part.

The trace's device metrics take the traced part (the profiler's first
seconds of the window); counts and host times take the untraced rest of
the window where it sent batches, so that the profiler's own cost is not
in them.
"""

from __future__ import annotations


def part(run: dict) -> str:
    """The untraced rest of the window where it sent batches."""
    return "untraced" if run["batches"]["untraced"] > 0 else "traced"


def counter(run: dict, name: str, which: str) -> float:
    return run["counters"][which].get(name, 0)


def per_batch(run: dict, name: str):
    """A counter's delta per batch sent, or None where it did not move."""
    which = part(run)
    v = counter(run, name, which)
    return v / run["batches"][which] if v else None
