"""The yardstick's peaks and the bytes each kernel of the port must move,
counted from the program's own counters (rows a launch covered, pages it
read, words it wrote), after ``chip_smoke.py``'s bound arithmetic: each
input byte read once, each output byte written once.

- K1 ``descent_round``: per row the active mask (1 byte) and seven
  outputs (three int32 words, four bools: 16 bytes); per active row its
  address and key pair (12 bytes); and the pages read.
- K2 ``gather_pages``: per row its index (4 bytes); the page written
  for each row that asks for a real page; the pages read.
- K3 ``writeback``: per row the applied mask (1 byte); per applied row
  its page and slot (8 bytes) and, per lane, the entry word read and the
  pool word written (8 bytes).

Rows, active rows and applied rows are the program's counts.  Page-sized
traffic is counted by what the inputs need, never by the rows a launch
covered.  The pages read are the leaf pages the inputs need: each
batch's distinct leaves, worked out from the benchmark's own keys and
the bulk load's layout (``harness.leaf_pages``), not the program's
page-read count, which counts a page once per row that reads it and
would put a share past 100%.  K2's pages written are its rows that read
a real page, which that count does give (every read of the multi-node
paths is an owner's K2 row); a row that carries no request, the padding
of a bucket, writes a page nobody asked for and counts its index only.
A kernel that reads a page twice, or an internal page, does more than
the inputs need, and its share is the lower for it.

A share is the least time these bytes take at the peak rate over the
kernel's device time in the trace.  A reader that finds no launch or no
device time returns nothing.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): HBM3 bandwidth, bytes/s
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}

PAGE_BYTES = 1024


def peak(device_kind: str, what: str = "hbm_bytes_per_s") -> float:
    for k, v in PEAKS.items():
        if k in device_kind:
            return v[what]
    raise KeyError(f"no peak of {what} for {device_kind!r}")


def k1_bytes(rows: int, active_rows: int, pages: int) -> int:
    """The mask and seven outputs of every row, the address and key pair
    of every active row, each page read."""
    return rows * 1 + active_rows * 3 * 4 + rows * (3 * 4 + 4) \
        + pages * PAGE_BYTES


def k2_bytes(rows: int, pages: int, masked: bool = False,
             written: int | None = None) -> int:
    """Every row's index (and mask where the gather is masked), each
    source page read, and the ``written`` output pages (default: every
    row's, as where each row carries a request)."""
    w = rows if written is None else written
    return rows * 4 + (rows if masked else 0) + (pages + w) * PAGE_BYTES


def k3_bytes(rows: int, applied_rows: int, lanes: int) -> int:
    """The mask of every row; per applied row its page and slot, and per
    lane the entry word read and the pool word written."""
    return rows + applied_rows * (4 + 4 + 8 * lanes)


def share_pct(nbytes: int, seconds: float, device_kind: str):
    """100 x (least time at the peak) / (device time); None without
    bytes or time."""
    if nbytes <= 0 or not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / peak(device_kind) / seconds
