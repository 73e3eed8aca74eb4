"""Host-side utilities of the port (counterparts of
``sherman_tpu/utils/``): timing, leveled logging, the op journal and the
checkpoint format.

Reference parity: ``include/Timer.h`` (ns timer, spin-sleep, per-loop
print) and ``include/Debug.h`` / ``src/Debug.cpp`` (printf-style leveled
logging with ANSI colors).
"""

import numpy as np

from sherman_tpu_torch.utils.debug import (DEBUG, ERROR, INFO, debug_item,
                                           notify_error, notify_info,
                                           set_level)
from sherman_tpu_torch.utils.timer import Timer, spin_sleep_ns

__all__ = [
    "Timer", "spin_sleep_ns",
    "notify_info", "notify_error", "debug_item", "set_level",
    "INFO", "ERROR", "DEBUG", "sorted_unique",
]


def sorted_unique(a) -> np.ndarray:
    """``np.unique(a)`` as a sort and a neighbour compare: numpy's
    hash-based unique is far slower than the sort at millions of
    elements."""
    a = np.sort(np.asarray(a).ravel())
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if a.size else a
