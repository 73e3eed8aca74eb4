"""Host-side utilities of the port: the op journal and the checkpoint
format (counterparts of ``sherman_tpu/utils/``)."""

import numpy as np


def sorted_unique(a) -> np.ndarray:
    """``np.unique(a)`` as a sort and a neighbour compare: numpy's
    hash-based unique is far slower than the sort at millions of
    elements."""
    a = np.sort(np.asarray(a).ravel())
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if a.size else a
