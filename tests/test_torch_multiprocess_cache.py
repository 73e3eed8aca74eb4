"""The hot-key tier, the cached staged step, the ingress step and the
front door across ranks: two ranks x 2 nodes of the port on this CPU
against the JAX package's ONE process of 4 nodes, for the ``cache`` and
``ingress`` sequences of ``tests/torch_mp_seqs.py``
(``chip_smoke.mr_cache_seq``/``mr_ingress_seq``).  The ranks' pool, lock
and counter blocks joined in rank order, every answer, receipt, cache
stat, cache mirror and device table must be bit-identical to the single
process's."""

import numpy as np
import pytest

import torch_mp_seqs as S
import torch_ranks as RK
from test_torch_multiprocess_engine import _RANK, _joined

#: the JAX package's receipts for the cache sequence's three cached
#: aligned staged steps at 4 nodes (20,000 keys, 512 filled, 4,096
#: slots, ``dev_b_resid=512``), from its own two-process run
_JAX_TWO_PROCESS_RECEIPTS = [3, 1, 12288, 6807, 585, 7848, 2491]


@pytest.mark.parametrize("name", S.CACHE_SEQS)
def test_two_ranks_match_one_jax_process(tmp_path, eight_devices, name):
    RK.run(tmp_path, _RANK, "SEQ-PASS", timeout=240, args=(name,))
    got = _joined(tmp_path, name)
    want = S.jax_run(name, str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k], np.asarray(want[k]).astype(got[k].dtype),
            err_msg=f"{name}: {k}")
    if name == "cache":
        assert got["res_ro"].tolist() == _JAX_TWO_PROCESS_RECEIPTS
