"""Two ranks x 2 nodes of the port on this CPU against the JAX package's
ONE process of 4 nodes, for each of the reference's five two-process
worker sequences (``tests/test_multihost.py``: cluster, engine, reclaim,
staged loop, split storm; ``tests/torch_mp_seqs.py`` holds them once for
both packages).  The ranks' pool, lock and counter blocks joined in rank
order, every answer and every receipt must be bit-identical to the
single process's: replicated-driver SPMD across processes is the same
cluster as one process driving every node."""

import numpy as np
import pytest

import torch_mp_seqs as S
import torch_ranks as RK

_RANK = r'''
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import torch_mp_seqs as S
S.port_rank(args[0], pid, tmp)
print(f"[{pid}] SEQ-PASS", flush=True)
'''


def _joined(tmp_path, name: str, nproc: int = 2) -> dict:
    parts = [dict(np.load(tmp_path / f"{name}_r{p}.npz"))
             for p in range(nproc)]
    out = {}
    for k in parts[0]:
        if k.startswith("res_"):
            for p in parts[1:]:
                np.testing.assert_array_equal(
                    p[k], parts[0][k], err_msg=f"ranks disagree on {k}")
            out[k] = parts[0][k]
        else:
            out[k] = np.concatenate([p[k] for p in parts])
    return out


@pytest.mark.parametrize("name", list(S.SEQS))
def test_two_ranks_match_one_jax_process(tmp_path, eight_devices, name):
    RK.run(tmp_path, _RANK, "SEQ-PASS", timeout=240, args=(name,))
    got = _joined(tmp_path, name)
    want = S.jax_run(name, str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k], np.asarray(want[k]).astype(got[k].dtype),
            err_msg=f"{name}: {k}")


_JAX_RANK = r'''
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
tmp = sys.argv[4]; name = sys.argv[5]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["SHERMAN_COORD"] = f"localhost:{port}"
os.environ["SHERMAN_NPROC"] = str(nproc)
os.environ["SHERMAN_PROC_ID"] = str(pid)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import torch_mp_seqs as S
from sherman_tpu.cluster import Cluster
from sherman_tpu.config import DSMConfig
from sherman_tpu.parallel import bootstrap
from sherman_tpu.utils import checkpoint as CK
keeper = bootstrap.init_multihost()
cluster = Cluster(DSMConfig(**S.CFGS[name]), keeper=keeper)
assert cluster.dsm.multihost
m = S.JaxMods()
m.name = f"jaxmh{pid}"
m.restore = lambda path, k: CK.restore(path, keeper=k)
res = S.SEQS[name](m, cluster, keeper, tmp)
out = {f"res_{k}": np.asarray(v) for k, v in res.items()}
for tag, c in (("", cluster), ("restored_", m.restored)):
    if c is None:
        continue
    out[tag + "pool"] = CK._local_block(c.dsm.pool)
    out[tag + "locks"] = CK._local_block(c.dsm.locks)
    out[tag + "counters"] = CK._local_block(c.dsm.counters)
np.savez(os.path.join(tmp, f"jax_{name}_r{pid}.npz"), **out)
keeper.barrier("done")
print(f"[{pid}] JAX-PASS", flush=True)
'''


@pytest.mark.slow
def test_two_ranks_match_the_jax_two_process_engine_worker(tmp_path):
    """The port's two ranks against the JAX package's REAL two-process
    run of the engine worker's sequence (jax.distributed on this CPU, 2
    processes x 2 devices): every rank's pool, lock and counter block and
    every answer equal, process by process."""
    import os
    import subprocess
    import sys
    RK.run(tmp_path, _RANK, "SEQ-PASS", timeout=240, args=("engine",))
    worker = tmp_path / "jax_worker.py"
    worker.write_text(_JAX_RANK)
    env = dict(os.environ)
    env["PYTHONPATH"] = RK.REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    port = RK.free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", port, str(tmp_path),
         "engine"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=RK.REPO, text=True) for pid in range(2)]
    outs = RK.collect(procs, 900)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"jax worker {pid}:\n{out[-4000:]}"
    for pid in range(2):
        got = dict(np.load(tmp_path / f"engine_r{pid}.npz"))
        want = dict(np.load(tmp_path / f"jax_engine_r{pid}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(
                got[k], want[k].astype(got[k].dtype),
                err_msg=f"rank {pid}: {k}")
