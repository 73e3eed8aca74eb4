"""Spawning the port's rank processes for the two-process tests: each
worker is a script run as ``python worker.py <rank> <nproc> <port> <tmp>
[args...]`` with the launcher's variables set, as
``tests/test_multihost.py`` runs the reference's workers: a free port
each, a timeout on every ``communicate`` and every child killed in a
``finally``."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r'''
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
tmp = sys.argv[4]; args = sys.argv[5:]
os.environ["SHERMAN_COORD"] = f"localhost:{port}"
os.environ["SHERMAN_NPROC"] = str(nproc)
os.environ["SHERMAN_PROC_ID"] = str(pid)
import numpy as np
import torch
torch.set_num_threads(2)
from sherman_tpu_torch.parallel import bootstrap
'''


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def spawn(tmp_path, script: str, nproc: int = 2, args=(), env=None,
          name: str = "worker.py"):
    worker = tmp_path / name
    worker.write_text(PRELUDE + script)
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    e.pop("SHERMAN_COORD", None)
    e.update(env or {})
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(nproc), port,
         str(tmp_path), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=e, cwd=REPO,
        text=True) for pid in range(nproc)]


def collect(procs, timeout: float):
    """Every worker's output, in rank order; every child killed at the
    end (a hang fails the test instead of the run)."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run(tmp_path, script: str, tag: str, timeout: float = 120,
        nproc: int = 2, args=(), env=None) -> list:
    procs = spawn(tmp_path, script, nproc, args, env)
    outs = collect(procs, timeout)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"[{pid}] {tag}" in out, out[-4000:]
    return outs
