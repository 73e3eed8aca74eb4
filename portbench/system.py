"""The system under test, behind the two entries the traffic drives.

:class:`PortSystem` builds the port (``sherman_tpu_torch``) from the
configuration and the benchmark's own keys and values, as
``sherman_tpu_torch.bench.build`` does (``Cluster``, ``Tree``, one
``BatchedEngine``, ``batched.bulk_load(..., fill)``, ``attach_router()``)
without calling it, since ``build`` derives its own keys.  Its entries:

- ``read``: ``workload.device_prep.make_ingress_step(eng, width,
  prep_impl="device")``, the serving front door's read path, split into
  ``dispatch(batch) -> handle`` and ``complete(handle) -> (values,
  found)``;
- ``mixed``: ``BatchedEngine.mixed(keys, values, is_read) -> (values,
  found, acks)``.

:class:`ControlSystem` serves the same entries from the plain reference
with one guarantee broken (see ``portbench/control.py``).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.gen import Batch
from portbench.reference import kv


class PortSystem:
    def __init__(self, cfg: dict, entry: str, keys: np.ndarray,
                 values: np.ndarray, device: str, log):
        from sherman_tpu_torch.cluster import Cluster
        from sherman_tpu_torch.config import DSMConfig, TreeConfig
        from sherman_tpu_torch.models import batched
        from sherman_tpu_torch.models.btree import Tree
        from sherman_tpu_torch.workload import device_prep

        n = int(cfg["machine_nr"])
        width = int(cfg["batch"])
        self.device = device
        self.width = width
        dcfg = DSMConfig(machine_nr=n,
                         pages_per_node=int(cfg["pool_pages"]) // n,
                         locks_per_node=int(cfg["locks_per_node"]),
                         step_capacity=width // n,
                         chunk_pages=int(cfg["chunk_pages"]),
                         device=device)
        self.cluster = Cluster(dcfg)
        self.tree = Tree(self.cluster)
        self.eng = batched.BatchedEngine(
            self.tree, batch_per_node=width // n,
            tcfg=TreeConfig(
                sibling_chase_budget=int(cfg["sibling_chase_budget"])))
        stats = batched.bulk_load(self.tree, keys, values,
                                  fill=float(cfg["fill"]))
        self.eng.attach_router()
        log(f"bulk_load: {stats}")
        # the layout the rooflines count leaf pages by
        want = -(-keys.shape[0] // int(cfg["leaf_keys"]))
        if stats["leaves"] != want:
            raise RuntimeError(f"bulk load laid out {stats['leaves']} "
                               f"leaves, the configuration's leaf_keys "
                               f"{cfg['leaf_keys']} gives {want}")
        self.step = None
        if entry == "read":
            self.step = device_prep.make_ingress_step(
                self.eng, width=width, prep_impl="device")
        elif entry != "mixed":
            raise ValueError(f"entry {entry!r}: want read|mixed")

    def dispatch(self, b: Batch):
        return self.step.dispatch(b.keys)

    def complete(self, handle):
        return self.step.complete(handle)

    def mixed(self, b: Batch):
        return self.eng.mixed(b.keys, b.values, b.is_read)

    def readback(self, keys: np.ndarray, ranks: np.ndarray):
        """Reads of ``keys`` through the cell's own entry, a batch of the
        timed width at a time.  -> (values, found)."""
        vals, found = [], []
        for i in range(0, keys.shape[0], self.width):
            k = keys[i:i + self.width]
            if self.step is not None:
                v, f = self.step.step(k)
            else:
                v, f, _ = self.eng.mixed(k, np.zeros_like(k),
                                         np.ones(k.shape[0], bool))
            vals.append(v)
            found.append(f)
        return np.concatenate(vals), np.concatenate(found)

    def counters(self) -> dict:
        """The program's counters now: the registry's ``kernels`` pull
        collector and the ingress step's prep histogram (count, sum), and
        the DSM's per-node page-read and write counters (uint32, each
        node's own: they wrap separately)."""
        from sherman_tpu_torch import obs
        from sherman_tpu_torch.parallel import dsm as D
        snap = obs.snapshot()
        out = {k: v for k, v in snap.items() if k.startswith("kernels.")}
        h = snap.get("prep.device_dispatch_ms") or {}
        out["prep.device_dispatch_ms.count"] = h.get("count", 0)
        out["prep.device_dispatch_ms.sum"] = h.get("sum", 0.0)
        nodes = self.eng.dsm.counters_np().reshape(-1, D.N_COUNTERS)
        nodes = nodes.astype(np.int64)
        for name, slot in (("read_pages", D.CNT_READ_PAGES),
                           ("write_ops", D.CNT_WRITE_OPS),
                           ("write_words", D.CNT_WRITE_WORDS)):
            out["dsm." + name] = nodes[:, slot]
        return out

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def free(self) -> None:
        self.step = self.eng = self.tree = self.cluster = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class ControlSystem:
    """The reference in the program's place, breaking the guarantee that
    a read answers with its own key's latest value: a hot-key cache of
    ``slots`` direct-mapped slots, filled with the hottest ranks, that
    answers every read whose slot is filled without checking the key
    tag, and that no update invalidates (a shortcut a faster read path
    could tempt: no tag compare, no invalidation)."""

    def __init__(self, values: np.ndarray, slots: int = 1 << 16):
        self.ref = kv.KVReference(values)
        self.bits = slots.bit_length() - 1
        hot = np.arange(min(values.shape[0], 4 * slots), dtype=np.uint64)
        self.slot_val = np.zeros(slots, np.uint64)
        self.slot_full = np.zeros(slots, bool)
        s = self._slot(hot)
        self.slot_val[s[::-1]] = values[hot.astype(np.int64)][::-1]
        self.slot_full[s] = True

    def _slot(self, ranks) -> np.ndarray:
        h = kv.mix64(np.asarray(ranks, np.uint64) ^ np.uint64(0x5107))
        return (h >> np.uint64(64 - self.bits)).astype(np.int64)

    def _read(self, ranks):
        s = self._slot(ranks)
        v = np.where(self.slot_full[s], self.slot_val[s],
                     self.ref.read(ranks))
        return v, np.ones(ranks.shape[0], bool)

    def dispatch(self, b: Batch):
        return self._read(b.ranks)

    def complete(self, handle):
        return handle

    def mixed(self, b: Batch):
        vals, found = self._read(b.ranks)
        applied, ack = kv.first_writes(b.ranks, b.is_read)
        self.ref.apply(b.ranks, b.values, applied)
        return (np.where(b.is_read, vals, 0).astype(np.uint64),
                found & b.is_read, ack)

    def readback(self, keys, ranks):
        return self._read(ranks)

    def sync(self) -> None:
        pass

    def free(self) -> None:
        self.ref = None
