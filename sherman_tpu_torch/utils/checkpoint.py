"""Checkpoint / resume of the whole cluster state, in the JAX package's
npz format (the port's copy of ``sherman_tpu/utils/checkpoint.py``).

One call snapshots everything a cluster needs to come back — the pool
(every page and the root-pointer meta words), the lock table, the op
counters and each directory's allocator state (bump mark, root hint,
reclaimed-page pool) — into a single ``.npz``; :func:`restore` rebuilds
a live cluster of the same ``machine_nr`` on the device the caller
names.  The arrays, their dtypes, the manifest and the ``cfg`` JSON are
the reference's, so a checkpoint written by either package restores into
the other:

- ``pool`` int32 ``[N*P, 256]``, ``locks`` int32 ``[N*L]``, ``counters``
  uint32 ``[N*10]`` (the port counts in int64 holding uint32 values and
  saves them as uint32), ``epoch`` int32 ``[nonce, seq, crc]``;
- ``cfg`` carries the reference's nine config fields.  The two the port
  has no knob for are written with the reference's defaults
  (``exchange_impl`` and ``gather_impl`` ``"xla"``); on load they are
  accepted and ignored (the port always runs its own kernels).  The
  device is never saved: the caller gives it on restore;
- with a value heap (``heap_pages_per_node`` > 0), ``heap`` int32
  ``[N*H, 256]``, the whole region; a delta carries the heap rows written
  since its parent as ``heap_rows``/``heap_pages``.

Delta artifacts (:func:`checkpoint_delta`) hold only the pages written
since the previous chain link; their page gather runs on the device
through the ``gather_pages`` kernel, so the copy to the host is
proportional to the dirty pages.

Client-side chunk leases are deliberately NOT saved: clients re-register
after restore and lease fresh chunks.  Locks are saved as-is, and
``restore(clear_locks=True)`` (default) zeroes the table: a restore is a
cluster-wide restart, no client of the old incarnation survives.

Every save counts in ``ckpt.full_saves`` or ``ckpt.delta_saves`` (with
``ckpt.delta_pages`` and ``ckpt.delta_bytes``), swept tmp orphans in
``ckpt.orphans_swept``; a full save is a ``checkpoint.save`` flight event
and a restore a ``checkpoint.restore`` one.

A cluster whose nodes span processes (``init_multihost``) saves
COLLECTIVELY, in the reference's format: every rank writes its node
block to ``<path>.host<r>.npz`` and the (mirrored) manifest to ``<path>``
with ``multihost = [ranks]``, all under one epoch whose nonce rank 0
draws and broadcasts, agreed on by every rank before any file is
written; :func:`restore` with the distributed keeper checks the pairs
(torn shard/manifest, rank count, epochs, node blocks) collectively
before it installs anything.  Both run inside the env-gated
``Watchdog.maybe`` (``SHERMAN_COLLECTIVE_TIMEOUT_S``).  Without a
distributed keeper a multihost artifact is refused with
:class:`CheckpointFormatError`, as the reference refuses it without a
multi-host cluster.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import glob
import json
import os
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sherman_tpu_torch import config as _C
from sherman_tpu_torch import obs
from sherman_tpu_torch.config import DSMConfig
from sherman_tpu_torch.errors import (CheckpointFormatError, ConfigError,
                                      ShermanError)
from sherman_tpu_torch.ops import bits as _bits
from sherman_tpu_torch.ops import page_kernels as PK

_OBS_FULL_SAVES = obs.counter("ckpt.full_saves")
_OBS_DELTA_SAVES = obs.counter("ckpt.delta_saves")
_OBS_DELTA_PAGES = obs.counter("ckpt.delta_pages")
_OBS_DELTA_BYTES = obs.counter("ckpt.delta_bytes")
_OBS_ORPHANS = obs.counter("ckpt.orphans_swept")

_CFG_FIELDS = ("machine_nr", "pages_per_node", "locks_per_node",
               "step_capacity", "host_step_capacity", "chunk_pages",
               "exchange_impl", "gather_impl", "heap_pages_per_node")
# the reference's config fields the port has no knob for, with the
# values its build writes by default
_REFERENCE_ONLY = {"exchange_impl": "xla", "gather_impl": "xla"}

# fsync indirection for tests (patching os.fsync itself would also
# intercept interpreter/numpy internals)
_fsync = os.fsync


class CheckpointCorruptError(ShermanError, RuntimeError):
    """A checkpoint artifact failed its content CRC / framing / chain
    pairing — corruption is detected at restore time, never served."""


# Page-layout fingerprint stamped into every checkpoint: the pool is raw
# words, so restoring across a layout change would silently misinterpret
# every page.  Missing tag = pre-stamp checkpoint, also rejected.
LAYOUT_TAG = (f"pw{_C.PAGE_WORDS}"
              f"+leaf{_C.LEAF_ENTRY_WORDS}x{_C.LEAF_CAP}"
              f"+int{_C.INTERNAL_ENTRY_WORDS}x{_C.INTERNAL_CAP}")


def _crc(arr) -> int:
    """CRC32 of an array's bytes, read in place (no ``tobytes`` copy of a
    multi-GB pool)."""
    return zlib.crc32(np.ascontiguousarray(arr))


def cfg_to_json(cfg) -> bytes:
    d = {f: getattr(cfg, f, _REFERENCE_ONLY.get(f)) for f in _CFG_FIELDS}
    d["_layout"] = LAYOUT_TAG
    return json.dumps(d).encode()


def cfg_from_json(raw, device: str = "cuda") -> DSMConfig:
    """Saved cfg JSON -> DSMConfig on ``device``, under the reference's
    forward-compat contract: fields ABSENT from the JSON take the
    DSMConfig default; fields neither build knows (a checkpoint written by
    a newer build) refuse loudly — silently dropping a semantic knob could
    reinterpret the pool."""
    d = json.loads(bytes(raw).decode())
    tag = d.pop("_layout", None)
    if tag != LAYOUT_TAG:
        raise CheckpointFormatError(
            f"checkpoint page layout {tag or 'unstamped'!r} does not match "
            f"this build's {LAYOUT_TAG!r}; re-create the checkpoint (raw "
            "page words cannot be reinterpreted across layouts)")
    known = ({f.name for f in dataclasses.fields(DSMConfig)} - {"device"}
             | set(_REFERENCE_ONLY))
    unknown = sorted(set(d) - known)
    if unknown:
        raise CheckpointFormatError(
            f"checkpoint cfg carries unknown fields {unknown} (written "
            "by a newer build?); refusing to drop config knobs silently")
    d.pop("exchange_impl", None)   # the port always runs its own kernels
    d.pop("gather_impl", None)
    return DSMConfig(**d, device=device)


def _state_arrays(dsm) -> dict:
    """The pool, lock table and counters copied to the host, in the
    reference's dtypes (the device-to-host half of a full save)."""
    return dict(pool=dsm.pool.cpu().numpy(), locks=dsm.locks.cpu().numpy(),
                counters=dsm.counters_np())


def checkpoint(cluster, path: str):
    """Write the cluster's full state to ``path`` (.npz), atomically
    (tmp + fsync + replace: a crash mid-save leaves the previous file
    intact).  -> the artifact's epoch ``[nonce, seq, crc]``, which delta
    artifacts chain onto.  Clears the DSM's dirty tracking."""
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez appends it silently; keep restore in sync
    if cluster.keeper.is_multihost:
        from sherman_tpu_torch.utils import failure
        # a peer dying mid-protocol would hang every other rank in the
        # collectives below: the env-gated watchdog fails fast instead
        with failure.Watchdog.maybe(
                what="collective checkpoint save",
                diagnostics=lambda: cluster.dsm.counter_snapshot()):
            _checkpoint_multihost(cluster, path)
        return None
    dsm = cluster.dsm
    man = _manifest(cluster)
    seq = cluster.keeper.mem_fetch_and_add("checkpoint_epoch")
    epoch = make_epoch(man, seq)
    arrays = dict(**_state_arrays(dsm), epoch=epoch, **man)
    # the value-heap region (heap-off checkpoints carry no heap array)
    if dsm.heap is not None:
        arrays["heap"] = dsm.heap_snapshot()
    arrays["integrity"] = _integrity(arrays)
    _savez_atomic(path, 0, **arrays)
    _OBS_FULL_SAVES.inc()
    obs.record_event("checkpoint.save", path=path, seq=int(seq))
    # a full save captures everything: dirty tracking restarts here
    dsm.clear_dirty()
    return epoch


def _checkpoint_multihost(cluster, path: str) -> None:
    """Every rank: its node block to ``<path>.host<r>.npz`` and the
    manifest to ``<path>``, under one agreed epoch."""
    from sherman_tpu_torch.parallel import bootstrap
    dsm = cluster.dsm
    me = dsm.mesh.rank
    # (nonce, seq, digest): the nonce is random on rank 0 and broadcast,
    # so every invocation is globally unique
    seq = cluster.keeper.mem_fetch_and_add("checkpoint_epoch")
    man = _manifest(cluster)
    nonce = np.frombuffer(os.urandom(4), np.int32).copy()
    nonce = bootstrap.broadcast_one_to_all(nonce)
    epoch = make_epoch(man, seq, nonce=int(nonce[0]))
    # save-time epoch agreement BEFORE any file write: diverged ranks
    # would otherwise replace a good checkpoint by a mixed-epoch set
    all_ep = bootstrap.process_allgather(epoch)
    if not (all_ep == all_ep[0]).all():
        raise CheckpointFormatError(
            "checkpoint aborted before writing: hosts disagree on the "
            f"checkpoint epoch {all_ep.tolist()} (divergent checkpoint "
            "counts or manifests — the replicated-driver invariant is "
            "broken); the previous checkpoint is left intact")
    shard = dict(**_state_arrays(dsm),
                 nodes=np.asarray(list(dsm.local_nodes), np.int64),
                 epoch=epoch)
    shard["integrity"] = _integrity(shard)
    _savez_atomic(f"{path}.host{me}.npz", me, own_tmp_only=True, **shard)
    man_arrays = dict(multihost=np.asarray([dsm.mesh.world_size], np.int64),
                      epoch=epoch, **man)
    man_arrays["integrity"] = _integrity(man_arrays)
    _savez_atomic(path, me, own_tmp_only=True, **man_arrays)
    _OBS_FULL_SAVES.inc()
    obs.record_event("checkpoint.save", path=path, seq=int(seq))
    cluster.keeper.barrier("checkpoint")


def make_epoch(man: dict, seq: int, nonce: int | None = None) -> np.ndarray:
    """The (nonce, seq, manifest-crc) epoch triple.  int32 throughout, as
    the reference stores it."""
    dig = 0
    for v in man.values():
        dig = zlib.crc32(np.ascontiguousarray(v), dig)
    if nonce is None:
        nonce = int(np.frombuffer(os.urandom(4), np.int32)[0])
    return np.asarray([nonce, seq, np.uint32(dig).view(np.int32)], np.int32)


def _sweep_tmp_orphans(path: str) -> int:
    """Remove ``<path>.tmp*.npz`` leftovers from a writer that crashed
    mid-:func:`_savez_atomic` (before its os.replace).  Returns the count
    removed.  Safe by construction: a live writer's tmp file only exists
    inside its own _savez_atomic call, which sweeps BEFORE creating it;
    concurrent writers to one path are excluded by the single-saver
    contract."""
    n = 0
    for orphan in glob.glob(glob.escape(path) + ".tmp*.npz"):
        try:
            os.unlink(orphan)
            n += 1
        except OSError:
            pass  # raced with another sweeper: gone either way
    if n:
        _OBS_ORPHANS.inc(n)
    return n


class _ParallelDeflate:
    """A raw-deflate compressor with zlib's ``compress``/``flush`` that
    deflates each chunk it is given on its own, in a thread pool (zlib
    frees the GIL), and ends each with a sync flush, so the chunks join
    into one valid deflate stream (as pigz does); the output keeps the
    input's order.  zlib's default level, as ``np.savez_compressed``."""

    def __init__(self, threads: int):
        self._pool = ThreadPoolExecutor(threads)
        self._pending: collections.deque = collections.deque()
        self._ahead = 2 * threads

    @staticmethod
    def _deflate(data) -> bytes:
        c = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush(zlib.Z_SYNC_FLUSH)

    def compress(self, data) -> bytes:
        self._pending.append(self._pool.submit(self._deflate, bytes(data)))
        out = []
        while self._pending and (self._pending[0].done()
                                 or len(self._pending) > self._ahead):
            out.append(self._pending.popleft().result())
        return b"".join(out)

    def flush(self) -> bytes:
        out = [f.result() for f in self._pending]
        self._pending.clear()
        self._pool.shutdown()
        # the stream's last block (BFINAL) — empty
        out.append(zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION,
                                    zlib.DEFLATED, -15).flush())
        return b"".join(out)


# arrays above this size deflate on every core (a whole pool); smaller ones
# (a delta, a migration batch) in the writer's thread
_PARALLEL_DEFLATE_BYTES = 64 << 20


def _savez_compressed(f, arrays: dict) -> None:
    """``np.savez_compressed``'s archive (one deflated, zip64 ``<name>.npy``
    member an array, zlib's default level), with every array above
    ``_PARALLEL_DEFLATE_BYTES`` deflated in ``np.save``'s 16 MiB chunks on
    every core: a one-thread deflate of a 4 GiB pool takes over a minute.
    Any npz reader (``np.load``, the JAX package) reads it."""
    threads = len(os.sched_getaffinity(0))
    with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zf:
        for name, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                if val.nbytes > _PARALLEL_DEFLATE_BYTES and threads > 1:
                    # zipfile's member writer feeds its deflater through
                    # this attribute (CRC and sizes stay its own)
                    fid._compressor = _ParallelDeflate(threads)
                np.lib.format.write_array(fid, val, allow_pickle=False)


def _savez_atomic(path: str, tag: int, *, own_tmp_only: bool = False,
                  **arrays) -> None:
    """:func:`_savez_compressed` via tmp + fsync + atomic replace +
    directory fsync: a crash mid-write never clobbers an existing
    checkpoint file, and a completed save survives power loss (the data
    AND the rename are both on disk before return).  Stale tmp orphans
    from a previous crash are swept first; ``own_tmp_only`` sweeps only
    this writer's own tmp name (the ranks of one host write the same
    manifest path at once, and must not sweep each other's tmp files)."""
    tmp = f"{path}.tmp{tag}.npz"
    if own_tmp_only:
        if os.path.exists(tmp):
            os.unlink(tmp)
            _OBS_ORPHANS.inc()
    else:
        _sweep_tmp_orphans(path)
    with open(tmp, "wb") as f:
        _savez_compressed(f, arrays)
        f.flush()
        _fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        _fsync(dfd)
    finally:
        os.close(dfd)


def _integrity(arrays: dict) -> np.ndarray:
    """Per-array content CRCs, stored alongside the arrays so restore
    detects corruption instead of serving it (npz member checksums cover
    the compressed stream; this covers the decoded content, one named CRC
    per array — a typed CheckpointCorruptError names the damaged
    array)."""
    crcs = {k: _crc(v) for k, v in arrays.items()}
    return np.frombuffer(json.dumps(crcs).encode(), np.uint8).copy()


def _verify_integrity(arrays: dict, path: str) -> None:
    """Check every loaded array against the artifact's stored CRC map
    (legacy artifacts without one pass).  Raises
    :class:`CheckpointCorruptError` naming the array."""
    blob = arrays.get("integrity")
    if blob is None:
        return
    try:
        crcs = json.loads(bytes(np.asarray(blob)).decode())
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable integrity map ({e})") from e
    for k, v in arrays.items():
        if k == "integrity" or k not in crcs:
            continue
        got = _crc(v)
        if got != int(crcs[k]):
            raise CheckpointCorruptError(
                f"{path}: array {k!r} failed its content CRC "
                f"({got:#x} != stored {int(crcs[k]):#x}) — the artifact "
                "is corrupt; restore from another chain link")


# shared_loads(): the store of the innermost open context (a dict of
# loaded arrays by (path, inode, size, mtime, keys)); an artifact rewritten
# in place of another (tmp + rename) is a new inode, so a hit is always the
# file's bytes.  A context var: each thread sees its own contexts.
_shared_lock = threading.Lock()
_shared_store = contextvars.ContextVar("sherman_shared_loads", default=None)


@contextlib.contextmanager
def shared_loads(store: dict | None = None):
    """While open, :func:`_load_arrays` hands every caller (in this thread)
    that asks for the same unchanged artifact and the same arrays the
    read-only arrays of the first load: N followers restoring one chain
    inflate and CRC-check each artifact once (``replica.ReplicaGroup``).
    ``store`` keeps the loads past the context (the caller prunes it);
    by default a context nested in another shares the outer one's store,
    and an outermost one drops its loads when it closes."""
    if store is None:
        store = _shared_store.get()
        if store is None:
            store = {}
    tok = _shared_store.set(store)
    try:
        yield store
    finally:
        _shared_store.reset(tok)


def shared_load_key(path: str, keys=None):
    """The store key of ``path``'s arrays ``keys`` as the file is now,
    or None when it is gone."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (path, st.st_ino, st.st_size, st.st_mtime_ns,
            None if keys is None else tuple(sorted(keys)))


def keep_shared_loads(store: dict, path: str) -> None:
    """Drop from a :func:`shared_loads` store every load but those of
    ``path`` as the file is now."""
    now = shared_load_key(path)
    with _shared_lock:
        for k in list(store):
            if now is None or k[:4] != now[:4]:
                del store[k]


def _load_arrays(path: str, keys=None) -> dict:
    """np.load + materialize (+ CRC verify) with typed failure: any
    unreadable/torn/corrupt artifact surfaces as
    :class:`CheckpointCorruptError`, never a stack of zipfile/zlib
    internals half-way through a restore.  Inside :func:`shared_loads`
    the result is shared and must not be written."""
    store = _shared_store.get()
    if store is not None:
        tag = shared_load_key(path, keys)
        if tag is not None:
            with _shared_lock:
                hit = store.get(tag)
            if hit is None:
                hit = _load_arrays_once(path, keys)
                with _shared_lock:
                    store[tag] = hit
            return hit
    return _load_arrays_once(path, keys)


def _load_arrays_once(path: str, keys=None) -> dict:
    try:
        with np.load(path) as z:
            names = z.files if keys is None else \
                [k for k in z.files if k in set(keys) | {"integrity"}]
            out = {k: np.asarray(z[k]) for k in names}
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable checkpoint artifact "
            f"({type(e).__name__}: {e})") from e
    _verify_integrity(out, path)
    return out


# The manifest schema: _manifest() emits exactly these keys.
_MANIFEST_FIELDS = ("cfg", "dir_nodes", "dir_next", "dir_root", "dir_free")


def _manifest(cluster) -> dict:
    """Config + directory/allocator state.  ``dir_free`` carries each
    allocator's reclaimed-page pool as packed addresses, sorted: those
    pages sit below the bump high-water mark with nonzero versions, so
    without this field a restore would re-leak everything reclamation
    freed."""
    free = []
    for d in cluster.directories:
        free += [_bits.make_addr(d.node_id, p) & 0xFFFFFFFF
                 for p in d.allocator.free_pages_list]
    out = dict(
        cfg=np.frombuffer(cfg_to_json(cluster.cfg), np.uint8),
        dir_nodes=np.asarray([d.node_id for d in cluster.directories],
                             np.int64),
        dir_next=np.asarray(
            [d.allocator._next for d in cluster.directories], np.int64),
        dir_root=np.asarray(
            [[d.root_ptr, d.root_level] for d in cluster.directories],
            np.int64),
        dir_free=np.asarray(sorted(free), np.int64),
    )
    return out


def set_free_pools(cluster, free_addrs) -> None:
    """SET every directory's reclaimed-page pool to the pages of
    ``free_addrs`` (packed page addresses) on its node, in the given order
    (the last of a node's pages is popped first): each pool is cleared,
    then refilled through ``GlobalAllocator.reclaim`` and its double-free
    check.  Replace, not merge, so chain restores can apply successive
    manifests without reclaiming a page twice."""
    by_node: dict[int, list[int]] = {}
    for a in np.asarray(free_addrs, np.int64).ravel().tolist():
        by_node.setdefault(_bits.addr_node(a), []).append(_bits.addr_page(a))
    for d in cluster.directories:
        d.allocator._free.clear()
        if by_node.get(d.node_id):
            d.allocator.reclaim(by_node[d.node_id])


def restore(path: str, device: str = "cuda", clear_locks: bool = True,
            keeper=None):
    """Rebuild a live Cluster on ``device`` from a full checkpoint.  With
    the distributed keeper (``init_multihost``) every rank restores its
    node block of a collective checkpoint.  -> Cluster."""
    from sherman_tpu_torch.cluster import Cluster

    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    if keeper is not None and keeper.is_multihost:
        from sherman_tpu_torch.utils import failure
        with failure.Watchdog.maybe(what="collective checkpoint restore"):
            return _restore_multihost(path, device, keeper, clear_locks)
    z = _load_arrays(path)
    if "delta" in z:
        raise CheckpointCorruptError(
            f"{path} is a DELTA artifact: restore its chain with "
            "restore_chain(base, deltas) — a delta alone holds only the "
            "pages written since its parent")
    if "multihost" in z and int(z["multihost"][0]) != 0:
        raise CheckpointFormatError(
            f"{path} is a multi-host checkpoint (one shard file per host) "
            "and needs a multi-host cluster: pass init_multihost()'s "
            "keeper on every host (the collective restore, ROADMAP.md "
            "item 7c-iv)")
    cfg = cfg_from_json(z["cfg"], device)
    cluster = Cluster(cfg)
    dsm = cluster.dsm
    dsm.pool.copy_(torch.from_numpy(z["pool"]))
    if not clear_locks:
        dsm.locks.copy_(torch.from_numpy(z["locks"]))
    dsm.counters.copy_(torch.from_numpy(z["counters"].astype(np.int64)))
    if dsm.heap is not None:
        if "heap" not in z:
            raise CheckpointCorruptError(
                f"{path}: cfg configures a value heap "
                f"({cfg.heap_pages_per_node} pages/node) but the "
                "artifact carries no heap array")
        dsm.heap.copy_(torch.from_numpy(z["heap"]))
    _restore_directories(cluster, z)
    # a restore is the recovery step every drill's black box must show
    obs.record_event("checkpoint.restore", path=path)
    return cluster


def _restore_multihost(path: str, device: str, keeper, clear_locks: bool):
    """COLLECTIVE-FIRST restore: every rank resolves all its fallible
    local work (the loads, the epoch pairing) into a status vector, every
    rank all-gathers it unconditionally, and only then raises, so a
    rank's local failure never leaves the others hanging in a
    collective."""
    from sherman_tpu_torch.cluster import Cluster
    from sherman_tpu_torch.parallel import bootstrap
    ws, me = bootstrap.process_layout()
    EW = 3  # epoch words; -1s for legacy shapes
    man = shard = None
    err = ""
    man_keys = set(_MANIFEST_FIELDS) | {"multihost", "epoch"}
    try:
        man = _load_arrays(path, keys=man_keys)
        shard = _load_arrays(f"{path}.host{me}.npz")
    except Exception as e:  # missing/torn/corrupt file: via the gather
        err = f"{type(e).__name__}: {e}"
    loads_ok = int(man is not None and shard is not None and "cfg" in man)
    pair_ok, saved_mh = 1, -1
    ep = np.full(EW, -1, np.int32)
    if loads_ok:
        saved_mh = int(man["multihost"][0]) if "multihost" in man else 0
        if ("epoch" in shard) != ("epoch" in man):
            pair_ok = 0  # mixed legacy/tagged files = torn pair
        elif "epoch" in shard:
            he = np.asarray(shard["epoch"]).ravel()
            ze = np.asarray(man["epoch"]).ravel()
            if he.shape != ze.shape or not (he == ze).all():
                pair_ok = 0
            else:
                ep[: min(EW, he.size)] = he[:EW].astype(np.int32)
    status = np.concatenate(
        [np.asarray([loads_ok, pair_ok, saved_mh], np.int32), ep])
    all_st = bootstrap.process_allgather(status)
    if not (all_st[:, 0] == 1).all():
        raise CheckpointFormatError("a host failed to load its checkpoint "
                                    f"files ({err or 'other host'})")
    if not (all_st[:, 1] == 1).all():
        raise CheckpointFormatError(
            "a host holds a torn checkpoint (shard/manifest from different "
            "checkpoints or mixed legacy/tagged files)")
    if not (all_st[:, 2] == ws).all():
        raise CheckpointFormatError(
            f"checkpoint host count {sorted(set(all_st[:, 2].tolist()))} != "
            f"{ws} restoring processes")
    if not (all_st[:, 3:] == all_st[0, 3:]).all():
        raise CheckpointFormatError(
            "hosts hold checkpoints from different epochs (crashed "
            "mid-checkpoint?): refusing to mix")
    # every rank validated: collectives are safe from here
    cfg = cfg_from_json(man["cfg"], device)
    cluster = Cluster(cfg, keeper=keeper)
    dsm = cluster.dsm
    nodes_ok = int(list(shard["nodes"]) == list(dsm.local_nodes))
    if not (bootstrap.process_allgather(
            np.asarray([nodes_ok], np.int32)) == 1).all():
        raise CheckpointFormatError("per-host node blocks changed since "
                                    "the checkpoint")
    dsm.pool.copy_(torch.from_numpy(shard["pool"]))
    if not clear_locks:
        dsm.locks.copy_(torch.from_numpy(shard["locks"]))
    dsm.counters.copy_(torch.from_numpy(
        shard["counters"].astype(np.int64)))
    _restore_directories(cluster, man)
    obs.record_event("checkpoint.restore", path=path)
    return cluster


def _restore_directories(cluster, man) -> None:
    """SET the directory/allocator state to the manifest's (replace, not
    merge)."""
    by_node = {int(n): i for i, n in enumerate(man["dir_nodes"])}
    for d in cluster.directories:
        i = by_node.get(d.node_id)
        if i is None:
            continue  # node had no directory in the saved cluster
        d.allocator._next = int(man["dir_next"][i])
        d.root_ptr = int(man["dir_root"][i][0])
        d.root_level = int(man["dir_root"][i][1])
    set_free_pools(cluster, man.get("dir_free", ()))


# ---------------------------------------------------------------------------
# Incremental (delta) checkpoints: only the pages written since the
# previous chain link (the DSM's dirty tracking: the device mask of the
# engine's write steps, the host set of host steps and direct installs),
# plus the full (small) locks/counters/manifest state, chained by the
# (nonce, seq, crc) epochs: each delta records its parent's epoch, and
# restore refuses out-of-order or mixed-chain links.
# ---------------------------------------------------------------------------

def _gather_rows(pool, rows: np.ndarray) -> np.ndarray:
    """``pool[rows]`` copied to the host, gathered on the pool's device by
    the ``gather_pages`` kernel (the copy is then as large as the rows,
    not the pool).  The rows are in range, where the kernel's clip is the
    identity."""
    if rows.size == 0:
        return np.zeros((0, _C.PAGE_WORDS), np.int32)
    r = torch.as_tensor(rows.astype(np.int32), device=pool.device)
    return PK.gather_pages(pool, r).cpu().numpy()


def checkpoint_delta(cluster, path: str, parent_epoch) -> dict:
    """Save a delta artifact chained onto ``parent_epoch`` (the epoch
    returned by the previous :func:`checkpoint` / :func:`checkpoint_delta`
    of this chain).  Clears the DSM's dirty tracking on success.
    Returns {"pages", "bytes", "epoch"}."""
    if not path.endswith(".npz"):
        path += ".npz"
    if parent_epoch is None:
        raise ConfigError(
            "checkpoint_delta needs the parent artifact's epoch "
            "(returned by checkpoint()/checkpoint_delta())")
    dsm = cluster.dsm
    rows = dsm.dirty_rows()
    man = _manifest(cluster)
    seq = cluster.keeper.mem_fetch_and_add("checkpoint_epoch")
    epoch = make_epoch(man, seq)
    arrays = dict(
        delta=np.asarray([1], np.int64),
        parent_epoch=np.asarray(parent_epoch, np.int32).ravel(),
        epoch=epoch,
        delta_rows=rows.astype(np.int64),
        delta_pages=_gather_rows(dsm.pool, rows),
        locks=dsm.locks.cpu().numpy(),
        counters=dsm.counters_np(),
        **man,
    )
    # the heap's dirty rows ride the same link (heap-off deltas carry
    # neither array)
    if dsm.heap is not None:
        hrows = dsm.heap_dirty_rows()
        arrays["heap_rows"] = hrows.astype(np.int64)
        arrays["heap_pages"] = _gather_rows(dsm.heap, hrows)
    arrays["integrity"] = _integrity(arrays)
    _savez_atomic(path, 0, **arrays)
    dsm.clear_dirty()
    _OBS_DELTA_SAVES.inc()
    _OBS_DELTA_PAGES.inc(int(rows.size))
    size = os.path.getsize(path)
    _OBS_DELTA_BYTES.inc(size)
    return {"pages": int(rows.size), "bytes": int(size), "epoch": epoch}


def _check_delta_link(z: dict, path: str, base_cfg_raw: bytes,
                      prev_epoch, n_rows_max: int) -> None:
    """Chain-pairing + sanity rules for one delta artifact."""
    if "delta" not in z:
        raise CheckpointCorruptError(
            f"{path}: not a delta artifact (chain links after the base "
            "must be checkpoint_delta outputs)")
    if bytes(np.asarray(z["cfg"])) != base_cfg_raw:
        raise CheckpointCorruptError(
            f"{path}: delta cfg does not match the chain's base cfg — "
            "links from different clusters cannot be mixed")
    pe = np.asarray(z["parent_epoch"]).ravel()
    prev = np.asarray(prev_epoch).ravel()
    if pe.shape != prev.shape or not (pe == prev).all():
        raise CheckpointCorruptError(
            f"{path}: parent epoch {pe.tolist()} does not pair with the "
            f"previous chain link's epoch {prev.tolist()} (wrong order, "
            "a skipped link, or artifacts from different chains)")
    rows = np.asarray(z["delta_rows"])
    pages = np.asarray(z["delta_pages"])
    if rows.ndim != 1 or pages.shape != (rows.size, _C.PAGE_WORDS):
        raise CheckpointCorruptError(
            f"{path}: delta rows/pages shape mismatch "
            f"({rows.shape} vs {pages.shape})")
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows_max):
        raise CheckpointCorruptError(
            f"{path}: delta rows outside the pool "
            f"[0, {n_rows_max}) — corrupt row index")


def restore_chain(base_path: str, delta_paths, device: str = "cuda",
                  clear_locks: bool = True):
    """Rebuild a live Cluster on ``device`` from ``base`` + ordered delta
    artifacts.

    Every artifact is CRC-verified and the (nonce, seq, crc) epoch chain
    is checked link by link — a corrupted, reordered or foreign link
    raises :class:`CheckpointCorruptError` instead of materializing a
    silently wrong pool.  The LAST link's locks/counters/allocator
    manifest win (each link carries the full small state).  -> Cluster."""
    cluster = restore(base_path, device=device, clear_locks=clear_locks)
    if not delta_paths:
        return cluster
    dsm = cluster.dsm
    base = _load_arrays(base_path, keys=("cfg", "epoch"))
    if "epoch" not in base:
        raise CheckpointCorruptError(
            f"{base_path}: base carries no epoch (pre-chain legacy "
            "checkpoint) — take a fresh base to start a delta chain")
    base_cfg_raw = bytes(np.asarray(base["cfg"]))
    prev_epoch = np.asarray(base["epoch"])
    n_rows = dsm.pool.shape[0]
    for path in delta_paths:
        z = _load_arrays(path)
        _check_delta_link(z, path, base_cfg_raw, prev_epoch, n_rows)
        rows = np.asarray(z["delta_rows"], np.int64)
        if rows.size:
            dsm.pool.index_copy_(
                0, torch.as_tensor(rows, device=dsm.device),
                torch.as_tensor(np.asarray(z["delta_pages"], np.int32),
                                device=dsm.device))
        if dsm.heap is not None and "heap_rows" in z:
            hrows = np.asarray(z["heap_rows"], np.int64)
            if hrows.size:
                hpages = np.asarray(z["heap_pages"])
                if hpages.shape != (hrows.size, _C.PAGE_WORDS) \
                        or hrows.min() < 0 \
                        or hrows.max() >= dsm.heap.shape[0]:
                    raise CheckpointCorruptError(
                        f"{path}: heap delta rows/pages shape mismatch "
                        "or rows outside the heap region")
                dsm.heap.index_copy_(
                    0, torch.as_tensor(hrows, device=dsm.device),
                    torch.as_tensor(hpages.astype(np.int32),
                                    device=dsm.device))
        dsm.locks.zero_()
        if not clear_locks:
            dsm.locks.copy_(torch.from_numpy(np.asarray(z["locks"])))
        dsm.counters.copy_(torch.from_numpy(
            np.asarray(z["counters"]).astype(np.int64)))
        _restore_directories(cluster, z)
        prev_epoch = np.asarray(z["epoch"])
    # restored state predates the crash-lost dirty tracking: callers
    # start a fresh chain (RecoveryPlane re-bases after replay)
    dsm.clear_dirty()
    return cluster


def read_chain_rows(base_path: str, delta_paths, rows) -> np.ndarray:
    """Reconstruct the CONTENT of specific pool rows as of the chain's
    tip, without materializing a cluster: the latest link containing a
    row wins, the base covers everything else.  The targeted-repair
    primitive (``recovery.py``): recovery cost scales with the damage,
    not the pool.  -> pages [len(rows), PAGE_WORDS] int32."""
    rows = np.asarray(rows, np.int64)
    base = _load_arrays(base_path)
    if "delta" in base:
        raise CheckpointCorruptError(
            f"{base_path}: chain base must be a full checkpoint")
    pool = np.asarray(base["pool"])
    if rows.size and (rows.min() < 0 or rows.max() >= pool.shape[0]):
        raise CheckpointCorruptError(
            f"repair rows outside the pool [0, {pool.shape[0]})")
    out = pool[rows].copy()
    base_cfg_raw = bytes(np.asarray(base["cfg"]))
    prev_epoch = np.asarray(base["epoch"]) if "epoch" in base else None
    for path in delta_paths:
        z = _load_arrays(path, keys=("delta", "cfg", "epoch",
                                     "parent_epoch", "delta_rows",
                                     "delta_pages"))
        if prev_epoch is None:
            raise CheckpointCorruptError(
                f"{base_path}: base carries no epoch to chain from")
        _check_delta_link(z, path, base_cfg_raw, prev_epoch,
                          pool.shape[0])
        drows = np.asarray(z["delta_rows"], np.int64)
        dpages = np.asarray(z["delta_pages"])
        pos = {int(r): i for i, r in enumerate(drows)}
        for i, r in enumerate(rows.tolist()):
            j = pos.get(int(r))
            if j is not None:
                out[i] = dpages[j]
        prev_epoch = np.asarray(z["epoch"])
    return out
