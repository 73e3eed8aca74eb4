"""Request routing between the nodes of one card (counterpart of
``sherman_tpu/parallel/transport.py`` and of the pytree packer in
``sherman_tpu/parallel/transport_pallas.py``).

Each node scatters its requests into per-destination buckets of capacity
``C``; one all-to-all delivers every bucket to its owner; replies ride the
reverse exchange.  Requests beyond a bucket's capacity are not routed and
the caller retries them, as in the reference.  Every exchange counts in
``transport.exchanges`` and its packed payload in
``transport.exchange_bytes``, per execution (the reference counts its
collective builds, ``transport.*_traced``).

Where the reference runs each helper inside ``shard_map`` on one node's
shard, these take the node-major stack of every node's shard: a leading
node dimension ``[N, R, ...]``, each row of which is what node ``n`` holds.

When the nodes span several processes ("ranks",
:mod:`sherman_tpu_torch.parallel.mesh`), a rank holds the stack of its own
``L`` nodes, ``[L, R, ...]``, and :func:`exchange` and :func:`gather_rows`
cross ranks: the exchange kernel lays the send buffer out by destination
rank, the buffer is copied to a page-locked host buffer, one
``all_to_all`` of the ``gloo`` process group carries it (an all-gather
for :func:`gather_rows`), and it is copied back and put in place by the
kernel.  The staging copies are the transport over gloo, not a fallback:
every apply, gather and search stays on the card.  :data:`SPLIT` holds
where an exchange's time went (staging as device time between CUDA
events, gloo as wall time, the kernel's device time between CUDA events)
and the bytes that crossed ranks.
"""

from __future__ import annotations

import time

import torch

from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ExchangeLaneError, PreconditionError
from sherman_tpu_torch.parallel import mesh as MESH
from sherman_tpu_torch.parallel import transport_kernel as TK

_OBS_XCH = obs.counter("transport.exchanges")
_OBS_XCH_BYTES = obs.counter("transport.exchange_bytes")
_OBS_CROSS_BYTES = obs.counter("transport.cross_rank_bytes")

# The split of the cross-rank collectives since the last reset_split():
# their count, the exchange kernel's device ms, the staging copies'
# device ms, gloo's wall ms and the bytes sent to other
# ranks.
SPLIT = {"collectives": 0, "k4_ms": 0.0, "stage_ms": 0.0, "gloo_ms": 0.0,
         "cross_bytes": 0}
_pending: list = []         # kernel events not read yet
_GLOO_CHUNK = 1 << 24       # words a peer a gloo call (64 MiB)


def reset_split() -> None:
    _resolve()
    SPLIT.update(collectives=0, k4_ms=0.0, stage_ms=0.0, gloo_ms=0.0,
                 cross_bytes=0)


def split() -> dict:
    """:data:`SPLIT` with every recorded event read (syncs the card)."""
    _resolve()
    return dict(SPLIT)


def _resolve() -> None:
    while _pending:
        key, a, b = _pending.pop()
        b.synchronize()
        SPLIT[key] += a.elapsed_time(b)


class _Staging:
    """Page-locked host buffers, reused and grown to the largest call."""

    def __init__(self):
        self.bufs: dict = {}

    def get(self, name: str, n: int) -> torch.Tensor:
        b = self.bufs.get(name)
        if b is None or b.numel() < n:
            self.bufs.pop(name, None)       # free the smaller one first
            b = self.bufs[name] = torch.empty(n, dtype=torch.int32,
                                              pin_memory=True)
        return b[:n]


_staging = _Staging()


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _timed_k4(fn, *args):
    """A K4 launch around a cross-rank collective, its device time
    recorded between two CUDA events (read at the next staging sync)."""
    if args[0].device.type != "cuda":
        return fn(*args)
    a, b = _events()
    a.record()
    out = fn(*args)
    b.record()
    _pending.append(("k4_ms", a, b))
    return out


def _to_host(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` (flat int32) on the host: a CPU tensor as is, a CUDA one
    copied into a staging buffer (device time recorded; the host waits
    for the copy before gloo reads the buffer)."""
    if t.device.type != "cuda":
        return t
    h = _staging.get(name, t.numel())
    a, b = _events()
    a.record()
    h.copy_(t, non_blocking=True)
    b.record()
    b.synchronize()
    SPLIT["stage_ms"] += a.elapsed_time(b)
    _resolve()          # every kernel event before the copy has completed
    return h


def _to_device(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The host result back on ``like``'s device (a CUDA copy queued on
    the current stream; the next staging call waits behind it before the
    buffer is reused)."""
    if like.device.type != "cuda":
        return h
    out = torch.empty(h.shape, dtype=h.dtype, device=like.device)
    a, b = _events()
    a.record()
    out.copy_(h, non_blocking=True)
    b.record()
    _pending.append(("stage_ms", a, b))
    return out


def rank_all_to_all(send: torch.Tensor) -> torch.Tensor:
    """Equal-split all-to-all of the ranks: ``send [R, n]`` int32 (block
    ``q`` for rank ``q``) -> ``[R, n]`` (block ``p`` from rank ``p``).

    The buffer crosses in chunks of at most :data:`_GLOO_CHUNK` words a
    peer, one ``all_to_all_single`` of equal splits each: from a CUDA
    buffer, each chunk's ``R`` contiguous pieces are copied into one
    page-locked buffer (the copies are timed on the card, and the host
    waits for them), gloo exchanges them, and the received pieces are
    copied back into place; the two staging buffers are reused, so a
    collective of any size holds ``2 * R * chunk`` words of host memory."""
    import torch.distributed as dist
    R, n = send.shape
    cuda = send.device.type == "cuda"
    out = torch.empty_like(send)
    cross = (R - 1) * n * 4
    for j in range(0, n, _GLOO_CHUNK):
        k = min(n, j + _GLOO_CHUNK)
        m = k - j
        if cuda:
            hs = _staging.get("send", R * m).view(R, m)
            hr = _staging.get("recv", R * m).view(R, m)
            a, b = _events()
            a.record()
            for q in range(R):
                hs[q].copy_(send[q, j:k], non_blocking=True)
            b.record()
            b.synchronize()      # also orders the previous chunk's copy-back
            SPLIT["stage_ms"] += a.elapsed_time(b)
            _resolve()
        elif m == n:
            hs, hr = send, out
        else:
            hs, hr = send[:, j:k].contiguous(), torch.empty_like(
                send[:, j:k])
        t0 = time.perf_counter()
        dist.all_to_all_single(hr, hs)
        SPLIT["gloo_ms"] += (time.perf_counter() - t0) * 1e3
        if cuda:
            a, b = _events()
            a.record()
            for p in range(R):
                out[p, j:k].copy_(hr[p], non_blocking=True)
            b.record()
            _pending.append(("stage_ms", a, b))
        elif m != n:
            out[:, j:k] = hr
    SPLIT["collectives"] += 1
    SPLIT["cross_bytes"] += cross
    _OBS_CROSS_BYTES.inc(cross)
    return out


def rank_all_gather(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """Tiled all-gather of the ranks: every rank's ``x [m, ...]`` ->
    ``[ranks * m, ...]`` in rank order."""
    import torch.distributed as dist
    flat = x.reshape(-1)
    if flat.dtype != torch.int32:
        flat = flat.to(torch.int32) if flat.dtype == torch.bool \
            else flat.view(torch.int32)
    n = flat.numel()
    hs = _to_host(flat.contiguous(), "gsend")
    hr = _staging.get("grecv", ranks * n) if x.device.type == "cuda" \
        else torch.empty(ranks * n, dtype=torch.int32)
    t0 = time.perf_counter()
    dist.all_gather(list(hr.view(ranks, n).unbind(0)), hs)
    SPLIT["gloo_ms"] += (time.perf_counter() - t0) * 1e3
    SPLIT["collectives"] += 1
    cross = (ranks - 1) * n * 4
    SPLIT["cross_bytes"] += cross
    _OBS_CROSS_BYTES.inc(cross)
    out = _to_device(hr, x)
    if x.dtype == torch.bool:
        out = out != 0
    elif x.dtype != torch.int32:
        out = out.view(x.dtype)
    return out.view((ranks * x.shape[0],) + tuple(x.shape[1:]))


def rank_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Element-wise sum of an integer tensor over the ranks (a small
    control-plane reduction: a plain host copy, no staging buffer)."""
    import torch.distributed as dist
    h = x.to("cpu", copy=True)
    dist.all_reduce(h)
    SPLIT["collectives"] += 1
    return h.to(x.device)


def bucketize(dest, active, n_nodes: int, capacity: int):
    """Assign each request a slot in its destination bucket, per source
    node: a stable sort by destination, the rank within each
    destination's run, and no slot past ``capacity``.

    dest, active: ``[N, R]`` int32 destination node and bool per request.
    -> (bucket_idx ``[N, R]`` int64 in ``[0, n_nodes*capacity)`` or -1,
    routed ``[N, R]`` bool)."""
    R = dest.shape[-1]
    d = torch.where(active, dest, n_nodes).to(torch.int32)
    sd, perm = torch.sort(d, dim=-1, stable=True)
    starts = torch.searchsorted(sd, sd, side="left")
    rank = torch.arange(R, device=dest.device) - starts
    ok = (sd < n_nodes) & (rank < capacity)
    bidx = torch.where(ok, sd.long() * capacity + rank, -1)
    bucket_idx = torch.empty_like(bidx).scatter_(-1, perm, bidx)
    return bucket_idx, bucket_idx >= 0


def bucket_fill(bucket_idx, capacity: int, mesh: MESH.Mesh) -> int:
    """The slots in use of the fullest bucket of any node of any rank,
    rounded up to a power of two (at most ``capacity``): across ranks only
    that many rows of each bucket need to cross, since a request takes
    the lowest free slot of its bucket and a reply comes back in its
    request's slot.  The rounding keeps the exchange's shapes few (at
    most twice the rows).  One all-reduce."""
    used = int(torch.where(bucket_idx >= 0, bucket_idx % capacity + 1,
                           0).max()) if bucket_idx.numel() else 0
    from sherman_tpu_torch.parallel import bootstrap
    if mesh.spans:
        used = bootstrap.allreduce_int(used, "max")
    return min(capacity, 1 << max(0, used - 1).bit_length())


def trim_buckets(x, n_nodes: int, capacity: int, fill: int):
    """``[L, n_nodes*capacity, ...]`` bucket rows -> the first ``fill``
    rows of each bucket, ``[L, n_nodes*fill, ...]``."""
    L, rest = x.shape[0], tuple(x.shape[2:])
    return x.reshape((L, n_nodes, capacity) + rest)[:, :, :fill].reshape(
        (L, n_nodes * fill) + rest)


def trimmed_slot(bucket_idx, capacity: int, fill: int):
    """A request's bucket slot in the trimmed layout of
    :func:`trim_buckets` (-1 stays -1)."""
    return torch.where(bucket_idx >= 0,
                       bucket_idx // capacity * fill + bucket_idx % capacity,
                       bucket_idx)


def scatter_to_buckets(field, bucket_idx, n_slots: int):
    """Place request fields ``[N, R, ...]`` into bucket slots
    ``[N, n_slots, ...]``; slots no request took stay zero."""
    N, R = bucket_idx.shape
    rest = field.shape[2:]
    base = torch.arange(N, device=field.device)[:, None] * n_slots
    # unrouted rows land in one spare row past the end, dropped below
    idx = torch.where(bucket_idx >= 0, base + bucket_idx, N * n_slots)
    out = field.new_zeros((N * n_slots + 1,) + rest)
    out[idx.view(-1)] = field.reshape((N * R,) + rest)
    return out[:-1].view((N, n_slots) + rest)


def take_local(x, idx):
    """Every node's own gather ``x[n][idx[n]]``: ``x [N, M, ...]``,
    ``idx [N, R]`` -> ``[N, R, ...]``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def gather_rows(x, mesh: MESH.Mesh | None = None):
    """Tiled all-gather of every node's row block ``x [N, R, ...]``: the
    node-major table ``[N*R, ...]`` that every node receives.  The nodes
    of one process share the card, so one view of ``x`` serves them all;
    with a ``mesh`` that spans ranks ``x`` is the rank's ``[L, R, ...]``
    and the ranks' blocks are gathered across the process group."""
    flat = x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])
    if mesh is None or not mesh.spans:
        return flat
    return rank_all_gather(flat, mesh.world_size)


def exchange(tree, mesh: MESH.Mesh | None = None):
    """Tiled all-to-all of a tensor or of every tensor of a dict, each
    ``[N, N*C, ...]`` (row block ``d*C:(d+1)*C`` of node ``s`` is its
    bucket for node ``d``).

    Every field is packed into one ``[N, N*C, sum(W)]`` int32 buffer that
    rides ONE launch of the exchange kernel, and unpacked afterwards:
    bools widen to int32, other 4-byte dtypes travel bit-exactly as a
    bitcast; any other width raises :class:`ExchangeLaneError`.  With a
    ``mesh`` that spans ranks, each field is the rank's ``[L, N*C, ...]``
    and the packed buffer crosses ranks: the kernel's rank layout, the
    staged ``all_to_all``, the kernel's placement."""
    single = isinstance(tree, torch.Tensor)
    fields = {"x": tree} if single else tree
    N, NC = next(iter(fields.values())).shape[:2]    # N: local nodes
    cols = []
    for x in fields.values():
        if tuple(x.shape[:2]) != (N, NC):
            raise PreconditionError("exchange fields must share [N, N*C]")
        if x.dtype == torch.bool:
            c = x.to(torch.int32)
        elif x.dtype == torch.int32:
            c = x
        elif x.element_size() == 4:
            c = x.view(torch.int32)
        else:
            raise ExchangeLaneError(x.dtype)
        cols.append(c.reshape(N, NC, -1))
    packed = cols[0] if len(cols) == 1 else torch.cat(cols, dim=2)
    _OBS_XCH.inc()
    _OBS_XCH_BYTES.inc(packed.numel() * 4)
    packed = packed.contiguous()
    if mesh is None or not mesh.spans:
        out = TK.all_to_all(packed)
    else:
        R = mesh.world_size
        send = _timed_k4(TK.pack_for_ranks, packed, R)
        recv = rank_all_to_all(send)
        out = _timed_k4(TK.unpack_from_ranks, recv, N, packed.shape)
    outs, off = {}, 0
    for (name, x), c in zip(fields.items(), cols):
        w = c.shape[2]
        piece = out[:, :, off:off + w].reshape(x.shape)
        off += w
        if x.dtype == torch.bool:
            piece = piece != 0
        elif x.dtype != torch.int32:
            piece = piece.view(x.dtype)
        outs[name] = piece
    return outs["x"] if single else outs
