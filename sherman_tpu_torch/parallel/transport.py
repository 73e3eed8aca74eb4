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
"""

from __future__ import annotations

import torch

from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ExchangeLaneError
from sherman_tpu_torch.parallel import transport_kernel as TK

_OBS_XCH = obs.counter("transport.exchanges")
_OBS_XCH_BYTES = obs.counter("transport.exchange_bytes")


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


def gather_rows(x):
    """Tiled all-gather of every node's row block ``x [N, R, ...]``: the
    node-major table ``[N*R, ...]`` that every node receives.  The nodes
    share the card, so one view of ``x`` serves them all."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def exchange(tree):
    """Tiled all-to-all of a tensor or of every tensor of a dict, each
    ``[N, N*C, ...]`` (row block ``d*C:(d+1)*C`` of node ``s`` is its
    bucket for node ``d``).

    Every field is packed into one ``[N, N*C, sum(W)]`` int32 buffer that
    rides ONE launch of the exchange kernel, and unpacked afterwards:
    bools widen to int32, other 4-byte dtypes travel bit-exactly as a
    bitcast; any other width raises :class:`ExchangeLaneError`."""
    single = isinstance(tree, torch.Tensor)
    fields = {"x": tree} if single else tree
    N, NC = next(iter(fields.values())).shape[:2]
    cols = []
    for x in fields.values():
        if tuple(x.shape[:2]) != (N, NC):
            raise ValueError("exchange fields must share [N, N*C]")
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
    out = TK.all_to_all(packed.contiguous())
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
