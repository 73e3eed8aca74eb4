"""Device-staged serving loops: the benchmark's whole client side — zipf
rank sampling, the synthetic rank->key map, request combining and the
router probe — run on the card inside each step, so a sustained loop
ships nothing per step: the step counter rides a device-resident carry
and the host only dispatches (counterpart of
``sherman_tpu/workload/device_prep.py``).

- Ranks come from a counter-based Threefry stream
  (:mod:`sherman_tpu_torch.workload.threefry`): two uint32 words per
  client, from the key folded with ``step * N + node``.  Two samplers
  invert the Gray/Jain zipf CDF: ``table`` (a host-built quantile table
  of edge pairs, one gather a client; exact: integer and correctly
  rounded f32 arithmetic only) and ``analytic`` (an exact head of 64
  partial sums, then an Euler-Maclaurin tail inverted by two Newton steps
  in f32; its ``exp``/``log`` are not correctly rounded, so the deep tail
  may differ from the reference's by a few ranks).
- The rank->key map is ``mix64(rank ^ salt)`` on uint32 words
  (:func:`sherman_tpu_torch.ops.bits.mix64_pair`), bit for bit the keys
  the bulk load wrote.
- Combining is one sort of a 64-bit key built from the two words (the
  high word offset by 2^31, so int64 order is the unsigned order), a
  segment scan, and a permutation that moves the first occurrences to
  the front in key order and the duplicates behind them in key order —
  the order of the reference's flag sort, padding rows included.  The
  unique count stays a device scalar: nothing syncs the host.
- Clients are served in key-sorted order, so the answer fan-out is a
  monotone gather, and every answer is checked on the card against
  ``key ^ check_xor``; the counts fold into the carry.

With ``N > 1`` nodes on the card every node draws its own stream, and the
per-node tensors are ``[N, batch]`` rows of the node-major batch.  The
serve is the engine's combined-search fan-out
(``BatchedEngine._get_search_fanout``), the same function object the
host-staged ``search_combined`` calls.

The serve's descent loop reads a pending count back once per round (one
host sync a round), which bounds what the pipelined forms can overlap.

The serving front door's ingress step (:func:`make_ingress_step`) is the
host-fed twin of the staged read loop: client batches that arrive from
outside, combined and probed on the host (``np.unique``, the router) or
on the card (:func:`make_device_prep`), served through the same fan-out.

Observability: the prep, serve and verify functions go through the
program ledger (``staged.prep``, ``engine.search_fanout``,
``staged.verify``, with the hot-key tier ``staged.cache_probe``;
``staged_mixed.prep``, ``staged_mixed.serve_fanout``,
``staged_mixed.verify``; the front door's ``serve.device_prep``), so a
new shape inside a sealed window counts as a retrace.  A step touches no
other obs object: the caller attributes a drained window to the SLO plane
with ``step.record_slo``, and publishes ``phase_profile``'s walls with
:func:`record_phase_obs`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError
from sherman_tpu_torch.models.batched import (ST_APPLIED, ST_SUPERSEDED,
                                              mixed_step_spmd)
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.obs import slo as SLO
from sherman_tpu_torch.ops import bits
from sherman_tpu_torch.parallel import mesh as MESH
from sherman_tpu_torch.workload import threefry

_MASK = bits.U32_MASK
_HEAD = 64                     # exact head ranks of the analytic sampler


# ---------------------------------------------------------------------------
# Host-side sampler constants.
# ---------------------------------------------------------------------------

def zipf_table(n: int, theta: float, log2_bins: int = 20) -> np.ndarray:
    """Inverse-CDF quantile table for Zipf(theta) ranks over [0, n):
    int32 [2^log2_bins + 1], ``table[i]`` = smallest 0-based rank r with
    CDF(r) >= i / 2^log2_bins (``table[-1]`` = n - 1).

    theta == 0 degenerates to the uniform ramp.  Head ranks are exact
    (float64 cumsum of the harmonic series up to 2^22); tail CDF values
    use the Euler-Maclaurin continuation, inverted by bisection."""
    assert 0.0 <= theta < 1.0 and n >= 1
    nb = 1 << log2_bins
    if theta == 0.0:
        t = np.floor(np.arange(nb + 1, dtype=np.float64) * n / nb)
        table = np.minimum(t, n - 1).astype(np.int32)
    else:
        M = min(n, 1 << 22)
        f = np.arange(1, M + 1, dtype=np.float64) ** -theta
        Hhead = np.cumsum(f)
        om = 1.0 - theta

        def H(r):
            """Harmonic partial sum for real r >= M (Euler-Maclaurin)."""
            r = np.asarray(r, np.float64)
            integral = (r ** om - float(M) ** om) / om
            half = 0.5 * (r ** -theta - float(M) ** -theta)
            d112 = (theta / 12.0) * (r ** (-theta - 1.0)
                                     - float(M) ** (-theta - 1.0))
            return Hhead[-1] + integral + half - d112

        Hn = Hhead[-1] if n <= M else float(H(float(n)))
        q = np.arange(nb + 1, dtype=np.float64) / nb * Hn
        table = np.searchsorted(Hhead, q, side="left").astype(np.int64)
        tail = q > Hhead[-1]
        if tail.any():
            qt = q[tail]
            lo = np.full(qt.shape, float(M))
            hi = np.full(qt.shape, float(n))
            for _ in range(48):
                mid = 0.5 * (lo + hi)
                ge = H(mid) >= qt
                hi = np.where(ge, mid, hi)
                lo = np.where(ge, lo, mid)
            table[tail] = np.ceil(hi).astype(np.int64) - 1
        table = np.minimum(np.maximum(table, 0), n - 1).astype(np.int32)
    assert (np.diff(table) >= 0).all()
    assert int(np.diff(table.astype(np.int64)).max(initial=0)) < (1 << 24), \
        "quantile bin wider than the 24-bit lerp resolution; raise log2_bins"
    return table


def zipf_analytic_consts(n: int, theta: float, head: int = _HEAD) -> dict:
    """Float64 constants of the analytic inverse CDF
    (:func:`_gen_ranks_analytic`): exact partial sums H(1..head) for the
    head, and the Euler-Maclaurin continuation constants for the tail."""
    assert 0.0 < theta < 1.0 and n > head
    f = np.arange(1, head + 1, dtype=np.float64) ** -theta
    Hh = np.cumsum(f)
    om = 1.0 - theta
    M = float(head)

    def H(r):
        r = np.asarray(r, np.float64)
        return (Hh[-1] + (r ** om - M ** om) / om
                + 0.5 * (r ** -theta - M ** -theta)
                - (theta / 12.0) * (r ** (-theta - 1.0)
                                    - M ** (-theta - 1.0)))

    return {
        "head_sums": Hh, "om": om, "theta": theta, "M": M,
        "Hn": float(H(float(n))),
        # tail start: r0 = (om*(x - B0))^(1/om) drops the small E-M
        # terms; the Newton steps restore them
        "B0": float(Hh[-1] - (M ** om) / om),
    }


# ---------------------------------------------------------------------------
# Device pieces of the prep (pure functions of their tensors).
# ---------------------------------------------------------------------------

def _analytic_terms(consts: dict, device) -> dict:
    """The analytic sampler's float32 constants as device tensors (each
    float64 constant rounded to nearest, as the reference rounds it)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    th, M, om = consts["theta"], consts["M"], consts["om"]
    t = {"Hh": f(consts["head_sums"]), "om": f(om), "theta": f(th),
         "Mf": f(M), "Hn": f(consts["Hn"]), "HhM": f(consts["head_sums"][-1]),
         "c_half": f(0.5 * M ** -th), "c_d12": f((th / 12.0) * M ** (-th - 1.0)),
         "Mom": f(M ** om), "B0": f(consts["B0"])}
    t["th12"] = t["theta"] / 12.0
    t["du"] = f(2.0 ** -24) * t["Hn"]
    return t


def _gen_ranks_analytic(consts: dict, w, *, n_keys: int, terms=None):
    """Zipf ranks via the analytic inverse CDF (no table gather).

    ``w``: uint32 words (in int64) with ``w[0]``, ``w[1]`` the two draws
    of every client.  u from 24 bits of ``w[0]`` -> x = u * H(n); head
    ranks (< 64) count the exact partial sums below x; the tail inverts
    the Euler-Maclaurin continuation at both edges of x's 2^-24-wide
    cell (closed-form start, two Newton steps, H'(r) = r^-theta) and
    lerps between them on 24 bits of ``w[1]``.  ``terms``: the device
    constants of :func:`_analytic_terms` (built here when absent)."""
    t = terms if terms is not None else _analytic_terms(consts, w.device)
    om, theta, Mf = t["om"], t["theta"], t["Mf"]
    u = (w[0] >> 8).to(torch.float32) * (2.0 ** -24)
    x = u * t["Hn"]
    # head: rank = #(partial sums < x), CDF-exact for ranks < 64
    rank_head = torch.searchsorted(t["Hh"], x.contiguous()).to(torch.int32)

    def invert(xt):
        r = torch.exp(torch.log(om * (xt - t["B0"])) / om)
        for _ in range(2):
            r = torch.maximum(r, Mf)
            rmt = torch.exp(-theta * torch.log(r))          # r^-theta
            Hr = (t["HhM"] + (r * rmt - t["Mom"]) / om + 0.5 * rmt
                  - t["c_half"] - t["th12"] * (rmt / r) + t["c_d12"])
            r = r - (Hr - xt) / rmt
        return torch.maximum(r, Mf)

    xt = torch.maximum(x, t["HhM"])
    r_lo = invert(xt)
    r_hi = invert(xt + t["du"])
    v = (w[1] >> 8).to(torch.float32) * (2.0 ** -24)
    rank_tail = (r_lo + (r_hi - r_lo) * v).to(torch.int32)
    rank = torch.where(rank_head < t["Hh"].shape[0], rank_head, rank_tail)
    return rank.clamp(0, n_keys - 1)


def _gen_ranks(tpair, w, *, log2_bins: int, n_keys: int):
    """Zipf ranks from the quantile table: the bin from the top
    ``log2_bins`` bits of ``w[0]`` (CDF-exact edges), an f32 lerp within
    the bin on 24 bits of ``w[1]``.  ``tpair`` is the [nb, 2] int32
    edge-pair table (one gather a client)."""
    t2 = tpair[w[0] >> (32 - log2_bins)]
    lo_r, hi_r = t2[..., 0], t2[..., 1]
    frac = (w[1] >> 8).to(torch.float32) * (2.0 ** -24)
    rank = lo_r + ((hi_r - lo_r).to(torch.float32) * frac).to(torch.int32)
    return rank.clamp(0, n_keys - 1)


def _keys_of_ranks(rank, salt_hi: int, salt_lo: int):
    """The rank->key map ``mix64(rank ^ salt)`` on uint32 words.  Ranks
    are below 2^31, so the high word of ``rank ^ salt`` is salt's."""
    xlo = (rank.to(torch.int64) & _MASK) ^ salt_lo
    return bits.mix64_pair(torch.full_like(xlo, salt_hi), xlo)


_TOP = 1 << 31


def _sort_combine(khi, klo, cap: int):
    """Sort-based request combining along the last dimension, without a
    host sync.  ``khi``/``klo``: uint32 words (int64) ``[..., n]``.

    Returns ``(skhi, sklo, ckhi, cklo, seg, n_uniq)``: the clients'
    keys sorted, the unique keys first in key order (then the duplicates
    in key order, as padding) cut to ``cap``, each client's unique row
    (int32) and the unique count (int32, a device tensor ``[...]``)."""
    key = (khi - _TOP) * (1 << 32) + klo     # signed order = unsigned
    sk = torch.sort(key, dim=-1).values
    n = sk.shape[-1]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[..., 1:] = sk[..., 1:] != sk[..., :-1]
    seg = torch.cumsum(first, dim=-1) - 1
    n_uniq = seg[..., -1] + 1
    # the reference's flag sort (1 - first, key) over key-sorted rows:
    # first occurrences to [0, n_uniq), duplicates after them, both in
    # key order
    idx = torch.arange(n, device=sk.device)
    dest = torch.where(first, seg, n_uniq[..., None] + idx - seg - 1)
    ck = torch.empty_like(sk).scatter_(-1, dest, sk)[..., :cap]
    word = lambda k: ((k >> 32) + _TOP, k & _MASK)
    skhi, sklo = word(sk)
    ckhi, cklo = word(ck)
    return (skhi, sklo, ckhi, cklo, seg.to(torch.int32),
            n_uniq.to(torch.int32))


def _router_probe(rtable, ukhi, uklo, shift: int, nb: int):
    """Index-cache probe: bucket = min(key >> shift, nb - 1) as unsigned
    64-bit arithmetic on the words, one gather from the router table."""
    bhi, blo = bits.u64_shr(ukhi, uklo, shift)
    bucket = torch.where(bhi != 0, nb - 1, blo.clamp(max=nb - 1))
    return rtable[bucket]


def _stage_inputs(dsm, router, n_keys: int, theta: float, log2_bins: int,
                  seed: int, sampler: str = "table"):
    """Stage the step's device-resident inputs once, before any timed
    region: the [nb, 2] zipf edge-pair table (a [1, 2] dummy for the
    analytic sampler), a copy of the router table taken under its lock,
    and the PRNG key."""
    if sampler == "analytic":
        table = np.zeros((1, 2), np.int32)
    else:
        t = zipf_table(n_keys, theta, log2_bins)
        table = np.stack([t[:-1], t[1:]], axis=1)
    with router._read_locked():
        rtable = np.array(router.table_np, np.int32)
    dev = dsm.device
    return (torch.from_numpy(np.ascontiguousarray(table)).to(dev),
            torch.from_numpy(rtable).to(dev),
            threefry.PRNGKey(seed, device=dev))


# ---------------------------------------------------------------------------
# Timing and the two-deep pipeline slot.
# ---------------------------------------------------------------------------

def _delta_ms(loop, reps: int) -> float:
    """Chained-delta timing on the host clock: ``(t(2K) - t(K)) / K`` in
    ms for ``loop(k)`` (k chained calls ending in a drain); cancels the
    per-call fixed cost."""
    loop(1)
    t0 = time.perf_counter()
    loop(reps)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop(2 * reps)
    t2 = time.perf_counter() - t0
    return max(0.0, (t2 - t1) / reps * 1e3)


def _cuda_ms(loop, reps: int) -> float:
    """Device-stream time per call, in ms, of ``loop(reps)`` between two
    CUDA events (after one warm call): what the stream spends on the
    phase, host-bound gaps inside it included."""
    loop(1)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    loop(reps)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _phase_ms(device, loop, reps: int) -> float:
    return (_cuda_ms if torch.device(device).type == "cuda"
            else _delta_ms)(loop, reps)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def overlap_receipt(prep_ms: float, serve_ms: float, verify_ms: float,
                    wall_ms: float) -> dict:
    """``bubble_ms`` = wall - serve (the work not hidden behind the
    serve) and ``overlap_efficiency`` = 1 - wall / (prep + serve +
    verify) (0 = fully serial)."""
    serial = prep_ms + serve_ms + verify_ms
    return {
        "wall_ms": wall_ms,
        "bubble_ms": max(0.0, wall_ms - serve_ms),
        "overlap_efficiency": (1.0 - wall_ms / serial
                               if serial > 0 else 0.0),
    }


def _two_deep_slot(jverify):
    """The pipelined forms' pending slot: ``fold`` folds a parked batch's
    verify inputs (if any) into the receipts, ``put`` parks batch k's,
    ``drain`` flushes the slot so the carry equals the sequential form's,
    ``reset`` clears it without folding."""
    pend = {"slot": None}

    def fold(rcarry):
        if pend["slot"] is not None:
            rcarry = jverify(rcarry, *pend["slot"])
        return rcarry

    def put(*slot):
        pend["slot"] = slot

    def drain(carry):
        step_idx, *rcarry = carry
        rcarry = tuple(rcarry)
        if pend["slot"] is not None:
            rcarry = jverify(rcarry, *pend["slot"])
            pend["slot"] = None
        return (step_idx,) + rcarry

    def reset():
        pend["slot"] = None

    return fold, put, drain, reset


def _rank_sampler(sampler: str, n_keys: int, theta: float, log2_bins: int,
                  device):
    """-> (rank(tpair, w), effective name).  ``analytic`` needs 0 < theta
    < 1 and more keys than its exact head; otherwise the quantile table
    runs, and the name says so."""
    if sampler == "analytic" and 0.0 < theta < 1.0 and n_keys > _HEAD:
        zc = zipf_analytic_consts(n_keys, theta)
        terms = _analytic_terms(zc, device)
        return (lambda tpair, w: _gen_ranks_analytic(
            zc, w, n_keys=n_keys, terms=terms), "analytic")
    return (lambda tpair, w: _gen_ranks(tpair, w, log2_bins=log2_bins,
                                        n_keys=n_keys), "table")


def _words(v: int) -> tuple[int, int]:
    return (v >> 32) & _MASK, v & _MASK


def _client_keys(gen_ranks, tpair, rkey, step_idx, N: int, batch: int,
                 salt: int, nodes: range | None = None):
    """Every node's ``batch`` client keys of one step: node n draws from
    ``fold_in(rkey, step_idx * N + n)``.  ``nodes``: the nodes this
    process serves (all ``N`` by default).  -> (khi, klo)
    ``[len(nodes), batch]`` uint32 words."""
    nodes = range(N) if nodes is None else nodes
    nodes = torch.arange(nodes.start, nodes.stop, dtype=torch.int64,
                         device=rkey.device)
    k = threefry.fold_in(rkey, (step_idx * N + nodes) & _MASK)   # [N, 2]
    w = threefry.bits(k, (2, batch)).transpose(0, 1)             # [2, N, b]
    rank = gen_ranks(tpair, w)
    return _keys_of_ranks(rank, *_words(salt))


def record_phase_obs(prefix: str, phases: dict) -> None:
    """Route one phase/overlap dict (``phase_profile``'s) into obs:
    ``overlap_efficiency`` is a ratio and lands in a gauge; every wall
    cost lands in a ``<prefix>.<name>_ms`` histogram (``wall_ms`` and
    ``bubble_ms`` already carry the unit)."""
    for name, v in phases.items():
        if name == "overlap_efficiency":
            obs.gauge(f"{prefix}.overlap_efficiency").set(v)
        else:
            h = name if name.endswith("_ms") else f"{name}_ms"
            obs.histogram(f"{prefix}.{h}").record(v)


def _slo_hook(step, op_class: str, batch: int) -> None:
    """``step.slo_class`` and ``step.record_slo(n_steps, elapsed_s)``: the
    driver attributes a whole drained window at once (the per-step
    dispatch path carries no obs work), ``batch`` client ops a step."""
    step.slo_class = op_class

    def record_slo(n_steps: int, elapsed_s: float) -> None:
        SLO.observe(op_class, n_steps * batch, elapsed_s, batches=n_steps)

    step.record_slo = record_slo


def _check_step_args(eng):
    if eng.router is None:
        raise ConfigError("attach_router() first: the staged loop probes "
                          "the engine's router")


def _receipts(carry, ops) -> list:
    """The carry as host ints, reduced over the ranks when the nodes span
    processes (each rank's carry folds only its own nodes): ``ops`` names
    each field's reduction, ``same`` for the step counters every rank
    agrees on."""
    vals = [int(x) for x in carry]
    if not MESH.process_layout()[0] > 1:
        return vals
    from sherman_tpu_torch.parallel import bootstrap
    g = bootstrap.process_allgather(np.asarray(vals, np.int64))
    red = {"sum": np.sum, "min": np.min, "max": np.max,
           "same": lambda c: c[0]}
    return [int(red[op](g[:, i])) for i, op in enumerate(ops)]


# ---------------------------------------------------------------------------
# The staged read loop (YCSB-C).
# ---------------------------------------------------------------------------

def make_staged_step(eng, *, n_keys: int, theta: float, salt: int,
                     batch: int, dev_b: int, log2_bins: int = 20,
                     check_xor: int = 0xDEADBEEF, seed: int = 11,
                     staged=None, sampler: str = "table",
                     fusion: str | None = None, leaf_cache=None,
                     dev_b_resid: int | None = None):
    """The device-staged read step for ``eng`` (a ``BatchedEngine`` with
    an attached router).

    Returns ``(step, (new_carry, table_d, rtable_d, rkey_d))``; then
    ``counters, carry = step(pool, counters, table_d, rtable_d, rkey_d,
    carry)`` runs one step: every node generates ``batch`` zipf client
    keys from the carry's step counter, combines them to at most
    ``dev_b`` unique rows, probes the router, serves them through the
    engine's fan-out and folds the receipts into the carry ``(step_idx,
    ok, n_correct, sum_nuniq, max_nuniq)``: ``ok`` goes 0 if a node's
    unique count overflowed ``dev_b``; ``n_correct`` counts client ops
    whose value equals ``key ^ check_xor`` (``S * batch * N`` after S
    good steps).  ``step_idx`` is a uint32 word in int64, the rest int32
    device scalars.  ``counters`` is updated in place (and returned).

    ``fusion`` (default :func:`sherman_tpu_torch.config.staged_fusion`):
    ``aligned`` runs prep -> serve -> verify; ``pipelined`` runs the same
    three phases two deep — call k folds batch k-1's answers into the
    receipts, then preps and serves batch k — so the receipts lag one
    batch until ``step.drain(carry)``, after which the carry equals
    ``aligned``'s.  The pending slot lives on the step: one pipelined
    step drives one carry stream (``new_carry()`` resets it).
    ``chained`` and ``fused`` raise :class:`ConfigError`.

    ``leaf_cache`` (optional): an attached
    :class:`~sherman_tpu_torch.models.leaf_cache.LeafCache`.  A fourth
    program, ``cache_probe`` (ledgered ``staged.cache_probe``), runs
    between prep and serve: validated hits leave the unique batch and the
    misses are compacted into a residual of ``dev_b_resid`` rows a node
    (default ``dev_b``: no shrink), the width the serve descends.  The
    verify merges the cache's answers back per client row before the
    same receipts, so the drained receipts equal the uncached loop's;
    the carry gains ``sum_hits`` (client ops served by the cache) and
    ``sum_hits_uniq`` (unique rows taken out of the serve) at its end.
    A step whose misses overflow ``dev_b_resid`` voids the run through
    ``ok``, as the ``dev_b`` cap does.  The cache's tables are staged
    once here: in the window a stale entry keeps missing (the pool
    validation stays the guard), and nothing invalidates on the device.

    Attributes: ``fusion``, ``sampler`` (effective), ``pipeline_depth``,
    ``cache``, ``cache_slots``, ``dev_b_resid`` (None without the cache),
    ``drain``, ``programs`` (phase -> ledgered function),
    ``phase_labels`` (phase -> ledger label), ``jprep``/``jserve``/
    ``jverify``, ``slo_class`` (``read``) and ``record_slo(n_steps,
    elapsed_s)``, which attributes a drained window of ``n_steps`` steps
    to the SLO plane at once (the step itself does no obs work), and
    ``phase_profile(pool, counters, table_d, rtable_d,
    rkey_d, reps=4) -> ({phase: ms}, counters)``: each phase's time per
    call — device-stream time between CUDA events on the card, the K/2K
    chained delta on the host clock on the CPU — plus, when pipelined,
    the overlap receipt of the drained pipelined step (the cache probe's
    time counted on the prep's side)."""
    fusion = fusion or C.staged_fusion()
    if fusion in C.STAGED_FUSIONS_NOT_BUILT:
        raise ConfigError(
            f"fusion={fusion!r} is an XLA program-structure form the port "
            "does not build yet; want aligned|pipelined")
    if fusion not in C.STAGED_FUSIONS:
        raise ConfigError(f"fusion={fusion!r}: want aligned|pipelined")
    _check_step_args(eng)
    if not 0 < dev_b <= batch:
        raise ConfigError(f"dev_b={dev_b}: the unique-row cap must lie in "
                          f"1..batch={batch}")
    use_cache = leaf_cache is not None
    R_resid = int(dev_b_resid) if dev_b_resid else dev_b
    if use_cache and not 0 < R_resid <= dev_b:
        raise ConfigError(f"dev_b_resid={R_resid}: the residual cap must "
                          f"lie in 1..dev_b={dev_b}")
    router, cfg, dsm = eng.router, eng.cfg, eng.dsm
    dev = eng.device
    mesh = MESH.of(cfg)
    # across processes a rank generates, serves and verifies its own
    # nodes' clients; the fan-out's table spans every node
    N = mesh.n_local
    iters = eng._iters()
    shift, nb = int(router.shift), int(router.nb)
    LB = int(log2_bins)
    gen_ranks, sampler = _rank_sampler(sampler, n_keys, theta, LB, dev)
    root = int(eng.tree._root_addr)
    cx_hi, cx_lo = _words(check_xor)
    node_off = (torch.arange(mesh.lo, mesh.lo + N, dtype=torch.int32,
                             device=dev) * dev_b)[:, None]
    iota_b = torch.arange(dev_b, device=dev)

    def prep(tpair, rtable, rkey, step_idx):
        step_idx = torch.as_tensor(step_idx, dtype=torch.int64, device=dev)
        khi_u, klo_u = _client_keys(gen_ranks, tpair, rkey, step_idx,
                                    cfg.machine_nr, batch, salt,
                                    mesh.local_nodes)
        skhi, sklo, ukhi, uklo, seg, n_uniq = _sort_combine(khi_u, klo_u,
                                                            dev_b)
        active = iota_b < n_uniq[:, None]
        start = _router_probe(rtable, ukhi, uklo, shift, nb)
        # the fan-out takes global unique rows of the node-major table
        inv = seg + node_off
        return ((step_idx + 1) & _MASK, skhi, sklo,
                bits.i32(ukhi).view(-1), bits.i32(uklo).view(-1),
                start.view(-1), active.view(-1), inv.view(-1), n_uniq)

    prep = DEV.wrap_program("staged.prep", prep)
    # the serve is the engine's own ledgered fan-out program
    jserve = eng._get_search_fanout(iters)

    def verify_core(rcarry, skhi, sklo, found, vhi, vlo, n_uniq):
        """Receipts: every (sorted-order) client answer must equal its
        key ^ check_xor, summed over the nodes."""
        ok, n_correct, sum_nu, max_nu = rcarry
        corr = (found & (vhi == bits.i32(skhi ^ cx_hi).view(-1))
                & (vlo == bits.i32(sklo ^ cx_lo).view(-1)))
        step_ok = (n_uniq <= dev_b).all().to(torch.int32)
        return (torch.minimum(ok, step_ok),
                n_correct + corr.sum().to(torch.int32),
                sum_nu + n_uniq.sum().to(torch.int32),
                torch.maximum(max_nu, n_uniq.max()))

    verify = verify_core
    jcache = cache_tables = None
    if use_cache:
        from sherman_tpu_torch.models.leaf_cache import probe_rows
        cache_tables = leaf_cache.device_tables()
        # the rank's nodes: local numbers index its own [N*dev_b] unique
        # rows, global ones the fan-out's table of every node's residual
        nodes = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
        gnodes = nodes + mesh.lo
        iota_r = torch.arange(R_resid, dtype=torch.int32,
                              device=dev).expand(N, R_resid)
        iota_u = torch.arange(dev_b, dtype=torch.int32,
                              device=dev).expand(N, dev_b)

        def cache_probe(pool, tkhi, tklo, tvhi, tvlo, tver, taddr, tslot,
                        khi, klo, active, start, inv):
            """Probe the unique rows, then compact every node's misses
            into its first ``R_resid`` residual rows (their order kept;
            rows past the cap are dropped and void the step through
            ``n_resid``), and remap each client's unique row onto the
            residual (a hit client lands on residual row 0: the verify
            overwrites its answer)."""
            tbl = dict(khi=tkhi, klo=tklo, vhi=tvhi, vlo=tvlo, ver=tver,
                       addr=taddr, slot=tslot)
            hit, cvhi, cvlo, _, _ = probe_rows(pool, tbl, khi, klo, active,
                                               cfg=cfg)
            resid = (active & ~hit).view(N, dev_b)
            pos = torch.cumsum(resid.to(torch.int32), dim=1) - 1
            n_resid = resid.sum(dim=1).to(torch.int32)
            keep = resid & (pos < R_resid)
            # each kept unique row into its residual position (column
            # R_resid is the sink of the rest); unfilled slots hold dev_b
            sidx = torch.full((N, R_resid + 1), dev_b, dtype=torch.int32,
                              device=dev)
            sidx.scatter_(1, torch.where(keep, pos, R_resid).long(), iota_u)
            sidx = sidx[:, :R_resid]
            valid = sidx < dev_b
            ci = (sidx.clamp(0, dev_b - 1) + nodes * dev_b).view(-1).long()
            remap = torch.zeros((N, dev_b + 1), dtype=torch.int32,
                                device=dev)
            remap.scatter_(1, torch.where(valid, sidx, dev_b).long(), iota_r)
            loc = (inv.view(N, -1) - gnodes * dev_b).clamp(0, dev_b)
            inv_r = remap.gather(1, loc.long()) + gnodes * R_resid
            return (hit, cvhi, cvlo, khi[ci], klo[ci], start[ci],
                    valid.view(-1), inv_r.view(-1), n_resid)

        jcache = DEV.wrap_program("staged.cache_probe", cache_probe)

        def verify(rcarry, skhi, sklo, found, vhi, vlo, n_uniq, seg, hit,
                   cvhi, cvlo, n_resid):
            """Cache-aware receipts: each client's cache answer (through
            its global unique row ``seg``, which lies on the client's own
            node, so on this rank) overrides the serve's, then the same
            receipts, the two hit sums and the residual cap's void."""
            ok, n_correct, sum_nu, max_nu, hits_c, hits_u = rcarry
            ctab = torch.stack([hit.to(torch.int32), cvhi, cvlo], dim=1)
            cout = ctab[(seg - mesh.lo * dev_b).clamp(0, ctab.shape[0] - 1)]
            chit = cout[:, 0] != 0
            rok = (n_resid <= R_resid).all().to(torch.int32)
            base = verify_core(
                (ok, n_correct, sum_nu, max_nu), skhi, sklo, found | chit,
                torch.where(chit, cout[:, 1], vhi),
                torch.where(chit, cout[:, 2], vlo), n_uniq)
            return ((torch.minimum(base[0], rok),) + tuple(base[1:])
                    + (hits_c + chit.sum().to(torch.int32),
                       hits_u + hit.sum().to(torch.int32)))

    verify = DEV.wrap_program("staged.verify", verify)

    def serve(pool, counters, khi, klo, active, start, inv):
        return jserve(pool, counters, khi, klo, root, active, start, inv)

    def served(pool, counters, arrs):
        """Probe (cache on) and serve one prepped batch.  -> the verify's
        inputs after the receipts carry."""
        skhi, sklo, khi, klo, start, active, inv, nu = arrs
        if not use_cache:
            _, found, vhi, vlo = serve(pool, counters, khi, klo, active,
                                       start, inv)
            return skhi, sklo, found, vhi, vlo, nu
        (hit, cvhi, cvlo, rkhi, rklo, rstart, ractive, rinv,
         nr) = jcache(pool, *cache_tables, khi, klo, active, start, inv)
        _, found, vhi, vlo = serve(pool, counters, rkhi, rklo, ractive,
                                   rstart, rinv)
        return skhi, sklo, found, vhi, vlo, nu, inv, hit, cvhi, cvlo, nr

    pipe_reset = None
    if fusion == "aligned":
        def step(pool, counters, tpair, rtable, rkey, carry):
            step_idx, *rcarry = carry
            step_idx, *arrs = prep(tpair, rtable, rkey, step_idx)
            vin = served(pool, counters, arrs)
            rcarry = verify(tuple(rcarry), *vin)
            return counters, (step_idx,) + tuple(rcarry)

        step.drain = lambda carry: carry
    else:
        fold, put, drain, pipe_reset = _two_deep_slot(verify)

        def step(pool, counters, tpair, rtable, rkey, carry):
            step_idx, *rcarry = carry
            rcarry = fold(tuple(rcarry))                  # batch k-1
            step_idx, *arrs = prep(tpair, rtable, rkey, step_idx)
            put(*served(pool, counters, arrs))            # batch k
            return counters, (step_idx,) + tuple(rcarry)

        step.drain = drain

    def new_carry():
        """A fresh device-resident carry; also empties the pipelined
        form's pending slot."""
        if pipe_reset is not None:
            pipe_reset()
        z = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        return ((torch.zeros((), dtype=torch.int64, device=dev), z(1), z(0),
                 z(0), z(0)) + ((z(0), z(0)) if use_cache else ()))

    def phase_profile(pool, counters, tpair, rtable, rkey, reps: int = 4):
        """Time per call of each phase (see :func:`make_staged_step`).
        Read-only: safe between measured windows."""
        out = {}

        def prep_loop(k):
            si = new_carry()[0]
            for _ in range(k):
                si = prep(tpair, rtable, rkey, si)[0]

        out["prep"] = _phase_ms(dev, prep_loop, reps)
        (_, skhi, sklo, khi, klo, start, active, inv,
         nu) = prep(tpair, rtable, rkey, new_carry()[0])
        extra = ()
        inv_s = inv
        if use_cache:
            def cache_loop(k):
                for _ in range(k):
                    jcache(pool, *cache_tables, khi, klo, active, start,
                           inv)

            out["cache_probe"] = _phase_ms(dev, cache_loop, reps)
            # the serve is timed on the compacted residual, the width
            # the cached loop descends
            (hit, cvhi, cvlo, khi, klo, start, active, inv_s,
             nr) = jcache(pool, *cache_tables, khi, klo, active, start, inv)
            extra = (inv, hit, cvhi, cvlo, nr)

        def serve_loop(k):
            for _ in range(k):
                serve(pool, counters, khi, klo, active, start, inv_s)

        out["serve_fanout"] = _phase_ms(dev, serve_loop, reps)
        _, f, vh, vl = serve(pool, counters, khi, klo, active, start, inv_s)

        def verify_loop(k):
            rc = tuple(new_carry()[1:])
            for _ in range(k):
                rc = verify(rc, skhi, sklo, f, vh, vl, nu, *extra)

        out["verify"] = _phase_ms(dev, verify_loop, reps)
        if fusion == "pipelined":
            def pipe_loop(k):
                c = new_carry()
                for _ in range(k):
                    c = step(pool, counters, tpair, rtable, rkey, c)[1]
                step.drain(c)

            out.update(overlap_receipt(
                out["prep"] + out.get("cache_probe", 0.0),
                out["serve_fanout"], out["verify"],
                _phase_ms(dev, pipe_loop, reps)))
        _sync(dev)
        return out, counters

    step.fusion, step.sampler = fusion, sampler
    step.pipeline_depth = 2 if fusion == "pipelined" else 1
    step.jprep, step.jserve, step.jverify = prep, jserve, verify
    step.programs = {"prep": prep, "serve_fanout": jserve, "verify": verify}
    if use_cache:
        # dispatch order: prep -> cache_probe -> serve -> verify
        step.jcache = jcache
        step.programs = {"prep": prep, "cache_probe": jcache,
                         "serve_fanout": jserve, "verify": verify}
    step.cache = use_cache
    step.cache_slots = leaf_cache.slots if use_cache else None
    step.dev_b_resid = R_resid if use_cache else None
    step.phase_labels = {name: prog.label
                         for name, prog in step.programs.items()}
    _slo_hook(step, "read", batch)
    step.phase_profile = phase_profile
    step.dev_b = dev_b
    # the drained carry as host ints, summed over the ranks
    step.receipts = lambda carry: _receipts(
        carry, ("same", "min", "sum", "sum", "max")
        + (("sum", "sum") if use_cache else ()))
    table_d, rtable_d, rkey_d = staged or _stage_inputs(
        dsm, router, n_keys, theta, LB, seed, sampler)
    return step, (new_carry, table_d, rtable_d, rkey_d)


# ---------------------------------------------------------------------------
# The staged mixed loop (YCSB-A/B).
# ---------------------------------------------------------------------------

def make_staged_mixed_step(eng, *, n_keys: int, theta: float, salt: int,
                           batch: int, read_ratio: float, dev_rb: int,
                           dev_wb: int, log2_bins: int = 20,
                           check_xor: int = 0xDEADBEEF, seed: int = 13,
                           staged=None, sampler: str = "table",
                           fusion: str | None = None):
    """The device-staged mixed step: each node's ``batch`` clients are
    ``R = round(batch * read_ratio)`` point reads then ``batch - R``
    in-place updates of zipf keys, each class combined on its own and
    served from the ``[reads | writes]`` row block of one fused
    ``mixed_step_spmd`` (``write_lo = dev_rb``, ``update_only``): reads
    see the pre-step pool, writes land at the step boundary.

    Write values stamp the step, ``key ^ check_xor ^ (step + 1)``, so a
    step's duplicate writes agree and a read passes only if its value
    decodes to an earlier step (the bulk load decodes to 0): the
    linearization check runs on the card.  Every write client's status
    must be ``ST_APPLIED`` (with several nodes ``ST_SUPERSEDED`` by an
    identical-value winner also passes).

    ``pool, counters, carry = step(pool, locks, counters, table_d,
    rtable_d, rkey_d, carry)`` with the carry ``(step_idx, ok,
    n_correct_reads, n_ok_writes, sum_nuniq, max_nuniq_r, max_nuniq_w,
    serve_step_idx)``; ``serve_step_idx`` is the serve's own step count
    (the decode bound).  ``fusion``: ``chained`` (default unless
    ``SHERMAN_STAGED_FUSION=pipelined``) verifies each step in the call;
    ``pipelined`` folds the receipts one batch behind (the pool writes
    stay in serve order) until ``step.drain``, after which the carry
    equals ``chained``'s.  ``slo_class`` (``mixed``), ``record_slo`` and
    ``phase_labels`` as in :func:`make_staged_step`."""
    fusion = fusion or ("pipelined" if C.staged_fusion() == "pipelined"
                        else "chained")
    if fusion not in ("chained", "pipelined"):
        raise ConfigError(f"mixed fusion={fusion!r}: want "
                          "chained|pipelined")
    _check_step_args(eng)
    router, cfg, dsm = eng.router, eng.cfg, eng.dsm
    dev = eng.device
    mesh = MESH.of(cfg)
    N = mesh.n_local
    iters = eng._iters()
    shift, nb = int(router.shift), int(router.nb)
    LB = int(log2_bins)
    gen_ranks, sampler = _rank_sampler(sampler, n_keys, theta, LB, dev)
    root = int(eng.tree._root_addr)
    cx_hi, cx_lo = _words(check_xor)
    R = int(round(batch * read_ratio))
    Wc = batch - R
    if not (0 < R < batch and 0 < dev_rb <= R and 0 < dev_wb <= Wc):
        raise ConfigError(
            f"mixed loop: want both classes (R={R} of batch={batch}) and "
            f"caps within them (dev_rb={dev_rb}, dev_wb={dev_wb})")
    U = dev_rb + dev_wb
    nodes = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    iota_r = torch.arange(dev_rb, device=dev)
    iota_w = torch.arange(dev_wb, device=dev)
    zr = torch.zeros((N, dev_rb), dtype=torch.int64, device=dev)

    def prep(tpair, rtable, rkey, step_idx):
        step_idx = torch.as_tensor(step_idx, dtype=torch.int64, device=dev)
        khi_u, klo_u = _client_keys(gen_ranks, tpair, rkey, step_idx,
                                    cfg.machine_nr, batch, salt,
                                    mesh.local_nodes)
        rskhi, rsklo, rukhi, ruklo, rseg, r_nu = _sort_combine(
            khi_u[:, :R], klo_u[:, :R], dev_rb)
        _, _, wukhi, wuklo, wseg, w_nu = _sort_combine(
            khi_u[:, R:], klo_u[:, R:], dev_wb)
        akhi = torch.cat([rukhi, wukhi], dim=1)
        aklo = torch.cat([ruklo, wuklo], dim=1)
        act_r = torch.cat([iota_r < r_nu[:, None],
                           torch.zeros((N, dev_wb), dtype=torch.bool,
                                       device=dev)], dim=1)
        act_w = torch.cat([torch.zeros((N, dev_rb), dtype=torch.bool,
                                       device=dev),
                           iota_w < w_nu[:, None]], dim=1)
        stamp = (step_idx + 1) & _MASK
        vhi = torch.cat([zr, wukhi ^ cx_hi], dim=1)
        vlo = torch.cat([zr, wuklo ^ cx_lo ^ stamp], dim=1)
        start = _router_probe(rtable, akhi, aklo, shift, nb)
        return ((step_idx + 1) & _MASK, akhi, aklo, vhi, vlo, act_r,
                act_w, start, rskhi, rsklo, rseg, r_nu, wseg, w_nu)

    prep = DEV.wrap_program("staged_mixed.prep", prep)

    def serve(pool, locks, counters, akhi, aklo, vhi, vlo, act_r, act_w,
              start, rseg, wseg):
        """The fused descent/apply and the monotone per-client fan-out of
        read answers and write statuses (global rows with several
        nodes).  -> (pool, counters, out [N, R, 3], st_cli [N, Wc])."""
        flat = lambda x: bits.i32(x).view(-1)
        status, _, found, rvh, rvl = mixed_step_spmd(
            pool, locks, counters, flat(akhi), flat(aklo), flat(vhi),
            flat(vlo), root, act_r.view(-1), act_w.view(-1),
            start.view(-1), cfg=cfg, iters=iters, write_lo=dev_rb,
            update_only=True)
        ans = torch.stack([found.to(torch.int32), rvh, rvl], dim=1)
        ans = ans.view(N, U, 3)[:, :dev_rb].reshape(N * dev_rb, 3)
        stat_w = status.view(N, U)[:, dev_rb:].reshape(-1)
        out = ans[(rseg + nodes * dev_rb).clamp(0, ans.shape[0] - 1)]
        st_cli = stat_w[(wseg + nodes * dev_wb).clamp(
            0, stat_w.shape[0] - 1)]
        return pool, counters, out, st_cli

    serve = DEV.wrap_program("staged_mixed.serve_fanout", serve)

    def verify(rcarry, rskhi, rsklo, out, st_cli, r_nu, w_nu):
        """The on-card linearization check (a read's value must decode
        to a strictly earlier step) and the write-status audit."""
        ok, n_corr_r, n_ok_w, sum_nu, max_nu_r, max_nu_w, sidx = rcarry
        dec_hi = bits.u32(out[..., 1]) ^ rskhi ^ cx_hi
        dec_lo = bits.u32(out[..., 2]) ^ rsklo ^ cx_lo
        corr_r = (out[..., 0] != 0) & (dec_hi == 0) & (dec_lo <= sidx)
        ok_w = st_cli == ST_APPLIED
        if cfg.machine_nr > 1:
            ok_w = ok_w | (st_cli == ST_SUPERSEDED)
        step_ok = ((r_nu <= dev_rb) & (w_nu <= dev_wb)).all()
        i32 = lambda x: x.to(torch.int32)
        return (torch.minimum(ok, i32(step_ok)),
                n_corr_r + i32(corr_r.sum()),
                n_ok_w + i32(ok_w.sum()),
                sum_nu + i32((r_nu + w_nu).sum()),
                torch.maximum(max_nu_r, r_nu.max()),
                torch.maximum(max_nu_w, w_nu.max()),
                (sidx + 1) & _MASK)

    verify = DEV.wrap_program("staged_mixed.verify", verify)

    def served(pool, locks, counters, arrs):
        (akhi, aklo, vhi, vlo, act_r, act_w, start, rskhi, rsklo, rseg,
         r_nu, wseg, w_nu) = arrs
        pool, counters, out, st_cli = serve(
            pool, locks, counters, akhi, aklo, vhi, vlo, act_r, act_w,
            start, rseg, wseg)
        return pool, counters, (rskhi, rsklo, out, st_cli, r_nu, w_nu)

    pipe_reset = None
    if fusion == "chained":
        def step(pool, locks, counters, tpair, rtable, rkey, carry):
            step_idx, *rcarry = carry
            step_idx, *arrs = prep(tpair, rtable, rkey, step_idx)
            pool, counters, vin = served(pool, locks, counters, arrs)
            rcarry = verify(tuple(rcarry), *vin)
            return pool, counters, (step_idx,) + tuple(rcarry)

        step.drain = lambda carry: carry
    else:
        fold, put, drain, pipe_reset = _two_deep_slot(verify)

        def step(pool, locks, counters, tpair, rtable, rkey, carry):
            step_idx, *rcarry = carry
            rcarry = fold(tuple(rcarry))                  # batch k-1
            step_idx, *arrs = prep(tpair, rtable, rkey, step_idx)
            pool, counters, vin = served(pool, locks, counters, arrs)
            put(*vin)
            return pool, counters, (step_idx,) + tuple(rcarry)

        step.drain = drain

    def new_carry():
        """``(step_idx, ok, n_correct_reads, n_ok_writes, sum_nuniq,
        max_nuniq_r, max_nuniq_w, serve_step_idx)``, fresh; also empties
        the pipelined form's pending slot."""
        if pipe_reset is not None:
            pipe_reset()
        z = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        u = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        return (u(), z(1), z(0), z(0), z(0), z(0), z(0), u())

    def phase_profile(pool, locks, counters, tpair, rtable, rkey,
                      reps: int = 4):
        """Time per call of each phase.  Not read-only: the serve is
        repeated on one prepped batch (same keys, same stamped values),
        so run it after the receipt-checked windows.  -> ({phase: ms},
        pool, counters)."""
        out = {}

        def prep_loop(k):
            si = new_carry()[0]
            for _ in range(k):
                si = prep(tpair, rtable, rkey, si)[0]

        out["prep"] = _phase_ms(dev, prep_loop, reps)
        arrs = prep(tpair, rtable, rkey, new_carry()[0])[1:]

        def serve_loop(k):
            for _ in range(k):
                served(pool, locks, counters, arrs)

        out["serve_fanout"] = _phase_ms(dev, serve_loop, reps)
        vin = served(pool, locks, counters, arrs)[2]

        def verify_loop(k):
            rc = tuple(new_carry()[1:])
            for _ in range(k):
                rc = verify(rc, *vin)

        out["verify"] = _phase_ms(dev, verify_loop, reps)
        if fusion == "pipelined":
            def pipe_loop(k):
                c = new_carry()
                for _ in range(k):
                    c = step(pool, locks, counters, tpair, rtable, rkey,
                             c)[2]
                step.drain(c)

            out.update(overlap_receipt(out["prep"], out["serve_fanout"],
                                       out["verify"],
                                       _phase_ms(dev, pipe_loop, reps)))
        _sync(dev)
        return out, pool, counters

    step.fusion, step.sampler = fusion, sampler
    step.pipeline_depth = 2 if fusion == "pipelined" else 1
    step.jprep, step.jserve, step.jverify = prep, serve, verify
    step.programs = {"prep": prep, "serve_fanout": serve, "verify": verify}
    step.phase_labels = {name: prog.label
                         for name, prog in step.programs.items()}
    _slo_hook(step, "mixed", batch)
    step.phase_profile = phase_profile
    step.receipts = lambda carry: _receipts(
        carry, ("same", "min", "sum", "sum", "sum", "max", "max", "same"))
    table_d, rtable_d, rkey_d = staged or _stage_inputs(
        dsm, router, n_keys, theta, LB, seed, sampler)
    return step, (new_carry, table_d, rtable_d, rkey_d)


# ---------------------------------------------------------------------------
# The serving front door's ingress step (host-fed batches).
# ---------------------------------------------------------------------------

def make_device_prep(eng, *, width: int):
    """Device request-plane prep for the ingress step
    (``config.prep_impl() == "device"``): on the card, what the host
    path's ``np.unique`` + ``LeafRouter.host_start`` + zero padding do,
    with the staged fan-out inputs ``(khi, klo, active, start, inv)``
    bit-identical to the host path's, plus the unique count as a device
    scalar.

    One sort of an int64 key built from the raw (hi, lo) words (the high
    word offset by 2^31, so signed order is the unsigned order) carries
    each client's row index; a segment cumsum numbers the unique groups
    (``np.unique``'s inverse is each key's rank among the unique keys);
    the first occurrences move to the front in key order (the
    reference's flag sort, as :func:`_sort_combine` computes it); the
    router probe shifts by a 0-d shift tensor
    (:func:`sherman_tpu_torch.ops.bits.u64_shr_dyn`), so a span grow
    changes data and not the call's signature; ``inv`` is the segment
    map un-sorted.  Ties among equal keys reach no output.

    Padding: rows past ``n`` carry the ``KEY_POS_INF`` pair ``(-1, -1)``,
    outside the valid key range, which sorts last and forms exactly one
    trailing group when ``n < width``; subtracting it gives the host's
    unique count, and the masked unique rows and the inverse map zero
    like the host path's padding.

    Returns ``prep_fn(khi_raw, klo_raw, n, rtable, shift) -> (khi, klo,
    active, start, inv, n_uniq)``: ``khi_raw``/``klo_raw`` int32
    ``[width]`` device tensors, ``n`` a Python int, ``rtable`` the router
    table and ``shift`` a 0-d int64 tensor on the engine's device.  The
    outputs span the whole width: across ranks every rank computes them
    all, and the ingress step hands the fan-out its nodes' block.  Plain
    torch: the reference computes this outside any Pallas kernel.
    Ledgered as ``serve.device_prep``."""
    dev = eng.device
    idx0 = torch.arange(width, device=dev)

    def prep_core(khi_raw, klo_raw, n, rtable, shift):
        key = (bits.u32(khi_raw) - _TOP) * (1 << 32) + bits.u32(klo_raw)
        sk, sidx = torch.sort(key)
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        seg = torch.cumsum(first, 0) - 1
        n_groups = seg[-1] + 1
        # the sentinel contributes one trailing group iff padding exists
        # shermanlint: disable=SL001 n, width: Python ints (count, rung)
        n_uniq = n_groups - int(n < width)
        # first occurrences to [0, n_groups) in key order, duplicates
        # behind them; the sentinel's head lands at n_uniq and is masked
        # with the rest of the tail, like the host pad
        dest = torch.where(first, seg, n_groups + idx0 - seg - 1)
        ck = torch.empty_like(sk).scatter_(0, dest, sk)
        active = idx0 < n_uniq
        ck = torch.where(active, ck, _TOP * -(1 << 32))   # key 0
        ukhi = (ck >> 32) + _TOP
        uklo = ck & _MASK
        # router probe (host_start's twin: key 0 -> bucket 0 -> table[0]
        # covers the masked tail exactly like the host)
        nb = rtable.shape[0]
        bhi, blo = bits.u64_shr_dyn(ukhi, uklo, shift)
        bucket = torch.where(bhi != 0, nb - 1, blo.clamp(max=nb - 1))
        start = rtable[bucket]
        # un-sort the segment map: inv[i] = unique rank of client row i
        inv = torch.empty_like(seg).scatter_(0, sidx, seg)
        inv = torch.where(idx0 < n, inv, 0)
        return (bits.i32(ukhi), bits.i32(uklo), active, start,
                inv.to(torch.int32), n_uniq.to(torch.int32))

    return DEV.wrap_program("serve.device_prep", prep_core)


def make_ingress_step(eng, *, width: int, leaf_cache=None,
                      prep_impl: str | None = None):
    """The serving front door's read path (:mod:`sherman_tpu_torch.serve`):
    the host-fed twin of the staged loops.  Client key batches of one
    fixed ``width`` are combined, probed and served through the engine's
    own fan-out function (``BatchedEngine._get_search_fanout``, the
    object ``search_combined`` and the staged loops call, so the
    program-identity pin and the ledger label carry over), with each
    client's answer fanned out on the device through the unique-inverse
    map.  Every ladder rung is one shape: a warmed, sealed serving loop
    records no new signature.

    Split protocol (the two-deep pipeline's raw material)::

        handle = step.dispatch(keys)        # keys u64 [n], 0 < n <= width
        vals, found = step.complete(handle) # copies to the host

    ``keys`` must be a uint64 array of in-range keys (the front door
    validates at admission).  Duplicates share one descent row; the
    unique set is key-sorted.  With ``leaf_cache`` the unique batch is
    probed first (validated hits leave the active set and merge back per
    client row in ``complete``, bit-identical to the uncached path) and
    the raw client stream feeds the admission sketch (``observe``).

    Unlike the reference's launch-only ``dispatch``, the port's syncs the
    host once per straggler round of the serve (``_routed_resolve`` reads
    its pending count back), so the ``pipelined`` form overlaps less.

    Stragglers (stale router seeds after splits or growth) are rescued in
    ``complete`` through the engine's root-descent ``search``.
    ``prep_impl`` (default :func:`sherman_tpu_torch.config.prep_impl`)
    places the prep: ``host`` or ``device`` (:func:`make_device_prep`; a
    step with a leaf cache falls back to ``host``, the probe being
    host-in/host-out).

    This factory and ``BatchedEngine.search_combined`` implement one
    combine/probe/fan-out/rescue/merge protocol at two width regimes;
    the parity tests pin the two equal."""
    router = eng.router
    if router is None:
        raise ConfigError("make_ingress_step: attach_router() first — "
                          "the front door serves router-seeded descents")
    if width <= 0 or width % eng.cfg.machine_nr != 0:
        raise ConfigError(
            f"ingress width {width} must be a positive multiple of "
            f"machine_nr={eng.cfg.machine_nr} (the batch is node-major)")
    if prep_impl is None:
        prep_impl = C.prep_impl()
    if prep_impl not in ("host", "device"):
        raise ConfigError(
            f"make_ingress_step: prep_impl={prep_impl!r}: want host|device")
    if prep_impl == "device" and leaf_cache is not None:
        # the documented fallback: the cache probe syncs its hit count,
        # which would bring back the per-batch host round trip
        prep_impl = "host"
    iters = eng._iters()
    fn = eng._get_search_fanout(iters)
    root = int(eng.tree._root_addr)
    dev = eng.device
    # histogram handles made here, so a dispatch records plain floats
    _h_prep = obs.histogram("prep.device_dispatch_ms"
                            if prep_impl == "device" else "prep.host_ms")
    obs.gauge("prep.impl_device").set(
        1.0 if prep_impl == "device" else 0.0)

    def _host_stage(keys):
        n = keys.shape[0]
        uk, inv = np.unique(keys, return_inverse=True)
        U = uk.shape[0]
        kh, kl = bits.keys_to_pairs(uk)
        khi = np.zeros(width, kh.dtype)
        klo = np.zeros(width, kl.dtype)
        khi[:U] = kh
        klo[:U] = kl
        active = np.zeros(width, bool)
        active[:U] = True
        return n, uk, inv.reshape(-1), U, khi, klo, active

    def dispatch(keys):
        t0p = time.perf_counter()
        n, uk, inv, U, khi, klo, active = _host_stage(keys)
        chit = cvhi = cvlo = None
        if leaf_cache is not None:
            # the sketch sees the raw (duplicated) client stream; the
            # probe drops validated hits out of the device batch
            leaf_cache.observe(keys)
            chit, cvhi, cvlo = leaf_cache.probe(khi, klo, active)
            active = active & ~chit
        start = router.host_start(khi, klo)
        inv_p = np.zeros(width, np.int32)
        inv_p[:n] = inv
        args = (eng._shard(khi), eng._shard(klo), root, eng._shard(active),
                eng._shard(start), eng._shard(inv_p))
        with eng._step_mutex:
            done, found, vhi, vlo = fn(eng.dsm.pool, eng.dsm.counters,
                                       *args)
        _h_prep.record((time.perf_counter() - t0p) * 1e3)
        return (n, U, uk, inv, done, found, vhi, vlo, chit, cvhi, cvlo)

    def _fetch(done, found, vhi, vlo):
        """The unique rows' done flags and the packed client answers on
        the host, whole on every rank (one copy each; across ranks one
        all-gather of every rank's rows), so every rank takes the same
        rescue decision and calls the collective ``search`` together."""
        return eng._unshard(done, torch.stack(
            [found.to(torch.int32), vhi, vlo], dim=1))

    def _answers(ans, n):
        return bits.pairs_to_keys(ans[:n, 1], ans[:n, 2]), ans[:n, 0] != 0

    def complete(handle):
        n, U, uk, inv, done, found, vhi, vlo, chit, cvhi, cvlo = handle
        done_u, ans = _fetch(done, found, vhi, vlo)
        done_u = done_u[:U]
        if chit is not None:
            done_u = done_u | chit[:U]
        if not done_u.all():
            # straggler rescue (stale seeds, height growth): the engine's
            # root-descent path answers the whole unique set
            vals_u, found_u = eng.search(uk)
            return vals_u[inv][:n], found_u[inv][:n]
        vals, fnd = _answers(ans, n)
        if chit is not None and chit[:U].any():
            # the hits' device rows were inactive: overwrite their client
            # rows through the inverse map the fan-out used
            ch = chit[:U][inv][:n]
            fnd[ch] = True
            vals[ch] = bits.pairs_to_keys(cvhi[:U], cvlo[:U])[inv][:n][ch]
        return vals, fnd

    def step(keys):
        """dispatch + complete in one call (closed loops, tests)."""
        return complete(dispatch(keys))

    def drain(handle):
        """Teardown completion (the front door's kill path): wait out the
        handle's device work and discard it, without the straggler
        rescue — a crashing server must not launch fresh descents."""
        done = handle[4]
        if done.is_cuda:
            torch.cuda.current_stream(done.device).synchronize()

    prep_fn = None
    if prep_impl == "device":
        prep_fn = make_device_prep(eng, width=width)
        # the router table on the card, versioned by the split and grow
        # counters (plain ints: two compares a dispatch, a copy only when
        # the table moved)
        _rt = {"ver": None, "rtable": None, "shift": None}

        def _router_state():
            ver = (router.splits_noted, router.span_grows)
            if _rt["ver"] != ver:
                with router._read_locked():
                    table = np.array(router.table_np)
                    shift = int(router.shift)
                    ver = (router.splits_noted, router.span_grows)
                _rt["rtable"] = torch.from_numpy(table).to(dev)
                _rt["shift"] = torch.tensor(shift, dtype=torch.int64,
                                            device=dev)
                _rt["ver"] = ver
            return _rt["rtable"], _rt["shift"]

        def _raw(keys):
            n = keys.shape[0]
            kh, kl = bits.keys_to_pairs(keys)
            khi_raw = np.full(width, -1, np.int32)   # the KEY_POS_INF pair
            klo_raw = np.full(width, -1, np.int32)
            khi_raw[:n] = kh
            klo_raw[:n] = kl
            return n, eng._dev(khi_raw), eng._dev(klo_raw)

        mesh = MESH.of(eng.cfg)
        per = width // eng.cfg.machine_nr
        blk = slice(mesh.lo * per, (mesh.lo + mesh.n_local) * per)

        def dispatch_device(keys):
            """``dispatch`` with the prep on the card: the host splits the
            pairs, pads with the sentinel and copies; combining, dedup,
            sort and the router probe run in ``prep_fn``, whose outputs
            feed the fan-out without touching the host (across ranks,
            each rank's nodes' block of them: the reference's
            node-sharded outputs)."""
            t0p = time.perf_counter()
            n, khi_raw, klo_raw = _raw(keys)
            rtable, shift = _router_state()
            khi, klo, active, start, inv_p, n_uniq = prep_fn(
                khi_raw, klo_raw, n, rtable, shift)
            with eng._step_mutex:
                done, found, vhi, vlo = fn(eng.dsm.pool, eng.dsm.counters,
                                           khi[blk], klo[blk], root,
                                           active[blk], start[blk],
                                           inv_p[blk])
            _h_prep.record((time.perf_counter() - t0p) * 1e3)
            return (n, n_uniq, (khi, klo), inv_p, done, found, vhi, vlo,
                    None, None, None)

        def complete_device(handle):
            """The unique count syncs here; the rescue copies the unique
            set and the inverse map only when a descent overran."""
            n, n_uniq, ukpair, inv_p, done, found, vhi, vlo, *_ = handle
            U = int(n_uniq)
            done_u, ans = _fetch(done, found, vhi, vlo)
            if not done_u[:U].all():
                ukhi, uklo = (t[:U].cpu().numpy() for t in ukpair)
                uk = bits.pairs_to_keys(ukhi, uklo)
                inv = inv_p[:n].cpu().numpy()
                vals_u, found_u = eng.search(uk)
                return vals_u[inv], found_u[inv]
            return _answers(ans, n)

        dispatch, complete = dispatch_device, complete_device

    def prep_profile(keys, reps: int = 8) -> dict:
        """Chained-delta wall of this step's prep alone, in ms (the
        host-vs-device A/B's number): host mode times ``np.unique``, the
        pad and the router probe; device mode chains ``prep_fn`` calls
        and syncs once at the end of each loop."""
        keys = np.asarray(keys, np.uint64)
        if prep_impl == "device":
            n, dk, dl = _raw(keys)
            rtable, shift = _router_state()

            def loop(k):
                for _ in range(k):
                    prep_fn(dk, dl, n, rtable, shift)
                _sync(dev)
            return {"prep_device_ms": _delta_ms(loop, reps)}

        def loop(k):
            for _ in range(k):
                _, _, _, _, khi, klo, _ = _host_stage(keys)
                router.host_start(khi, klo)
        return {"prep_host_ms": _delta_ms(loop, reps)}

    step.dispatch = dispatch
    step.complete = complete
    step.drain = drain
    step.width = width
    step.cache = leaf_cache is not None
    step.prep_impl = prep_impl
    step.prep_profile = prep_profile
    step.programs = {"serve_fanout": fn}
    step.phase_labels = {"serve_fanout": fn.label}
    if prep_fn is not None:
        step.programs["device_prep"] = prep_fn
        step.phase_labels["device_prep"] = prep_fn.label
    return step
