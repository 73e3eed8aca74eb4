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

Observability: the prep, serve and verify functions go through the
program ledger (``staged.prep``, ``engine.search_fanout``,
``staged.verify``; ``staged_mixed.prep``, ``staged_mixed.serve_fanout``,
``staged_mixed.verify``), so a new shape inside a sealed window counts as
a retrace.  A step touches no other obs object: the driver attributes a
drained window to the SLO plane with ``step.record_slo``, and publishes
``phase_profile``'s walls with :func:`record_phase_obs`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sherman_tpu_torch import config as C
from sherman_tpu_torch import obs
from sherman_tpu_torch.errors import ConfigError, NotPortedError
from sherman_tpu_torch.models.batched import (ST_APPLIED, ST_SUPERSEDED,
                                              mixed_step_spmd)
from sherman_tpu_torch.obs import device as DEV
from sherman_tpu_torch.obs import slo as SLO
from sherman_tpu_torch.ops import bits
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
                 salt: int):
    """Every node's ``batch`` client keys of one step: node n draws from
    ``fold_in(rkey, step_idx * N + n)``.  -> (khi, klo) ``[N, batch]``
    uint32 words."""
    nodes = torch.arange(N, dtype=torch.int64, device=rkey.device)
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


def _check_step_args(eng, leaf_cache):
    if leaf_cache is not None:
        raise NotPortedError(
            "leaf_cache: the hot-key leaf cache comes with ROADMAP.md "
            "item 6a")
    if eng.router is None:
        raise ConfigError("attach_router() first: the staged loop probes "
                          "the engine's router")


# ---------------------------------------------------------------------------
# The staged read loop (YCSB-C).
# ---------------------------------------------------------------------------

def make_staged_step(eng, *, n_keys: int, theta: float, salt: int,
                     batch: int, dev_b: int, log2_bins: int = 20,
                     check_xor: int = 0xDEADBEEF, seed: int = 11,
                     staged=None, sampler: str = "table",
                     fusion: str | None = None, leaf_cache=None):
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
    ``chained`` and ``fused`` raise :class:`ConfigError`; ``leaf_cache``
    raises :class:`NotPortedError` (ROADMAP.md item 6a).

    Attributes: ``fusion``, ``sampler`` (effective), ``pipeline_depth``,
    ``drain``, ``programs`` (phase -> ledgered function),
    ``phase_labels`` (phase -> ledger label), ``jprep``/``jserve``/
    ``jverify``, ``slo_class`` (``read``) and ``record_slo(n_steps,
    elapsed_s)``, which attributes a drained window of ``n_steps`` steps
    to the SLO plane at once (the step itself does no obs work), and
    ``phase_profile(pool, counters, table_d, rtable_d,
    rkey_d, reps=4) -> ({phase: ms}, counters)``: each phase's time per
    call — device-stream time between CUDA events on the card, the K/2K
    chained delta on the host clock on the CPU — plus, when pipelined,
    the overlap receipt of the drained pipelined step."""
    fusion = fusion or C.staged_fusion()
    if fusion in C.STAGED_FUSIONS_NOT_BUILT:
        raise ConfigError(
            f"fusion={fusion!r} is an XLA program-structure form the port "
            "does not build yet; want aligned|pipelined")
    if fusion not in C.STAGED_FUSIONS:
        raise ConfigError(f"fusion={fusion!r}: want aligned|pipelined")
    _check_step_args(eng, leaf_cache)
    if not 0 < dev_b <= batch:
        raise ConfigError(f"dev_b={dev_b}: the unique-row cap must lie in "
                          f"1..batch={batch}")
    router, cfg, dsm = eng.router, eng.cfg, eng.dsm
    dev = eng.device
    N = cfg.machine_nr
    iters = eng._iters()
    shift, nb = int(router.shift), int(router.nb)
    LB = int(log2_bins)
    gen_ranks, sampler = _rank_sampler(sampler, n_keys, theta, LB, dev)
    root = int(eng.tree._root_addr)
    cx_hi, cx_lo = _words(check_xor)
    node_off = (torch.arange(N, dtype=torch.int32, device=dev)
                * dev_b)[:, None]
    iota_b = torch.arange(dev_b, device=dev)

    def prep(tpair, rtable, rkey, step_idx):
        step_idx = torch.as_tensor(step_idx, dtype=torch.int64, device=dev)
        khi_u, klo_u = _client_keys(gen_ranks, tpair, rkey, step_idx, N,
                                    batch, salt)
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

    def verify(rcarry, skhi, sklo, found, vhi, vlo, n_uniq):
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

    verify = DEV.wrap_program("staged.verify", verify)

    def serve(pool, counters, khi, klo, active, start, inv):
        return jserve(pool, counters, khi, klo, root, active, start, inv)

    pipe_reset = None
    if fusion == "aligned":
        def step(pool, counters, tpair, rtable, rkey, carry):
            step_idx, *rcarry = carry
            (step_idx, skhi, sklo, khi, klo, start, active, inv,
             nu) = prep(tpair, rtable, rkey, step_idx)
            _, found, vhi, vlo = serve(pool, counters, khi, klo, active,
                                       start, inv)
            rcarry = verify(tuple(rcarry), skhi, sklo, found, vhi, vlo, nu)
            return counters, (step_idx,) + tuple(rcarry)

        step.drain = lambda carry: carry
    else:
        fold, put, drain, pipe_reset = _two_deep_slot(verify)

        def step(pool, counters, tpair, rtable, rkey, carry):
            step_idx, *rcarry = carry
            rcarry = fold(tuple(rcarry))                  # batch k-1
            (step_idx, skhi, sklo, khi, klo, start, active, inv,
             nu) = prep(tpair, rtable, rkey, step_idx)    # batch k
            _, found, vhi, vlo = serve(pool, counters, khi, klo, active,
                                       start, inv)
            put(skhi, sklo, found, vhi, vlo, nu)
            return counters, (step_idx,) + tuple(rcarry)

        step.drain = drain

    def new_carry():
        """A fresh device-resident carry; also empties the pipelined
        form's pending slot."""
        if pipe_reset is not None:
            pipe_reset()
        z = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        return (torch.zeros((), dtype=torch.int64, device=dev), z(1), z(0),
                z(0), z(0))

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

        def serve_loop(k):
            for _ in range(k):
                serve(pool, counters, khi, klo, active, start, inv)

        out["serve_fanout"] = _phase_ms(dev, serve_loop, reps)
        _, f, vh, vl = serve(pool, counters, khi, klo, active, start, inv)

        def verify_loop(k):
            rc = tuple(new_carry()[1:])
            for _ in range(k):
                rc = verify(rc, skhi, sklo, f, vh, vl, nu)

        out["verify"] = _phase_ms(dev, verify_loop, reps)
        if fusion == "pipelined":
            def pipe_loop(k):
                c = new_carry()
                for _ in range(k):
                    c = step(pool, counters, tpair, rtable, rkey, c)[1]
                step.drain(c)

            out.update(overlap_receipt(out["prep"], out["serve_fanout"],
                                       out["verify"],
                                       _phase_ms(dev, pipe_loop, reps)))
        _sync(dev)
        return out, counters

    step.fusion, step.sampler = fusion, sampler
    step.pipeline_depth = 2 if fusion == "pipelined" else 1
    step.jprep, step.jserve, step.jverify = prep, jserve, verify
    step.programs = {"prep": prep, "serve_fanout": jserve, "verify": verify}
    step.phase_labels = {name: prog.label
                         for name, prog in step.programs.items()}
    _slo_hook(step, "read", batch)
    step.phase_profile = phase_profile
    step.dev_b = dev_b
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
    _check_step_args(eng, None)
    router, cfg, dsm = eng.router, eng.cfg, eng.dsm
    dev = eng.device
    N = cfg.machine_nr
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
        khi_u, klo_u = _client_keys(gen_ranks, tpair, rkey, step_idx, N,
                                    batch, salt)
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
        if N > 1:
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
    table_d, rtable_d, rkey_d = staged or _stage_inputs(
        dsm, router, n_keys, theta, LB, seed, sampler)
    return step, (new_carry, table_d, rtable_d, rkey_d)
