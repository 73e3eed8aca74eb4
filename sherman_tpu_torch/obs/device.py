"""White-box device telemetry: program ledger, memory accounting,
rooflines (the torch form of ``sherman_tpu/obs/device.py``).

The SLO plane (:mod:`sherman_tpu_torch.obs.slo`) measures the system from
the OUTSIDE: per-class walls and windowed rates.  This module attributes
them to the programs that produce them, and watches the two device-side
hazards no black-box gauge sees:

- **Program ledger** (:class:`CompileLedger`).  Eager PyTorch compiles
  no programs, so the ledger has two kinds of entry where the reference
  has jit compiles:

  - *kernel builds*: each ``torch.utils.cpp_extension`` build of the
    hand-written CUDA sources (``ops/csrc``, ``parallel/csrc``), with its
    wall, under the label ``build.<module>`` (:meth:`CompileLedger.
    record_build`).  These are the port's only real compiles.
  - *first call per signature*: a program wrapped by :func:`wrap_program`
    records the first call of each abstract signature (dtype, shape and
    device of every tensor argument, the type of every other one), with
    the wall of that call on the host clock and a count.  A new
    signature is what would retrace a jitted program, and what breaks a
    captured CUDA graph.

  The **steady-state retrace detector**: after :meth:`CompileLedger.seal`
  (the drivers seal around every timed window) ANY new entry increments
  ``device.retraces``, records a ``compile.retrace`` flight event and
  auto-dumps the black box (env-gated and debounced, the degraded-entry
  contract).

- **Memory accountant** (:class:`MemoryAccountant`): weakref-bound byte
  sources (the DSM registers its pool, locks, counters and dirty mask,
  the journal and the recovery plane their on-disk artifacts) published
  as ``device.hbm_*`` / ``device.host_*`` gauges with a peak watermark.
  Beside them, where a CUDA device is present, the card's own figures:
  ``device.cuda_allocated_bytes``, ``cuda_max_allocated_bytes`` and
  ``cuda_reserved_bytes`` (``torch.cuda.memory_allocated`` and friends:
  allocator bookkeeping, no device sync).

- **Rooflines**: :func:`roofline` joins a program's byte/flop floor with
  a measured wall into achieved rates and, where the card's peaks are
  known (:func:`device_peaks`: the H100's HBM3 bandwidth, or the
  ``SHERMAN_PEAK_GBPS`` / ``SHERMAN_PEAK_TFLOPS`` overrides), achieved
  fractions.  PyTorch has no ``cost_analysis``: :func:`program_cost` and
  :func:`program_memory` return the typed ``{"available": False,
  "reason": ...}`` form, which :func:`roofline` passes through.

Process-wide default: :func:`get_ledger` / :func:`get_accountant`
register the ``device.`` pull collector on first access, so every
registry snapshot carries flat ``device.<stat>`` keys.
``SHERMAN_DEVICE_OBS=0`` is the kill switch, checked per call: the
wrapper then forwards straight to the program and the ledger goes dark.
"""

from __future__ import annotations

import os
import threading
import time

from sherman_tpu_torch.obs import recorder as _recorder
from sherman_tpu_torch.obs import registry as _registry

__all__ = [
    "DEVICE_OBS_ENV", "CompileLedger", "LedgeredProgram",
    "MemoryAccountant", "program_cost", "program_memory", "roofline",
    "rooflines", "device_peaks", "get_ledger", "get_accountant",
    "wrap_program", "enabled",
]

DEVICE_OBS_ENV = "SHERMAN_DEVICE_OBS"

# PyTorch has no cost model of an eager program: the typed answer
# program_cost / program_memory give, as the reference's do on a backend
# that cannot answer
_NO_COST = ("eager PyTorch has no cost_analysis; the port's kernels state "
            "their bounds in chip_smoke.py's kernels line")


def enabled() -> bool:
    """The kill switch, checked per call (one dict lookup) so the
    obs-on/off A/B toggles at run time."""
    return os.environ.get(DEVICE_OBS_ENV, "1") != "0"


def _sig_part(a, out: list) -> None:
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        dev = getattr(a, "device", None)
        name = str(dtype).replace("torch.", "")
        out.append(f"{name}[{','.join(str(d) for d in shape)}]"
                   + (f"@{dev.type}" if dev is not None
                      and hasattr(dev, "type") else ""))
    elif isinstance(a, (tuple, list)):
        for x in a:
            _sig_part(x, out)
    elif isinstance(a, dict):
        for k in a:
            _sig_part(a[k], out)
    elif a is None:
        out.append("None")
    else:
        out.append(type(a).__name__)


def _signature(args, kwargs=None) -> str:
    """Abstract signature of a call: dtype[shape]@device per tensor (or
    array) leaf, the type name of every other leaf (a Python scalar's
    value, like a traced scalar's, does not make a new program)."""
    out: list = []
    _sig_part(args, out)
    if kwargs:
        _sig_part(kwargs, out)
    return ",".join(out)


class _ProgramEntry:
    """One label's ledger row: entry count and walls, the signatures
    seen, and the retraces charged to it after a seal."""

    __slots__ = ("label", "compiles", "compile_ms", "retraces",
                 "signatures")

    def __init__(self, label: str):
        self.label = label
        self.compiles = 0
        self.compile_ms = 0.0
        self.retraces = 0
        self.signatures: dict[str, int] = {}   # sig -> entry count

    def snapshot(self) -> dict:
        return {
            "label": self.label,
            "compiles": self.compiles,
            "compile_ms": round(self.compile_ms, 3),
            "retraces": self.retraces,
            "signatures": dict(self.signatures),
        }


class LedgeredProgram:
    """Transparent wrapper around one program (a plain function of
    tensors): forwards every call, and reports the first call of each
    abstract signature to the ledger under this program's label.  The
    signatures seen are per wrapper, as a jit cache is per program
    object: a rebuilt engine's programs record their first calls again.
    Cache the WRAPPER at the program-cache site so identity pins
    (``step.jserve is eng._get_search_fanout(...)``) keep holding."""

    __slots__ = ("_fn", "label", "_ledger", "_seen", "__weakref__")

    def __init__(self, ledger: "CompileLedger", label: str, fn):
        self._fn = fn
        self.label = label
        self._ledger = ledger
        self._seen: set[str] = set()

    @property
    def unwrapped(self):
        return self._fn

    def __call__(self, *args, **kwargs):
        if not enabled():
            return self._fn(*args, **kwargs)
        sig = _signature(args, kwargs)
        if sig in self._seen:
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return self._fn(*args, **kwargs)
        finally:
            # recorded even when the call raises: a new signature that
            # then fails is the postmortem the ledger exists for
            self._seen.add(sig)
            self._ledger._record_compile(
                self.label, (time.perf_counter() - t0) * 1e3, sig)

    def __repr__(self):
        return f"LedgeredProgram({self.label!r}, {self._fn!r})"


class CompileLedger:
    """Structured record of every kernel build and every first call per
    signature of a ledgered program, with the post-``seal()``
    steady-state retrace detector (module docstring).

    Thread model: entries mutate under one lock (entries are rare); the
    per-call cost of a ledgered program whose signature was seen is one
    signature string and one set lookup."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, _ProgramEntry] = {}
        self._tls = threading.local()
        self._sealed = 0          # nesting depth of seal() scopes
        self.retraces = 0
        self.seals = 0

    def _suppressed(self) -> bool:
        return getattr(self._tls, "suppress", 0) > 0

    class _Suppress:
        def __init__(self, ledger):
            self._l = ledger

        def __enter__(self):
            tls = self._l._tls
            tls.suppress = getattr(tls, "suppress", 0) + 1

        def __exit__(self, *exc):
            self._l._tls.suppress -= 1

    def suppress(self):
        """Scope in which entries are the instrument's own probes and
        must not be recorded, least of all as retraces."""
        return self._Suppress(self)

    # -- recording -----------------------------------------------------------

    def _record_compile(self, label: str, ms: float, sig: str) -> None:
        if self._suppressed():
            return
        with self._lock:
            e = self._entries.get(label)
            if e is None:
                e = self._entries[label] = _ProgramEntry(label)
            e.compiles += 1
            e.compile_ms += ms
            e.signatures[sig] = e.signatures.get(sig, 0) + 1
            tripped = self._sealed > 0
            if tripped:
                e.retraces += 1
                self.retraces += 1
        if tripped:
            # the serving hazard: a new program shape inside a sealed
            # steady-state window.  Flight event + env-gated, debounced
            # black-box dump (the degraded-entry contract).
            _recorder.record_event("compile.retrace", program=label,
                                   signature=sig, compile_ms=round(ms, 3))
            _recorder.auto_dump("compile_retrace")

    def record_build(self, label: str, ms: float, sources) -> None:
        """One kernel build (``torch.utils.cpp_extension``) of ``sources``
        that took ``ms``.  Called after the build returned: a failed
        build raises to its caller and records nothing."""
        if enabled():
            self._record_compile(label, ms, ",".join(sources))

    # -- seal / steady state --------------------------------------------------

    def seal(self) -> None:
        """Enter steady state: from here until :meth:`unseal`, ANY new
        entry is a retrace.  Nests (scopes stack)."""
        with self._lock:
            self._sealed += 1
            self.seals += 1

    def unseal(self) -> None:
        with self._lock:
            if self._sealed > 0:
                self._sealed -= 1

    @property
    def sealed(self) -> bool:
        return self._sealed > 0

    class _Sealed:
        def __init__(self, ledger):
            self._l = ledger

        def __enter__(self):
            self._l.seal()
            return self._l

        def __exit__(self, *exc):
            self._l.unseal()

    def sealed_scope(self):
        """``with ledger.sealed_scope(): <timed loop>``."""
        return self._Sealed(self)

    # -- wrapping -------------------------------------------------------------

    def wrap(self, label: str, fn):
        """Wrap a program for the ledger.  Idempotent on an already
        wrapped program (re-labeling would split its history)."""
        if isinstance(fn, LedgeredProgram):
            return fn
        return LedgeredProgram(self, label, fn)

    # -- views ----------------------------------------------------------------

    def entries(self) -> list[dict]:
        with self._lock:
            return [e.snapshot() for e in self._entries.values()]

    def entry(self, label: str) -> _ProgramEntry | None:
        with self._lock:
            return self._entries.get(label)

    def summary(self) -> dict:
        """The drivers' ledger block: totals + per-program entries."""
        with self._lock:
            entries = [e.snapshot() for e in self._entries.values()]
        return {
            "programs": len(entries),
            "compiles": sum(e["compiles"] for e in entries),
            "compile_ms_total": round(
                sum(e["compile_ms"] for e in entries), 3),
            "retraces": self.retraces,
            "sealed_windows": self.seals,
            "entries": sorted(entries, key=lambda e: -e["compile_ms"]),
        }

    def collect(self) -> dict:
        """Flat numbers for the ``device.`` pull collector."""
        with self._lock:
            n = len(self._entries)
            compiles = sum(e.compiles for e in self._entries.values())
            ms = sum(e.compile_ms for e in self._entries.values())
        return {
            "programs": n,
            "compiles": compiles,
            "compile_ms_total": round(ms, 3),
            "retraces": self.retraces,
            "sealed": int(self._sealed > 0),
        }

    def analyze(self, label: str, *, memory: bool = False) -> dict:
        """Cost (and optionally memory) analysis of a ledgered program:
        typed-unavailable, with the reason (no ledger entry, or no cost
        model in eager PyTorch)."""
        if self.entry(label) is None:
            return {"available": False,
                    "reason": f"no ledger entry for {label!r}"}
        out = program_cost(None)
        if memory:
            out["memory"] = program_memory(None)
        return out

    def reset(self) -> None:
        """Zero in place (test isolation); wrapped programs stay live."""
        with self._lock:
            self._entries.clear()
            self.retraces = 0
            self.seals = 0
            self._sealed = 0


# -- per-program analysis -----------------------------------------------------

def program_cost(fn, *args, **kwargs) -> dict:
    """flops/bytes of one program: PyTorch has no cost analysis of an
    eager program, so this is the typed unavailable form."""
    return {"available": False, "reason": _NO_COST}


def program_memory(fn, *args, **kwargs) -> dict:
    """Memory analysis of one program: typed unavailable, as
    :func:`program_cost` (the accountant's ``cuda_*`` gauges give the
    allocator's live and peak bytes instead)."""
    return {"available": False, "reason": _NO_COST}


# -- rooflines ----------------------------------------------------------------

# peak (HBM bytes/s, flops/s) by device-name substring: NVIDIA's data sheet
# for the H100 SXM part (HBM3 3.35 TB/s; 67 TFLOP/s float32 outside the
# tensor cores, the rate of the port's int32/float32 elementwise work).
# Env overrides win (SHERMAN_PEAK_GBPS / SHERMAN_PEAK_TFLOPS).
_KNOWN_PEAKS = (
    ("h100 80gb hbm3", 3.35e12, 67e12),
)


def device_peaks() -> dict:
    """{"bytes_per_s", "flops_per_s", "source"} for CUDA device 0: each
    peak from a valid env override, else the known-card table; a
    malformed override is flagged in ``source`` and falls back like an
    unset one.  Any other card (or no card) leaves the unresolved peaks
    None, so fractions are omitted, never invented; the absolute
    properties of the card ride along (``name``, ``sms``,
    ``memory_bytes``)."""
    notes = []

    def _env(var: str, scale: float):
        raw = os.environ.get(var)
        if not raw:
            return None
        try:
            return float(raw) * scale
        except ValueError:
            notes.append(f"bad-env:{var}")
            return None

    bw = _env("SHERMAN_PEAK_GBPS", 1e9)
    fl = _env("SHERMAN_PEAK_TFLOPS", 1e12)
    name, props = "", {}
    try:
        import torch
        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            p = torch.cuda.get_device_properties(0)
            props = {"sms": int(p.multi_processor_count),
                     "memory_bytes": int(p.total_memory)}
    except (ImportError, RuntimeError, AssertionError):
        name = ""
    kind = name.lower()
    table = next(((tbw, tfl) for token, tbw, tfl in _KNOWN_PEAKS
                  if token in kind), None)
    if bw is not None or fl is not None:
        notes.append("env")
    if table is not None and (bw is None or fl is None):
        notes.append(f"device_name:{kind}")
        bw = table[0] if bw is None else bw
        fl = table[1] if fl is None else fl
    elif table is None and (bw is None or fl is None):
        notes.append(f"unknown:{kind or 'no-device'}")
    return {"bytes_per_s": bw, "flops_per_s": fl,
            "source": ";".join(notes), "name": name, **props}


def roofline(cost: dict, wall_ms: float, peaks: dict | None = None) -> dict:
    """Join one program's flop/byte floor with its measured wall:
    achieved rates always, achieved FRACTIONS only when the device's
    peaks are known.  Typed-unavailable cost dicts pass through with the
    wall attached."""
    out = {"wall_ms": round(float(wall_ms), 3)}
    if not cost.get("available"):
        out["available"] = False
        out["reason"] = cost.get("reason", "cost analysis unavailable")
        return out
    wall_s = max(float(wall_ms), 1e-6) / 1e3
    flops, bytes_ = cost["flops"], cost["bytes"]
    out.update({
        "available": True,
        "flops": flops,
        "bytes": bytes_,
        "achieved_gbytes_s": round(bytes_ / wall_s / 1e9, 3),
        "achieved_gflops_s": round(flops / wall_s / 1e9, 3),
    })
    # a wall under ~50 us makes the achieved rates measurement noise:
    # keep them (flagged) but publish no fractions from them
    if float(wall_ms) < 0.05:
        out["wall_below_resolution"] = True
        return out
    peaks = peaks or device_peaks()
    pb, pf = peaks.get("bytes_per_s"), peaks.get("flops_per_s")
    if pb:
        out["achieved_bytes_frac"] = round(bytes_ / wall_s / pb, 4)
    if pf:
        out["achieved_flops_frac"] = round(flops / wall_s / pf, 4)
    if pb and pf:
        t_bytes = bytes_ / pb
        t_flops = flops / pf
        out["bound"] = "bytes" if t_bytes >= t_flops else "flops"
    return out


def rooflines(phase_ms: dict, phase_labels: dict, *,
              memory: bool = False, peaks: dict | None = None,
              ledger: "CompileLedger | None" = None) -> dict:
    """Per-phase roofline receipts: join a ``phase_profile``-shaped
    ``{phase: wall_ms}`` dict with the ledger entries named by
    ``phase_labels`` (``step.phase_labels`` on the staged factories).
    Phases without a label (the overlap receipt's keys) are skipped."""
    led = ledger or get_ledger()
    peaks = peaks or device_peaks()
    out = {}
    for phase, ms in phase_ms.items():
        label = phase_labels.get(phase)
        if label is None or not isinstance(ms, (int, float)):
            continue
        ana = led.analyze(label, memory=memory)
        rec = roofline(ana, ms, peaks)
        rec["program"] = label
        if memory and "memory" in ana:
            rec["memory"] = ana["memory"]
        out[phase] = rec
    return out


# -- memory accountant --------------------------------------------------------

def _cuda_memory() -> dict:
    """The caching allocator's own figures for the current CUDA device,
    when torch has initialised CUDA (never initialises it, never syncs)."""
    import torch
    if not torch.cuda.is_initialized():
        return {}
    return {"cuda_allocated_bytes": int(torch.cuda.memory_allocated()),
            "cuda_max_allocated_bytes": int(
                torch.cuda.max_memory_allocated()),
            "cuda_reserved_bytes": int(torch.cuda.memory_reserved())}


class MemoryAccountant:
    """Named live-byte sources with a peak watermark.

    Sources are weakref-bound at the call sites (a dead DSM's pool must
    drop out, not pin device memory); a source that raises reports 0 for
    that snapshot (the registry's collector-error contract).  ``kind``
    splits the exposition: ``hbm`` sources are device-resident buffers
    (pool/locks/counters/dirty), ``host`` sources are host-side
    artifacts (journal, checkpoints).  The watermark tracks the max
    TOTAL hbm bytes any snapshot saw.  With CUDA initialised, the
    allocator's ``cuda_*`` bytes ride beside the sources."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[str, tuple[str, object]] = {}
        self.hbm_peak_bytes = 0

    def register(self, name: str, fn, *, kind: str = "hbm") -> None:
        """``fn() -> bytes``; re-registering a name replaces it (a
        rotated journal segment supersedes its ancestor)."""
        assert kind in ("hbm", "host"), kind
        with self._lock:
            self._sources[name] = (kind, fn)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def gauges(self) -> dict:
        """Flat ``{hbm_<name>_bytes, host_<name>_bytes, ...,
        hbm_total_bytes, hbm_peak_bytes[, cuda_*_bytes]}``; updates the
        watermark."""
        with self._lock:
            sources = list(self._sources.items())
        out: dict = {}
        hbm_total = 0
        for name, (kind, fn) in sources:
            try:
                v = int(fn())
            except Exception:
                v = 0
            out[f"{kind}_{name}_bytes"] = v
            if kind == "hbm":
                hbm_total += v
        out["hbm_total_bytes"] = hbm_total
        with self._lock:
            if hbm_total > self.hbm_peak_bytes:
                self.hbm_peak_bytes = hbm_total
            out["hbm_peak_bytes"] = self.hbm_peak_bytes
        out.update(_cuda_memory())
        return out

    def reset(self) -> None:
        with self._lock:
            self._sources.clear()
            self.hbm_peak_bytes = 0


# -- process-wide defaults ----------------------------------------------------

_LEDGER = CompileLedger()
_ACCOUNTANT = MemoryAccountant()
_REGISTERED = [False]


def _collect() -> dict:
    if not enabled():
        return {"enabled": 0}
    out = _LEDGER.collect()
    out.update(_ACCOUNTANT.gauges())
    out["enabled"] = 1
    return out


def _register() -> None:
    if not _REGISTERED[0]:
        _registry.register_collector("device", _collect)
        _REGISTERED[0] = True


def get_ledger() -> CompileLedger:
    """The default ledger, registered as (half of) the ``device.`` pull
    collector on first access."""
    _register()
    return _LEDGER


def get_accountant() -> MemoryAccountant:
    _register()
    return _ACCOUNTANT


def wrap_program(label: str, fn):
    """Module-level convenience for the program-cache sites:
    ``fn = device.wrap_program("engine.search", fn)``."""
    return get_ledger().wrap(label, fn)
