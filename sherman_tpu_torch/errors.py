"""Typed errors of the PyTorch/CUDA port (counterpart of
``sherman_tpu/errors.py``; the port keeps its own copy).

Every class multiply-inherits the stdlib exception it stands for, so
``except ValueError`` / ``except RuntimeError`` callers keep working.
"""

__all__ = [
    "ShermanError",
    "ConfigError",
    "KeyRangeError",
    "DoubleFreeError",
    "ProtocolError",
    "StateError",
    "MultiprocessUnsupportedError",
    "TreeCorruptError",
    "CheckpointFormatError",
    "ReshardError",
    "KernelUnavailableError",
    "NotPortedError",
    "ExchangeLaneError",
    "NativeBuildError",
    "NativeUnavailableError",
]


class ShermanError(Exception):
    """Root of every typed error the port raises."""


class ConfigError(ShermanError, ValueError):
    """A knob, argument or device choice failed validation.  The message
    names the knob and the accepted values."""


class KeyRangeError(ShermanError, ValueError):
    """Request keys fall outside ``[KEY_MIN, KEY_MAX]``."""


class DoubleFreeError(ShermanError, ValueError):
    """A page was returned to the reclaim pool twice: granting it again
    would alias two leaves onto one page."""


class ProtocolError(ShermanError, RuntimeError):
    """A DSM/lock protocol invariant was breached at runtime (a host op
    refused a row)."""


class StateError(ShermanError, RuntimeError):
    """The object is in the wrong state for this call (journal closed,
    reclaim already running, no checkpoint chain started)."""


class MultiprocessUnsupportedError(ShermanError, RuntimeError):
    """A single-process-only feature was invoked on a multihost mesh, or a
    multihost artifact reached a single-process entry point (a collective
    checkpoint handed to ``utils.checkpoint.restore``).  The port drives
    every node from one process."""


class TreeCorruptError(ShermanError, RuntimeError):
    """Structural validation failed: the pool holds pages that violate
    the B+-tree invariants (``models/validate.py`` names each violated
    class)."""


class CheckpointFormatError(ShermanError, RuntimeError):
    """A checkpoint artifact is structurally unusable: wrong build, wrong
    config, missing arrays, incompatible layout.  Distinct from
    :class:`~sherman_tpu_torch.utils.checkpoint.CheckpointCorruptError`
    (a content CRC mismatch on an artifact with the right shape)."""


class ReshardError(ShermanError, RuntimeError):
    """A checkpoint could not be repacked onto the target node count
    (non-covering host shards, a dangling or out-of-range address, a shape
    that does not match the manifest)."""


class KernelUnavailableError(ShermanError, RuntimeError):
    """A CUDA tensor reached a kernel wrapper but the kernel could not be
    built or launched.  ``cause`` names what failed (the nvcc/ninja build
    error or the CUDA launch error); there is no silent fallback to the
    plain PyTorch version."""

    def __init__(self, kernel: str, cause: str):
        super().__init__(f"CUDA kernel {kernel!r} unavailable: {cause}")
        self.kernel = kernel
        self.cause = cause


class NotPortedError(ShermanError, NotImplementedError):
    """The request needs a path that a later slice of the port brings
    (named in the message, with its ROADMAP.md item)."""


class ExchangeLaneError(ShermanError, TypeError):
    """A field cannot ride the packed 32-bit exchange buffer (counterpart
    of ``sherman_tpu/parallel/transport_pallas.py::ExchangeLaneError``)."""

    def __init__(self, dtype):
        super().__init__(
            f"the exchange carries 32-bit lanes; got {dtype} — widen the "
            "field to a 32-bit dtype (bools and any 4-byte dtype travel "
            "bit-exactly)")
        self.dtype = dtype


class NativeBuildError(ShermanError, RuntimeError):
    """The native helper library failed to compile."""


class NativeUnavailableError(ShermanError, RuntimeError):
    """The native helper library is not importable/loadable in this
    environment.  The library's modules keep the reference's pure-numpy
    branches for that case; the headline bench and the chip smoke raise
    this instead (the message carries the build's output)."""
