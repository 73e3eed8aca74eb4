"""shermanlint for the port — AST-based enforcement of the protocol
invariants over ``sherman_tpu_torch/`` (counterpart of
``sherman_tpu/analysis``; the port keeps its own copy).

Sherman's correctness rests on conventions: kw-only ``dirty=`` threading
for delta checkpoints, typed errors instead of bare raises,
fsync-before-ack journaling, sealed-window zero-retrace serving, and hot
paths that must not sync to the host.  This package turns them into
machine-checked rules that fail before a violation costs a card run.

Stdlib-only by constraint AND by design (``ast``, ``tokenize``,
``fnmatch``, ``dataclasses``, ``pathlib``): it imports neither torch nor
the JAX package, so it runs anywhere the sources are.

Layout:

- :mod:`~sherman_tpu_torch.analysis.core` — the framework: ``Finding``,
  ``SourceFile`` (parse + pragma extraction + qualnames), the runner,
  inline ``# shermanlint: disable=SLxxx <reason>`` suppression.
- :mod:`~sherman_tpu_torch.analysis.registry` — the port's own knowledge
  the rules consult (which functions are hot, including the CUDA kernels'
  launch wrappers; which primitives mutate the pool; where the append
  path lives; which calls sync the card).  Tests swap in their own.
- :mod:`~sherman_tpu_torch.analysis.rules` — the seven rules, SL001-SL007.
- :mod:`~sherman_tpu_torch.analysis.baseline` — grandfathered findings
  with a freshness contract: an entry whose file/line no longer matches
  is an ERROR, never a silent skip.

Run it: ``python -m sherman_tpu_torch.shermanlint`` (default paths
``sherman_tpu_torch/`` and ``chip_smoke.py``).
"""

from sherman_tpu_torch.analysis.baseline import (Baseline, BaselineError,
                                                 load_baseline,
                                                 write_baseline)
from sherman_tpu_torch.analysis.core import (Finding, LintResult, Rule,
                                             SourceFile, iter_py_files, run)
from sherman_tpu_torch.analysis.registry import DEFAULT_REGISTRY, Registry
from sherman_tpu_torch.analysis.rules import ALL_RULES, rule_catalog

__all__ = [
    "ALL_RULES", "Baseline", "BaselineError", "DEFAULT_REGISTRY",
    "Finding", "LintResult", "Registry", "Rule", "SourceFile",
    "iter_py_files", "load_baseline", "rule_catalog", "run",
    "write_baseline",
]
