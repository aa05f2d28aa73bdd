"""pintlint: codebase-aware static analysis for pint_tpu_torch.

The port's correctness conventions — lock discipline on shared serving
state and on the process-wide module locks (``graphs._LOCK``,
``autodiff.LOCK``, ``kernels/build.py``'s), a lock order without
cycles, fault-registry coverage, atomic writes of durable artifacts,
one clock on the instrumented surface, recorded quality signals and
request outcomes, bucket shapes through the planner — are enforced
here as AST lint rules instead of being remembered in code review.
``python -m pint_tpu_torch.analysis pint_tpu_torch/`` (or
``pint_tpu_torch/scripts/pintlint.py``) exits nonzero on any
unsuppressed finding; tests/test_torch_pintlint.py gates the tree.

Rule catalogue (``--list-rules`` prints it; the registries are in
``config.py``):

- ``lock-discipline`` (locks): a registered class's shared attribute
  or a registered module global mutated outside its lock;
- ``locked-helper-call`` (locks): a ``*_locked`` helper called without
  the lock;
- ``lock-order-cycle`` (lockorder, whole-program): two paths acquiring
  locks in opposite orders; ``--lock-dag PATH`` writes the graph;
- ``registry-drift`` (registry, whole-program): a lock-owning class
  missing from ``LOCKED_CLASSES``, or a registry entry matching no file;
- ``durable-write-unatomic`` (durable): a truncating ``open`` in a
  durable-artifact module instead of ``pint_tpu_torch.durable``'s
  atomic writers;
- ``fault-point-unknown`` / ``fault-point-unfired`` /
  ``fault-point-untested`` (faults): a fault name missing from
  ``resilience/faultinject.py``, a registered point nothing fires, a
  device point no test arms;
- ``request-state-leak`` (serve): a request's terminal status set
  without a lifecycle or telemetry record;
- ``timing-untraced`` (obs): a raw clock read in an instrumented module
  instead of ``pint_tpu_torch.obs.clock``;
- ``quality-signal-dropped`` (quality): a computed fit-quality signal
  never recorded;
- ``bucket-hardcoded`` (bucket): a pow2 bucket width picked outside the
  shape planner.

Suppress a finding inline with ``# pintlint: disable=<rule>`` and its
reason. The precision, precision-flow, retrace, signature, kernel
fallback, bench-timing and budget families are not ported yet: they
need torch counterparts (CUDA-graph capture for ``jit``, the kernel
wrappers for ``pallas``, ``torch.cuda.synchronize`` for
``block_until_ready``).
"""

from .config import LintConfig
from .core import (Finding, Rule, RULES, all_rules, counts_by_rule,
                   register, run, run_project, unsuppressed)
# importing the rule modules populates the registry
from . import (rules_bucket, rules_durable, rules_faults,  # noqa: F401
               rules_locks, rules_lockorder, rules_obs, rules_quality,
               rules_registry, rules_serve)
from .report import json_report, text_report

__all__ = [
    "Finding", "LintConfig", "Rule", "RULES", "all_rules",
    "counts_by_rule", "json_report", "register", "run", "run_project",
    "text_report", "unsuppressed",
]


def run_lint(paths, config=None):
    """Convenience wrapper: (findings, unsuppressed_findings)."""
    findings = run(paths, config=config)
    return findings, unsuppressed(findings)
