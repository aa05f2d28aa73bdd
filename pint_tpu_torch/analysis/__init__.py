"""pintlint: codebase-aware static analysis for pint_tpu_torch.

The port's correctness conventions — f64 end to end on the residual
chain, NaN-aware mixed-precision guards, no host sync inside a captured
program, program keys that hash by value, captured programs that read
their arguments and not ``self``, kernels that launch or raise, timed
windows that synchronize, lock discipline on shared serving state and
on the process-wide module locks (``graphs._LOCK``, ``autodiff.LOCK``,
``kernels/build.py``'s), a lock order without cycles, fault-registry
coverage, atomic writes of durable artifacts, one clock on the
instrumented surface, recorded quality signals and request outcomes,
bucket shapes through the planner, every round key in the budget
file — are enforced here as AST lint
rules instead of being remembered in code review. Its modules are pure
``ast``: none imports torch or the JAX package.
``python -m pint_tpu_torch.analysis pint_tpu_torch/`` (or
``pint_tpu_torch/scripts/pintlint.py``) exits nonzero on any
unsuppressed finding; tests/test_torch_pintlint.py gates the tree.

Rule catalogue, 22 ids (``--list-rules`` prints it; the registries are
in ``config.py``):

- ``nan-guard`` (precision): ``diag > tol`` or builtin ``max()`` on a
  convergence diagnostic, both blind to NaN;
- ``f32-in-f64`` (precision): float32 introduced inside an
  f64-critical function (``F64_CRITICAL``), and anywhere a TF32
  re-enable or a float32 default dtype;
- ``precision-flow`` (precision, whole-program): an f32 value flowing
  across functions into an f64-critical sink;
- ``host-sync-in-jit`` (retrace): a host sync inside device code;
- ``static-unhashable`` (retrace): a list, dict, set or tensor in a
  program key (``self._fns[...]``, ``ExecutableCache`` keys,
  ``lru_cache`` arguments);
- ``serve-unpadded-batch`` (retrace): a ``PTABatch`` built in
  ``serve/`` without ``pad_toas=``;
- ``signature-incomplete`` (retrace, whole-program): a ``self`` read
  inside a captured closure outside its program key, or a dispatch
  argument ``shape_signature`` does not fingerprint
  (``SIGNATURE_CLASSES``);
- ``kernel-silent-fallback`` (kernels): a handler around a kernel
  launch that does not re-raise, or a plain branch a CUDA tensor can
  take (``kernels/``, ``gw/``);
- ``timing-no-block`` (bench): a timer window around device work with
  no synchronize;
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
  shape planner;
- ``meta-key-unbudgeted`` (budget): a ``measured_*``/``serve_*``/
  ``chaos_*``/``cold_start_*``/``gw_*``/``incremental_*`` dict-literal
  key in a round writer (``BUDGET_META_MODULES``: ``chip_smoke.py``)
  missing from ``pint_tpu_torch/obs/budgets.json``.

What the torch counterparts mean by their terms:

- *device code*: a function passed to ``graphs.Program``,
  ``graphs.GraphProgram``, ``fitter.aot_backend_compile``, a
  ``torch.func`` transform or ``autodiff.jacfwd``, or stored in a
  program table (``self._fns[key] = f``, ``.setdefault(key, f)``),
  followed through parameters, returned tuples and the local functions
  it calls (``rules_retrace.TracedIndex``); on the card it is captured
  into CUDA graphs, where host code runs once. ``graphs.eager(fn,
  ...)``'s arguments and ``fn`` are the sanctioned escape;
- *sync*: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.nonzero()``, ``torch.nonzero``/``unique``,
  ``torch.cuda.synchronize`` / ``.synchronize()``, ``float``/``int``/
  ``bool``, ``np.asarray``/``np.array`` and ``time.*``; for a timer
  window also an event's ``elapsed_time``;
- *f32 source*: a float32 dtype (``torch.float32``, ``torch.float``,
  ``float16``, ``bfloat16``), ``.float()``/``.half()``/``.bfloat16()``,
  a torch factory left at its float32 default (``torch.zeros(n)``),
  and a ``*_cuda`` kernel wrapper's result;
- *sanitizer*: ``.double()``, ``.to(torch.float64)``,
  ``.to(dtype=torch.float64)``, a ``dtype=torch.float64`` constructor,
  ``np.float64(...)``.

Suppress a finding inline with ``# pintlint: disable=<rule>`` and its
reason.
"""

from .config import LintConfig
from .core import (Finding, Rule, RULES, all_rules, counts_by_rule,
                   register, run, run_project, unsuppressed)
# importing the rule modules populates the registry
from . import (rules_bench, rules_bucket, rules_budget,  # noqa: F401
               rules_durable, rules_faults, rules_flow, rules_kernels,
               rules_locks, rules_lockorder, rules_obs, rules_precision,
               rules_quality, rules_registry, rules_retrace, rules_serve,
               rules_signature)
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
