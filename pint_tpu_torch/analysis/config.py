"""Codebase-tuned registries the pintlint rules check against.

A generic linter cannot know which functions are f64-critical, which
classes are shared across threads, which module locks guard which
caches, or which names are legal fault points — those are THIS
codebase's contracts. They live here, in one reviewable place, so
adding a shared class or a fault point is a one-line registry edit and
the rules pick it up everywhere.

The registries name the port's files and classes (``pint_tpu_torch/``).
Tests construct ``LintConfig`` directly with fixture registries; the
CLI and the CI gate use :meth:`LintConfig.default`, which binds the
registries below; the fault points are parsed from
``pint_tpu_torch/resilience/faultinject.py`` (``POINTS``,
``DEVICE_POINTS``).

The precision, precision-flow, retrace, signature, kernel-fallback and
bench-timing registries are torch counterparts of the JAX package's,
not copies: CUDA-graph capture and ``torch.func`` stand where ``jit``
and ``vmap`` stood, the ``*_cuda`` kernel wrappers where the Pallas
kernels stood, ``torch.cuda.synchronize`` where ``block_until_ready``
stood. The budget family binds the port's own budget file
(``pint_tpu_torch/obs/budgets.json``) to the port's round writer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# Repo root (two levels above this package): the registry-drift
# staleness check also looks here for registered surfaces.
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# -- precision ---------------------------------------------------------

# Functions where introducing float32 (a float32 dtype, .float(), a
# torch factory left at its float32 default) is a correctness bug: the
# whitening/normal-equation chain feeding the f64-critical residual
# solve. Keyed by path suffix; "*" marks a whole module. gls_gram and
# seg_gls_eigh_refine are deliberately NOT listed — their f32 is the
# sanctioned mixed-precision path, guarded at run time by
# fitter.relres_failed.
F64_CRITICAL = {
    "pint_tpu_torch/fitter.py": {
        "gls_whiten", "gls_normal", "gls_eigh_solve", "gls_eigh_refine",
        "column_norms", "stack_noise_bases", "relres_failed",
    },
    "pint_tpu_torch/timescales.py": {"*"},
    "pint_tpu_torch/residuals.py": {"*"},
    "pint_tpu_torch/dd.py": {"*"},
}

# Names that mark a value as a NaN-signalling convergence diagnostic:
# comparing one of these with ``>`` (False under NaN) silently
# swallows a diverged fit; fitter.relres_failed is the sanctioned
# guard.
NAN_DIAG_PATTERN = r"(?:^|_)rel_?res(?:id)?(?:_|$)|relres"

# -- lock discipline ---------------------------------------------------

# Shared classes whose attributes may be mutated outside the owning
# thread: every mutation of a monitored attribute must sit inside
# ``with self._lock:`` (or live in a ``*_locked`` helper whose call
# sites the locked-helper-call rule checks). attrs=None monitors every
# self attribute except the exemptions.
LOCKED_CLASSES = {
    "ExecutableCache": {"lock": "_lock", "attrs": None},
    "MicroBatcher": {"lock": "_lock", "attrs": None},
    "HealthMonitor": {"lock": "_lock", "attrs": None},
    "CircuitBreaker": {"lock": "_lock", "attrs": None},
    # the async front door: submitter threads, the flusher worker,
    # and the watchdog all touch these
    "ServeTelemetry": {"lock": "_lock", "attrs": None},
    "IntakeQueue": {"lock": "_lock", "attrs": None},
    "AdmissionController": {"lock": "_lock", "attrs": None},
    # only the pipeline state shared with the prep worker pool; fit
    # results (diverged, fit_metrics, ...) are caller-thread-only
    "PTAFleet": {"lock": "_lock",
                 "attrs": {"batches", "_batch_futures", "_prep_pool"}},
    # the flusher work mutex serializes flush/idle generations against
    # drain() and close(); it guards execution phases, not attribute
    # state (attribute discipline on the front door lives in IntakeQueue
    # / AdmissionController above), so no attrs are monitored — the
    # entry exists for the lock-ORDER analysis, which needs to know the
    # mutex's identity to order it against the collaborator locks taken
    # underneath it.
    "AsyncServeEngine": {"lock": "_work_mutex", "attrs": set()},
    # the port's ServeEngine owns that mutex itself (AsyncServeEngine
    # inherits it): every flush, capture and lane registration holds
    # it, and graphs._LOCK is taken underneath
    "ServeEngine": {"lock": "_work_mutex", "attrs": set()},
    # observability: counters/ledgers written from serve worker threads
    # and read by exporters. Mutators hold self._lock; the exempt attrs
    # are injected collaborators (clock) handled globally.
    "Counter": {"lock": "_lock", "attrs": None},
    "Gauge": {"lock": "_lock", "attrs": None},
    "Histogram": {"lock": "_lock", "attrs": None},
    "Registry": {"lock": "_lock", "attrs": None},
    "ProgramLedger": {"lock": "_lock", "attrs": None},
    "Tracer": {"lock": "_lock", "attrs": None},
    "DriftBoard": {"lock": "_lock", "attrs": None},
    "LifecycleLedger": {"lock": "_lock", "attrs": None},
    "BurnRateMonitor": {"lock": "_lock", "attrs": None},
    "FitQualityLedger": {"lock": "_lock", "attrs": None},
    "FlightRecorder": {"lock": "_lock", "attrs": None},
    "RequestJournal": {"lock": "_lock", "attrs": None},
    # durable tiers reached from under their in-memory caches' locks:
    # ordering matters (ExecutableCache._lock -> Persistent..._lock).
    "PersistentExecutableCache": {"lock": "_lock", "attrs": None},
    "PackStore": {"lock": "_lock", "attrs": None},
    # streaming append lanes: serve worker threads append while
    # register/recover touch the same lane table. The refitter lock
    # covers only the lane registry and counters; each lane's math and
    # delta IO runs under the lane's OWN lock so independent lanes
    # append concurrently. Ordering is one-way — StreamingLane._lock
    # -> StreamingRefitter._lock (counter bumps inside an append /
    # escalation) and StreamingLane._lock -> DeltaStore._lock (the
    # durable-before-visible publish); nothing takes a lane lock while
    # holding the refitter lock. The lane lock is reached through the
    # registry dict (an untyped alias the static lock-order pass can't
    # follow); attrs=set() because lane fields are mutated through
    # that same alias (the documented static-model limit). The
    # refitter monitors its registry + counters explicitly: `deltas`
    # is an init-time reference to the internally-locked DeltaStore
    # (calls into it are its own lock's business, not the refitter's).
    "StreamingRefitter": {"lock": "_lock",
                          "attrs": {"lanes", "appends", "escalated",
                                    "replayed"}},
    "StreamingLane": {"lock": "_lock", "attrs": set()},
    "DeltaStore": {"lock": "_lock", "attrs": None},
}

# Attributes never treated as shared state even under attrs=None:
# injected collaborators and configuration, written once in __init__.
LOCKED_CLASS_EXEMPT_ATTRS = frozenset({"_lock", "clock", "_sleep"})

# Module-level state mutated from multiple threads: mutations must
# hold the paired module lock.
# - parallel/pta.py: the fleet's build pool and concurrent prewarm both
#   reach the per-process precision-probe cache;
# - graphs.py: the last capture's or call's event per device and the
#   live captured programs, under the lock every capture and replay
#   holds (graphs._LOCK);
# - kernels/build.py: the loaded libraries and their build logs.
# autodiff.LOCK guards no module state: it serializes torch.func's
# jacfwd calls, and the lock-order graph sees it by its own name.
LOCKED_GLOBALS = {
    "_PRECISION_AUTO_CACHE": "_PRECISION_AUTO_LOCK",
    "_DONE": "_LOCK",
    "_LIVE": "_LOCK",
    "_LIBS": "_LOCK",
    "BUILD_INFO": "_LOCK",
}

# Path suffix of THIS module: the registry-drift staleness half only
# runs when the registry file itself is in the scan (linting one file
# must not claim the whole registry is stale).
REGISTRY_ANCHOR_SUFFIX = "analysis/config.py"

# -- precision flow (whole-program) -----------------------------------

# Function-name patterns whose RESULTS are f32 at the source: the
# hand-written Hopper kernels' wrappers (fused_block_gls_cuda,
# block_grams_cuda, pair_products_cuda, harmonic_sums_cuda,
# delta_gram_cuda) compute in f32, so what they return is f32-tainted
# until an explicit .double() / .to(torch.float64).
F32_SOURCE_PATTERNS = (r"_cuda$",)

# -- signature completeness (whole-program) ---------------------------

# Classes whose program tables are keyed by a shape signature: the
# registered method must fingerprint every attribute the captured
# closures read, and every self attr passed as a runtime argument at a
# self._fns[...] dispatch. "exempt" lists host-only metadata attrs
# that cannot change a program's shapes.
SIGNATURE_CLASSES = {
    # preps/_free_map/static/template are structure-determining, not
    # shape-determining: PTABatch.structure_key fingerprints them, and
    # every path that shares a _fns table across instances composes
    # structure_key into its key alongside shape_signature (the serve
    # engine's slot key, the persisted tier's key).
    "PTABatch": {"signature": "shape_signature",
                 "exempt": {"preps", "_free_map", "static", "template"}},
    "ShapePlan": {"signature": "signature", "exempt": set()},
}

# -- retrace / sync hazards -------------------------------------------

# Callables whose function argument becomes device code: a fit program
# (captured into CUDA graphs, where host code runs once at capture and
# a host value derived there is baked into every replay), a torch.func
# transform, or the port's jacfwd. Matched on the callee's last name.
TRACING_WRAPPERS = frozenset({
    "Program", "GraphProgram", "aot_backend_compile", "vmap", "jacfwd",
    "jacrev", "grad", "hessian", "functional_call",
})

# The sanctioned escape from a graph: graphs.eager(fn, *args) runs fn
# eagerly between two graphs, so its arguments and fn's body may sync.
EAGER_CALLS = frozenset({"eager", "graphs.eager"})

# Attributes holding a program table: a function stored there
# (self._fns[key] = f, self._fns.setdefault(key, f)) is device code,
# and a call through it dispatches device work.
PROGRAM_TABLE_ATTRS = frozenset({"_fns"})

# Host-sync callables forbidden inside device code (any ``time.*``
# call too).
HOST_SYNC_CALLS = frozenset({
    "float", "int", "bool", "np.asarray", "np.array", "numpy.asarray",
    "numpy.array", "torch.nonzero", "torch.unique",
    "torch.cuda.synchronize",
})

# Methods whose call on a device tensor forces a device->host sync.
HOST_SYNC_METHODS = frozenset({
    "item", "tolist", "cpu", "numpy", "nonzero", "synchronize",
})

# Modules (path substrings) where building a PTABatch without
# pad_toas= breaks the serve path's zero-recapture contract: every
# flush of a slot must present identical shapes to the executable
# cache.
SERVE_PAD_MODULES = ("pint_tpu_torch/serve/",)

# -- bucket shapes -----------------------------------------------------

# Call names that pick a legacy pow2 bucket width directly.
BUCKET_CALLS = frozenset({"pow2_bucket"})

# Modules (path suffixes) allowed to call them: the canonical
# implementation (serve/batcher.py) and the shape planner's sanctioned
# wrapper (parallel/shapeplan.py::pow2_width). Everything else must
# route bucket-shape decisions through the planner so the padded-FLOP
# cost model stays in one place.
BUCKET_ALLOWED_MODULES = ("parallel/shapeplan.py", "serve/batcher.py")

# -- fault injection ---------------------------------------------------

# Call names whose first string argument must be a registered fault
# point.
FAULT_CALLS = frozenset({
    "fire", "inject", "faultinject.fire", "faultinject.inject",
    "FaultPoint", "faultinject.FaultPoint",
})

# Path suffix of the registry module; its POINTS tuple is the ground
# truth, and the unfired check only runs when this file is in the scan
# (linting one file must not claim the whole registry is unused).
FAULT_REGISTRY_SUFFIX = "resilience/faultinject.py"

# Path markers identifying test files. Device-level fault points
# (the registry's DEVICE_POINTS tuple) must be ARMED — inject()/
# FaultPoint() — from at least one test: a device failure mode that
# no test can trigger is chaos coverage on paper only. The check runs
# only when test files are in the scan, so linting the package alone
# stays quiet.
TEST_PATH_MARKERS = ("/tests/", "/test_")

# -- bench hygiene -----------------------------------------------------

# Calls that synchronize with the card: one inside a timing window
# makes the measurement honest (a CUDA launch, a graph replay and a
# program-table call all return before the device work ends).
SYNC_CALLS = frozenset({
    "torch.cuda.synchronize", "synchronize", "elapsed_time", "item",
    "cpu", "tolist", "numpy", "np.asarray", "np.array", "float",
})

TIMER_CALLS = frozenset({
    "time.perf_counter", "time.monotonic", "time.time",
    "perf_counter", "monotonic", "self.clock", "clock",
    # the obs clock (pint_tpu_torch.obs.clock) opens timing windows
    # too — instrumented modules import it as obs_clock
    "obs_clock.now", "obs_clock.walltime",
})

# -- observability -----------------------------------------------------

# Modules (normalized "/"-prefixed path suffixes) instrumented with
# the obs tracing layer (pint_tpu_torch.obs): raw wall-clock READS
# there must go through pint_tpu_torch.obs.clock (obs_clock.now / Stopwatch) or a
# span, so every timing number on the instrumented surface shares one
# clock and shows up in exported timelines and flight dumps.
# time.sleep is a delay, not a measurement, and stays legal; timer
# REFERENCES used as injectable defaults (clock=time.monotonic) are
# not calls and are never flagged.
OBS_INSTRUMENTED_MODULES = (
    "/fitter.py", "/parallel/pta.py", "/parallel/fleetmesh.py",
    "/serve/engine.py", "/serve/excache.py", "/serve/batcher.py",
    "/serve/metrics.py", "/serve/frontdoor.py", "/serve/admission.py",
    "/resilience/retry.py", "/scripts/pint_serve_bench.py",
    "/gw/residuals.py", "/gw/correlate.py", "/gw/hd.py",
    "/gw/__main__.py",
)

# Raw timer call names timing-untraced flags in instrumented modules.
OBS_RAW_TIMER_CALLS = frozenset({
    "time.time", "time.perf_counter", "time.monotonic",
    "time.perf_counter_ns", "time.monotonic_ns",
    "perf_counter", "monotonic",
})

# Path markers never checked: the obs package IS the clock, and tests
# drive fake clocks on purpose.
OBS_ALLOWED_PATH_MARKERS = ("/obs/", "/tests/", "/test_")

# -- durable-artifact write discipline --------------------------------

# Modules (normalized "/"-prefixed path suffixes) that own
# crash-surviving artifacts: checkpoint snapshots, the write-ahead
# request journal, the persisted executable cache, the packed-TOA
# columnar store, flight-recorder dumps. Truncating open() there must
# go through pint_tpu_torch.durable's atomic writers — a crash
# mid-`open(path, "w")` tears the previous good artifact, the exact
# loss these modules exist to prevent.
# pint_tpu_torch/durable.py itself is NOT listed: its temp-file write
# IS the atomic implementation.
DURABLE_ARTIFACT_MODULES = (
    "/checkpoint.py", "/obs/recorder.py", "/serve/journal.py",
    "/serve/excache.py", "/store/packstore.py", "/store/deltas.py",
)

# -- kernel dispatch ---------------------------------------------------

# Path markers identifying kernel dispatch modules. A kernel wrapper
# given a CUDA tensor launches its kernel or raises: the port has no
# fallback, so a handler around a launch that does not re-raise, or a
# plain/reference branch a CUDA tensor can take on any test but its
# device or a named size constant, hides a kernel that did not run.
KERNEL_DISPATCH_MODULES = ("/kernels/", "/gw/")

# Call names that launch a hand-written kernel (besides the symbols of
# a library that kernels/build.py's load() returns).
KERNEL_LAUNCH_PATTERN = r"_cuda$|^launch_gram$"

# -- budget coverage ---------------------------------------------------

# Modules (normalized "/"-prefixed path suffixes) that write benchmark
# rounds: their measured_*/serve_*/... dict-literal keys must be
# registered in the budget file (pint_tpu_torch/obs/budgets.json) so
# the regression gate sees every number from the round it first
# appears. chip_smoke.py writes the card's round (its [regress] phase).
BUDGET_META_MODULES = ("/chip_smoke.py",)

# -- fit-quality signal coverage --------------------------------------

# Modules (normalized "/"-prefixed path suffixes) on the fit path
# where numerical quality signals are computed: any function there
# that evaluates a signal (a relres_failed verdict, a chi2_whitened
# assignment) must also feed the numerics observatory
# (pint_tpu_torch.obs.fitquality) or carry an explicit suppression — a
# computed-then-dropped quality signal is telemetry the fleet
# dashboards silently never see.
QUALITY_SIGNAL_MODULES = (
    "/fitter.py", "/parallel/pta.py", "/parallel/toa_shard.py",
    "/serve/engine.py",
)

# Identifier pattern marking a quality-signal computation.
QUALITY_SIGNAL_PATTERN = r"relres_failed|chi2_whitened"

# Identifier pattern marking that the enclosing function routes the
# signal into the observatory (the fitquality ledger / the per-batch
# quality summary).
QUALITY_RECORD_PATTERN = (
    r"quality|FITQ|obs_fitq|record_fit_batch|note_fallback")

# -- serve request-state coverage -------------------------------------

# Modules (normalized "/"-prefixed path suffixes) that own the serve
# request state machine: any function there that assigns a request's
# terminal outcome (``res.status`` / ``res.reason``) must also emit a
# lifecycle transition (pint_tpu_torch.obs.reqlife) or a telemetry record in
# the same function — a status set on a path the ledger never hears
# about breaks the exactly-one-terminal-state invariant silently.
SERVE_STATE_MODULES = ("/serve/engine.py", "/serve/frontdoor.py")

# Identifier pattern marking that the enclosing function records the
# outcome (a lifecycle transition, a telemetry record/counter, or one
# of the reject/fail helpers that do both).
SERVE_STATE_RECORD_PATTERN = (
    r"_lc|reqlife|lifecycle|telemetry|_reject|_fail")


@dataclass
class LintConfig:
    f64_critical: dict = field(default_factory=dict)
    locked_classes: dict = field(default_factory=dict)
    locked_class_exempt_attrs: frozenset = LOCKED_CLASS_EXEMPT_ATTRS
    locked_globals: dict = field(default_factory=dict)
    bucket_allowed_modules: tuple = ()
    serve_pad_modules: tuple = ()
    fault_points: tuple = None  # None -> parse from the registry file
    device_fault_points: tuple = None  # None -> parse DEVICE_POINTS
    fault_registry_suffix: str = FAULT_REGISTRY_SUFFIX
    test_path_markers: tuple = TEST_PATH_MARKERS
    nan_diag_pattern: str = NAN_DIAG_PATTERN
    obs_instrumented_modules: tuple = ()
    obs_raw_timer_calls: frozenset = OBS_RAW_TIMER_CALLS
    obs_allowed_path_markers: tuple = OBS_ALLOWED_PATH_MARKERS
    durable_artifact_modules: tuple = ()
    kernel_dispatch_modules: tuple = ()
    budget_meta_modules: tuple = ()
    budgeted_meta_keys: frozenset = None  # None -> rule is inert
    quality_signal_modules: tuple = ()
    quality_signal_pattern: str = QUALITY_SIGNAL_PATTERN
    quality_record_pattern: str = QUALITY_RECORD_PATTERN
    serve_state_modules: tuple = ()
    serve_state_record_pattern: str = SERVE_STATE_RECORD_PATTERN
    # whole-program analyses (empty/falsy -> the rule is inert, so
    # fixture configs built for per-file rules stay quiet)
    registry_anchor_suffix: str = ""
    registry_tree_roots: tuple = ()
    f32_source_patterns: tuple = ()
    signature_classes: dict = field(default_factory=dict)

    @classmethod
    def default(cls):
        # The budget-file key set loads lazily and tolerantly: lint
        # must keep working when the data file is missing or unreadable
        # (the meta-key rule goes inert rather than erroring); any other
        # error surfaces.
        from ..obs import baseline

        try:
            budgeted = frozenset(baseline.registered_keys())
        except (OSError, ValueError):
            budgeted = None
        return cls(f64_critical=dict(F64_CRITICAL),
                   locked_classes=dict(LOCKED_CLASSES),
                   locked_globals=dict(LOCKED_GLOBALS),
                   bucket_allowed_modules=BUCKET_ALLOWED_MODULES,
                   serve_pad_modules=SERVE_PAD_MODULES,
                   obs_instrumented_modules=OBS_INSTRUMENTED_MODULES,
                   durable_artifact_modules=DURABLE_ARTIFACT_MODULES,
                   kernel_dispatch_modules=KERNEL_DISPATCH_MODULES,
                   budget_meta_modules=BUDGET_META_MODULES,
                   budgeted_meta_keys=budgeted,
                   quality_signal_modules=QUALITY_SIGNAL_MODULES,
                   serve_state_modules=SERVE_STATE_MODULES,
                   registry_anchor_suffix=REGISTRY_ANCHOR_SUFFIX,
                   registry_tree_roots=(_REPO_ROOT,),
                   f32_source_patterns=F32_SOURCE_PATTERNS,
                   signature_classes=dict(SIGNATURE_CLASSES))
