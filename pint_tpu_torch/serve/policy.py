"""Degradation policy: what happens when the fast path isn't
available (the JAX package's ``serve/policy.py``). Three pressure
valves, all visible in telemetry rather than silent:

- mixed -> f64 fallback: PTABatch.gls_fit (per pulsar) and gls_solve
  already refit in f64 with a warning when gls_eigh_refine's rel_resid
  contract says the f32 preconditioner failed. PTABatch's finalize
  lists the lanes it refit in ``metrics["fell_back"]``; the engine
  counts exactly those requests as degraded instead of hiding the
  retry. The finalize runs on the host, after the program's one pull,
  so a replayed CUDA graph (which calls no Python) still reports it.
- oversize spill: requests too large for the bucketed batch path run
  solo (unbatched, padded to their own length) so one monster request
  can't blow up a shared executable's shape budget.
- shedding: queue-full and past-deadline requests are rejected with a
  structured reason instead of growing the queue without bound or
  executing work nobody is waiting for.
"""

from __future__ import annotations

# above this TOA count a request skips the bucketed batch path
DEFAULT_OVERSIZE_TOAS = 16384

# substring of the mixed-precision fallback warnings emitted by
# PTABatch.gls_fit and fitter.gls_solve (the JAX package's marker)
MIXED_FALLBACK_MARK = "refitting in f64"


def has_correlated_noise(model):
    """GLS is required when any component contributes noise-basis
    columns (same criterion as PTAFleet.fit's method="auto"). A
    streaming lane for such a model refits in full on every append."""
    return any(getattr(c, "basis_weight", None) is not None
               for c in model.components.values())


def resolve(request):
    """(kind, method, maxiter, precision) with "auto" resolved — the
    routing half of the slot key, fixed at submit time so requests
    that resolve identically share a slot."""
    from ..fitter import check_precision

    kind = request.kind
    if kind in ("resid", "phase"):
        return kind, None, None, "f64"
    if kind == "append":
        # streaming appends never share a batched slot (the math is
        # per-lane; see AppendToasRequest) but still resolve here so
        # the slot key stays total over request kinds
        precision = request.precision
        check_precision(precision)
        return kind, None, None, precision
    if kind != "fit":
        raise ValueError(f"unknown request kind {kind!r}")
    method = getattr(request, "method", "auto")
    if method == "auto":
        method = "gls" if has_correlated_noise(request.model) else "wls"
    if method not in ("wls", "gls"):
        raise ValueError(f"unknown fit method {method!r}")
    maxiter = getattr(request, "maxiter", None)
    if maxiter is None:
        maxiter = 2 if method == "gls" else 3
    # WLS has no mixed mode (aot_compile rejects it); fits always
    # carry an explicit precision so the slot key is fully resolved
    precision = request.precision if method == "gls" else "f64"
    check_precision(precision)
    return kind, method, int(maxiter), precision


def is_oversize(n_toa, limit):
    return limit is not None and n_toa > limit


def expired(request, submitted_at, now):
    """Deadline check at flush time: queued past the budget -> shed."""
    return (request.deadline_s is not None
            and (now - submitted_at) > request.deadline_s)


def rejection(reason, **detail):
    """Structured rejection payload (stable keys, JSON-safe) attached
    to a shed ServeResult's telemetry."""
    return {"rejected": True, "reason": reason, "detail": detail}


def mixed_fell_back(caught_warnings):
    """True when a recorded-warnings list contains the mixed-precision
    f64-fallback marker (a single fit's fallback, e.g. gls_solve's)."""
    return any(MIXED_FALLBACK_MARK in str(w.message)
               for w in caught_warnings)
