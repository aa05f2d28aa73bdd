"""Typed requests + result handles for the online timing service (the
JAX package's ``serve/request.py``).

The serve layer speaks in small dataclasses so the engine, batcher,
and policy modules agree on one vocabulary: what work is asked for
(fit / residuals / phase predict), under what latency contract
(deadline_s), and at what precision. A request carries the same
(model, toas) pair the offline fitters take — the serving win is in
how requests are routed onto warm executables, not in a new math
path.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

_ids = itertools.count()


def _next_id():
    return f"req-{next(_ids)}"


def ensure_request_counter_above(n):
    """Advance the process-wide request-id counter past ``n``.

    Crash recovery replays requests that carry ids minted by a DEAD
    process; without this, fresh requests created in the recovered
    process would restart at req-0 and collide with replayed ids in
    the journal. The JAX package's ServeEngine.recover calls this with
    the highest id it saw in the log (the port's waits with the
    journal, ROADMAP §1 item 3)."""
    global _ids
    current = next(_ids)
    _ids = itertools.count(max(current, int(n) + 1))


@dataclass
class TimingRequest:
    """Base request: a (model, toas) pair plus the service contract.

    deadline_s: max seconds between submit and execution start; a
        request still queued past its deadline is shed at flush time
        rather than executed late (serve.policy).
    precision: "f64" or "mixed" — GLS fits (fitter.gls_gram) and
        streaming appends (K1′ under "mixed");
        non-fit kinds and WLS always run f64.
    tenant: accounting principal for per-tenant metrics/SLOs
        (obs.reqlife lifecycle records, snapshot()["tenants"] rows);
        never part of the slot key — tenants share warm executables.
    priority: admission class (serve.admission): 0 = high (interactive,
        never backpressure-shed), 1 = normal (default), 2 = batch
        (first to shed under load). Like tenant, never part of the
        slot key — priorities share warm executables.
    """

    model: object
    toas: object
    deadline_s: float | None = None
    precision: str = "f64"
    tenant: str = "anon"
    priority: int = 1
    request_id: str = field(default_factory=_next_id)

    kind = "fit"


@dataclass
class FitRequest(TimingRequest):
    """WLS/GLS parameter fit. method="auto" picks GLS when the model
    carries correlated-noise (basis_weight) components, mirroring
    PTAFleet.fit; maxiter=None takes the method default (GLS 2,
    WLS 3)."""

    method: str = "auto"
    maxiter: int | None = None

    kind = "fit"


@dataclass
class ResidualRequest(TimingRequest):
    """Time residuals (seconds) at the model's current parameter
    values."""

    kind = "resid"


@dataclass
class PhasePredictRequest(TimingRequest):
    """Continuous pulse phase at the request's TOAs — the polyco-style
    predict surface, evaluated through the full timing model instead
    of a polynomial expansion."""

    kind = "phase"


@dataclass
class AppendToasRequest(TimingRequest):
    """Fold appended TOAs into a registered streaming lane
    (serve.streaming.StreamingRefitter) instead of refitting from
    scratch.

    ``toas`` carries ONLY the new rows; the lane holds the base
    dataset and its cached normal state, so execution costs one
    additive Gram delta + rank-r factor update + small solve — the
    incremental tier's latency budget is far below a refit. The lane
    must have been registered (ServeEngine.register_append_lane)
    before the first append; appends on stale lanes escalate to a
    full refit via the drift sentinel / divergence policy.

    Appends bypass the micro-batcher: each is executed immediately
    (the JAX package journals it at intake first; the port's engine has
    no journal yet), because the lane's delta chain orders appends per
    pulsar — batching appends
    across pulsars would add latency without saving any device work
    (the math is per-lane, there is no shared executable to warm).
    """

    kind = "append"


@dataclass
class ServeResult:
    """Mutable handle returned by ServeEngine.submit; filled in when
    the request's slot flushes (or immediately on shed/spill/error).

    status: "pending" -> "ok" | "shed" | "error" | "rejected".
    reason: shed/error/rejection cause ("queue_full", "deadline",
        "nonfinite_input", "circuit_open", "solver_diverged",
        "nonfinite_result", "draining", or an exception summary);
        "rejected" statuses always carry a structured
        policy.rejection payload in ``telemetry``.
    value: kind-dependent payload (fit: x/chi2/cov/free_names;
        resid: resid_s; phase: phase).
    telemetry: the per-request record metrics.ServeTelemetry
        aggregates (latency phases, routing flags) or a structured
        rejection (policy.rejection) when shed.
    """

    request: TimingRequest
    status: str = "pending"
    reason: str | None = None
    value: dict | None = None
    telemetry: dict = field(default_factory=dict)

    @property
    def done(self):
        return self.status != "pending"
