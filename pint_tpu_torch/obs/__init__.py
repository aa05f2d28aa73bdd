"""pint_tpu_torch.obs: tracing spans, metrics, the flight recorder, the
cost model, SLO burn rates, drift sentinels and the exporters (the JAX
package's ``obs/``).

One observability surface for the whole stack: the fleet executor, the
AOT build/capture split, the GW stage, the stores and the serve flush
path all emit :func:`span`\\ s; counters and latency histograms
aggregate in :data:`metricsreg.REGISTRY`; the :data:`recorder.RECORDER`
flight recorder keeps a bounded ring of recent spans, fault firings and
events and dumps it to JSON on an anomaly.

Quick start::

    from pint_tpu_torch import obs

    obs.enable()                       # spans on (off by default)
    xs, chi2, covs = fleet.fit()
    obs.write_chrome_trace("fleet.json")   # -> ui.perfetto.dev

Tracing is off by default and a disabled ``span(...)`` call is one
attribute check returning the shared :data:`NOOP_SPAN`; enabling it
never touches device code (spans read the host clock only), so a traced
fit is bitwise the untraced one.

On top of the raw telemetry sit :mod:`costmodel` (per-program FLOP and
byte counts recorded when a program is built, roofline MFU on the
card's row of its peak table), :mod:`slo` (dual-window burn-rate alerts
over serve snapshots), :mod:`fitquality` (numerical-health probes of
every fit), :mod:`drift` (EWMA/CUSUM sentinels over successive refits)
and :mod:`reqlife` (the per-request lifecycle ledger). The JAX package's
``baseline`` regression gate reads that package's TPU benchmark rounds
and waits for the port's own benchmark.

CLI: ``python -m pint_tpu_torch.obs`` (traced fleet demo, flight-dump ->
Perfetto conversion, Prometheus rendering, offline ``slo`` replay,
``fitq`` gate and ``tail`` p99-exemplar resolution).
"""

from . import clock  # noqa: F401
from . import costmodel  # noqa: F401
from . import drift  # noqa: F401
from . import fitquality  # noqa: F401
from . import reqlife  # noqa: F401
from . import slo  # noqa: F401
from .trace import (  # noqa: F401
    NOOP_SPAN,
    TRACER,
    Span,
    Tracer,
    current_trace_id,
    disable,
    enable,
    enabled,
    reset,
    span,
    spans,
)
from .metricsreg import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    percentile,
    prometheus_text,
    summary,
)
from .recorder import RECORDER, FlightRecorder, configure  # noqa: F401
from .costmodel import (  # noqa: F401
    LEDGER,
    ProgramLedger,
    attribute,
    device_spec,
    executable_cost,
    mfu_pct,
)
from .slo import (  # noqa: F401
    BurnRateMonitor,
    SLOSpec,
    serve_slos,
    tenant_slos,
)
from .reqlife import (  # noqa: F401
    REQLIFE,
    LifecycleLedger,
    phase_split,
    resolve_tail,
    tail_artifact,
)
from .drift import CUSUM, EWMA, DriftBoard, DriftSentinel  # noqa: F401
from .fitquality import (  # noqa: F401
    FITQ,
    FitQualityLedger,
    fit_quality_slos,
)
from .export import (  # noqa: F401
    chrome_trace,
    flight_spans,
    reqlife_spans,
    write_chrome_trace,
)

__all__ = [
    "BurnRateMonitor", "CUSUM", "Counter", "DriftBoard",
    "DriftSentinel", "EWMA", "FITQ", "FitQualityLedger",
    "FlightRecorder", "Gauge", "Histogram", "LEDGER",
    "LifecycleLedger", "NOOP_SPAN", "ProgramLedger", "RECORDER",
    "REGISTRY", "REQLIFE", "Registry", "SLOSpec", "Span", "TRACER",
    "Tracer", "attribute", "chrome_trace", "clock",
    "configure", "costmodel", "current_trace_id", "device_spec",
    "disable", "drift", "enable", "enabled", "executable_cost",
    "fit_quality_slos", "fitquality", "flight_spans", "mfu_pct",
    "percentile", "phase_split", "prometheus_text", "reqlife",
    "reqlife_spans", "reset", "resolve_tail", "serve_slos", "slo",
    "span", "spans", "summary", "tail_artifact", "tenant_slos",
    "write_chrome_trace",
]
