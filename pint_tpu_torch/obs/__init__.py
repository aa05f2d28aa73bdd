"""Observability of the port (the JAX package's ``obs/``, in part).

- :mod:`clock` — the one host clock every instrumented module reads;
- :mod:`metricsreg` — counters, gauges and histograms in one snapshot,
  rendered in the Prometheus text format (:data:`REGISTRY`);
- :mod:`recorder` — the flight recorder (:data:`RECORDER`): a bounded
  ring of fault firings and events, dumped to JSON on an anomaly;
- :mod:`slo` — :class:`SLOSpec`, one service-level objective;
- :mod:`fitquality` — the fit-quality probes the fitters and
  ``PTAFleet`` record when ``fitquality.enable()`` is on (:data:`FITQ`);
- :mod:`drift` — EWMA/CUSUM sentinels (the streaming lanes' drift
  watch);
- :mod:`trace` — structured spans in a ring (:func:`trace.enable`; the
  serve engine's ``serve.*`` spans, optionally named torch profiler
  ranges);
- :mod:`reqlife` — the per-request lifecycle ledger the serve engine
  records (:data:`reqlife.REQLIFE`).

Quick start::

    from pint_tpu_torch.obs import fitquality

    fitquality.enable()
    xs, chi2, covs = fleet.fit(method="gls", maxiter=2)
    print(fitquality.check_report(fitquality.FITQ.snapshot()))

Not ported yet (ROADMAP §1 item 3's observability queue): the cost
model, ``DriftBoard``, the burn-rate monitor and the serve packs of
``slo.py``, the baseline gate, the exporter and the ``python -m
pint_tpu.obs`` CLIs.
"""

from . import clock  # noqa: F401
from . import fitquality  # noqa: F401
from . import reqlife  # noqa: F401
from . import slo  # noqa: F401
from . import trace  # noqa: F401
from .fitquality import FITQ, FitQualityLedger, fit_quality_slos  # noqa: F401
from .metricsreg import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                         Registry, percentile, prometheus_text, summary)
from .recorder import RECORDER, FlightRecorder, configure  # noqa: F401
from .slo import SLOSpec  # noqa: F401
