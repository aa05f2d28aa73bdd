"""Metrics registry: counters / gauges / histograms in one snapshot
(the JAX package's ``obs/metricsreg.py``).

This is the pull-model half of the observability layer: hot paths
keep their own cheap bookkeeping (the fit-quality ledger's counters,
a fleet's per-bucket metrics dicts) and the registry *absorbs* those
into one named snapshot at export time, so adding metrics costs the
fit path nothing. Histograms own the one nearest-rank
:func:`percentile` implementation. :func:`prometheus_text` renders a
snapshot in the Prometheus text format with the JAX package's
``pint_tpu_`` name prefix, so one scrape config reads both packages.
"""

from __future__ import annotations

import json
import os
import re
import threading

#: Hard cap on distinct label sets per metric family (env-tunable).
#: Past the cap a new label set folds into the ``other`` bucket and
#: the ``metrics.label_overflow`` counter ticks — an unbounded tenant
#: id space must never become unbounded registry memory.
LABEL_CAP_ENV = "PINT_TPU_LABEL_CAP"


def label_cap():
    try:
        return max(1, int(os.environ.get(LABEL_CAP_ENV, 64)))
    except (TypeError, ValueError):
        return 64


_LBL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def render_labels(labels):
    """Canonical ``{k="v",...}`` rendering (sorted keys, Prometheus
    label-value escaping) — the registry's storage-key suffix for
    labeled metrics, chosen so exposition needs no re-rendering."""
    body = ",".join(
        '%s="%s"' % (k, "".join(_LBL_ESC.get(c, c) for c in str(v)))
        for k, v in sorted(labels.items()))
    return "{%s}" % body


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]); None on empty input.
    Nearest-rank, not interpolated: at serving sample counts the p99
    should be an actually-observed latency, not an average of two."""
    if not values:
        return None
    v = sorted(float(x) for x in values)
    idx = min(len(v) - 1, max(0, -(-int(q) * len(v) // 100) - 1))
    return v[idx]


def summary(values, quantiles=(50, 90, 99)):
    """count/mean/min/max plus nearest-rank quantiles of a sample —
    the shared shape bench stage stats and latency reports render."""
    vals = [float(x) for x in values]
    out = {"count": len(vals)}
    if vals:
        out.update(mean=sum(vals) / len(vals), min=min(vals),
                   max=max(vals))
    else:
        out.update(mean=None, min=None, max=None)
    for q in quantiles:
        out["p%d" % q] = percentile(vals, q)
    return out


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n
        return self


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def set(self, value):
        with self._lock:
            self.value = value
        return self


class Histogram:
    """Bounded raw-sample histogram with nearest-rank quantiles. Raw
    samples (not pre-bucketed counts) because serving sample counts
    are small and the nearest-rank contract needs the actual values.

    Overflow semantics: below ``capacity`` every sample is kept and
    quantiles are exact (byte-compatible with the unbounded case).
    Past capacity the buffer becomes a uniform reservoir (Algorithm
    R, deterministic seed): each of the ``n`` samples observed so far
    has equal probability capacity/n of being in the buffer, so
    quantiles stay an unbiased estimate of the whole stream instead
    of silently narrowing to the most recent window. ``observed``
    and ``sum`` always cover the full stream — Prometheus ``_count``
    / ``_sum`` stay exact either way.

    Exemplar slots: ``record(value, exemplar={...})`` keeps the
    ``exemplar_slots`` largest-valued (value, labels) pairs seen so
    far — trace id + labels on the max-latency observations — so a
    p99 spike resolves to a concrete request (``obs tail``) instead
    of an anonymous quantile."""

    __slots__ = ("_lock", "_capacity", "_values", "_observed",
                 "_sum", "_rng", "_exemplars", "_exemplar_slots")

    def __init__(self, capacity=4096, seed=0, exemplar_slots=4):
        import random

        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._values = []
        self._observed = 0
        self._sum = 0.0
        self._rng = random.Random(seed)
        self._exemplars = []  # [(value, labels dict)], ascending
        self._exemplar_slots = int(exemplar_slots)

    def record(self, value, exemplar=None):
        val = float(value)
        with self._lock:
            self._observed += 1
            self._sum += val
            if len(self._values) < self._capacity:
                self._values.append(val)
            else:
                j = self._rng.randrange(self._observed)
                if j < self._capacity:
                    self._values[j] = val
            if exemplar is not None and self._exemplar_slots > 0:
                ex = self._exemplars
                if (len(ex) < self._exemplar_slots
                        or val > ex[0][0]):
                    ex.append((val, dict(exemplar)))
                    ex.sort(key=lambda p: p[0])
                    del ex[:-self._exemplar_slots]
        return self

    @property
    def observed(self):
        """Total samples ever recorded (>= len(values()) once the
        reservoir saturates)."""
        with self._lock:
            return self._observed

    @property
    def sum(self):
        """Exact running sum over the full stream."""
        with self._lock:
            return self._sum

    def values(self):
        with self._lock:
            return list(self._values)

    def percentile(self, q):
        return percentile(self.values(), q)

    def exemplars(self):
        """Max-latency exemplars, largest first: JSON-safe dicts of
        ``{"value": v, **labels}``."""
        with self._lock:
            return [{"value": v, **labels}
                    for v, labels in reversed(self._exemplars)]

    def summary(self, quantiles=(50, 90, 99)):
        out = summary(self.values(), quantiles)
        with self._lock:
            out["observed"] = self._observed
            out["sum"] = self._sum
            if self._exemplars:
                out["exemplars"] = [{"value": v, **labels}
                                    for v, labels
                                    in reversed(self._exemplars)]
        return out


class Registry:
    """Named metric store; one process-global instance (REGISTRY)
    plus throwaway instances in tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}
        self._families = {}  # base name -> set of rendered label sets

    def _family_key(self, name, labels):
        """Storage key for a (name, labels) pair, enforcing the hard
        per-family cardinality cap: the first ``label_cap()`` distinct
        label sets are admitted verbatim; every later one folds into
        the ``other`` bucket and ticks ``metrics.label_overflow``.
        Unlabeled metrics pass through untouched (and uncapped)."""
        if not labels:
            return name
        rendered = render_labels(labels)
        overflow = False
        with self._lock:
            fam = self._families.setdefault(name, set())
            if rendered not in fam:
                if len(fam) < label_cap():
                    fam.add(rendered)
                else:
                    overflow = True
        if overflow:
            # counted per folded observation: the counter's rate IS
            # the rate of traffic landing in the overflow bucket
            self.counter("metrics.label_overflow").inc()
            return name + render_labels(
                {k: "other" for k in labels})
        return name + rendered

    def counter(self, name, labels=None):
        name = self._family_key(name, labels)
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter()
        return m

    def gauge(self, name, labels=None):
        name = self._family_key(name, labels)
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge()
        return m

    def histogram(self, name, capacity=4096, labels=None):
        name = self._family_key(name, labels)
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(capacity)
        return m

    def attach_histogram(self, name, hist, labels=None):
        """Install a live Histogram object under ``name`` (shared, not
        copied), so a caller's live latency histogram (and its
        exemplar slots) joins the scraped exposition without
        re-recording samples at export time."""
        name = self._family_key(name, labels)
        with self._lock:
            self._histograms[name] = hist
        return hist

    def absorb(self, mapping, prefix=""):
        """Fold a flat or nested dict of numbers into the registry:
        ints become counters, floats/None become gauges, lists become
        histograms, dicts recurse with a dotted prefix. This is how
        a ledger's counters land in one exportable snapshot without
        the fit path pushing metrics as it runs."""
        for key, val in mapping.items():
            name = "%s%s" % (prefix, key)
            if isinstance(val, dict):
                self.absorb(val, prefix=name + ".")
            elif isinstance(val, bool):
                self.gauge(name).set(int(val))
            elif isinstance(val, int):
                c = self.counter(name)
                with c._lock:
                    c.value = val
            elif isinstance(val, (list, tuple)):
                h = self.histogram(name)
                for v in val:
                    if isinstance(v, (int, float)):
                        h.record(v)
            elif isinstance(val, float) or val is None:
                self.gauge(name).set(val)
            # non-numeric leaves (strings, objects) are not metrics
        return self

    def snapshot(self):
        with self._lock:
            counters = {k: m.value for k, m in self._counters.items()}
            gauges = {k: m.value for k, m in self._gauges.items()}
            hists = dict(self._histograms)
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": {k: hists[k].summary()
                           for k in sorted(hists)},
        }

    def to_json(self, **dump_kw):
        return json.dumps(self.snapshot(), **dump_kw)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._families.clear()


REGISTRY = Registry()

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name, prefix="pint_tpu_"):
    return prefix + _PROM_BAD.sub("_", name)


def _prom_split(name, prefix):
    """Split a registry storage key into (sanitized name, label body):
    labeled keys carry their canonical ``{k="v"}`` suffix, which must
    survive exposition verbatim rather than being sanitized away."""
    base, brace, rest = name.partition("{")
    labels = (brace + rest) if brace else ""
    return prom_name(base, prefix), labels


def _merge_labels(labels, extra):
    """Append ``extra`` (e.g. a quantile label) into a rendered label
    body, handling the unlabeled case."""
    if not labels:
        return "{%s}" % extra
    return labels[:-1] + "," + extra + "}"


def prometheus_text(registry=None, prefix="pint_tpu_"):
    """Render a registry snapshot in the Prometheus text exposition
    format: one `# TYPE` header per sanitized metric name (deduped —
    two registry names that sanitize to the same exposition name get
    one header), histograms exported as summaries with nearest-rank
    quantile labels, `_count`/`_sum` covering the full observed
    stream when the snapshot carries reservoir totals."""
    reg = REGISTRY if registry is None else registry
    snap = reg.snapshot() if isinstance(reg, Registry) else reg
    lines = []
    typed = set()

    def _type(pn, kind):
        if pn not in typed:
            typed.add(pn)
            lines.append("# TYPE %s %s" % (pn, kind))

    for name, val in snap.get("counters", {}).items():
        pn, lbl = _prom_split(name, prefix)
        _type(pn, "counter")
        lines.append("%s%s %s" % (pn, lbl, _prom_value(val)))
    for name, val in snap.get("gauges", {}).items():
        pn, lbl = _prom_split(name, prefix)
        _type(pn, "gauge")
        lines.append("%s%s %s" % (pn, lbl, _prom_value(val)))
    for name, summ in snap.get("histograms", {}).items():
        pn, lbl = _prom_split(name, prefix)
        _type(pn, "summary")
        for q in (50, 90, 99):
            qlbl = _merge_labels(lbl, 'quantile="0.%02d"' % q)
            lines.append('%s%s %s'
                         % (pn, qlbl, _prom_value(summ.get("p%d" % q))))
        count = summ.get("observed", summ["count"])
        lines.append("%s_count%s %s" % (pn, lbl, _prom_value(count)))
        total = summ.get("sum")
        if total is None:
            mean = summ.get("mean")
            total = (mean * summ["count"]
                     if mean is not None and summ["count"] else 0)
        lines.append("%s_sum%s %s" % (pn, lbl, _prom_value(total)))
        for ex in summ.get("exemplars") or []:
            # classic-text-format-safe exemplar: comment lines are
            # ignored by Prometheus parsers, OpenMetrics-style body
            ex = dict(ex)
            val = ex.pop("value", None)
            body = ",".join('%s="%s"' % (k, v)
                            for k, v in sorted(ex.items())
                            if v is not None)
            lines.append("# exemplar: %s{%s} %s"
                         % (pn, body, _prom_value(val)))
    return "\n".join(lines) + "\n"


def _prom_value(v):
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(v)
