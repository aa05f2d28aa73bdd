"""The port's spans (obs.trace) on the fleet executor, the AOT split, the
GW stage and the delta store, against the JAX package's on the same
calls.

- A traced fleet fit — WLS and GLS buckets, sequential and pipelined,
  after ``precompile`` — is bitwise the untraced one, and its span
  names and parent links (by name, in finish order) equal the JAX
  package's for the same fit of the same TOAs.
- ``fleet.execute`` carries the roofline attribution of its bucket's
  program on the CPU row (a non-null MFU); with tracing off the fit
  builds no attribute and never calls the cost model, and ``span()``
  returns the shared no-op. (The 1% cost share of a disabled span is
  timed on the card, in ``chip_smoke.py``'s ``[obs] fleet``.)
- A cold traced build and ``precompile`` show ``fleet.host_prep``,
  ``fleet.pack``, ``fleet.compile``, ``aot.trace`` and
  ``aot.backend_compile``; pool threads join their caller's trace.
- ``gw.os`` / ``gw.correlate`` / ``gw.scramble``, and
  ``store.delta_append`` / ``store.delta_prewarm``, equal the JAX
  package's names and links on the same inputs.
"""

import copy

import numpy as np
import pytest

from test_torch_fleet_pipeline import _noise_par, _spin_par
from test_torch_pta import port_toas


def _links(spans):
    """[(name, parent name)] in finish order."""
    by_id = {s["span"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent"])) for s in spans]


def _jax_pulsars():
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    pars, toas = [], []
    rng = np.random.default_rng(0)
    for i in range(2):
        pars.append(_spin_par(i))
        mjds = np.sort(rng.uniform(55000, 56000, 24 + 4 * i))
        toas.append(make_fake_toas_fromMJDs(
            mjds, get_model(pars[-1]), error_us=1.0, freq_mhz=1400.0,
            obs="gbt", add_noise=True, seed=i))
    for i in range(2):
        pars.append(_noise_par(i))
        days = np.linspace(55000, 56000, 10 + 2 * i)
        mjds = np.concatenate([d + np.arange(3) * 0.5 / 86400.0
                               for d in days])
        toas.append(make_fake_toas_fromMJDs(
            mjds, get_model(pars[-1]), error_us=1.0,
            freq_mhz=np.full(len(mjds), 1400.0), obs="gbt",
            add_noise=True, seed=100 + i, flags={"f": "L-wide"}))
    return pars, toas


@pytest.fixture(scope="module")
def fleets():
    """(port fleet, JAX fleet) of 2 spin + 2 noise pulsars on the same
    TOAs, every program precompiled for method="auto", maxiter=2."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTAFleet

    pars, jts = _jax_pulsars()
    tf = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  device="cpu")
    jf = JaxFleet([jget_model(p) for p in pars], jts)
    for f in (tf, jf):
        f.precompile(method="auto", maxiter=2)
    return tf, jf


def _traced(trace, fn):
    trace.reset()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    spans = trace.spans()
    trace.reset()
    return out, spans


@pytest.mark.parametrize("pipeline", [False, True])
def test_traced_fit_bitwise_and_links_match_jax(fleets, pipeline):
    from pint_tpu.obs import trace as jtrace
    from pint_tpu_torch.obs import trace

    tf, jf = fleets

    def fit(f):
        return lambda: f.fit(method="auto", maxiter=2, pipeline=pipeline)

    plain = fit(tf)()
    traced, spans = _traced(trace, fit(tf))
    for a, b in zip(plain, traced):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    _, jspans = _traced(jtrace, fit(jf))
    assert _links(spans) == _links(jspans)
    want = ([("fleet.dispatch", "fleet.fit")] * 2 if pipeline else []) + [
        ("fleet.execute", "fleet.fit")] * 2 + [("fleet.fit", None)]
    assert _links(spans) == want
    execs = [s for s in spans if s["name"] == "fleet.execute"]
    for s in execs:
        a = s["attrs"]
        assert a["platform"] == "cpu" and "nominal" not in a
        assert a["mfu_pct"] is not None and a["roofline_pct"] is not None
        assert a["bound"] in ("compute", "memory")
        assert a["flops"] > 0 and a["bytes_accessed"] > 0
    assert {s["trace"] for s in spans} == {spans[-1]["trace"]}


def test_disabled_tracing_is_the_noop_and_attributes_nothing(fleets,
                                                             monkeypatch):
    from pint_tpu_torch.obs import costmodel, trace
    from pint_tpu_torch.parallel import PTAFleet

    tf, _ = fleets
    trace.reset()
    assert not trace.enabled()
    assert trace.span("fleet.execute", bucket=0) is trace.NOOP_SPAN

    def boom(*a, **k):
        raise AssertionError("attribution while tracing is off")

    monkeypatch.setattr(costmodel, "attribute", boom)
    monkeypatch.setattr(PTAFleet, "_annotate_execute", staticmethod(boom))
    for pipeline in (False, True):
        tf.fit(method="auto", maxiter=2, pipeline=pipeline)
    assert trace.spans() == []
    monkeypatch.undo()
    # spans per traced fit: what the card's 1% share multiplies by
    _, spans = _traced(trace, lambda: tf.fit(method="auto", maxiter=2,
                                             pipeline=True))
    assert len(spans) == 5


def test_cold_build_and_precompile_spans():
    from pint_tpu_torch.obs import trace
    from pint_tpu_torch.parallel import PTAFleet
    from test_torch_fleet_pipeline import _noise_pulsars, _spin_pulsars

    ms, ts = _spin_pulsars(2)
    mn, tn = _noise_pulsars(2)

    def cold():
        with trace.span("demo"):
            fleet = PTAFleet(copy.deepcopy(ms + mn), ts + tn, device="cpu",
                             pipeline=True)
            fleet.precompile(method="auto", maxiter=2)
        return fleet

    fleet, spans = _traced(trace, cold)
    names = {s["name"] for s in spans}
    assert {"fleet.host_prep", "fleet.pack", "fleet.compile", "aot.trace",
            "aot.backend_compile", "demo"} <= names
    root = next(s for s in spans if s["name"] == "demo")
    # pool threads (host prep, program builds) join the caller's trace
    assert {s["trace"] for s in spans} == {root["trace"]}
    links = _links(spans)
    assert links.count(("fleet.host_prep", None)) == 2  # pool threads
    assert links.count(("aot.trace", None)) == 2
    assert links.count(("aot.backend_compile", "fleet.compile")) == 2
    assert ("fleet.compile", "demo") in links
    compiles = [s for s in spans if s["name"] == "aot.backend_compile"]
    assert all(s["attrs"]["flops"] > 0 and s["attrs"]["captured"] is False
               for s in compiles)
    assert all(b._costs for b in fleet.batches.values())


def test_aot_deserialize_raises_inside_its_span():
    from pint_tpu_torch import fitter
    from pint_tpu_torch.obs import trace

    def call():
        with pytest.raises(RuntimeError, match="no serialized form"):
            fitter.aot_deserialize({"payload": b""})

    _, spans = _traced(trace, call)
    assert [(s["name"], s["status"]) for s in spans] == [
        ("aot.deserialize", "error")]


def test_gw_spans_match_jax():
    from pint_tpu import gw as jgw
    from pint_tpu.obs import trace as jtrace
    from pint_tpu_torch import gw
    from pint_tpu_torch.obs import trace
    from pint_tpu_torch.obs.metricsreg import REGISTRY
    from test_torch_gw import _injected

    jlat, lat = _injected(P=12, M=24)

    def run(mod, L, **kw):
        def go():
            os_ = mod.optimal_statistic(L, block=5, **kw)
            null = mod.scramble_null(L, n_draws=3, block=5,
                                     snr_obs=os_["snr"], **kw)
            return os_, null
        return go

    before = REGISTRY.counter("gw.pairs").value
    (os_, null), spans = _traced(trace, run(gw, lat, device="cpu"))
    (jos, jnull), jspans = _traced(jtrace, run(jgw, jlat))
    assert _links(spans) == _links(jspans) == [
        ("gw.correlate", "gw.os"), ("gw.os", None),
        ("gw.correlate", "gw.scramble"), ("gw.scramble", None)]
    np.testing.assert_allclose(null["snr_null"], jnull["snr_null"],
                               rtol=1e-10)
    assert REGISTRY.counter("gw.pairs").value - before == 2 * 66
    st = os_["sweep"]
    assert st["bytes_accessed"] > 0 and st["mfu_pct"] is not None
    assert st["bound"] == jos["sweep"]["bound"]
    corr = next(s for s in spans if s["name"] == "gw.correlate")
    assert corr["attrs"]["mfu_pct"] == st["mfu_pct"]
    assert corr["attrs"]["bound"] == st["bound"]


def test_store_spans_match_jax(tmp_path):
    from pint_tpu.obs import trace as jtrace
    from pint_tpu.store import DeltaStore as JDeltaStore
    from pint_tpu_torch.obs import trace
    from pint_tpu_torch.store import DeltaStore

    rng = np.random.default_rng(3)
    arrays = {"X": rng.standard_normal((6, 4)), "r": rng.standard_normal(6),
              "winv": rng.uniform(1, 2, 6)}

    def run(cls, d):
        def go():
            st = cls(d)
            tip, _ = st.append("lane0", "base", arrays, rid="a")
            st.append("lane0", tip, arrays, rid="b")
            st2 = cls(d)
            st2.prewarm([("lane0", "base")], background=False)
            return st2.load_chain("lane0", "base")
        return go

    got, spans = _traced(trace, run(DeltaStore, tmp_path / "t"))
    want, jspans = _traced(jtrace, run(JDeltaStore, tmp_path / "j"))
    assert _links(spans) == _links(jspans) == [
        ("store.delta_append", None), ("store.delta_append", None),
        ("store.delta_prewarm", None)]
    assert len(got) == len(want) == 2
