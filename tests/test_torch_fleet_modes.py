"""The port's PTAFleet modes beyond the main path against the JAX
package's, on the CPU, on the same noisy TOAs (test_torch_pta.py's six
pulsars, 64-512 TOAs): WLS (``method="wls"``, and ``"auto"`` on
noise-free buckets), dense ECORR (``ecorr_mode="dense"`` and
overlapping ECORR masks, unpacked and packed), ``toa_bucket="pow2"``
with ``bucket_floor`` and ``"split<k>"``, and ``precision="auto"``.

Tolerances, as in test_torch_pta.py: parameters to 1e-6 sigma (the
batched-fit tier; measured ~1e-7 sigma, one-ulp phase differences),
chi2 to 1e-9 relative, covariances to 1e-10 relative in f64 and 1e-4
in mixed precision (each package factors its own f32-accumulated
Gram). Dense against marginalized ECORR in the port is held as
tests/test_parallel.py holds it in the JAX package: rtol 1e-9 on the
updates x - x0, 1e-12 on chi2, 1e-6 on the quoted uncertainties.
"""

import warnings

import numpy as np
import pytest
import torch

from test_torch_pta import PLAN, compare, make_toas, port_toas


@pytest.fixture(scope="module")
def toas():
    """(pars, JAX models, JAX TOAs, port TOAs)."""
    pars, jms, jts = make_toas()
    return pars, jms, jts, [port_toas(t) for t in jts]


def _fleets(pars, jts, pts, **kw):
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTAFleet

    jf = JaxFleet([jget_model(p) for p in pars], jts, **kw)
    tf = PTAFleet([get_model(p) for p in pars], pts, device="cpu", **kw)
    return jf, tf


def _fit_both(jf, tf, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_j = jf.fit(**kw)
    return out_j, tf.fit(**kw)


def _noise_free(p):
    """The par without its noise lines (EFAC and after)."""
    return p.split("EFAC")[0]


@pytest.mark.parametrize("method", ["wls", "auto"])
def test_wls_fleet_matches_jax(toas, method):
    """Noise-free models: method "wls", and "auto", which routes every
    bucket through WLS (no correlated-noise basis)."""
    pars, _, jts, pts = toas
    jf, tf = _fleets([_noise_free(p) for p in pars], jts, pts)
    (xj, cj, covj), (xt, ct, covt) = _fit_both(jf, tf, method=method,
                                               maxiter=3)
    compare(xj, cj, covj, xt, ct, covt, 1e-10)
    assert all(m["method"] == "wls" for m in tf.fit_metrics.values())


def test_auto_routes_wls_and_gls_per_bucket(toas):
    """A fleet mixing noise-free and noise models: "auto" fits the
    noise-free bucket by WLS and the noise bucket by GLS, and matches
    the JAX package's "auto"; "wls" on a noise bucket is a plain WLS,
    as in the JAX package; an unknown method is refused."""
    pars, _, jts, pts = toas
    mixed = [_noise_free(p) if i % 2 else p for i, p in enumerate(pars)]
    jf, tf = _fleets(mixed, jts, pts)
    (xj, cj, covj), (xt, ct, covt) = _fit_both(jf, tf, method="auto",
                                               maxiter=2)
    compare(xj, cj, covj, xt, ct, covt, 1e-10)
    assert sorted(m["method"] for m in tf.fit_metrics.values()) == [
        "gls", "wls"]
    with pytest.raises(ValueError, match="method"):
        tf.fit(method="lm")


@pytest.mark.parametrize("mode,kw,precision", [
    ("pow2", {"bucket_floor": 64}, "f64"),
    ("pow2", {"bucket_floor": 64}, "mixed"),
    ("split2", {}, "f64"),
    ("split3", {}, "mixed")])
def test_bucket_modes_match_jax(toas, mode, kw, precision):
    """toa_bucket="pow2" (bucket_floor 64) and "split<k>": the same
    buckets as the JAX package (keys and members) and the same fit."""
    pars, _, jts, pts = toas
    jf, tf = _fleets(pars, jts, pts, toa_bucket=mode, **kw)
    assert list(tf.group_indices.items()) == list(jf.group_indices.items())
    assert len(tf.group_indices) > 1
    assert tf.padding_ratio == pytest.approx(jf.padding_ratio, rel=1e-15)
    (xj, cj, covj), (xt, ct, covt) = _fit_both(
        jf, tf, method="gls", maxiter=2, precision=precision)
    compare(xj, cj, covj, xt, ct, covt,
            1e-10 if precision == "f64" else 1e-4)


def test_bucket_planning_matches_jax():
    """optimal_split_bounds and plan_groups on ragged counts, and the
    refusals of bad toa_bucket values."""
    from types import SimpleNamespace

    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.parallel.pta import PTAFleet

    rng = np.random.default_rng(4)
    counts = rng.lognormal(np.log(2000), 1.0, 40).astype(int) + 10
    for k in (1, 2, 3, 5, 60):
        assert PTAFleet.optimal_split_bounds(counts, k) == \
            JaxFleet.optimal_split_bounds(counts, k)
    assert PTAFleet.optimal_split_bounds([], 3) == []
    # the structure key reads components/free params/static values only
    model = SimpleNamespace(components={"Spindown": None}, free_params=[],
                            params=[])
    toas_list = [range(int(c)) for c in counts]
    for mode, kw in (("pow2", {"bucket_floor": 128}), ("split4", {})):
        g, bkw, plans = PTAFleet.plan_groups([model] * len(counts),
                                             toas_list, toa_bucket=mode, **kw)
        jg, _, _ = JaxFleet.plan_groups([model] * len(counts), toas_list,
                                        toa_bucket=mode, **kw)
        assert g == jg and bkw == {} and plans == {}
    for bad in ("split0", "splitx", "pow3"):
        with pytest.raises(ValueError, match="toa_bucket"):
            PTAFleet.plan_groups([], [], toa_bucket=bad)


@pytest.mark.parametrize("layout,precision", [(None, "f64"),
                                              (None, "mixed"),
                                              ("plan", "f64")])
def test_dense_ecorr_matches_jax(toas, layout, precision):
    """ecorr_mode="dense": every ECORR epoch column in the dense solve,
    one pulsar per row and in the packed plan layout."""
    pars, _, jts, pts = toas
    kw = PLAN if layout == "plan" else {}
    jf, tf = _fleets(pars, jts, pts, **kw)
    (xj, cj, covj), (xt, ct, covt) = _fit_both(
        jf, tf, method="gls", maxiter=2, precision=precision,
        ecorr_mode="dense")
    compare(xj, cj, covj, xt, ct, covt,
            1e-10 if precision == "f64" else 1e-4)


def test_dense_ecorr_matches_marginalized(toas):
    """In the port, the dense solve and the analytic marginalization
    give the same fit (tests/test_parallel.py's tiers); an unknown
    ecorr_mode is refused; no global dtype change."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTABatch

    pars, _, _, pts = toas
    b = PTABatch([get_model(p) for p in pars], pts, device="cpu")
    x0 = b._x0().numpy()
    xd, c2d, covd = b.gls_fit(maxiter=2, ecorr_mode="dense")
    xm, c2m, covm = b.gls_fit(maxiter=2, ecorr_mode="auto")
    np.testing.assert_allclose(xm - x0, xd - x0, rtol=1e-9, atol=1e-18)
    np.testing.assert_allclose(c2m, c2d, rtol=1e-12)
    dd = np.sqrt(np.diagonal(covd, axis1=1, axis2=2))
    dm = np.sqrt(np.diagonal(covm, axis1=1, axis2=2))
    np.testing.assert_allclose(dm, dd, rtol=1e-6)
    with pytest.raises(ValueError, match="ecorr_mode"):
        b.gls_fit(ecorr_mode="sparse")
    assert torch.get_default_dtype() == torch.float32


def test_overlapping_ecorr_masks_match_jax(toas):
    """Two ECORR masks over the same TOAs (a flag mask and an MJD
    range) put TOAs in two epochs: both packages pack the dense U and
    take the dense solve, in one pulsar per row and in the plan
    layout, where pulsars without the overlap are densified."""
    pars, _, jts, pts = toas
    over = [p + "ECORR mjd 54000 55500 0.6\n" if i % 2 == 0 else p
            for i, p in enumerate(pars)]
    from pint_tpu_torch.models import get_model

    p0 = get_model(over[0]).prepare(pts[0], device="cpu")
    assert "ecorr_U" in p0.prep and "ecorr_eidx" not in p0.prep
    for kw in ({}, PLAN):
        jf, tf = _fleets(over, jts, pts, **kw)
        (xj, cj, covj), (xt, ct, covt) = _fit_both(jf, tf, method="gls",
                                                   maxiter=2)
        compare(xj, cj, covj, xt, ct, covt, 1e-10)


def test_precision_auto_matches_jax(toas):
    """precision="auto" on the plan fleet: each bucket times one warm
    mixed and one warm f64 fit and keeps the faster; whatever each
    package chose, the parameters agree within the mixed tier. The
    verdict is cached per structure and shape."""
    from pint_tpu_torch.parallel import pta

    pars, _, jts, pts = toas
    jf, tf = _fleets(pars, jts, pts, **PLAN)
    (xj, cj, covj), (xt, ct, covt) = _fit_both(jf, tf, method="gls",
                                               maxiter=2, precision="auto")
    compare(xj, cj, covj, xt, ct, covt, 1e-4)
    for b in tf.batches.values():
        v = b.precision_auto
        assert v["choice"] in ("f64", "mixed") and v["f64_s"] > 0
        assert v["choice"] == pta.PTABatch._precision_verdict(
            {"f64": v["f64_s"], "mixed": v["mixed_s"]},
            v["mixed_relres_failed"])
        assert b._resolve_precision("auto") == v["choice"]  # cached
        assert b._resolve_precision("mixed") == "mixed"


def test_precision_verdict_rule():
    """The verdict: f64 on a failed mixed probe or a tie, else the
    faster mode."""
    from pint_tpu.parallel.pta import PTABatch as JB
    from pint_tpu_torch.parallel.pta import PTABatch as TB

    for t, failed in (({"f64": 1.0, "mixed": 0.5}, False),
                      ({"f64": 1.0, "mixed": 0.5}, True),
                      ({"f64": 0.5, "mixed": 0.5}, False),
                      ({"f64": 0.4, "mixed": 0.5}, False)):
        assert TB._precision_verdict(t, failed) == JB._precision_verdict(
            t, failed)


def test_wls_refused_on_packed_batches(toas):
    """The packed layout is GLS-only, as in the JAX package."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTAFleet

    pars, _, _, pts = toas
    tf = PTAFleet([get_model(p) for p in pars], pts, device="cpu", **PLAN)
    packed = [b for b in tf.batches.values() if b._pack]
    assert packed
    with pytest.raises(RuntimeError, match="packed"):
        packed[0].wls_fit()


@pytest.mark.cuda
def test_fleet_modes_on_card():
    """On the card: WLS, pow2 (mixed) and dense ECORR against the CPU
    port, on TOAs from the port's own fake-TOA maker (the card's
    machine need not have JAX). Parameters to 1e-6 sigma and
    covariances to the mixed tier, as above; chi2 to 2e-7 relative, the
    cross-device tier: CUDA's f64 sin/cos/atan differ from the host
    libm's by an ulp, which moves the phase by ~1e-11 cycles and each
    residual by ~1e-13 s against ~1 us residuals, so chi2 moves by up
    to ~2 x 1e-7 of itself (measured 1.3e-8 on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTAFleet
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from test_torch_pta import COUNTS, par

    rng = np.random.default_rng(3)
    pars, pts = [], []
    for i, n in enumerate(COUNTS):
        pars.append(par(i))
        days = np.sort(rng.uniform(54000, 57000, n // 4))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        pts.append(make_fake_toas_fromMJDs(
            mjds, get_model(pars[-1]), error_us=1.0,
            freq_mhz=np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0),
            add_noise=True, seed=i, flags={"f": "L-wide"}, device="cpu"))
    for plist, kw, fit_kw in (
            ([_noise_free(p) for p in pars], {}, {"method": "wls"}),
            (pars, {"toa_bucket": "pow2", "bucket_floor": 64},
             {"method": "gls", "precision": "mixed"}),
            (pars, {}, {"method": "gls", "ecorr_mode": "dense"})):
        cpu = PTAFleet([get_model(p) for p in plist], pts, device="cpu", **kw)
        card = PTAFleet([get_model(p) for p in plist], pts, device="cuda",
                        **kw)
        xc, cc, covc = cpu.fit(maxiter=2, **fit_kw)
        xg, cg, covg = card.fit(maxiter=2, **fit_kw)
        sig = np.sqrt(np.array([np.diag(c) for c in covc]))
        assert np.max(np.abs(np.array(xg) - np.array(xc)) / sig) <= 1e-6
        np.testing.assert_allclose(cg, cc, rtol=2e-7, atol=0)
        for a, b in zip(covg, covc):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
