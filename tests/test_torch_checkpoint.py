"""The port's fit checkpoints (pint_tpu_torch/checkpoint.py) against the
JAX package's, on the CPU.

A snapshot is one ``.npz`` artifact with its CRC32 embedded (the JAX
package's fallback format; torch has no orbax), rotated to
``<tag>.prev`` before every save, and a damaged latest snapshot
restores the previous one. ``checkpointed_fit`` and
``checkpointed_pta_fit`` resume from a snapshot: within the port a
resumed fit is bitwise the uninterrupted one over the same chunks (a
segment-packed mixed-precision bucket included, the main path's
layout), and across packages each holds the JAX package's at 1e-6
sigma (ERRORBUDGET's tier). A red-noise batch's chi2 is held at 1e-7
relative, the tier of ROADMAP §3's red-noise GLS chi2 entry: the same
batch fitted by ``PTABatch.gls_fit`` with no checkpoint already differs
by 3.1e-8 between the packages (the one-ulp phase gap through the
Woodbury cancellation). The JAX package restores the port's snapshots.
"""

import warnings

import numpy as np
import pytest

from test_torch_serve import pulsar, side
from test_torch_store import NOISE, _fleet_inputs

warnings.simplefilter("ignore")

TOL_SIGMA = 1e-6
TOL_CHI2_RED = 1e-7  # red-noise GLS chi2 across packages (ROADMAP §3)


@pytest.fixture(autouse=True)
def _disarm_everything():
    yield
    from pint_tpu_torch.resilience import disarm

    disarm()


def test_checkpoint_writes_one_artifact_no_sidecar(tmp_path):
    from pint_tpu.checkpoint import FitCheckpointer as JaxCheckpointer
    from pint_tpu_torch.checkpoint import FitCheckpointer

    ckpt = FitCheckpointer(tmp_path)
    ckpt.save("fit", {"x": np.arange(4.0), "iter": 1,
                      "names": np.array(["F0", "F1"])})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["fit.npz"]
    out = ckpt.restore("fit")
    assert int(out["iter"]) == 1 and list(out["names"]) == ["F0", "F1"]
    # the JAX package reads it (its npz path, with the same CRC)
    theirs = JaxCheckpointer(tmp_path).restore("fit")
    np.testing.assert_array_equal(theirs["x"], np.arange(4.0))
    assert list(theirs["names"]) == ["F0", "F1"]
    assert ckpt.latest_iteration("fit") == 1
    assert ckpt.latest_iteration("none") == -1


def test_checkpoint_rotation_clears_stale_legacy_prev(tmp_path):
    from pint_tpu_torch.checkpoint import FitCheckpointer

    stale = tmp_path / "fit.prev.meta.json"
    stale.write_text("{}")
    ckpt = FitCheckpointer(tmp_path)
    ckpt.save("fit", {"x": np.arange(4.0), "iter": 1})
    ckpt.save("fit", {"x": np.arange(4.0), "iter": 2})  # rotates
    assert not stale.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["fit.npz", "fit.prev.npz"]
    assert int(ckpt.restore("fit")["iter"]) == 2
    assert int(ckpt.restore("fit.prev")["iter"]) == 1


def test_corrupt_latest_falls_back_to_prev(tmp_path):
    from pint_tpu_torch.checkpoint import FitCheckpointer
    from pint_tpu_torch.resilience import FaultPoint, inject

    ckpt = FitCheckpointer(tmp_path)
    ckpt.save("fit", {"x": np.arange(4.0), "iter": 1})
    with inject(FaultPoint("checkpoint_corrupt", count=1)):
        ckpt.save("fit", {"x": np.arange(4.0) + 1, "iter": 2})
    with pytest.warns(UserWarning):
        out = ckpt.restore("fit")
    assert int(out["iter"]) == 1
    assert ckpt.restore("fit", fallback=False) is None
    # a flipped byte that still unzips fails the CRC instead
    ckpt.save("fit", {"x": np.arange(4.0), "iter": 3})
    ckpt.save("fit", {"x": np.arange(4.0), "iter": 4})
    with np.load(tmp_path / "fit.npz") as z:
        tree = {k: z[k] for k in z.files}
    tree["x"] = tree["x"] + 1.0  # same layout, different numbers
    np.savez(tmp_path / "fit.npz", **tree)
    with pytest.warns(UserWarning, match="CRC32"):
        assert int(ckpt.restore("fit")["iter"]) == 3


def test_resilience_state_roundtrip(tmp_path):
    from pint_tpu.checkpoint import restore_resilience_state as jax_restore
    from pint_tpu.resilience import CircuitBreaker as JaxBreaker
    from pint_tpu_torch.checkpoint import (restore_resilience_state,
                                           save_resilience_state)
    from pint_tpu_torch.resilience import CircuitBreaker, HealthMonitor

    br, hm = CircuitBreaker(), HealthMonitor()
    br.trip(("fit", 64, "gls"))
    save_resilience_state(tmp_path, breaker=br, health=hm)
    br2, hm2 = CircuitBreaker(), HealthMonitor()
    assert restore_resilience_state(tmp_path, breaker=br2, health=hm2) \
        == {"breaker", "health"}
    assert br2.open_count() == 1
    jbr = JaxBreaker()
    assert jax_restore(tmp_path, breaker=jbr) == {"breaker"}
    assert jbr.open_count() == 1
    assert restore_resilience_state(tmp_path / "none", breaker=br2) == set()


def test_checkpointed_fit_resumes_and_matches_jax(tmp_path):
    """Two WLS iterations in one-iteration chunks: a run that stops
    after the first chunk and resumes equals the uninterrupted run
    bitwise, and both hold the JAX package's at 1e-6 sigma."""
    from pint_tpu.checkpoint import checkpointed_fit as jax_ckfit
    from pint_tpu.fitter import WLSFitter as JaxWLS
    from pint_tpu_torch.checkpoint import checkpointed_fit
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model

    p = pulsar(2, 40, seed=7)
    par, jm, jt = p[0], p[1], p[2]
    _, pt = side(p, "torch")

    def port_fit(d, maxiter):
        f = WLSFitter(pt, get_model(par), device="cpu")
        chi2 = checkpointed_fit(f, d, every=1, maxiter=maxiter)
        return f, chi2

    full, chi2_full = port_fit(tmp_path / "full", 2)
    port_fit(tmp_path / "resumed", 1)
    resumed, chi2_res = port_fit(tmp_path / "resumed", 2)
    assert chi2_res == chi2_full
    names = list(full.model.free_params)
    for n in names:
        assert getattr(resumed.model, n).value \
            == getattr(full.model, n).value
    jf = JaxWLS(jt, jm)
    jax_ckfit(jf, tmp_path / "jax", every=1, maxiter=2)
    for n in names:
        sig = getattr(jf.model, n).uncertainty
        gap = abs(getattr(full.model, n).value
                  - getattr(jf.model, n).value) / sig
        assert gap < TOL_SIGMA, (n, gap)
    # a snapshot over other free parameters refuses to restore
    other = get_model(par.replace("DM 12.2 1", "DM 12.2 0"))
    with pytest.raises(ValueError, match="free params"):
        checkpointed_fit(WLSFitter(pt, other, device="cpu"),
                         tmp_path / "full", maxiter=3)


@pytest.fixture(scope="module")
def noise_fleet():
    return _fleet_inputs(4, 40, extra=NOISE)


def test_checkpointed_pta_fit_matches_jax(tmp_path, noise_fleet):
    from pint_tpu.checkpoint import checkpointed_pta_fit as jax_ckpta
    from pint_tpu.parallel import PTABatch as JaxBatch
    from pint_tpu_torch.checkpoint import checkpointed_pta_fit
    from pint_tpu_torch.parallel import PTABatch

    _, jms, jts, pms, pts = noise_fleet
    x, chi2, cov = checkpointed_pta_fit(
        PTABatch(pms, pts, device="cpu"), tmp_path / "torch",
        every=1, maxiter=2)
    jx, jchi2, jcov = jax_ckpta(JaxBatch(jms, jts), tmp_path / "jax",
                                every=1, maxiter=2)
    for i in range(len(pms)):
        sig = np.sqrt(np.diag(np.asarray(jcov[i])))
        assert np.max(np.abs(x[i] - np.asarray(jx[i])) / sig) < TOL_SIGMA
    np.testing.assert_allclose(chi2, np.asarray(jchi2), rtol=TOL_CHI2_RED)
    # the snapshot covers maxiter: a rerun fits nothing
    x2, chi2b, cov2 = checkpointed_pta_fit(
        PTABatch(pms, pts, device="cpu"), tmp_path / "torch",
        every=1, maxiter=2)
    assert cov2 is None and np.array_equal(x2, x)


def test_checkpointed_pta_fit_resume_is_bitwise_on_a_packed_bucket(
        tmp_path, noise_fleet):
    """The main path's bucket layout and precision: a segment-packed
    red-noise bucket fitted GLS mixed. One chunk, a stop, then a resume
    (through a damaged latest snapshot, which falls back to .prev) is
    bitwise the uninterrupted two-chunk run."""
    from pint_tpu_torch.checkpoint import checkpointed_pta_fit
    from pint_tpu_torch.parallel import PTAFleet

    _, _, _, pms, pts = noise_fleet

    def batch():
        fleet = PTAFleet(pms, pts, device="cpu", toa_bucket="plan",
                         plan_quantum=32, plan_min_width=128,
                         plan_max_pack=4, plan_compile_budget=1)
        (b,) = fleet.batches.values()
        assert b._pack
        return b

    kw = dict(method="gls", precision="mixed", every=1)
    full = checkpointed_pta_fit(batch(), tmp_path / "full", maxiter=2,
                                **kw)
    d = tmp_path / "resumed"
    checkpointed_pta_fit(batch(), d, maxiter=1, **kw)
    # the stop left chunk 1 as the latest snapshot; make a second
    # generation and damage it, so the resume must read .prev
    from pint_tpu_torch.checkpoint import FitCheckpointer

    ckpt = FitCheckpointer(d)
    state = ckpt.restore("pta")
    ckpt.save("pta", dict(state))
    ckpt._corrupt_snapshot("pta")
    with pytest.warns(UserWarning, match="previous snapshot"):
        resumed = checkpointed_pta_fit(batch(), d, maxiter=2, **kw)
    for a, b in zip(full, resumed):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert int(FitCheckpointer(d).restore("pta")["iter"]) == 2
