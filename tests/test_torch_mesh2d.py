"""The port's PTABatch on a 2-D ("pulsar", "toa") mesh
(pint_tpu_torch/parallel/sharded.py::ToaRowBatch) on the CPU, with
meshes of repeated ``cpu`` entries: against the port's unsharded batch,
against itself (repeats, mixed against f64), and against the JAX
package's 2-D batch on its eight forced host devices
(tests/test_parallel.py's 2-D fixture: 4 pulsars x 48 TOAs on a 4 x 2
mesh); then ``from_packed(mesh=)``, ``PTAFleet(mesh=)`` (sequential,
pipelined, a store hit) and ``ServeEngine(mesh=)`` on a 2-D mesh, and
the plan + mesh refusal.

Tolerances: against the unsharded port batch the JAX test's tiers (chi2
1e-9 relative, x 1e-12 absolute) and 1e-6 sigma; mixed against f64 1e-6
sigma; a second fit bitwise the first; against the JAX package's 2-D
fit 1e-6 sigma on the parameters; chi2 misses its 1e-9 tier there
(9.49e-9 WLS, 5.67e-9 GLS measured, the unsharded port batch against
the unsharded JAX batch alike: the packages' one-ulp phase gaps,
ROADMAP §3), so it is held to 5e-8 and the 2-D port chi2 to the
unsharded port's at 1e-9.
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from test_torch_mesh import _models, batches  # noqa: F401
from test_torch_pta import port_toas

TOL_SIGMA = 1e-6
TOL_CHI2 = 1e-9
TOL_CHI2_JAX = 5e-8  # the 1e-9 tier is out of reach (ROADMAP §3)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def td():
    """(pars, JAX models, JAX TOAs, port TOAs): tests/test_parallel.py's
    2-D fixture, 4 uniform 48-TOA pulsars whose F0 starts 1e-9 off."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(7)
    pars, jms, jts = [], [], []
    for i in range(4):
        par = (f"PSR TD{i}\nRAJ 1{i}:00:00.0\nDECJ {6 + i}:30:00.0\n"
               f"F0 {150 + 9 * i}.25 1\nF1 -{2 + i}e-16 1\nPEPOCH 55500\n"
               f"DM {9 + i}.5 1\n")
        m = jax_model(par)
        mjds = np.sort(rng.uniform(55000, 56000, 48))
        freqs = np.where(np.arange(48) % 2, 1400.0, 800.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = make_fake_toas_fromMJDs(mjds, m, error_us=1.0,
                                        freq_mhz=freqs, obs="gbt",
                                        add_noise=True, seed=10 + i)
        m2 = copy.deepcopy(m)
        m2.F0.value += 1e-9
        pars.append(par.replace(f"F0 {150 + 9 * i}.25 1",
                                f"F0 {m2.F0.value!r} 1"))
        jms.append(m2)
        jts.append(t)
    return pars, jms, jts, [port_toas(t) for t in jts]


def _sigma_gap(ref, got):
    sig = np.sqrt(np.diagonal(ref[2], axis1=1, axis2=2))
    return float(np.max(np.abs(np.asarray(got[0]) - ref[0]) / sig))


def _close2d(ref, got, cov_tol=1e-12):
    """x to 1e-12 relative and 1e-6 sigma, chi2 to 1e-12 relative, the
    covariance to ``cov_tol`` of sqrt(C_ii C_jj): elementwise it is
    noise on the near-zero correlations (F0-F1 ~ 1e-31). A mixed fit's
    covariance comes from its f32 Gram (``fitter.gls_eigh_refine``,
    ~1e-6 relative), summed per TOA shard here, so it takes 1e-5."""
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12, atol=0)
    assert _sigma_gap(ref, got) <= TOL_SIGMA
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)
    d = np.sqrt(np.diagonal(ref[2], axis1=1, axis2=2))
    gap = np.abs(got[2] - ref[2]) / (d[:, :, None] * d[:, None, :])
    assert float(np.max(gap)) <= cov_tol


def _bitwise(a, b):
    return all(np.array_equal(u, v) for u, v in zip(a, b))


def test_pta_batch_2d_matches_unsharded(td):
    """tests/test_parallel.py's 2-D test on the port: each TOA shard
    holds 24 rows; WLS (maxiter 3) and GLS (maxiter 1) at the JAX
    test's tiers against the unsharded batch; a second fit bitwise."""
    from pint_tpu_torch.parallel import PTABatch, make_mesh2d
    from pint_tpu_torch.parallel.sharded import ShardedBatch, ToaRowBatch

    pars, _, _, tts = td
    ref = PTABatch(_models(pars), tts, device="cpu")
    pta = PTABatch(_models(pars), tts, mesh=make_mesh2d(4, 2, devices=CPU8))
    assert isinstance(pta, ShardedBatch) and len(pta._shards) == 4
    for row in pta._shards:
        assert isinstance(row, ToaRowBatch)
        assert [tuple(b.tdb_sec.shape) for b in row._leaves()[2]] == [
            (1, 24), (1, 24)]
    want = ref.wls_fit(maxiter=3)
    got = pta.wls_fit(maxiter=3)
    np.testing.assert_allclose(got[1], want[1], rtol=TOL_CHI2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    assert _sigma_gap(want, got) <= TOL_SIGMA
    assert _bitwise(got, pta.wls_fit(maxiter=3))
    g_want, g_got = ref.gls_fit(maxiter=1), pta.gls_fit(maxiter=1)
    np.testing.assert_allclose(g_got[1], g_want[1], rtol=TOL_CHI2)
    assert _bitwise(g_got, pta.gls_fit(maxiter=1))


@pytest.mark.parametrize("ecorr_mode", ["auto", "dense"])
def test_pta_batch_2d_noise_gls(batches, ecorr_mode):  # noqa: F811
    """EFAC/ECORR/red-noise pulsars (ragged 24-30 TOAs, ECORR epoch
    pairs straddling the TOA shards, an uneven split at 30 rows over 4)
    on 3 x 4 and 1 x 2 meshes: f64 (hoisted under "auto") and mixed
    against the unsharded batch, mixed against f64, repeats bitwise."""
    from pint_tpu_torch.parallel import PTABatch, make_mesh2d

    pars, _, _, tts = batches["noise"]
    ref = PTABatch(_models(pars), tts, device="cpu")
    for shape in ((3, 4), (1, 2)):
        pta = PTABatch(_models(pars), tts,
                       mesh=make_mesh2d(*shape, devices=["cpu"] * 12))
        rows = [tuple(b.tdb_sec.shape[1] for b in row._leaves()[2])
                for row in pta._shards]
        assert sum(rows[0]) == int(ref.batch.tdb_sec.shape[1])
        f64 = pta.gls_fit(maxiter=2, ecorr_mode=ecorr_mode)
        _close2d(ref.gls_fit(maxiter=2, ecorr_mode=ecorr_mode), f64)
        mixed = pta.gls_fit(maxiter=2, ecorr_mode=ecorr_mode,
                            precision="mixed")
        assert _sigma_gap(f64, mixed) <= TOL_SIGMA
        _close2d(ref.gls_fit(maxiter=2, ecorr_mode=ecorr_mode,
                             precision="mixed"), mixed, cov_tol=1e-5)
        assert _bitwise(mixed, pta.gls_fit(maxiter=2, ecorr_mode=ecorr_mode,
                                           precision="mixed"))


def test_pta_batch_2d_programs_and_evaluations(batches):  # noqa: F811
    """aot_compile installs one eager program per row (a row's program
    spans its devices: nothing is captured) that refits alike;
    time_residuals, phases and gw_arrays gather the TOA blocks in row
    order, equal to the unsharded batch's."""
    from pint_tpu_torch.parallel import PTABatch, make_mesh2d

    pars, _, _, tts = batches["noise"]
    ref = PTABatch(_models(pars), tts, device="cpu")
    pta = PTABatch(_models(pars), tts, mesh=make_mesh2d(2, 2, devices=CPU8))
    want = pta.gls_fit(maxiter=2)
    key = pta.program_key("gls", 2)
    info = pta.aot_compile("gls", maxiter=2)
    assert not info["captured"] and pta._program_ready(key)
    assert len(pta._fns[key]) == 2
    assert _bitwise(want, pta.gls_fit(maxiter=2))
    for name in ("time_residuals", "phases"):
        (vr, mr), (vs, ms) = getattr(ref, name)(), getattr(pta, name)()
        assert np.array_equal(mr, ms)
        np.testing.assert_allclose(vs.numpy()[mr], vr.numpy()[mr],
                                   rtol=1e-15, atol=1e-18)
    gr, gs = ref.gw_arrays(want[0]), pta.gw_arrays(want[0])
    assert set(gr) == set(gs)
    for k in gr:
        np.testing.assert_allclose(gs[k], gr[k], rtol=1e-15, atol=1e-18)


def test_pta_batch_2d_matches_jax(td):
    """PTABatch on a 4 x 2 mesh in both packages on the same TOAs: WLS
    and GLS within 1e-6 sigma, chi2 at 5e-8 relative and as far from
    the JAX package's as the unsharded port batch's: the mesh adds no
    gap."""
    from pint_tpu.parallel import PTABatch as JaxBatch
    from pint_tpu.parallel import make_mesh2d as jax_mesh2d
    from pint_tpu_torch.parallel import PTABatch, make_mesh2d

    pars, jms, jts, tts = td
    jb = JaxBatch(copy.deepcopy(jms), jts, mesh=jax_mesh2d(4, 2))
    tb = PTABatch(_models(pars), tts, mesh=make_mesh2d(4, 2, devices=CPU8))
    ub = PTABatch(_models(pars), tts, device="cpu")
    for method, maxiter in (("wls", 3), ("gls", 1)):
        want = [np.asarray(a) for a in
                getattr(jb, method + "_fit")(maxiter=maxiter)]
        got = getattr(tb, method + "_fit")(maxiter=maxiter)
        assert _sigma_gap(want, got) <= TOL_SIGMA
        np.testing.assert_allclose(got[1], want[1], rtol=TOL_CHI2_JAX)
        np.testing.assert_allclose(
            got[1], getattr(ub, method + "_fit")(maxiter=maxiter)[1],
            rtol=TOL_CHI2)


def test_mesh2d_fleet_store_and_from_packed(batches, tmp_path):  # noqa: F811
    """PTAFleet(mesh=make_mesh2d) sequential and pipelined (pow2
    buckets), a store-built 2-D fleet, from_packed(mesh=) of a
    pack_state: all at the f64 tier of the unsharded fleet; the plan +
    2-D mesh refusals."""
    from pint_tpu_torch.parallel import PTABatch, PTAFleet, make_mesh2d
    from pint_tpu_torch.parallel.sharded import ToaRowBatch
    from pint_tpu_torch.store import PackStore

    pars = batches["spin"][0] + batches["noise"][0]
    tts = batches["spin"][3] + batches["noise"][3]
    mesh = make_mesh2d(2, 2, devices=["cpu"] * 4)
    kw = dict(toa_bucket="pow2", bucket_floor=16)
    want = PTAFleet(_models(pars), tts, device="cpu", **kw).fit(
        method="auto", maxiter=2)
    stacked = lambda out: tuple(np.asarray(a) for a in out)  # noqa: E731
    for pipeline in (False, True):
        fleet = PTAFleet(_models(pars), tts, mesh=mesh, pipeline=pipeline,
                         **kw)
        assert fleet.device == torch.device("cpu")
        _close2d(stacked(want), stacked(fleet.fit(method="auto",
                                                  maxiter=2)))
    store = PackStore(str(tmp_path / "store"))
    PTAFleet(_models(pars), tts, mesh=mesh, store=store, **kw)
    hit = PTAFleet(_models(pars), tts, mesh=mesh, store=store, **kw)
    rows = [s for b in hit.batches.values() for s in getattr(b, "_shards", [])]
    assert rows and all(isinstance(s, ToaRowBatch) for s in rows)
    _close2d(stacked(want), stacked(hit.fit(method="auto", maxiter=2)))
    ref = PTABatch(_models(batches["noise"][0]), batches["noise"][3],
                   device="cpu")
    again = PTABatch.from_packed(ref.template, ref.pack_state(), mesh=mesh)
    assert [type(s) for s in again._shards] == [ToaRowBatch] * 2
    _close2d(ref.gls_fit(maxiter=2), again.gls_fit(maxiter=2))
    plan = dict(toa_bucket="plan", plan_quantum=32, plan_min_width=64,
                plan_max_pack=4, plan_compile_budget=1)
    packed = PTAFleet(_models(batches["noise"][0]), batches["noise"][3],
                      device="cpu", **plan)
    pb = next(b for b in packed.batches.values() if b._pack)
    with pytest.raises(ValueError, match="device mesh"):
        PTABatch.from_packed(pb.template, pb.pack_state(), mesh=mesh)
    with pytest.raises(ValueError, match="device mesh"):
        PTAFleet(_models(batches["noise"][0]), batches["noise"][3],
                 mesh=mesh, **plan)


def test_serve_engine_on_2d_mesh():
    """ServeEngine(mesh=make_mesh2d(2, 2)): a 4-lane flush, 2 + 2 pulsars
    each over 2 TOA shards, serves the plain engine's fits at the f64
    tier, and its resid/phase requests alike."""
    from test_torch_serve import assert_fit_close, engine, pulsar

    from pint_tpu_torch import serve as s
    from pint_tpu_torch.parallel import make_mesh2d

    ps = [pulsar(20 + i, 24) for i in range(3)]

    def reqs():
        return ([s.FitRequest(p[3], p[4], maxiter=2) for p in ps]
                + [s.ResidualRequest(ps[0][3], ps[0][4]),
                   s.PhasePredictRequest(ps[1][3], ps[1][4])])

    plain = engine("torch", max_batch=4).run_stream(reqs())
    meshed = engine("torch", max_batch=4,
                    mesh=make_mesh2d(2, 2, devices=["cpu"] * 4))
    got = meshed.run_stream(reqs())
    for r, q in zip(plain[:3], got[:3]):
        assert r.status == q.status == "ok"
        assert_fit_close(q.value, r.value)
    for r, q in zip(plain[3:], got[3:]):
        assert r.status == q.status == "ok" and q.value.keys() == r.value.keys()
        for k in r.value:
            np.testing.assert_allclose(q.value[k], r.value[k], rtol=1e-15,
                                       atol=1e-18)
