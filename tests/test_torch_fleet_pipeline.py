"""The port's fleet executor (pint_tpu_torch/parallel/pta.py:
``PTAFleet(pipeline=True)``, ``fit(pipeline=True)``, ``precompile``,
``fleet_pipeline_metrics``, ``from_batches``, ``free_maps``, the
program table and the AOT helpers of pint_tpu_torch/fitter.py) on the
CPU — tests/test_fleet_pipeline.py's executor tests on the port — and
against the JAX package's pipelined fit on the same TOAs.

On the CPU nothing is captured: ``aot_backend_compile`` installs the
eager program, and pipelined results must equal the sequential ones
bitwise (``np.array_equal``). The ``cuda``-marked tests at the end
capture the programs into CUDA graphs and replay them on the card; they
skip here.

Tolerance of the JAX parity test: the batched-fit tier of
ERRORBUDGET.md, parameters to 1e-6 sigma and chi2 to 1e-9 relative
(test_torch_pta.py measures ~1e-7 sigma: one-ulp phase differences).
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from test_torch_pta import PLAN, make_toas, port_toas


def _spin_par(i):
    return (f"PSR FP{i}\nRAJ 1{i % 10}:00:00.0\nDECJ {5 + i}:30:00.0\n"
            f"F0 {200 + 10 * i}.5 1\nF1 -{3 + i}e-16 1\nPEPOCH 55500\n"
            f"DM {10 + i}.5 1\n")


def _noise_par(i):
    return (f"PSR NP{i}\nRAJ 0{(2 * i) % 10}:30:00.0\n"
            f"DECJ {8 + i}:00:00.0\n"
            f"F0 {310 + 4 * i}.25 1\nF1 -{2 + i}e-16 1\nPEPOCH 55500\n"
            f"DM {12 + i}.3 1\n"
            "EFAC -f L-wide 1.2\nEQUAD -f L-wide 0.5\n"
            "ECORR -f L-wide 0.9\n")


def _spin_pulsars(n_psr=2, base_toas=24):
    """Spin-only pulsars (the WLS route under method="auto"), ragged."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(0)
    models, toas_list = [], []
    for i in range(n_psr):
        m = get_model(_spin_par(i))
        mjds = np.sort(rng.uniform(55000, 56000, base_toas + 4 * i))
        toas_list.append(make_fake_toas_fromMJDs(
            mjds, m, error_us=1.0, freq_mhz=1400.0, obs="gbt",
            add_noise=True, seed=i, device="cpu"))
        models.append(m)
    return models, toas_list


def _noise_pulsars(n_psr=2, n_epochs=10, per_epoch=3):
    """EFAC/EQUAD/ECORR pulsars (the GLS route under method="auto")."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    models, toas_list = [], []
    for i in range(n_psr):
        m = get_model(_noise_par(i))
        days = np.linspace(55000, 56000, n_epochs + 2 * i)
        mjds = np.concatenate(
            [d + np.arange(per_epoch) * 0.5 / 86400.0 for d in days])
        toas_list.append(make_fake_toas_fromMJDs(
            mjds, m, error_us=1.0, freq_mhz=np.full(len(mjds), 1400.0),
            obs="gbt", add_noise=True, seed=100 + i,
            flags={"f": "L-wide"}, device="cpu"))
        models.append(m)
    return models, toas_list


@pytest.fixture(scope="module")
def pulsars():
    """(spin models, spin TOAs, noise models, noise TOAs)."""
    return (*_spin_pulsars(2), *_noise_pulsars(2))


def _mixed_fleet(pulsars, **fleet_kw):
    """WLS-structure + GLS-structure pulsars in one fleet (2 buckets),
    each fleet with its own model copies."""
    from pint_tpu_torch.parallel import PTAFleet

    ms, ts, mn, tn = pulsars
    return PTAFleet(copy.deepcopy(ms + mn), ts + tn, device="cpu",
                    **fleet_kw)


def _fit_arrays(fleet, **kw):
    x, chi2, cov = fleet.fit(**kw)
    return (np.asarray(x), np.asarray(chi2), np.asarray(cov),
            sorted(int(i) for i in fleet.diverged))


def _assert_bitwise(a, b):
    xa, ca, cova, da = a
    xb, cb, covb, db = b
    assert np.array_equal(xa, xb)
    assert np.array_equal(ca, cb, equal_nan=True)
    assert np.array_equal(cova, covb, equal_nan=True)
    assert da == db


# -- bitwise equivalence ----------------------------------------------


def test_pipelined_fit_bitwise_matches_sequential(pulsars):
    """The pipelined executor is a scheduling change only: bitwise
    equal x/chi2/cov on a mixed WLS+GLS fleet with deferred builds."""
    fleet = _mixed_fleet(pulsars, pipeline=True)
    seq = _fit_arrays(fleet, method="auto", maxiter=3, pipeline=False)
    pipe = _fit_arrays(fleet, method="auto", maxiter=3, pipeline=True)
    _assert_bitwise(seq, pipe)
    assert seq[3] == []
    assert sorted(fleet.fit_metrics) == sorted(fleet.group_indices)
    assert {m["method"] for m in fleet.fit_metrics.values()} == {"wls", "gls"}


def test_pipelined_fit_bitwise_under_injected_divergence(pulsars):
    """solver_diverge fires on a deterministic schedule; the pipelined
    path finalizes in the sequential path's bucket order, so the same
    lane diverges and the isolated results stay bitwise equal (the NaN
    chi2 included)."""
    from pint_tpu_torch.resilience import FaultPoint, inject

    fleet = _mixed_fleet(pulsars)

    def run(pipeline):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject(FaultPoint("solver_diverge", count=1,
                                   payload={"lanes": [1]})):
                return _fit_arrays(fleet, method="auto", maxiter=3,
                                   pipeline=pipeline)

    seq, pipe = run(False), run(True)
    assert len(seq[3]) == 1
    assert np.isnan(seq[1][seq[3][0]])
    _assert_bitwise(seq, pipe)


def test_pipelined_straggler_stays_bitwise(pulsars):
    """The straggler site delays one bucket's dispatch; the finalize
    order is unchanged, so results stay bitwise."""
    from pint_tpu_torch.resilience import FaultPoint, inject

    fleet = _mixed_fleet(pulsars, pipeline=True)
    seq = _fit_arrays(fleet, method="auto", maxiter=2, pipeline=False)
    fp = FaultPoint("straggler_delay", rate=1.0, count=1,
                    payload={"delay_s": 0.0})
    with inject(fp):
        pipe = _fit_arrays(fleet, method="auto", maxiter=2, pipeline=True)
    assert fp.fires == 1
    _assert_bitwise(seq, pipe)
    assert pipe[3] == []


def test_pipelined_rejects_bad_kwargs_like_sequential(pulsars):
    """kwargs are validated before any dispatch: a WLS bucket given a
    GLS-only kwarg raises the same TypeError on both paths."""
    from pint_tpu_torch.parallel import PTAFleet

    ms, ts, _, _ = pulsars
    fleet = PTAFleet(copy.deepcopy(ms), ts, device="cpu")
    for pipeline in (True, False):
        with pytest.raises(TypeError, match="unexpected keyword"):
            fleet.fit(method="wls", maxiter=3, pipeline=pipeline,
                      ecorr_mode="auto")
    assert all(not b._fns for b in fleet.batches.values())


# -- the program table ------------------------------------------------


def test_precompile_installs_the_lazy_paths_programs(pulsars):
    """precompile installs exactly the program keys a lazy fit
    installs, and a pipelined fit after it equals a fresh sequential
    fit bitwise."""
    fleet = _mixed_fleet(pulsars)
    infos, wall_s = fleet.precompile(method="auto", maxiter=3)
    assert len(infos) == len(fleet.group_indices) and wall_s > 0
    for info in infos:
        assert info["trace_s"] >= 0 and info["backend_compile_s"] == 0.0
        # the program's recorded count (obs.costmodel), none captured
        assert info["captured"] is False and info["flops"] > 0
    for key in fleet.group_indices:
        batch = fleet.batches[key]
        method = "gls" if fleet._use_gls(batch, "auto") else "wls"
        assert batch.program_key(method=method, maxiter=3) in batch._fns
    assert fleet.precompile(method="auto", maxiter=3)[0] == []
    lazy = _mixed_fleet(pulsars)
    ref = _fit_arrays(lazy, method="auto", maxiter=3, pipeline=False)
    for key in fleet.group_indices:
        assert sorted(map(repr, fleet.batches[key]._fns)) == \
            sorted(map(repr, lazy.batches[key]._fns))
    _assert_bitwise(_fit_arrays(fleet, method="auto", maxiter=3,
                                pipeline=True), ref)


def test_precompile_auto_installs_both_modes(pulsars):
    """precision="auto" prepares both GLS modes of a GLS bucket."""
    from pint_tpu_torch.parallel import PTAFleet

    _, _, mn, tn = pulsars
    fleet = PTAFleet(copy.deepcopy(mn), tn, device="cpu")
    infos, _ = fleet.precompile(method="gls", maxiter=2, precision="auto")
    (batch,) = fleet.batches.values()
    assert len(infos) == 2
    assert {batch.program_key("gls", 2, precision=p)
            for p in ("f64", "mixed")} == set(batch._fns)


def test_program_keys_match_jax():
    """program_key keys a bucket's programs as the JAX package keys its
    executables, on a packed and an unpacked bucket."""
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTAFleet

    pars, jms, jts = make_toas()
    jf = JaxFleet(jms, jts, **PLAN)
    tf = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  device="cpu", **PLAN)
    assert any(b._pack for b in tf.batches.values())
    for key in tf.group_indices:
        jb, tb = jf.batches[key], tf.batches[key]
        for opts in ({"method": "gls"},
                     {"method": "gls", "maxiter": 3, "precision": "mixed"},
                     {"method": "gls", "ecorr_mode": "dense"}):
            assert tb.program_key(**opts) == jb.program_key(**opts)
    assert tf.free_maps() == [list(fm) for fm in jf.free_maps()]


def test_aot_helpers_on_cpu():
    """The AOT helpers: aot_lower times a build, aot_backend_compile
    captures nothing on the CPU, aot_serialize has no payload and
    aot_deserialize refuses."""
    from pint_tpu_torch import fitter, graphs

    low = fitter.aot_lower(lambda k: (lambda x: x * k), 3.0)
    assert low["trace_s"] >= 0
    info = fitter.aot_backend_compile(low["lowered"],
                                      torch.ones(2, dtype=torch.float64))
    assert isinstance(info["compiled"], graphs.Program)
    assert info["captured"] is False and info["backend_compile_s"] == 0.0
    assert info["pieces"] == []
    assert all(info[k] is None for k in ("flops", "bytes_accessed",
                                         "memory", "bound"))
    assert torch.equal(info["compiled"](torch.ones(2, dtype=torch.float64)),
                       torch.full((2,), 3.0, dtype=torch.float64))
    assert fitter.aot_serialize(info["compiled"]) is None
    with pytest.raises(RuntimeError, match="no serialized form"):
        fitter.aot_deserialize({"payload": b""})
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphProgram(lambda x: x, torch.ones(2))


def test_fleet_pipeline_metrics_keys_finite(pulsars):
    """The metrics contract: every key present and finite, bitwise
    True."""
    from pint_tpu_torch.parallel import PTAFleet, fleet_pipeline_metrics

    ms, ts = _spin_pulsars(3, base_toas=30)  # buckets 32 and 64
    fleet = PTAFleet(ms, ts, toa_bucket="pow2", bucket_floor=16,
                     device="cpu")
    rep = fleet_pipeline_metrics(fleet, method="wls", maxiter=3, repeats=1)
    for key in ("fleet_compile_serial_s", "fleet_compile_concurrent_s",
                "fleet_fit_sequential_s", "fleet_fit_pipelined_s",
                "fleet_pipeline_overlap_pct"):
        assert rep[key] is not None and np.isfinite(rep[key]), (key, rep)
    assert rep["fleet_pipeline_bitwise"] is True
    assert rep["fleet_buckets"] == 2


# -- fleet construction -----------------------------------------------


def test_deferred_builds_match_inline(pulsars):
    """PTAFleet(pipeline=True) builds its buckets in a worker pool; its
    fits equal an inline-built fleet's bitwise, and every bucket lands
    in ``batches`` once resolved."""
    deferred = _mixed_fleet(pulsars, pipeline=True)
    inline = _mixed_fleet(pulsars)
    assert deferred.pipeline and not inline.pipeline
    assert (set(deferred.batches) | set(deferred._batch_futures)
            == set(deferred.group_indices))
    _assert_bitwise(_fit_arrays(deferred, method="auto", maxiter=2),
                    _fit_arrays(inline, method="auto", maxiter=2))
    assert set(deferred.batches) == set(deferred.group_indices)
    assert not deferred._batch_futures and deferred._prep_pool is None
    assert deferred.padding_ratio == inline.padding_ratio


def test_from_batches_fits_like_the_fleet(pulsars):
    """A fleet wrapped around already-built batches fits each pulsar as
    the fleet that built them does (pulsar order: the batches' rows)."""
    from pint_tpu_torch.parallel import PTAFleet

    fleet = _mixed_fleet(pulsars)
    x, chi2, cov, _ = _fit_arrays(fleet, method="auto", maxiter=2)
    wrapped = PTAFleet.from_batches(list(fleet.batches.values()))
    order = [i for idxs in fleet.group_indices.values() for i in idxs]
    assert wrapped.n == fleet.n == len(order)
    for pipeline in (False, True):
        xw, cw, covw, _ = _fit_arrays(wrapped, method="auto", maxiter=2,
                                      pipeline=pipeline)
        assert np.array_equal(xw, x[order])
        assert np.array_equal(cw, chi2[order])
        assert np.array_equal(covw, cov[order])
    assert wrapped.free_maps() == [fleet.free_maps()[i] for i in order]


def test_free_maps_match_jax(pulsars):
    """free_maps lists each pulsar's free-parameter map in original
    order, as the JAX package's does (the same par files and epochs)."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    _, ts, _, tn = pulsars
    fleet = _mixed_fleet(pulsars, pipeline=True)
    jms = ([jax_model(_spin_par(i)) for i in range(2)]
           + [jax_model(_noise_par(i)) for i in range(2)])
    jts = []
    for m, t in zip(jms, ts + tn):
        jt = make_fake_toas_fromMJDs(t.day + t.sec / 86400.0, m,
                                     obs="gbt", iterations=0)
        for f in jt.flags:
            f["f"] = "L-wide"
        jts.append(jt)
    jf = JaxFleet(jms, jts)
    assert fleet.free_maps() == [list(fm) for fm in jf.free_maps()]


def test_start_vector_after_precompile_takes_effect(pulsars):
    """set_start_vector after precompile changes the next fit: it equals
    a never-precompiled fleet's fit from the same start."""
    fleet = _mixed_fleet(pulsars)
    fleet.precompile(method="auto", maxiter=1)
    before = _fit_arrays(fleet, method="auto", maxiter=1, pipeline=True)
    ref = _mixed_fleet(pulsars)
    for f in (fleet, ref):
        for key, idxs in f.group_indices.items():
            b = f.batches[key]
            x0 = np.array([[getattr(f.batches[key].models[j], n).value
                            for n, _, _ in b.free_map()]
                           for j in range(len(idxs))])
            x0[:, 0] += 1e-9  # F0 off its fit
            b.set_start_vector(x0)
    after = _fit_arrays(fleet, method="auto", maxiter=1, pipeline=True)
    assert not np.array_equal(after[0], before[0])
    _assert_bitwise(after, _fit_arrays(ref, method="auto", maxiter=1,
                                       pipeline=False))


# -- against the JAX package's executor --------------------------------


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_pipelined_fit_matches_jax(precision):
    """The port's pipelined fit against the JAX package's pipelined fit
    on the same numpy-seeded shape-planned fleet (a packed bucket and an
    unpacked one): the batched-fit tier, 1e-6 sigma on parameters and
    1e-9 relative on chi2."""
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTAFleet

    pars, jms, jts = make_toas()
    jf = JaxFleet(jms, jts, pipeline=True, **PLAN)
    tf = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  pipeline=True, device="cpu", **PLAN)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, cj, covj = jf.fit(method="gls", maxiter=2, precision=precision)
    xt, ct, covt = tf.fit(method="gls", maxiter=2, precision=precision)
    sig = np.sqrt(np.array([np.diag(c) for c in covj]))
    assert np.max(np.abs(np.array(xt) - np.array(xj)) / sig) <= 1e-6
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=0)
    assert not any(m["refit_f64"] for m in tf.fit_metrics.values())
    assert all(tf.batches[k]._fns for k in tf.group_indices)


def test_ecorr_without_red_noise_matches_jax():
    """An unpacked bucket with ECORR but no red noise (the marginalized,
    hoisted program with an empty noise basis) fits as the JAX
    package's does; the port's epoch sums failed to reshape the empty
    basis before the executor's tests reached it. One-pass TOAs, as in
    test_torch_pta.py, so chi2 is held to the 1e-9 tier (on converged
    TOAs the packages' one-ulp phase gap moves a chi2 of ~n by ~2e-8,
    ROADMAP §3)."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTAFleet

    jms, jts = [], []
    for i in range(3):
        jms.append(jax_model(_noise_par(i)))
        days = np.linspace(55000, 56000, 10 + 2 * i)
        mjds = np.concatenate([d + np.arange(3) * 0.5 / 86400.0
                               for d in days])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jt = make_fake_toas_fromMJDs(mjds, jms[-1], error_us=1.0,
                                         freq_mhz=1400.0, obs="gbt",
                                         add_noise=True, seed=100 + i,
                                         iterations=0)
        for f in jt.flags:
            f["f"] = "L-wide"
        jts.append(jt)
    jf = JaxFleet(jms, jts)
    tf = PTAFleet([get_model(_noise_par(i)) for i in range(3)],
                  [port_toas(t) for t in jts], device="cpu")
    (batch,) = tf.batches.values()
    assert batch.program_key("gls")[3:] == (True, "f64", True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, cj, covj = jf.fit(method="gls", maxiter=2)
    xt, ct, _ = tf.fit(method="gls", maxiter=2)
    sig = np.sqrt(np.array([np.diag(c) for c in covj]))
    assert np.max(np.abs(np.array(xt) - np.array(xj)) / sig) <= 1e-6
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=0)


def test_faultinject_has_straggler_delay():
    from pint_tpu_torch.resilience import faultinject as fi

    assert "straggler_delay" in fi.POINTS
    with fi.inject(fi.FaultPoint("straggler_delay",
                                 payload={"delay_s": 0.5, "lane": 1})):
        out = fi.fire("straggler_delay", bucket=1)
    assert out == {"delay_s": 0.5, "lane": 1, "bucket": 1,
                   "point": "straggler_delay", "fire": 1}


# -- on the card ------------------------------------------------------


def _card_fleet(device="cuda"):
    """A noise fleet on the card (or ``device``) with a packed bucket
    (K1/K2 in mixed), from the port's own fake-TOA maker (the card's
    machine need not have JAX)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTAFleet
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from test_torch_pta import COUNTS, par

    rng = np.random.default_rng(3)
    models, pts = [], []
    for i, n in enumerate(COUNTS):
        models.append(get_model(par(i)))
        days = np.sort(rng.uniform(54000, 57000, n // 4))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        pts.append(make_fake_toas_fromMJDs(
            mjds, models[-1], error_us=1.0,
            freq_mhz=np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0),
            add_noise=True, seed=i, flags={"f": "L-wide"}, device="cpu"))
    return PTAFleet(models, pts, device=device, **PLAN)


@pytest.mark.cuda
def test_capture_replays_like_eager_and_counts_launches():
    """On the card: a captured packed mixed program replays to within
    1e-6 sigma of the eager fit (its eighs run eagerly between the
    graphs), K1 and K2 count their launches on every replay as they do
    eagerly, and a new start vector reaches the captured input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.kernels import block_grams_cuda, fused_block_gls_cuda

    fleet = _card_fleet()
    key = next(k for k, b in fleet.batches.items() if b._pack)
    b = fleet.batches[key]
    fused_block_gls_cuda.launches = block_grams_cuda.launches = 0
    xe, ce, cove = b.gls_fit(maxiter=2, precision="mixed")
    eager = (fused_block_gls_cuda.launches, block_grams_cuda.launches)
    assert min(eager) > 0
    info = b.aot_compile("gls", 2, precision="mixed")
    assert info["captured"] and info["backend_compile_s"] > 0
    assert info["pieces"] == ["graph", "linalg_eigh", "graph", "linalg_eigh",
                              "graph"]
    prog = b._fns[b.program_key("gls", 2, precision="mixed")]
    assert prog.launches == {"fused_block_gls_cuda": eager[0],
                             "block_grams_cuda": eager[1]}
    fused_block_gls_cuda.launches = block_grams_cuda.launches = 0
    xr, cr, covr = b.gls_fit(maxiter=2, precision="mixed")
    assert (fused_block_gls_cuda.launches, block_grams_cuda.launches) == eager
    assert b.metrics["replayed"]
    sig = np.sqrt(np.array([np.diag(c) for c in cove]))
    assert np.max(np.abs(xr - xe) / sig) <= 1e-6
    xr2, _, _ = b.gls_fit(maxiter=2, precision="mixed")
    assert np.array_equal(xr, xr2)
    x0 = np.array(xe)
    x0[:, 0] += 1e-9
    b.set_start_vector(x0)
    xs, _, _ = b.gls_fit(maxiter=2, precision="mixed")
    assert not np.array_equal(xs, xr)


@pytest.mark.cuda
def test_pipelined_bitwise_on_card():
    """On the card: after precompile, the pipelined fit equals the
    sequential replay bitwise (fleet_pipeline_metrics' flag)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.parallel import fleet_pipeline_metrics

    fleet = _card_fleet()
    rep = fleet_pipeline_metrics(fleet, method="gls", maxiter=2,
                                 repeats=1, precision="mixed")
    assert rep["fleet_pipeline_bitwise"] is True
    assert rep["fleet_compile_serial_s"] > 0
    assert all(p.captured for b in fleet.batches.values()
               for p in b._fns.values())


# -- a program holds nothing of the batch that built it ------------------


def _reachable(root):
    """Objects reachable from a function through closures, defaults,
    bound methods, partials and containers (not through other objects'
    attributes)."""
    import functools
    import types

    seen, out, stack = set(), [], [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        out.append(obj)
        if isinstance(obj, types.FunctionType):
            for cell in obj.__closure__ or ():
                try:
                    stack.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    pass
            stack.extend(obj.__defaults__ or ())
            stack.extend((obj.__kwdefaults__ or {}).values())
        elif isinstance(obj, types.MethodType):
            stack.extend((obj.__self__, obj.__func__))
        elif isinstance(obj, functools.partial):
            stack.extend((obj.func, *obj.args, *obj.keywords.values()))
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple, set, frozenset)):
            stack.extend(obj)
        elif isinstance(obj, types.SimpleNamespace):
            stack.extend(vars(obj).values())
    return out


@pytest.fixture(scope="module")
def plan_fleet(pulsars):
    """The packed noise fleet of the card tests, on the CPU, and the
    spin + noise pulsars' unpacked buckets: (packed fleet, fleet)."""
    return _card_fleet("cpu"), _mixed_fleet(pulsars)


@pytest.mark.parametrize("build", [
    ("wls", {}), ("gls", {}), ("gls", {"precision": "mixed"}),
    ("gls", {"ecorr_mode": "dense"}), ("packed", {}),
    ("packed", {"fused": False}), ("resid", {}), ("phase", {})])
def test_programs_hold_nothing_of_their_batch(plan_fleet, build):
    """A program in a batch's table reaches neither the batch nor any of
    its device tensors, so a cached table (the serve engine's) keeps
    only the programs' own data alive, and runs on the data it is
    given."""
    from pint_tpu_torch.parallel import PTABatch

    kind, opts = build
    packed = [b for f in plan_fleet for b in f.batches.values() if b._pack]
    plain = [b for b in plan_fleet[1].batches.values()]
    assert packed and not [b for b in plain if b._pack]
    if kind == "packed":
        b = packed[0]
        fit = b._build_gls(2, **opts)[1]
    elif kind in ("resid", "phase"):
        b = plain[0]
        (b.time_residuals if kind == "resid" else b.phases)()
        fit = b._fns[(kind,)].fn
    else:
        b = next(b for b in plain
                 if ("EcorrNoise" in b.template.components) == (kind == "gls"))
        fit = (b._build_wls(3) if kind == "wls"
               else b._build_gls(2, **opts))[1]
    leaves = {id(t) for t in
              [*b.params.values(), *b.prep.values(), *b.batch]
              if isinstance(t, torch.Tensor)}
    found = _reachable(fit)
    assert not [o for o in found if isinstance(o, PTABatch)]
    assert not [o for o in found if id(o) in leaves]


# -- captured programs on other batches and other threads (the card) -----


def _card_batches():
    """Three unpacked noise batches on the card: A and B of one
    signature with disjoint pulsars, C of a wider one (another program
    on the same graph memory pool)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from test_torch_pta import par

    rng = np.random.default_rng(5)
    out = []
    for first, days in ((0, 24), (2, 24), (4, 48)):
        models, pts = [], []
        for i in (first, first + 1):
            models.append(get_model(par(i)))
            d = np.sort(rng.uniform(54000, 57000, days - 2 * (i % 2)))
            mjds = (d[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
            pts.append(make_fake_toas_fromMJDs(
                mjds, models[-1], error_us=1.0,
                freq_mhz=np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0),
                add_noise=True, seed=20 + i, flags={"f": "L-wide"},
                device="cpu"))
        out.append(PTABatch(models, pts, pad_toas=4 * days, device="cuda"))
    return out


def _replay(prog, b):
    """(x, chi2) of ``prog`` run on batch ``b``'s start vectors and
    data, and the data bytes the call copied in."""
    before = prog.copied_bytes
    x, chi2, _ = prog(b._x0(), *b._leaves())
    return (x, chi2), prog.copied_bytes - before


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_captured_program_copies_or_skips_its_inputs():
    """On the card: a program captured on batch A and called with B's
    tensors copies all of them in and fits B (bitwise B's own captured
    program; B's eager fit to 1e-6 sigma and chi2 to 1e-9 relative, the
    batched-fit tier of the module docstring); called with A's again
    it copies them back; a leaf of A written in place is copied alone
    and the fit sees it; an unchanged call copies nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.graphs import _data_leaves

    bA, bB, _ = _card_batches()
    assert bA.shape_signature() == bB.shape_signature()
    def near(fit, ref):
        sig = np.sqrt(np.array([np.diag(c) for c in ref[2]]))
        assert np.max(np.abs(np.asarray(fit[0]) - ref[0]) / sig) <= 1e-6
        np.testing.assert_allclose(fit[1], ref[1], rtol=1e-9)

    eager = {}
    for name, b in (("A", bA), ("B", bB)):
        eager[name] = tuple(np.asarray(v) for v in b.gls_fit(maxiter=2))
        b.aot_compile("gls", 2)
    key = bA.program_key("gls", 2)
    P, Q = bA._fns[key], bB._fns[key]
    assert P.captured and Q.captured
    own_A, copied = _replay(P, bA)
    assert copied == 0  # the tensors P was captured on
    own_B, _ = _replay(Q, bB)
    nbytes = sum(t.numel() * t.element_size()
                 for t in _data_leaves(bB._leaves()))

    on_B, copied = _replay(P, bB)
    assert copied == nbytes
    assert _same(on_B, own_B) and not _same(on_B, own_A)
    bB._fns = bA._fns  # a cached table adopted by another batch
    near(bB.gls_fit(maxiter=2), eager["B"])

    again, copied = _replay(P, bA)
    assert copied == nbytes and _same(again, own_A)

    err = bA.batch.error_us
    err[1] *= 2.0  # in place: the pulsar's weights drop by 4
    written, copied = _replay(P, bA)
    assert copied == err.numel() * err.element_size()
    assert float(written[1][1]) != float(own_A[1][1])
    bA._fns = {}
    near([t.cpu().numpy() for t in written],
         tuple(np.asarray(v) for v in bA.gls_fit(maxiter=2)))  # eager

    unchanged, copied = _replay(P, bA)
    assert copied == 0 and _same(unchanged, written)


@pytest.mark.cuda
def test_replays_from_threads_fit_their_own_batches():
    """On the card: threads on their own streams replay one program on
    two batches, and a second program on the same graph memory pool on
    a third, at the same time; every result is bitwise that batch's
    replay alone (graphs.py runs the calls one at a time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from pint_tpu_torch import graphs

    bA, bB, bC = _card_batches()
    for b in (bA, bC):
        b.aot_compile("gls", 2)
    P = bA._fns[bA.program_key("gls", 2)]
    R = bC._fns[bC.program_key("gls", 2)]
    assert R.pool is P.pool == graphs.pool(P.device)
    jobs = [(P, bA), (P, bB), (R, bC)]
    alone = [tuple(t.cpu() for t in _replay(p, b)[0]) for p, b in jobs]
    assert not _same(alone[0], alone[1])
    bad, errors = [], []
    start = threading.Barrier(len(jobs))

    def work(j):
        prog, b = jobs[j]
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                start.wait()
                for it in range(12):
                    got = tuple(t.cpu() for t in _replay(prog, b)[0])
                    if not _same(got, alone[j]):
                        bad.append((j, it))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(j,))
               for j in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and not bad
