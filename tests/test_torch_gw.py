"""The port's GW detection stage (pint_tpu_torch/gw/, the pair-products
kernel module kernels/paircorr.py and PTAFleet.gw_stage) against the
JAX package's, on the same inputs, on the CPU.

Inputs are made with numpy from seeds (the injected fixture of
gw/hd.py, which both packages draw with the same
``np.random.default_rng`` keys) or are test_torch_pta.py's fleets: six
noisy pulsars in a shape-planned fleet with one segment-packed bucket
and unpacked ones, fitted by the JAX package. Their TOAs are simulated
to convergence (``iterations=2``), so the post-fit residuals are white
at the 1 us TOA errors and the fleet's S/N is O(1); from one-pass TOAs
(test_torch_pta.py's) the residuals keep a ~1.6 ms systematic, |S/N|
reaches ~3e5, and the stage's 2e-10 relative gap would be 6e-5 in S/N
units.

Tolerances (ERRORBUDGET.md, GW rows) and the measured gaps:
- f32 pair products, port plain vs the Pallas kernel in interpret mode:
  rtol/atol 2e-5 (measured 0 on the 13x37 / 21x37 inputs); the mixed
  sweep against the JAX mixed sweep: 1e-5 of max|.| (measured 3e-8 for
  num, 2e-7 for den: f32 sums in different orders).
- f64 products and sweep against the JAX f64 paths: 1e-12 relative
  (measured 6e-16: torch and XLA sum the lattice axis in different
  orders); block-size invariance 1e-13 (measured 7e-15 absolute on
  entries of ~30).
- Statistics over one lattice: amp2 / snr / sigma_amp2 to 1e-12
  relative (measured 2.5e-16); scramble nulls to 1e-12 relative
  (measured 2.5e-16; not bit-identical, since the pair products are
  not), with equal p-values.
- Residuals at the same fitted vectors: 1e-12 s absolute (measured
  1.5e-13 s: one-ulp phase differences, ~1e-11 cycles at F0 ~ 170 Hz);
  sigma 1e-12 relative (measured 2.2e-16); MJDs and masks equal.
- End to end on the fleet: snr within 1e-6, amp2 within 1e-6 sigma_amp2
  (measured 2.2e-8 and 2.2e-8 at S/N 1.25), equal p-values; the port's
  packed and unpacked fleets, each fitting itself, agree to 1e-9
  relative (measured 0).
- CLI JSON: amp2 / snr to 1e-12 relative (measured 2.3e-16).
"""

import json
import os
import subprocess
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_pta import PLAN, make_toas, port_toas


def _injected(P=68, M=128, amp=0.5, seed=0):
    """(JAX lattice, port lattice) of the injected-GWB fixture."""
    from pint_tpu import gw as jgw
    from pint_tpu.gw.hd import isotropic_positions
    from pint_tpu_torch import gw

    pos = isotropic_positions(P, seed=seed)
    return (jgw.inject_gwb(pos, M, amp, seed=seed),
            gw.inject_gwb(gw.isotropic_positions(P, seed=seed), M, amp,
                          seed=seed))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


# -- (a) kernel module ---------------------------------------------------


def test_pair_products_paths_match_jax(pallas_interpret):
    from pint_tpu.kernels.paircorr import (pair_products_jnp,
                                           pair_products_pallas)
    from pint_tpu_torch.kernels.paircorr import (pair_products,
                                                 pair_products_plain,
                                                 pair_products_ref)

    rng = np.random.default_rng(11)
    ua, wa = rng.standard_normal((13, 37)), rng.uniform(0.5, 2, (13, 37))
    ub, wb = rng.standard_normal((21, 37)), rng.uniform(0.5, 2, (21, 37))
    args = [_t(a) for a in (ua, wa, ub, wb)]
    plain = pair_products_plain(*args)
    pallas = pair_products_pallas(ua, wa, ub, wb, tile=8,
                                  interpret=pallas_interpret)
    for got, ref in zip(plain, pallas):
        assert got.dtype == torch.float32 and got.shape == (13, 21)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)
    for got, ref in zip(pair_products_ref(*args),
                        pair_products_jnp(ua, wa, ub, wb)):
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), ref) <= 1e-12
    # the dispatcher: "mixed" on CPU tensors is the plain version, bit
    # for bit; "f64" is the reference
    for got, ref in zip(pair_products(*args, precision="mixed"), plain):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    for got, ref in zip(pair_products(*args), pair_products_ref(*args)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    with pytest.raises(ValueError, match="precision"):
        pair_products(*args, precision="bf16")


# -- (b) sweep -------------------------------------------------------------


def test_f64_sweep_matches_jax_1e12():
    """block=13 forces off-diagonal tiles, partial edge tiles and
    diagonal-tile triangle masking at once."""
    from pint_tpu import gw as jgw
    from pint_tpu_torch import gw

    jlat, lat = _injected()
    nj, dj, sj = jgw.correlation_matrix(jlat.z, jlat.w, block=13)
    nt, dt, st = gw.correlation_matrix(lat.z, lat.w, block=13, device="cpu")
    assert _rel(nt, nj) <= 1e-12 and _rel(dt, dj) <= 1e-12
    lower = np.tril(np.ones((68, 68), bool))
    assert not nt[lower].any() and not dt[lower].any()
    for key in ("n_psr", "n_cells", "n_pairs", "n_blocks", "flops"):
        assert st[key] == sj[key]
    assert st["n_pairs"] == 68 * 67 // 2
    # the sweep attributes its own FLOPs and bytes (obs.costmodel), on
    # the CPU row here as the JAX package's does on its CPU backend
    assert st["mfu_pct"] is not None and st["bound"] == sj["bound"]
    assert st["bytes_accessed"] > 0


def test_sweep_block_size_invariance():
    from pint_tpu_torch import gw

    _, lat = _injected(P=17, M=32)
    ref = gw.correlation_matrix(lat.z, lat.w, block=1000, device="cpu")
    for block in (3, 8, 17):
        got = gw.correlation_matrix(lat.z, lat.w, block=block, device="cpu")
        for a, b in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-13)


def test_mixed_sweep_matches_jax_interpret(pallas_interpret):
    from pint_tpu import gw as jgw
    from pint_tpu_torch import gw

    jlat, lat = _injected()
    # non-unit weights, so den is not the same constant everywhere
    w = np.random.default_rng(5).uniform(0.5, 2.0, lat.w.shape)
    ref = jgw.correlation_matrix(jlat.z, w, block=32, precision="mixed",
                                 interpret=pallas_interpret)
    got = gw.correlation_matrix(lat.z, w, block=32, precision="mixed",
                                device="cpu")
    for a, b in zip(got[:2], ref[:2]):
        assert _rel(a, b) <= 1e-5


# -- (c) statistic ---------------------------------------------------------


@pytest.mark.parametrize("orf", ["hd", "monopole", "dipole"])
def test_optimal_statistic_matches_jax(orf):
    from pint_tpu import gw as jgw
    from pint_tpu_torch import gw

    jlat, lat = _injected()
    oj = jgw.optimal_statistic(jlat, orf=orf, block=32)
    ot = gw.optimal_statistic(lat, orf=orf, block=32, device="cpu")
    for key in ("amp2", "snr", "sigma_amp2"):
        assert abs(ot[key] - oj[key]) <= 1e-12 * abs(oj[key])
    for key in ("orf", "n_pairs", "n_incoherent"):
        assert ot[key] == oj[key]
    assert abs(ot["max_pair_snr"] - oj["max_pair_snr"]) <= (
        1e-12 * oj["max_pair_snr"])
    if orf == "hd":  # the injected background is recovered, HD wins
        assert 0.25 < np.sqrt(ot["amp2"]) < 1.0 and ot["snr"] > 5.0


@pytest.mark.parametrize("mode", ["sky", "phase"])
def test_scramble_null_matches_jax(mode):
    from pint_tpu import gw as jgw
    from pint_tpu_torch import gw

    P, M, D = (68, 128, 12) if mode == "sky" else (12, 48, 5)
    jlat, lat = _injected(P=P, M=M, amp=0.3, seed=4)
    nj = jgw.scramble_null(jlat, n_draws=D, seed=9, mode=mode, block=32)
    nt = gw.scramble_null(lat, n_draws=D, seed=9, mode=mode, block=32,
                          device="cpu")
    assert nt["p_value"] == nj["p_value"]
    assert (nt["mode"], nt["n_draws"], nt["seed"]) == (mode, D, 9)
    assert abs(nt["snr_obs"] - nj["snr_obs"]) <= 1e-12 * abs(nj["snr_obs"])
    np.testing.assert_allclose(nt["snr_null"], nj["snr_null"], rtol=1e-12,
                               atol=0)


# -- (d) fixtures ----------------------------------------------------------


def test_fixtures_bitwise_equal():
    from pint_tpu import gw as jgw
    from pint_tpu_torch import gw

    from pint_tpu.gw.hd import isotropic_positions

    np.testing.assert_array_equal(gw.isotropic_positions(31, seed=2),
                                  isotropic_positions(31, seed=2))
    jlat, lat = _injected(P=31, M=40, amp=0.7, seed=2)
    for name in ("pos", "z", "w", "t_cells"):
        np.testing.assert_array_equal(getattr(lat, name),
                                      getattr(jlat, name))
    assert lat.labels == jlat.labels
    # hd_curve is carried over as is
    c = np.linspace(-1, 1, 101)
    np.testing.assert_array_equal(gw.hd_curve(c), jgw.hd_curve(c))


# -- (e) residuals ---------------------------------------------------------


@pytest.fixture(scope="module")
def fleets():
    """The JAX plan fleet, the port's plan fleet and the port's unpacked
    fleet on the same TOAs, and the JAX fleet's fitted vectors."""
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTAFleet

    pars, jms, jts = make_toas(iterations=2)
    jf = JaxFleet(jms, jts, **PLAN)
    tf = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  device="cpu", **PLAN)
    tu = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, _, _ = jf.fit(method="gls", maxiter=2)
    return SimpleNamespace(jf=jf, tf=tf, tu=tu,
                           xj=[np.asarray(x, np.float64) for x in xj])


def test_gw_arrays_match_jax(fleets):
    jf, tf, xj = fleets.jf, fleets.tf, fleets.xj
    layouts = set()
    for key, idxs in tf.group_indices.items():
        tb, jb = tf.batches[key], jf._resolve(key)
        layouts.add(tb._pack is not None)
        xb = np.stack([xj[i] for i in idxs])
        aj, at = jb.gw_arrays(xb), tb.gw_arrays(xb)
        m = np.asarray(aj["mask"])
        np.testing.assert_array_equal(at["mask"], m)
        assert np.abs(at["resid"][m] - aj["resid"][m]).max() <= 1e-12
        assert np.abs(at["sigma_us"][m] / aj["sigma_us"][m] - 1).max() <= 1e-12
        np.testing.assert_array_equal(at["mjd"][m], aj["mjd"][m])
        assert tb._pulsar_labels() == jb._pulsar_labels()
    assert layouts == {True, False}  # a packed and an unpacked bucket


def test_gw_arrays_at_start_vector_match_time_residuals(fleets):
    """Inside the port: gw_arrays at the start vectors equals the
    unpacked batch's time_residuals; packed batches refuse the latter."""
    for b in fleets.tf.batches.values():
        x0 = b._x0().numpy()
        if b._pack:
            with pytest.raises(RuntimeError, match="packed"):
                b.time_residuals()
            continue
        arrays = b.gw_arrays(x0)
        r, mask = b.time_residuals()
        np.testing.assert_array_equal(arrays["mask"], mask)
        assert np.abs(arrays["resid"][mask] - r.numpy()[mask]).max() <= 1e-15


def test_assemble_and_regrid_match_jax(fleets):
    from pint_tpu import gw as jgw
    from pint_tpu_torch import gw

    ij = jgw.assemble(fleets.jf, fleets.xj)
    it = gw.assemble(fleets.tf, fleets.xj)
    assert it.labels == ij.labels
    np.testing.assert_array_equal(it.pos, ij.pos)
    for p in range(ij.n_pulsars):
        np.testing.assert_array_equal(it.times[p], ij.times[p])
        assert np.abs(it.resid[p] - ij.resid[p]).max() <= 1e-12
        assert np.abs(it.weights[p] / ij.weights[p] - 1).max() <= 1e-12
    # regrid / regrid_append on the same inputs: bitwise
    same = gw.GWInputs(ij.labels, ij.pos, ij.times, ij.resid, ij.weights)
    lj = jgw.regrid(ij, lattice_days=60.0)
    lt = gw.regrid(same, lattice_days=60.0)
    for name in ("z", "w", "u", "t_cells", "pos"):
        np.testing.assert_array_equal(getattr(lt, name), getattr(lj, name))
    rng = np.random.default_rng(8)
    t_new = ij.times[2][-1] + np.array([10.0, 75.0, 200.0])
    r_new, w_new = rng.normal(size=3) * 1e-6, rng.uniform(1e11, 1e12, 3)
    aj = jgw.regrid_append(lj, ij.labels[2], t_new, r_new, w_new)
    at = gw.regrid_append(lt, ij.labels[2], t_new, r_new, w_new)
    assert at.n_cells > lt.n_cells
    for name in ("z", "w", "u", "t_cells"):
        np.testing.assert_array_equal(getattr(at, name), getattr(aj, name))
    with pytest.raises(ValueError, match="precede"):
        gw.regrid_append(lt, ij.labels[2], [1000.0], [0.0], [1.0])


# -- (f) end to end --------------------------------------------------------


def test_gw_stage_matches_jax(fleets):
    kw = dict(lattice_days=60.0, n_scrambles=4, seed=3)
    oj = fleets.jf.gw_stage(xs=fleets.xj, **kw)
    ot = fleets.tf.gw_stage(xs=fleets.xj, **kw)
    assert abs(ot["snr"] - oj["snr"]) <= 1e-6
    assert abs(ot["amp2"] - oj["amp2"]) <= 1e-6 * oj["sigma_amp2"]
    assert ot["n_pairs"] == oj["n_pairs"] and 0 < ot["n_pairs"] <= 15
    assert ot["sweep"]["n_pairs"] == 15
    assert (ot["n_pulsars"], ot["n_cells"]) == (oj["n_pulsars"], oj["n_cells"])
    assert ot["null"]["p_value"] == oj["null"]["p_value"]
    assert ot["null"]["n_draws"] == 4
    # a caller-held lattice skips fit/assemble/regrid; explicit
    # positions replace the models' astrometry
    from pint_tpu_torch import gw

    lat = gw.regrid(gw.assemble(fleets.tf, fleets.xj), lattice_days=60.0)
    assert fleets.tf.gw_stage(lattice=lat)["snr"] == ot["snr"]
    rolled = np.roll(lat.pos, 1, axis=0)
    moved = fleets.tf.gw_stage(xs=fleets.xj, lattice_days=60.0,
                               positions=rolled)
    ref = gw.optimal_statistic(gw.GWLattice(lat.labels, rolled, lat.z, lat.w,
                                            lat.t_cells), device="cpu")
    assert moved["snr"] == ref["snr"] != ot["snr"]


def test_gw_stage_packed_and_unpacked_agree(fleets):
    """Each port fleet fits itself (GLS, maxiter=2), then runs the stage;
    mirrors tests/test_gw.py's regular-vs-packed check."""
    ou = fleets.tu.gw_stage(maxiter=2, lattice_days=60.0, n_scrambles=4,
                            seed=3)
    op = fleets.tf.gw_stage(maxiter=2, lattice_days=60.0)
    assert not any(b._pack for b in fleets.tu.batches.values())
    assert any(b._pack for b in fleets.tf.batches.values())
    assert ou["amp2"] is not None and np.isfinite(ou["amp2"])
    assert 0.0 < ou["null"]["p_value"] <= 1.0
    np.testing.assert_allclose(op["amp2"], ou["amp2"], rtol=1e-9)
    np.testing.assert_allclose(op["snr"], ou["snr"], rtol=1e-9)


# -- (g) CLI ---------------------------------------------------------------


def test_cli_matches_jax(capsys):
    from pint_tpu.gw.__main__ import main as jax_main
    from pint_tpu_torch.gw.__main__ import main

    argv = ["--pulsars", "16", "--cells", "32", "--amplitude", "0.7",
            "--scrambles", "4"]
    assert jax_main(argv) == 0
    oj = json.loads(capsys.readouterr().out)
    assert main(argv + ["--device", "cpu"]) == 0
    ot = json.loads(capsys.readouterr().out)
    for orf in ("hd", "monopole", "dipole"):
        for key in ("amp2", "snr"):
            assert abs(ot[orf][key] - oj[orf][key]) <= 1e-12 * abs(oj[orf][key])
    assert ot["null"]["p_value"] == oj["null"]["p_value"]
    assert ot["null"]["n_draws"] == 4


# -- (h) guards ------------------------------------------------------------


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from pint_tpu_torch import gw
    from pint_tpu_torch.gw.__main__ import main
    from pint_tpu_torch.parallel.pta import PTAFleet

    _, lat = _injected(P=5, M=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gw.correlation_sweep(lat.z, lat.w, lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gw.optimal_statistic(lat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--pulsars", "5", "--cells", "8"])
    # gw_stage runs on its fleet's device, which defaults to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTAFleet([], [])


def test_kernel_wrapper_refuses_cpu_tensors():
    from pint_tpu_torch.kernels.paircorr import pair_products_cuda

    before = pair_products_cuda.launches
    x = torch.zeros((4, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pair_products_cuda(x, x, x, x)
    assert pair_products_cuda.launches == before


def test_gw_modules_import_no_jax():
    code = ("import sys, pint_tpu_torch.gw, pint_tpu_torch.gw.__main__, "
            "pint_tpu_torch.kernels.paircorr, pint_tpu_torch.parallel.pta\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pint_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr
