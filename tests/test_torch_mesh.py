"""The port's device mesh (pint_tpu_torch/parallel/mesh.py) and the
pulsar-sharded batch (``PTABatch(mesh=)``, ``PTABatch.from_packed(mesh=)``,
``PTAFleet(mesh=)``) on the CPU, with meshes of repeated ``cpu``
entries, against the unsharded port batch and the JAX package's
``PTABatch(mesh=)`` on its eight forced host devices.

Tolerances: a sharded batch runs smaller batches than the unsharded
one, so it is held to the f64 tier (1e-12 relative) and 1e-6 sigma, not
bitwise; against the JAX package the batched-fit tier of ERRORBUDGET.md,
parameters to 1e-6 sigma. chi2 misses its 1e-9 tier on these TOAs
(1.51e-8 measured, and the unsharded port batch alike: ROADMAP §3), so
it is held to 5e-8.
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from test_torch_pta import port_toas

TOL_REL = 1e-12
TOL_SIGMA = 1e-6
TOL_CHI2 = 5e-8  # the 1e-9 tier is out of reach here (ROADMAP §3)


def _par(i, noise):
    base = (f"PSR MS{i}{'N' if noise else ''}\nRAJ 1{i}:00:00.0\n"
            f"DECJ {6 + i}:30:00.0\nF0 {150 + 9 * i}.25 1\n"
            f"F1 -{2 + i}e-16 1\nPEPOCH 55500\nDM {9 + i}.5 1\n")
    if noise:
        base += ("EFAC -f L-wide 1.1\nECORR -f L-wide 0.7\n"
                 "RNAMP 1e-14\nRNIDX -3.0\nTNREDC 4\n")
    return base


@pytest.fixture(scope="module")
def batches():
    """{kind: (pars, JAX models, JAX TOAs, port TOAs)} for 3 spin-only
    and 3 full-noise (EFAC, ECORR, red noise) pulsars, ragged."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(7)
    out = {}
    for kind, noise in (("spin", False), ("noise", True)):
        pars, jms, jts = [], [], []
        for i in range(3):
            p = _par(i, noise)
            jm = jax_model(p)
            days = np.sort(rng.uniform(55000, 56000, 12 + 3 * i))
            mjds = np.sort(np.concatenate([days, days + 30.0 / 86400.0]))
            freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                jt = make_fake_toas_fromMJDs(
                    mjds, jm, error_us=1.0, freq_mhz=freqs, obs="gbt",
                    add_noise=True, seed=20 + i, flags={"f": "L-wide"})
            pars.append(p)
            jms.append(jm)
            jts.append(jt)
        out[kind] = (pars, jms, jts, [port_toas(t) for t in jts])
    return out


def _models(pars):
    from pint_tpu_torch.models import get_model

    return [get_model(p) for p in pars]


def _close(ref, got, rel=TOL_REL):
    (rx, rc, rcov), (gx, gc, gcov) = ref, got
    sig = np.sqrt(np.diagonal(rcov, axis1=1, axis2=2))
    assert np.max(np.abs(gx - rx) / sig) <= TOL_SIGMA
    np.testing.assert_allclose(gx, rx, rtol=rel, atol=0)
    np.testing.assert_allclose(gc, rc, rtol=rel)
    np.testing.assert_allclose(gcov, rcov, rtol=1e-10, atol=0)


def test_mesh_helpers():
    """make_mesh / lane_meshes / make_mesh2d / shard_batch / replicate /
    ordered_sum on repeated CPU entries."""
    from pint_tpu_torch.parallel import (lane_meshes, make_mesh,
                                         make_mesh2d, shard_batch)
    from pint_tpu_torch.parallel.mesh import (ordered_max, ordered_sum,
                                              pulsar_slices, replicate)

    m = make_mesh(devices=["cpu"] * 4)
    assert m.shape == {"pulsar": 4} and m.size == 4
    assert make_mesh(2, devices=["cpu"] * 4).shape == {"pulsar": 2}
    assert [lm.shape for lm in lane_meshes(["cpu"] * 3)] == \
        [{"pulsar": 1}] * 3
    m2 = make_mesh2d(2, 2, devices=["cpu"] * 4)
    assert m2.shape == {"pulsar": 2, "toa": 2} and m2.axis_size("toa") == 2
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh2d(3, 2, devices=["cpu"] * 4)
    assert pulsar_slices(5, 2) == [slice(0, 3), slice(3, 5)]
    assert pulsar_slices(2, 4) == [slice(0, 1), slice(1, 2)]
    tree = {"a": np.arange(12.0).reshape(4, 3), "b": 2.0,
            "c": torch.arange(4.0)}
    parts = shard_batch(tree, m2, n_toa=3)
    assert [ps for ps, _ in parts] == [slice(0, 2), slice(2, 4)]
    assert torch.equal(parts[1][1][0]["a"],
                       torch.tensor([[6.0, 7.0, 8.0], [9.0, 10.0, 11.0]]))
    four = shard_batch({"t": np.arange(8.0).reshape(2, 4)}, m2, n_toa=4)
    assert torch.equal(four[0][1][1]["t"], torch.tensor([[2.0, 3.0]]))
    assert len(replicate(tree, m)) == 4
    parts = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])]
    assert torch.equal(ordered_sum(parts), torch.tensor([4.0, 7.0]))
    assert torch.equal(ordered_max(parts), torch.tensor([3.0, 5.0]))


@pytest.mark.parametrize("kind,method,precision", [
    ("spin", "wls", "f64"), ("noise", "gls", "f64"),
    ("noise", "gls", "mixed")])
def test_sharded_batch_matches_unsharded(batches, kind, method, precision):
    """3 pulsars over a 2-shard mesh (2 + 1) against the unsharded batch,
    eager and after aot_compile (one program per shard), and with a
    start vector set through the shards."""
    from pint_tpu_torch.parallel import PTABatch, make_mesh

    pars, _, _, tts = batches[kind]
    kw = {} if method == "wls" else {"precision": precision}
    ref = PTABatch(_models(pars), tts, device="cpu")
    sh = PTABatch(_models(pars), tts, mesh=make_mesh(devices=["cpu"] * 2))
    assert [s.n_pulsars for s in sh._shards] == [2, 1]
    assert sh.n_pulsars == 3 and sh.shape_signature() == ref.shape_signature()
    fit_r = getattr(ref, method + "_fit")
    fit_s = getattr(sh, method + "_fit")
    want = fit_r(maxiter=2, **kw)
    _close(want, fit_s(maxiter=2, **kw))
    key = sh.program_key(method, 2, precision=precision)
    assert not sh._program_ready(key) or isinstance(sh._fns[key], list)
    sh.aot_compile(method, maxiter=2, precision=precision)
    assert sh._program_ready(key) and len(sh._fns[key]) == 2
    _close(want, fit_s(maxiter=2, **kw))
    x0 = want[0] * (1 + 1e-12)
    ref.set_start_vector(x0)
    sh.set_start_vector(x0)
    _close(fit_r(maxiter=2, **kw), fit_s(maxiter=2, **kw))


def test_sharded_batch_evaluations(batches):
    """time_residuals, phases and gw_arrays of a sharded batch gather its
    shards' rows in pulsar order: equal to the unsharded batch's."""
    from pint_tpu_torch.parallel import PTABatch, make_mesh

    pars, _, _, tts = batches["noise"]
    ref = PTABatch(_models(pars), tts, device="cpu")
    sh = PTABatch(_models(pars), tts, mesh=make_mesh(devices=["cpu"] * 3))
    for name in ("time_residuals", "phases"):
        (vr, mr), (vs, ms) = getattr(ref, name)(), getattr(sh, name)()
        assert np.array_equal(mr, ms)
        np.testing.assert_allclose(vs.numpy()[mr], vr.numpy()[mr],
                                   rtol=1e-15, atol=1e-18)
    x = ref.gls_fit(maxiter=1)[0]
    gr, gs = ref.gw_arrays(x), sh.gw_arrays(x)
    assert set(gr) == set(gs)
    for k in gr:
        np.testing.assert_allclose(gs[k], gr[k], rtol=1e-15, atol=1e-18)


def test_sharded_batch_matches_jax(batches):
    """PTABatch(mesh=) in both packages on the same TOAs (3 pulsars over
    3 devices; the JAX package needs an even split): WLS and GLS within
    1e-6 sigma, chi2 to 5e-8 relative (ROADMAP §3) and as far from the
    JAX package's as the unsharded port batch's: the mesh adds no gap."""
    from pint_tpu.parallel import PTABatch as JaxBatch
    from pint_tpu.parallel import make_mesh as jax_mesh
    from pint_tpu_torch.parallel import PTABatch, make_mesh

    for kind, method in (("spin", "wls"), ("noise", "gls")):
        pars, jms, jts, tts = batches[kind]
        jb = JaxBatch(copy.deepcopy(jms), jts, mesh=jax_mesh(3))
        tb = PTABatch(_models(pars), tts,
                      mesh=make_mesh(devices=["cpu"] * 3))
        jx, jc, jcov = (np.asarray(a) for a in
                        getattr(jb, method + "_fit")(maxiter=2))
        tx, tc, _ = getattr(tb, method + "_fit")(maxiter=2)
        _, uc, _ = getattr(PTABatch(_models(pars), tts, device="cpu"),
                           method + "_fit")(maxiter=2)
        sig = np.sqrt(np.diagonal(jcov, axis1=1, axis2=2))
        assert np.max(np.abs(tx - jx) / sig) <= TOL_SIGMA
        np.testing.assert_allclose(tc, jc, rtol=TOL_CHI2)
        np.testing.assert_allclose(tc, uc, rtol=TOL_REL)


def test_mesh_fleet_and_from_packed(batches, tmp_path):
    """PTAFleet(mesh=) (sequential and pipelined) against the unsharded
    fleet; from_packed(mesh=) of a pack_state; a store-built mesh fleet;
    the refusals the JAX package makes (plan + mesh); a 2-D ("pulsar",
    "toa") mesh builds and fits (tests/test_torch_mesh2d.py holds it to
    its tiers)."""
    from pint_tpu_torch.parallel import (PTABatch, PTAFleet, make_mesh,
                                         make_mesh2d)
    from pint_tpu_torch.store import PackStore
    from pint_tpu_torch.parallel.sharded import ShardedBatch

    pars = batches["spin"][0] + batches["noise"][0]
    tts = batches["spin"][3] + batches["noise"][3]
    mesh = make_mesh(devices=["cpu"] * 2)
    ref = PTAFleet(_models(pars), tts, device="cpu")
    want = ref.fit(method="auto", maxiter=2)
    stacked = lambda out: tuple(np.asarray(a) for a in out)  # noqa: E731
    for pipeline in (False, True):
        fleet = PTAFleet(_models(pars), tts, mesh=mesh, pipeline=pipeline)
        assert fleet.device == torch.device("cpu") and fleet.mesh is mesh
        _close(stacked(want), stacked(fleet.fit(method="auto", maxiter=2)))
    store = PackStore(str(tmp_path / "store"))
    PTAFleet(_models(pars), tts, mesh=mesh, store=store)
    hit = PTAFleet(_models(pars), tts, mesh=mesh, store=store)
    assert all(isinstance(b, ShardedBatch) for b in hit.batches.values())
    _close(stacked(want), stacked(hit.fit(method="auto", maxiter=2)))
    batch = ref.batches[next(iter(ref.batches))]
    again = PTABatch.from_packed(batch.template, batch.pack_state(),
                                 mesh=mesh)
    assert len(again._shards) == 2
    _close(batch.wls_fit(maxiter=2), again.wls_fit(maxiter=2))
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
    two_d = PTABatch(_models(batches["spin"][0]), batches["spin"][3],
                     mesh=make_mesh2d(2, 2, devices=["cpu"] * 4))
    assert [len(s._leaves()[2]) for s in two_d._shards] == [2, 2]
    ref = PTABatch(_models(batches["spin"][0]), batches["spin"][3],
                   device="cpu")
    (rx, rc, _), (gx, gc, _) = ref.wls_fit(maxiter=2), two_d.wls_fit(maxiter=2)
    np.testing.assert_allclose(gx, rx, rtol=TOL_REL, atol=0)
    np.testing.assert_allclose(gc, rc, rtol=TOL_REL)
