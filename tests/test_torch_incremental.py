"""The port's streaming append refits against the JAX package's, on the
CPU: the incremental kernel module (pint_tpu_torch/kernels/
incremental.py), the delta store (store/deltas.py) and the streaming
lanes (serve/streaming.py), with the small modules they use
(resilience/faultinject.py, obs/drift.py, store/packstore.py,
``TimingModel.as_parfile``, ``toa.merge_TOAs``).

Inputs are made from numpy seeds and handed to both packages as numpy
arrays; streaming lanes of both packages run on the same TOAs (the JAX
package's simulated TOAs through test_torch_pta.py's ``port_toas``).
The JAX Pallas delta-Gram kernel runs in interpret mode, as
tests/test_incremental.py runs it.

Tolerances and measured gaps:
- appended-rows Gram: f64 port vs JAX 1e-12 relative; the port's plain
  f32 Gram vs the Pallas kernel 1e-5 of max|G| over the entries a lane
  reads ([:K+1, :K+1]; the winv^2 row/column is never read);
- ``chol_update`` and ``IncrementalNormal.solve``: 1e-12 relative, same
  solver (the same IEEE operations in another framework);
- port-internal contracts as in tests/test_incremental.py: f64
  accumulators bitwise the scratch fold, parities 1e-15, escalation and
  restart replay bitwise;
- streaming lanes, port vs JAX: parameters 1e-6 sigma (sigma from the
  port lane's ridged normal matrix), chi2 1e-9 relative. The lanes use
  one-pass TOAs (``iterations=0``), whose residuals keep a ~ms
  systematic, as test_torch_pta.py's do: chi2 is then dominated by it.
  On converged TOAs (chi2 ~ n) the packages' ~1e-13 s residual gap
  (one-ulp phase differences) alone is 7e-9 (n = 48) and 3.5e-9
  (n = 480) of chi2, above 1e-9 (ROADMAP.md queue 3).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_pta import port_toas

K_LANE = 4  # offset, F0, F1, DM


def _rows(rng, n, k):
    X = rng.standard_normal((n, k))
    r = rng.standard_normal(n) * 1e-6
    winv = rng.uniform(0.5, 2.0, n) * 1e6
    return X, r, winv


def _chunks(seed=0, n_base=3000, k=6, appends=(5, 64, 17)):
    rng = np.random.default_rng(seed)
    out = [_rows(rng, n_base, k)]
    out.extend(_rows(rng, n, k) for n in appends)
    return out


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# -- kernel module against the JAX package ------------------------------


@pytest.mark.parametrize("n,k", [(5, K_LANE), (24, K_LANE), (64, 10)])
def test_delta_gram_matches_jax(n, k, pallas_interpret):
    from pint_tpu.kernels import incremental as jinc
    from pint_tpu_torch.kernels import incremental as inc

    X, r, winv = _rows(np.random.default_rng(n), n, k)
    ref = np.asarray(jinc.delta_gram(X, r, winv, precision="f64"))
    out = inc.delta_gram(_t(X), _t(r), _t(winv), precision="f64")
    assert out.dtype == torch.float64 and out.shape == (k + 2, k + 2)
    assert _rel(out, ref) <= 1e-12
    used = slice(0, k + 1)
    pal = np.asarray(jinc.delta_gram_pallas(X, r, winv,
                                            interpret=pallas_interpret))
    mix = inc.delta_gram(X, r, winv, precision="mixed").numpy()
    assert np.abs(mix - pal)[used, used].max() \
        <= 1e-5 * np.abs(pal)[used, used].max()
    # mixed is the f32 Gram widened: f32-close to f64, not equal
    assert 0 < _rel(mix[used, used], ref[used, used]) <= 1e-5
    # the plain version is the CPU form of K1′ on the padded rows
    Xp, rp, wp = inc.pad_append_rows(_t(X), _t(r), _t(winv))
    aug = torch.cat([Xp, rp[:, None], wp[:, None]], 1).float()
    np.testing.assert_array_equal(inc.delta_gram_plain(aug).double(), mix)
    assert Xp.shape[0] == -(-n // 8) * 8


def test_chol_update_matches_jax():
    from pint_tpu.kernels import incremental as jinc
    from pint_tpu_torch.kernels import incremental as inc

    rng = np.random.default_rng(2)
    B = rng.standard_normal((40, 6))
    L = np.linalg.cholesky(B.T @ B + 1e-3 * np.eye(6))
    V = rng.standard_normal((6, 64))
    ref = np.asarray(jinc.chol_update(L, V))
    out = inc.chol_update(_t(L), _t(V))
    assert _rel(out, ref) <= 1e-12
    assert np.allclose(out @ out.T, L @ L.T + V @ V.T, rtol=1e-12)


def test_incremental_solve_matches_jax():
    from pint_tpu.kernels import incremental as jinc
    from pint_tpu_torch.kernels import incremental as inc

    chunks = _chunks(seed=3)
    q = np.full(6, 1e-6)
    sj = jinc.build_normal(*chunks[0], q=q)
    st = inc.build_normal(*chunks[0], q=q, device="cpu")
    for X, r, winv in chunks[1:]:
        sj.append(X, r, winv)
        st.append(X, r, winv)
    dj, cj, ij = sj.solve()
    dt, ct, it = st.solve()
    assert it["solver"] == ij["solver"] == "chol_update"
    assert _rel(dt, dj) <= 1e-12
    assert abs(ct - cj) <= 1e-12 * abs(cj)


# -- kernel module, port-internal (as tests/test_incremental.py) ---------


def test_accumulators_bitwise_vs_scratch():
    from pint_tpu_torch.kernels import incremental as inc

    chunks = _chunks()
    state = inc.build_normal(*chunks[0], q=np.full(6, 1e-6), device="cpu")
    for X, r, winv in chunks[1:]:
        state.append(X, r, winv)
    A0, b0, rNr = inc.scratch_normal(chunks, block=1024, device="cpu")
    assert torch.equal(state.A0, A0)
    assert torch.equal(state.b, b0)
    assert torch.equal(state.rNr, rNr)
    assert state.n_appended == 5 + 64 + 17 and state.appends == 3


@pytest.mark.parametrize("appends", [(64,), (5, 64, 17)])
def test_append_parity_vs_scratch_refit(appends):
    """One append to a clone of the base accumulators (bench.py's
    parity scenario, floored-relative budget) and several chained
    appends (norm-scaled budget) against the scratch refit: 1e-15."""
    from pint_tpu_torch.kernels import incremental as inc

    chunks = _chunks(seed=3, appends=appends)
    q = np.full(6, 1e-6)
    base = inc.build_normal(*chunks[0], q=q, device="cpu")
    state = inc.IncrementalNormal(base.A0, base.b, base.rNr, q=base.q,
                                  device="cpu")
    for X, r, winv in chunks[1:]:
        state.append(X, r, winv)
    dx_i, chi2_i, info_i = state.solve()
    dx_s, chi2_s, _, info_s = inc.scratch_refit(chunks, q=q, device="cpu")
    assert info_i["solver"] == info_s["solver"]
    ref = dx_s.numpy()
    scale = np.abs(ref).max()
    if len(appends) == 1:
        den = np.maximum(np.abs(ref), np.finfo(np.float64).eps * scale)
        assert np.max(np.abs(dx_i.numpy() - ref) / den) <= 1e-15
    else:
        assert np.abs(dx_i.numpy() - ref).max() <= 1e-15 * scale
    assert abs(chi2_i - chi2_s) <= 1e-12 * abs(chi2_s)


def test_chol_update_factorizes_the_updated_normal():
    from pint_tpu_torch.kernels import incremental as inc

    chunks = _chunks(seed=7, appends=(32,))
    state = inc.build_normal(*chunks[0], q=np.full(6, 1e-3), device="cpu")
    state.append(*chunks[1])
    L, A = state.L.numpy(), state.A.numpy()
    assert np.allclose(L @ L.T, A, rtol=1e-10, atol=1e-10 * np.abs(A).max())
    dx, _, info = state.solve()
    assert info["solver"] == "chol_update" and info["relres"] <= 1e-12
    ref = np.linalg.solve(A, state.b.numpy())
    assert np.max(np.abs(dx.numpy() - ref) / np.maximum(np.abs(ref), 1e-30)) \
        < 1e-9


def test_append_survives_unfactorable_normal():
    """An indefinite A routes through the eigh solve, and the NEXT
    append must not crash on the absent factor."""
    from pint_tpu_torch.kernels import incremental as inc

    rng = np.random.default_rng(11)
    k = 6
    state = inc.IncrementalNormal(-np.eye(k), np.ones(k), 1.0, q=np.zeros(k),
                                  device="cpu")
    assert torch.isnan(state.L).all()  # cholesky_ex failed: NaNs, as JAX
    Xa, ra, wa = _rows(rng, 8, k)
    for _ in range(2):
        state.append(Xa * 1e-8, ra, wa * 1e-12)
        assert state.L is None
        dx, _, info = state.solve()
        assert info["solver"] == "eigh_refresh"
        assert torch.isfinite(dx).all()


def test_kernel_wrapper_and_defaults_need_a_card(monkeypatch):
    """K1′'s wrapper refuses a CPU tensor (no launch counted), and the
    module's entry points default to the card."""
    from pint_tpu_torch.kernels import incremental as inc

    before = inc.delta_gram_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        inc.delta_gram_cuda(torch.zeros((64, 6), dtype=torch.float32))
    assert inc.delta_gram_cuda.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, r, winv = _chunks(n_base=64, appends=())[0]
    for call in (lambda: inc.build_normal(X, r, winv, q=np.zeros(6)),
                 lambda: inc.IncrementalNormal(np.eye(6), np.ones(6), 1.0),
                 lambda: inc.scratch_refit([(X, r, winv)], q=np.zeros(6))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- delta store ----------------------------------------------------------


def _arrays(rng, n=16, k=5):
    X, r, winv = _rows(rng, n, k)
    return {"X": X, "r": r, "winv": winv}


def _case_roundtrip(ds, rng):
    from pint_tpu.store.deltas import chain_signature as jax_chain
    from pint_tpu_torch.store import chain_signature

    a1, a2 = _arrays(rng), _arrays(rng)
    tip1, rep1 = ds.append("J0", "base", a1, rid="req-0")
    tip2, rep2 = ds.append("J0", tip1, a2, rid="req-1")
    assert not rep1 and not rep2 and tip2 != tip1
    # the chain links are the JAX package's, byte for byte
    assert tip1 == chain_signature("base", a1, "req-0") \
        == jax_chain("base", a1, "req-0")
    # replay of the newest link (same rid + payload): no new segment
    assert ds.append("J0", tip1, a2, rid="req-1") == (tip2, True)
    assert ds.counters()["replays"] == 1
    chain = ds.load_chain("J0", "base")
    assert [s for s, _ in chain] == [tip1, tip2]
    for (_, got), want in zip(chain, (a1, a2)):
        for name in ("X", "r", "winv"):
            assert np.array_equal(got[name], want[name])
    scan = ds.scan()
    assert (scan["segments"], scan["valid"], scan["corrupt_or_stale"]) \
        == (2, 2, 0)


def _case_diverged_parent(ds, rng):
    ds.append("J1", "base", _arrays(rng), rid="r0")
    with pytest.raises(ValueError, match="chain tip"):
        ds.append("J1", "not-the-tip", _arrays(rng), rid="r1")


def _case_corrupt_suffix(ds, rng):
    tip1, _ = ds.append("J2", "base", _arrays(rng), rid="r0")
    tip2, _ = ds.append("J2", tip1, _arrays(rng), rid="r1")
    ds.append("J2", tip2, _arrays(rng), rid="r2")
    with open(ds._chain_paths("J2")[1], "r+b") as fh:  # corrupt the middle
        fh.seek(40)
        fh.write(b"\xff\xff\xff\xff")
    with pytest.warns(UserWarning, match="delta chain broken"):
        chain = ds.load_chain("J2", "base")
    # verified prefix only; the corrupt segment AND its successor die
    assert [s for s, _ in chain] == [tip1]
    assert ds.scan()["segments"] == 1 and ds.counters()["corrupt"] == 1


def _case_unreadable_tip(ds, rng):
    t1, _ = ds.append("J9", "base", _arrays(rng), rid="r0")
    t2, _ = ds.append("J9", t1, _arrays(rng), rid="r1")
    os.truncate(ds._chain_paths("J9")[-1], 6)  # tear the newest segment
    with pytest.warns(UserWarning, match="delta chain broken"):
        t3, replay = ds.append("J9", t1, _arrays(rng), rid="r2")
    assert not replay and t3 not in (t1, t2)
    assert [s for s, _ in ds.load_chain("J9", "base")] == [t1, t3]
    assert ds.scan()["corrupt_or_stale"] == 0
    # a caller whose in-memory tip WAS the torn segment diverges loudly
    with pytest.raises(ValueError, match="chain tip"):
        ds.append("J9", t2, _arrays(rng), rid="r3")


@pytest.mark.parametrize("case", [_case_roundtrip, _case_diverged_parent,
                                  _case_corrupt_suffix, _case_unreadable_tip],
                         ids=["roundtrip_replay", "diverged_parent",
                              "corrupt_suffix", "unreadable_tip"])
def test_delta_store_chain(tmp_path, case):
    from pint_tpu_torch.store import DeltaStore

    case(DeltaStore(tmp_path), np.random.default_rng(0))


def test_delta_store_prewarm_reset_and_identity(tmp_path):
    from pint_tpu_torch.parallel.shapeplan import PACK_GEOMETRY_VERSION
    from pint_tpu_torch.store import DeltaStore, store_identity

    ds = DeltaStore(tmp_path)
    rng = np.random.default_rng(3)
    tip, _ = ds.append("J3", "base", _arrays(rng), rid="r0")
    ds.prewarm([("J3", "base")], background=True).join(timeout=30)
    assert [s for s, _ in ds.load_chain("J3", "base")] == [tip]
    assert ds.counters()["prewarm_hits"] == 1
    assert PACK_GEOMETRY_VERSION == 3
    assert store_identity() == {"format": 1,
                                "torch_version": torch.__version__,
                                "pack_geometry": 3}
    with pytest.warns(UserWarning, match="re-rooted"):
        ds.reset_lane("J3")
    assert ds.scan()["segments"] == 0


# -- fault injection, drift, signatures, merge ------------------------------


def test_faultinject_trigger_semantics():
    from pint_tpu_torch.resilience import faultinject as fi

    with pytest.raises(ValueError, match="unknown fault point"):
        fi.FaultPoint("not_a_point")
    assert fi.fire("solver_diverge") is None
    with fi.inject(fi.FaultPoint("solver_diverge", count=1, after=1,
                                 payload={"lanes": [0]})):
        assert fi.fire("solver_diverge", lane="A") is None  # skipped
        out = fi.fire("solver_diverge", lane="A")
        assert out == {"lanes": [0], "lane": "A",
                       "point": "solver_diverge", "fire": 1}
        assert fi.fire("solver_diverge") is None  # count spent
        with fi.inject(fi.FaultPoint("process_kill",
                                     payload={"at": "elsewhere"})):
            assert fi.fire_kill("append_delta_write") is False
    assert fi._armed == {}
    fi.arm(fi.FaultPoint("solver_diverge"))
    assert fi.fire("solver_diverge")["fire"] == 1
    fi.disarm("solver_diverge")
    assert fi.fire("solver_diverge") is None and fi._armed == {}


def test_drift_sentinel_matches_jax():
    from pint_tpu.obs.drift import DriftSentinel as JaxSentinel
    from pint_tpu_torch.obs.drift import DriftSentinel

    rng = np.random.default_rng(5)
    series = np.concatenate([rng.standard_normal(30),
                             rng.standard_normal(20) + 4.0])
    js, ts = JaxSentinel(), DriftSentinel()
    alarms = [(js.observe(x), ts.observe(x)) for x in series]
    assert all(a == b for a, b in alarms)
    assert ts.alarms == js.alarms >= 1
    state = ts.state_dict()
    assert state == js.state_dict()
    again = DriftSentinel()
    again.load_state_dict(state)
    assert again.state_dict() == state and again.cusum.pos == 0.0


_PAR = """\
PSR TSTR0
RAJ 11:00:00.0
DECJ 8:00:00.0
F0 289.5 1
F1 -3.2e-16 1
PEPOCH 55500
DM 15.0 1
"""
_NOISE = "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
_RED = "RNAMP 1e-14\nRNIDX -3.1\nTNREDC 8\n"


def test_parfile_signature_and_merge():
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.store import content_signature
    from pint_tpu_torch.toa import merge_TOAs

    m = get_model(_PAR + _NOISE + "ECORR -f L-wide 0.8\n" + _RED)
    m2 = get_model(m.as_parfile())
    assert m2.as_parfile() == m.as_parfile()
    assert sorted(m2.components) == sorted(m.components)
    for p in m.params:
        assert getattr(m2, p).value == getattr(m, p).value, p
    assert "EFAC     -f L-wide 1.1 0" in m.as_parfile()
    t = make_fake_toas_fromMJDs(np.linspace(55000, 55100, 12), m,
                                flags={"f": "L-wide"}, device="cpu")
    a, b = t.mask(np.arange(12) < 5), t.mask(np.arange(12) >= 5)
    merged = merge_TOAs([a, b])
    for col in ("day", "sec", "error_us", "freq_mhz"):
        np.testing.assert_array_equal(getattr(merged, col), getattr(t, col))
    for f in ("pos", "vel"):
        np.testing.assert_array_equal(merged.ssb_obs.__dict__[f],
                                      t.ssb_obs.__dict__[f])
    np.testing.assert_array_equal(merged.tdb.sec, t.tdb.sec)
    assert merged.flags == t.flags
    sig = content_signature([m], [t], lane="stream")
    assert sig == content_signature([m2], [merged], lane="stream")
    assert sig.startswith("pack-") and len(sig) == 45
    assert sig != content_signature([m], [a], lane="stream")
    assert sig != content_signature([get_model(_PAR)], [t], lane="stream")
    assert sig != content_signature([m], [t], lane="other")


# -- streaming lanes --------------------------------------------------------


def _jax_lane_fixture(seed, n_base=48, chunk_sizes=(6, 8, 5), par=_PAR,
                      iterations=0):
    """JAX model, base TOAs and append chunks (gbt, 1400 MHz, white
    noise); ``iterations=0`` leaves the one-pass ~ms systematic."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(seed)
    model = get_model(par)
    kw = dict(error_us=1.0, freq_mhz=1400.0, obs="gbt", add_noise=True,
              iterations=iterations)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        base = make_fake_toas_fromMJDs(
            np.sort(rng.uniform(54800, 56000, n_base)), model, seed=seed,
            **kw)
        chunks, lo = [], 56000.0
        for i, n in enumerate(chunk_sizes):
            mj = np.sort(rng.uniform(lo, lo + 10.0, n))
            lo += 10.0
            chunks.append(make_fake_toas_fromMJDs(mj, model,
                                                  seed=seed + 100 + i, **kw))
    return model, base, chunks


def _lane_sigma(lane):
    """Un-normalized parameter sigmas of a lane (its ridged normal
    matrix), offset dropped."""
    covn = np.linalg.inv(lane.state.A.numpy())
    return (np.sqrt(np.diag(covn)) / lane.norm)[1:]


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_streaming_lanes_match_jax(precision):
    from pint_tpu.serve.streaming import StreamingRefitter as JaxRefitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.serve import StreamingRefitter

    jm, base, chunks = _jax_lane_fixture(seed=4)
    tm = get_model(_PAR)
    js, ts = JaxRefitter(), StreamingRefitter(device="cpu")
    js.register(jm, base, precision=precision)
    ts.register(tm, port_toas(base), precision=precision)
    for i, c in enumerate(chunks):
        oj = js.append(jm, c, rid=f"r{i}")
        ot = ts.append(tm, port_toas(c), rid=f"r{i}")
        assert not ot["escalated"] and not oj["escalated"]
        assert ot["solver"] == oj["solver"] == "chol_update"
        assert ot["free_names"] == oj["free_names"] == ["F0", "F1", "DM"]
        sig = _lane_sigma(ts.lane(tm))
        assert np.max(np.abs(ot["x"] - np.asarray(oj["x"])) / sig) <= 1e-6
        assert abs(ot["chi2"] - oj["chi2"]) <= 1e-9 * abs(oj["chi2"])
        assert ot["n_appended"] == oj["n_appended"]
    assert ts.counters() == js.counters()


def test_correlated_noise_tier_matches_jax():
    """A red-noise model gets no incremental lane: its append is a full
    GLS refit over the merged TOAs, in both packages."""
    from pint_tpu.serve.streaming import StreamingRefitter as JaxRefitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTABatch
    from pint_tpu_torch.serve import StreamingRefitter
    from pint_tpu_torch.toa import merge_TOAs

    par = _PAR + _RED
    jm, base, chunks = _jax_lane_fixture(seed=21, n_base=96,
                                         chunk_sizes=(16,), par=par)
    tm = get_model(par)
    js, ts = JaxRefitter(), StreamingRefitter(device="cpu")
    js.register(jm, base)
    ts.register(tm, port_toas(base))
    assert ts.lane(tm).state is None and not ts.lane(tm).incremental
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        oj = js.append(jm, chunks[0], rid="r0")
    ot = ts.append(tm, port_toas(chunks[0]), rid="r0")
    assert ot["escalation_reason"] == oj["escalation_reason"] \
        == "correlated_noise"
    merged = merge_TOAs([port_toas(base), port_toas(chunks[0])])
    _, _, cov = PTABatch([tm], [merged], pad_toas=128, device="cpu").gls_fit()
    sig = np.sqrt(np.diag(cov[0]))
    assert np.max(np.abs(ot["x"] - np.asarray(oj["x"])) / sig) <= 1e-6
    assert abs(ot["chi2"] - oj["chi2"]) <= 1e-9 * abs(oj["chi2"])


def _port_lane_fixture(seed, n_base=48, chunk_sizes=(6, 8, 5), psr="TSTR0"):
    """Port model, base TOAs and chunks from the port's own simulation
    (geocentric, white noise)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(seed)
    model = get_model(_PAR.replace("TSTR0", psr) + _NOISE)

    def toas(mjds, s):
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        return make_fake_toas_fromMJDs(mjds, model, freq_mhz=freqs,
                                       add_noise=True, seed=s,
                                       flags={"f": "L-wide"}, device="cpu")

    base = toas(np.sort(rng.uniform(54800, 56000, n_base)), seed)
    chunks, lo = [], 56000.0
    for i, n in enumerate(chunk_sizes):
        chunks.append(toas(np.sort(rng.uniform(lo, lo + 10.0, n)),
                           seed + 100 + i))
        lo += 10.0
    return model, base, chunks


def _fresh(model, toas, precision="f64"):
    """(x, chi2) of a fresh registration on ``toas``."""
    from pint_tpu_torch.serve import StreamingRefitter

    sr = StreamingRefitter(device="cpu")
    sr.register(model, toas, precision=precision)
    x, chi2, _ = sr._solve(sr.lane(model))
    return x, chi2


@pytest.mark.parametrize("trigger", ["drift_alarm", "solver_diverge"])
def test_escalation_bitwise_vs_fresh(trigger):
    """Rounds of appends, then an escalation (a drift alarm forced by a
    sentinel that trips on anything, or an injected solver divergence):
    the escalated lane is bitwise a FRESH registration on the merged
    dataset."""
    from pint_tpu_torch.obs.drift import DriftSentinel
    from pint_tpu_torch.resilience import faultinject
    from pint_tpu_torch.serve import StreamingRefitter
    from pint_tpu_torch.toa import merge_TOAs

    model, base, chunks = _port_lane_fixture(seed=4)
    sr = StreamingRefitter(device="cpu")
    if trigger == "drift_alarm":
        sr.register(model, base, precision="mixed",
                    sentinel=DriftSentinel(min_n=2, z_trip=1e-12))
        for i, c in enumerate(chunks[:-1]):
            assert not sr.append(model, c, rid=f"r{i}")["escalated"]
        with pytest.warns(UserWarning, match="escalated"):
            out = sr.append(model, chunks[-1], rid="last")
    else:
        sr.register(model, base, precision="mixed")
        for i, c in enumerate(chunks[:-1]):
            sr.append(model, c, rid=f"r{i}")
        with faultinject.inject("solver_diverge"):
            with pytest.warns(UserWarning, match="escalated"):
                out = sr.append(model, chunks[-1], rid="last")
    assert out["escalated"] and out["solver"] == "full_refit"
    assert out["escalation_reason"] == trigger
    assert sr.counters()["escalated"] == 1
    x_f, chi2_f = _fresh(model, merge_TOAs([base] + chunks),
                         precision="mixed")
    assert np.array_equal(out["x"], x_f)
    assert out["chi2"] == chi2_f


def test_chain_replay_bitwise_across_restart(tmp_path):
    """A second refitter over the same delta store re-registers the
    lane, replays the persisted chain, and solves to bitwise the first
    process's answer — in mixed, where every replayed link goes through
    the same f32 Gram again."""
    from pint_tpu_torch.serve import StreamingRefitter
    from pint_tpu_torch.store import DeltaStore

    model, base, chunks = _port_lane_fixture(seed=8)
    sr1 = StreamingRefitter(deltas=DeltaStore(tmp_path), device="cpu")
    sr1.register(model, base, precision="mixed")
    for i, c in enumerate(chunks):
        out1 = sr1.append(model, c, rid=f"r{i}")
    sr2 = StreamingRefitter(deltas=DeltaStore(tmp_path), device="cpu")
    sr2.register(model, base, precision="mixed")
    assert sr2.counters()["replayed"] == len(chunks)
    lane2 = sr2.lane(model)
    assert lane2.tip == out1["chain"]
    assert lane2.n_appended == out1["n_appended"]
    x2, chi2_2, _ = sr2._solve(lane2)
    assert np.array_equal(out1["x"], x2)
    assert out1["chi2"] == chi2_2
    # replay of the newest link is recognized, not applied twice
    again = sr2.append(model, chunks[-1], rid=f"r{len(chunks) - 1}")
    assert again["replayed"] and again["n_appended"] == out1["n_appended"]


def test_escalation_rechains_and_replayed_lane_keeps_chain(tmp_path):
    """Escalation on a delta-backed lane re-roots the chain at the
    merged base and the next append chains onto it (same math as a
    delta-less lane); a lane restored by chain replay escalates in place
    instead, keeping its chain and every replayed row."""
    from pint_tpu_torch.resilience import faultinject
    from pint_tpu_torch.serve import StreamingRefitter
    from pint_tpu_torch.store import DeltaStore

    model, base, chunks = _port_lane_fixture(seed=15, chunk_sizes=(6, 5, 4))
    ds = DeltaStore(tmp_path / "a")
    outs = {}
    for name, deltas in (("durable", ds), ("plain", None)):
        sr = StreamingRefitter(deltas=deltas, device="cpu")
        sr.register(model, base)
        sr.append(model, chunks[0], rid="r0")
        with faultinject.inject("solver_diverge"):
            with pytest.warns(UserWarning, match="escalated"):
                assert sr.append(model, chunks[1], rid="r1")["escalated"]
        outs[name] = sr.append(model, chunks[2], rid="r2")
    assert not outs["durable"]["escalated"]
    assert np.array_equal(outs["durable"]["x"], outs["plain"]["x"])
    assert outs["durable"]["chi2"] == outs["plain"]["chi2"]
    assert ds.scan()["segments"] == 1  # the old chain went at the re-root

    # restored lane: two links replayed, then an escalation in place
    ds2 = DeltaStore(tmp_path / "b")
    sr1 = StreamingRefitter(deltas=ds2, device="cpu")
    sr1.register(model, base)
    for i, c in enumerate(chunks[:2]):
        sr1.append(model, c, rid=f"r{i}")
    sr2 = StreamingRefitter(deltas=ds2, device="cpu")
    sr2.register(model, base)
    lane = sr2.lane(model)
    assert lane.replayed_segments == 2
    n_rows = lane.n_appended
    with faultinject.inject("solver_diverge"):
        with pytest.warns(UserWarning, match="escalated"):
            out = sr2.append(model, chunks[2], rid="r2")
    assert out["escalated"] and ds2.scan()["segments"] == 3
    assert lane.tip == out["chain"] != lane.base_signature
    assert out["n_appended"] == lane.n_appended > n_rows
    assert np.all(np.isfinite(out["x"]))


def test_streaming_registry_and_device_default(monkeypatch):
    from pint_tpu_torch.serve import StreamingRefitter

    model, base, chunks = _port_lane_fixture(seed=5, chunk_sizes=(4,))
    with pytest.raises(KeyError, match="no streaming lane"):
        StreamingRefitter(device="cpu").append(model, chunks[0], rid="r0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingRefitter()
