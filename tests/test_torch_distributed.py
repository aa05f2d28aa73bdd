"""The port's multi-process fleet (pint_tpu_torch/parallel/distributed.py)
on ``torch.distributed`` with gloo: two CPU ranks, each packing its
``process_pulsar_slice`` and assembling the global batch, against a
single-process fit of the same pulsars in the port and in the JAX
package (tests/test_parallel.py's distributed fleet: EFAC + ECORR + red
noise, so the GLS runs the Woodbury path).

The ranks run as subprocesses (torch's process group is global state of
a process) rendezvousing through a FileStore under ``tmp_path``, each
with its own timeout; a third subprocess, started with them, checks the
handshake watchdog. One module fixture runs all three at once.

Tolerances: a rank's batch is half the single-process one, so the
gathered fit is held to the f64 tier (1e-12 relative) and 1e-6 sigma;
against the JAX package the batched-fit tier, 1e-6 sigma.
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest

from test_torch_pta import port_toas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TOA = 40

WORKER = r'''
import os, pickle, sys, warnings
warnings.simplefilter("ignore")
pid, store, fleet, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
import numpy as np
from pint_tpu_torch.models import get_model
from pint_tpu_torch.parallel import PTABatch
from pint_tpu_torch.parallel.distributed import (
    assemble_global_batch, global_pulsar_mesh, initialize_distributed,
    process_pulsar_slice)
got = initialize_distributed(coordinator_address="file://" + store,
                             num_processes=2, process_id=pid,
                             timeout_s=60)
assert got == (pid, 2), got
assert initialize_distributed() == (pid, 2)  # idempotent
assert process_pulsar_slice(10, process_id=1, num_processes=3) == slice(4, 8)
with open(fleet, "rb") as fh:
    pars, toas, n_pad = pickle.load(fh)
sl = process_pulsar_slice(len(pars))
assert sl == slice(2 * pid, 2 * pid + 2), sl
mesh = global_pulsar_mesh(device="cpu")
local = PTABatch([get_model(p) for p in pars[sl]], toas[sl],
                 pad_toas=n_pad, device="cpu")
pta = assemble_global_batch(local, mesh=mesh)
assert pta.mesh is mesh and pta._pulsar_offset == 2 * pid
assert len(pta.n_toas) == 4
x, chi2, cov = pta.wls_fit(maxiter=3)
xg, chi2g, covg = pta.gls_fit(maxiter=2)
assert x.shape[0] == 4 and xg.shape[0] == 4
np.savez(os.path.join(out, f"rank{pid}.npz"), x=x, chi2=chi2, cov=cov,
         xg=xg, chi2g=chi2g, covg=covg)
print("DIST-OK", pid)
'''

TIMEOUT_PROBE = r'''
import os, socket, sys
from pint_tpu_torch.parallel.distributed import initialize_distributed
with socket.socket() as s:  # a port nobody listens on
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
try:
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=1, timeout_s=1.0)
except TimeoutError as e:
    ok = "did not complete within 1.0s" in str(e) and str(port) in str(e)
    print("TIMEOUT-OK" if ok else f"TIMEOUT-BAD {e}", flush=True)
os._exit(0)  # the watchdog's daemon worker is still in the rendezvous
'''


def _pars():
    return [(f"PSR DT{i}\nRAJ 0{2 * i}:30:00.0\nDECJ {10 + i}:00:00.0\n"
             f"F0 {180 + 7 * i}.25 1\nF1 -{2 + i}e-16 1\nPEPOCH 55500\n"
             f"DM {12 + i}.0 1\n"
             "EFAC -f L-wide 1.1\nECORR -f L-wide 0.7\n"
             "RNAMP 1e-14\nRNIDX -3.0\nTNREDC 8\n") for i in range(4)]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """(pars, JAX models, JAX TOAs, port TOAs, n_pad, rank results):
    the two-rank fit and the watchdog probe, run together."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(42)
    pars = _pars()
    jms, jts = [], []
    for i, p in enumerate(pars):
        jm = jax_model(p)
        n = N_TOA - 2 * i  # ragged: the ranks pad to a common count
        days = np.sort(rng.uniform(55000, 56000, n // 2))
        mjds = np.sort(np.concatenate([days, days + 30.0 / 86400.0]))
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jts.append(make_fake_toas_fromMJDs(
                mjds, jm, error_us=1.0, freq_mhz=freqs, obs="gbt",
                add_noise=True, seed=100 + i, flags={"f": "L-wide"}))
        jms.append(jm)
    tts = [port_toas(t) for t in jts]
    fleet = tmp / "fleet.pkl"
    with open(fleet, "wb") as fh:
        pickle.dump((pars, tts, N_TOA), fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PINT_TPU_FAULTS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), str(tmp / "store"),
         str(fleet), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", TIMEOUT_PROBE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for pid, (out, err) in enumerate(outs[:2]):
        assert f"DIST-OK {pid}" in out, (pid, out[-500:], err[-3000:])
        ranks.append(dict(np.load(tmp / f"rank{pid}.npz")))
    return pars, jms, jts, tts, ranks, outs[2]


def test_two_rank_fit_matches_single_process(dist_run):
    """Both ranks hold the same gathered global result, at the f64 tier
    of a single-process fit of the 4 pulsars (padded alike), WLS and
    GLS."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTABatch

    pars, _, _, tts, (r0, r1), _ = dist_run
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k
    ref = PTABatch([get_model(p) for p in pars], tts, pad_toas=N_TOA,
                   device="cpu")
    for tag, fit in (("", ref.wls_fit(maxiter=3)),
                     ("g", ref.gls_fit(maxiter=2))):
        x, chi2, cov = fit
        sig = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
        assert np.max(np.abs(r0["x" + tag] - x) / sig) <= 1e-6
        np.testing.assert_allclose(r0["x" + tag], x, rtol=1e-12, atol=0)
        np.testing.assert_allclose(r0["chi2" + tag], chi2, rtol=1e-12)
        np.testing.assert_allclose(r0["cov" + tag], cov, rtol=1e-10, atol=0)


def test_two_rank_fit_matches_jax(dist_run):
    """The gathered two-rank GLS fit against the JAX package's
    single-process PTABatch on the same TOAs: 1e-6 sigma."""
    from pint_tpu.parallel import PTABatch as JaxBatch

    _, jms, jts, _, (r0, _), _ = dist_run
    jx, _, jcov = (np.asarray(a) for a in
                   JaxBatch(jms, jts, pad_toas=N_TOA).gls_fit(maxiter=2))
    sig = np.sqrt(np.diagonal(jcov, axis1=1, axis2=2))
    assert np.max(np.abs(r0["xg"] - jx) / sig) <= 1e-6


def test_handshake_watchdog_and_world_one(dist_run):
    """An unreachable coordinator raises TimeoutError naming it within
    the bound (the probe subprocess); without a process group the
    helpers are single-process: the whole slice, rows gathered as they
    are, an assembled batch of one rank keeps its own ECORR decision."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.parallel.distributed import (assemble_global_batch,
                                                     gather_rows,
                                                     process_pulsar_slice)

    pars, _, _, tts, _, (out, err) = dist_run
    assert "TIMEOUT-OK" in out, (out, err[-2000:])
    assert process_pulsar_slice(10) == slice(0, 10)
    assert process_pulsar_slice(10, process_id=2, num_processes=3) == \
        slice(8, 10)
    a = [np.arange(3.0)]
    assert gather_rows(a)[0] is a[0]
    b = PTABatch([get_model(p) for p in pars[:2]], tts[:2], device="cpu")
    want = b.gls_fit(maxiter=1)
    own = b._marginalize("auto")
    assert assemble_global_batch(b) is b
    assert b._ecorr_marg_ok is own and b.mesh.shape == {"pulsar": 1}
    got = b.gls_fit(maxiter=1)
    for u, v in zip(want, got):
        assert np.array_equal(u, v)
