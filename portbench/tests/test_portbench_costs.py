"""The benchmark's counts against hand counts at tiny shapes, and the
profiler reduction on a hand-made trace."""

import pytest

from portbench import costs, profiling


def test_refit_flops_by_hand():
    # one pulsar of 10 TOAs and 2 columns, one iteration:
    # Gram 2*10*4 = 80, rhs 2*10*2 = 40, chi2 20, eigh 9*8 = 72
    assert costs.refit_flops([(10, 2)], 1) == 212.0
    assert costs.refit_flops([(10, 2), (10, 2)], 2) == 4 * 212.0


def test_pulsar_columns():
    # offset, F0, F1, DM and 30 harmonics: 64 columns
    assert costs.pulsar_columns({"RNAMP": 1e-14, "TNREDC": 30.0}, 3) == 64
    assert costs.pulsar_columns({"TNREDAMP": -14.0, "TNREDC": 30.0}, 3) == 64
    assert costs.pulsar_columns({"F0": 1.0}, 2) == 3


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_by_hand():
    """Host: a span range over [0, 100] us holding an eigh op over
    [10, 40] that launches two kernels (correlations 1, 2), and a graph
    launch at 50 (correlation 3). Device: the span's device-side copy
    (ignored), the eigh's kernels over [15, 25] and [25, 35], the
    graph's kernel over [80, 90]."""
    events = [
        ev("user_annotation", "fleet.dispatch", 0, 100),
        ev("cpu_op", "aten::linalg_eigh", 10, 30),
        ev("cpu_op", "aten::_linalg_eigh", 11, 28),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        ev("cuda_runtime", "cudaGraphLaunch", 50, 2, corr=3),
        ev("cpu_op", "aten::copy_", 60, 10),
        ev("gpu_user_annotation", "fleet.dispatch", 0, 100, tid=7),
        ev("kernel", "syevd", 15, 10, tid=7, corr=1),
        ev("kernel", "ormtr", 25, 10, tid=7, corr=2),
        ev("kernel", "gemm", 80, 10, tid=7, corr=3),
    ]
    out = profiling.reduce(events)
    assert out["busy_s"] == pytest.approx(30e-6)
    eigh = {"aten::linalg_eigh", "aten::_linalg_eigh"}
    assert profiling.op_device_s(events, eigh) == pytest.approx(20e-6)
    assert profiling.op_device_s(events, {"fleet.dispatch"}) == \
        pytest.approx(30e-6)
    assert dict(out["device_ops"]) == pytest.approx(
        {"syevd": 10e-6, "ormtr": 10e-6, "gemm": 10e-6})
    # [0, 15]: mid 7.5 inside the span only; [35, 80]: mid 57.5, the
    # span (the copy starts at 60); [90, 100]: the span
    assert dict(out["idle_gaps"]) == pytest.approx({"fleet.dispatch": 70e-6})


def test_reduce_without_device_time():
    assert profiling.reduce([ev("cpu_op", "op", 0, 5)]) is None


def test_innermost_matches_a_scan():
    """The sweep's labels against a scan of every range at every point,
    on random nested and overlapping ranges."""
    import numpy as np

    rng = np.random.default_rng(5)
    starts = rng.uniform(0, 100, 300)
    ranges = [(f"r{k}", float(s), float(s + rng.exponential(5.0)))
              for k, s in enumerate(starts)]
    points = [float(p) for p in rng.uniform(-5, 110, 500)]
    for p, got in zip(points, profiling.innermost(ranges, points)):
        open_ = [r for r in ranges if r[1] <= p <= r[2]]
        want = (min(open_, key=lambda r: (-r[1], r[2]))[0] if open_
                else "host (no range open)")
        assert got == want
