"""The port's cost model (pint_tpu_torch/obs/costmodel.py) against the
JAX package's obs/costmodel.py, and the cost a fit program carries.

- ``attribute``, ``mfu_pct``, ``arithmetic_intensity``,
  ``roofline_ceiling_flops`` and ``ProgramLedger`` give the JAX
  package's results, key for key, on the CPU row under the same
  ``PINT_TPU_PEAK_*`` overrides (exact: the same float arithmetic).
- The card's row is chosen by ``torch.cuda.get_device_name``: the H100
  SXM's name gets NVIDIA's data-sheet rates, any other card the nominal
  spec with ``nominal=True``.
- A fit program's count (``PTABatch._program_cost``,
  ``costmodel.normal_equations_cost``) is checked by hand on a small
  batch and is the same for ``precision="mixed"`` and ``"f64"``.
"""

import numpy as np
import pytest
import torch

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def overrides(monkeypatch):
    monkeypatch.setenv("PINT_TPU_PEAK_FLOPS", "2.5e12")
    monkeypatch.setenv("PINT_TPU_PEAK_BYTES_PER_S", "1.25e11")


@pytest.mark.parametrize("flops,nbytes,wall", [
    (4.0e10, 1.0e9, 0.05), (1.0e9, 2.0e9, 0.3), (7.0e6, 1.0e5, 1e-4),
    (3.0e9, None, 0.1), (None, 5.0e8, 0.1), (2.0e9, 4.0e8, None)])
def test_attribute_matches_jax(overrides, flops, nbytes, wall):
    from pint_tpu.obs import costmodel as jcm
    from pint_tpu_torch.obs import costmodel as cm

    got = cm.attribute(flops, nbytes, wall_s=wall, platform="cpu")
    want = jcm.attribute(flops, nbytes, wall_s=wall, platform="cpu")
    assert got == want
    assert cm.mfu_pct(flops, wall, "cpu") == jcm.mfu_pct(flops, wall, "cpu")
    ai = cm.arithmetic_intensity(flops, nbytes)
    assert ai == jcm.arithmetic_intensity(flops, nbytes)
    assert cm.roofline_ceiling_flops(ai, "cpu") == \
        jcm.roofline_ceiling_flops(ai, "cpu")


def test_ledger_matches_jax(overrides):
    from pint_tpu.obs import costmodel as jcm
    from pint_tpu_torch.obs import costmodel as cm

    rec = {"flops": 3.2e9, "bytes_accessed": 6.4e8, "memory": None}
    led, jled = cm.ProgramLedger(), jcm.ProgramLedger()
    led.record("p", rec)
    jled.record("p", rec)
    assert led.attribute("p", 0.02, "cpu") == jled.attribute("p", 0.02,
                                                              "cpu")
    assert led.attribute("missing") is None
    assert led.snapshot() == jled.snapshot() == {"p": rec}
    led.reset()
    assert led.snapshot() == {}


def test_card_row_chosen_by_name(monkeypatch):
    from pint_tpu_torch.obs import costmodel as cm

    monkeypatch.delenv("PINT_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PINT_TPU_PEAK_BYTES_PER_S", raising=False)
    assert cm.platform_of(torch.device("cpu")) == "cpu"
    assert cm.default_platform() == "cpu"  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    assert cm.default_platform() == H100
    spec = cm.device_spec()
    assert spec == {"peak_flops": 6.7e13, "peak_bytes_per_s": 3.35e12,
                    "platform": H100}
    attr = cm.attribute(6.7e10, 1.0e9, wall_s=1.0)
    assert "nominal" not in attr and attr["mfu_pct"] == 0.1
    assert attr["bound"] == "compute"  # 67 FLOP/B >= the 20 FLOP/B knee
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    spec = cm.device_spec()
    assert spec["nominal"] is True and spec["peak_flops"] == 1.0e12
    assert cm.attribute(1e9, 1e8, wall_s=1.0)["nominal"] is True
    assert "gpu" not in cm.DEVICE_SPECS and "tpu" not in cm.DEVICE_SPECS
    assert cm.device_memory_stats() is None or torch.cuda.device_count()


def test_bare_program_has_no_cost():
    from pint_tpu_torch.obs import costmodel as cm

    assert cm.executable_cost(lambda x: x) == {
        "flops": None, "bytes_accessed": None, "memory": None}
    assert cm.device_memory_stats(torch.device("cpu")) is None


def _red_noise_batch(n_psr=2, n_toa=(30, 24), tnredc=4):
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    models, toas = [], []
    for i in range(n_psr):
        m = get_model(f"PSR CM{i}\nRAJ 0{i}:10:00.0\nDECJ 2{i}:00:00.0\n"
                      f"F0 {180 + 9 * i}.5 1\nF1 -{1 + i}e-16 1\n"
                      f"PEPOCH 55500\nDM {7 + i}.25 1\n"
                      f"TNREDAMP -13.7\nTNREDGAM 3.0\nTNREDC {tnredc}\n")
        mjds = np.sort(np.random.default_rng(i).uniform(55000, 56000,
                                                        n_toa[i]))
        toas.append(make_fake_toas_fromMJDs(
            mjds, m, error_us=1.0, freq_mhz=1400.0, obs="gbt",
            add_noise=True, seed=i, device="cpu"))
        models.append(m)
    return PTABatch(models, toas, device="cpu")


def test_program_count_by_hand_and_precision_free():
    from pint_tpu_torch.obs import costmodel as cm

    batch = _red_noise_batch()
    B, W = 2, 30
    n_free = 3  # F0, F1, DM
    k = 1 + n_free + 2 * 4  # offset + free + 2 TNREDC basis columns
    maxiter = 2
    flops = maxiter * (2 * B * W * k * k + 2 * B * W * k + 2 * B * W
                       + 9 * B * k ** 3)
    leaves = [batch._x0()] + [t for tree in batch._leaves()
                              for t in (tree.values() if isinstance(
                                  tree, dict) else tree)
                              if isinstance(t, torch.Tensor)]
    in_bytes = sum(t.numel() * t.element_size() for t in leaves)
    out_bytes = B * (n_free + 1 + n_free ** 2) * 8
    want = {"flops": float(flops), "bytes_accessed": float(in_bytes
                                                           + out_bytes),
            "memory": {"argument_size_in_bytes": in_bytes,
                       "output_size_in_bytes": out_bytes}}
    assert batch._program_cost("gls", maxiter) == want

    cm.LEDGER.reset()
    infos = {p: batch.aot_compile("gls", maxiter, precision=p)
             for p in ("f64", "mixed")}
    for p, info in infos.items():
        assert info["flops"] == want["flops"]
        assert info["bytes_accessed"] == want["bytes_accessed"]
        assert info["bound"] in ("compute", "memory")
        key = batch.program_key("gls", maxiter, precision=p)
        assert batch._costs[key] == want
        assert cm.LEDGER.get(str(key)) == want
    wls = batch._program_cost("wls", 3)
    assert wls["flops"] == 3 * (2 * B * W * 16 + 2 * B * W * 4
                                + 2 * B * W + 9 * B * 64)
    cm.LEDGER.reset()
