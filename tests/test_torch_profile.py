"""The port's fftfit (profile/) against the JAX package's, on the CPU.

Inputs: seeded noisy profiles of a one- or two-peak template rotated
by known shifts, as numpy arrays handed to both packages.

Tolerance: every number of every backend and wrapper (shift,
uncertainty, scale, offset, S/N; the nustar/presto tuples; cprof) to
1e-12, absolute for the shift and relative otherwise: the FFTs of
torch and XLA round alike to ~1e-15 and the grid's first maximum is
the same cell.
"""

import numpy as np
import pytest

NBIN = 256


def _template(two_peaks):
    x = (np.arange(NBIN) + 0.5) / NBIN
    t = np.exp(-0.5 * ((x - 0.3) / 0.03) ** 2) + 0.1
    if two_peaks:
        t += 0.6 * np.exp(-0.5 * ((x - 0.72) / 0.05) ** 2)
    return t


def _rotate(p, shift):
    """``p`` rotated later by ``shift`` turns (exact Fourier rotation)."""
    k = np.arange(NBIN // 2 + 1)
    return np.fft.irfft(np.fft.rfft(p) * np.exp(-2j * np.pi * k * shift),
                        NBIN)


CASES = [(seed, shift, two) for seed, shift, two in
         ((0, 0.1234, False), (1, -0.377, True), (2, 0.49, False),
          (3, 0.0, True))]


def _profile(seed, shift, two_peaks):
    rng = np.random.default_rng(seed)
    tpl = _template(two_peaks)
    prof = 3.0 * _rotate(tpl, shift) + 2.0 + 0.05 * rng.standard_normal(NBIN)
    return tpl, prof


def _close(a, b, rel=1e-12):
    assert abs(a - b) <= rel * max(abs(b), 1.0), (a, b)


@pytest.mark.parametrize("seed,shift,two", CASES)
def test_fftfit_full_matches_jax(seed, shift, two):
    import pint_tpu.profile as jp
    import pint_tpu_torch.profile as tp

    tpl, prof = _profile(seed, shift, two)
    a = tp.fftfit_full(tpl, prof, device="cpu")
    b = jp.fftfit_full(tpl, prof)
    assert abs(a.shift - b.shift) <= 1e-12
    for f in ("uncertainty", "scale", "offset", "snr"):
        _close(getattr(a, f), getattr(b, f))
    # and the fit finds the injected rotation
    d = (a.shift - shift + 0.5) % 1.0 - 0.5
    assert abs(d) < 5 * a.uncertainty + 1e-6
    assert tp.fftfit_basic(tpl, prof, device="cpu") == a.shift
    assert tp.fftfit_full_aarchiba(tpl, prof, device="cpu") == a
    assert tp.fftfit_basic_aarchiba(tpl, prof, device="cpu") == a.shift


@pytest.mark.parametrize("seed,shift,two", CASES)
def test_fftfit_cc_and_wrappers_match_jax(seed, shift, two):
    import torch

    import pint_tpu.profile as jp
    import pint_tpu_torch.profile as tp

    tpl, prof = _profile(seed, shift, two)
    assert abs(tp.fftfit_cc(tpl, prof, device="cpu")
               - jp.fftfit_cc(tpl, prof)) <= 1e-12
    for a, b in zip(tp.fftfit_full_nustar(tpl, prof, device="cpu"),
                    jp.fftfit_full_nustar(tpl, prof)):
        _close(a, b)
    for a, b in zip(tp.fftfit_full_presto(tpl, prof, device="cpu"),
                    jp.fftfit_full_presto(tpl, prof)):
        _close(a, b, rel=1e-12 * NBIN)
    for a, b in zip(tp.fftfit_cprof(torch.as_tensor(prof)),
                    jp.fftfit_cprof(prof)):
        np.testing.assert_array_equal(a, b)
    # tensors already on the device are taken as they are
    r = tp.fftfit_full(torch.as_tensor(tpl), torch.as_tensor(prof),
                       device="cpu")
    assert r == tp.fftfit_full(tpl, prof, device="cpu")


def test_fftfit_needs_a_card_unless_asked(monkeypatch):
    import torch

    import pint_tpu_torch.profile as tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpl, prof = _profile(0, 0.1, False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.fftfit_full(tpl, prof)
