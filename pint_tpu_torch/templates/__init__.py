"""Pulse-profile templates and the photon-template fit (torch
counterpart of the JAX package's ``templates/``).

(reference: src/pint/templates/ — lcprimitives, lctemplate, lcfitters,
lcnorm; used by photon-event fitting and TOA extraction.)

Densities are float64 torch expressions of the phases, on the phases'
device; numpy phases go to the card. Template parameters cross between
packages as numpy vectors (``LCTemplate.get_parameters`` /
``set_parameters``).
"""

import torch


def photon_loglike(f, weights=None):
    """Unbinned photon log-likelihood sum(log f) — weighted form
    sum(log(w f + 1 - w)) per the reference's wtemp convention
    (reference: lcfitters.py::LCFitter.loglikelihood)."""
    if weights is None:
        return torch.sum(torch.log(torch.clamp(f, min=1e-300)))
    return torch.sum(torch.log(torch.clamp(weights * f + (1.0 - weights),
                                           min=1e-300)))


from .lcprimitives import (LCGaussian, LCGaussian2, LCHarmonic,  # noqa: E402
                           LCKernelDensity, LCLorentzian, LCLorentzian2,
                           LCSkewGaussian, LCTopHat, LCVonMises)
from .lcnorm import NormAngles, angles_from_norms, norms_from_angles  # noqa: E402
from .lctemplate import (LCEmpiricalFourier, LCTemplate,  # noqa: E402
                         gauss_template_from_file, write_gauss_template)
from .lceprimitives import LCEGaussian, LCELorentzian, LCEVonMises  # noqa: E402
from .lcfitters import LCFitter  # noqa: E402

__all__ = ["photon_loglike", "LCGaussian", "LCGaussian2", "LCHarmonic",
           "LCKernelDensity", "LCLorentzian", "LCLorentzian2",
           "LCSkewGaussian", "LCTopHat", "LCVonMises", "NormAngles",
           "angles_from_norms", "norms_from_angles", "LCEmpiricalFourier",
           "LCTemplate", "gauss_template_from_file", "write_gauss_template",
           "LCEGaussian", "LCELorentzian", "LCEVonMises", "LCFitter"]
