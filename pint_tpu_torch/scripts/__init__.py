"""Command-line entry points of the port: ``photonphase`` and its
Fermi wrapper ``fermiphase``
(``python -m pint_tpu_torch.scripts.photonphase <events> <par>``)."""
