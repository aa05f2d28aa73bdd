"""The benchmark of pint_tpu_torch, the PyTorch/CUDA port: warm GLS
refits of NANOGrav-15-yr-like fleets, measured on one card and checked
against a plain reference (see run.py)."""
