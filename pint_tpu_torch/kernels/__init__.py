"""Kernels of the port: hand-written CUDA for Hopper beside their plain
PyTorch versions (see fusedgls.py, seggram.py, paircorr.py,
incremental.py and harmonics.py)."""

from .fusedgls import (fused_block_gls_cuda, fused_block_gls_f32,
                       fused_block_gls_plain, fused_segment_gls)
from .harmonics import (harmonic_sums, harmonic_sums_cuda,
                        harmonic_sums_plain, harmonic_sums_ref)
from .paircorr import (pair_products, pair_products_cuda,
                       pair_products_plain, pair_products_ref)
from .seggram import (block_grams_cuda, block_grams_f32, block_grams_plain,
                      segment_gram)

__all__ = ["fused_block_gls_cuda", "fused_block_gls_f32",
           "fused_block_gls_plain", "fused_segment_gls",
           "harmonic_sums", "harmonic_sums_cuda", "harmonic_sums_plain",
           "harmonic_sums_ref",
           "pair_products", "pair_products_cuda", "pair_products_plain",
           "pair_products_ref",
           "block_grams_cuda", "block_grams_f32", "block_grams_plain",
           "segment_gram"]
