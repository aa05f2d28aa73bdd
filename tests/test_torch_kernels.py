"""The port's Gram kernels (pint_tpu_torch/kernels) against the JAX
package's: the fused whiten+Gram kernel (K1, kernels/fusedgls.py) and
the block-Gram kernel (K2, kernels/seggram.py); on a card also the GW
pair-products kernel (K3, kernels/paircorr.py, whose CPU parity tests
are in test_torch_gw.py) and the appended-rows Gram (K1′,
kernels/incremental.py, CPU parity tests in test_torch_incremental.py)
against their plain versions.

On the CPU the JAX Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them) and the port's wrappers take their
plain f32 version, because the tensors lie on the CPU. Inputs are made
from a numpy seed and handed to both packages as numpy arrays.

Tolerances: f32 block Grams of O(1) entries accumulated over Q rows in
two different summation orders differ by a few f32 ulps of the largest
entry, so the f32 paths are held to 1e-5 of max|G|. The f64 paths
compute the same sums in f64 in possibly different orders: 1e-12
relative.
"""

import numpy as np
import pytest
import torch

# (n rows, K columns, block Q): Q = 96 is one of the planner's non-pow2
# quanta; K = 21 / 62 are not multiples of 4 (the kernel's tile edge) —
# the ragged column edge
CASES = [(192, 9, 32), (96 * 4, 21, 96), (256 * 2, 62, 256), (64, 1, 32)]


def _aug(n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    r = rng.normal(size=n)
    winv = 1.0 / rng.uniform(0.5, 2.0, n)
    return x, r, winv


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("n,k,block", CASES)
def test_fused_block_gls_plain_f32_matches_pallas(n, k, block,
                                                  pallas_interpret):
    from pint_tpu.kernels.fusedgls import augment, fused_block_gls_pallas
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_f32,
                                                 fused_block_gls_plain)

    x, r, winv = _aug(n, k, 12)
    aug = np.asarray(augment(x, r, winv))
    ref = np.asarray(fused_block_gls_pallas(aug, block,
                                            interpret=pallas_interpret))
    out = fused_block_gls_plain(_t(aug, torch.float32), block).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(fused_block_gls_f32(_t(aug), block).numpy(),
                                  out)


@pytest.mark.parametrize("n,k,block", CASES)
def test_block_grams_plain_f32_matches_pallas(n, k, block, pallas_interpret):
    from pint_tpu.kernels.seggram import block_grams_pallas
    from pint_tpu_torch.kernels.seggram import (block_grams_f32,
                                                block_grams_plain)

    x, _, _ = _aug(n, k, 11)
    ref = np.asarray(block_grams_pallas(x, block,
                                        interpret=pallas_interpret))
    out = block_grams_plain(_t(x, torch.float32), block).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(block_grams_f32(_t(x), block).numpy(), out)


@pytest.mark.parametrize("n,k,block", CASES)
def test_f64_references_match_jnp(n, k, block):
    """f64 block and segment references against the JAX *_jnp paths."""
    from pint_tpu.kernels.fusedgls import (augment, fused_block_gls_jnp,
                                           fused_segment_gls_jnp)
    from pint_tpu.kernels.seggram import block_grams_jnp, segment_gram_jnp
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_plain,
                                                 fused_segment_gls)
    from pint_tpu_torch.kernels.seggram import (block_grams_plain,
                                                segment_gram)

    x, r, winv = _aug(n, k, 13)
    nb = n // block
    seg = np.minimum(np.arange(nb) // 2, 2)  # contiguous segments
    n_seg = int(seg.max()) + 1

    def close(a, b):
        b = np.asarray(b)
        assert np.abs(np.asarray(a) - b).max() <= 1e-12 * np.abs(b).max()

    aug = np.asarray(augment(x, r, winv))
    close(fused_block_gls_plain(_t(aug), block), fused_block_gls_jnp(aug, block))
    close(block_grams_plain(_t(x), block), block_grams_jnp(x, block))
    close(segment_gram(_t(x), _t(seg, torch.int64), n_seg, block),
          segment_gram_jnp(x, seg, n_seg, block))
    ref = fused_segment_gls_jnp(x, r, winv, seg, n_seg, block)
    out = fused_segment_gls(_t(x), _t(r), _t(winv), _t(seg, torch.int64),
                            n_seg, block)
    for a, b in zip(out, ref):
        close(a, b)


def test_mixed_segment_pass_matches_pallas_end_to_end(pallas_interpret):
    """The mixed fused segment pass (f32 blocks + f64 segment sum) and
    the mixed segment Gram against the JAX Pallas paths."""
    from pint_tpu.kernels.fusedgls import fused_segment_gls_pallas
    from pint_tpu.kernels.seggram import segment_gram_pallas
    from pint_tpu_torch.kernels.fusedgls import fused_segment_gls
    from pint_tpu_torch.kernels.seggram import segment_gram

    n, k, block = 96 * 6, 13, 96
    x, r, winv = _aug(n, k, 14)
    seg = np.array([0, 0, 1, 1, 1, 2])
    ref = fused_segment_gls_pallas(x, r, winv, seg, 3, block,
                                   interpret=pallas_interpret)
    out = fused_segment_gls(_t(x), _t(r), _t(winv), _t(seg, torch.int64), 3,
                            block, precision="mixed")
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    G = segment_gram(_t(x), _t(seg, torch.int64), 3, block, precision="mixed")
    Gr = np.asarray(segment_gram_pallas(x, seg, 3, block,
                                        interpret=pallas_interpret))
    assert np.abs(G.numpy() - Gr).max() <= 1e-5 * np.abs(Gr).max()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; a CPU call never
    counts as a launch."""
    from pint_tpu_torch.kernels.fusedgls import fused_block_gls_cuda
    from pint_tpu_torch.kernels.incremental import delta_gram_cuda
    from pint_tpu_torch.kernels.seggram import block_grams_cuda

    kernels = (fused_block_gls_cuda, block_grams_cuda, delta_gram_cuda)
    before = [k.launches for k in kernels]
    x = torch.zeros((64, 5), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_block_gls_cuda(x, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        block_grams_cuda(x, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        delta_gram_cuda(x)
    assert [k.launches for k in kernels] == before


# K = 120: the output is too wide for one band of shared memory and its
# tiles for one thread block (the kernel's grid.y split)
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,block", CASES + [(256 * 8, 64, 256),
                                               (32 * 4, 120, 32)])
def test_kernels_on_card_match_plain(n, k, block):
    """K1 and K2 on the card against their plain f32 versions on the
    same inputs: 1e-5 of max|G|, and each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_cuda,
                                                 fused_block_gls_plain)
    from pint_tpu_torch.kernels.seggram import (block_grams_cuda,
                                                block_grams_plain)

    x, r, winv = _aug(n, k, 15)
    aug = torch.as_tensor(np.column_stack([x, r, winv]),
                          dtype=torch.float32, device="cuda")
    for kern, plain, inp in ((fused_block_gls_cuda, fused_block_gls_plain, aug),
                             (block_grams_cuda, block_grams_plain,
                              aug[:, :k].contiguous())):
        before = kern.launches
        out = kern(inp, block)
        torch.cuda.synchronize()
        ref = plain(inp, block)
        assert kern.launches == before + 1
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


# K3 (B_a, B_b, M): a single entry, ragged edges in every dimension of
# the kernel's 64 x 64 output tiles and 32-cell lattice chunks, and the
# GW sweep's full 256 x 256 tile at the throughput lattice
PAIR_CASES = [(1, 1, 1), (13, 21, 37), (256, 256, 512), (300, 70, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("ba,bb,m", PAIR_CASES)
def test_pair_products_on_card_match_plain(ba, bb, m):
    """K3 on the card against its plain f32 version on the same inputs:
    1e-5 of max|.| of each product, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pint_tpu_torch.kernels.paircorr import (pair_products_cuda,
                                                 pair_products_plain)

    rng = np.random.default_rng(16)
    ins = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
           for a in (rng.normal(size=(ba, m)), rng.uniform(0.5, 2, (ba, m)),
                     rng.normal(size=(bb, m)), rng.uniform(0.5, 2, (bb, m)))]
    before = pair_products_cuda.launches
    out = pair_products_cuda(*ins)
    torch.cuda.synchronize()
    assert pair_products_cuda.launches == before + 1
    for got, ref in zip(out, pair_products_plain(*ins)):
        assert got.shape == (ba, bb)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# K1′ (rows, Ka): the streaming lanes' 64-row chunks at Ka = 6 (offset,
# F0, F1, DM + r, winv) and bench.py's kernel scenario at Ka = 12; 8 and
# 24 rows are partial 64-row staging chunks, Ka = 6 a ragged 4x4 tile
@pytest.mark.cuda
@pytest.mark.parametrize("n,ka", [(n, ka) for n in (8, 24, 64)
                                  for ka in (6, 12)])
def test_delta_gram_on_card_matches_plain(n, ka):
    """K1′ on the card against its plain f32 version on the same padded
    rows: 1e-5 of max|G| over the entries a lane reads, one K1′ launch
    and no K1 launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pint_tpu_torch.kernels.fusedgls import fused_block_gls_cuda
    from pint_tpu_torch.kernels.incremental import (delta_gram,
                                                    delta_gram_cuda,
                                                    delta_gram_plain)

    x, r, winv = _aug(n, ka - 2, 17)
    winv = winv * 1e6
    aug = torch.as_tensor(np.column_stack([x, r, winv]),
                          dtype=torch.float32, device="cuda")
    before = (delta_gram_cuda.launches, fused_block_gls_cuda.launches)
    out = delta_gram_cuda(aug)
    torch.cuda.synchronize()
    assert (delta_gram_cuda.launches,
            fused_block_gls_cuda.launches) == (before[0] + 1, before[1])
    ref = delta_gram_plain(aug)
    used = slice(0, ka - 1)
    assert out.shape == (ka, ka)
    assert (out - ref)[used, used].abs().max() \
        <= 1e-5 * ref[used, used].abs().max()
    # the dispatcher launches it for CUDA rows under precision="mixed"
    dev = [torch.as_tensor(a, device="cuda") for a in (x, r, winv)]
    G = delta_gram(*dev, precision="mixed")
    assert G.dtype == torch.float64 and G.is_cuda
    assert delta_gram_cuda.launches == before[0] + 2
