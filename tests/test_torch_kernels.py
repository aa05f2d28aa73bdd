"""The port's kernels (pint_tpu_torch/kernels) against the JAX
package's: the fused whiten+Gram kernel (K1, kernels/fusedgls.py), the
block-Gram kernel (K2, kernels/seggram.py) and the photon harmonic sums
(K4, kernels/harmonics.py); on a card also the GW pair-products kernel
(K3, kernels/paircorr.py, whose CPU parity tests are in
test_torch_gw.py), the appended-rows Gram (K1′, kernels/incremental.py,
CPU parity tests in test_torch_incremental.py) and K4 against their
plain versions.

On the CPU the JAX Pallas kernels run in interpret mode (as
tests/test_kernels.py runs them) and the port's wrappers take their
plain f32 version, because the tensors lie on the CPU. Inputs are made
from a numpy seed and handed to both packages as numpy arrays.

Tolerances: f32 block Grams of O(1) entries accumulated over Q rows in
two different summation orders differ by a few f32 ulps of the largest
entry, so the f32 paths are held to 1e-5 of max|G|. The f64 paths
compute the same sums in f64 in possibly different orders: 1e-12
relative. K4's f32 sums over n photons are held to the JAX package's
own bound, max(4e-8 n, 1e-4) absolute (tests/test_kernels.py), and its
f64 reference to 1e-12 of sum|w|.
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


# -- K4: harmonic sums over photon phases ---------------------------------

def _photons(n, seed, weighted):
    rng = np.random.default_rng(seed)
    ph = rng.random(n)
    return ph, (rng.random(n) if weighted else None)


def _k4_tol(n):
    return max(4e-8 * n, 1e-4)


@pytest.mark.parametrize("n,m,weighted", [(1000, 5, False),
                                          (5000, 8, True), (3, 33, True)])
def test_harmonic_sums_ref_matches_jnp(n, m, weighted):
    """The f64 reference against the JAX package's jnp path: the same
    expression summed in different orders, <= 1e-12 sum|w|."""
    from pint_tpu.kernels.harmonics import harmonic_sums_jnp
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums,
                                                  harmonic_sums_ref)

    ph, w = _photons(n, 3, weighted)
    scale = n if w is None else np.abs(w).sum()
    ref = harmonic_sums_jnp(ph, m, w)
    out = harmonic_sums_ref(_t(ph), m, None if w is None else _t(w))
    for a, b in zip(out, ref):
        assert a.shape == (m,) and a.dtype == torch.float64
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12 * scale
    # the dispatcher takes the f64 reference for CPU tensors
    disp = harmonic_sums(_t(ph), m, None if w is None else _t(w))
    for a, b in zip(disp, out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,m,weighted", [(1000, 5, False),
                                          (8192 * 3 + 517, 8, True),
                                          (70000, 20, False)])
def test_harmonic_sums_plain_matches_pallas(n, m, weighted, pallas_interpret):
    """The plain f32 version (the kernel's arithmetic) against the JAX
    Pallas kernel in interpret mode, at the JAX package's tolerance."""
    from pint_tpu.kernels.harmonics import harmonic_sums_pallas
    from pint_tpu_torch.kernels.harmonics import harmonic_sums_plain

    ph, w = _photons(n, 4, weighted)
    ref = harmonic_sums_pallas(ph, m, weights=w, interpret=pallas_interpret)
    out = harmonic_sums_plain(_t(ph), m, None if w is None else _t(w))
    for a, b in zip(out, ref):
        assert a.shape == (m,) and a.dtype == torch.float64
        assert np.abs(a.numpy() - np.asarray(b)).max() < _k4_tol(n)


@pytest.mark.parametrize("weights", ["none", "shared", "per-row"])
def test_harmonic_sums_rows_equal_row_calls(weights):
    """A (G, n) input gives what G calls on its rows give: the f64
    reference to 1e-12 of sum|w|, the plain f32 version to the K4
    tolerance."""
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums_plain,
                                                  harmonic_sums_ref)

    rng = np.random.default_rng(8)
    g, n, m = 3, 4099, 7
    ph = rng.random((g, n))
    w = {"none": None, "shared": rng.random(n),
         "per-row": rng.random((g, n))}[weights]
    for fn, tol in ((harmonic_sums_ref, 1e-12 * n),
                    (harmonic_sums_plain, _k4_tol(n))):
        c, s = fn(_t(ph), m, None if w is None else _t(w))
        assert c.shape == s.shape == (g, m)
        for i in range(g):
            wi = None if w is None else _t(w if w.ndim == 1 else w[i])
            ci, si = fn(_t(ph[i]), m, wi)
            assert np.abs(c[i].numpy() - ci.numpy()).max() <= tol
            assert np.abs(s[i].numpy() - si.numpy()).max() <= tol


def test_harmonic_sums_cuda_refuses_cpu_tensors():
    from pint_tpu_torch.kernels.harmonics import harmonic_sums_cuda

    before = harmonic_sums_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        harmonic_sums_cuda(torch.zeros(70000, dtype=torch.float32), 4)
    assert harmonic_sums_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("m", [1, 5, 20, 33])
@pytest.mark.parametrize("n", [1, 8191, 8192 * 3 + 517, 4_000_000])
def test_harmonic_sums_on_card_match_plain(n, m, g):
    """K4 on the card against its plain f32 version, unweighted and
    weighted (per-row and shared weights), at the K4 tolerance; one
    launch per call, two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums_cuda,
                                                  harmonic_sums_plain)

    rng = np.random.default_rng(n + m + g)
    shape = (n,) if g == 1 else (g, n)
    ph = torch.as_tensor(rng.random(shape), dtype=torch.float32,
                         device="cuda")
    wts = (None, torch.as_tensor(rng.random(shape), dtype=torch.float32,
                                 device="cuda"),
           torch.as_tensor(rng.random(n), dtype=torch.float32,
                           device="cuda"))
    for w in wts:
        before = harmonic_sums_cuda.launches
        out = harmonic_sums_cuda(ph, m, w)
        again = harmonic_sums_cuda(ph, m, w)
        torch.cuda.synchronize()
        assert harmonic_sums_cuda.launches == before + 2
        ref = harmonic_sums_plain(ph, m, w)
        for a, b, r in zip(out, again, ref):
            assert a.shape == r.shape == shape[:-1] + (m,)
            assert a.dtype == torch.float64 and a.is_cuda
            assert torch.equal(a, b)
            assert (a - r).abs().max().item() < _k4_tol(n)


@pytest.mark.cuda
def test_harmonic_sums_cuda_refuses_bad_tensors():
    """An f64 or a non-contiguous CUDA tensor, or m < 1, raises and
    counts no launch; the dispatcher sends a CUDA batch of >= 65536
    photons to the kernel and a smaller one to the f64 reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums,
                                                  harmonic_sums_cuda)

    before = harmonic_sums_cuda.launches
    ph = torch.rand(2, 70000, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        harmonic_sums_cuda(ph.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        harmonic_sums_cuda(ph.mT, 4)
    with pytest.raises(ValueError, match="m must be"):
        harmonic_sums_cuda(ph, 0)
    assert harmonic_sums_cuda.launches == before
    harmonic_sums(ph.double(), 4)
    assert harmonic_sums_cuda.launches == before + 1
    harmonic_sums(ph[:, :1000].double(), 4)
    assert harmonic_sums_cuda.launches == before + 1
