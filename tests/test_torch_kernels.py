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


# -- launch plans (computed in Python, so they are tested here) ---------

# chip_smoke.py's K3 shapes (fleet, sweep tile, whole product) and the
# card tests' edges
PAIR_PLAN_SHAPES = [(68, 68, 100), (256, 256, 512), (3000, 3000, 512),
                    (1, 1, 1), (13, 21, 37), (300, 70, 129), (129, 257, 33),
                    (64, 64, 37), (50, 40, 7)]


@pytest.mark.parametrize("ba,bb,m", PAIR_PLAN_SHAPES)
def test_pair_grid_covers_each_output_once(ba, bb, m):
    """K3's launch: the grid's 64 x 64 tiles and each tile's 128 threads
    (8 rows x 4 columns each) cover every output of both products
    exactly once, with no block wholly past the edge; the ring fits the
    48 KB a block has without an opt-in; rows copy 16 bytes at a time
    only when M is a multiple of 4 and every operand is aligned."""
    from pint_tpu_torch.kernels import paircorr as pc

    gx, gy, gz = pc.pair_grid(ba, bb)
    assert gz == 2
    assert (gx - 1) * pc.TILE < bb <= gx * pc.TILE
    assert (gy - 1) * pc.TILE < ba <= gy * pc.TILE
    tm, tn = pc.PER_THREAD
    assert pc.THREADS * tm * tn == pc.TILE ** 2
    rt, ct = pc.TILE // tm, pc.TILE // tn
    seen = np.zeros((pc.TILE, pc.TILE), dtype=int)
    for tid in range(pc.THREADS):
        ty, tx = divmod(tid, ct)
        for i in range(tm):
            for j in range(tn):
                seen[ty + rt * i, tx + ct * j] += 1
    assert (seen == 1).all()
    assert pc.SMEM_BYTES <= 48 * 1024
    assert pc.copies_16_bytes(m, 0, 256, 4096, 16) == (m % 4 == 0)
    assert not pc.copies_16_bytes(m, 0, 4, 4096, 16)


# chip_smoke.py's shapes, (nb, q, ka): K2 (115200, 64) at Q = 32, K1
# (460800, 66) at Q = 256, K1′ at 64 x 6 and 64 x 12; then the card
# tests' shapes, K = 120's grid.y split, and q * ka no multiple of 4
GRAM_PLAN_SHAPES = [(3600, 32, 64), (1800, 256, 66), (1, 64, 6), (1, 64, 12),
                    (6, 32, 9), (6, 32, 11), (4, 96, 21), (4, 96, 23),
                    (2, 256, 62), (2, 256, 64), (2, 32, 1), (2, 32, 3),
                    (4, 32, 120), (4, 32, 122), (3, 30, 5), (3, 30, 7),
                    (1, 8, 6), (1, 24, 12)]


@pytest.mark.parametrize("resident", [1, 131, 528])
@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("nb,q,ka", GRAM_PLAN_SHAPES)
def test_gram_plan_covers_each_q_block_once(nb, q, ka, whiten, resident):
    """The block-Gram launch plan: the persistent grid walks every
    Q-block exactly once and is never wider than the Q-blocks; the ring
    chunks cover every row of a Q-block once; the threads of the grid's
    y-blocks own every upper-triangle 4 x 4 tile once (numbered diagonal
    by diagonal, as gram.cu does); the layout pass's threads cover a
    row; shared memory stays within 227 KB; rows copy 16 bytes at a
    time exactly when every chunk starts on a 16-byte boundary (else per
    thread, 4 bytes at a time); the products read the ring directly
    only without whitening at ka % 4 == 0; the output leaves by one
    bulk store only for even ka, one block per Q-block, an aligned
    output and blocks that walk more than one Q-block."""
    from pint_tpu_torch.kernels import gram

    shape = gram.gram_shape(q, ka, whiten)
    grid_x, threads, chunk, vec, bulk, smem = gram.gram_plan(
        nb, q, ka, whiten, 256, 512, resident)
    assert (threads, chunk, smem) == (shape.threads, shape.chunk,
                                      shape.smem_bytes)
    assert 1 <= grid_x <= nb
    assert grid_x == max(1, min(nb, resident // shape.grid_y))
    # gram.cu: blk = blockIdx.x; blk < nb; blk += gridDim.x
    walked = [blk for bx in range(grid_x) for blk in range(bx, nb, grid_x)]
    assert sorted(walked) == list(range(nb))
    rows = np.zeros(q, dtype=int)
    for c in range(-(-q // chunk)):
        rows[c * chunk:min(q, (c + 1) * chunk)] += 1
    assert (rows == 1).all() and (chunk % 4 == 0 or chunk == q)
    ntr = -(-ka // gram.TILE)
    n_tiles = ntr * (ntr + 1) // 2
    assert threads % 32 == 0 and threads <= gram.MAX_THREADS
    assert (shape.grid_y - 1) * threads < n_tiles <= shape.grid_y * threads
    entries = np.zeros((4 * ntr, 4 * ntr), dtype=int)
    for t in range(n_tiles):
        d = 0
        while t >= (d + 1) * ntr - (d + 1) * d // 2:
            d += 1
        ti = t - (d * ntr - d * (d - 1) // 2)
        entries[4 * ti:4 * ti + 4, 4 * (ti + d):4 * (ti + d) + 4] += 1
    upper = np.triu(np.ones((ka, ka), dtype=bool))
    assert (entries[:ka, :ka][upper] == 1).all()
    assert (ka if ka % 2 else ka // 2) <= threads  # the layout pass
    assert smem <= gram.SMEM_LIMIT
    assert shape.direct == (not whiten and ka % 4 == 0)
    land = -(-chunk * ka // 4) * 4
    assert smem == 4 * (gram.STAGES * land
                        + (0 if shape.direct else chunk * 4 * ntr)
                        + ka * ka)
    assert vec == (q * ka % 4 == 0)
    assert bulk == (nb > grid_x and ka % 2 == 0 and shape.grid_y == 1)
    assert gram.gram_plan(nb, q, ka, whiten, 260, 512, resident)[3] == 0
    assert gram.gram_plan(nb, q, ka, whiten, 256, 520, resident)[4] == 0


def test_gram_shape_refuses_what_shared_memory_cannot_hold():
    """A staging tile wider than a block's shared memory is refused
    before any launch; the widest the plan accepts fits."""
    from pint_tpu_torch.kernels import gram

    with pytest.raises(ValueError, match="shared memory"):
        gram.gram_shape(32, 240, True)
    assert gram.gram_shape(32, 200, True).smem_bytes <= gram.SMEM_LIMIT


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
    x, r, winv = _aug(n, k, 15)
    aug = torch.as_tensor(np.column_stack([x, r, winv]),
                          dtype=torch.float32, device="cuda")
    _gram_pair_on_card(aug, k, block)


def _gram_pair_on_card(aug, k, block, kernels=("K1", "K2")):
    """K1 on ``aug`` and K2 on its first k columns against their plain
    f32 versions: 1e-5 of max|G|, one launch per call, and a second
    call bitwise equal to the first."""
    from pint_tpu_torch.kernels.fusedgls import (fused_block_gls_cuda,
                                                 fused_block_gls_plain)
    from pint_tpu_torch.kernels.seggram import (block_grams_cuda,
                                                block_grams_plain)

    runs = {"K1": (fused_block_gls_cuda, fused_block_gls_plain, aug),
            "K2": (block_grams_cuda, block_grams_plain,
                   aug[:, :k].contiguous())}
    for kern, plain, inp in (runs[name] for name in kernels):
        before = kern.launches
        out = kern(inp, block)
        again = kern(inp, block)
        torch.cuda.synchronize()
        ref = plain(inp, block)
        assert kern.launches == before + 2
        assert out.shape == ref.shape
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
        assert torch.equal(out, again)


# Q-block counts at the persistent grid's edges (one Q-block, just
# below and just above the grid's width on this card, K2's 3,600 at
# Q = 32, K = 64) and Q-blocks whose q * Ka is no multiple of 4, which
# take the per-thread copies
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("case", ["one", "below", "above", "k2", "ragged"])
def test_gram_on_card_at_persistent_edges(case, kernel):
    """K1 or K2 on the card at the persistent grid's edges and with
    rows that cannot copy 16 bytes at a time, against its plain f32
    version: 1e-5 of max|G|, one launch per call, bitwise repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pint_tpu_torch.kernels import gram

    k, block = (5, 30) if case == "ragged" else (64, 32)
    ka = k + 2 if kernel == "K1" else k
    shape = gram.gram_shape(block, ka, kernel == "K1")
    width = gram.persistent_grid(
        2**40, shape.grid_y,
        gram.resident_blocks(torch.cuda.current_device(), shape.threads,
                             shape.smem_bytes))
    nb = {"one": 1, "below": width - 1, "above": width + 1, "k2": 3600,
          "ragged": 3}[case]
    x, r, winv = _aug(nb * block, k, 18)
    aug = torch.as_tensor(np.column_stack([x, r, winv]),
                          dtype=torch.float32, device="cuda")
    _gram_pair_on_card(aug, k, block, (kernel,))


# K3 (B_a, B_b, M): a single entry, ragged edges in every dimension of
# the kernel's output tiles and 32-cell lattice chunks, and the GW
# sweep's full 256 x 256 tile at the throughput lattice; then a shape
# that straddles the 64 tile and the chunk in every dimension, M not a
# multiple of 4, M below one chunk, and the whole 3000-pulsar product
# (the 128 tile)
PAIR_CASES = [(1, 1, 1), (13, 21, 37), (256, 256, 512), (300, 70, 129),
              (129, 257, 33), (64, 64, 37), (50, 40, 7), (3000, 3000, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("ba,bb,m", PAIR_CASES)
def test_pair_products_on_card_match_plain(ba, bb, m, offset):
    """K3 on the card against its plain f32 version on the same inputs:
    1e-5 of max|.| of each product, one launch per call, and a second
    call bitwise equal to the first. ``offset`` 1 starts every operand
    one float into its buffer, off the 16-byte copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pint_tpu_torch.kernels.paircorr import (pair_products_cuda,
                                                 pair_products_plain)

    rng = np.random.default_rng(16)

    def upload(a):
        buf = torch.empty(a.size + offset, dtype=torch.float32,
                          device="cuda")
        buf[offset:] = torch.as_tensor(a.ravel(), dtype=torch.float32)
        return buf[offset:].view(a.shape)

    ins = [upload(a)
           for a in (rng.normal(size=(ba, m)), rng.uniform(0.5, 2, (ba, m)),
                     rng.normal(size=(bb, m)), rng.uniform(0.5, 2, (bb, m)))]
    before = pair_products_cuda.launches
    out = pair_products_cuda(*ins)
    again = pair_products_cuda(*ins)
    torch.cuda.synchronize()
    assert pair_products_cuda.launches == before + 2
    for got, rep, ref in zip(out, again, pair_products_plain(*ins)):
        assert got.shape == (ba, bb)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
        assert torch.equal(got, rep)


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


# chip_smoke.py's K4 shapes (hm / hmw at 4M photons, z2m(m=4), the
# 32-trial scan), then the card tests' edges: one photon, n % 4 != 0,
# fewer photons than a wave of threads, 65535 one-photon rows, m above
# one chunk
K4_PLAN_SHAPES = [(1, 4_000_000, 20), (1, 4_000_000, 4), (32, 4_000_000, 20),
                  (1, 1, 1), (1, 7, 2), (3, 4095, 4), (3, 8191, 5),
                  (2, 70000, 33), (65535, 1, 1), (1, 25093, 8), (4, 9, 20)]


@pytest.mark.parametrize("resident", [132, 264, 528])
@pytest.mark.parametrize("weights", ["none", "shared", "per-row"])
@pytest.mark.parametrize("g,n,m", K4_PLAN_SHAPES)
def test_harmonic_plan_covers_each_photon_and_harmonic_once(g, n, m, weights,
                                                            resident):
    """K4's launch plan: the smallest instantiation that holds m (32 and
    several chunks above 32), whose chunks cover harmonics 1..m once;
    blocks per (row, chunk) never more than the row's quads need and
    the grid one wave wherever the rows allow; the grid-stride loop over
    whole quads of 4 photons and the one thread that takes the last n %
    4 photons cover every photon of a row exactly once; 16-byte loads
    exactly when every row of phases (and weights) starts on a 16-byte
    boundary; the partial scratch (g, chunks, blocks, 2 chunk)."""
    from pint_tpu_torch.kernels import harmonics as hs

    w_ptr = None if weights == "none" else 1024
    w_stride = n if weights == "per-row" else 0
    plan = hs.harmonic_plan(g, n, m, 512, w_ptr, w_stride, resident)
    assert len(plan) == len(hs.PlanArray())
    pg, pn, pm, kc, nchunks, nb, vec, ws = plan
    assert (pg, pn, pm, ws) == (g, n, m, w_stride)
    assert kc in hs.CHUNKS
    if m <= max(hs.CHUNKS):
        assert kc >= m and all(c < m for c in hs.CHUNKS if c < kc)
        assert nchunks == 1
    else:
        assert kc == max(hs.CHUNKS)
    k = np.zeros(m, dtype=int)
    for chunk in range(nchunks):  # harmonics.cu: j < min(KC, m - k0)
        for j in range(min(kc, m - chunk * kc)):
            k[chunk * kc + j] += 1
    assert (k == 1).all()
    need = -(-(-(-n // hs.PHOTONS)) // hs.THREADS)
    assert 1 <= nb <= need
    assert g * nchunks * nb <= max(resident, g * nchunks)
    if need * g * nchunks <= resident:
        assert nb == need
    stride = nb * hs.THREADS
    nq = n // hs.PHOTONS
    if n <= 100_000:  # the kernel's loop, thread by thread
        seen = np.zeros(n, dtype=int)
        for lin in range(stride):
            for q in range(lin, nq, stride):
                seen[hs.PHOTONS * q:hs.PHOTONS * (q + 1)] += 1
            if lin == nq % stride:
                seen[nq * hs.PHOTONS:] += 1
        assert (seen == 1).all()
    rows_aligned = g == 1 or n % hs.PHOTONS == 0
    assert vec == int(rows_aligned)
    assert hs.harmonic_plan(g, n, m, 516, w_ptr, w_stride, resident)[6] == 0
    if w_ptr is not None:
        assert hs.harmonic_plan(g, n, m, 512, 1028, w_stride,
                                resident)[6] == 0
    assert hs.partial_floats(plan) == g * nchunks * nb * 2 * kc
    assert hs.harmonic_plan(g, n, m, 512, w_ptr, w_stride, resident) == plan


def test_harmonic_sums_cuda_refuses_cpu_tensors():
    from pint_tpu_torch.kernels.harmonics import harmonic_sums_cuda

    before = harmonic_sums_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        harmonic_sums_cuda(torch.zeros(70000, dtype=torch.float32), 4)
    assert harmonic_sums_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("m", [1, 2, 4, 5, 20, 33])
@pytest.mark.parametrize("n", [1, 5, 4095, 8191, 8192 * 3 + 517, 4_000_000])
def test_harmonic_sums_on_card_match_plain(n, m, g):
    """K4 on the card against its plain f32 version, unweighted and
    weighted (per-row and shared weights), at the K4 tolerance; one
    launch per call, two launches bitwise equal. The instantiations the
    photon path uses (m = 2, 4, 20) at their edges: one photon, n not a
    multiple of the 4 photons a thread takes, fewer photons than a wave
    of threads, rows that are not 16-byte aligned (g = 3, n % 4 != 0)."""
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
@pytest.mark.parametrize("m", [2, 4, 20])
def test_harmonic_sums_on_card_unaligned_rows(m):
    """Phases and weights that start 4 bytes past a 16-byte boundary
    take the 4-byte loads and give the plain version's sums; the same
    values from aligned storage give bitwise the same result as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.kernels import harmonics as hs

    rng = np.random.default_rng(m)
    n = 70_000
    buf = torch.as_tensor(rng.random((2, n + 1)), dtype=torch.float32,
                          device="cuda")
    ph, w = buf[0, 1:], buf[1, 1:]
    assert ph.data_ptr() % 16 == 4 and not hs.copies_16_bytes(
        1, n, ph.data_ptr())
    for wt in (None, w):
        out = hs.harmonic_sums_cuda(ph, m, wt)
        ref = hs.harmonic_sums_plain(ph, m, wt)
        aligned = hs.harmonic_sums_cuda(
            ph.clone(), m, None if wt is None else wt.clone())
        torch.cuda.synchronize()
        for a, r, b in zip(out, ref, aligned):
            assert (a - r).abs().max().item() < _k4_tol(n)
            assert torch.equal(a, b)


# the photon phases where the recurrence's ~k^2 amplification of an error
# in cos(theta) is worst (theta near 0, pi/2, pi, 3 pi/2), and seeded ones
def _rounding_phases(rng, rows):
    near = [np.float32(c) + np.float32(2.0 ** -24) * rng.integers(
        -2000, 2000, rows // 8) for c in (0.0, 0.25, 0.5, 0.75)]
    ph = np.concatenate(near + [rng.random(rows)]).astype(np.float32)
    return ph[(ph >= 0) & (ph < 1)][:rows]


@pytest.mark.cuda
def test_harmonic_c1_s1_correctly_rounded_on_card():
    """Through the public entry: 65,535 rows of one photon at m = 1, so
    each row's C_1 and S_1 are that photon's f32 cos(theta) and
    sin(theta), exactly, in f64. They equal the plain version's
    correctly rounded values (f64 cos/sin rounded to f32), seeded phases
    in [0, 1) and phases within 2000 f32 steps of 0, 1/4, 1/2 and 3/4.
    Each side takes its f64 value from a different routine, so a
    double-rounding tie (an f64 value within an ulp of an f32 rounding
    boundary, ~1 in 2^28 values) may round the two apart: at most 2 of
    the 131,070 values may differ, by one f32 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pint_tpu_torch.kernels.harmonics import (harmonic_sums_cuda,
                                                  harmonic_sums_plain)

    rows = 65535
    ph = _rounding_phases(np.random.default_rng(12), rows)
    assert len(ph) == rows
    x = torch.as_tensor(ph, device="cuda").reshape(rows, 1)
    c, s = harmonic_sums_cuda(x, 1)
    pc, ps = harmonic_sums_plain(x, 1)
    torch.cuda.synchronize()
    assert c.shape == s.shape == (rows, 1)
    differ = 0
    for a, b in ((c, pc), (s, ps)):
        a32 = a.to(torch.float32)
        assert torch.equal(a32.double(), a)  # an f32 value, exactly
        bad = a32 != b.to(torch.float32)
        differ += int(bad.sum())
        ulps = (a32[bad].view(torch.int32) - b.to(torch.float32)[bad]
                .view(torch.int32)).abs()
        assert bool((ulps <= 1).all())
    assert differ <= 2


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
