"""Ensemble MCMC sampler: the Goodman & Weare affine-invariant stretch
move, on the device (counterpart of the JAX package's ``sampler.py``).

(reference: src/pint/sampler.py::EmceeSampler — a thin wrapper around
the external ``emcee`` package, which runs its walkers on the host. The
same algorithm here evaluates every moving walker's posterior in one
``torch.func.vmap`` on the device.)

The step loop makes no host sync: the draws come from a
``torch.Generator`` on the device, the chain is written into
preallocated device tensors and the accept count stays on the device
until the loop has ended.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import DTYPE, resolve_device


def _generator_draws(gen, device):
    """The default source of a half-step's draws: (u, idx, v) with u,
    v ~ U[0, 1) (float64) and idx ~ U{0..n_others-1}, from ``gen``."""
    def draw(n_movers, n_others):
        u = torch.rand(n_movers, generator=gen, dtype=DTYPE, device=device)
        idx = torch.randint(0, n_others, (n_movers,), generator=gen,
                            device=device)
        v = torch.rand(n_movers, generator=gen, dtype=DTYPE, device=device)
        return u, idx, v
    return draw


def run_ensemble(logpost, x0, n_steps, seed=0, a=2.0, thin=1, device="cuda",
                 _draws=None):
    """Affine-invariant ensemble MCMC.

    logpost: (d,) tensor -> scalar log-posterior tensor, vmap-safe.
    x0: (n_walkers, d) initial positions; n_walkers even, >= 2*d+2.
    Returns (chain (n_kept, n_walkers, d), logpost_chain, accept_frac)
    as numpy arrays and a float.

    The red/black split: each half moves by stretch proposals drawn
    against the other half, so the walkers of a half are independent
    and one vmap evaluates them (Goodman & Weare 2010; Foreman-Mackey
    et al. 2013 sec. 3). A NaN posterior is rejected like -inf.
    Thinning is folded into the loop: n_steps rounds up to a multiple
    of thin and only every thin-th state is kept. The draws of each
    half-step come from ``_draws(n_movers, n_others) -> (u, idx, v)``,
    by default a ``torch.Generator`` on ``device`` seeded with
    ``seed``; the parameter is the seam through which a test feeds
    another package's draws.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x0, dtype=DTYPE).to(dev)
    n_w = x.shape[0]
    if n_w % 2:
        raise ValueError("need an even number of walkers")
    thin = max(int(thin), 1)
    if thin > n_steps:
        raise ValueError(f"thin={thin} exceeds n_steps={n_steps}")
    n_kept = -(-n_steps // thin)
    if _draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        _draws = _generator_draws(gen, dev)
    v_logpost_raw = torch.func.vmap(logpost)

    def v_logpost(xs):
        lp = v_logpost_raw(xs)
        return torch.where(torch.isnan(lp), torch.full_like(lp, -math.inf),
                           lp)

    chain, lp_chain, n_acc = _walk(v_logpost, x, v_logpost(x), n_kept, thin,
                                   a, _draws)
    accept_frac = float(n_acc) / (n_kept * thin * n_w)
    return chain.cpu().numpy(), lp_chain.cpu().numpy(), accept_frac


def _walk(v_logpost, x, lp, n_kept, thin, a, draws):
    """The step loop of run_ensemble: (chain, lnprob chain, accept
    count), all left on the device; nothing in it waits for the host."""
    n_w, d = x.shape
    half = n_w // 2

    def half_step(movers, movers_lp, others):
        u, idx, v = draws(movers.shape[0], others.shape[0])
        # z ~ g(z) propto 1/sqrt(z) on [1/a, a]
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        partners = others[idx]
        prop = partners + z[:, None] * (movers - partners)
        prop_lp = v_logpost(prop)
        ln_accept = (d - 1.0) * torch.log(z) + prop_lp - movers_lp
        acc = torch.log(v) < ln_accept
        new = torch.where(acc[:, None], prop, movers)
        new_lp = torch.where(acc, prop_lp, movers_lp)
        return new, new_lp, acc

    chain = torch.empty((n_kept, n_w, d), dtype=DTYPE, device=x.device)
    lp_chain = torch.empty((n_kept, n_w), dtype=DTYPE, device=x.device)
    n_acc = torch.zeros((), dtype=torch.int64, device=x.device)
    for k in range(n_kept):
        for _ in range(thin):
            first, first_lp, acc_a = half_step(x[:half], lp[:half], x[half:])
            second, second_lp, acc_b = half_step(x[half:], lp[half:], first)
            x = torch.cat([first, second])
            lp = torch.cat([first_lp, second_lp])
            n_acc = n_acc + acc_a.sum() + acc_b.sum()
        chain[k] = x
        lp_chain[k] = lp
    return chain, lp_chain, n_acc


class EnsembleSampler:
    """Object API shaped like the reference's EmceeSampler
    (reference: sampler.py::EmceeSampler — init_pos sphere around a
    start vector, run_mcmc, chain access)."""

    def __init__(self, logpost, n_walkers, ndim, seed=0, device="cuda"):
        self.logpost = logpost
        self.n_walkers = int(n_walkers)
        self.ndim = int(ndim)
        self.seed = seed
        self.device = device
        self.chain = None
        self.lnprob = None
        self.accept_frac = None

    def get_initial_pos(self, x0, scale):
        """Gaussian ball around x0 (reference: EmceeSampler.get_initial_pos),
        drawn on the host with numpy as in the JAX package."""
        rng = np.random.default_rng(self.seed)
        x0 = np.asarray(x0, float)
        scale = np.broadcast_to(np.asarray(scale, float), x0.shape)
        return x0[None, :] + scale[None, :] * rng.standard_normal(
            (self.n_walkers, self.ndim))

    def run_mcmc(self, pos0, n_steps, thin=1):
        self.chain, self.lnprob, self.accept_frac = run_ensemble(
            self.logpost, pos0, n_steps, seed=self.seed, thin=thin,
            device=self.device)
        return self.chain

    def flatchain(self, burn=0):
        c = self.chain[burn:]
        return c.reshape(-1, self.ndim)
