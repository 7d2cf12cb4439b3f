"""Exact t-SNE on the card (JAX counterpart deeplearning4j_tpu/plot/
tsne.py; reference plot/Tsne.java: calculate():72, the gains/momentum
update :88-151, the binary-search x2p():238).

Every iteration (Student-t affinities over all pairs, the gradient, the
gains, the momentum) is one `_tsne_step` over [N, N] and [N, 2] tensors
on the points' device; the host loop counts iterations and flips the
early-exaggeration and momentum scalars, and reads the KL every 50
iterations. The perplexity search (`_x2p`) is the JAX package's lock-step
bisection: every row's beta search step runs together, 50 steps with no
data-dependent exit.

The initial embedding y0 is drawn from a `torch.Generator` seeded with
`seed` (on the CPU, then moved), not from JAX's `PRNGKey`: the two
packages start from different points for one seed. `calculate(...,
y0=...)` takes a given start, which is how the tests hold the run
against the JAX package's. t-SNE is chaotic, so two runs from one start
drift apart in the last bits; hold a whole run by its KL and its
neighbourhoods, not its coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device


def _x2p(x, perplexity, iters=50):
    """Conditional Gaussian affinities P(j|i) with each row's variance
    found by bisection on the entropy (Tsne.java x2p:238): all rows
    search together, a fixed `iters` steps. x [N, D] f32 -> P [N, N]."""
    n = x.shape[0]
    sum_x = (x * x).sum(1)
    d2 = (sum_x[:, None] + sum_x[None, :] - 2.0 * x @ x.T).clamp_min(0.0)
    log_u = torch.log(torch.tensor(perplexity, dtype=x.dtype,
                                   device=x.device))
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    def entropy_and_p(beta):
        logits = (-d2 * beta[:, None]).masked_fill(eye, float("-inf"))
        p = torch.softmax(logits, 1)
        # Shannon entropy H = -sum p log p (natural log, as the reference)
        h = -torch.where(p > 0, p * torch.log(p + 1e-30), zero).sum(1)
        return h, p

    beta = torch.ones(n, dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > log_u          # entropy too high -> beta too small
        new_lo = torch.where(too_high, beta, lo)
        new_hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(new_hi), beta * 2.0,
                        (beta + new_hi) / 2.0),
            (new_lo + beta) / 2.0)
        lo, hi = new_lo, new_hi
    _, p = entropy_and_p(beta)
    return p


def _tsne_step(y, iy, gains, p, p_report, momentum, min_gain,
               learning_rate):
    """One t-SNE gradient step with the reference's gains/momentum
    scheme (Tsne.java:124-151). `p` drives the gradient (it may be
    exaggerated); `p_report` is the true P, so the KL reads alike on
    both sides of the exaggeration phase. -> (y, iy, gains, kl)."""
    n = y.shape[0]
    sum_y = (y * y).sum(1)
    num = 1.0 / (1.0 + sum_y[:, None] + sum_y[None, :] - 2.0 * y @ y.T)
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    q = (num / num.sum()).clamp_min(1e-12)
    pq = (p - q) * num                                          # [N, N]
    dy = 4.0 * (torch.diag(pq.sum(1)) - pq) @ y                 # KL grad
    # gains: shrink where the gradient keeps the velocity's sign, grow
    # otherwise
    same_sign = torch.sign(dy) == torch.sign(iy)
    gains = torch.where(same_sign, gains * 0.8, gains + 0.2)
    gains = gains.clamp_min(min_gain)
    iy = momentum * iy - learning_rate * (gains * dy)
    y = y + iy
    y = y - y.mean(0, keepdim=True)
    kl = torch.where(p_report > 0, p_report * torch.log(p_report / q),
                     torch.zeros((), dtype=y.dtype, device=y.device)).sum()
    return y, iy, gains, kl


class Tsne:
    """Exact t-SNE (plot/Tsne.java builder surface: maxIter, perplexity,
    learningRate, stopLyingIteration, the momentum switch at iteration
    20). Runs on `device` (CUDA unless the caller names another)."""

    def __init__(self, max_iter: int = 1000, perplexity: float = 30.0,
                 learning_rate: float = 500.0, initial_momentum: float = 0.5,
                 final_momentum: float = 0.8, momentum_switch: int = 20,
                 stop_lying_iteration: int = 250, exaggeration: float = 4.0,
                 min_gain: float = 0.01, seed: int = 0, device=None):
        self.max_iter = max_iter
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.stop_lying_iteration = stop_lying_iteration
        self.exaggeration = exaggeration
        self.min_gain = min_gain
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_history: list[float] = []

    def initial_y(self, n: int, target_dimensions: int = 2):
        """The start of the embedding: N(0, 1e-4^2) [n, dims] f32 from a
        CPU `torch.Generator` seeded with `seed`."""
        gen = torch.Generator().manual_seed(self.seed)
        return torch.randn((n, target_dimensions), generator=gen) * 1e-4

    def calculate(self, x, target_dimensions: int = 2,
                  perplexity: float | None = None, y0=None) -> np.ndarray:
        """Embed x [N, D] -> [N, target_dimensions] (Tsne.calculate:72),
        from `y0` [N, target_dimensions] when given, else `initial_y`."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to(self.device, torch.float32)
        else:
            x = torch.as_tensor(np.asarray(x, dtype=np.float32),
                                device=self.device)
        n = x.shape[0]
        perp = self.perplexity if perplexity is None else perplexity
        p = _x2p(x, perp)
        p = (p + p.T) / (2.0 * n)                 # symmetrise, normalise
        p = p.clamp_min(1e-12)

        if y0 is None:
            y0 = self.initial_y(n, target_dimensions)
        if not isinstance(y0, torch.Tensor):
            y0 = torch.tensor(np.asarray(y0, dtype=np.float32))
        y = y0.to(self.device, torch.float32)
        iy = torch.zeros_like(y)
        gains = torch.ones_like(y)

        self.kl_history = []
        for i in range(self.max_iter):
            momentum = (self.initial_momentum if i < self.momentum_switch
                        else self.final_momentum)
            lying = i < self.stop_lying_iteration
            p_eff = p * self.exaggeration if lying else p
            y, iy, gains, kl = _tsne_step(
                y, iy, gains, p_eff, p, momentum, self.min_gain,
                self.learning_rate)
            if (i + 1) % 50 == 0:
                self.kl_history.append(float(kl))
        return y.cpu().numpy()

    # reference alias (Tsne.plot -> calculate)
    def fit_transform(self, x, target_dimensions: int = 2) -> np.ndarray:
        return self.calculate(x, target_dimensions)
