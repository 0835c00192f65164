"""Plain reference of one RED-DiffEq inversion step and what it reports.

The velocity model lives in [-1, 1], zero-padded by one cell to the
denoiser's grid. A step perturbs it by ``sigma_x0`` times its noise,
propagates the unpadded part, takes each sample's L1 misfit to the
observations plus lambda times RED's loss, differentiates, applies
``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 after the root) under a cosine
decay of the rate to 0 over ``ts`` steps, clamps to [-1, 1], and reports
the losses and the MAE, RMSE and SSIM of the new model against the truth.
The initial model is the truth blurred by a Gaussian of ``sigma`` cells.
"""
import math

import numpy as np
import torch

from h100_bench.reference import diffusion, solver


def initial_model(v_true_ms: np.ndarray, sigma: float) -> np.ndarray:
    """(B, 1, H, W) m/s -> (B, 1, H+2, W+2): the normalised truth blurred
    (reflecting edges, radius 4 sigma) and zero-padded."""
    v = solver.v_normalize(np.asarray(v_true_ms, np.float64))
    radius = int(4.0 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    k /= k.sum()
    for axis in (2, 3):
        pad = [(0, 0)] * 4
        pad[axis] = (radius, radius)
        v = np.apply_along_axis(lambda m: np.convolve(m, k, mode='valid'),
                                axis, np.pad(v, pad, mode='symmetric'))
    return np.pad(v.astype(np.float32), ((0, 0), (0, 0), (1, 1), (1, 1)))


def l1(pred, obs):
    err = obs - pred
    return torch.where(err >= 0, err, -err).mean(dim=(1, 2, 3))


def rate(lr: float, ts: int, count: int) -> torch.Tensor:
    c = torch.tensor(float(min(count, ts)), dtype=torch.float32)
    return lr * (0.5 * (1 + torch.cos(math.pi * c / ts)))


def _window(size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float64)
    g = np.exp(-((x - size // 2) ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a, b, ar):
    """Per-sample SSIM of (B, 1, H, W) images in [0, 1]: an 11x11
    Gaussian window (sigma 1.5) with zero padding."""
    w = torch.from_numpy(_window()).to(a.device)[None, None]

    def filt(x):
        return ar.conv2d(x, w, padding=5)

    mu1, mu2 = filt(a), filt(b)
    s1 = filt(ar.mul(a, a)) - ar.mul(mu1, mu1)
    s2 = filt(ar.mul(b, b)) - ar.mul(mu2, mu2)
    s12 = filt(ar.mul(a, b)) - ar.mul(mu1, mu2)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * ar.mul(mu1, mu2) + c1) * (2 * s12 + c2)) / (
        (ar.mul(mu1, mu1) + ar.mul(mu2, mu2) + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


def fit(mu, target, ar):
    """(mae, rmse, ssim) per sample of the unpadded ``mu`` and truth."""
    d = mu - target
    return (d.abs().mean(dim=(1, 2, 3)),
            ar.mul(d, d).mean(dim=(1, 2, 3)).sqrt(),
            ssim((mu + 1) / 2, (target + 1) / 2, ar))


class Problem:
    """One job's fixed parts: the configuration's ``pde`` context, its
    observations and truth (normalised), the prior (U-Net and schedule),
    lambda, ``sigma_x0``, the rate and the steps."""

    def __init__(self, ctx, y, target, unet, sched, reg_lambda, sigma_x0, lr,
                 ts, input_size):
        self.ctx, self.y, self.target = ctx, y, target
        self.unet, self.sched = unet, sched
        self.reg_lambda, self.sigma_x0 = reg_lambda, sigma_x0
        self.lr, self.ts, self.input_size = lr, ts, input_size


def step(p: Problem, mu, m, v, count: int, draws, ar):
    """Step ``count`` (0-based) from the padded ``mu`` and Adam's moments.
    Returns (mu, m, v, report): the report holds the losses at ``mu`` and
    RED's scale, and the fit of the new model."""
    mu_p = mu.detach().requires_grad_(True)
    x0 = mu_p + p.sigma_x0 * draws['x0_noise']
    obs = l1(solver.forward(x0[:, :, 1:-1, 1:-1], p.ctx, ar), p.y)
    reg, scale = diffusion.red_loss(p.unet, p.sched, x0, draws['t'],
                                    draws['reg_noise'], p.input_size)
    tot = obs + p.reg_lambda * reg
    g, = torch.autograd.grad(tot.sum(), mu_p)
    m = 0.1 * g + 0.9 * m
    v = 0.001 * (g * g) + 0.999 * v
    k = float(count + 1)
    upd = (m / (1 - 0.9 ** torch.tensor(k))) / (
        torch.sqrt(v / (1 - 0.999 ** torch.tensor(k))) + 1e-8)
    mu = (mu + upd * -rate(p.lr, p.ts, count).to(mu.device)).clamp(-1.0, 1.0)
    mae, rmse, s = fit(mu[:, :, 1:-1, 1:-1], p.target, ar)
    report = dict(obs=obs.detach(), reg=reg.detach(), scale=scale,
                  tot=tot.detach(), mae=mae, rmse=rmse, ssim=s)
    return mu.detach(), m, v, report
