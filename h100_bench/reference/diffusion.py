"""Plain reference of the diffusion prior's arithmetic: the sigmoid beta
schedule of 1000 steps (coefficients in float64, kept as float32), the
forward process, the ``pred_noise`` model's clipped x0 and re-derived
noise, RED-DiffEq's score (unpatched, or over overlapping square windows
for a model wider than the denoiser) and the training loss.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F


class Schedule:
    def __init__(self, timesteps: int, device):
        t = np.linspace(0, timesteps, timesteps + 1) / timesteps

        def sigmoid(x):
            return 1.0 / (1.0 + np.exp(-x))

        v0, v1 = sigmoid(-3.0), sigmoid(3.0)
        ac = (-sigmoid(t * 6.0 - 3.0) + v1) / (v1 - v0)
        ac = ac / ac[0]
        betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
        ac = np.cumprod(1.0 - betas)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.timesteps = timesteps
        self.sqrt_ac = f32(np.sqrt(ac))
        self.sqrt_1m_ac = f32(np.sqrt(1.0 - ac))
        self.sqrt_recip_ac = f32(np.sqrt(1.0 / ac))
        self.sqrt_recipm1_ac = f32(np.sqrt(1.0 / ac - 1))

    @staticmethod
    def at(a, t):
        return a[t].reshape(-1, 1, 1, 1)

    def q_sample(self, x0, t, noise):
        return self.at(self.sqrt_ac, t) * x0 + self.at(self.sqrt_1m_ac, t) * noise


def score(unet, sched: Schedule, x, t, noise):
    """eps_hat - eps at ``x`` diffused to ``t`` with ``noise``: the model's
    x0 clipped to [-1, 1] and its noise re-derived from it."""
    with torch.no_grad():
        x_t = sched.q_sample(x, t, noise)
        out = unet(x_t, t)
        x0 = (sched.at(sched.sqrt_recip_ac, t) * x_t
              - sched.at(sched.sqrt_recipm1_ac, t) * out).clamp(-1.0, 1.0)
        eps = ((sched.at(sched.sqrt_recip_ac, t) * x_t - x0)
               / sched.at(sched.sqrt_recipm1_ac, t))
        return eps - noise


def windows(width: int, height: int):
    """[(start, end)]: ceil(width / height) windows of side ``height``
    spread evenly over ``width``, the last at the right edge."""
    k = math.ceil(width / height)
    if k == 1:
        return [(0, width)]
    s = (width - height) / (k - 1)
    return [(int(i * s), min(int(i * s) + height, width)) if i < k - 1
            else (width - height, width) for i in range(k)]


def red_loss(unet, sched, x, t, noise, input_size: int):
    """RED's per-sample loss mean(score * x) of the padded model ``x``
    (B, 1, H+2, W+2), differentiable in ``x`` through its linear factor,
    and its scale mean(|score * x|). A model wider than ``input_size`` is
    scored on windows of the unpadded model, each zero-padded, blended
    with weight 0.5 where two overlap; ``noise`` then has the unpadded
    shape."""
    b = x.shape[0]
    if x.shape[-1] <= input_size and x.shape[-2] <= input_size:
        field = score(unet, sched, x.detach(), t, noise) * x
    else:
        inner = x[:, :, 1:-1, 1:-1]
        h, w = inner.shape[-2:]
        pos = windows(w, h)
        k = len(pos)
        xs = torch.cat([F.pad(inner[..., a:e].detach(), (1, 1, 1, 1))
                        for a, e in pos])
        ns = torch.cat([F.pad(noise[..., a:e], (1, 1, 1, 1)) for a, e in pos])
        grads = score(unet, sched, xs, t.repeat(k), ns)[:, :, 1:-1, 1:-1]
        grads = grads.reshape(k, b, *grads.shape[1:])
        acc = torch.zeros_like(inner)
        wsum = torch.zeros_like(inner)
        for i, (a, e) in enumerate(pos):
            wt = torch.ones(e - a, dtype=x.dtype, device=x.device)
            if i > 0:
                wt[:pos[i - 1][1] - a] = 0.5
            if i < k - 1:
                wt[pos[i + 1][0] - a:] = 0.5
            acc[..., a:e] += grads[i, ..., :e - a] * wt
            wsum[..., a:e] += wt
        field = acc / wsum.clamp_min(1e-8) * inner
    flat = field.reshape(b, -1)
    return flat.mean(dim=1), flat.detach().abs().mean(dim=1)


def denoising_loss(unet, sched, img01, t, noise):
    """The training loss of images in [0, 1]: the batch mean of each
    image's mean squared error of the predicted noise (``pred_noise``
    weighs every timestep 1)."""
    x0 = img01 * 2.0 - 1.0
    out = unet(sched.q_sample(x0, t, noise), t)
    return ((out - noise) ** 2).mean(dim=(1, 2, 3)).mean()
