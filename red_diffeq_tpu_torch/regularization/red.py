"""RED-DiffEq: Regularization-by-Denoising with a diffusion prior.

Counterpart of ``red_diffeq_tpu/regularization/red.py``. The velocity model
is noised to a random timestep, denoised once by the U-Net, and the
residual score (eps_hat - eps), detached, multiplies the model linearly, so
d(reg)/d(mu) = mean(score) without backpropagation through the U-Net.

For models wider than the denoiser input (Marmousi and Overthrust, 70x190)
overlapping square windows are scored in one batched U-Net call of k*B
windows and blended with weight 0.5 on the overlaps.

:class:`RED_DiffEq_POST_PROCESS` polishes a final model with the
deterministic posterior-mean chain of the same prior.
"""
import math
from typing import List, Optional, Tuple

import torch

from red_diffeq_tpu_torch.utils.diffusion_utils import (
    diffusion_crop, diffusion_pad, extract,
)


def calculate_patches(width: int, height: int
                      ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Overlapping square-window layout: ([(start_x, end_x), ...],
    [overlap_i]) for k = ceil(width / height) windows of side ``height``
    spread evenly over ``width``, the last pinned to the right edge."""
    m, n = height, width
    k = math.ceil(n / m)
    if k == 1:
        return [(0, n)], []
    s = (n - m) / (k - 1)
    positions = []
    for i in range(k):
        if i == k - 1:
            positions.append((n - m, n))
        else:
            start = int(i * s)
            positions.append((start, min(start + m, n)))
    overlaps = [positions[i][1] - positions[i + 1][0] for i in range(k - 1)]
    return positions, overlaps


def _score_residual(diffusion, mu, t, noise):
    """One RED evaluation: q_sample, one denoiser call and the re-derived
    noise prediction; returns (eps_hat - eps), detached."""
    with torch.no_grad():
        x_t = diffusion.q_sample(mu, t, noise)
        preds = diffusion.model_predictions(
            x_t, t, clip_x_start=True, rederive_pred_noise=True)
        return (preds.pred_noise - noise).detach()


def _time_weight(diffusion, tensor, t):
    """w(t) = sqrt((1 - gamma_t) / gamma_t)."""
    gamma = extract(diffusion.schedule.alphas_cumprod, t, tensor.ndim)
    return tensor * torch.sqrt((1.0 - gamma) / gamma)


class RED_DiffEq:
    """The RED regulariser over a GaussianDiffusion bundle. ``sigma_x0`` is
    kept for the JAX class's signature, as there: the engine perturbs the
    model by it before the regulariser sees it."""

    def __init__(self, diffusion_model, use_time_weight: bool = False,
                 sigma_x0: float = 0.0001,
                 fixed_timestep: Optional[int] = None):
        self.diffusion_model = diffusion_model
        self.use_time_weight = use_time_weight
        self.sigma_x0 = sigma_x0
        self.fixed_timestep = fixed_timestep
        self.input_size = diffusion_model.image_size[0]

    def _draws(self, shape, t, noise, generator, device, dtype):
        """``t`` (B,) and ``noise`` of ``shape``, each drawn from
        ``generator`` (t first) unless given."""
        if t is None:
            max_t = (self.fixed_timestep if self.fixed_timestep is not None
                     else self.diffusion_model.num_timesteps)
            t = torch.randint(0, max_t, (shape[0],), generator=generator,
                              device=device)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device,
                                dtype=dtype)
        return t, noise

    def get_reg_loss(self, mu, generator=None, t=None, noise=None):
        """Unpatched RED loss. ``t`` (B,) and ``noise`` (shape of ``mu``)
        are drawn from ``generator`` unless given. Returns
        (reg_per_sample, gradient_per_sample, t)."""
        b = mu.shape[0]
        t, noise = self._draws(mu.shape, t, noise, generator, mu.device,
                               mu.dtype)
        gradient_field = _score_residual(self.diffusion_model, mu, t, noise)
        reg_field = gradient_field * mu
        if self.use_time_weight:
            reg_field = _time_weight(self.diffusion_model, reg_field, t)
        return (reg_field.reshape(b, -1).mean(dim=1),
                gradient_field.reshape(b, -1).mean(dim=1), t)

    def get_reg_loss_patched(self, mu, generator=None, t=None, noise=None):
        """Patched RED loss for a padded model ``mu`` (B, C, H+2, W+2)
        wider than the denoiser. ``noise`` has the unpadded shape (B, C, H,
        W); each window of it is zero-padded like the model's, so its pad
        ring is zero. The k windows go to the U-Net as one batch of k*B,
        window-major, with ``t`` repeated k times to match. The scores are
        cropped, weighted (0.5 on overlaps) and divided by the summed
        weights. Returns (reg_per_sample, gradient_per_sample, t)."""
        d = self.diffusion_model
        mu_unpadded = diffusion_crop(mu)
        b, c, h, w = mu_unpadded.shape
        positions, overlaps = calculate_patches(w, h)
        k = len(positions)
        t, noise = self._draws(mu_unpadded.shape, t, noise, generator,
                               mu.device, mu.dtype)

        x_stack = torch.cat([diffusion_pad(mu_unpadded[:, :, :, sx:ex])
                             for sx, ex in positions])
        n_stack = torch.cat([diffusion_pad(noise[:, :, :, sx:ex])
                             for sx, ex in positions])
        grad_stack = diffusion_crop(
            _score_residual(d, x_stack, t.repeat(k), n_stack))
        m = positions[0][1] - positions[0][0]
        grad_patches = grad_stack.reshape(k, b, c, h, m)

        gradient_field = torch.zeros_like(mu_unpadded)
        weight_map = torch.zeros_like(mu_unpadded)
        for idx, (sx, ex) in enumerate(positions):
            pw = ex - sx
            weight = torch.ones(pw, dtype=mu.dtype, device=mu.device)
            if idx > 0:
                weight[:overlaps[idx - 1]] = 0.5
            if idx < k - 1:
                weight[pw - overlaps[idx]:] = 0.5
            gradient_field[:, :, :, sx:ex] += grad_patches[idx, :, :, :, :pw] \
                * weight
            weight_map[:, :, :, sx:ex] += weight
        gradient_field = gradient_field / weight_map.clamp_min(1e-8)
        reg_field = gradient_field * mu_unpadded
        if self.use_time_weight:
            reg_field = _time_weight(d, reg_field, t)
        return (reg_field.reshape(b, -1).mean(dim=1),
                gradient_field.reshape(b, -1).mean(dim=1), t)


def make_red_reg_fn(diffusion, use_time_weight: bool = False,
                    fixed_timestep: Optional[int] = None):
    """The engine-facing ``reg_fn(mu, t=None, noise=None, generator=None)
    -> (loss, t)``, patched for a model wider or taller than the denoiser's
    input. ``reg_fn.draws(shape, generator, device, dtype)`` returns the
    (t, noise) that ``reg_fn`` would draw for a model of ``shape``, so that
    a caller can draw for a whole batch and hand each part its slice."""
    red = RED_DiffEq(diffusion, use_time_weight=use_time_weight,
                     fixed_timestep=fixed_timestep)

    def patched(shape):
        return shape[3] > red.input_size or shape[2] > red.input_size

    def reg_fn(mu, t=None, noise=None, generator=None):
        fn = (red.get_reg_loss_patched if patched(mu.shape)
              else red.get_reg_loss)
        reg, _, t = fn(mu, t=t, noise=noise, generator=generator)
        return reg, t

    def draws(shape, generator, device, dtype):
        b, c, h, w = shape
        noise_shape = (b, c, h - 2, w - 2) if patched(shape) else shape
        return red._draws(noise_shape, None, None, generator, device, dtype)

    reg_fn.draws = draws
    return reg_fn


class RED_DiffEq_POST_PROCESS:
    """Deterministic reverse-diffusion polish of a final velocity model:
    noise the [0, 1]-mapped model to timestep ``timesteps`` and run the
    posterior-mean chain back to t = 0, one U-Net call a step (the JAX
    package's one ``lax.scan``): on the card a CUDA graph of the step,
    replayed a step (``GaussianDiffusion._chain``)."""

    def __init__(self, diffusion_model):
        self.diffusion_model = diffusion_model

    @torch.no_grad()
    def diffusion_denoise(self, mu, timesteps: int, generator=None,
                          noise=None):
        """``mu`` in [-1, 1] (B, C, H, W) -> the polished model in [0, 1].
        ``noise`` (shape of ``mu``) is the one forward draw, from
        ``generator`` unless given, made before the chain."""
        d = self.diffusion_model
        if timesteps > d.num_timesteps:
            raise ValueError(
                f"timesteps ({timesteps}) exceeds model's num_timesteps "
                f'({d.num_timesteps})')
        mu01 = (mu + 1.0) / 2.0
        t_full = torch.full((mu.shape[0],), min(timesteps, d.num_timesteps - 1),
                            dtype=torch.long, device=mu.device)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        x_t = d.unnormalize(d.q_sample(d.normalize(mu01), t_full, noise))
        if timesteps <= 0:
            return x_t
        return d._chain('deterministic', x_t,
                        list(range(timesteps - 1, -1, -1)))
