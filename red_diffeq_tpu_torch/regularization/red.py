"""RED-DiffEq: Regularization-by-Denoising with a diffusion prior.

Counterpart of ``red_diffeq_tpu/regularization/red.py``. The velocity model
is noised to a random timestep, denoised once by the U-Net, and the
residual score (eps_hat - eps), detached, multiplies the model linearly, so
d(reg)/d(mu) = mean(score) without backpropagation through the U-Net. The
patched variant for models wider than the denoiser input (Marmousi,
Overthrust) is not ported yet.
"""
from typing import Optional

import torch

from red_diffeq_tpu_torch.utils.diffusion_utils import extract


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
    """The RED regulariser over a GaussianDiffusion bundle."""

    def __init__(self, diffusion_model, use_time_weight: bool = False,
                 fixed_timestep: Optional[int] = None):
        self.diffusion_model = diffusion_model
        self.use_time_weight = use_time_weight
        self.fixed_timestep = fixed_timestep
        self.input_size = diffusion_model.image_size[0]

    def get_reg_loss(self, mu, t=None, noise=None, generator=None):
        """Unpatched RED loss. ``t`` (B,) and ``noise`` (shape of ``mu``)
        are drawn from ``generator`` unless given. Returns
        (reg_per_sample, gradient_per_sample, t)."""
        b = mu.shape[0]
        if t is None:
            max_t = (self.fixed_timestep if self.fixed_timestep is not None
                     else self.diffusion_model.num_timesteps)
            t = torch.randint(0, max_t, (b,), generator=generator,
                              device=mu.device)
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        gradient_field = _score_residual(self.diffusion_model, mu, t, noise)
        reg_field = gradient_field * mu
        if self.use_time_weight:
            reg_field = _time_weight(self.diffusion_model, reg_field, t)
        return (reg_field.reshape(b, -1).mean(dim=1),
                gradient_field.reshape(b, -1).mean(dim=1), t)


def make_red_reg_fn(diffusion, use_time_weight: bool = False,
                    fixed_timestep: Optional[int] = None):
    """The engine-facing ``reg_fn(mu, t=None, noise=None, generator=None)
    -> (loss, t)``."""
    red = RED_DiffEq(diffusion, use_time_weight=use_time_weight,
                     fixed_timestep=fixed_timestep)

    def reg_fn(mu, t=None, noise=None, generator=None):
        h, w = mu.shape[2], mu.shape[3]
        if w > red.input_size or h > red.input_size:
            raise NotImplementedError(
                f'a {h}x{w} model is wider than the {red.input_size}px '
                'denoiser: the patched RED variant is not ported yet')
        reg, _, t = red.get_reg_loss(mu, t=t, noise=noise,
                                     generator=generator)
        return reg, t

    return reg_fn
