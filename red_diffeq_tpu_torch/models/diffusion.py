"""Gaussian diffusion: the schedule, the forward process and the model's
predictions.

Counterpart of ``red_diffeq_tpu/models/diffusion.py:82-267``. Schedule
coefficients are computed in float64 on the host and stored as float32
tensors on the device. Public functions keep the JAX package's
(B, 1, H, W) layout. Sampling and training are not ported yet.
"""
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.utils.device import resolve_device
from red_diffeq_tpu_torch.utils.diffusion_utils import extract


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps: int, start: float = -3, end: float = 3,
                          tau: float = 1.0) -> np.ndarray:
    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start, v_end = sigmoid(start / tau), sigmoid(end / tau)
    ac = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {
    'linear': linear_beta_schedule,
    'cosine': cosine_beta_schedule,
    'sigmoid': sigmoid_beta_schedule,
}


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed fp32 coefficient tensors."""
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor

    @staticmethod
    def create(timesteps: int, beta_schedule: str = 'sigmoid',
               objective: str = 'pred_noise', min_snr_loss_weight: bool = False,
               min_snr_gamma: float = 5.0,
               schedule_fn_kwargs: Optional[dict] = None,
               device='cpu') -> 'DiffusionSchedule':
        betas = _SCHEDULES[beta_schedule](timesteps,
                                          **(schedule_fn_kwargs or {}))
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        snr = ac / (1 - ac)
        clipped_snr = np.minimum(snr, min_snr_gamma) if min_snr_loss_weight \
            else snr
        if objective == 'pred_noise':
            loss_weight = clipped_snr / snr
        elif objective == 'pred_x0':
            loss_weight = clipped_snr
        elif objective == 'pred_v':
            loss_weight = clipped_snr / (snr + 1)
        else:
            raise ValueError(f'unknown objective {objective}')

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return DiffusionSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(
                np.log(np.clip(post_var, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas)
                                     / (1.0 - ac)),
            loss_weight=f32(loss_weight),
        )


class GaussianDiffusion:
    """The U-Net and its schedule on one device (default ``'cuda'``; without
    a card it raises unless ``device='cpu'``)."""

    def __init__(self, model: Unet, *, image_size, timesteps: int = 1000,
                 objective: str = 'pred_noise', beta_schedule: str = 'sigmoid',
                 device=None):
        if objective not in ('pred_noise', 'pred_x0', 'pred_v'):
            raise ValueError(f'unknown objective {objective}')
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.channels = model.channels
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self.image_size = tuple(image_size)
        self.objective = objective
        self.num_timesteps = int(timesteps)
        self.schedule = DiffusionSchedule.create(
            timesteps, beta_schedule, objective, device=self.device)

    def apply_fn(self, x, t):
        """One denoiser forward pass."""
        return self.model(x, t)

    def q_sample(self, x_start, t, noise):
        """Diffuse ``x_start`` to timestep ``t``."""
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        s = self.schedule
        return ((extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def predict_v(self, x_start, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * noise
                - extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * x_start)

    def predict_start_from_v(self, x_t, t, v):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(s.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)

    def model_predictions(self, x, t, clip_x_start=False,
                          rederive_pred_noise=False) -> ModelPrediction:
        out = self.apply_fn(x, t)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start \
            else (lambda v: v)
        if self.objective == 'pred_noise':
            pred_noise = out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
            if clip_x_start and rederive_pred_noise:
                pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.objective == 'pred_x0':
            x_start = clip(out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return ModelPrediction(pred_noise, x_start)
