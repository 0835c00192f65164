"""The inversion engine: gradient descent on the velocity model.

Counterpart of ``red_diffeq_tpu/core/inversion.py:34-75, 266-``: each step
perturbs the model by ``sigma_x0`` noise (diffusion regularisation only),
crops the 1px pad before the solver, takes the per-sample L1 plus lambda
times the regulariser, updates with Adam under a cosine-decay learning
rate, clamps to [-1, 1], and records MAE, RMSE and SSIM of the cropped
result. The optimizer is the arithmetic of ``optax.adam`` with
``optax.cosine_decay_schedule(lr, ts)``, so the first update uses ``lr``.
Each step's draws (the ``sigma_x0`` noise, the RED timestep and the RED
noise) come from a ``torch.Generator`` unless given explicitly.
"""
import math
from typing import Callable, Dict, Optional

import torch

from red_diffeq_tpu_torch.core.losses import observation_loss, total_loss
from red_diffeq_tpu_torch.core.metrics import calculate_metrics
from red_diffeq_tpu_torch.regularization.base import make_reg_fn
from red_diffeq_tpu_torch.utils.data_trans import v_normalize
from red_diffeq_tpu_torch.utils.device import resolve_device

_VALID_REG = ('diffusion', 'l2', 'tv', 'hybrid', None)
_F32 = torch.float32


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha=0)`` in
    float32: lr(k) = init * 0.5 * (1 + cos(pi * min(k, decay) / decay))."""

    def schedule(count: int) -> torch.Tensor:
        c = torch.tensor(min(count, decay_steps), dtype=_F32)
        decayed = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return torch.tensor(init_value, dtype=_F32) * decayed

    return schedule


class Adam:
    """``optax.adam(schedule)`` (b1 0.9, b2 0.999, eps 1e-8 added after the
    square root) on one tensor, as a pure update."""

    def __init__(self, schedule: Callable[[int], torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: torch.Tensor) -> Dict:
        return {'count': 0, 'mu': torch.zeros_like(params),
                'nu': torch.zeros_like(params)}

    def update(self, grads: torch.Tensor, state: Dict):
        """Returns (updates, new_state); apply with ``params + updates``."""
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grads + b1 * state['mu']
        nu = (1 - b2) * (grads * grads) + b2 * state['nu']
        count = state['count'] + 1
        bc1 = 1 - torch.tensor(b1, dtype=_F32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=_F32) ** count
        mu_hat = mu / bc1.to(mu.device)
        nu_hat = nu / bc2.to(nu.device)
        updates = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        step_size = -self.schedule(state['count'])
        updates = updates * step_size.to(updates.device)
        return updates, {'count': count, 'mu': mu, 'nu': nu}


def make_inversion_step(fwi_fn: Callable, reg_fn: Callable, optimizer: Adam,
                        reg_lambda: float, sigma_x0: float,
                        is_diffusion: bool):
    """Build one update step
    ``step(mu, opt_state, *, y, mask, mu_true_norm, x0_noise=None, t=None,
    reg_noise=None, generator=None) -> (mu, opt_state, metrics)``."""

    def step(mu, opt_state, *, y, mask, mu_true_norm, x0_noise=None, t=None,
             reg_noise=None, generator=None):
        mu_p = mu.detach().requires_grad_(True)
        if is_diffusion:
            if x0_noise is None:
                x0_noise = torch.randn(mu.shape, generator=generator,
                                       device=mu.device, dtype=mu.dtype)
            x0_pred = mu_p + sigma_x0 * x0_noise
        else:
            x0_pred = mu_p
        predicted = fwi_fn(x0_pred[:, :, 1:-1, 1:-1])
        obs = observation_loss(predicted, y, mask)
        reg, t = reg_fn(x0_pred, t=t, noise=reg_noise, generator=generator)
        tot = total_loss(obs, reg, reg_lambda)
        grads, = torch.autograd.grad(tot.sum(), mu_p)

        updates, opt_state = optimizer.update(grads, opt_state)
        mu = (mu + updates).clamp(-1.0, 1.0)

        mae, rmse, ssim_val = calculate_metrics(mu[:, :, 1:-1, 1:-1],
                                                mu_true_norm)
        metrics = {
            'total_losses': tot.detach(), 'obs_losses': obs.detach(),
            'reg_losses': reg.detach(), 'mae': mae, 'rmse': rmse,
            'ssim': ssim_val,
        }
        if t is not None:
            metrics['t'] = t
        return mu, opt_state, metrics

    return step


class InversionEngine:
    """Drives the velocity-model optimisation on ``device`` (default
    ``'cuda'``; without a card it raises unless ``device='cpu'``).
    ``diffusion_model`` is a GaussianDiffusion bundle, or None when no
    diffusion regularisation is used."""

    def __init__(self, diffusion_model=None,
                 regularization: Optional[str] = None,
                 use_time_weight: bool = False, sigma_x0: float = 0.0001,
                 fixed_timestep: Optional[int] = None, device=None):
        if regularization not in _VALID_REG + ('none',):
            raise ValueError(f'Unknown regularization: {regularization}')
        self.device = resolve_device(device)
        self.diffusion_model = diffusion_model
        self.regularization = regularization
        self.use_time_weight = use_time_weight
        self.sigma_x0 = sigma_x0
        self.fixed_timestep = fixed_timestep

    def optimize(self, mu, mu_true, y, fwi_forward, ts: int = 300,
                 lr: float = 0.03, reg_lambda: float = 0.01,
                 regularization: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        """Run ``ts`` steps; returns (mu_cropped, per-sample metric curves).

        ``mu``: initial model, padded (B, 1, H+2, W+2), in [-1, 1].
        ``mu_true``: ground truth in m/s, (B, 1, H, W).
        ``y``: observed seismograms (B, ns, nt, ng).
        ``generator``: source of every step's draws; a generator on the
        engine's device seeded with 0 when None."""
        if mu.shape[0] != y.shape[0]:
            raise ValueError(
                'Batch size mismatch between velocity and seismic data')
        if regularization not in _VALID_REG:
            raise ValueError(f'Unknown regularization: {regularization}')
        if fwi_forward is None or not callable(fwi_forward):
            raise ValueError(
                'fwi_forward must be a callable forward modeling function')
        reg_name = (regularization if regularization is not None
                    else self.regularization)
        is_diffusion = reg_name == 'diffusion'
        if is_diffusion and self.diffusion_model is None:
            raise ValueError(
                "Diffusion model required for 'diffusion' regularization")

        dev = self.device
        mu = torch.as_tensor(mu, dtype=_F32, device=dev)
        mu_true_norm = v_normalize(torch.as_tensor(mu_true, dtype=_F32,
                                                   device=dev))
        y = torch.as_tensor(y, dtype=_F32, device=dev)
        mask = torch.ones_like(y)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)

        reg_fn = make_reg_fn(reg_name, self.diffusion_model,
                             use_time_weight=self.use_time_weight,
                             fixed_timestep=self.fixed_timestep)
        optimizer = Adam(cosine_decay_schedule(lr, ts))
        step = make_inversion_step(fwi_forward, reg_fn, optimizer,
                                   reg_lambda, self.sigma_x0, is_diffusion)
        opt_state = optimizer.init(mu)
        history = []
        for _ in range(ts):
            mu, opt_state, m = step(mu, opt_state, y=y, mask=mask,
                                    mu_true_norm=mu_true_norm,
                                    generator=generator)
            history.append(m)

        keys = ('total_losses', 'obs_losses', 'reg_losses', 'ssim', 'mae',
                'rmse')
        metrics = {k: torch.stack([h[k] for h in history]).cpu().numpy()
                   for k in keys}
        per_model = [{k: list(metrics[k][:, i]) for k in keys}
                     for i in range(mu.shape[0])]
        return mu[:, :, 1:-1, 1:-1], per_model
