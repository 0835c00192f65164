"""Regularisation dispatch.

Counterpart of ``red_diffeq_tpu/regularization/base.py``: a config string
becomes ``reg_fn(mu, t=None, noise=None, generator=None) ->
(per_sample_loss, t)``, with ``t`` the diffusion timesteps (None for other
methods). 'diffusion' takes the patched RED when the padded model is wider
or taller than the denoiser's input. Like the reference, the name 'hybrid'
has no implementation and silently yields zero regularisation.
"""
from typing import Optional

from red_diffeq_tpu_torch.regularization.benchmark import (
    tikhonov_loss, total_variation_loss,
)


def make_reg_fn(regularization_type: Optional[str], diffusion=None,
                use_time_weight: bool = False,
                fixed_timestep: Optional[int] = None):
    if regularization_type == 'diffusion':
        if diffusion is None:
            raise ValueError(
                "Diffusion model required for 'diffusion' regularization")
        from red_diffeq_tpu_torch.regularization.red import make_red_reg_fn
        return make_red_reg_fn(diffusion, use_time_weight=use_time_weight,
                               fixed_timestep=fixed_timestep)
    if regularization_type == 'l2':
        return lambda mu, t=None, noise=None, generator=None: (
            tikhonov_loss(mu), None)
    if regularization_type == 'tv':
        return lambda mu, t=None, noise=None, generator=None: (
            total_variation_loss(mu), None)
    # None / 'none' / unimplemented 'hybrid' -> zero regularisation.
    return lambda mu, t=None, noise=None, generator=None: (
        mu.new_zeros(mu.shape[0]), None)


class RegularizationMethod:
    """Stateful shim with the reference class's interface."""

    def __init__(self, regularization_type: Optional[str],
                 diffusion_model=None, use_time_weight: bool = False,
                 sigma_x0: float = 0.0001,
                 fixed_timestep: Optional[int] = None):
        self.regularization_type = regularization_type
        self.diffusion_model = diffusion_model
        self.use_time_weight = use_time_weight
        self.sigma_x0 = sigma_x0
        self.fixed_timestep = fixed_timestep
        self._fn = make_reg_fn(regularization_type, diffusion_model,
                               use_time_weight, fixed_timestep)

    def get_reg_loss(self, mu, generator=None, t=None, noise=None):
        """(per-sample loss, diffusion timesteps or None); the RED draws
        ``t`` and ``noise`` come from ``generator`` unless given (the JAX
        method's ``key``)."""
        return self._fn(mu, t=t, noise=noise, generator=generator)
