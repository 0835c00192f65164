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
