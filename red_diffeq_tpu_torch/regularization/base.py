"""Regularisation dispatch.

Counterpart of ``red_diffeq_tpu/regularization/base.py``: a config string
becomes ``reg_fn(mu, t=None, noise=None, generator=None) ->
(per_sample_loss, t)``, with ``t`` the diffusion timesteps (None for other
methods). Like the reference, the name 'hybrid' has no implementation and
silently yields zero regularisation. TV and Tikhonov are not ported yet.
"""
from typing import Optional


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
    if regularization_type in ('l2', 'tv'):
        raise NotImplementedError(
            f'{regularization_type!r} regularization is not ported yet')
    # None / 'none' / unimplemented 'hybrid' -> zero regularisation.
    return lambda mu, t=None, noise=None, generator=None: (
        mu.new_zeros(mu.shape[0]), None)
