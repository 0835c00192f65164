"""Data-fidelity and total loss composition.

Counterpart of ``red_diffeq_tpu/core/losses.py``: a per-sample,
optionally mask-normalised L1. Its |x| takes ``jnp.abs``'s gradient at 0
(:func:`abs_jax`): where a predicted sample ties its observation exactly,
the JAX package sends -1/N back through the solver and ``torch.abs``
would send 0. The ties before an arrival (both traces still 0) change no
velocity gradient; a tie inside the field's reach does, and a run that
meets one parts from the JAX package's from there.
"""
from typing import Optional

import torch


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is 1, as ``jnp.abs``'s (``torch.abs``'s is
    0)."""
    return torch.where(x >= 0, x, -x)


def observation_loss(predicted: torch.Tensor, target: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample L1 between predicted and observed seismograms,
    (B, ns, nt, ng) -> (B,). With a mask (1 = observed, 0 = missing
    trace) the mean runs over observed elements only."""
    err = abs_jax(target.float() - predicted.float())
    dims = tuple(range(1, err.ndim))
    if mask is not None:
        num_observed = mask.sum(dim=dims).clamp_min(1.0)
        return (err * mask).sum(dim=dims) / num_observed
    return err.mean(dim=dims)


def total_loss(obs_loss: torch.Tensor, reg_loss: torch.Tensor,
               reg_lambda: float) -> torch.Tensor:
    """obs + lambda * reg, per sample."""
    return obs_loss + reg_lambda * reg_loss
