"""Data-fidelity and total loss composition.

Counterpart of ``red_diffeq_tpu/core/losses.py``: a per-sample,
optionally mask-normalised L1.
"""
from typing import Optional

import torch


def observation_loss(predicted: torch.Tensor, target: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample L1 between predicted and observed seismograms,
    (B, ns, nt, ng) -> (B,). With a mask (1 = observed, 0 = missing
    trace) the mean runs over observed elements only."""
    err = torch.abs(target.float() - predicted.float())
    dims = tuple(range(1, err.ndim))
    if mask is not None:
        num_observed = mask.sum(dim=dims).clamp_min(1.0)
        return (err * mask).sum(dim=dims) / num_observed
    return err.mean(dim=dims)


def total_loss(obs_loss: torch.Tensor, reg_loss: torch.Tensor,
               reg_lambda: float) -> torch.Tensor:
    """obs + lambda * reg, per sample."""
    return obs_loss + reg_lambda * reg_loss
