"""Per-sample evaluation metrics, on the tensors' device.

Counterpart of ``red_diffeq_tpu/core/metrics.py``: MAE/RMSE on normalised
([-1, 1]) velocities, SSIM on the [0, 1] mapping.
"""
from typing import Tuple

import torch

from red_diffeq_tpu_torch.utils.data_trans import v_normalize
from red_diffeq_tpu_torch.utils.ssim import ssim


def calculate_metrics(mu: torch.Tensor, mu_true_norm: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mae, rmse, ssim) per sample for ``mu`` in [-1, 1], (B, 1, H, W),
    against ground truth already normalised to [-1, 1]."""
    mu = mu.detach()
    diff = mu - mu_true_norm
    mae = diff.abs().mean(dim=(1, 2, 3))
    rmse = (diff ** 2).mean(dim=(1, 2, 3)).sqrt()
    ssim_val = ssim((mu + 1) / 2, (mu_true_norm + 1) / 2, size_average=False)
    return mae, rmse, ssim_val


class MetricsCalculator:
    """The reference's class interface: ground truth in m/s, normalised
    here. ``ssim_loss`` is accepted and unused, as in the JAX package."""

    def __init__(self, ssim_loss=None):
        del ssim_loss

    def calculate(self, mu: torch.Tensor, mu_true: torch.Tensor):
        return calculate_metrics(mu, v_normalize(mu_true))
