"""Baseline regularisers: anisotropic TV and Tikhonov smoothness.

Counterpart of ``red_diffeq_tpu/regularization/benchmark.py``: per-sample
means of first differences of the velocity image (B, 1, H, W) -> (B,).
"""
import torch


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is 1, as ``jnp.abs``'s (``torch.abs``'s is
    0). A model's zero pad ring has zero differences, so the ring moves
    under the TV term only with JAX's rule."""
    return torch.where(x >= 0, x, -x)


def total_variation_loss(mu: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation, per sample."""
    dx = _abs(mu[:, :, :, 1:] - mu[:, :, :, :-1])
    dy = _abs(mu[:, :, 1:, :] - mu[:, :, :-1, :])
    return dx.mean(dim=(1, 2, 3)) + dy.mean(dim=(1, 2, 3))


def tikhonov_loss(mu: torch.Tensor) -> torch.Tensor:
    """Mean squared first differences, per sample."""
    dx = mu[:, :, :, 1:] - mu[:, :, :, :-1]
    dy = mu[:, :, 1:, :] - mu[:, :, :-1, :]
    return (dx ** 2).mean(dim=(1, 2, 3)) + (dy ** 2).mean(dim=(1, 2, 3))
