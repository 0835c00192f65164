"""Baseline regularisers: anisotropic TV and Tikhonov smoothness.

Counterpart of ``red_diffeq_tpu/regularization/benchmark.py``: per-sample
means of first differences of the velocity image (B, 1, H, W) -> (B,).
"""
import torch

from red_diffeq_tpu_torch.core.losses import abs_jax


def total_variation_loss(mu: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation, per sample. Its |x| has JAX's gradient
    at 0 (:func:`abs_jax`): a model's zero pad ring has zero differences,
    so the ring moves under the TV term only with JAX's rule."""
    dx = abs_jax(mu[:, :, :, 1:] - mu[:, :, :, :-1])
    dy = abs_jax(mu[:, :, 1:, :] - mu[:, :, :-1, :])
    return dx.mean(dim=(1, 2, 3)) + dy.mean(dim=(1, 2, 3))


def tikhonov_loss(mu: torch.Tensor) -> torch.Tensor:
    """Mean squared first differences, per sample."""
    dx = mu[:, :, :, 1:] - mu[:, :, :, :-1]
    dy = mu[:, :, 1:, :] - mu[:, :, :-1, :]
    return (dx ** 2).mean(dim=(1, 2, 3)) + (dy ** 2).mean(dim=(1, 2, 3))
