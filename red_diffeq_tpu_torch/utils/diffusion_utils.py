"""Glue between the physics grid and the denoiser grid.

Counterpart of ``red_diffeq_tpu/utils/diffusion_utils.py``: the 70x70
physics grid is zero-padded by one pixel to 72x72 so U-Net feature maps
divide by 8.
"""
import torch
import torch.nn.functional as F


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-batch schedule coefficients ``a[t]`` shaped (B, 1, 1, ...)."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def diffusion_pad(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad one pixel on each spatial edge: (B,C,H,W) -> (B,C,H+2,W+2)."""
    return F.pad(x, (1, 1, 1, 1))


def diffusion_crop(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`diffusion_pad`."""
    return x[:, :, 1:-1, 1:-1]
