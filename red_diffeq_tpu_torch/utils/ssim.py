"""SSIM with an 11x11 Gaussian window (sigma=1.5), zero padding, fp32.

Counterpart of ``red_diffeq_tpu/utils/ssim.py:14-73``: a depthwise
convolution with zero padding of window_size//2, C1=0.01^2, C2=0.03^2.
The JAX version asks for HIGHEST precision; here cuDNN is kept off TF32.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from red_diffeq_tpu_torch.utils.precision import fp32_convolutions


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalised 2D Gaussian window, shape (window_size, window_size)."""
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_on(window_size: int, device: torch.device) -> torch.Tensor:
    """The window on ``device``, made once and kept for the process (a
    CUDA graph's capture allows no copy from the host)."""
    return torch.from_numpy(gaussian_window(window_size)).to(device)


def _filter2d(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    pad = window.shape[0] // 2
    kernel = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(x, kernel, padding=pad, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity of two NCHW images in [0, 1]: a scalar mean
    with ``size_average``, else a per-sample mean of shape (N,)."""
    window = _window_on(window_size, img1.device)
    with fp32_convolutions():
        mu1 = _filter2d(img1, window)
        mu2 = _filter2d(img2, window)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _filter2d(img1 * img1, window) - mu1_sq
        sigma2_sq = _filter2d(img2 * img2, window) - mu2_sq
        sigma12 = _filter2d(img1 * img2, window) - mu1_mu2

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


class SSIM:
    """Callable wrapper with the reference module's interface."""

    def __init__(self, window_size: int = 11, size_average: bool = True):
        self.window_size = window_size
        self.size_average = size_average

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return ssim(img1, img2, window_size=self.window_size,
                    size_average=self.size_average)
