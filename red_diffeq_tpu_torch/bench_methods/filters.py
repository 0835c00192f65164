"""Image filters for the bench methods' gradient tricks, on the device.

Counterpart of ``red_diffeq_tpu/bench_methods/filters.py``: the Gaussian
smoothing of the FWI gradient (``scipy.ndimage.gaussian_filter``'s
symmetric boundary) and the 3x3 model blur (reflect boundary), as
separable or 3x3 convolutions run in full fp32 (cuDNN's TF32 off, as the
JAX package runs them at ``Precision.HIGHEST``), and the total-norm clip.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from red_diffeq_tpu_torch.utils.precision import fp32_convolutions


# The constants below are made once per device, not copied to the card at
# every call (each such copy waits for the card's queue to drain).


@lru_cache(maxsize=None)
def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.as_tensor((w / w.sum()).astype(np.float32), device=device)


@lru_cache(maxsize=None)
def _symmetric_index(n: int, radius: int, device) -> torch.Tensor:
    """Indices of numpy's ``'symmetric'`` pad of ``radius`` cells a side
    (the edge cell repeated: ... x1 x0 | x0 x1 ... x_{n-1} | x_{n-1} ...),
    for any radius."""
    m = np.mod(np.arange(-radius, n + radius), 2 * n)
    return torch.as_tensor(np.where(m < n, m, 2 * n - 1 - m), device=device)


@lru_cache(maxsize=None)
def _blur_kernel(sigma: float, device) -> torch.Tensor:
    xs = np.array([-1.0, 0.0, 1.0])
    w = np.exp(-0.5 * (xs / sigma) ** 2)
    w = (w / w.sum()).astype(np.float32)
    return torch.as_tensor(np.outer(w, w), device=device)[None, None]


def gaussian_smooth(x: torch.Tensor, sigma: float, truncate: float = 4.0
                    ) -> torch.Tensor:
    """Gaussian blur over the last two axes of (B, C, H, W) with numpy's
    ``'symmetric'`` boundary, equal to ``scipy.ndimage.gaussian_filter(x,
    sigma=[0, 0, s, s])``: the rows, then the columns, each a 1D
    convolution of radius ``int(truncate * sigma + 0.5)``."""
    if sigma is None or sigma <= 0:
        return x
    radius = int(truncate * float(sigma) + 0.5)
    if radius == 0:
        return x
    w = _gaussian_kernel1d(float(sigma), radius, x.device)
    b, c, h, wd = x.shape
    flat = x.reshape(b * c, 1, h, wd)
    with fp32_convolutions():
        rows = flat.index_select(2, _symmetric_index(h, radius, x.device))
        flat = F.conv2d(rows, w.reshape(1, 1, -1, 1))
        cols = flat.index_select(3, _symmetric_index(wd, radius, x.device))
        flat = F.conv2d(cols, w.reshape(1, 1, 1, -1))
    return flat.reshape(b, c, h, wd)


def gaussian_blur_3x3(x: torch.Tensor, sigma: float = 0.4) -> torch.Tensor:
    """3x3 Gaussian blur with reflect padding, as
    ``torchvision.transforms.functional.gaussian_blur(x, [3, 3], [sigma,
    sigma])``."""
    kernel = _blur_kernel(float(sigma), x.device)
    b, c, h, wd = x.shape
    padded = F.pad(x.reshape(b * c, 1, h, wd), (1, 1, 1, 1), mode='reflect')
    with fp32_convolutions():
        out = F.conv2d(padded, kernel)
    return out.reshape(b, c, h, wd)


def clip_total_norm(g: torch.Tensor, max_norm) -> torch.Tensor:
    """Scale ``g`` so that its global L2 norm is at most ``max_norm``, as
    ``torch.nn.utils.clip_grad_norm_`` over one tensor (with its 1e-6)."""
    norm = torch.linalg.vector_norm(g.reshape(-1))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return g * scale
