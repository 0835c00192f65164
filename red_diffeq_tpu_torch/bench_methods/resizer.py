"""Anti-aliased image resampling as dense matrix products, and the bilinear
resize of the patch path.

Counterpart of ``red_diffeq_tpu/bench_methods/resizer.py``. For each
resized axis a dense (out_len, in_len) weight matrix is built on the host
(:func:`resize_matrix`, numpy, copied from the JAX package so the matrices
are the same) and applied as ``W_h @ x @ W_w^T``, two fp32 matrix products
on the device. PyTorch keeps fp32 matrix products out of TF32 unless told
otherwise; nothing here tells it.
"""
from math import pi
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from red_diffeq_tpu_torch.utils.device import resolve_device


def cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((1 < ax) & (ax <= 2)))


def box(x):
    return ((-0.5 <= x) & (x < 0.5)) * 1.0


def linear(x):
    return ((x + 1) * ((-1 <= x) & (x < 0))
            + (1 - x) * ((0 <= x) & (x <= 1)))


def _lanczos(x, a):
    eps = np.finfo(np.float32).eps
    return ((np.sin(pi * x) * np.sin(pi * x / a) + eps)
            / ((pi ** 2 * x ** 2 / a) + eps)) * (np.abs(x) < a)


def lanczos2(x):
    return _lanczos(x, 2)


def lanczos3(x):
    return _lanczos(x, 3)


_KERNELS = {
    'cubic': (cubic, 4.0),
    'lanczos2': (lanczos2, 4.0),
    'lanczos3': (lanczos3, 6.0),
    'box': (box, 1.0),
    'linear': (linear, 2.0),
    None: (cubic, 4.0),
}


def resize_matrix(in_len: int, out_len: int, scale: float,
                  kernel: Optional[str] = None,
                  antialias: bool = True) -> np.ndarray:
    """Dense (out_len, in_len) resampling matrix for one axis: the kernel
    stretched by 1/scale when shrinking, half-pixel sample positions,
    out-of-range taps folded back by mirroring, rows summing to 1."""
    method, width = _KERNELS[kernel]
    antialias = antialias and scale < 1
    if antialias:
        fixed = lambda x: scale * method(scale * x)  # noqa: E731
        width = width / scale
    else:
        fixed = method

    out_coords = np.arange(1, out_len + 1, dtype=np.float64)
    # Center-aligned mapping with half-pixel convention.
    shifted = out_coords - (out_len - in_len * scale) / 2
    match = shifted / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(match - width / 2)
    window = int(np.ceil(width)) + 2
    taps = (left[:, None] + np.arange(window)[None, :] - 1).astype(np.int64)
    weights = fixed(match[:, None] - taps - 1)
    wsum = weights.sum(axis=1, keepdims=True)
    wsum[wsum == 0] = 1.0
    weights = weights / wsum

    # Mirror boundary: fold out-of-range taps back into [0, in_len).
    mirror = np.concatenate([np.arange(in_len),
                             np.arange(in_len - 1, -1, -1)])
    taps = mirror[np.mod(taps, 2 * in_len)]

    mat = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        np.add.at(mat[i], taps[i], weights[i])
    return mat.astype(np.float32)


class Resizer:
    """Resize (B, C, H, W) images of ``in_shape`` by ``scale_factor`` (a
    scalar or one per axis; the output is ceil(H * s) x ceil(W * s)) or to
    ``output_shape``, as a callable. The two weight matrices live on
    ``device`` (default ``'cuda'``; without a card it raises unless
    ``device='cpu'``)."""

    def __init__(self, in_shape: Sequence[int],
                 scale_factor: Union[float, Sequence[float], None] = None,
                 output_shape: Optional[Sequence[int]] = None,
                 kernel: Optional[str] = None, antialiasing: bool = True,
                 device=None):
        h, w = int(in_shape[2]), int(in_shape[3])
        if scale_factor is not None:
            if np.isscalar(scale_factor):
                sh = sw = float(scale_factor)
            else:
                sh, sw = float(scale_factor[0]), float(scale_factor[1])
            oh, ow = int(np.ceil(h * sh)), int(np.ceil(w * sw))
        else:
            oh, ow = int(output_shape[-2]), int(output_shape[-1])
            sh, sw = oh / h, ow / w
        self.device = resolve_device(device)
        self.out_hw = (oh, ow)
        self.w_h = torch.as_tensor(
            resize_matrix(h, oh, sh, kernel, antialiasing),
            device=self.device)
        self.w_w = torch.as_tensor(
            resize_matrix(w, ow, sw, kernel, antialiasing),
            device=self.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # Rows, then columns.
        return torch.matmul(torch.matmul(self.w_h, x), self.w_w.t())


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear NCHW resize with half-pixel centres that antialiases when it
    shrinks, as ``jax.image.resize(method='bilinear')``."""
    return F.interpolate(x, size=tuple(out_hw), mode='bilinear',
                         align_corners=False, antialias=True)
