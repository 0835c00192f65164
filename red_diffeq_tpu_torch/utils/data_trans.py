"""Velocity/seismic normalisation and initial-model synthesis.

Counterpart of ``red_diffeq_tpu/utils/data_trans.py:19-120``. The
normalisations work on tensors and numpy arrays alike; the initial-model
helpers are host numpy, copied so that the port needs nothing of the JAX
package.
"""
from typing import Union

import numpy as np

# Velocity range of the OpenFWI datasets: [1500, 4500] m/s.
_V_MIN, _V_RANGE = 1500.0, 3000.0


def v_normalize(v):
    """Map velocity in m/s to [-1, 1]."""
    return (v - _V_MIN) / _V_RANGE * 2.0 - 1.0


def v_denormalize(v_norm):
    """Map [-1, 1] back to m/s."""
    return (v_norm + 1.0) / 2.0 * _V_RANGE + _V_MIN


def s_normalize_none(s):
    """Identity seismic normalisation."""
    return s


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    return w / w.sum()


def gaussian_filter_np(x: np.ndarray, sigma: float,
                       truncate: float = 4.0) -> np.ndarray:
    """Separable Gaussian blur over every axis with symmetric-reflect
    boundaries, numerically equivalent to
    ``scipy.ndimage.gaussian_filter``."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius == 0:
        return x.astype(np.float64)
    w = _gaussian_kernel1d(sigma, radius)
    out = x.astype(np.float64)
    for axis in range(out.ndim):
        if out.shape[axis] == 1:
            continue  # a size-1 axis is invariant under reflect smoothing
        pad = [(0, 0)] * out.ndim
        pad[axis] = (radius, radius)
        padded = np.pad(out, pad, mode='symmetric')
        out = np.apply_along_axis(
            lambda m: np.convolve(m, w, mode='valid'), axis, padded)
    return out


def prepare_initial_model(v_true: Union[np.ndarray, 'torch.Tensor'],
                          initial_type: str = None, sigma: float = None,
                          linear_coeff: float = 1.0) -> np.ndarray:
    """Starting velocity model in [-1, 1], shape (1, 1, H, W), float32:
    ``'smoothed'`` (Gaussian blur of the normalised truth),
    ``'homogeneous'`` (top-row minimum) or ``'linear'`` (depth gradient
    from the global min to max)."""
    if initial_type not in ('smoothed', 'homogeneous', 'linear'):
        raise ValueError(
            "please choose from 'smoothed', 'homogeneous', and 'linear'")
    v_np = v_normalize(np.asarray(v_true, dtype=np.float64))

    if initial_type == 'smoothed':
        v_init = gaussian_filter_np(v_np, sigma=sigma)
    elif initial_type == 'homogeneous':
        v_init = np.full_like(v_np, np.min(v_np[0, 0, 0, :]))
    else:  # linear
        height = v_np.shape[2]
        grad = np.linspace(np.min(v_np), np.max(v_np), height).reshape(-1, 1)
        v_init = np.tile(grad, (1, v_np.shape[3])).reshape(1, 1, height, -1)

    return v_init.astype(np.float32)
