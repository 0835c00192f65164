"""Normalisation, observation corruption and initial-model synthesis.

Counterpart of ``red_diffeq_tpu/utils/data_trans.py``. The normalisations
work on tensors and numpy arrays alike; the initial-model helpers are host
numpy, copied so that the port needs nothing of the JAX package. The
corruptions take their random draw as an optional explicit tensor (so that
a test can feed them the JAX package's draws) and otherwise draw it from a
``torch.Generator`` on the observations' device.
"""
from typing import Optional, Tuple, Union

import numpy as np
import torch

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


def s_normalize(s):
    """Map seismic amplitude in [-20, 60] to [-1, 1]."""
    return (s + 20.0) / 80.0 * 2.0 - 1.0


def s_denormalize(s_norm):
    """Inverse of :func:`s_normalize`."""
    return (s_norm + 1.0) / 2.0 * 80.0 - 20.0


def add_noise_to_seismic(y: torch.Tensor, std: float,
                         noise_type: str = 'gaussian',
                         generator: Optional[torch.Generator] = None,
                         draw: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Corrupt observations with gaussian or laplace noise of scale ``std``.

    ``draw`` (shape of ``y``) is the standard normal for ``'gaussian'`` and
    the U(0, 1) sample for ``'laplace'``, which becomes laplace noise by the
    inverse CDF, ``-std * sign(u) * log1p(-2|u|)`` with ``u = draw - 0.5``;
    without it the draw comes from ``generator``."""
    if std < 0:
        raise ValueError('the standard deviation/scale of the noise must '
                         'be >= 0')
    if noise_type not in ('gaussian', 'laplace'):
        raise ValueError(f'unknown noise type: {noise_type}')
    if std == 0:
        return y
    if draw is None:
        sample = torch.randn if noise_type == 'gaussian' else torch.rand
        draw = sample(y.shape, generator=generator, device=y.device,
                      dtype=y.dtype)
    draw = torch.as_tensor(draw, dtype=y.dtype, device=y.device)
    if noise_type == 'gaussian':
        return y + draw * std
    u = draw - 0.5
    return y + -std * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


def missing_trace(y: torch.Tensor, num_missing: int,
                  generator: Optional[torch.Generator] = None,
                  trace_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero ``num_missing`` receivers per sample of ``y`` (B, ns, nt, ng):
    the same receivers on every shot of a sample; returns the observations
    and their mask. ``trace_mask`` (B, ng) of
    ones and zeros says which; without it each sample's receivers are the
    first ``num_missing`` of a random permutation drawn from
    ``generator``."""
    if num_missing < 0:
        raise ValueError('the number of missing traces must be >= 0')
    mask = torch.ones_like(y)
    if num_missing == 0:
        return y, mask
    batch, ng = y.shape[0], y.shape[-1]
    if trace_mask is None:
        trace_mask = torch.ones(batch, ng, dtype=y.dtype, device=y.device)
        for b in range(batch):
            perm = torch.randperm(ng, generator=generator, device=y.device)
            trace_mask[b, perm[:num_missing]] = 0.0
    trace_mask = torch.as_tensor(trace_mask, dtype=y.dtype, device=y.device)
    mask = trace_mask[:, None, None, :] * mask
    return y * mask, mask


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
