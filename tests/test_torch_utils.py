"""The port's step utilities against the JAX package: normalisation,
initial models, synthetic data (exact), losses and metrics (rtol 1e-5),
SSIM (atol 1e-5)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.core import losses as jlosses
from red_diffeq_tpu.core import metrics as jmetrics
from red_diffeq_tpu.io import synthetic as jsynth
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu.utils import diffusion_utils as jdu
from red_diffeq_tpu_torch.core import losses, metrics
from red_diffeq_tpu_torch.io import synthetic
from red_diffeq_tpu_torch.utils import data_trans, diffusion_utils, ssim

# ``red_diffeq_tpu.utils`` re-exports the function ``ssim`` under the
# module's name.
jssim = importlib.import_module('red_diffeq_tpu.utils.ssim')


def _pair(seed=0, shape=(3, 1, 20, 24)):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize('size_average', [True, False])
def test_ssim_matches(size_average):
    a, b = _pair()
    b = np.clip(a + 0.1 * (b - 0.5), 0, 1).astype(np.float32)
    want = np.asarray(jssim.ssim(jnp.asarray(a), jnp.asarray(b),
                                 size_average=size_average))
    got = ssim.ssim(torch.from_numpy(a), torch.from_numpy(b),
                    size_average=size_average).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ssim.gaussian_window(),
                                  jssim.gaussian_window())


def test_metrics_and_losses_match():
    a, b = _pair(1)
    mu, mu_true = a * 2 - 1, b * 2 - 1
    want = jmetrics.calculate_metrics(jnp.asarray(mu), jnp.asarray(mu_true))
    got = metrics.calculate_metrics(torch.from_numpy(mu),
                                    torch.from_numpy(mu_true))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    pred, obs = _pair(2, (2, 3, 10, 7))
    mask = (np.random.RandomState(3).rand(*obs.shape) > 0.3).astype(
        np.float32)
    for m in (None, mask):
        want = jlosses.observation_loss(
            jnp.asarray(pred), jnp.asarray(obs),
            None if m is None else jnp.asarray(m))
        got = losses.observation_loss(
            torch.from_numpy(pred), torch.from_numpy(obs),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        losses.total_loss(torch.tensor([1.0, 2.0]), torch.tensor([0.5, 4.0]),
                          0.75).numpy(),
        np.asarray(jlosses.total_loss(jnp.array([1.0, 2.0]),
                                      jnp.array([0.5, 4.0]), 0.75)))


@pytest.mark.parametrize('kind,sigma', [('smoothed', 10.0),
                                        ('smoothed', 2.5),
                                        ('homogeneous', None),
                                        ('linear', None)])
def test_initial_models_match(kind, sigma):
    v = jsynth.generate_mixed_dataset(1, h=30, w=30, seed=4)
    np.testing.assert_array_equal(
        data_trans.prepare_initial_model(v, kind, sigma=sigma),
        jdt.prepare_initial_model(v, kind, sigma=sigma))


def test_synthetic_and_normalisation_match():
    np.testing.assert_array_equal(
        synthetic.generate_mixed_dataset(6, h=20, w=20, seed=8888),
        jsynth.generate_mixed_dataset(6, h=20, w=20, seed=8888))
    v = synthetic.generate_mixed_dataset(2, h=8, w=8, seed=1)
    np.testing.assert_allclose(
        data_trans.v_normalize(torch.from_numpy(v)).numpy(),
        np.asarray(jdt.v_normalize(jnp.asarray(v))), rtol=1e-6)
    np.testing.assert_allclose(
        data_trans.v_denormalize(torch.from_numpy(v / 4500.0)).numpy(),
        np.asarray(jdt.v_denormalize(jnp.asarray(v / 4500.0))), rtol=1e-6)


def test_diffusion_pad_crop_extract_match():
    x = np.arange(2 * 1 * 3 * 4, dtype=np.float32).reshape(2, 1, 3, 4)
    padded = diffusion_utils.diffusion_pad(torch.from_numpy(x))
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jdu.diffusion_pad(x)))
    np.testing.assert_array_equal(
        diffusion_utils.diffusion_crop(padded).numpy(), x)
    a = np.linspace(0, 1, 10, dtype=np.float32)
    t = np.array([1, 7])
    np.testing.assert_array_equal(
        diffusion_utils.extract(torch.from_numpy(a), torch.from_numpy(t),
                                4).numpy(),
        np.asarray(jdu.extract(jnp.asarray(a), jnp.asarray(t), 4)))
