"""The shipped prior across the diffusion schedule, port against JAX.

The dim-64 (1, 2, 4, 8) U-Net at 72x72 holding the shipped prior, at
batch 4, at the schedule's ends (t = 0, 1, 999 for the whole batch) and at
a batch of mixed timesteps, on x_t diffused from held-out velocity models
(what RED feeds it). The U-Net's output is held to flax's at atol 1e-4 (as
the single-timestep case of ``test_torch_unet.py``). ``q_sample`` and
``model_predictions(clip_x_start=True, rederive_pred_noise=True)`` (RED's
call) are held to the JAX bundle's at T=1000: ``pred_noise`` at atol 1e-4;
``pred_x_start`` at 1e-4 times ``sqrt(1 / alpha_bar_t - 1)`` (1825 at
t = 999), the factor by which ``predict_start_from_noise`` carries the
U-Net's difference (the clip to [-1, 1] only shrinks it), plus 1e-5.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict, load_params
from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.utils.data_trans import v_normalize

CKPT = (Path(__file__).resolve().parents[1] / 'pretrained_models'
        / 'model-synthetic-ema.ckpt')
UNET = dict(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
T = 1000
TIMESTEPS = {'t0': [0, 0, 0, 0], 't1': [1, 1, 1, 1],
             't999': [999, 999, 999, 999], 'mixed': [0, 1, 500, 999]}



@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The port runs on one thread here: the suite's workers share the
    cores, and a full-width step's many small operations on more threads a
    worker only wait on each other (40x slower under a full run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope='module')
def outputs():
    """Each case's (JAX, port) U-Net output, pred_noise, pred_x_start, the
    x_t both were given, and the schedule's sqrt(1/alpha_bar - 1)."""
    raw = load_params(CKPT)
    jd = JaxDiffusion(JaxUnet(**UNET), image_size=72, timesteps=T,
                      objective='pred_noise',
                      params=jax.tree.map(jnp.asarray, raw))

    @jax.jit
    def jax_side(params, mu, noise, t):
        d = jd.with_params(params)
        x_t = d.q_sample(mu, t, noise=noise)
        p = d.model_predictions(x_t, t, clip_x_start=True,
                                rederive_pred_noise=True)
        return x_t, d.apply_fn(x_t, t), p.pred_noise, p.pred_x_start

    tm = Unet(**UNET)
    tm.load_state_dict(flax_to_state_dict(raw, tm))
    td = GaussianDiffusion(tm, image_size=72, timesteps=T,
                           objective='pred_noise', device='cpu')
    v = generate_mixed_dataset(4, h=70, w=70, seed=7777)
    mu = np.pad(v_normalize(v), ((0, 0), (0, 0), (1, 1), (1, 1))).astype(
        np.float32)
    noise = np.random.RandomState(5).standard_normal(mu.shape).astype(
        np.float32)
    out = {}
    for name, ts in TIMESTEPS.items():
        t = np.asarray(ts, np.int32)
        want = [np.asarray(a) for a in jax_side(
            jd.params, jnp.asarray(mu), jnp.asarray(noise), jnp.asarray(t))]
        tt = torch.from_numpy(t).long()
        with torch.no_grad():
            x_t = td.q_sample(torch.from_numpy(mu), tt,
                              torch.from_numpy(noise))
            given = torch.from_numpy(want[0])
            p = td.model_predictions(given, tt, clip_x_start=True,
                                     rederive_pred_noise=True)
            got = [x_t.numpy(), tm(given, tt).numpy(), p.pred_noise.numpy(),
                   p.pred_x_start.numpy()]
        scale = td.schedule.sqrt_recipm1_alphas_cumprod[tt].numpy()
        out[name] = (want, got, scale.reshape(-1, 1, 1, 1))
    return out


@pytest.mark.parametrize('case', list(TIMESTEPS))
def test_shipped_prior_unet_matches_flax_across_the_schedule(outputs, case):
    want, got, _ = outputs[case]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0,
                               err_msg='q_sample')
    assert np.abs(want[1]).max() > 0.1
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0,
                               err_msg='U-Net output')


@pytest.mark.parametrize('case', list(TIMESTEPS))
def test_rederived_model_predictions_match_jax_across_the_schedule(outputs,
                                                                  case):
    want, got, scale = outputs[case]
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0,
                               err_msg='pred_noise')
    gap = np.abs(got[3] - want[3])
    assert np.all(gap <= 1e-4 * scale + 1e-5), (
        f'pred_x_start: max gap {gap.max():.3e} against '
        f'{(1e-4 * scale).max():.3e}')
    assert np.all(np.abs(got[3]) <= 1.0)
