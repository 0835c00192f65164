"""The port's diffusion schedule and model predictions against the JAX
package (schedules rtol 1e-6; predictions atol 1e-5 / rtol 1e-4 through a
dim-8 U-Net on weights carried across)."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.models import diffusion as jdiff
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu.regularization.red import RED_DiffEq as JaxRED
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
from red_diffeq_tpu_torch.models import diffusion as tdiff
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.regularization.red import RED_DiffEq


@pytest.mark.parametrize('schedule', ['linear', 'cosine', 'sigmoid'])
@pytest.mark.parametrize('objective', ['pred_noise', 'pred_x0', 'pred_v'])
def test_schedule_matches(schedule, objective):
    want = jdiff.DiffusionSchedule.create(1000, schedule, objective)
    got = tdiff.DiffusionSchedule.create(1000, schedule, objective)
    for name in want.__dataclass_fields__:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)


@pytest.fixture(scope='module')
def pair():
    jm = JaxUnet(dim=8, dim_mults=(1, 2), channels=1)
    jd = jdiff.GaussianDiffusion(jm, image_size=16, timesteps=50)
    jd.init_params(jax.random.PRNGKey(5))
    tm = Unet(dim=8, dim_mults=(1, 2), channels=1)
    tm.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            jd.params)), tm))
    td = tdiff.GaussianDiffusion(tm, image_size=16, timesteps=50,
                                 device='cpu')
    return jd, td


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (3, 1, 16, 16)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([0, 17, 49], np.int32)
    return x, noise, t


@pytest.mark.parametrize('clip,rederive', [(False, False), (True, False),
                                           (True, True)])
def test_model_predictions_match(pair, clip, rederive):
    jd, td = pair
    x, noise, t = _inputs()
    jx = jd.q_sample(jnp.asarray(x), jnp.asarray(t), noise=jnp.asarray(noise))
    tx = td.q_sample(torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(noise))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-7)
    want = jd.model_predictions(jx, jnp.asarray(t), clip_x_start=clip,
                                rederive_pred_noise=rederive)
    with torch.no_grad():
        got = td.model_predictions(tx, torch.from_numpy(t).long(),
                                   clip_x_start=clip,
                                   rederive_pred_noise=rederive)
    # Unclipped x_start at t=49 is eps scaled by sqrt(1/alpha_bar - 1),
    # about 10^2: hence the relative part of the tolerance.
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize('fn', ['predict_start_from_noise',
                                'predict_noise_from_start', 'predict_v',
                                'predict_start_from_v'])
def test_prediction_identities_match(pair, fn):
    jd, td = pair
    a, b, t = _inputs(1)
    want = getattr(jd, fn)(jnp.asarray(a), jnp.asarray(t), jnp.asarray(b))
    got = getattr(td, fn)(torch.from_numpy(a), torch.from_numpy(t).long(),
                          torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('use_time_weight', [False, True])
def test_red_loss_matches_with_fed_draws(pair, use_time_weight):
    """RED loss, score mean and t with the JAX draws fed to the port."""
    jd, td = pair
    mu, _, _ = _inputs(2)
    key = jax.random.PRNGKey(9)
    jred = JaxRED(jd, use_time_weight=use_time_weight)
    want = jred.get_reg_loss(jnp.asarray(mu), key)
    t, noise = jred._sample_t_noise(key, 3, mu.shape, jnp.float32)
    red = RED_DiffEq(td, use_time_weight=use_time_weight)
    got = red.get_reg_loss(torch.from_numpy(mu),
                           t=torch.from_numpy(np.array(t)).long(),
                           noise=torch.from_numpy(np.array(noise)))
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_red_gradient_is_the_detached_score(pair):
    """d(reg)/d(mu) is the mean score per pixel: nothing flows back
    through the U-Net."""
    _, td = pair
    mu = torch.from_numpy(_inputs(3)[0]).requires_grad_(True)
    red = RED_DiffEq(td)
    g = torch.Generator().manual_seed(0)
    reg, score_mean, _ = red.get_reg_loss(mu, generator=g)
    reg.sum().backward()
    g = torch.Generator().manual_seed(0)
    t = torch.randint(0, 50, (3,), generator=g)
    noise = torch.randn(mu.shape, generator=g)
    from red_diffeq_tpu_torch.regularization.red import _score_residual
    score = _score_residual(td, mu.detach(), t, noise)
    torch.testing.assert_close(mu.grad, score / mu[0].numel())
