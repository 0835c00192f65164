"""The port's diffusion schedule, model predictions and reverse process
against the JAX package (schedules rtol 1e-6; predictions, posterior means,
sampler steps and chains atol 1e-5 / rtol 1e-4 through a dim-8 U-Net on
weights carried across, the samplers fed JAX's draws)."""
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


# -- the reverse process ------------------------------------------------


def _tt(a):
    return torch.from_numpy(np.array(a))


def _pair_with(timesteps, **kw):
    """A JAX and a port diffusion over one dim-8 U-Net's weights, with the
    constructor options ``kw`` on both."""
    jm = JaxUnet(dim=8, dim_mults=(1, 2), channels=1)
    jd = jdiff.GaussianDiffusion(jm, image_size=16, timesteps=timesteps,
                                 **kw)
    jd.init_params(jax.random.PRNGKey(5))
    tm = Unet(dim=8, dim_mults=(1, 2), channels=1)
    tm.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            jd.params)), tm))
    return jd, tdiff.GaussianDiffusion(tm, image_size=16,
                                       timesteps=timesteps, device='cpu',
                                       **kw)


def test_q_posterior_and_p_mean_variance_match(pair):
    """On x_t diffused from x0 as in the prediction test above."""
    jd, td = pair
    x0, noise, t = _inputs(6)
    x = np.array(jd.q_sample(jnp.asarray(x0), jnp.asarray(t),
                             noise=jnp.asarray(noise)))
    for w, g in zip(jd.q_posterior(jnp.asarray(x0), jnp.asarray(x),
                                   jnp.asarray(t)),
                    td.q_posterior(torch.from_numpy(x0), torch.from_numpy(x),
                                   torch.from_numpy(t).long())):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    for clip in (False, True):
        want = jd.p_mean_variance(jnp.asarray(x), jnp.asarray(t),
                                  clip_denoised=clip)
        with torch.no_grad():
            got = td.p_mean_variance(torch.from_numpy(x),
                                     torch.from_numpy(t).long(),
                                     clip_denoised=clip)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-4)


@pytest.mark.parametrize('t', [0, 17])
def test_p_sample_matches_with_fed_noise(pair, t):
    """No noise at t == 0; JAX's draw fed to the port elsewhere."""
    jd, td = pair
    x, _, _ = _inputs(7)
    key = jax.random.PRNGKey(t)
    want = jd.p_sample(jnp.asarray(x), jnp.int32(t), key)
    got = td.p_sample(torch.from_numpy(x), t,
                      noise=_tt(jax.random.normal(key, x.shape)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
    det = td.p_sample_deterministic(torch.from_numpy(x), t)
    jdet = jd.p_sample_deterministic(jnp.asarray(x), jnp.int32(t))
    for w, g in zip(jdet, det):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def _chain_draws(key, shape, steps):
    """JAX's draws of a sampler: the start image, then one per step."""
    key, init_key = jax.random.split(key)
    return torch.stack([_tt(jax.random.normal(init_key, shape))]
                       + [_tt(jax.random.normal(k, shape))
                          for k in jax.random.split(key, steps)])


@pytest.mark.parametrize('eta', [0.0, 0.5])
def test_ddim_sample_matches_with_fed_draws(eta):
    """3 DDIM steps of a 50-step schedule; eta 0.5 lets the step noise in."""
    jd, td = _pair_with(50, sampling_timesteps=3, ddim_sampling_eta=eta)
    assert td.is_ddim_sampling and jd.is_ddim_sampling
    shape = (2, 1, 16, 16)
    key = jax.random.PRNGKey(11)
    draws = _chain_draws(key, shape, 3)
    want = np.asarray(jd.sample(batch_size=2, key=key,
                                return_all_timesteps=True))
    got = td.sample(2, noise=draws, return_all_timesteps=True)
    assert got.shape == want.shape == (2, 4, 1, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(td.ddim_sample(shape, noise=draws).numpy(),
                               want[:, -1], atol=1e-5, rtol=1e-4)


def test_p_sample_loop_and_interpolate_match_with_fed_draws():
    """The ancestral chain of a 3-step schedule, and interpolate from t=2."""
    jd, td = _pair_with(3)
    assert not td.is_ddim_sampling
    shape = (2, 1, 16, 16)
    key = jax.random.PRNGKey(12)
    want = np.asarray(jd.sample(batch_size=2, key=key))
    got = td.sample(2, noise=_chain_draws(key, shape, 3))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    assert float(got.min()) >= -0.5 and float(got.max()) <= 1.5

    x1, x2, _ = _inputs(8)
    key = jax.random.PRNGKey(13)
    want = jd.interpolate(jnp.asarray(x1[:2]), jnp.asarray(x2[:2]), key, t=2,
                          lam=0.3)
    key, k1, k2 = jax.random.split(key, 3)
    draws = torch.stack(
        [_tt(jax.random.normal(k, x1[:2].shape))
         for k in (k1, k2, *jax.random.split(key, 2))])
    got = td.interpolate(torch.from_numpy(x1[:2]), torch.from_numpy(x2[:2]),
                         t=2, lam=0.3, noise=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


def test_sample_from_a_generator_is_in_range_and_repeats():
    _, td = _pair_with(50, sampling_timesteps=3)
    a = td.sample(2, generator=torch.Generator().manual_seed(0))
    b = td.sample(2, generator=torch.Generator().manual_seed(0))
    assert a.shape == (2, 1, 16, 16) and torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    with pytest.raises(ValueError, match='exceeds timesteps'):
        tdiff.GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=16,
                                timesteps=3, sampling_timesteps=4,
                                device='cpu')


def test_post_process_matches_with_fed_noise(pair):
    """``RED_DiffEq_POST_PROCESS``: 4 deterministic steps from t=4."""
    from red_diffeq_tpu.regularization.red import \
        RED_DiffEq_POST_PROCESS as JaxPost
    from red_diffeq_tpu_torch.regularization.red import \
        RED_DiffEq_POST_PROCESS

    jd, td = pair
    mu, _, _ = _inputs(9)
    key = jax.random.PRNGKey(14)
    want = JaxPost(jd).diffusion_denoise(jnp.asarray(mu), 4, key)
    _, kn = jax.random.split(key)
    got = RED_DiffEq_POST_PROCESS(td).diffusion_denoise(
        torch.from_numpy(mu), 4, noise=_tt(jax.random.normal(kn, mu.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    with pytest.raises(ValueError, match='exceeds'):
        RED_DiffEq_POST_PROCESS(td).diffusion_denoise(
            torch.from_numpy(mu), 51)
