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
from red_diffeq_tpu.utils import seed_utils as jseed
from red_diffeq_tpu_torch.core import losses, metrics
from red_diffeq_tpu_torch.io import synthetic
from red_diffeq_tpu_torch.utils import data_trans, diffusion_utils, ssim
from red_diffeq_tpu_torch.utils import seed_utils as tseed

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


def _jax_draw(key):
    import jax
    return np.asarray(jax.random.normal(key, (4,)))


def _torch_draw(gen):
    return torch.randn(4, generator=gen).numpy()


def _torch_key():
    return tseed.next_key('cpu')


@pytest.mark.parametrize('mod,key,draw',
                         [(jseed, jseed.next_key, _jax_draw),
                          (tseed, _torch_key, _torch_draw)],
                         ids=['jax', 'torch'])
def test_seed_sequence_behaves_as_in_jax(mod, key, draw):
    """The port's seed sequence behaves as the JAX package's (the numbers
    differ): ``next_key`` draws anew on each call, ``set_seed`` repeats the
    sequence, and ``SeedContext`` restores it on exit. The module's state
    is restored afterwards."""
    with mod.SeedContext(0):
        _seed_sequence_checks(mod, key, draw)


def _seed_sequence_checks(mod, key, draw):
    mod.set_seed(5)
    a = [draw(key()) for _ in range(3)]
    assert not np.array_equal(a[0], a[1])
    mod.set_seed(5)
    assert all(np.array_equal(x, draw(key())) for x in a[:2])
    host = np.random.get_state()[1].copy()
    with mod.SeedContext(9):
        inner = draw(key())
        np.random.rand()
    assert np.array_equal(np.random.get_state()[1], host)
    assert np.array_equal(draw(key()), a[2])
    mod.set_seed(9)
    assert np.array_equal(draw(key()), inner)


def test_next_key_places_the_generator_on_the_device(monkeypatch):
    """``next_key`` puts the generator on the device asked for; with none,
    on the card, as every entry point of the port, and so it raises
    without one."""
    tseed.set_seed(2)
    gen = tseed.next_key('cpu')
    assert gen.device.type == 'cpu'
    assert isinstance(tseed.get_key(), torch.Generator)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tseed.next_key()


def test_seismic_normalisation_matches():
    s = np.random.RandomState(3).uniform(-20, 60, (2, 3, 5, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        data_trans.s_normalize(torch.from_numpy(s)).numpy(),
        np.asarray(jdt.s_normalize(jnp.asarray(s))), rtol=1e-6)
    np.testing.assert_allclose(
        data_trans.s_denormalize(torch.from_numpy(s / 60.0)).numpy(),
        np.asarray(jdt.s_denormalize(jnp.asarray(s / 60.0))), rtol=1e-6)


@pytest.mark.parametrize('noise_type', ['gaussian', 'laplace'])
def test_noise_matches_jax_on_its_draws(noise_type):
    """``add_noise_to_seismic`` fed JAX's own draw (the standard normal or
    the uniform of its key) gives JAX's noisy observations, rtol 1e-6; a
    scale of 0 leaves them as they are."""
    import jax
    y = np.random.RandomState(4).standard_normal((2, 3, 20, 12)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    want = jdt.add_noise_to_seismic(jnp.asarray(y), 0.3,
                                    noise_type=noise_type, key=key)
    sample = (jax.random.normal if noise_type == 'gaussian'
              else jax.random.uniform)
    draw = torch.from_numpy(np.array(sample(key, y.shape)))
    got = data_trans.add_noise_to_seismic(torch.from_numpy(y), 0.3,
                                          noise_type=noise_type, draw=draw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    yt = torch.from_numpy(y)
    assert data_trans.add_noise_to_seismic(yt, 0.0) is yt
    drawn = data_trans.add_noise_to_seismic(
        yt, 0.3, noise_type=noise_type,
        generator=torch.Generator().manual_seed(1))
    assert drawn.shape == yt.shape and not torch.equal(drawn, yt)
    with pytest.raises(ValueError):
        data_trans.add_noise_to_seismic(yt, 0.3, noise_type='cauchy')


def test_missing_trace_matches_jax_on_its_draws():
    """``missing_trace`` fed JAX's per-sample receiver masks gives JAX's
    observations and mask; drawing its own, it zeroes exactly
    ``num_missing`` receivers per sample, the same on every shot."""
    import jax
    y = np.random.RandomState(5).standard_normal((3, 2, 10, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    want_y, want_mask = jdt.missing_trace(jnp.asarray(y), 4, key=key)
    trace_mask = np.ones((3, 16), np.float32)
    for b, k in enumerate(jax.random.split(key, 3)):
        trace_mask[b, np.asarray(jax.random.permutation(k, 16))[:4]] = 0.0
    got_y, got_mask = data_trans.missing_trace(
        torch.from_numpy(y), 4, trace_mask=torch.from_numpy(trace_mask))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-6)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))

    _, mask = data_trans.missing_trace(
        torch.from_numpy(y), 4, generator=torch.Generator().manual_seed(2))
    dead = mask[:, :, :, :] == 0
    assert torch.equal(dead, dead[:, :1, :1].expand_as(dead))
    assert (dead[:, 0, 0].sum(dim=1) == 4).all()
    yt = torch.from_numpy(y)
    kept, ones = data_trans.missing_trace(yt, 0)
    assert kept is yt and torch.equal(ones, torch.ones_like(yt))


def test_step_timer_leaves_out_the_first_step_as_in_jax(monkeypatch):
    """Steps of 5, 1, 2 and 3 s on a fake clock: both timers keep the
    last three and summarise them alike; with no step kept, zeros."""
    from red_diffeq_tpu.utils import profiling as jprofiling
    from red_diffeq_tpu_torch.utils import profiling

    for timer in (profiling.StepTimer(), jprofiling.StepTimer()):
        assert timer.summary() == '0 steps, 0.00 ms/step (0.00 steps/s)'
        clock = iter([0.0, 5.0, 5.0, 6.0, 6.0, 8.0, 8.0, 11.0])
        monkeypatch.setattr('time.perf_counter', lambda: next(clock))
        for _ in range(4):
            with timer:
                pass
        monkeypatch.undo()
        assert timer.times == [1.0, 2.0, 3.0] and timer.mean == 2.0
        assert timer.summary() == '3 steps, 2000.00 ms/step (0.50 steps/s)'
