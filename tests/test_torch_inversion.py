"""The port's inversion step against the JAX package's on the CPU.

Three steps of ``make_inversion_step`` at a small size (16x16 model,
nbc=60, nt=40, dim-8 U-Net with mults (1, 2) on the 18x18 padded grid,
20 diffusion steps). JAX's draws (the sigma_x0 noise, the RED timestep
and the RED noise) are fed to the port. Tolerances: mu atol 1e-5 (the
Adam step is 0.03, so this is 3e-4 of one update); losses and metrics
rtol 1e-4. The same three steps at nbc=8, where the t2 guard takes the
taped adjoint, hold the port's kernel backend to the JAX engine on its
Pallas kernels in interpret mode. The sharded step over a (2 x 2) mesh of
the CPU repeated, on the same draws for the whole batch, is held to the
same unsharded JAX steps.
"""
from functools import partial

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from red_diffeq_tpu.core.inversion import InversionEngine as JaxEngine
from red_diffeq_tpu.core.inversion import \
    make_inversion_step as jax_make_step
from red_diffeq_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu.regularization.base import make_reg_fn as jax_make_reg
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.core import inversion
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.parallel.mesh import make_mesh
from red_diffeq_tpu_torch.regularization.base import make_reg_fn
from red_diffeq_tpu_torch.ops.stencil import resolve_run_config
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward, Geometry
from red_diffeq_tpu_torch.utils import data_trans as tdt
from red_diffeq_tpu_torch.utils.seed_utils import SeedContext

CTX = dict(n_grid=16, nt=40, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
           gz=10, ng=16, ns=2)
TAPE_CTX = dict(CTX, nbc=8)
WIDE_CTX = dict(CTX, n_grid=40, ng=40)
TS, LR, LAM, SIGMA = 3, 0.03, 0.75, 1e-4
KEYS = ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


def _problem(width=16):
    rng = np.random.RandomState(7)
    v_true = np.full((2, 1, 16, width), 2000.0, np.float32)
    v_true[:, :, 9:] = 3200.0
    v_true += rng.uniform(-50, 50, v_true.shape).astype(np.float32)
    init = np.concatenate([jdt.prepare_initial_model(v_true[i:i + 1],
                                                     'smoothed', sigma=3.0)
                           for i in range(2)])
    mu0 = np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1)))
    return v_true, mu0


def _jax_steps(ctx, backend):
    """Three JAX inversion steps on ``backend`` at the model width
    ``ctx['n_grid']``; returns the problem, the draws, every step's mu and
    metrics, and the U-Net's weights. A model wider than the denoiser's 18
    cells takes the patched RED, whose noise has the unpadded shape."""
    v_true, mu0 = _problem(ctx['n_grid'])
    patched = mu0.shape[-1] > 18
    op = JaxFWI(ctx, normalize=True, v_denorm_func=jdt.v_denormalize,
                s_norm_func=jdt.s_normalize_none, backend=backend, chunk=20)
    y = op(jdt.v_normalize(jnp.asarray(v_true)))
    diff = JaxDiffusion(JaxUnet(dim=8, dim_mults=(1, 2), channels=1),
                        image_size=18, timesteps=20)
    diff.init_params(jax.random.PRNGKey(3))
    optimizer = optax.adam(optax.cosine_decay_schedule(LR, TS, alpha=0.0))
    step = jax_make_step(op._forward, jax_make_reg('diffusion', diff),
                         optimizer, LAM, SIGMA, True)
    mu_true_norm = jdt.v_normalize(jnp.asarray(v_true))
    run = jax.jit(partial(step, y=y, mask=jnp.ones_like(y),
                          mu_true_norm=mu_true_norm))
    carry = (jnp.asarray(mu0), optimizer.init(jnp.asarray(mu0)))
    draws, mus, metrics = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(11), TS):
        key_x0, key_reg = jax.random.split(key)
        kt, kn = jax.random.split(key_reg)
        draws.append(dict(
            x0_noise=np.asarray(jax.random.normal(key_x0, mu0.shape)),
            t=np.asarray(jax.random.randint(kt, (2,), 0, 20)),
            reg_noise=np.asarray(jax.random.normal(
                kn, v_true.shape if patched else mu0.shape))))
        carry, m = run(carry, key)
        mus.append(np.asarray(carry[0]))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    params = jax.tree.map(np.asarray,
                          flax.serialization.to_state_dict(diff.params))
    return dict(v_true=v_true, mu0=mu0, y=np.array(y), draws=draws,
                mus=mus, metrics=metrics, params=params)


@pytest.fixture(scope='module')
def jax_run():
    return _jax_steps(CTX, 'xla')


@pytest.mark.parametrize('backend', ['plain', 'kernel'])
def test_three_steps_match_jax(jax_run, backend):
    _check_three_steps(jax_run, CTX, backend)


def test_three_steps_match_jax_on_the_tape_route():
    """nbc=8: the guard routes both packages to the taped adjoint; the port
    runs it through ``backend='kernel'`` (the tape kernels' plain versions
    on the CPU), JAX through ``_tape_kernel`` and ``_bwd_kernel`` in
    interpret mode."""
    geom = Geometry.from_ctx(TAPE_CTX)
    assert resolve_run_config(geom, 20)[0] == 'tape'
    _check_three_steps(_jax_steps(TAPE_CTX, 'pallas_interpret'), TAPE_CTX,
                       'kernel')


def test_three_wide_steps_match_jax():
    """A 16x40 model (18x42 padded), wider than the 18-cell denoiser: both
    packages take the patched RED (3 windows in one U-Net call)."""
    _check_three_steps(_jax_steps(WIDE_CTX, 'xla'), WIDE_CTX, 'plain')


def test_optimize_with_corrupted_observations_matches_jax():
    """Three ``optimize`` steps with TV on observations with gaussian noise
    and 5 of 16 receivers missing, the port fed JAX's corruption draws: mu
    atol 1e-5, curves rtol 1e-4."""
    v_true, mu0 = _problem()
    op = JaxFWI(CTX, normalize=True, v_denorm_func=jdt.v_denormalize,
                s_norm_func=jdt.s_normalize_none, backend='xla', chunk=20)
    y = np.array(op(jdt.v_normalize(jnp.asarray(v_true))))
    kw = dict(ts=TS, lr=LR, reg_lambda=0.5, noise_std=0.05,
              noise_type='gaussian', missing_number=5, regularization='tv')
    key = jax.random.PRNGKey(13)
    want_mu, want = JaxEngine(regularization='tv').optimize(
        mu0, v_true, y, op, key=key, progress=False, **kw)
    _, k_noise, k_miss = jax.random.split(key, 3)
    trace_mask = np.ones((2, 16), np.float32)
    for b, k in enumerate(jax.random.split(k_miss, 2)):
        trace_mask[b, np.asarray(jax.random.permutation(k, 16))[:5]] = 0.0
    port = FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                      s_norm_func=tdt.s_normalize_none, device='cpu')
    mu, got = inversion.InversionEngine(
        regularization='tv', device='cpu').optimize(
        mu0, v_true, y, port, progress=False,
        noise_draw=torch.from_numpy(np.array(jax.random.normal(k_noise,
                                                               y.shape))),
        trace_mask=torch.from_numpy(trace_mask), **kw)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), atol=1e-5,
                               rtol=0)
    for curves, want_curves in zip(got, want):
        for k in KEYS:
            np.testing.assert_allclose(curves[k], want_curves[k], rtol=1e-4,
                                       err_msg=k)


def _check_three_steps(r, ctx, backend):
    op = FWIForward(ctx, v_denorm_func=tdt.v_denormalize,
                    s_norm_func=tdt.s_normalize_none, backend=backend,
                    chunk=20, device='cpu')
    unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
    unet.load_state_dict(flax_to_state_dict(r['params'], unet))
    diff = GaussianDiffusion(unet, image_size=18, timesteps=20,
                             device='cpu')
    optimizer = inversion.Adam(inversion.cosine_decay_schedule(LR, TS))
    step = inversion.make_inversion_step(
        op, make_reg_fn('diffusion', diff), optimizer, LAM, SIGMA, True)
    y = torch.from_numpy(r['y'])
    mu = torch.from_numpy(r['mu0'])
    state = optimizer.init(mu)
    mu_true_norm = tdt.v_normalize(torch.from_numpy(r['v_true']))
    for i, d in enumerate(r['draws']):
        mu, state, m = step(
            mu, state, y=y, mask=torch.ones_like(y),
            mu_true_norm=mu_true_norm,
            **{k: torch.from_numpy(np.array(v)) for k, v in d.items()})
        np.testing.assert_allclose(mu.numpy(), r['mus'][i], atol=1e-5,
                                   rtol=0)
        for k in KEYS:
            np.testing.assert_allclose(m[k].numpy(), r['metrics'][i][k],
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_array_equal(m['t'].numpy(), r['metrics'][i]['t'])


def test_sharded_red_steps_match_jax_on_the_reverse_route(jax_run):
    """Three RED-DiffEq steps of the sharded step (data=2 x shot=2) at
    nbc=60, where the kernel backend takes the tape-free adjoint (its
    plain versions on the CPU), on JAX's U-Net weights and JAX's draws for
    the whole batch, against the unsharded JAX steps."""
    r = jax_run
    op = FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                    s_norm_func=tdt.s_normalize_none, backend='kernel',
                    chunk=20, device='cpu')
    unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
    unet.load_state_dict(flax_to_state_dict(r['params'], unet))
    diff = GaussianDiffusion(unet, image_size=18, timesteps=20, device='cpu')
    optimizer = inversion.Adam(inversion.cosine_decay_schedule(LR, TS))
    y = torch.from_numpy(r['y'])
    mesh = make_mesh(data=2, shot=2, devices=['cpu'] * 4)
    steps = inversion._MeshSteps(
        mesh, op, make_reg_fn('diffusion', diff), optimizer, LAM, SIGMA,
        True, y, torch.ones_like(y),
        tdt.v_normalize(torch.from_numpy(r['v_true'])))
    mu = torch.from_numpy(r['mu0'])
    mus, states = steps.split(mu), steps.split_state(optimizer.init(mu))
    for i, d in enumerate(r['draws']):
        mus, states, m = steps(mus, states, None, draws={
            k: torch.from_numpy(np.array(v)) for k, v in d.items()})
        np.testing.assert_allclose(steps.gather(mus).numpy(), r['mus'][i],
                                   atol=1e-5, rtol=0)
        for k in KEYS:
            np.testing.assert_allclose(m[k].numpy(), r['metrics'][i][k],
                                       rtol=1e-4, err_msg=k)
        np.testing.assert_array_equal(m['t'].numpy(), r['metrics'][i]['t'])


def test_cosine_adam_matches_optax():
    rng = np.random.RandomState(2)
    p = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [rng.standard_normal(p.shape).astype(np.float32)
             for _ in range(4)]
    opt = optax.adam(optax.cosine_decay_schedule(0.03, 4, alpha=0.0))
    jp, js = jnp.asarray(p), opt.init(jnp.asarray(p))
    port = inversion.Adam(inversion.cosine_decay_schedule(0.03, 4))
    tp, ts = torch.from_numpy(p), port.init(torch.from_numpy(p))
    for g in grads:
        u, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = port.update(torch.from_numpy(g), ts)
        tp = tp + tu
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-7)
    # The first update moves each entry by lr (cosine decay starts at lr).
    first, _ = port.update(torch.from_numpy(grads[0]),
                           port.init(torch.from_numpy(p)))
    np.testing.assert_allclose(first.abs().numpy(), 0.03, rtol=1e-4)


def test_optimize_runs_and_returns_per_model_curves():
    """``InversionEngine.optimize`` on the CPU: a few plain-path steps of
    unregularised FWI lower the observation loss."""
    v_true, mu0 = _problem()
    op = FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                    s_norm_func=tdt.s_normalize_none, device='cpu')
    assert op.backend == 'plain'
    y = op(tdt.v_normalize(torch.from_numpy(v_true)))
    engine = inversion.InversionEngine(regularization=None, device='cpu')
    mu, per_model = engine.optimize(mu0, v_true, y, op, ts=4, lr=0.01)
    assert tuple(mu.shape) == (2, 1, 16, 16)
    assert len(per_model) == 2
    for curves in per_model:
        assert set(curves) == set(KEYS)
        assert all(len(c) == 4 for c in curves.values())
        assert curves['obs_losses'][-1] < curves['obs_losses'][0]
    with pytest.raises(ValueError, match='Unknown regularization'):
        inversion.InversionEngine(regularization='Diffusion', device='cpu')
    with pytest.raises(ValueError, match='Diffusion model required'):
        engine.optimize(mu0, v_true, y, op, ts=1, regularization='diffusion')


def test_reg_dispatch():
    mu = torch.ones(3, 1, 4, 4)
    for name in (None, 'none', 'hybrid'):
        reg, t = make_reg_fn(name)(mu)
        assert t is None and torch.equal(reg, torch.zeros(3))
    ramp = torch.arange(16.0).reshape(1, 1, 4, 4).repeat(3, 1, 1, 1)
    for name, want in (('l2', 1.0 + 16.0), ('tv', 1.0 + 4.0)):
        reg, t = make_reg_fn(name)(ramp)
        assert t is None and torch.equal(reg, torch.full((3,), want))
    with pytest.raises(ValueError):
        make_reg_fn('diffusion')
    diff = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=18,
                             timesteps=20, device='cpu')
    calls = []
    diff.model.register_forward_hook(
        lambda m, args, out: calls.append(tuple(args[0].shape)))
    reg, t = make_reg_fn('diffusion', diff)(
        torch.zeros(1, 1, 18, 40), generator=torch.Generator().manual_seed(0))
    assert reg.shape == (1,) and t.shape == (1,)
    assert calls == [(3, 1, 18, 18)]    # the wide model's 3 windows at once


def test_optimize_without_a_generator_draws_anew_and_repeats_under_set_seed():
    """Without a generator, ``optimize`` takes the next one of the global
    sequence, as the JAX engine takes ``next_key()``: two calls draw
    different sigma_x0 and RED noise (different models and RED losses),
    and ``set_seed`` (here through ``SeedContext``) repeats them."""
    v_true, mu0 = _problem()
    op = FWIForward(dict(CTX, nt=20), v_denorm_func=tdt.v_denormalize,
                    s_norm_func=tdt.s_normalize_none, device='cpu')
    y = op(tdt.v_normalize(torch.from_numpy(v_true)))
    torch.manual_seed(0)
    diff = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=18,
                             timesteps=20, device='cpu')
    engine = inversion.InversionEngine(diff, regularization='diffusion',
                                       sigma_x0=SIGMA, device='cpu')

    def run():
        mu, per_model = engine.optimize(mu0, v_true, y, op, ts=1, lr=LR,
                                        reg_lambda=LAM)
        return mu, [c['reg_losses'][0] for c in per_model]

    with SeedContext(3):
        first, second = run(), run()
    assert not torch.equal(first[0], second[0])
    assert first[1] != second[1]
    with SeedContext(3):
        again = run()
    assert torch.equal(again[0], first[0]) and again[1] == first[1]
