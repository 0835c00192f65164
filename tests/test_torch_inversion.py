"""The port's inversion step against the JAX package's on the CPU.

Three steps of ``make_inversion_step`` at a small size (16x16 model,
nbc=60, nt=40, dim-8 U-Net with mults (1, 2) on the 18x18 padded grid,
20 diffusion steps). JAX's draws (the sigma_x0 noise, the RED timestep
and the RED noise) are fed to the port. Tolerances: mu atol 1e-5 (the
Adam step is 0.03, so this is 3e-4 of one update); losses and metrics
rtol 1e-4. The same three steps at nbc=8, where the t2 guard takes the
taped adjoint, hold the port's kernel backend to the JAX engine on its
Pallas kernels in interpret mode.
"""
from functools import partial

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from red_diffeq_tpu_torch.regularization.base import make_reg_fn
from red_diffeq_tpu_torch.ops.stencil import resolve_run_config
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward, Geometry
from red_diffeq_tpu_torch.utils import data_trans as tdt

CTX = dict(n_grid=16, nt=40, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
           gz=10, ng=16, ns=2)
TAPE_CTX = dict(CTX, nbc=8)
TS, LR, LAM, SIGMA = 3, 0.03, 0.75, 1e-4
KEYS = ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


def _problem():
    rng = np.random.RandomState(7)
    v_true = np.full((2, 1, 16, 16), 2000.0, np.float32)
    v_true[:, :, 9:] = 3200.0
    v_true += rng.uniform(-50, 50, v_true.shape).astype(np.float32)
    init = np.concatenate([jdt.prepare_initial_model(v_true[i:i + 1],
                                                     'smoothed', sigma=3.0)
                           for i in range(2)])
    mu0 = np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1)))
    return v_true, mu0


def _jax_steps(ctx, backend):
    """Three JAX inversion steps on ``backend``; returns the problem, the
    draws, every step's mu and metrics, and the U-Net's weights."""
    v_true, mu0 = _problem()
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
            reg_noise=np.asarray(jax.random.normal(kn, mu0.shape))))
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
    for name in ('l2', 'tv'):
        with pytest.raises(NotImplementedError):
            make_reg_fn(name)
    with pytest.raises(ValueError):
        make_reg_fn('diffusion')
    diff = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=18,
                             timesteps=20, device='cpu')
    with pytest.raises(NotImplementedError, match='patched'):
        make_reg_fn('diffusion', diff)(torch.zeros(1, 1, 18, 40))
