"""The port's bench methods against the JAX package's, on the CPU.

The same numpy inputs, and JAX's own draws, go to both packages; JAX runs
on ``backend='xla'``, the port its plain versions. Tolerances: the filters,
the resizers and the patch split/merge atol 1e-6 (``resize_matrix`` exact);
DiffusionFWI and ILVR-FWI at the JAX tests' tiny shapes (16x16 model,
nt=50, nbc=8, dim-8 U-Net on the 18x18 padded grid, 12 diffusion steps):
every curve rtol 1e-4 (atol 1e-7 for values near 0), and the final model
atol 3e-5, looser than the inversion's 1e-5. The reason is the denoiser:
one posterior-mean denoise of the same model differs between the packages
by up to 4.5e-6 at t <= 5 (the two U-Nets' fp32 convolutions round
differently; ``tools/bench_prior_parity.py`` prints it), each outer step
starts with one, and the errors of 3-5 outer steps add up to 1-2.3e-5.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.bench_methods import diffusion_fwi as jfwi
from red_diffeq_tpu.bench_methods import filters as jfilters
from red_diffeq_tpu.bench_methods import ilvr_fwi as jilvr
from red_diffeq_tpu.bench_methods import resizer as jresizer
from red_diffeq_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.bench_methods import diffusion_fwi as tfwi
from red_diffeq_tpu_torch.bench_methods import filters as tfilters
from red_diffeq_tpu_torch.bench_methods import ilvr_fwi as tilvr
from red_diffeq_tpu_torch.bench_methods import resizer as tresizer
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
from red_diffeq_tpu_torch.utils import data_trans as tdt

CURVES = ('total_losses', 'obs_losses', 'ssim', 'mae', 'rmse')


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('shape,sigma', [((2, 1, 20, 24), 1.0),
                                         ((2, 1, 20, 24), 2.0),
                                         ((1, 2, 6, 7), 2.0)])
def test_gaussian_smooth_matches_jax(shape, sigma):
    """Symmetric padding (the edge cell repeated), also where the radius
    (8 at sigma 2) exceeds the side (6 x 7)."""
    x = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jfilters.gaussian_smooth(jnp.asarray(x), sigma))
    got = tfilters.gaussian_smooth(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_blur_and_clip_match_jax():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 1, 8, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tfilters.gaussian_blur_3x3(torch.from_numpy(x), 0.4).numpy(),
        np.asarray(jfilters.gaussian_blur_3x3(jnp.asarray(x), 0.4)),
        atol=1e-6, rtol=0)
    for max_norm in (0.5, 1e3):     # scaled down, left alone
        np.testing.assert_allclose(
            tfilters.clip_total_norm(torch.from_numpy(x),
                                     torch.tensor(max_norm)).numpy(),
            np.asarray(jfilters.clip_total_norm(jnp.asarray(x),
                                                jnp.float32(max_norm))),
            atol=1e-6, rtol=0)


def test_resizer_matches_jax():
    for kernel in ('cubic', 'lanczos2', 'lanczos3', 'box', 'linear', None):
        for args in ((64, 16, 0.25), (70, 5, 1 / 14), (5, 70, 14.0)):
            np.testing.assert_array_equal(
                tresizer.resize_matrix(*args, kernel=kernel),
                jresizer.resize_matrix(*args, kernel=kernel))
    x = np.random.RandomState(2).standard_normal((2, 1, 16, 44)).astype(
        np.float32)
    for factor in (2, 4, 16):
        jdown = jresizer.Resizer(x.shape, 1.0 / factor)
        jup = jresizer.Resizer((2, 1, *jdown.out_hw), output_shape=(16, 44))
        down = tresizer.Resizer(x.shape, 1.0 / factor, device='cpu')
        up = tresizer.Resizer((2, 1, *down.out_hw), output_shape=(16, 44),
                              device='cpu')
        assert down.out_hw == jdown.out_hw
        np.testing.assert_allclose(
            up(down(torch.from_numpy(x))).numpy(),
            np.asarray(jup(jdown(jnp.asarray(x)))), atol=1e-6, rtol=0)


@pytest.mark.parametrize('src,dst', [((70, 70), (40, 40)),
                                     ((40, 40), (70, 70)),
                                     ((16, 20), (16, 16)),
                                     ((70, 70), (70, 70))])
def test_bilinear_resize_matches_jax(src, dst):
    """``jax.image.resize`` antialiases when it shrinks (70 -> 40, 20 ->
    16); without ``antialias=True`` the port would differ by about 2."""
    x = np.random.RandomState(3).standard_normal((2, 1, *src)).astype(
        np.float32)
    np.testing.assert_allclose(
        tresizer.bilinear_resize(torch.from_numpy(x), dst).numpy(),
        np.asarray(jresizer.bilinear_resize(jnp.asarray(x), dst)),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize('batch', [1, 2])
def test_split_merge_match_jax(batch):
    x = np.random.RandomState(4).random((batch, 1, 16, 44)).astype(
        np.float32)
    want = jfwi.split_data_to_patches(jnp.asarray(x), (16, 20), (1, 12))
    got = tfwi.split_data_to_patches(torch.from_numpy(x), (16, 20), (1, 12))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[0] == 3 * batch
    # Windows scaled by their index, so that overlaps do not average to x.
    scaled = np.asarray(want) * np.arange(1, 3 * batch + 1,
                                          dtype=np.float32)[:, None, None,
                                                            None]
    np.testing.assert_allclose(
        tfwi.merge_patches_to_data(torch.from_numpy(scaled), (16, 44),
                                   (16, 20), (1, 12)).numpy(),
        np.asarray(jfwi.merge_patches_to_data(jnp.asarray(scaled), (16, 44),
                                              (16, 20), (1, 12))),
        atol=1e-6, rtol=0)
    merged = tfwi.merge_patches_to_data(got, (16, 44), (16, 20), (1, 12))
    np.testing.assert_allclose(merged.numpy(), x, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match='not a multiple'):
        tfwi.merge_patches_to_data(got[:-1], (16, 44), (16, 20), (1, 12))


@pytest.mark.parametrize('name,n', [('linear', 5), ('linear', 30),
                                    ('stepwise', 3), ('stepwise', 10),
                                    ('stepwise', 30)])
def test_ilvr_down_schedule_matches_jax(name, n):
    np.testing.assert_array_equal(tilvr.ilvr_down_schedule(name, n),
                                  jilvr.ilvr_down_schedule(name, n))
    with pytest.raises(ValueError, match='Unknown ilvr_down_schedule'):
        tilvr.ilvr_down_schedule('bogus', n)


# -- the methods end to end ---------------------------------------------

N, NT, NS, NBC = 16, 50, 2, 8
CTX = dict(n_grid=N, nt=NT, dx=10.0, dt=0.001, nbc=NBC, f=15.0, sz=10,
           gz=10, ng=N, ns=NS)


def _ops(ctx):
    jop = JaxFWI(ctx, normalize=True, v_denorm_func=jdt.v_denormalize,
                 s_norm_func=lambda s: s, backend='xla', chunk=10)
    top = FWIForward(ctx, v_denorm_func=tdt.v_denormalize,
                     s_norm_func=lambda s: s, backend='plain', chunk=10,
                     device='cpu')
    return jop, top


@pytest.fixture(scope='module')
def setup():
    jd = JaxDiffusion(JaxUnet(dim=8, dim_mults=(1, 2), channels=1),
                      image_size=18, timesteps=12, objective='pred_noise')
    jd.init_params(jax.random.PRNGKey(0))
    unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
    unet.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            jd.params)), unet))
    td = GaussianDiffusion(unet, image_size=18, timesteps=12, device='cpu')
    return jd, td


def _problem(width=N):
    """Two layered models (m/s) of 16 x ``width``, and initial models."""
    v_true = np.full((2, 1, N, width), 2000.0, np.float32)
    v_true[0, :, 8:] = 3000.0
    v_true[1, :, 5:] = 2600.0
    mu0 = np.asarray(jdt.v_normalize(
        np.full((2, 1, N, width), 2400.0, np.float32)))
    return v_true, mu0


def _corruption_draws(key, y_shape, noise_std, missing):
    """JAX's draws for the observation corruption of ``optimize``, and the
    key its steps fold in."""
    key, k_noise, k_miss = jax.random.split(key, 3)
    draws = {}
    if noise_std > 0:
        draws['noise_draw'] = _t(jax.random.normal(k_noise, y_shape))
    if missing > 0:
        mask = np.ones((y_shape[0], y_shape[-1]), np.float32)
        for b, k in enumerate(jax.random.split(k_miss, y_shape[0])):
            mask[b, np.asarray(jax.random.permutation(k, y_shape[-1]))
                 [:missing]] = 0.0
        draws['trace_mask'] = torch.from_numpy(mask)
    return key, draws


def _check(got, want):
    (mu, curves), (jmu, jcurves) = got, want
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=3e-5,
                               rtol=0)
    for c, jc in zip(curves, jcurves):
        for k in CURVES:
            np.testing.assert_allclose(np.asarray(c[k]), np.asarray(jc[k]),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


# (method kwargs, ts, diffusion_ts, observation noise, missing receivers)
CASES = {
    'all_tricks': (dict(grad_norm=True, grad_smooth=1.0, model_blur=True,
                        grad_clip=1.1), 3, 4, 0.05, 3),
    'no_tricks': (dict(grad_norm=False, grad_smooth=None, model_blur=False,
                       grad_clip=1.0), 2, 3, 0.0, 0),
    'grad_norm_only': (dict(grad_norm=True, grad_smooth=None,
                            model_blur=False, grad_clip=1.0), 2, 3, 0.0, 0),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_diffusionfwi_matches_jax(setup, case):
    """Batch 2, so that the first step's max |g| is the whole batch's."""
    jd, td = setup
    kw, ts, dts, noise_std, missing = CASES[case]
    jop, top = _ops(CTX)
    v_true, mu0 = _problem()
    y = np.array(jop(jdt.v_normalize(jnp.asarray(v_true))))
    key = jax.random.PRNGKey(5)
    common = dict(ts=ts, diffusion_ts=dts, lr=0.05, noise_std=noise_std,
                  missing_number=missing, progress=False, **kw)
    want = jfwi.DiffusionFWI(jd, jop).optimize(
        jnp.asarray(mu0), jnp.asarray(v_true), jnp.asarray(y), jop, key=key,
        **common)
    _, draws = _corruption_draws(key, y.shape, noise_std, missing)
    got = tfwi.DiffusionFWI(td, top, device='cpu').optimize(
        mu0, v_true, y, top, **common, **draws)
    _check(got, want)


@pytest.mark.parametrize('schedule,dts', [('linear', 4), ('stepwise', 5)])
def test_ilvr_fwi_matches_jax(setup, schedule, dts):
    """JAX's hook noise of step t, normal(fold_in(key, t)), fed to the port
    as ``ilvr_noise[t]``."""
    jd, td = setup
    jop, top = _ops(CTX)
    v_true, mu0 = _problem()
    y = np.array(jop(jdt.v_normalize(jnp.asarray(v_true))))
    key = jax.random.PRNGKey(6)
    common = dict(ts=2, diffusion_ts=dts, lr=0.05, grad_smooth=1.0,
                  model_blur=True, ilvr_weight=0.1,
                  ilvr_down_schedule=schedule, progress=False)
    jbench = jilvr.ILVR_FWI(jd, jop)
    want = jbench.optimize(jnp.asarray(mu0), jnp.asarray(v_true),
                           jnp.asarray(y), jop, key=key, **common)
    step_key, _ = _corruption_draws(key, y.shape, 0.0, 0)
    ilvr_noise = torch.stack([_t(jax.random.normal(
        jax.random.fold_in(step_key, s), mu0.shape)) for s in range(dts)])
    bench = tilvr.ILVR_FWI(td, top, device='cpu')
    got = bench.optimize(mu0, v_true, y, top, ilvr_noise=ilvr_noise,
                         **common)
    np.testing.assert_array_equal(bench.down_n, jbench.down_n)
    _check(got, want)


def test_patched_diffusionfwi_matches_jax(setup):
    """A 16x44 model in 16x20 windows at stride (1, 12): 3 windows, each
    shrunk to the denoiser's 16x16 (antialiased) and grown back, all in one
    U-Net call."""
    jd, td = setup
    w = 44
    ctx = dict(CTX, nt=40, ng=w, gx=list(range(w)), sx=[5, 38])
    jop, top = _ops(ctx)
    v_true, mu0 = _problem(w)
    y = np.array(jop(jdt.v_normalize(jnp.asarray(v_true))))
    common = dict(ts=2, diffusion_ts=3, lr=0.05, grad_smooth=1.0,
                  use_patches=True, patch_kernel_size=[16, 20],
                  patch_stride=[1, 12], progress=False)
    want = jfwi.DiffusionFWI(jd, jop).optimize(
        jnp.asarray(mu0), jnp.asarray(v_true), jnp.asarray(y), jop,
        key=jax.random.PRNGKey(7), **common)
    calls = []
    handle = td.model.register_forward_hook(
        lambda m, args, out: calls.append(tuple(args[0].shape)))
    try:
        got = tfwi.DiffusionFWI(td, top, device='cpu').optimize(
            mu0, v_true, y, top, **common)
    finally:
        handle.remove()
    assert calls == [(6, 1, 18, 18)] * 3     # 3 windows x 2 samples a step
    _check(got, want)


def test_validation_and_fresh_draws(setup):
    _, td = setup
    _, top = _ops(CTX)
    v_true, mu0 = _problem()
    y = top(tdt.v_normalize(torch.from_numpy(v_true)))
    bench = tilvr.ILVR_FWI(td, top, device='cpu')
    with pytest.raises(ValueError, match='Batch size mismatch'):
        bench.optimize(np.concatenate([mu0, mu0]), v_true, y, top, ts=1,
                       diffusion_ts=1)
    with pytest.raises(ValueError, match='callable'):
        bench.optimize(mu0, v_true, y, None, ts=1, diffusion_ts=1)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return bench.optimize(mu0, v_true, y, top, ts=1, diffusion_ts=2,
                              generator=gen, progress=False)[0]

    # The hook's noise comes from the generator: repeated, and new with
    # another seed.
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
