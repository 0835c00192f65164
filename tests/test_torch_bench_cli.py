"""The port's bench CLI against the JAX package's, on the CPU.

The JAX CLI runs DiffusionFWI on a tiny 2-sample dataset (the JAX tests'
fixture: 16x16 models, nt=50, nbc=8, a dim-8 U-Net checkpoint on disk,
3 outer x 2 inner steps, batch 2); the port's CLI then runs the config
snapshot that run wrote, on ``--device cpu``. Its run directory has the
same layout and every array of every ``<i>_results.npz`` matches: the
curves rtol 1e-4 (atol 1e-7), the model atol 3e-5 for the reason
``tests/test_torch_bench_methods.py`` gives (each outer step's denoise
carries the two U-Nets' fp32 difference), the rest exactly. ILVR-FWI is
held to the layout and finite values; its draws differ between the
packages.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from red_diffeq_tpu.cli import run_bench as jax_bench
from red_diffeq_tpu.config import get_config as jax_get_config
from red_diffeq_tpu.io.checkpoints import save_params
from red_diffeq_tpu.models.diffusion import GaussianDiffusion
from red_diffeq_tpu.models.unet import Unet
from red_diffeq_tpu.solvers.acoustic import FWIForward
from red_diffeq_tpu.utils.data_trans import v_denormalize, v_normalize
from red_diffeq_tpu_torch.cli import run_bench
from red_diffeq_tpu_torch.config import get_config

KEYS = ('result', 'initial_velocity', 'ground_truth', 'total_losses',
        'obs_losses', 'ssim', 'mae', 'rmse')


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """The JAX CLI's DiffusionFWI run; returns its run directory."""
    root = tmp_path_factory.mktemp('benchdata')
    (root / 'Synth' / 'seis').mkdir(parents=True)
    (root / 'Synth' / 'vel').mkdir()
    n, nt, ns, nbc = 16, 50, 2, 8
    ctx = dict(n_grid=n, nt=nt, dx=10.0, dt=0.001, nbc=nbc, f=15.0,
               sz=10, gz=10, ng=n, ns=ns)
    op = FWIForward(ctx, normalize=True, v_denorm_func=v_denormalize,
                    s_norm_func=lambda s: s, backend='xla', chunk=10)
    vel = np.full((2, 1, n, n), 2000.0, np.float32)
    vel[0, :, 8:, :] = 3000.0
    vel[1, :, 5:, :] = 2600.0
    np.save(root / 'Synth' / 'seis' / 'CF.npy',
            np.asarray(op(v_normalize(jnp.asarray(vel)))))
    np.save(root / 'Synth' / 'vel' / 'CF.npy', vel)
    d = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2), channels=1),
                          image_size=18, timesteps=12,
                          objective='pred_noise')
    d.init_params(jax.random.PRNGKey(0))
    save_params(d.params, root / 'model.ckpt')

    cfg = jax_get_config()
    for k, v in ctx.items():
        setattr(cfg.pde, k, v)
    cfg.model.dim = 8
    cfg.model.dim_mults = [1, 2]
    cfg.diffusion.image_size = 18
    cfg.diffusion.timesteps = 12
    cfg.diffusion.sampling_timesteps = 6
    cfg.diffusion.model_path = str(root / 'model.ckpt')
    cfg.optimization.ts = 2
    cfg.optimization.diffusion_ts = 3
    cfg.optimization.sigma = 3.0
    cfg.data.seismic_data_dir = str(root / 'Synth' / 'seis')
    cfg.data.velocity_data_dir = str(root / 'Synth' / 'vel')
    cfg.data.batch_size = 2
    cfg.experiment.random_seed = 8888
    cfg.experiment.results_dir = str(root / 'jax')
    cfg.tpu.solver_backend = 'xla'
    cfg.tpu.solver_chunk = 10
    return jax_bench.run_experiment(cfg, method='diffusionfwi')


def _port(config, method, out):
    return run_bench.main(['--config', str(config), '--method', method,
                           '--device', 'cpu', '--results_dir', str(out)])


def test_diffusionfwi_run_matches_jax(jax_run, tmp_path):
    out = _port(jax_run / 'config.yaml', 'diffusionfwi', tmp_path)
    jax_root = jax_run.parents[2]
    # <results_dir>/<dataset>/<method>_<name>/<timestamp>/
    assert out.relative_to(tmp_path).parts[:2] == \
        jax_run.relative_to(jax_root).parts[:2] == \
        ('Synth', 'diffusionfwi_red_diffeq_default')
    assert (out / 'config.yaml').is_file()
    npzs = sorted(p.relative_to(out) for p in out.glob('*/*_results.npz'))
    assert npzs == sorted(p.relative_to(jax_run)
                          for p in jax_run.glob('*/*_results.npz')) == [
        Path('CF/0_results.npz'), Path('CF/1_results.npz')]
    for rel in npzs:
        got, want = np.load(out / rel), np.load(jax_run / rel)
        assert sorted(got.files) == sorted(want.files) == sorted(KEYS)
        assert got['ssim'].shape == (3,)       # one per outer step
        for k in ('initial_velocity', 'ground_truth'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got['result'], want['result'], atol=3e-5,
                                   rtol=0)
        for k in KEYS[3:]:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    # The initial model is not padded.
    assert got['initial_velocity'].shape == got['result'].shape == (16, 16)


def test_ilvr_run_layout(jax_run, tmp_path):
    out = _port(jax_run / 'config.yaml', 'ilvr', tmp_path)
    assert out.relative_to(tmp_path).parts[1] == 'ilvr_red_diffeq_default'
    npzs = sorted(out.glob('CF/*_results.npz'))
    assert len(npzs) == 2
    for p in npzs:
        d = np.load(p)
        assert sorted(d.files) == sorted(KEYS)
        assert all(np.isfinite(d[k]).all() for k in KEYS)
        assert np.abs(d['result']).max() <= 1.0


def test_bench_cli_overrides():
    args = run_bench.build_parser().parse_args([
        '--method', 'ilvr', '--diffusion_ts', '7', '--grad_norm', 'false',
        '--grad_smooth', '2.0', '--model_blur', 'true',
        '--ilvr_weight', '0.2', '--use_patches', 'true',
        '--patch_height', '70', '--patch_width', '70',
        '--patch_stride_h', '1', '--patch_stride_w', '60',
        '--results_dir', '/tmp/bench_out', '--random_seed', '3',
    ])
    assert args.device == 'cuda'
    cfg = run_bench.apply_overrides(get_config(), args)
    assert cfg.optimization.diffusion_ts == 7
    assert cfg.optimization.grad_norm is False
    assert cfg.optimization.grad_smooth == 2.0
    assert cfg.optimization.model_blur is True
    assert cfg.optimization.ilvr_weight == 0.2
    assert cfg.optimization.patch_kernel_size == [70, 70]
    assert cfg.optimization.patch_stride == [1, 60]
    assert cfg.experiment.results_dir == '/tmp/bench_out'
    assert cfg.experiment.random_seed == 3
    # The JAX CLI's flags, and --device.
    assert sorted(vars(args)) == sorted([*vars(
        jax_bench.build_parser().parse_args([])), 'device'])
