"""The port's inversion CLI against the JAX package's on the CPU.

One tiny dataset (two 16x16 samples, nt=60, 2 shots, nbc=8) through both
CLIs with TV regularisation and clean observations: the same run-directory
layout, and every array of every ``<i>_results.npz`` at atol 1e-5. Then the
port alone on a 16x40 model with the patched RED (dim-8 U-Net at 18x18)
and corrupted observations; the flags and what is not ported; the
batches cut from the dataset files.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from red_diffeq_tpu.cli import run_inversion as jcli
from red_diffeq_tpu.config import get_config as jget_config
from red_diffeq_tpu.config import save_config as jsave_config
from red_diffeq_tpu.io import results as jresults
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils.data_trans import v_denormalize, v_normalize
from red_diffeq_tpu_torch.cli import run_inversion as cli
from red_diffeq_tpu_torch.config import get_config
from red_diffeq_tpu_torch.io import results
from red_diffeq_tpu_torch.models.unet import Unet

NPZ_KEYS = ('result', 'initial_velocity', 'ground_truth', 'total_losses',
            'obs_losses', 'reg_losses', 'ssim', 'mae', 'rmse')


def _ctx(n):
    return dict(n_grid=n, nt=60, dx=10.0, dt=0.001, nbc=8, f=15.0, sz=10,
                gz=10, ng=n, ns=2)


def _write_dataset(root: Path, width: int) -> dict:
    """Two models of 16 x ``width`` and their observations, in the
    reference layout ``root/{Seismic,Velocity}_Data/FV.npy``."""
    ctx = _ctx(width)
    op = JaxFWI(ctx, normalize=True, v_denorm_func=v_denormalize,
                s_norm_func=lambda s: s, backend='xla', chunk=10)
    # Two layers, perturbed as the inversion tests' models are: where two
    # neighbours are exactly equal, TV sits on the kink of |x| and Adam
    # turns a rounding-level difference between the packages into a
    # whole step.
    vel = np.full((2, 1, 16, width), 2000.0, np.float32)
    vel[0, :, 8:, :] = 3200.0
    vel[1, :, 5:, :] = 2800.0
    vel += np.random.RandomState(7).uniform(-50, 50, vel.shape).astype(
        np.float32)
    seis = np.asarray(op(v_normalize(jnp.asarray(vel))))
    for sub, arr in (('Seismic_Data', seis), ('Velocity_Data', vel)):
        (root / sub).mkdir(parents=True)
        np.save(root / sub / 'FV.npy', arr)
    return ctx


def _jax_config(root, ctx, results_dir):
    cfg = jget_config()
    for k, v in ctx.items():
        setattr(cfg.pde, k, v)
    cfg.data.seismic_data_dir = str(root / 'Seismic_Data')
    cfg.data.velocity_data_dir = str(root / 'Velocity_Data')
    cfg.data.batch_size = 2
    cfg.optimization.ts = 4
    cfg.optimization.regularization = 'tv'
    cfg.optimization.reg_lambda = 0.1
    cfg.optimization.sigma = 3.0
    cfg.experiment.results_dir = str(results_dir)
    cfg.experiment.random_seed = 8888
    cfg.tpu.solver_backend = 'xla'
    cfg.tpu.solver_chunk = 10
    return cfg


def _files(out: Path):
    return sorted(str(p.relative_to(out)) for p in out.rglob('*'))


def test_cli_matches_the_jax_cli(tmp_path):
    root = tmp_path / 'Synth'
    ctx = _write_dataset(root, 16)
    cfg = _jax_config(root, ctx, tmp_path / 'jax')
    jsave_config(cfg, tmp_path / 'tv.yaml')
    want = jcli.run_experiment(cfg)
    got = cli.main(['--config', str(tmp_path / 'tv.yaml'), '--device', 'cpu',
                    '--results_dir', str(tmp_path / 'port')])

    # <results_dir>/<dataset>/<name>/<timestamp>/, the same files below it.
    assert (want.relative_to(tmp_path / 'jax').parts[:2]
            == got.relative_to(tmp_path / 'port').parts[:2]
            == ('Synth', cfg.experiment.name))
    assert _files(got) == _files(want) == [
        'FV', 'FV/0_results.npz', 'FV/1_results.npz', 'config.yaml']
    for name in ('0_results.npz', '1_results.npz'):
        a, b = np.load(got / 'FV' / name), np.load(want / 'FV' / name)
        assert sorted(a.files) == sorted(b.files) == sorted(NPZ_KEYS)
        for k in NPZ_KEYS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0,
                                       err_msg=k)
    snap = yaml.safe_load((got / 'config.yaml').read_text())
    assert snap['tpu']['solver_backend'] == 'plain'
    assert snap['optimization'] == cfg.optimization.to_dict()
    # The aggregation over the run directories agrees too.
    np.testing.assert_allclose(
        list(results.load_marmousi(got / 'FV', True).values()),
        list(jresults.load_marmousi(want / 'FV', True).values()), atol=1e-5)
    np.testing.assert_allclose(
        results.load_openfwi(got, True, families=('FV',))['SSIM'],
        jresults.load_openfwi(want, True, families=('FV',))['SSIM'],
        atol=1e-5)


def test_cli_runs_the_patched_red_with_corrupted_observations(tmp_path):
    """A 16x40 model, wider than the 18-cell denoiser: one U-Net call of
    the 3 windows a step; laplace noise and 3 receivers missing."""
    root = tmp_path / 'Wide'
    ctx = _write_dataset(root, 40)
    cfg = get_config()
    for k, v in ctx.items():
        cfg.pde[k] = v
    cfg.model.dim, cfg.model.dim_mults = 8, (1, 2)
    cfg.diffusion.image_size, cfg.diffusion.timesteps = 18, 20
    # build_diffusion_model passes sampling_timesteps, at most timesteps.
    cfg.diffusion.sampling_timesteps = 20
    cfg.data.seismic_data_dir = str(root / 'Seismic_Data')
    cfg.data.velocity_data_dir = str(root / 'Velocity_Data')
    cfg.experiment.results_dir = str(tmp_path / 'results')
    cfg.experiment.random_seed = 3
    cfg.optimization.sigma = 3.0
    cfg.tpu.solver_chunk = 10

    cfg.diffusion.model_path = str(tmp_path / 'no-prior.ckpt')
    cli.apply_overrides(cfg, cli.build_parser().parse_args([
        '--ts', '2', '--sample_index', '1', '--noise_std', '0.05',
        '--noise_type', 'laplace', '--missing_number', '3']))

    calls = []

    def hook(module, args, out):
        if isinstance(module, Unet):
            calls.append(tuple(args[0].shape))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        with pytest.warns(UserWarning, match='no-prior'):
            out = cli.run_experiment(cfg, device='cpu')
    finally:
        handle.remove()
    assert calls == [(3, 1, 18, 18)] * 2
    assert _files(out) == ['FV', 'FV/1_results.npz', 'config.yaml']
    d = np.load(out / 'FV' / '1_results.npz')
    assert sorted(d.files) == sorted(NPZ_KEYS)
    assert d['result'].shape == (16, 40) and d['mae'].shape == (2,)
    assert all(np.isfinite(d[k]).all() for k in NPZ_KEYS)
    mu0 = cli.prepare_batch_initial_models(d['ground_truth'][None, None],
                                           cfg)
    assert tuple(mu0.shape) == (1, 1, 18, 42) and not mu0[:, :, 0].any()


def test_cli_flags_and_what_is_not_ported(monkeypatch, tmp_path):
    args = cli.build_parser().parse_args([
        '--lr', '0.5', '--ts', '7', '--regularization', 'tv',
        '--reg_lambda', '0.1', '--batch_size', '4',
        '--experiment_name', 'x', '--random_seed', '1',
        '--solver_backend', 'kernel', '--openfwi_families', 'CF', 'CV',
        '--noise_std', '0.1', '--missing_number', '2'])
    cfg = cli.apply_overrides(get_config(), args)
    assert (cfg.optimization.lr, cfg.optimization.ts) == (0.5, 7)
    assert cfg.optimization.regularization == 'tv'
    assert (cfg.optimization.noise_std, cfg.optimization.missing_number) \
        == (0.1, 2)
    assert cfg.data.batch_size == 4 and cfg.experiment.name == 'x'
    assert cfg.tpu.solver_backend == 'kernel'
    assert cfg.data.openfwi_families == ['CF', 'CV']
    assert args.device == 'cuda'
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(['--solver_backend', 'xla'])

    # A mesh is ported: tpu.mesh_* build one, over the CPU repeated with
    # --device cpu; on the card it needs as many cards as shards.
    cfg = get_config()
    assert cli.build_mesh(cfg, 'cpu') is None
    cfg.tpu.mesh_data, cfg.tpu.mesh_shot = 2, 5
    mesh = cli.build_mesh(cfg, 'cpu')
    assert mesh.shape == {'data': 2, 'shot': 5}
    assert list(mesh.devices.flat) == [torch.device('cpu')] * 10
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='needs 10 cards, and 1 are'):
        cli.build_mesh(cfg, 'cuda')
    assert cli.build_mesh(cfg, 'cuda', ['cpu'] * 10).shape['shot'] == 5
    # tpu.bf16_unet is ported: it reaches the denoiser as half_precision.
    cfg = get_config()
    cfg.model.dim, cfg.model.dim_mults = 8, (1, 2)
    cfg.diffusion.image_size = 16
    for bf16 in (True, False):
        cfg.tpu.bf16_unet = bf16
        assert cli.build_mesh(cfg, 'cpu') is None
        d = cli.build_diffusion_model(cfg, load_weights=False, device='cpu')
        assert d.half_precision is bf16
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--results_dir', str(tmp_path)])


def test_cli_cuts_batches_from_the_dataset_files(tmp_path):
    """With batch size 1 every sample is a batch of its own, holding its
    own row of the velocity file; a ``sample_index`` past the end skips
    the family and writes no result."""
    root = tmp_path / 'Synth'
    ctx = _write_dataset(root, 16)
    cfg = get_config()
    for k, v in ctx.items():
        cfg.pde[k] = v
    cfg.data.seismic_data_dir = str(root / 'Seismic_Data')
    cfg.data.velocity_data_dir = str(root / 'Velocity_Data')
    cfg.experiment.results_dir = str(tmp_path / 'results')
    cfg.optimization.sigma = 3.0
    cfg.tpu.solver_chunk = 10
    cli.apply_overrides(cfg, cli.build_parser().parse_args([
        '--ts', '1', '--batch_size', '1', '--regularization', 'none',
        '--random_seed', '5']))
    out = cli.run_experiment(cfg, device='cpu')
    assert _files(out) == [
        'FV', 'FV/0_results.npz', 'FV/1_results.npz', 'config.yaml']
    vel = np.load(root / 'Velocity_Data' / 'FV.npy')
    for i in range(2):
        d = np.load(out / 'FV' / f'{i}_results.npz')
        np.testing.assert_array_equal(d['ground_truth'], vel[i, 0])
        mu0 = cli.prepare_batch_initial_models(vel[i:i + 1], cfg)
        np.testing.assert_array_equal(d['initial_velocity'],
                                      mu0[0, 0, 1:-1, 1:-1].numpy())
        assert d['mae'].shape == (1,) and np.isfinite(d['result']).all()

    cfg.data.sample_index = 5
    cfg.experiment.results_dir = str(tmp_path / 'skipped')
    out = cli.run_experiment(cfg, device='cpu')
    assert _files(out) == ['FV', 'config.yaml']
