"""Inversion experiment CLI.

Counterpart of ``red_diffeq_tpu/cli/run_inversion.py``, with the same flags
and run directory: a three-tier config (defaults < YAML < flags), a loop
over the dataset's .npy families, a timestamped run directory
``<results_dir>/<dataset>/<name>/<timestamp>/`` with a config snapshot, and
per-sample ``<i>_results.npz`` files holding the final model, the initial
model, the ground truth and the per-step metric curves.

Run it on the card (the default) or, with ``--device cpu``, on the CPU:

    python -m red_diffeq_tpu_torch.cli.run_inversion \\
        --config configs/marmousi/red-diffeq.yaml --device cuda

``--solver_backend`` is 'auto' (the kernels on the card, the plain path on
the CPU), 'plain' or 'kernel'; a config file's 'xla' and 'pallas' are read
as 'plain' and 'kernel'. ``tpu.bf16_unet`` runs the U-Net in bf16
(``GaussianDiffusion(half_precision=True)``). ``tpu.use_scan`` (default
true, the presets' setting) is passed on as in the JAX CLI: on the card the
inversion step is a CUDA graph, captured at a batch's first step and
replayed (``InversionEngine.optimize``); false runs the eager loop.
``tpu.remat`` is accepted and changes nothing: the port always recomputes a
chunk in its backward. ``tpu.mesh_data`` x ``tpu.mesh_shot`` > 1 runs
each batch over a ('data', 'shot') mesh of the visible cards
(:func:`build_mesh`; ``['cpu'] * (data * shot)`` with ``--device cpu``).
The datasets are read through the native loader
(``io/native_loader.py``), the next batch prefetched.
"""
import argparse
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from red_diffeq_tpu_torch.config import (
    ConfigDict, get_config, load_config, save_config,
)
from red_diffeq_tpu_torch.core.inversion import InversionEngine
from red_diffeq_tpu_torch.io.checkpoints import load_diffusion_params
from red_diffeq_tpu_torch.io.native_loader import NpyBatchLoader, read_batches
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.parallel.mesh import make_mesh
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
from red_diffeq_tpu_torch.utils.data_trans import (
    prepare_initial_model, s_normalize_none, v_denormalize,
)
from red_diffeq_tpu_torch.utils.device import resolve_device
from red_diffeq_tpu_torch.utils.seed_utils import next_key, set_seed


def build_diffusion_model(config: ConfigDict, load_weights: bool = True,
                          device=None) -> GaussianDiffusion:
    """The denoiser bundle; without weights, a U-Net initialised from
    torch's generator seeded with 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = Unet(dim=config.model.dim,
                     dim_mults=tuple(config.model.dim_mults),
                     channels=config.model.channels,
                     flash_attn=config.model.get('flash_attn', False))
    diffusion = GaussianDiffusion(
        model,
        image_size=config.diffusion.image_size,
        timesteps=config.diffusion.timesteps,
        sampling_timesteps=config.diffusion.get('sampling_timesteps', None),
        objective=config.diffusion.objective,
        half_precision=bool(config.get('tpu', {}).get('bf16_unet', False)),
        device=device,
    )
    if load_weights:
        load_diffusion_params(diffusion, config.diffusion.model_path)
    return diffusion


def build_forward_operator(config: ConfigDict, device=None) -> FWIForward:
    tpu_cfg = config.get('tpu', {})
    return FWIForward(
        config.pde.to_dict(),
        normalize=True,
        v_denorm_func=v_denormalize,
        s_norm_func=s_normalize_none,
        backend=tpu_cfg.get('solver_backend', 'auto'),
        chunk=int(tpu_cfg.get('solver_chunk', 20)),
        remat=bool(tpu_cfg.get('remat', True)),
        device=device,
    )


def get_data_files(config: ConfigDict) -> list:
    """The dataset's family files, filtered by ``openfwi_families``."""
    seismic_dir = Path(config.data.seismic_data_dir)
    if not seismic_dir.exists():
        raise FileNotFoundError(
            f'Seismic data directory not found: {seismic_dir}')
    family_files = sorted(seismic_dir.glob(config.data.data_pattern))
    if not family_files:
        raise ValueError(
            f'No data files found matching {config.data.data_pattern} '
            f'in {seismic_dir}')
    all_families = [f.name for f in family_files]

    wanted = config.data.get('openfwi_families', None)
    if not wanted:
        return all_families
    if isinstance(wanted, str):
        wanted = [wanted]
    wanted = [w if w.endswith('.npy') else f'{w}.npy'
              for w in wanted if w is not None]
    if not wanted:
        return all_families
    result = [f for f in all_families if f in wanted]
    if not result:
        raise ValueError(f'No matching families found. Requested: {wanted}, '
                         f'Available: {all_families}')
    return result


def prepare_batch_initial_models(vel_batch: np.ndarray,
                                 config: ConfigDict) -> torch.Tensor:
    """Initial model per sample, zero-padded by one cell to the denoiser
    grid."""
    inits = [
        prepare_initial_model(
            vel_batch[i:i + 1],
            config.optimization.initial_type,
            sigma=config.optimization.sigma,
        )
        for i in range(vel_batch.shape[0])
    ]
    init = np.concatenate(inits, axis=0)
    return torch.from_numpy(np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1))))


def build_mesh(config: ConfigDict, device=None, devices=None):
    """The ('data', 'shot') mesh of the ``tpu`` section's ``mesh_data`` x
    ``mesh_shot``, or None for 1 x 1. Its devices are ``devices`` if given
    (a list that may repeat a device), else the visible cards for a CUDA
    ``device`` (raising, with both numbers, when there are fewer than the
    mesh needs), else ``device`` repeated."""
    tpu_cfg = config.get('tpu', {})
    data = int(tpu_cfg.get('mesh_data', 1))
    shot = int(tpu_cfg.get('mesh_shot', 1))
    if data * shot <= 1:
        return None
    if devices is None:
        dev = torch.device('cuda' if device is None else device)
        if dev.type == 'cuda':
            count = torch.cuda.device_count()
            if count < data * shot:
                raise ValueError(
                    f'the mesh mesh_data={data} x mesh_shot={shot} needs '
                    f'{data * shot} cards, and {count} are visible')
        else:
            devices = [dev] * (data * shot)
    return make_mesh(data=data, shot=shot, devices=devices)


def process_batch(seis_batch, vel_batch, config, engine, fwi_forward,
                  generator=None, mesh=None):
    """One batch through the engine, over ``mesh`` if given."""
    mu0 = prepare_batch_initial_models(vel_batch, config)
    reg = config.optimization.regularization
    reg = None if (not reg or reg == 'none') else reg
    mu, per_model = engine.optimize(
        mu0,
        torch.from_numpy(vel_batch),
        torch.from_numpy(seis_batch),
        fwi_forward,
        ts=config.optimization.ts,
        lr=config.optimization.lr,
        reg_lambda=config.optimization.reg_lambda,
        noise_std=config.optimization.noise_std,
        noise_type=config.optimization.noise_type,
        missing_number=config.optimization.missing_number,
        regularization=reg,
        generator=generator,
        use_scan=bool(config.get('tpu', {}).get('use_scan', True)),
        mesh=mesh,
    )
    return mu, per_model, mu0


def save_batch_results(batch_start, mu, per_model, mu0, vel_batch,
                       output_dir: Path) -> None:
    """One ``<i>_results.npz`` per sample."""
    mu_np = mu.detach().cpu().numpy()
    mu0_np = mu0.cpu().numpy()[:, :, 1:-1, 1:-1]
    output_dir.mkdir(parents=True, exist_ok=True)
    for i in range(mu_np.shape[0]):
        curves = per_model[i]
        np.savez(
            str((output_dir / f'{batch_start + i}_results.npz').resolve()),
            result=mu_np[i, 0],
            initial_velocity=mu0_np[i, 0],
            ground_truth=np.asarray(vel_batch)[i, 0],
            total_losses=np.asarray(curves['total_losses']),
            obs_losses=np.asarray(curves['obs_losses']),
            reg_losses=np.asarray(curves['reg_losses']),
            ssim=np.asarray(curves['ssim']),
            mae=np.asarray(curves['mae']),
            rmse=np.asarray(curves['rmse']),
        )


def run_experiment(config: ConfigDict, device=None,
                   mesh_devices=None) -> Path:
    """The whole experiment on ``device`` (default ``'cuda'``); returns the
    run directory. ``mesh_devices``: the devices of the ``tpu`` section's
    mesh (:func:`build_mesh`), e.g. one card repeated."""
    dev = resolve_device(device)
    seed = config.experiment.random_seed
    if seed is not None:
        set_seed(int(seed), verbose=True)
    else:
        print('No random seed set - experiment will be non-deterministic')
        set_seed(int(np.random.randint(0, 2 ** 31)))
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'CPU'
    print(f'PyTorch {torch.__version__}, device: {dev} ({name})')
    mesh = build_mesh(config, dev, mesh_devices)

    needs_diffusion = config.optimization.regularization == 'diffusion'
    print('Initializing models...')
    diffusion = (build_diffusion_model(config, device=dev)
                 if needs_diffusion else None)
    fwi_forward = build_forward_operator(config, device=dev)

    engine = InversionEngine(
        diffusion,
        regularization=(config.optimization.regularization
                        if config.optimization.regularization else None),
        use_time_weight=bool(config.optimization.get('use_time_weight',
                                                     False)),
        sigma_x0=float(config.optimization.get('sigma_x0', 0.0001)),
        fixed_timestep=config.optimization.get('fixed_timestep', None),
        device=dev,
    )

    seismic_dir = Path(config.data.seismic_data_dir).resolve()
    dataset_name = (seismic_dir.parts[-2] if len(seismic_dir.parts) >= 2
                    else None)
    timestamp = datetime.now().strftime('%Y%m%d_%H%M%S')
    results_dir = Path(config.experiment.results_dir)
    if dataset_name:
        results_dir = results_dir / dataset_name
    results_dir = results_dir / config.experiment.name / timestamp
    results_dir.mkdir(parents=True, exist_ok=True)
    print(f'Results will be saved to: {results_dir}')
    save_config(config, results_dir / 'config.yaml')

    family_files = get_data_files(config)
    print(f'Found {len(family_files)} data families to process')
    if mesh is not None:
        print(f'Device mesh: data={mesh.shape["data"]} '
              f'shot={mesh.shape["shot"]}')

    for family_name in family_files:
        print(f'\nProcessing: {family_name}')
        family_dir = results_dir / Path(family_name).stem
        family_dir.mkdir(exist_ok=True)
        # Native mmap loaders with the next batch prefetched (numpy's mmap
        # without a toolchain).
        seis = NpyBatchLoader(Path(config.data.seismic_data_dir) / family_name)
        vel = NpyBatchLoader(Path(config.data.velocity_data_dir) / family_name)
        num_models = len(seis)

        sample_index = config.data.get('sample_index', None)
        if sample_index is not None:
            if sample_index < 0 or sample_index >= num_models:
                print(f'Warning: sample_index {sample_index} out of range '
                      f'[0, {num_models - 1}]. Skipping {family_name}.')
                seis.close()
                vel.close()
                continue
            batches = [(sample_index, sample_index + 1)]
        else:
            bs = config.data.batch_size
            batches = [(s, min(s + bs, num_models))
                       for s in range(0, num_models, bs)]

        for batch_start, batch_end, seis_batch, vel_batch in read_batches(
                seis, vel, batches):
            mu, per_model, mu0 = process_batch(
                seis_batch, vel_batch, config, engine, fwi_forward,
                generator=next_key(dev), mesh=mesh)
            save_batch_results(batch_start, mu, per_model, mu0, vel_batch,
                               family_dir)

    print(f'\nExperiment complete! Results saved to: {results_dir}')
    return results_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='Run Full Waveform Inversion with RED-DiffEq (PyTorch)',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--config', type=Path, default=None,
                   help='Path to YAML configuration file')
    p.add_argument('--lr', type=float, help='Learning rate')
    p.add_argument('--ts', type=int, help='Number of optimization steps')
    p.add_argument('--regularization',
                   choices=['diffusion', 'tv', 'l2', 'none'],
                   help='Regularization type')
    p.add_argument('--reg_lambda', type=float, help='Regularization weight')
    p.add_argument('--noise_type', choices=['gaussian', 'laplace'],
                   help='Observation noise type')
    p.add_argument('--noise_std', type=float,
                   help='Noise std (gaussian) or scale (laplace)')
    p.add_argument('--sigma', type=float, help='Initial model smoothing sigma')
    p.add_argument('--sigma_x0', type=float,
                   help='Pre-noise added to mu before the diffusion forward '
                        'process')
    p.add_argument('--missing_number', type=int, help='Number of missing traces')
    p.add_argument('--batch_size', type=int, help='Batch size')
    p.add_argument('--experiment_name', type=str, help='Experiment name')
    p.add_argument('--results_dir', type=Path, help='Base results directory')
    p.add_argument('--random_seed', type=int, help='Random seed')
    p.add_argument('--openfwi_families', type=str, nargs='+',
                   help='OpenFWI families to process (e.g., CF CV)')
    p.add_argument('--sample_index', type=int, default=None,
                   help='Process only this sample index')
    p.add_argument('--solver_backend', choices=['auto', 'plain', 'kernel'],
                   help='FD solver backend')
    p.add_argument('--device', default='cuda',
                   help="Device to run on ('cuda' or 'cpu'); 'cuda' raises "
                        'without a card')
    return p


def apply_overrides(config: ConfigDict,
                    args: argparse.Namespace) -> ConfigDict:
    o, d, e = config.optimization, config.data, config.experiment
    if args.lr is not None:
        o.lr = args.lr
    if args.ts is not None:
        o.ts = args.ts
    if args.regularization is not None:
        o.regularization = args.regularization
    if args.reg_lambda is not None:
        o.reg_lambda = args.reg_lambda
    if args.noise_type is not None:
        o.noise_type = args.noise_type
    if args.noise_std is not None:
        o.noise_std = args.noise_std
    if args.sigma is not None:
        o.sigma = args.sigma
    if args.sigma_x0 is not None:
        o.sigma_x0 = args.sigma_x0
    if args.missing_number is not None:
        o.missing_number = args.missing_number
    if args.batch_size is not None:
        d.batch_size = args.batch_size
    if args.experiment_name is not None:
        e.name = args.experiment_name
    if args.results_dir is not None:
        e.results_dir = str(args.results_dir)
    if args.random_seed is not None:
        e.random_seed = args.random_seed
    if args.openfwi_families is not None:
        d.openfwi_families = args.openfwi_families
    if args.sample_index is not None:
        d.sample_index = args.sample_index
    if args.solver_backend is not None:
        if 'tpu' not in config:
            config.tpu = ConfigDict()
        config.tpu.solver_backend = args.solver_backend
    return config


def main(argv=None) -> Path:
    """Parse ``argv``, run the experiment and return the run directory."""
    args = build_parser().parse_args(argv)
    if args.config:
        print(f'Loading configuration from: {args.config}')
        config = load_config(args.config)
    else:
        print('No config file specified. Using default configuration.')
        config = get_config()
    config = apply_overrides(config, args)
    return run_experiment(config, device=args.device)


if __name__ == '__main__':
    main()
