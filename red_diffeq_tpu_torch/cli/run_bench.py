"""Benchmark-method CLI: DiffusionFWI or ILVR-FWI over a dataset.

Counterpart of ``red_diffeq_tpu/cli/run_bench.py``, with the same flags and
run directory ``<results_dir>/<dataset>/<method>_<name>/<timestamp>/
<family>/``: the config snapshot, then one ``<i>_results.npz`` per sample
with the final model, the initial model, the ground truth and the curves
(``total_losses``, ``obs_losses``, ``ssim``, ``mae``, ``rmse``; one entry
per outer diffusion step, no ``reg_losses``). Unlike the inversion CLI the
initial model is not padded: the methods pad and crop around the denoiser
themselves. ``data.sample_index`` in the config picks one sample.

Run it on the card (the default) or, with ``--device cpu``, on the CPU:

    python -m red_diffeq_tpu_torch.cli.run_bench --method ilvr \\
        --config configs/ablation/OpenFWI_Ablation/ablation_all_tricks_dt30_ts10.yaml

The solver backend is the config's ``tpu.solver_backend``, read as the
inversion CLI reads it; ``tpu.mesh_data`` and ``tpu.mesh_shot`` are read by
neither this CLI nor the JAX one (the methods run on one device). The
datasets are read through the native loader (``io/native_loader.py``), the
next batch prefetched.
"""
import argparse
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from red_diffeq_tpu_torch.bench_methods.diffusion_fwi import DiffusionFWI
from red_diffeq_tpu_torch.bench_methods.ilvr_fwi import ILVR_FWI
from red_diffeq_tpu_torch.cli.run_inversion import (
    build_diffusion_model, build_forward_operator, get_data_files,
)
from red_diffeq_tpu_torch.config import (
    ConfigDict, get_config, load_config, save_config,
)
from red_diffeq_tpu_torch.io.native_loader import NpyBatchLoader, read_batches
from red_diffeq_tpu_torch.utils.data_trans import prepare_initial_model
from red_diffeq_tpu_torch.utils.device import resolve_device
from red_diffeq_tpu_torch.utils.seed_utils import next_key, set_seed


def _opt_get(config, name, default):
    return config.optimization.get(name, default)


def process_batch(seis_batch, vel_batch, config, bench, fwi_forward,
                  generator=None):
    """One batch through a bench method; returns (model, curves, initial
    model)."""
    inits = [
        prepare_initial_model(vel_batch[i:i + 1],
                              config.optimization.initial_type,
                              sigma=config.optimization.sigma)
        for i in range(vel_batch.shape[0])
    ]
    mu0 = torch.from_numpy(np.concatenate(inits, axis=0))   # not padded

    kwargs = dict(
        ts=config.optimization.ts,
        diffusion_ts=config.optimization.diffusion_ts,
        lr=config.optimization.lr,
        noise_std=config.optimization.noise_std,
        noise_type=config.optimization.noise_type,
        missing_number=config.optimization.missing_number,
        grad_norm=_opt_get(config, 'grad_norm', True),
        grad_smooth=_opt_get(config, 'grad_smooth', None),
        model_blur=_opt_get(config, 'model_blur', False),
        grad_clip=_opt_get(config, 'grad_clip', 1.0),
        use_patches=_opt_get(config, 'use_patches', False),
        patch_kernel_size=_opt_get(config, 'patch_kernel_size', None),
        patch_stride=_opt_get(config, 'patch_stride', None),
        generator=generator,
    )
    if isinstance(bench, ILVR_FWI):
        kwargs.update(
            use_ilvr=_opt_get(config, 'use_ilvr', True),
            ilvr_weight=_opt_get(config, 'ilvr_weight', 0.05),
            ilvr_down_schedule=_opt_get(config, 'ilvr_down_schedule',
                                        'linear'),
        )
    mu, per_model = bench.optimize(mu0, torch.from_numpy(vel_batch),
                                   torch.from_numpy(seis_batch), fwi_forward,
                                   **kwargs)
    return mu, per_model, mu0


def save_batch_results(batch_start, mu, per_model, mu0, vel_batch,
                       output_dir: Path) -> None:
    """One ``<i>_results.npz`` per sample, eight keys."""
    mu_np = mu.detach().cpu().numpy()
    mu0_np = mu0.cpu().numpy()
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
            ssim=np.asarray(curves['ssim']),
            mae=np.asarray(curves['mae']),
            rmse=np.asarray(curves['rmse']),
        )


def run_experiment(config: ConfigDict, method: str = 'diffusionfwi',
                   device=None) -> Path:
    """The whole run on ``device`` (default ``'cuda'``); returns the run
    directory."""
    dev = resolve_device(device)
    seed = config.experiment.random_seed
    if seed is not None:
        set_seed(int(seed), verbose=True)
    else:
        set_seed(int(np.random.randint(0, 2 ** 31)))
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'CPU'
    print(f'PyTorch {torch.__version__}, device: {dev} ({name})')

    print('Initializing models...')
    diffusion = build_diffusion_model(config, device=dev)
    fwi_forward = build_forward_operator(config, device=dev)
    if method in ('ilvr', 'ilvr_fwi'):
        bench = ILVR_FWI(diffusion, fwi_forward, device=dev)
    else:
        bench = DiffusionFWI(diffusion, fwi_forward, device=dev)
    print(f'Benchmark method: {type(bench).__name__}')

    seismic_dir = Path(config.data.seismic_data_dir).resolve()
    dataset_name = (seismic_dir.parts[-2] if len(seismic_dir.parts) >= 2
                    else None)
    timestamp = datetime.now().strftime('%Y%m%d_%H%M%S')
    results_dir = Path(config.experiment.results_dir)
    if dataset_name:
        results_dir = results_dir / dataset_name
    results_dir = (results_dir / f'{method}_{config.experiment.name}'
                   / timestamp)
    results_dir.mkdir(parents=True, exist_ok=True)
    save_config(config, results_dir / 'config.yaml')
    print(f'Results will be saved to: {results_dir}')

    for family_name in get_data_files(config):
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
                seis_batch, vel_batch, config, bench, fwi_forward,
                generator=next_key(dev))
            save_batch_results(batch_start, mu, per_model, mu0, vel_batch,
                               family_dir)

    print(f'\nExperiment complete! Results saved to: {results_dir}')
    return results_dir


def build_parser() -> argparse.ArgumentParser:
    def boolean(x):
        return x.lower() == 'true'

    p = argparse.ArgumentParser(
        description='Run benchmark diffusion FWI methods '
                    '(DiffusionFWI or ILVR-FWI), PyTorch',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument('--method', type=str,
                   choices=['diffusionfwi', 'ilvr', 'ilvr_fwi'],
                   default='diffusionfwi')
    p.add_argument('--config', type=Path, default=None)
    p.add_argument('--lr', type=float)
    p.add_argument('--ts', type=int,
                   help='FWI iterations per diffusion step')
    p.add_argument('--diffusion_ts', type=int,
                   help='Number of diffusion timesteps')
    p.add_argument('--grad_norm', type=boolean)
    p.add_argument('--grad_smooth', type=float)
    p.add_argument('--model_blur', type=boolean)
    p.add_argument('--grad_clip', type=float)
    p.add_argument('--use_ilvr', type=boolean)
    p.add_argument('--ilvr_weight', type=float)
    p.add_argument('--ilvr_down_schedule', type=str,
                   choices=['linear', 'stepwise'])
    p.add_argument('--use_patches', type=boolean)
    p.add_argument('--patch_height', type=int)
    p.add_argument('--patch_width', type=int)
    p.add_argument('--patch_stride_h', type=int)
    p.add_argument('--patch_stride_w', type=int)
    p.add_argument('--noise_type', choices=['gaussian', 'laplace'])
    p.add_argument('--noise_std', type=float)
    p.add_argument('--sigma', type=float)
    p.add_argument('--missing_number', type=int)
    p.add_argument('--batch_size', type=int)
    p.add_argument('--experiment_name', type=str)
    p.add_argument('--random_seed', type=int)
    p.add_argument('--results_dir', type=str, help='output root')
    p.add_argument('--device', default='cuda',
                   help="Device to run on ('cuda' or 'cpu'); 'cuda' raises "
                        'without a card')
    return p


def apply_overrides(config: ConfigDict,
                    args: argparse.Namespace) -> ConfigDict:
    o = config.optimization
    for name in ('lr', 'ts', 'diffusion_ts', 'grad_norm', 'grad_smooth',
                 'model_blur', 'grad_clip', 'use_ilvr', 'ilvr_weight',
                 'ilvr_down_schedule', 'use_patches', 'noise_type',
                 'noise_std', 'sigma', 'missing_number'):
        val = getattr(args, name, None)
        if val is not None:
            setattr(o, name, val)
    if args.patch_height is not None and args.patch_width is not None:
        o.patch_kernel_size = [args.patch_height, args.patch_width]
    if args.patch_stride_h is not None and args.patch_stride_w is not None:
        o.patch_stride = [args.patch_stride_h, args.patch_stride_w]
    if args.batch_size is not None:
        config.data.batch_size = args.batch_size
    if args.experiment_name is not None:
        config.experiment.name = args.experiment_name
    if args.random_seed is not None:
        config.experiment.random_seed = args.random_seed
    if args.results_dir is not None:
        config.experiment.results_dir = args.results_dir
    return config


def main(argv=None) -> Path:
    """Parse ``argv``, run the method and return the run directory."""
    args = build_parser().parse_args(argv)
    if args.config:
        print(f'Loading configuration from: {args.config}')
        config = load_config(args.config)
    else:
        print('No config file specified. Using default configuration.')
        config = get_config()
    config = apply_overrides(config, args)
    return run_experiment(config, method=args.method, device=args.device)


if __name__ == '__main__':
    main()
