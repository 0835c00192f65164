"""End-to-end OpenFWI example with the PyTorch port (counterpart of
``examples/example_openfwi.py``): run a single-sample RED-DiffEq inversion
through ``red_diffeq_tpu_torch.cli.run_inversion`` and show ground truth /
result / absolute error.

If the configured dataset directory does not exist, a synthetic
OpenFWI-style dataset is generated on the fly (the real datasets are not
distributable), with observations from a dt/2 + dx/2 refined solver, and
the shipped prior is used when present. The final MAE/RMSE/SSIM are
printed; the figure is drawn where matplotlib is installed.

Usage:
    python examples/torch_example_openfwi.py [--config configs/openfwi/red-diffeq.yaml]
        [--results_dir experiment/example_openfwi] [--device cuda]
        [any other flag of the inversion CLI, e.g. --ts 20]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from red_diffeq_tpu_torch.cli.run_inversion import (  # noqa: E402
    main as run_inversion_main,
)

PRIOR = ROOT / 'pretrained_models' / 'model-synthetic-ema.ckpt'


def ensure_dataset(config_path: str, device='cuda', root=None) -> list:
    """Create a synthetic dataset + config override under ``root`` (a new
    temporary directory by default) if the config's data is missing.
    Returns the inversion CLI's ``--config`` arguments."""
    import torch

    from red_diffeq_tpu_torch.config import load_config, save_config
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu_torch.solvers.acoustic import (
        FWIForward, refined_ctx, upsample_velocity,
    )
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize, v_normalize,
    )

    cfg = load_config(config_path)
    if Path(cfg.data.seismic_data_dir).exists():
        return ['--config', str(config_path)]

    print('dataset not found -> generating a synthetic OpenFWI-style one')
    root = (Path(tempfile.mkdtemp(prefix='red_diffeq_synth_'))
            if root is None else Path(root))
    (root / 'Seismic_Data').mkdir(parents=True, exist_ok=True)
    (root / 'Velocity_Data').mkdir(parents=True, exist_ok=True)
    vel = generate_mixed_dataset(2, h=70, w=int(cfg.pde.ng), seed=1234)
    # Observations come from a dt/2 + dx/2 refined solver at the same
    # physical acquisition, not from the solver the inversion itself uses,
    # so the metrics carry an honest forward-model mismatch (no inverse
    # crime), as in QUALITY.md. The refined grid's receiver line is strided
    # (every 2nd fine column), which only the plain path takes.
    op = FWIForward(refined_ctx(cfg.pde.to_dict(), factor=2),
                    sample_temporal=2, normalize=True,
                    v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend='plain', chunk=20,
                    device=device)
    vel_fine = torch.from_numpy(upsample_velocity(vel, factor=2))
    with torch.no_grad():
        seis = op(v_normalize(vel_fine.to(op.device))).cpu().numpy()
    np.save(root / 'Seismic_Data' / 'CV.npy', seis)
    np.save(root / 'Velocity_Data' / 'CV.npy', vel)

    cfg.data.seismic_data_dir = str(root / 'Seismic_Data')
    cfg.data.velocity_data_dir = str(root / 'Velocity_Data')
    if PRIOR.exists():
        cfg.diffusion.model_path = str(PRIOR)
    override = root / 'config.yaml'
    save_config(cfg, override)
    return ['--config', str(override)]


def plot_results(run_dir: Path, name: str = 'example_openfwi') -> dict:
    """Print the final MAE/RMSE/SSIM of the run's first sample and, where
    matplotlib imports, save the figure beside it. Returns the three."""
    npz = sorted(run_dir.rglob('*_results.npz'))[0]
    d = np.load(npz)
    final = {k: float(d[k][-1]) for k in ('mae', 'rmse', 'ssim')}
    print(f'Final MAE {final["mae"]:.4f}  RMSE {final["rmse"]:.4f}  '
          f'SSIM {final["ssim"]:.4f}')
    try:
        import matplotlib
    except ImportError:
        print('matplotlib is not installed: no figure drawn')
        return final
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    gt, res = d['ground_truth'], d['result']
    # result is in [-1, 1]; map ground truth for comparison
    gt_norm = (gt - 1500.0) / 3000.0 * 2.0 - 1.0
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    for ax, img, title in zip(
            axes, [gt_norm, res, np.abs(res - gt_norm)],
            ['ground truth', 'RED-DiffEq result', 'absolute error']):
        im = ax.imshow(img, cmap='jet')
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    out = run_dir / f'{name}.png'
    fig.savefig(out, dpi=120, bbox_inches='tight')
    plt.close(fig)
    print(f'Figure saved to {out}')
    return final


def main(argv=None, config='configs/openfwi/red-diffeq.yaml',
         results_dir='experiment/example_openfwi', name='example_openfwi',
         data_root=None) -> dict:
    """Parse ``argv`` (flags the example does not know go to the inversion
    CLI), make the dataset if needed (under ``data_root``), run sample 0
    and report it."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default=config)
    p.add_argument('--results_dir', default=results_dir)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args, rest = p.parse_known_args(argv)
    run_inversion_main(ensure_dataset(args.config, args.device, data_root)
                       + ['--sample_index', '0',
                          '--results_dir', args.results_dir,
                          '--random_seed', '8888', '--device', args.device,
                          *rest])
    run_dir = sorted(Path(args.results_dir).rglob('config.yaml'))[-1].parent
    return plot_results(run_dir, name=name)


if __name__ == '__main__':
    main()
