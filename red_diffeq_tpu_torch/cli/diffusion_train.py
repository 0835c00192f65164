"""Diffusion pretraining CLI (``red-diffeq-torch-train``).

Counterpart of ``red_diffeq_tpu/cli/diffusion_train.py:1-119`` (reference
``scripts/diffusion_train.py:1-77``), with the same flags and defaults and
one more, ``--device``: trains the 72x72 single-channel denoiser (a dim-64
U-Net, ``dim_mults`` (1, 2, 4, 8), 1000 timesteps, 250 DDIM sampling
steps, ``pred_noise``) on velocity maps normalised (v - 1500)/3000 to
[0, 1] and zero-padded by one pixel, batch 32, lr 2e-4, EMA 0.995, for
400k steps unless told otherwise. Milestones (``model-<k>.ckpt``, sample
grids, the losses JSON, ``fid_scores.json`` with ``--calculate_fid``) go
to ``--results_folder``; ``tools/export_ema_torch.py`` turns one into a
bare EMA prior in the shipped prior's format.

    python -m red_diffeq_tpu_torch.cli.diffusion_train \\
        --data_dir dataset/OpenFWI/Velocity_Data --results_folder results/t
    python -m red_diffeq_tpu_torch.cli.diffusion_train --data_dir \\
        /tmp/Synth/Velocity_Data --image_size 16 --dim 8 --batch_size 16 \\
        --train_num_steps 4 --save_every 2 --device cpu

The U-Net's initial weights come from torch's generator seeded with 0 (the
trainer's seed).
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.trainer import (
    ImageFolderDataset, TensorDataset, Trainer,
)
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.utils.device import resolve_device


def load_velocity_datasets(data_dir: Path, families=None, split: float = 0.9):
    """Load and concatenate velocity .npy families; train/val split
    (reference diffusion_train.py:22-56)."""
    files = sorted(Path(data_dir).glob('*.npy'))
    if families:
        # The reference uses '_b'-suffixed family names (CurveVel_b, ...);
        # the dataset generators write unsuffixed files (CurveVel.npy).
        # Accept either spelling against either layout.
        def _stems(f):
            stem = f[:-4] if f.endswith('.npy') else f
            base = stem[:-2] if stem.endswith('_b') else stem
            return {base, base + '_b'}
        wanted = {s + '.npy' for f in families for s in _stems(f)}
        files = [f for f in files if f.name in wanted]
    if not files:
        raise FileNotFoundError(f'no velocity .npy files in {data_dir}')
    train_parts, val_parts = [], []
    for f in files:
        arr = np.load(f).astype(np.float32)
        n_train = int(len(arr) * split)
        train_parts.append(arr[:n_train])
        val_parts.append(arr[n_train:])
    return np.concatenate(train_parts), np.concatenate(val_parts)


def prepare_images(vel: np.ndarray) -> np.ndarray:
    """(N,1,70,70) m/s -> (N,1,72,72) in [0,1]
    (reference diffusion_train.py:59-61)."""
    img = (vel - 1500.0) / 3000.0
    return np.pad(img, ((0, 0), (0, 0), (1, 1), (1, 1)))


def build_parser():
    p = argparse.ArgumentParser(description='Pretrain the diffusion denoiser')
    p.add_argument('--data_dir', type=Path,
                   default=Path('dataset/OpenFWI/Velocity_Data'))
    p.add_argument('--families', type=str, nargs='+', default=None,
                   help="velocity families (default: all; reference used "
                        "the 'b' families CurveVel_b FlatVel_b CurveFault_b "
                        "FlatFault_b)")
    p.add_argument('--results_folder', type=str, default='./results')
    p.add_argument('--batch_size', type=int, default=32)
    p.add_argument('--lr', type=float, default=2e-4)
    p.add_argument('--train_num_steps', type=int, default=400000)
    p.add_argument('--ema_decay', type=float, default=0.995)
    p.add_argument('--save_every', type=int, default=10000)
    p.add_argument('--image_size', type=int, default=72)
    p.add_argument('--timesteps', type=int, default=1000)
    p.add_argument('--dim', type=int, default=64)
    p.add_argument('--amp', action='store_true',
                   help='bf16 model forward')
    p.add_argument('--resume_milestone', type=int, default=None)
    p.add_argument('--keep_last', type=int, default=0,
                   help='if >0, keep only the newest K milestone ckpts')
    p.add_argument('--image_folder', type=Path, default=None,
                   help='train on an image folder (jpg/png/tiff) instead '
                        'of velocity .npy families (reference '
                        'models/diffusion.py:556-573)')
    p.add_argument('--augment_horizontal_flip', action='store_true')
    p.add_argument('--calculate_fid', action='store_true',
                   help='Frechet distance of EMA samples against training '
                        'images in a frozen random-conv feature space at '
                        'each milestone (inception-free FID proxy; '
                        'reference models/diffusion.py:603-607)')
    p.add_argument('--num_fid_samples', type=int, default=64)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def build_diffusion(args, device) -> GaussianDiffusion:
    """The denoiser the CLI trains, its weights from torch's generator
    seeded with 0."""
    torch.manual_seed(0)
    model = Unet(dim=args.dim, dim_mults=(1, 2, 4, 8), channels=1)
    return GaussianDiffusion(
        model, image_size=args.image_size, timesteps=args.timesteps,
        sampling_timesteps=250, objective='pred_noise', device=device)


def main(argv=None) -> Trainer:
    """Parse ``argv``, train, and return the trainer."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    diffusion = build_diffusion(args, device)

    if args.image_folder is not None:
        dataset = ImageFolderDataset(
            args.image_folder, args.image_size,
            augment_horizontal_flip=args.augment_horizontal_flip,
            convert_image_to='L')  # the CLI denoiser is single-channel
        print(f'image folder: {len(dataset)} files')
    else:
        train_vel, val_vel = load_velocity_datasets(args.data_dir,
                                                    args.families)
        print(f'train samples: {len(train_vel)}, val: {len(val_vel)}')
        dataset = TensorDataset(prepare_images(train_vel))

    trainer = Trainer(
        diffusion, dataset,
        train_batch_size=args.batch_size,
        train_lr=args.lr,
        train_num_steps=args.train_num_steps,
        ema_decay=args.ema_decay,
        save_and_sample_every=args.save_every,
        results_folder=args.results_folder,
        amp=args.amp,
        keep_last_checkpoints=args.keep_last,
        calculate_fid=args.calculate_fid,
        num_fid_samples=args.num_fid_samples,
    )
    if args.resume_milestone is not None:
        trainer.load(args.resume_milestone)
    trainer.train()
    return trainer


if __name__ == '__main__':
    main()
