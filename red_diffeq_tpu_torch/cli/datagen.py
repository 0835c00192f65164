"""Synthetic dataset generation CLI (``red-diffeq-torch-datagen``).

Counterpart of ``red_diffeq_tpu/cli/datagen.py:22-77``, with the same flags
and defaults and one more, ``--device``. It writes the reference layout,
``<out>/Velocity_Data/<family>.npy`` (N, 1, H, W) in m/s from
``io/synthetic.py:generate_velocity_models`` (seed + i for the i-th
family, as the JAX tool), and unless ``--velocity_only``
``<out>/Seismic_Data/<family>.npy`` (N, ns, nt, W): seismograms of the
forward operator (normalised velocities in, no seismogram normalisation),
simulated under ``torch.no_grad()`` in ``--sim_batch`` pieces. On the card
(the default) the solver runs on the forward kernel ``fwd_step``.

    python -m red_diffeq_tpu_torch.cli.datagen --out dataset/OpenFWI --n 500
    python -m red_diffeq_tpu_torch.cli.datagen --out dataset/Marmousi --n 8 \\
        --width 190 --families CurveFault
    python -m red_diffeq_tpu_torch.cli.datagen --out /tmp/Synth --n 2 \\
        --height 16 --width 16 --nt 100 --ns 2 --device cpu

Like every entry point of the port it raises without a card unless given
``--device cpu``, ``--velocity_only`` included.
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from red_diffeq_tpu_torch.io.synthetic import generate_velocity_models
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
from red_diffeq_tpu_torch.utils.data_trans import (
    s_normalize_none, v_denormalize, v_normalize,
)
from red_diffeq_tpu_torch.utils.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description='Generate synthetic datasets')
    p.add_argument('--out', type=Path, required=True,
                   help='dataset root (creates Velocity_Data/ and '
                        'Seismic_Data/)')
    p.add_argument('--n', type=int, default=100, help='samples per family')
    p.add_argument('--families', type=str, nargs='+',
                   default=['FlatVel', 'CurveVel', 'FlatFault',
                            'CurveFault'])
    p.add_argument('--height', type=int, default=70)
    p.add_argument('--width', type=int, default=70)
    p.add_argument('--nt', type=int, default=1000)
    p.add_argument('--ns', type=int, default=5)
    p.add_argument('--nbc', type=int, default=120)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--velocity_only', action='store_true',
                   help='skip seismogram simulation (pretraining only '
                        'needs velocities)')
    p.add_argument('--sim_batch', type=int, default=8,
                   help='simulation batch size')
    p.add_argument('--device', default='cuda',
                   help="device of the simulation: 'cuda' (default; raises "
                        "without a card) or 'cpu'")
    return p


def simulate(op: FWIForward, vel: np.ndarray, sim_batch: int) -> np.ndarray:
    """Seismograms of the velocities ``vel`` (N, 1, H, W) in m/s, ``sim_batch``
    models at a time."""
    chunks = []
    for s in range(0, len(vel), sim_batch):
        batch = torch.from_numpy(vel[s:s + sim_batch]).to(op.device)
        with torch.no_grad():
            chunks.append(op(v_normalize(batch)).cpu().numpy())
        print(f'  simulated {min(s + sim_batch, len(vel))}/{len(vel)}',
              flush=True)
    return np.concatenate(chunks)


def main(argv=None) -> Path:
    """Write the dataset; returns its root."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    vel_dir = args.out / 'Velocity_Data'
    seis_dir = args.out / 'Seismic_Data'
    op = None
    if not args.velocity_only:
        ctx = dict(n_grid=args.width, nt=args.nt, dx=10.0, dt=0.001,
                   nbc=args.nbc, f=15.0, sz=10, gz=10, ng=args.width,
                   ns=args.ns)
        op = FWIForward(ctx, v_denorm_func=v_denormalize,
                        s_norm_func=s_normalize_none, device=device)
        seis_dir.mkdir(parents=True, exist_ok=True)
    vel_dir.mkdir(parents=True, exist_ok=True)

    for i, fam in enumerate(args.families):
        vel = generate_velocity_models(args.n, args.height, args.width,
                                       family=fam, seed=args.seed + i)
        np.save(vel_dir / f'{fam}.npy', vel)
        print(f'{fam}: velocities {vel.shape} -> {vel_dir}', flush=True)
        if op is not None:
            np.save(seis_dir / f'{fam}.npy',
                    simulate(op, vel, args.sim_batch))
    print(f'dataset written to {args.out}')
    return args.out


if __name__ == '__main__':
    main()
