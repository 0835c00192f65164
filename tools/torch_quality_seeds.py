"""How far the port's refined RED-DiffEq row moves with its draws.

``QUALITY.md``'s refined RED-DiffEq row comes from JAX's keys and the
port's (``tools/torch_eval_quality.py``) from a ``torch.Generator`` seeded
8888, so the two can agree only within the spread of the draws. This runs
that row of the eval tool's protocol (the held-out problem of
``tools/torch_quality.py``, n=4 samples, 300 steps, lambda 0.75) once per
draw seed and prints each run's final MAE, RMSE and SSIM, then one JSON
line with their mean, min and max. ``--no_tf32`` runs the U-Net's
convolutions and the products in full fp32 (PyTorch lets cuDNN take TF32
on the card by default); ``--bf16_unet`` runs the U-Net in bf16
(``GaussianDiffusion.half_precision``), nearer the TPU's default
one-pass bf16 convolutions, under which the JAX row was made.

Usage:
    python tools/torch_quality_seeds.py [--seeds 8888 1 2 3 4] [--no_tf32]
        [--bf16_unet] [--device cuda]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_quality as Q  # noqa: E402
from red_diffeq_tpu_torch.core.inversion import (  # noqa: E402
    InversionEngine,
)
from torch_eval_quality import LAMBDAS  # noqa: E402

N, TS = 4, 300


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--ckpt', type=Path, default=Q.CKPT)
    p.add_argument('--seeds', type=int, nargs='+',
                   default=[Q.DRAW_SEED, 1, 2, 3, 4])
    p.add_argument('--no_tf32', action='store_true',
                   help='full fp32 convolutions and products')
    p.add_argument('--bf16_unet', action='store_true',
                   help='the U-Net in bf16')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    prob = Q.held_out_problem(args.device, n=N, obs=('refined',),
                              ckpt=args.ckpt)
    prob.diffusion.half_precision = args.bf16_unet
    dev, y = prob.op.device, prob.observations['refined']
    lam = LAMBDAS['diffusion']
    engine = InversionEngine(prob.diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)
    engine.warm_compile(prob.mu0.shape, y.shape, prob.op, ts=TS,
                        reg_lambda=lam)
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        _, pm = engine.optimize(prob.mu0, prob.v_true_t, y, prob.op, ts=TS,
                                lr=0.03, reg_lambda=lam,
                                generator=Q.draws(dev, seed), progress=False)
        rows.append(Q.final_metrics(pm))
        print(f'refined diffusion seed {seed}: MAE {rows[-1]["MAE"]:.4f}'
              f'  RMSE {rows[-1]["RMSE"]:.4f}  SSIM {rows[-1]["SSIM"]:.4f}'
              f'  ({time.time() - t0:.1f} s)', flush=True)
    summary = {k: {'mean': float(np.mean([r[k] for r in rows])),
                   'min': min(r[k] for r in rows),
                   'max': max(r[k] for r in rows)} for k in rows[0]}
    print(json.dumps({'row': 'refined/diffusion', 'n': N, 'ts': TS,
                      'seeds': args.seeds,
                      'tf32': torch.backends.cudnn.allow_tf32,
                      'bf16_unet': args.bf16_unet, **summary}))
    return rows, summary


if __name__ == '__main__':
    main()
