"""Regularization-strength sweep of the port for a given prior checkpoint.

Counterpart of ``tools/lambda_sweep.py`` for ``red_diffeq_tpu_torch``:
refined (honest) observations, n=4 held-out samples
(``tools/torch_quality.py:held_out_problem``), ts=300; sweeps reg_lambda
for the diffusion (RED) regularizer and prints one JSON line per lambda,
with the JAX tool's keys. The JAX tool's positional arguments, plus
``--device`` (default ``cuda``; without a card it raises unless ``--device
cpu``).

Usage: python tools/torch_lambda_sweep.py [ckpt] [l1,l2,...] [--device cuda]
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_quality as Q  # noqa: E402
from red_diffeq_tpu_torch.core.inversion import (  # noqa: E402
    InversionEngine,
)

N, TS = 4, 300


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('ckpt', nargs='?', default=str(Q.CKPT))
    p.add_argument('lambdas', nargs='?', default='0.4,0.2,0.1',
                   help='comma-separated reg_lambda values')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    lambdas = [float(x) for x in args.lambdas.split(',')]

    prob = Q.held_out_problem(args.device, n=N, obs=('refined',),
                              ckpt=args.ckpt)
    dev, y = prob.op.device, prob.observations['refined']
    engine = InversionEngine(prob.diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)
    rows = []
    for lam in lambdas:
        Q.sync(dev)
        t0 = time.time()
        _, pm = engine.optimize(prob.mu0, prob.v_true_t, y, prob.op, ts=TS,
                                lr=0.03, reg_lambda=lam,
                                generator=Q.draws(dev), use_scan=True,
                                progress=False)
        final = Q.final_metrics(pm, keys=('MAE', 'SSIM'))
        rows.append({'ckpt': args.ckpt, 'lambda': lam,
                     'MAE': round(final['MAE'], 4),
                     'SSIM': round(final['SSIM'], 4),
                     'secs': round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == '__main__':
    main()
