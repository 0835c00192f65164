"""Quality evaluation of the port: RED-DiffEq vs TV vs L2 vs unregularized
on held-out synthetic samples.

Counterpart of ``tools/eval_quality.py`` for ``red_diffeq_tpu_torch``, with
its flags, defaults, printed lines, JSON keys and markdown layout, plus
``--device`` (default ``cuda``; without a card it raises unless ``--device
cpu``). Runs the full reference workload (70x70, nt=1000, ns=5, ts=300
steps, draws seeded 8888) for each regularization and reports final
MAE/RMSE/SSIM. The problem is ``tools/torch_quality.py:held_out_problem``.

Timing protocol: each regularization's configuration is warmed by
``InversionEngine.warm_compile`` (the kernel library's build and load,
the route's first launches, the U-Net's first call) and one ``optimize``
of the first row runs untimed, so s/sample measures execution only.

Usage:
    python tools/torch_eval_quality.py [--ckpt pretrained_models/model-synthetic-ema.ckpt]
        [--n 4] [--ts 300] [--out QUALITY_torch.md] [--device cuda]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_quality as Q  # noqa: E402
from red_diffeq_tpu_torch.core.inversion import (  # noqa: E402
    InversionEngine,
)

LAMBDAS = {'none': 0.0, 'tv': 0.01, 'l2': 0.01, 'diffusion': 0.75}
CURVE_KEYS = ('mae', 'rmse', 'ssim', 'total_losses', 'obs_losses',
              'reg_losses')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ckpt', type=Path, default=Q.CKPT)
    p.add_argument('--n', type=int, default=4)
    p.add_argument('--ts', type=int, default=300)
    p.add_argument('--width', type=int, default=70,
                   help='model width; >72 exercises the patched RED path '
                        '(Marmousi-style, reference configs use 190)')
    p.add_argument('--sigma', type=float, default=10.0,
                   help='initial-model smoothing (reference: 10 OpenFWI, '
                        '20 Marmousi)')
    p.add_argument('--noise_std', type=float, default=0.0)
    p.add_argument('--missing_number', type=int, default=0)
    p.add_argument('--obs', choices=['both', 'clean', 'refined'],
                   default='both',
                   help="observation discretization: 'clean' = same "
                        "solver as the inversion (inverse crime, upper "
                        "bound); 'refined' = dt/2 + dx/2 grid (honest "
                        "forward-model mismatch)")
    p.add_argument('--regs', type=str, nargs='+',
                   choices=['none', 'tv', 'l2', 'diffusion'],
                   default=['none', 'tv', 'l2', 'diffusion'],
                   help='regularizations to evaluate')
    p.add_argument('--out', type=Path, default=None)
    p.add_argument('--save_curves', type=Path, default=None,
                   help='directory for per-step metric curves '
                        '(<obs>_<reg>.npz), e.g. for golden-run pinning')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    prob = Q.held_out_problem(args.device, n=args.n, width=args.width,
                              sigma=args.sigma,
                              obs=Q.OBS_CHOICES[args.obs], ckpt=args.ckpt)
    dev, op, mu0 = prob.op.device, prob.op, prob.mu0

    results = {}
    process_warm = False
    # One engine per regularizer, shared across observation protocols
    # (clean and refined observations have the same shape).
    engines = {reg: InversionEngine(prob.diffusion, regularization=reg,
                                    sigma_x0=1e-4, device=dev)
               for reg in args.regs}
    warmed = set()
    init_ssim_true = Q.initial_ssim(prob)
    for obs_name, y in prob.observations.items():
        for reg in args.regs:
            lam = LAMBDAS[reg]
            engine = engines[reg]
            run = dict(ts=args.ts, lr=0.03, reg_lambda=lam,
                       noise_std=args.noise_std,
                       missing_number=args.missing_number,
                       regularization=None if reg == 'none' else reg,
                       use_scan=True, progress=False)
            # Warm each configuration so the timed run measures execution
            # only: the kernel library's build, the route's first launches
            # and the U-Net's first call would otherwise land in whichever
            # row runs first.
            if (reg, tuple(y.shape)) not in warmed:
                engine.warm_compile(
                    mu0.shape, y.shape, op, ts=args.ts, lr=0.03,
                    reg_lambda=lam,
                    regularization=None if reg == 'none' else reg)
                warmed.add((reg, tuple(y.shape)))
            if not process_warm:
                # The process's first run absorbs one-time costs that the
                # warm-up does not cover (allocator growth, the other
                # operations' first calls); run it once untimed so no
                # table row inherits them.
                engine.optimize(mu0, prob.v_true_t, y, op,
                                generator=Q.draws(dev), **run)
                process_warm = True
            Q.sync(dev)
            t0 = time.time()
            _, per_model = engine.optimize(mu0, prob.v_true_t, y, op,
                                           generator=Q.draws(dev), **run)
            dt = time.time() - t0
            final = {
                **Q.final_metrics(per_model),
                'initial_SSIM': init_ssim_true,
                'first_step_SSIM': float(np.mean([pm['ssim'][0]
                                                  for pm in per_model])),
                'seconds_per_sample': round(dt / args.n, 2),
            }
            results[f'{obs_name}/{reg}'] = final
            if args.save_curves is not None:
                args.save_curves.mkdir(parents=True, exist_ok=True)
                np.savez(args.save_curves / f'{obs_name}_{reg}.npz',
                         **{k: np.asarray([pm[k] for pm in per_model])
                            for k in CURVE_KEYS})
            print(f'{obs_name:8s} {reg:10s} MAE {final["MAE"]:.4f}  '
                  f'RMSE {final["RMSE"]:.4f}  SSIM {final["SSIM"]:.4f}  '
                  f'({final["seconds_per_sample"]} s/sample)', flush=True)

    print(json.dumps(results))
    if args.out:
        lines = ['# Quality evaluation (synthetic held-out OpenFWI-style)',
                 '',
                 f'n={args.n} samples (70x{args.width}), ts={args.ts}, '
                 f'nt=1000, ns=5, sigma_init={args.sigma}, '
                 f'seed 8888, backend={prob.backend}, '
                 f'noise_std={args.noise_std}, '
                 f'missing={args.missing_number}', '',
                 f'Card: {Q.card_line(dev)}. Produced by `python '
                 'tools/torch_eval_quality.py` (PyTorch port).', '',
                 'Observations: `clean` = generated by the inversion '
                 'solver itself (inverse crime — an upper bound); '
                 '`refined` = generated on a dt/2 + dx/2 grid at the same '
                 'physical acquisition (honest forward-model mismatch).',
                 '',
                 '| observations | regularization | MAE | RMSE | SSIM | '
                 's/sample |',
                 '|---|---|---|---|---|---|']
        for key_name, r in results.items():
            obs_name, reg = key_name.split('/')
            lines.append(f'| {obs_name} | {reg} | {r["MAE"]:.4f} | '
                         f'{r["RMSE"]:.4f} | {r["SSIM"]:.4f} | '
                         f'{r["seconds_per_sample"]} |')
        lines += [
            '',
            'Timing note: each configuration is warmed '
            '(`InversionEngine.warm_compile`: the kernel library\'s build '
            'and load, the route\'s first kernel launches and the U-Net\'s '
            'first call) before its timed run, and a separate untimed '
            'run of the first row absorbs the process\'s other first-call '
            'costs, so s/sample measures execution only.',
            f'Prior checkpoint: `{args.ckpt}`.',
        ]
        args.out.write_text('\n'.join(lines) + '\n')
        print(f'wrote {args.out}')
    return results


if __name__ == '__main__':
    main()
