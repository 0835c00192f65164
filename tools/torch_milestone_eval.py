"""Eval-vs-milestone for the port: inversion quality as a function of the
prior's training progress.

Counterpart of ``tools/milestone_eval.py`` for ``red_diffeq_tpu_torch``,
with its flags, printed lines, JSON sidecar and markdown layout, plus
``--device`` (default ``cuda``; without a card it raises unless ``--device
cpu``); the table goes to ``docs/milestone_eval_torch.md`` by default,
beside the JAX tool's. For each milestone of the port's trainer
(``model-<k>.ckpt``, a flax-msgpack training state) its EMA weights are
assigned to one ``GaussianDiffusion`` (``diffusion.params``, which also
renews the bf16 copy) and the reference inversion workload (70x70,
nt=1000, ns=5, ts=300, diffusion regularization) runs on the held-out
samples (``tools/torch_quality.py:held_out_problem``) under both
observation protocols. A bare parameter tree (the shipped prior) is taken
as it is, with train step '?'.

Also summarizes the training-loss curve from ``training_losses-<k>.json``
so prior quality and optimization progress can be read side by side.

Usage:
    python tools/torch_milestone_eval.py \
        [--ckpts pretrained_models/milestones_archive/model-*.ckpt ...] \
        [--n 4] [--ts 300] [--out docs/milestone_eval_torch.md] [--device cuda]
"""
import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_quality as Q  # noqa: E402
from red_diffeq_tpu_torch.core.inversion import (  # noqa: E402
    InversionEngine,
)
from red_diffeq_tpu_torch.io.checkpoints import load_params  # noqa: E402

ARCHIVE = Path('pretrained_models/milestones_archive')


def loss_curve_summary(run_dir: Path):
    """(step, mean-loss-of-trailing-1k-steps) from the newest losses JSON."""
    files = {int(m.group(1)): f
             for f in run_dir.glob('training_losses-*.json')
             if (m := re.match(r'training_losses-(\d+)\.json$', f.name))}
    if not files:
        return []
    data = json.loads(files[max(files)].read_text())
    losses = data.get('losses', [])
    # Trainer entries are {'step': int, 'loss': float} dicts
    vals = np.asarray([x['loss'] if isinstance(x, dict) else float(x)
                       for x in losses], np.float64)
    if not len(vals):
        return []
    window = min(1000, len(vals))
    stride = max(window, len(vals) // 20)
    points = list(range(window, len(vals) + 1, stride))
    # Always include the curve's end: the final training loss is the number
    # the saturation table exists to show.
    if points[-1] != len(vals):
        points.append(len(vals))
    return [(k, float(np.mean(vals[max(0, k - window):k])))
            for k in points]


def milestones(run: Path):
    """``model-<k>.ckpt`` under the archive and ``run``, by k (the
    archive's first)."""
    cands = {}
    for d in (ARCHIVE, run):
        for f in d.glob('model-*.ckpt'):
            m = re.match(r'model-(\d+)\.ckpt$', f.name)
            if m:
                cands.setdefault(int(m.group(1)), f)
    return [cands[k] for k in sorted(cands)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--ckpts', type=Path, nargs='+', default=None,
                   help='Trainer milestone checkpoints (default: all under '
                        'pretrained_models/milestones_archive + train_run)')
    p.add_argument('--run', type=Path,
                   default=Path('pretrained_models/train_run'))
    p.add_argument('--n', type=int, default=4)
    p.add_argument('--ts', type=int, default=300)
    p.add_argument('--out', type=Path,
                   default=Path('docs/milestone_eval_torch.md'))
    p.add_argument('--note', default=None,
                   help='extra provenance paragraph written under the '
                        'table (e.g. which checkpoints come from which '
                        'training run)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    if args.ckpts is None:
        args.ckpts = milestones(args.run)
    if not args.ckpts:
        raise SystemExit('no milestone checkpoints found')

    prob = Q.held_out_problem(args.device, n=args.n, ckpt=None)
    dev, op, diffusion = prob.op.device, prob.op, prob.diffusion

    rows = []
    # One engine over one bundle: each milestone's weights are copied into
    # the same U-Net.
    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)
    for ck in args.ckpts:
        state = load_params(ck)
        step = state.get('step', '?')
        diffusion.params = (state['ema_params'] if 'ema_params' in state
                            else state)
        row = {'ckpt': str(ck), 'step': step}
        for obs_name, y in prob.observations.items():
            Q.sync(dev)
            t0 = time.time()
            _, pm = engine.optimize(
                prob.mu0, prob.v_true_t, y, op, ts=args.ts, lr=0.03,
                reg_lambda=0.75, generator=Q.draws(dev), use_scan=True,
                progress=False)
            row[obs_name] = {
                **Q.final_metrics(pm, keys=('MAE', 'SSIM')),
                'secs': round(time.time() - t0, 1),
            }
        rows.append(row)
        print(f"{ck} step={step} "
              f"clean MAE {row['clean']['MAE']:.4f} SSIM "
              f"{row['clean']['SSIM']:.4f} | refined MAE "
              f"{row['refined']['MAE']:.4f} SSIM "
              f"{row['refined']['SSIM']:.4f}", flush=True)

    # Order the table by training step (explicit --ckpts globs arrive
    # lexically: model-10 before model-2).
    rows.sort(key=lambda r: (not isinstance(r['step'], int), r['step']))

    try:
        curve = loss_curve_summary(args.run)
    except Exception as e:  # never lose the eval table to a summary bug
        print(f'loss-curve summary failed ({e!r}); table written without it')
        curve = []
    lines = [
        '# Prior quality vs training progress',
        '',
        f'Inversion: n={args.n} held-out samples, ts={args.ts}, nt=1000, '
        f'ns=5, diffusion reg lambda=0.75, seed 8888, '
        f'backend={prob.backend}. Card: {Q.card_line(dev)}. Every '
        'milestone is copied into one U-Net. Produced by `python '
        'tools/torch_milestone_eval.py` (PyTorch port).',
        '',
        '| milestone ckpt | train step | clean MAE | clean SSIM | '
        'refined MAE | refined SSIM |',
        '|---|---|---|---|---|---|',
    ]
    for r in rows:
        ckpt_path = Path(r['ckpt'])
        lines.append(
            f"| {ckpt_path.parent.name}/{ckpt_path.name} | {r['step']} | "
            f"{r['clean']['MAE']:.4f} | {r['clean']['SSIM']:.4f} | "
            f"{r['refined']['MAE']:.4f} | {r['refined']['SSIM']:.4f} |")
    if args.note:
        lines += ['', args.note]
    if curve:
        lines += ['', '## Training loss (trailing-1k mean)', '',
                  '| step | loss |', '|---|---|']
        lines += [f'| {s} | {l:.5f} |' for s, l in curve]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text('\n'.join(lines) + '\n')
    # Machine-readable sidecar so downstream tools
    # (torch_pick_best_milestone) select on the measured numbers instead of
    # re-parsing the table.
    args.out.with_suffix('.json').write_text(json.dumps(rows, indent=1))
    print(f'wrote {args.out} (+ .json sidecar)')
    return rows


if __name__ == '__main__':
    main()
