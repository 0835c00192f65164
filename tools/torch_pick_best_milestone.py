"""Select the best-by-held-out-quality milestone of a training run and
export its EMA weights as the shipped prior, with the port.

Counterpart of ``tools/pick_best_milestone.py`` for
``red_diffeq_tpu_torch``: reads the JSON sidecar of a milestone table
(``tools/torch_milestone_eval.py``, or the JAX tool's), picks by
refined-protocol SSIM (the honest, headline protocol), tie-broken by clean
SSIM, among the listed checkpoints that exist, and writes the pick's EMA
parameter tree with the port's ``save_params`` (a bare tree, which
``load_diffusion_params`` of either package loads). Runs on the host only.

Usage:
    python tools/torch_pick_best_milestone.py \
        --eval docs/milestone_eval_torch.md \
        [--out pretrained_models/model-synthetic-ema.ckpt]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from red_diffeq_tpu_torch.io.checkpoints import (  # noqa: E402
    load_params, save_params,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--eval', type=Path, required=True,
                   help='milestone_eval output (.md path; reads the '
                        '.json sidecar)')
    p.add_argument('--out', type=Path,
                   default=Path('pretrained_models/model-synthetic-ema.ckpt'))
    args = p.parse_args(argv)

    sidecar = args.eval.with_suffix('.json')
    rows = json.loads(sidecar.read_text())
    rows = [r for r in rows if Path(r['ckpt']).exists()]
    if not rows:
        raise SystemExit(f'no existing checkpoints listed in {sidecar}')
    best = max(rows, key=lambda r: (r['refined']['SSIM'],
                                    r['clean']['SSIM']))
    print(f"best milestone: {best['ckpt']} (step {best['step']}) "
          f"refined SSIM {best['refined']['SSIM']:.4f} / "
          f"clean SSIM {best['clean']['SSIM']:.4f}")

    state = load_params(Path(best['ckpt']))
    params = state['ema_params'] if 'ema_params' in state else state
    save_params(params, args.out)
    print(f"exported EMA -> {args.out}")
    return best


if __name__ == '__main__':
    main()
