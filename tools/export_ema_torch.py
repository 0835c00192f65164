"""Export the EMA denoiser weights of a milestone of the port's trainer.

Counterpart of ``tools/export_ema.py`` for ``red_diffeq_tpu_torch``: reads
``<run>/model-<k>.ckpt`` (the full training state that
``red-diffeq-torch-train`` writes) and writes its bare EMA parameter tree
in the shipped prior's format (``pretrained_models/model-synthetic-ema.ckpt``),
which the inversion and bench CLIs of either package load. Imports only the
port.

Usage:
    python tools/export_ema_torch.py [--run pretrained_models/train_run]
        [--milestone latest] [--out pretrained_models/model-synthetic-ema.ckpt]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from red_diffeq_tpu_torch.io.checkpoints import export_ema  # noqa: E402


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--run', type=Path,
                   default=Path('pretrained_models/train_run'))
    p.add_argument('--milestone', default='latest',
                   help="milestone number, or 'latest'")
    p.add_argument('--out', type=Path,
                   default=Path('pretrained_models/model-synthetic-ema.ckpt'))
    args = p.parse_args(argv)
    src = export_ema(args.run, args.milestone, args.out)
    print(f'exported the EMA params of {src} -> {args.out}')
    return args.out


if __name__ == '__main__':
    main()
