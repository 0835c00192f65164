#!/usr/bin/env python3
"""Does the sponge pad decide whether the velocity gradient repeats?

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_pad_determinism.py

At the two shapes of ``chip_smoke.py``'s ``determinism`` phase (the
headline, nbc=120, tape-free adjoint; nbc=40, taped adjoint) it computes
the velocity gradient of a masked-L1 observation loss through the kernel
backend twice with the port's own pad (``solvers/acoustic.py:edge_pad``,
a fixed-order backward) and twice with PyTorch's replicate pad in its
place (whose CUDA backward sums with atomics), and prints the largest
difference between the two runs of each. Prints the card's name and
power limit last.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import torch
    import torch.nn.functional as F
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    edge_pad = acoustic.edge_pad

    def replicate(v, n):
        return F.pad(v, (n,) * 4, mode='replicate')

    for ctx in (C.HEADLINE, C.NARROW):
        p = C.headline_problem(dev, ctx)
        seis, _ = C.forward_pass(stencil.fwd_chunk, p)
        problem = C.gradient_problem(p['v_true'], seis[:, :, :ctx['nt']])
        del p, seis
        diffs = {}
        for name, pad in (('edge_pad', edge_pad), ('replicate', replicate)):
            acoustic.edge_pad = pad
            try:
                g1 = C.velocity_grad(ctx, 'kernel', *problem)
                g2 = C.velocity_grad(ctx, 'kernel', *problem)
            finally:
                acoustic.edge_pad = edge_pad
            diffs[name] = float((g1 - g2).abs().max())
        print(f"nbc={ctx['nbc']}: two identical gradient runs differ by "
              + ', '.join(f'{d:.3e} with {k}' for k, d in diffs.items()),
              flush=True)
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
