#!/usr/bin/env python3
"""Where a launch of the port's blocked stencil kernels spends its time.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_stencil_breakdown.py

At the headline shape of ``chip_smoke.py`` (B=4, ns=5, 310x310) it times
the launchers of the two blocked kernels, ``fwd_step`` and
``bwd_reverse_step``, straight through the library (no wrapper), one
launch of n = 1 .. U steps at a time and a whole 20-step chunk, all
device time between CUDA events over 20 calls. Then it times the same
launches of three variants of ``red_diffeq_tpu_torch/ops/csrc/stencil.cu``,
each with one phase cut out: the zeroing of the windows' pads, the window
load, the tile's copy-out. The variants compute wrong values and exist
only to be timed; they are built next to the real library in the
git-ignored build directory. Prints one line per variant and the card's
name and power limit.
"""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# Statements each variant removes from the source.
CUTS = {
    'pads': ['zero_pads<L>(smem, 2);', 'zero_pads<L>(smem, 4);'],
    'load': [r'copy_async\(&(?:smem|sums)\[[^\]]*\], [^;]*\);'],
    'copy-out': [r'(?:out0|out1|s1_out|s_out|u_out|v_out|pa|p1|p2)\[g\] = '
                 r'(?:smem|sums)\[[^\]]*\];'],
}


def variant_source(src: str, cut: str) -> str:
    for pattern in CUTS[cut]:
        src, n = re.subn(pattern if '\\' in pattern else re.escape(pattern),
                         '', src)
        if n == 0:
            raise RuntimeError(f'variant {cut!r}: {pattern!r} not in source')
    return src


def main():
    import torch
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    p = C.headline_problem(dev)
    b, ns, hp, wp = p['shape']
    g = p['geo']
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    grecs = C.random_grecs(p)
    x = [torch.randn(p['shape'], device=dev) for _ in range(12)]
    recs = torch.empty((b, ns, C.CHUNK, g['ng']), device=dev)
    u = S.pick_blocking('fwd_step', hp, wp)[0]
    assert u == S.pick_blocking('bwd_reverse_step', hp, wp)[0]
    real = S._CSRC
    S.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ('as built', *CUTS):
        if name == 'as built':
            S._CSRC = real
        else:
            path = S.BUILD_DIR / f'breakdown-{name}.cu'
            path.write_text(variant_source(real.read_text(), name))
            S._CSRC = path
        S._lib = None
        lib, st = S._load(), S._stream(dev)
        xp, yp = S._ptrs(x[4:8]), S._ptrs(x[8:12])
        cells = []
        for steps in (*range(1, u + 1), C.CHUNK):
            def fwd():
                for i in range(20):
                    lib.rdt_fwd_chunk(
                        *map(S._ptr, (x[0], x[1], x[2], x[3], x[0], x[1],
                                      *coef, p['src'][i], recs)),
                        b, ns, hp, wp, g['isz'], g['igz'], g['g0'], g['ng'],
                        steps, u, st)

            def bwd():
                for i in range(20):
                    lib.rdt_bwd_reverse_chunk(
                        *map(S._ptr, x[:4]), xp, yp,
                        *map(S._ptr, (x[8], x[9], x[10], x[11], grecs[i],
                                      *coef, p['src'][i])),
                        b, ns, hp, wp, g['isz'], g['igz'], g['g0'], g['ng'],
                        steps, u, st)

            launches = 20 * -(-steps // u)
            cells.append(f'{steps} steps: fwd '
                         f'{C.cuda_ms(fwd, 10) * 1e3 / launches:.2f}, bwd '
                         f'{C.cuda_ms(bwd, 10) * 1e3 / launches:.2f}')
        print(f'{name:9s} us per launch (U={u}): ' + '; '.join(cells),
              flush=True)
    S._CSRC, S._lib = real, None
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
