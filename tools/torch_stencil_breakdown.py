#!/usr/bin/env python3
"""Where a launch of the port's blocked stencil kernels spends its time.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_stencil_breakdown.py

At the headline shape of ``chip_smoke.py`` (B=4, ns=5, 310x310) it times
the launchers of the three blocked kernels, ``fwd_step``,
``bwd_reverse_step`` and ``bwd_tape_step`` (each adjoint without its
``sum_shots`` launch), straight through the library (no wrapper), one
launch of n = 1 .. U steps at a time and a whole 20-step chunk, all
device time between CUDA events over 20 calls. Then it times the same
launches of three variants of ``red_diffeq_tpu_torch/ops/csrc/stencil.cu``,
each with one phase cut out: the zeroing of the windows' pads, the window
load (the tape's slots included), the tile's copy-out through shared
memory. ``bwd_tape_step`` writes its running sums straight from registers,
and those stores stay in every variant: without them the compiler would
drop the sums themselves. The variants compute wrong values and exist
only to be timed; they are built next to the real library in the
git-ignored build directory. Prints one line per variant. Then, as built,
a 20-step chunk of ``bwd_tape_step`` at each U = 1..4 that fits, at the
headline shape and at the nbc=40 shape (150x150), in ms per 1000-step
pass. Last the card's name and power limit.

    python3 tools/torch_stencil_breakdown.py --sum-shots ROOT

instead times the ``sum_shots`` wrapper of the checkout at ROOT (any with
``stencil.sum_shots(pa, p1, p2)``, so also an earlier one) and PyTorch's
``torch.sum`` over the shot axis on the 50 per-shot partials of a headline
pass, as device time: the pass captured once in a CUDA graph and replayed.
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
    'load': [r'copy_async\(&(?:smem|sums|buf)\[[^;]*?\], [^;]*\);'],
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


def card_line():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def sum_shots_device_time(root):
    """Device ms per headline pass of ``sum_shots`` from the checkout at
    ``root`` and of ``torch.sum`` over the shot axis."""
    import torch
    import chip_smoke as C           # this checkout's: shapes, graph_ms
    sys.path.insert(0, str(Path(root).resolve()))
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    n = C.HEADLINE['n_grid'] + 2 * C.HEADLINE['nbc']
    shape = (C.BATCH, C.HEADLINE['ns'], n, n)
    gen = torch.Generator(device=dev).manual_seed(5)
    parts = [[torch.randn(shape, generator=gen, device=dev)
              for _ in range(3)] for _ in range(C.HEADLINE['nt'] // C.CHUNK)]
    ms = C.graph_ms(lambda: [S.sum_shots(*q) for q in parts], 20)
    lib_ms = C.graph_ms(lambda: [[t.sum(dim=1, keepdim=True) for t in q]
                                 for q in parts], 20)
    print(f'sum_shots of {S.__file__}: device time {ms:.3f} ms per pass '
          f'({len(parts)} calls), torch.sum {lib_ms:.3f} ms', flush=True)
    print(card_line())
    return 0


def tape_unroll_sweep(C, S, dev):
    """ms per 1000-step pass of bwd_tape_step (20-step chunks, no shot
    sums) at each U that fits, at the headline and nbc=40 shapes."""
    import torch
    for ctx in (C.HEADLINE, C.NARROW):
        p = C.headline_problem(dev, ctx)
        b, ns, hp, wp = p['shape']
        g = p['geo']
        # u, v, the two ping-pong pairs, the per-shot sums, ginj.
        x = [torch.randn(p['shape'], device=dev) for _ in range(10)]
        tape = torch.randn((C.CHUNK + 2, *p['shape']), device=dev)
        grecs = C.random_grecs(p)
        lib, st = S._load(), S._stream(dev)
        cells = []
        for u in range(1, 5):
            if 4 * u > min(hp, wp):
                continue

            def taped():
                for i in range(len(p['src'])):
                    lib.rdt_bwd_tape_chunk(
                        *map(S._ptr, (x[0], x[1], tape, *x[2:10])), None,
                        None, None,
                        *map(S._ptr, (grecs[i], p['alpha'], p['t1'],
                                      p['t2'], p['src'][i])),
                        b, ns, hp, wp, g['isz'], g['igz'], g['g0'], g['ng'],
                        C.CHUNK, u, st)

            cells.append(f'U={u} {C.cuda_ms(taped, 5):.3f}')
        print(f"bwd_tape_step at {hp}x{wp} (nbc={ctx['nbc']}), ms per pass: "
              + ', '.join(cells), flush=True)


def main():
    if sys.argv[1:2] == ['--sum-shots']:
        return sum_shots_device_time(sys.argv[2])
    import torch
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    smi = card_line()
    p = C.headline_problem(dev)
    b, ns, hp, wp = p['shape']
    g = p['geo']
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    grecs = C.random_grecs(p)
    x = [torch.randn(p['shape'], device=dev) for _ in range(12)]
    recs = torch.empty((b, ns, C.CHUNK, g['ng']), device=dev)
    u = S.pick_blocking('fwd_step', hp, wp)[0]
    assert u == S.pick_blocking('bwd_reverse_step', hp, wp)[0]
    assert u == S.pick_blocking('bwd_tape_step', hp, wp)[0]
    # A tape of one chunk (slot i = s_{i-1}); its values do not matter here.
    tape = torch.randn((C.CHUNK + 2, *p['shape']), device=dev)
    null = [None] * 3           # no sum_shots launch
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
                        *map(S._ptr, x[8:12]), *null,
                        *map(S._ptr, (grecs[i], *coef, p['src'][i])),
                        b, ns, hp, wp, g['isz'], g['igz'], g['g0'], g['ng'],
                        steps, u, st)

            def taped():
                for i in range(20):
                    lib.rdt_bwd_tape_chunk(
                        *map(S._ptr, (x[0], x[1], tape, *x[4:8], *x[8:12])),
                        *null,
                        *map(S._ptr, (grecs[i], *coef[:3], p['src'][i])),
                        b, ns, hp, wp, g['isz'], g['igz'], g['g0'], g['ng'],
                        steps, u, st)

            launches = 20 * -(-steps // u)
            cells.append(f'{steps} steps: fwd '
                         f'{C.cuda_ms(fwd, 10) * 1e3 / launches:.2f}, bwd '
                         f'{C.cuda_ms(bwd, 10) * 1e3 / launches:.2f}, taped '
                         f'{C.cuda_ms(taped, 10) * 1e3 / launches:.2f}')
        print(f'{name:9s} us per launch (U={u}): ' + '; '.join(cells),
              flush=True)
    S._CSRC, S._lib = real, None
    del x, tape
    tape_unroll_sweep(C, S, dev)
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
