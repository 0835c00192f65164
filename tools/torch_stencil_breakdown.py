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

    python3 tools/torch_stencil_breakdown.py --tape-pass ROOT

instead times the ``tape_chunk`` wrapper of the checkout at ROOT (any with
``stencil.tape_chunk(p0, p1, alpha, t1, t2, inj, src, isz=)``, so also an
earlier one) over a 1000-step pass at the headline and nbc=40 shapes, in
device time between CUDA events, with its launches per pass.

    python3 tools/torch_stencil_breakdown.py --tape

instead times ``tape_step`` (one launch per 20-step chunk, one field per
cluster of 16 blocks) at the headline and nbc=40 shapes, in ms per
1000-step pass of device time between CUDA events: as built, at chunks of
1, 2, 5, 10 and 20 steps (the launch's fixed part and the per-step slope),
and four variants: without the tape stores; without the halo rows written
into the neighbours' shared memory and with a block barrier in place of the
cluster barrier (each block then steps alone); both cut; and both cut with
each cell's stencil replaced by one add (what the loop, the loads and the
barriers cost alone). The variants compute wrong values and exist only to
be timed. Then one launch's timeline at each shape: every block's start
and end (``%globaltimer``) and SM, so the waves of resident clusters show.

    python3 tools/torch_stencil_breakdown.py --beyond-pass ROOT [global]

instead times the ``tape_chunk`` wrapper of the checkout at ROOT over a
200-step pass at ``chip_smoke.py``'s field past ``tape_step``'s cluster
limit (BEYOND: 420x420, B=1, ns=5), from random carries, with the host's
launches and as a CUDA graph, and prints its launches by kernel; with
``global`` the stream picker is forced to refuse, so the pass takes
``tape_step_global``.

    python3 tools/torch_stencil_breakdown.py --stream

instead times ``tape_step_stream`` (one launch per 20-step chunk) at that
field, in ms per pass as a CUDA graph: as built, at chunks of 1, 2, 5, 10
and 20 steps, and variants (STREAM_CUTS): without the streamed
coefficient loads (the index arithmetic kept), without the tape stores,
with a block barrier in place of each step's cluster barrier (one
cluster barrier before the blocks leave, so that none leaves while a
neighbour writes into it; the halo rows then race), with each cell's
stencil and coefficients replaced by one add (what the walk, the stores,
the pushes and the barriers cost alone), without the halo rows written
into the neighbours, and without the steps' walks (what is left: the
launch, the strip's loads, the carry's slots and the barriers). The
variants compute wrong values and exist only to be timed. Then
``tape_step_global`` forced at
the same pass, and both at 500x500 and 600x600 (B=1, ns=5, nt=200),
where ``tape_step_stream`` keeps one and no coefficient plane in shared
memory.
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


def tape_pass_time(root):
    """ms per 1000-step pass of the ``tape_chunk`` wrapper of the checkout
    at ``root``, at the headline and nbc=40 shapes, from random carries."""
    import torch
    import chip_smoke as C           # this checkout's: shapes, cuda_ms
    sys.path.insert(0, str(Path(root).resolve()))
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    cells = []
    for ctx in (C.HEADLINE, C.NARROW):
        p = C.headline_problem(dev, ctx)
        gen = torch.Generator(device=dev).manual_seed(1)
        carry = [torch.randn(p['shape'], generator=gen, device=dev)
                 for _ in range(2)]
        coef = (p['alpha'], p['t1'], p['t2'], p['inj'])

        def tpass():
            for s_ in p['src']:
                S.tape_chunk(*carry, *coef, s_, isz=p['geo']['isz'])

        tpass()
        S.reset_launches()
        tpass()
        launched = S.launches['tape_step']
        cells.append(f"nbc={ctx['nbc']} {C.cuda_ms(tpass, 5):.3f} ms "
                     f'({launched} launches)')
    print(f'tape_step of {S.__file__}, ms per pass: ' + ', '.join(cells),
          flush=True)
    print(card_line())
    return 0


def beyond_pass_time(root, route=None):
    """ms per pass of the ``tape_chunk`` wrapper of the checkout at
    ``root`` on ``chip_smoke.py``'s field past ``tape_step``'s cluster
    limit (BEYOND: 420x420, B=1, ns=5, nt=200), from random carries, with
    the host's launches and as a CUDA graph, and its launches by kernel.
    With ``route='global'`` the stream picker is forced to refuse, so the
    pass takes ``tape_step_global``."""
    import torch
    import chip_smoke as C           # this checkout's: shapes, timers
    sys.path.insert(0, str(Path(root).resolve()))
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    if route == 'global':
        S.pick_stream = lambda hp, wp: None
    dev = torch.device('cuda')
    p = C.headline_problem(dev, C.BEYOND, batch=1)
    gen = torch.Generator(device=dev).manual_seed(1)
    carry = [torch.randn(p['shape'], generator=gen, device=dev)
             for _ in range(2)]
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])

    def tpass():
        for s_ in p['src']:
            S.tape_chunk(*carry, *coef, s_, isz=p['geo']['isz'])

    tpass()
    S.reset_launches()
    tpass()
    launched = {k: v for k, v in S.launches.items() if v}
    ms = C.cuda_ms(tpass, 5)
    graph = C.graph_ms(tpass, 5)
    print(f'tape_chunk of {S.__file__} at {p["shape"]} ({len(p["src"])} '
          f'chunks of {C.CHUNK}'
          + (', route forced to tape_step_global' if route else '')
          + f'): {ms:.3f} ms per pass with the host\'s launches, '
          f'{graph:.3f} as a CUDA graph; launches {launched}', flush=True)
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
        tape = torch.randn((C.CHUNK + 1, *p['shape']), device=dev)
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


# tape_step's variants: each a list of (text, replacement) in the source.
_HALO = """        if (halo) {
          if (y < 2) hu[at] = p;
          if (y >= rows - 2) hd[at] = p;
        }
"""
_BARRIER = """    if (halo) {
      cluster_arrive();
      cluster_wait();
    }
"""
_STORE = "        out[at] = p;\n"
_STENCIL = """        const float lap = kC2 * (((ym1 + yp1) + r[xm1]) + r[xp1]) +
                          kC3 * (((ym2 + yp2) + r[xm2]) + r[xp2]);
        float p = (s1[at] * cc - s2[at] * o[at]) + sa[at] * lap;
"""
_LOCAL = [(_HALO, ''), (_BARRIER, '    __syncthreads();\n')]
TAPE_CUTS = {
    'no tape stores': [(_STORE, '')],
    'no DSMEM, block barrier': _LOCAL,
    'no DSMEM, block barrier, no stores': _LOCAL + [(_STORE, '')],
    'one add a cell, no DSMEM, block barrier, no stores':
        _LOCAL + [(_STORE, ''), (_STENCIL, '        float p = cc + yp2;\n')],
}
# The timeline: each block's start, end and SM, written by thread 0 into
# the first cells of tape slot 0 (as 64-bit words) at the end of the launch.
_TIMELINE = [
    ("  extern __shared__ float smem[];\n  const int rank = cluster_rank();",
     "  extern __shared__ float smem[];\n  unsigned long long t_start;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n"
     "  const int rank = cluster_rank();"),
    ("    sk = sk_next;\n  }\n}",
     "    sk = sk_next;\n  }\n  __syncthreads();\n  if (tid == 0) {\n"
     "    unsigned long long t_end;\n    unsigned smid;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_end));\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    unsigned long long* d = reinterpret_cast<unsigned long long*>(tape)"
     " + 4 * (blockIdx.y * ranks + rank);\n"
     "    d[0] = t_start;\n    d[1] = t_end;\n    d[2] = smid;\n  }\n}"),
]


def _edit(src, cuts, name):
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f'variant {name!r}: {old!r} not in source once')
        src = src.replace(old, new)
    return src


def tape_breakdown():
    """tape_step as built and cut (TAPE_CUTS), ms per pass at the headline
    and nbc=40 shapes, then one launch's timeline at each."""
    import torch
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    probs = []
    for ctx in (C.HEADLINE, C.NARROW):
        p = C.headline_problem(dev, ctx)
        gen = torch.Generator(device=dev).manual_seed(1)
        carry = [torch.randn(p['shape'], generator=gen, device=dev)
                 for _ in range(2)]
        probs.append((ctx['nbc'], p, carry))
    real = S._CSRC
    S.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def timed(args, steps=C.CHUNK):
        p, carry = args
        coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
        srcs = [s_[:steps].contiguous() for s_ in p['src']]
        return C.cuda_ms(lambda: [S.tape_chunk(*carry, *coef, s_,
                                               isz=p['geo']['isz'])
                                  for s_ in srcs], 5)

    for name in ('as built', *TAPE_CUTS):
        if name == 'as built':
            S._CSRC = real
        else:
            path = S.BUILD_DIR / ('tape-' + re.sub(r'\W+', '-', name) + '.cu')
            path.write_text(_edit(real.read_text(), TAPE_CUTS[name], name))
            S._CSRC = path
        S._lib = None
        cells = []
        for nbc, p, carry in probs:
            cells.append(f'nbc={nbc} {timed((p, carry)):.3f}')
            if name == 'as built':
                cells.append('chunks of ' + ', '.join(
                    f'{n}: {timed((p, carry), n):.3f}'
                    for n in (1, 2, 5, 10)))
        print(f'tape_step {name}, ms per pass: ' + '; '.join(cells),
              flush=True)
    path = S.BUILD_DIR / 'tape-timeline.cu'
    path.write_text(_edit(real.read_text(), _TIMELINE, 'timeline'))
    S._CSRC, S._lib = path, None
    for nbc, p, carry in probs:
        coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
        tape = S.tape_chunk(*carry, *coef, p['src'][3], isz=p['geo']['isz'])
        ranks = S.last_ranks['tape_step']
        fields = p['shape'][0] * p['shape'][1]
        d = tape[0].reshape(-1).view(torch.int64)[:4 * fields * ranks]
        d = d.reshape(fields, ranks, 4).cpu()
        t0 = int(d[..., 0].min())
        start = (d[..., 0] - t0).min(1).values.double() / 1e3
        end = (d[..., 1] - t0).max(1).values.double() / 1e3
        waves = sorted({round(float(s_), -1) for s_ in start})
        print(f'tape_step timeline at nbc={nbc}: {fields} clusters of {ranks} '
              f'blocks, launch {float(end.max()):.2f} us, a cluster '
              f'{float((end - start).mean()):.2f} us on average, cluster '
              f'starts (us, to 10) {waves}', flush=True)
    S._CSRC, S._lib = real, None
    print(card_line())
    return 0


# tape_step_stream's variants: each a list of (text, replacement) in the
# source. The per-step cluster barrier's text, with what follows the
# kernel, is that kernel's alone.
_S_STEP_BARRIER = """    if (!halo) break;    // the last step: no rows are read after it
    cluster_arrive();
    cluster_wait();
"""
_S_END = """    const int t = cur; cur = nxt; nxt = t;
  }
}

// The adjoint's blocking"""
_S_CELL = """    const float lap = kC2 * (((w.ym1 + w.yp1) + r[dm1]) + r[dp1]) +
                      kC3 * (((w.ym2 + yp2) + r[dm2]) + r[dp2]);
    float cf[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      cf[i] = i < NP ? res[i * plane + at] : w.q[i < NP ? 0 : i - NP][0];
    const float p = (cf[1] * w.cc - cf[2] * o[at]) + cf[0] * lap;
"""
_S_PUSH = """        for (int j = 0; ya + j < top; ++j)
          dsmem_store(hu, j * W, o[first + j * W]);
        for (int j = bot - ya; j < nb; ++j)
          dsmem_store(hd, j * W, o[first + j * W]);
"""
STREAM_CUTS = {
    'no streamed loads': [('w.q[i][a] = sp[i][w.ahead];',
                           'w.q[i][a] = __int_as_float(w.ahead);')],
    'no tape stores': [('    o[at] = p;\n    out[at] = p;\n',
                        '    o[at] = p;\n')],
    'block barrier a step': [
        (_S_STEP_BARRIER, '    if (!halo) break;\n    __syncthreads();\n'),
        (_S_END, _S_END.replace('  }\n}', '  }\n  cluster_arrive();\n'
                                '  cluster_wait();\n}'))],
    'one add a cell': [(_S_CELL, '    const float p = w.cc + yp2;\n')],
    'no halo rows': [(_S_PUSH, '')],
    'no steps': [('    for (int col = 0; col < cols; ++col) {',
                  '    for (int col = 0; col < 0 * cols; ++col) {')],
}


def stream_breakdown():
    """tape_step_stream as built and cut (STREAM_CUTS), ms per 200-step
    pass at chip_smoke.py's BEYOND field (420x420, B=1, ns=5) as a CUDA
    graph, with chunks of 1, 2, 5, 10 and 20 steps as built; then
    tape_step_global forced at the same pass."""
    import torch
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import stencil as S

    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    p = C.headline_problem(dev, C.BEYOND, batch=1)
    gen = torch.Generator(device=dev).manual_seed(1)
    carry = [torch.randn(p['shape'], generator=gen, device=dev)
             for _ in range(2)]
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    hp, wp = p['shape'][-2:]
    print(f'tape_step_stream at {p["shape"]}: plan (blocks a cluster, '
          f'resident planes) {S.pick_stream(hp, wp)}', flush=True)
    real = S._CSRC
    S.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def timed(steps=C.CHUNK):
        srcs = [s_[:steps].contiguous() for s_ in p['src']]
        return C.graph_ms(lambda: [S.tape_chunk(*carry, *coef, s_,
                                                isz=p['geo']['isz'])
                                   for s_ in srcs], 5)

    for name in ('as built', *STREAM_CUTS):
        if name == 'as built':
            S._CSRC = real
        else:
            path = S.BUILD_DIR / ('stream-' + re.sub(r'\W+', '-', name)
                                  + '.cu')
            path.write_text(_edit(real.read_text(), STREAM_CUTS[name], name))
            S._CSRC = path
        S._lib = None
        S.reset_launches()
        cells = [f'{timed():.3f}']
        check = S.launches['tape_step_stream']
        if name == 'as built':
            cells.append('chunks of ' + ', '.join(
                f'{n}: {timed(n):.3f}' for n in (1, 2, 5, 10)))
        print(f'tape_step_stream {name}, ms per pass as a CUDA graph: '
              + '; '.join(cells) + f' ({check} launches)', flush=True)
    S._CSRC, S._lib = real, None
    pick_stream = S.pick_stream
    S.pick_stream = lambda h, w: None
    print(f'tape_step_global forced, ms per pass as a CUDA graph: '
          f'{timed():.3f}', flush=True)
    S.pick_stream = pick_stream
    # The instantiations with one and with no resident plane, and
    # tape_step_global forced at the same pass.
    for ctx in (dict(C.BEYOND, n_grid=400, ng=400),
                dict(C.BEYOND, n_grid=500, ng=500)):
        p = C.headline_problem(dev, ctx, batch=1)
        carry = [torch.randn(p['shape'], generator=gen, device=dev)
                 for _ in range(2)]
        coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
        plan = S.pick_stream(*p['shape'][-2:])
        cells = [f'tape_step_stream (plan {plan}) {timed():.3f}']
        S.pick_stream = lambda h, w: None
        cells.append(f'tape_step_global forced {timed():.3f}')
        S.pick_stream = pick_stream
        print(f'at {p["shape"]}, ms per pass as a CUDA graph: '
              + ', '.join(cells), flush=True)
    print(card_line())
    return 0


def main():
    if sys.argv[1:2] == ['--stream']:
        return stream_breakdown()
    if sys.argv[1:2] == ['--sum-shots']:
        return sum_shots_device_time(sys.argv[2])
    if sys.argv[1:2] == ['--tape']:
        return tape_breakdown()
    if sys.argv[1:2] == ['--tape-pass']:
        return tape_pass_time(sys.argv[2])
    if sys.argv[1:2] == ['--beyond-pass']:
        return beyond_pass_time(sys.argv[2], *sys.argv[3:4])
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
    # A tape of one chunk (chunk + 1 slots, slot i = s_{i-1}); its values
    # do not matter here.
    tape = torch.randn((C.CHUNK + 1, *p['shape']), device=dev)
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
