#!/usr/bin/env python3
"""Where a launch of the layout probe's tensor-core products, or of its
resident stencils, spends its time.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_probe_breakdown.py [--nt 1000] [--reps 3]
        [--programs 20] [--resident]

At the probe's workload (20 fields of 310x310, ``chip_smoke.py``'s PROBE)
it times ``probe_mxu_x`` and ``probe_mxu_xy`` straight through their
launcher ``rdt_probe_mxu`` (no wrapper), nt steps a call, as device time:
the call captured once in a CUDA graph and replayed. Then the same for
variants of ``red_diffeq_tpu_torch/ops/csrc/layout_probe.cu``, each built
next to the real library in the git-ignored build directory (all builds at
once). Some cut one part out and compute wrong values, only to be timed:

* ``no products``: both products skipped (the epilogue, the launches);
* ``store only``: the epilogue stores the products' sum alone (no
  y-stencil, no reads of p0, p1 or the planes);
* ``no staging``: no cp.async (the slabs are whatever shared memory holds);
* ``no mma``: each mma.sync replaced by one add (the staging, the
  fragments' shared-memory reads and splits, the barriers);
* ``no split``: every part of an operand its fp32 value (no splits);
* ``mma only``: no splits, no staging, the epilogue a store (what is left:
  the fragments' shared-memory reads, the mma.sync, the barriers).

Others are designs of their own: ``stages 3`` (a ring of 3 stages),
``depth 16`` (slabs 16 deep), ``epilogue 8 rows`` (8 rows of loads in
flight a thread, not 4), ``3 blocks an SM`` and ``4 blocks an SM``
(registers capped for 3 or 4 resident blocks), ``TF32 parts`` (3 parts
of 11 bits in place of 8), ``3xTF32`` (2 parts of 11 bits, the products
lo*hi and hi*lo into one sum, hi*hi into another). Each line gives every
variant's max-rel from the plain version (``torch.matmul`` in fp32)
after the call, the gate's measure, and each kernel's registers, spill
bytes and resident blocks an SM. Prints one line a variant and the
card's name and power limit last. ``--programs`` sets the fields of a
call (25 blocks each at 310x310: how the blocks fill the card's waves).

With ``--against SOURCE`` another version of the source (for instance
the parent commit's, from ``git show``) is built and timed as it is, on
the line ``against``, beside this one's.

With ``--resident`` it times ``probe_roll`` and ``probe_halo`` (one
cluster launch a call, ``rdt_probe_resident``) the same way, under the
source variants of RESIDENT_VARIANTS. Some cut one part out (wrong
values, timed only): ``block barrier a step`` (each step's cluster
barrier a block barrier, one cluster barrier before the blocks leave so
that none leaves while a neighbour writes into it), ``no halo rows``
(the writes into the neighbours' halo rows), ``no steps`` (every step's
cell updates: what is left is the load, the barriers and the store),
``no coefficients`` (alpha, t1 and t2 read as constants: 24 fewer
registers). ``band 7`` (bands of at most 7 rows: 3 fewer registers),
``generic remote stores`` (the neighbours' halo rows written through
64-bit generic pointers from ``map_shared_rank``, not 32-bit
``st.shared::cluster`` addresses) and ``store after the steps`` (the
newest state stored after the step loop, not in its last step) are
designs of their own. The shipped
source (and ``against``) is also timed at 1 and 2 fields a cluster (20
and 10 clusters for 20 fields) beside its own pick.
"""
import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_MMA = re.compile(r'  asm\("mma\.sync.*?\);\n', re.S)
_CP_ASYNC = re.compile(
    r'  asm volatile\("cp\.async\.cg\.shared\.global.*?\);\n', re.S)
_SPLIT = re.compile(r'(void split_parts\(float x,\s*unsigned '
                    r'\(&part\)\[kParts\]\) \{\n).*?\n\}\n', re.S)


def _split_body(body):
    """A substitution of split_parts' body."""
    return (_SPLIT, lambda m: m.group(1) + body + '}\n')


_STORE_ONLY = [('if (!XY) {', 'if (false) {'),
               ('update(u[k], c1[k], v[k], c0[k], a[k],', '(')]
_NO_SPLIT = [_split_body('  for (int q = 0; q < kParts; ++q) '
                         'part[q] = __float_as_uint(x);\n')]
_CVT = '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(part[{}]) : "f"(x));\n'
# Each variant: substitutions on the source.
VARIANTS = {
    'as built': [],
    'no products': [(re.compile(r'product_tile<(?:true|false)>\([^;]*\);'),
                     ';')],
    'store only': _STORE_ONLY,
    'no staging': [(_CP_ASYNC, '')],
    'no mma': [(_MMA, '  c[0] = c[0] + __uint_as_float(a[0] ^ b[1]);\n')],
    'stages 3': [('kStages = 2', 'kStages = 3')],
    'depth 16': [('kMxuK = 32', 'kMxuK = 16')],
    'no split': _NO_SPLIT,
    'mma only': _STORE_ONLY + _NO_SPLIT + [(_CP_ASYNC, '')],
    'epilogue 8 rows': [('constexpr int kRows = 4;', 'constexpr int kRows = 8;')],
    '3 blocks an SM': [('__launch_bounds__(kMxuThreads)\n    probe_mxu(',
                        '__launch_bounds__(kMxuThreads, 3)\n    probe_mxu(')],
    '4 blocks an SM': [('__launch_bounds__(kMxuThreads)\n    probe_mxu(',
                        '__launch_bounds__(kMxuThreads, 4)\n    probe_mxu(')],
    # 3 parts of 11 significant bits: half of 13 dropped bits.
    'TF32 parts': [('kHalf = 1u << 15, kCut = ~0xffffu',
                    'kHalf = 1u << 12, kCut = ~0x1fffu')],
    # hi = cvt.rna(x), lo = cvt.rna(x - hi); lo*hi and hi*lo, then hi*hi.
    '3xTF32': [('kParts = 3, kPasses = 6', 'kParts = 2, kPasses = 3'),
               (re.compile(r'kPass\[kPasses\]\[2\] = \{.*?\};', re.S),
                'kPass[kPasses][2] = {{1, 0}, {0, 1}, {0, 0}};'),
               _split_body(_CVT.format(0)
                           + '  x = x - __uint_as_float(part[0]);\n'
                           + _CVT.format(1))],
}


_STEP_BARRIER = '''    if (k + 1 < nt) {
      cluster_arrive();
      cluster_wait();
    }
'''
_HALO_ROWS = '''        for (int j = 0; ya + j < top; ++j) cluster_store(up, j * S, o[j * S]);
        for (int j = bot - ya; j < nb; ++j)
          cluster_store(dn, j * S, o[j * S]);
'''
_LAST_BARRIER = '  }\n}\n\n// Shared memory of one probe_resident block'
_OUT_IN_STEP = '''      } else {
        float* const g = out + (size_t)(f0 + f) * H * W +
                         (size_t)(r0 + ya) * W + x;
        for (int j = 0; j < nb; ++j) g[j * W] = o[j * S];
      }
'''
_OUT_AFTER = '''  }
  int f = 0;
  do {
    const float* c = smem + 2 * f * bsz + cur + own + at;
    float* const g = out + (size_t)(f0 + f) * H * W + (size_t)(r0 + ya) * W +
                     x;
    for (int j = 0; j < nb; ++j) g[j * W] = c[j * S];
  } while (++f < nf);
}

// Shared memory of one probe_resident block'''
_COEFFICIENTS = '''      ca[j] = alpha[g];
      cu[j] = t1[g];
      cv[j] = t2[g];
'''
# The resident kernels' variants: substitutions on the source.
RESIDENT_VARIANTS = {
    'as built': [],
    'block barrier a step': [(_STEP_BARRIER, '    __syncthreads();\n'),
                             (_LAST_BARRIER, '  }\n  cluster_arrive();\n'
                              '  cluster_wait();\n' + _LAST_BARRIER[4:])],
    'no halo rows': [(_HALO_ROWS, '')],
    'no steps': [('for (int f = 0; nb > 0 && f < nf; ++f) {',
                  'for (int f = 0; false && f < nf; ++f) {')],
    'no coefficients': [(_COEFFICIENTS, '      ca[j] = 1.0f; cu[j] = 0.0f; '
                         'cv[j] = 1.0f; (void)g;\n')],
    'band 7': [('kResBand = 8;', 'kResBand = 7;'),
               (' RDT_STEP_BAND(8);', '')],
    'generic remote stores': [('#ifdef CUDA_HOST_EMULATION\nusing cluster_addr',
                               '#if 1\nusing cluster_addr')],
    'store after the steps': [(_OUT_IN_STEP, '      }\n'),
                              (_LAST_BARRIER, _OUT_AFTER)],
}


def variant_source(src, subs):
    for old, new in subs:
        if isinstance(old, str):
            n = src.count(old)
            src = src.replace(old, new)
        else:
            src, n = old.subn(new, src)
        if n == 0:
            raise RuntimeError(f'{old!r} is not in the source')
    return src


def _time_resident(args, libs, prob, dev):
    """Each library's probe_roll and probe_halo at ``prob``, nt steps a call
    through rdt_probe_resident as a CUDA graph, at the cluster its picker
    gives and, for the shipped source, at 1 and 2 fields a cluster; one
    line a variant with each kernel's ms, max-rel from the plain version,
    registers, local bytes and resident clusters."""
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    from red_diffeq_tpu_torch.ops import stencil as S
    import torch
    p0 = prob[0]
    nprog, hp, wp = p0.shape
    out = torch.empty_like(p0)
    plain = {halo: lp.plain_variant(('roll', 'halo')[halo], *prob,
                                    nt=args.nt) for halo in (0, 1)}
    for name, lib_path in libs.items():
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdt_probe_resident.argtypes = [i] + [p] * 6 + [i] * 6 + [p]
        lib.rdt_probe_resident_info.argtypes = [i] * 4 + [
            ctypes.POINTER(i)] * 6
        for halo in (0, 1):
            info = [ctypes.c_int() for _ in range(6)]
            err = lib.rdt_probe_resident_info(halo, nprog, hp, wp,
                                              *map(ctypes.byref, info))
            if err:
                raise RuntimeError(f'{name}: CUDA error {err}')
            regs, local, _, ranks, pick, clusters = (v.value for v in info)
            cells = []
            for per in ((pick, 1, 2) if name in ('as built', 'against')
                        else (pick,)):
                def call():
                    err = lib.rdt_probe_resident(
                        halo, *map(S._ptr, (p0, prob[1], out, *prob[2:])),
                        nprog, hp, wp, args.nt, ranks, per, S._stream(dev))
                    if err:
                        raise RuntimeError(f'{name}: CUDA error {err}')

                ms = C.graph_ms(call, args.reps)
                cells.append(f'{per} fields a cluster '
                             f'({-(-nprog // per)} clusters) {ms:.3f} ms '
                             f'(max-rel vs plain '
                             f'{C.max_rel(out, plain[halo]):.2e})')
            print(f'{name}: {lp.KERNELS[("roll", "halo")[halo]]}, ms a '
                  f'{args.nt}-step call as a CUDA graph: ' + ', '.join(cells)
                  + f'; {regs} registers, {local} local bytes, {ranks} '
                  f'blocks a cluster, {clusters} clusters resident',
                  flush=True)


def main(argv=None):
    import torch
    import chip_smoke as C
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    from red_diffeq_tpu_torch.ops import stencil as S

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--nt', type=int, default=C.PROBE['nt'])
    ap.add_argument('--reps', type=int, default=C.PROBE['reps'])
    ap.add_argument('--programs', type=int, default=C.PROBE['programs'],
                    help='fields of the call (blocks: 25 a 310x310 field)')
    ap.add_argument('--resident', action='store_true',
                    help='the resident kernels probe_roll and probe_halo '
                         'under RESIDENT_VARIANTS, not the products')
    ap.add_argument('--against', metavar='SOURCE', type=Path, default=None,
                    help='another version of layout_probe.cu (e.g. the '
                         'parent commit\'s), built and timed as it is '
                         'beside this one')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    src = lp._CSRC.read_text()
    S.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    variants = RESIDENT_VARIANTS if args.resident else VARIANTS
    if args.against is not None:
        path = S.BUILD_DIR / 'layout_probe_against.cu'
        path.write_text(args.against.read_text())
        paths['against'] = path
    for name, subs in variants.items():
        if not subs:
            paths[name] = lp._CSRC
            continue
        stem = ('layout_probe_' + ('resident_' if args.resident else '')
                + re.sub(r'\W', '_', name))
        path = S.BUILD_DIR / f'{stem}.cu'
        path.write_text(variant_source(src, subs))
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(lambda q: S.build(source=q),
                                        paths.values())))

    nprog, hp = args.programs, C.PROBE['size']
    wp = hp
    p0, p1, alpha, t1, t2 = [torch.from_numpy(a).to(dev) for a in
                             lp.make_problem(nprog, hp, wp)]
    if args.resident:
        _time_resident(args, libs, (p0, p1, alpha, t1, t2), dev)
        libs = {}
    s0, s1 = lp._rows_of(p0, lp.round4(wp)), lp._rows_of(p1, lp.round4(wp))
    d, e = lp.circulant(wp, dev, rows=True), lp.circulant(hp, dev, rows=True)
    x, y = torch.empty_like(s0), torch.empty_like(s0)
    plain = {xy: lp.plain_variant(('mxu_x', 'mxu_xy')[xy], p0, p1, alpha, t1,
                                  t2, nt=args.nt) for xy in (0, 1)}
    for name, lib_path in libs.items():
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdt_probe_mxu.argtypes = [i] + [p] * 9 + [i] * 4 + [p]
        lib.rdt_probe_info.argtypes = [i] + [ctypes.POINTER(i)] * 3
        cells = []
        for xy in (0, 1):
            def call():
                err = lib.rdt_probe_mxu(xy, *map(S._ptr, (
                    s0, s1, x, y, alpha, t1, t2, d, e)), nprog, hp, wp,
                    args.nt, S._stream(dev))
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')

            ms = C.graph_ms(call, args.reps)
            out = (x if args.nt % 2 else y)[..., :wp]
            info = [ctypes.c_int() for _ in range(3)]
            lib.rdt_probe_info(1 + xy, *map(ctypes.byref, info))
            cells.append(f'{lp.KERNELS[("mxu_x", "mxu_xy")[xy]]} {ms:.3f} '
                         f'(max-rel vs plain {C.max_rel(out, plain[xy]):.2e}; '
                         f'{info[0].value} registers, {info[1].value} local '
                         f'bytes, {info[2].value} blocks an SM)')
        print(f'{name}: ms a {args.nt}-step call as a CUDA graph: '
              + ', '.join(cells), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
