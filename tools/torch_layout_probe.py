#!/usr/bin/env python3
"""Stencil-layout probe on the card: does another x-stencil layout step the
wave recursion faster?

The PyTorch counterpart of ``tools/kernel_layout_probe.py``. It times the
bare damped-wave recursion

    p = t1*p1 - t2*p0 + alpha * L4(p1)

for ``nt`` steps on ``--programs`` independent fields of ``--size`` cells
square, under the four layouts of the x-stencil, each a hand-written CUDA
kernel (``red_diffeq_tpu_torch/ops/csrc/layout_probe.cu``):

* ``roll``   - 8 wrapped neighbour reads from a shared-memory tile;
* ``mxu_x``  - y by neighbour reads, x as the dense product ``p @ D`` with
               the banded circulant (Wp, Wp) matrix, in fp32;
* ``mxu_xy`` - ``E @ p + p @ D``, no neighbour reads;
* ``halo``   - the state kept (Hp, Wp+4) with the wrap copied into 2 halo
               columns a side, x neighbours plain offsets.

All compute the same operator. First every variant runs min(nt, 20) steps
and is held to ``roll`` (the JAX tool's check, gate 1e-4 relative); then
each is timed over ``--reps`` calls of ``nt`` steps. ``roll`` and ``halo``
keep each field in the shared memory of a thread-block cluster for all
``nt`` steps, one launch a call (the ``resident`` route), as the TPU
kernels keep it in VMEM; fields past that design's size limit take their
one-launch-a-step ``*_global`` kernels (the ``global`` route), as do the
products at every size. So the JAX tool's ``--unroll`` (steps per grid
step) has no counterpart here. On the card each line also gets the
variant's kernel, route, blocks per cluster and fields per cluster, the
kernel's largest difference from its plain PyTorch version over the
``nt`` steps, its launches a call, the call's device time replayed as a
CUDA graph (the host's launches left out) and the plain version's time;
the card's name and power limit come first. With ``--device cpu`` the
plain versions run and are timed by the host clock.

Usage, from the repository root:
    python3 tools/torch_layout_probe.py --validate-only --device cpu
    python3 tools/torch_layout_probe.py [--nt 1000 --programs 20 --reps 3]
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GATE = 1e-4


def _host_ms(fn, reps):
    """Mean ms of ``fn()`` by the host clock over ``reps`` calls after one
    warm-up (the plain versions on the CPU)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    """Run the probe; returns one record a variant and timing line (the
    dicts printed), with ``'ok'`` False in the validation records when a
    variant misses the gate."""
    import torch
    import chip_smoke
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    from red_diffeq_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--programs', type=int, default=20,
                    help='independent (sample, shot) fields (bench '
                         'workload: batch 4 x ns 5 = 20)')
    ap.add_argument('--size', type=int, default=310)
    ap.add_argument('--nt', type=int, default=1000)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--variants', nargs='+', default=list(lp.VARIANTS),
                    choices=lp.VARIANTS)
    ap.add_argument('--validate-only', action='store_true',
                    help='the equivalence check alone, at 2 fields of '
                         '40x48 and 20 steps')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == 'cuda'
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    if args.validate_only:
        nprog, hp, wp, nt = 2, 40, 48, 20
    else:
        nprog, hp, wp, nt = args.programs, args.size, args.size, args.nt
    prob = [torch.from_numpy(a).to(dev)
            for a in lp.make_problem(nprog, hp, wp)]

    # Correctness: every variant is the same operator.
    records, ref = [], None
    for v in args.variants:
        out = lp.run_variant(v, *prob, nt=min(nt, 20))
        if ref is None:
            ref = out
        err = chip_smoke.max_rel(out, ref)
        records.append(_emit({'variant': v, 'rel_err_vs_roll': err,
                              'ok': err < GATE}))
    ok = all(r['ok'] for r in records)
    if args.validate_only:
        print('VALIDATION', 'OK' if ok else 'FAILED', flush=True)
        return records

    for v in args.variants:
        def call(v=v):
            return lp.run_variant(v, *prob, nt=nt)

        rec = {'variant': v, 'device': str(dev), 'programs': nprog,
               'size': [hp, wp], 'nt': nt}
        if on_card:
            plan = lp.route(v, nprog, hp, wp)
            kernel = plan['kernel']
            rec.update(kernel=kernel, route=plan['route'],
                       ranks=plan['ranks'],
                       fields_per_cluster=plan['fields_per_cluster'])
            before = lp.launches[kernel]
            got = call()
            rec['launches_per_call'] = lp.launches[kernel] - before
            want = lp.plain_variant(v, *prob, nt=nt)
            rec['max_abs_err_vs_plain'] = float((got - want).abs().max())
            rec['max_rel_vs_plain'] = chip_smoke.max_rel(got, want)
            del got, want
        dt = (chip_smoke.cuda_ms(call, args.reps) if on_card
              else _host_ms(call, args.reps))
        rec['ms_per_call'] = round(dt, 3)
        rec['us_per_step_per_field'] = round(dt * 1e3 / nt / nprog, 4)
        if on_card:
            rec['graph_ms_per_call'] = round(
                chip_smoke.graph_ms(call, args.reps), 3)
            rec['plain_ms_per_call'] = round(chip_smoke.cuda_ms(
                lambda: lp.plain_variant(v, *prob, nt=nt), 1), 3)
        records.append(_emit(rec))
    return records


if __name__ == '__main__':
    recs = main()
    sys.exit(0 if all(r.get('ok', True) for r in recs) else 1)
