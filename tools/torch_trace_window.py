#!/usr/bin/env python3
"""Whether a trace of the card holds every kernel the traced block launched.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_trace_window.py [--runs N] [--pause S]

The profiler keeps only the device events that lie inside its window,
which it opens and closes by the host's clock; the card's clock and the
host's can disagree. This tool traces the graphed DiffusionFWI run that
``chip_smoke.py``'s phase ``loop graphs`` traces (``LOOP_TRACE`` outer x
inner steps at the OpenFWI ablation preset, its graphs captured by an
untraced run first) ``N`` times with ``utils/profiling.trace``, the
tracer's window margin (``WINDOW_MARGIN_S``) set to 0 and to its default in
turn, ``S`` seconds apart. For each trace it prints the solver kernels the
trace holds against the launch counters, the ``fwd_step`` kernels after the
last adjoint kernel (the run's last metrics forward: 500 when whole) and
by how many µs the last device event ends after the last host event.
Exits 1 if a trace taken with the default margin lacks a kernel.
Prints the card's name and power limit last.
"""
import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNELS = ('fwd_step', 'bwd_reverse_step', 'sum_shots')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def trace_counts(events):
    """From a Chrome trace's events: the solver kernels by name
    (KERNELS), the ``fwd_step`` kernels after the last
    ``bwd_reverse_step`` (None without one), and µs from the end of the
    last host event to the end of the last device event."""
    spans = [e for e in events if e.get('ph') == 'X']
    device = sorted((e for e in spans if e.get('cat') in DEVICE_CATS),
                    key=lambda e: e['ts'])
    host = [e for e in spans if e.get('cat') not in DEVICE_CATS]
    names = []
    for e in device:
        hit = [k for k in KERNELS if e['cat'] == 'kernel'
               and re.search(rf'\b{k}\b', e['name'])]
        names.append(hit[0] if hit else None)
    counts = {k: names.count(k) for k in KERNELS}
    adjoint = [i for i, n in enumerate(names) if n == 'bwd_reverse_step']
    tail = names[adjoint[-1]:].count('fwd_step') if adjoint else None
    end = None
    if device and host:
        end = (max(e['ts'] + e['dur'] for e in device)
               - max(e['ts'] + e['dur'] for e in host))
    return counts, tail, end


def main(argv=None):
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--runs', type=int, default=8)
    ap.add_argument('--pause', type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    import chip_smoke as C
    from red_diffeq_tpu_torch.bench_methods import DiffusionFWI
    from red_diffeq_tpu_torch.cli.run_inversion import (
        build_diffusion_model, build_forward_operator,
    )
    from red_diffeq_tpu_torch.config import load_config
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.utils import profiling
    from red_diffeq_tpu_torch.utils.data_trans import prepare_initial_model

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    stencil.build()
    margin = profiling.WINDOW_MARGIN_S
    short = 0
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        cfg = load_config(C.write_bench_dataset(dev, root)[C.BENCH_PRESET])
        o = cfg.optimization
        op = build_forward_operator(cfg, device=dev)
        method = DiffusionFWI(build_diffusion_model(cfg, device=dev), op,
                              device=dev)
        v_true = np.load(f'{cfg.data.velocity_data_dir}/synthetic.npy')[:1]
        y = np.load(f'{cfg.data.seismic_data_dir}/synthetic.npy')[:1]
        mu0 = prepare_initial_model(v_true, o.initial_type, sigma=o.sigma)
        dts, ts = C.LOOP_TRACE

        def run():
            return method.optimize(
                mu0, v_true, y, op, ts=ts, diffusion_ts=dts, lr=o.lr,
                grad_norm=o.grad_norm, grad_smooth=o.grad_smooth,
                model_blur=o.model_blur, grad_clip=o.grad_clip,
                generator=torch.Generator(device=dev).manual_seed(0),
                progress=False)

        C.loop_mode(dev, True, run)
        for i in range(args.runs):
            if i:
                time.sleep(args.pause)
            profiling.WINDOW_MARGIN_S = 0.0 if i % 2 == 0 else margin
            log_dir = root / f'trace{i}'
            r = C.loop_mode(dev, True, lambda: C._traced(
                run, log_dir, profiling.trace, dev))
            path, = log_dir.glob('*.pt.trace.json')
            counts, tail, end = trace_counts(
                json.loads(path.read_text())['traceEvents'])
            want = {k: r['launches'][k] for k in KERNELS}
            whole = counts == want
            if not whole and profiling.WINDOW_MARGIN_S:
                short += 1
            print(f'trace {i}, margin {profiling.WINDOW_MARGIN_S} s: '
                  f'kernels {counts}, counters {want} '
                  f'({"whole" if whole else "short"}); fwd_step after the '
                  f'last adjoint kernel {tail}; the last device event ends '
                  f'{end} us after the last host event', flush=True)
        profiling.WINDOW_MARGIN_S = margin
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 1 if short else 0


if __name__ == '__main__':
    sys.exit(main())
