"""Run one cell of the port's benchmark once and print its result.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a profiler trace of the window. Every run
checks what the timed path produced against the plain reference under
``h100_bench/reference/`` and prints each number compared beside its
limit, last on standard error and in the result line. The last line of
standard output is the result, a JSON object. Without the cards, or with
the JAX package or JAX loaded after the window, it exits non-zero and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench.lib import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    harness.fixed_caches()
    cell = harness.load_cell(args.workload)
    import torch
    chips = int(cell['workload']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'this cell needs {chips} CUDA device(s); '
              f'available: {torch.cuda.is_available()}, count: '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device('cuda', 0)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}; '
          f'cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, '
          f'matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}',
          flush=True)
    run = harness.driver(cell['traffic']['driver']).run
    out = run(cell, dev, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f'modules loaded that the port must not load: {found}',
              file=sys.stderr)
        return 3
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
              'count': chips, 'memory_peak_bytes': out.memory_peak_bytes}
    if args.trace and out.trace is not None:
        device['busy_s'] = out.trace.busy_s
        device['window_s'] = out.trace.window_s
    line = harness.result_line(cell, out, device, bool(args.trace))
    print(f'card: {harness.card_line()} (the peaks assume 700 W)',
          flush=True)
    for k, (v, lim) in out.checks.items():
        print(f'check {k}: {v!r} limit {lim!r}'
              f"{'' if v <= lim else '  FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
