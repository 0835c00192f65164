"""The readings that the output check's limits are set from (not run by
the benchmark's runs).

    python3 h100_bench/readings.py --workload <name> --seeds 1 2 3 ... \\
        [--control 7 8 9] [--faults half altered] [--fault-seeds 4 5 6]

For each of ``--seeds`` a sound run of the program (one job or one train
call after the set-up, as a run's window starts) and its numbers; for
each of ``--control`` the reference in TF32 put in the program's place;
for each fault named (``lib/faults.py``, each driver's ``fault``), the program with that fault on
each of ``--fault-seeds``. One JSON line a reading, then the largest sound
reading and the smallest control and fault readings of each number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench.lib import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control', type=int, nargs='*', default=[])
    p.add_argument('--faults', nargs='*', default=[])
    p.add_argument('--fault-seeds', type=int, nargs='*', default=[])
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    harness.fixed_caches()
    import torch
    dev = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell['traffic']['driver'])
    rows = []

    def note(what, seed, checks, extra=None):
        row = dict(what=what, seed=seed, **{k: v for k, v in checks.items()},
                   **(extra or {}))
        rows.append(row)
        print(json.dumps(row), flush=True)

    for s in args.seeds:
        out = drv.run(cell, dev, s, 0.0, False, time.perf_counter())
        note('sound', s, {k: v for k, (v, _) in out.checks.items()},
             out.metrics)
    for s in args.control:
        note('control', s, drv.control(cell, dev, s))
    for f in args.faults:
        for s in args.fault_seeds:
            with drv.fault(f):
                out = drv.run(cell, dev, s, 0.0, False, time.perf_counter())
            note(f, s, {k: v for k, (v, _) in out.checks.items()})
    names = [k for k in rows[0] if k not in ('what', 'seed')] if rows else []
    for what in dict.fromkeys(r['what'] for r in rows):
        pick = [r for r in rows if r['what'] == what]
        agg = max if what == 'sound' else min
        print(json.dumps({'summary': what, 'n': len(pick), **{
            k: agg(r[k] for r in pick) for k in names
            if all(k in r for r in pick)}}), flush=True)


if __name__ == '__main__':
    main()
