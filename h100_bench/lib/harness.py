"""The harness: one run of one cell, driven by ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the preset as it
is run) and a traffic mix (``traffic/<name>.json``: the parameters of the
window and of the output check, and ``driver``, the module
``drivers/<driver>.py`` that runs it). Per-layer metrics are readers
``metrics/<name>.py``, found by the metric's name. A later cell, mix,
driver or metric is a new file and a new entry; nothing here changes.

A driver's ``run(cell, device, seed, seconds, trace, t_start)`` returns
an :class:`Outcome`: the end-to-end metrics it timed, the context the
per-layer readers read in a traced run, the numbers compared with their
limits, the units of work attempted (jobs, train steps) and those the
check found wrong, and the device's peak memory. ``control(cell, device,
seed)`` gives the numbers of the control and ``fault(name)`` plants a
fault (``lib/faults.py``).
"""
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'h100_bench'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'red_diffeq_tpu')


@dataclass
class Outcome:
    metrics: Dict[str, float]
    context: dict
    checks: Dict[str, tuple]          # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[object] = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            v == v and v <= lim for v, lim in self.checks.values())


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The workload's entry with its configuration and traffic files
    read, and the metric entries that apply to it."""
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    work = {w['name']: w for w in spec['workloads']}
    if workload not in work:
        raise SystemExit(f'unknown workload {workload!r}; the cells are '
                         f'{sorted(work)}')
    w = work[workload]
    conf = {c['name']: c for c in spec['configs']}[w['config']]
    traffic = json.loads((root / 'h100_bench' / 'traffic'
                          / f"{w['traffic']}.json").read_text())

    def applies(m):
        return workload in m.get('workloads', [workload])

    return dict(workload=w, config=json.loads((root / conf['file'])
                                              .read_text()),
                traffic=traffic,
                end_to_end=[m for m in spec['end_to_end'] if applies(m)],
                per_layer=[m for m in spec['per_layer'] if applies(m)])


def driver(name: str):
    return importlib.import_module(f'h100_bench.drivers.{name}')


def reader(metric: str):
    """The per-layer reader ``metrics/<metric>.py`` (names hold dots)."""
    path = BENCH / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'h100_bench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fixed_caches(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own ``ops/_build`` and ``io/_build`` already are)."""
    cache = root / 'h100_bench' / '_cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ.setdefault('USE_FLAX', '0')


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (the
    published peaks assume 700 W)."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi: {e}'
    return out.stdout.strip() or out.stderr.strip()


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell, out: Outcome, device: dict, trace: bool) -> dict:
    """The run's result line; with ``trace`` the per-layer metrics read
    from ``out.context``, else the cell's end-to-end metrics."""
    if trace:
        metrics = {}
        for m in cell['per_layer']:
            v = reader(m['name'])(out.context)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': out.metrics[m['name']],
                               'unit': m['unit']}
                   for m in cell['end_to_end'] if m['name'] in out.metrics}
    line = {'correct': out.correct, 'attempted': out.attempted,
            'failed': out.failed, 'metrics': metrics, 'device': device}
    if trace and out.trace is not None:
        line['breakdown'] = out.trace.breakdown()
    line['checks'] = {k: {'value': v, 'limit': lim}
                      for k, (v, lim) in out.checks.items()}
    return line
