"""A tiny CPU rehearsal of each driver: it reaches a well-formed last line
with the device's numbers absent and not faked, and its output check
passes; the entry point refuses to run without a card."""
import json
import time

import pytest
import torch

from conftest import tiny
from h100_bench import run as entry
from h100_bench.lib import harness


@pytest.mark.parametrize('workload', ['openfwi-red-b4', 'openfwi-train-b32',
                                      'marmousi-red-b1'])
def test_driver_rehearsal(workload):
    cell = tiny(workload)
    out = harness.driver(cell['traffic']['driver']).run(
        cell, torch.device('cpu'), 2 ** 31 + 7, 0.0, False,
        time.perf_counter())
    assert out.correct, out.checks
    device = {'platform': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
    line = json.loads(json.dumps(harness.result_line(cell, out, device,
                                                     False)))
    assert list(line)[-1] == 'checks'
    assert set(line) >= {'correct', 'attempted', 'failed', 'metrics',
                         'device'}
    assert {m['name'] for m in cell['end_to_end']} == set(line['metrics'])
    assert all(v['value'] > 0 for v in line['metrics'].values())
    # No trace on the CPU: every device-trace metric is left out; only the
    # program's own span of its warm-up is there to read.
    traced = harness.result_line(cell, out, device, True)
    assert set(traced['metrics']) <= {'warm_compile_s'}
    assert 'breakdown' not in traced and 'busy_s' not in traced['device']


def test_entry_point_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = entry.main(['--workload', 'openfwi-red-b4', '--seed', '1',
                     '--seconds', '1', '--trace', '0'])
    assert rc != 0
    assert capsys.readouterr().out == ''
