"""On the card, at each cell's own size: one run reaches a correct,
well-formed last line, and the control fails the cell's limits. Skipped
without a card; run on the card with

    python3 -m pytest h100_bench/tests/test_h100_bench_card.py
"""
import json

import pytest

from h100_bench import run as entry
from h100_bench.lib import harness

CELLS = ['openfwi-red-b4', 'openfwi-train-b32', 'marmousi-red-b1']


@pytest.mark.card
@pytest.mark.parametrize('workload', CELLS)
def test_cell_run_is_correct(workload, card, capsys):
    rc = entry.main(['--workload', workload, '--seed', '2147483659',
                     '--seconds', '0', '--trace', '0'])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line['correct'] and line['failed'] == 0
    assert line['device']['platform'] == 'gpu'
    assert 'setup_s' in line['metrics']


@pytest.mark.card
@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_at_cell_size(workload, card):
    cell = harness.load_cell(workload)
    checks = harness.driver(cell['traffic']['driver']).control(
        cell, card, 2147483661)
    lim = cell['traffic']['limits']
    assert any(not (v <= lim[k]) for k, v in checks.items()), checks
