"""The output check fails what it must: the control (the reference in
TF32 put in the program's place) and each fault a cell can have, planted
in the program underneath a tiny CPU run of the harness."""
import time

import pytest
import torch

from conftest import tiny
from h100_bench.lib import harness

CPU = torch.device('cpu')


def numbers_fail(cell, checks):
    lim = cell['traffic']['limits']
    return any(not (v <= lim[k]) for k, v in checks.items())


@pytest.mark.parametrize('workload', ['openfwi-red-b4', 'openfwi-train-b32',
                                      'marmousi-red-b1'])
def test_control_fails(workload):
    cell = tiny(workload)
    checks = harness.driver(cell['traffic']['driver']).control(cell, CPU, 5)
    assert numbers_fail(cell, checks), checks


# ``b1`` at the tiny B=1 size moves the numbers by less than the cell's
# limits; at the cell's own size on the card it fails them (PERF.md).
CASES = [('openfwi-red-b4', f) for f in ('unchanged', 'half', 'altered',
                                         'stale', 'b1', 'obsgrad')] \
    + [('marmousi-red-b1', f) for f in ('unchanged', 'altered', 'stale',
                                        'obsgrad')] \
    + [('openfwi-train-b32', f) for f in ('unchanged', 'half', 'altered',
                                          'ema', 'emadecay')]


@pytest.mark.parametrize('workload,fault', CASES)
def test_fault_fails(workload, fault):
    cell = tiny(workload)
    kind = cell['traffic']['driver']
    with harness.driver(kind).fault(fault):
        out = harness.driver(kind).run(cell, CPU, 11, 0.0, False,
                                       time.perf_counter())
    assert not out.correct, out.checks
