"""BENCHMARK.json resolves: every cell to its configuration, traffic mix,
driver and metric readers, within the limits of its format."""
import json
import re

import pytest

from conftest import ROOT
from h100_bench.lib import harness

SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def test_top_level_keys_and_paths():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['h100_bench']
    assert 1 <= SPEC['run_seconds'] <= 51
    for word in SPEC['command']:
        assert not word.startswith('/') and '..' not in word
    assert (ROOT / SPEC['command'][1]).is_file()


@pytest.mark.parametrize('w', [w['name'] for w in SPEC['workloads']])
def test_cell_resolves(w):
    cell = harness.load_cell(w)
    drv = harness.driver(cell['traffic']['driver'])
    assert callable(drv.run) and callable(drv.control)
    assert cell['workload']['chips'] == 1
    e2e = {m['name'] for m in cell['end_to_end']}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell['per_layer']
    for m in cell['per_layer']:
        assert m['moves'] in e2e
        assert callable(harness.reader(m['name']))
    assert set(cell['traffic']['limits']) and all(
        lim > 0 for lim in cell['traffic']['limits'].values())


def test_names_units_and_bounds():
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in SPEC['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for c in SPEC['configs']:
        assert (ROOT / c['file']).is_file()
        assert c['file'].startswith('h100_bench/')
    pairs = [(w['config'], w['traffic']) for w in SPEC['workloads']]
    assert len(set(pairs)) == len(pairs)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_reduced_keys_differ_from_the_preset_and_others_match():
    from red_diffeq_tpu_torch.config import load_config
    for c in SPEC['configs']:
        cfg = json.loads((ROOT / c['file']).read_text())
        preset = load_config(ROOT / cfg['preset']).to_dict()
        for section in ('pde', 'model', 'diffusion', 'optimization',
                        'data', 'tpu'):
            for k, v in preset[section].items():
                key = f'{section}.{k}'
                assert (cfg[section][k] != v) == (key in c['reduced']), key
