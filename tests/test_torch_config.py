"""The port's config objects and YAML reader/writer against the JAX package
and ``yaml.safe_load``: every ``configs/**/*.yaml`` file reads to the same
values and types; forms outside the subset raise with the file and line;
``save_config`` output reads back to the source; the defaults equal the
JAX package's."""
from pathlib import Path

import pytest
import yaml

from red_diffeq_tpu.config import default_config as jconfig
from red_diffeq_tpu_torch.config import (
    ConfigDict, get_config, get_marmousi_config, load_config, save_config,
)
from red_diffeq_tpu_torch.config.config_utils import dump_yaml, parse_yaml

REPO = Path(__file__).resolve().parents[1]
PRESETS = sorted((REPO / 'configs').rglob('*.yaml'))


def _typed(x):
    """A value with the type of every leaf, so that 300 and 300.0 differ."""
    if isinstance(x, dict):
        return {k: _typed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_typed(v) for v in x]
    return (type(x).__name__, x)


def test_every_preset_is_found():
    assert len(PRESETS) == 38


@pytest.mark.parametrize('path', PRESETS,
                         ids=lambda p: str(p.relative_to(REPO / 'configs')))
def test_reader_matches_safe_load_on_presets(path):
    text = path.read_text()
    assert _typed(parse_yaml(text, str(path))) == _typed(yaml.safe_load(text))


@pytest.mark.parametrize('value', [
    'yes', 'Off', 'TRUE', '~', 'Null', '', '0', '-0', '+1', '1_000', '-1_0',
    '09', '1.', '.5', '-.5', '0.0001', '010.5', '1.0e+5', '1e5', '1e-3',
    '.inf', '-.Inf', 'a:b', 'a#b', 'plain text', "'it''s'",
    "'*.npy'", "''", "'null'"])
def test_reader_matches_safe_load_on_scalars(value):
    text = f'a: {value}\nb:\n- {value or "x"}\n'
    assert _typed(parse_yaml(text)) == _typed(yaml.safe_load(text))


@pytest.mark.parametrize('text, line', [
    ('a: [1, 2]', 1), ('a: &x 1', 1), ('a: *x', 1), ('a: !!str 1', 1),
    ('a: "x"', 1), ('a: |\n  x', 1), ('a: 1 # c', 1), ('a: 012', 1),
    ('a: 0x1f', 1), ('a: 1:30', 1), ('a: 2020-01-01', 1), ('a: 1\na: 2', 2),
    ('a:\n\t- 1', 2), ('a:\n-\n', 2), ('a:\n- - 1', 2), ('a:\n- b: 1', 2),
    ('a: x\n  y', 2), ('- 1', 1), ('---\na: 1', 1), ('on: 1', 1),
    ("a: 'x", 1), ('a: b: c', 1), ('a: []', 1), ('a: {}', 1)])
def test_reader_raises_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=f'f.yaml:{line}'):
        parse_yaml(text, 'f.yaml')


def test_defaults_equal_the_jax_package():
    assert get_config().to_dict() == jconfig.get_config().to_dict()
    assert (get_marmousi_config().to_dict()
            == jconfig.get_marmousi_config().to_dict())


def test_save_config_reads_back(tmp_path):
    cfg = get_config()
    cfg.extra = {'strings': ['*.npy', 'null', 'true', '10', '1e-3', '-.5',
                             'a: b', '# x', "it's", '', ' lead', 'plain'],
                 'floats': [1e-5, 1e20, 0.1, -2.5, float('inf')],
                 'none': None, 'nested': {'deep': {'k': 1}}}
    save_config(cfg, tmp_path / 'run' / 'config.yaml')
    text = (tmp_path / 'run' / 'config.yaml').read_text()
    want = yaml.safe_load(yaml.safe_dump(cfg.to_dict()))   # tuples -> lists
    assert _typed(yaml.safe_load(text)) == _typed(want)
    assert _typed(load_config(tmp_path / 'run' / 'config.yaml').to_dict()) \
        == _typed(want)
    with pytest.raises(TypeError, match='bad'):
        dump_yaml({'bad': object()})
    with pytest.raises(TypeError, match='empty'):
        dump_yaml({'empty': []})


def test_load_config_maps_the_jax_backends(tmp_path):
    for jax_name, name in (('xla', 'plain'), ('pallas', 'kernel'),
                           ('auto', 'auto')):
        path = tmp_path / f'{jax_name}.yaml'
        path.write_text(f'tpu:\n  solver_backend: {jax_name}\n')
        assert load_config(path).tpu.solver_backend == name
    with pytest.raises(FileNotFoundError):
        load_config(tmp_path / 'missing.yaml')


def test_config_dict_behaves_as_the_cli_uses_it():
    cfg = ConfigDict({'a': {'b': 1}})
    cfg.c = {'d': 2}
    cfg.a.e = (1, 2)
    assert isinstance(cfg.c, ConfigDict) and cfg.c.d == 2
    assert 'a' in cfg and 'z' not in cfg and cfg.get('z', 3) == 3
    assert cfg.to_dict() == {'a': {'b': 1, 'e': (1, 2)}, 'c': {'d': 2}}
    assert type(cfg.to_dict()['a']) is dict
    with pytest.raises(AttributeError):
        cfg.z
