"""Config objects and YAML files, without ``yaml`` or ``ml_collections``.

Counterpart of ``red_diffeq_tpu/config/config_utils.py``. :class:`ConfigDict`
is a dict whose keys are also attributes (``cfg.pde.nt``), with ``.get``,
``in``, :meth:`ConfigDict.to_dict` and nested assignment: what the inversion
CLI uses of ``ml_collections.ConfigDict``.

The YAML reader and writer cover the subset the repo's ``configs/`` files
use: block mappings nested by indentation, block sequences of scalars
(``- 1``), ``null``/``~``, booleans, decimal integers, floats, plain and
single-quoted strings, and whole-line comments. A scalar becomes the same
Python value as under ``yaml.safe_load`` (YAML 1.1: ``ts: 300`` is an int,
``dx: 10.0`` a float, ``1e-3`` a string, ``yes`` True). Anything else
(flow collections, anchors, tags, double quotes, block scalars, inline
comments, octal, hex and sexagesimal numbers, dates, duplicate keys)
raises ``ValueError`` naming the file and line; nothing is misread. The
writer quotes every string that would read back as another value.
"""
import math
import numbers
import re
import warnings
from pathlib import Path
from typing import Union

PathLike = Union[str, Path]

# The JAX package's solver backends, as this package's.
JAX_BACKENDS = {'xla': 'plain', 'pallas': 'kernel'}


class ConfigDict(dict):
    """A dict with attribute access; nested dicts become ConfigDicts."""

    def __init__(self, data=None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigDict) else v
                for k, v in self.items()}


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1.
_BOOL = {'yes': True, 'Yes': True, 'YES': True, 'true': True, 'True': True,
         'TRUE': True, 'on': True, 'On': True, 'ON': True,
         'no': False, 'No': False, 'NO': False, 'false': False,
         'False': False, 'FALSE': False, 'off': False, 'Off': False,
         'OFF': False}
_NULL = ('~', 'null', 'Null', 'NULL')
_DEC_INT = re.compile(r'[-+]?(?:0|[1-9][0-9_]*)$')
_OTHER_INT = re.compile(r'''[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$
    |[-+]?0x[0-9a-fA-F_]+$|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+$''', re.X)
_FLOAT = re.compile(r'''[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$''', re.X)
_SPECIAL_FLOAT = {'.inf': math.inf, '.Inf': math.inf, '.INF': math.inf,
                  '+.inf': math.inf, '+.Inf': math.inf, '+.INF': math.inf,
                  '-.inf': -math.inf, '-.Inf': -math.inf,
                  '-.INF': -math.inf, '.nan': math.nan, '.NaN': math.nan,
                  '.NAN': math.nan}
_OTHER_FLOAT = re.compile(r'[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$')
_DATE = re.compile(r'[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}')
_KEY = re.compile(r'[A-Za-z_][A-Za-z0-9_-]*$')
_INDICATORS = set('-?:,[]{}#&*!|>\'"%@`')


class _Unsupported(ValueError):
    pass


def _plain_scalar(text: str):
    """The value of a plain scalar, as ``yaml.safe_load`` resolves it;
    raises for a form outside the subset."""
    if '\t' in text or ': ' in text or text.endswith(':') or ' #' in text:
        raise _Unsupported(f'unsupported plain scalar {text!r}')
    if text[0] in _INDICATORS and not (text[0] == '-' and len(text) > 1
                                       and text[1] != ' '):
        raise _Unsupported(f'unsupported scalar {text!r}')
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _DEC_INT.match(text):
        return int(text.replace('_', ''))
    if _FLOAT.match(text):
        return float(text.replace('_', ''))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if (_OTHER_INT.match(text) or _OTHER_FLOAT.match(text)
            or _DATE.match(text) or text in ('<<', '=')):
        raise _Unsupported(f'unsupported scalar {text!r} (octal, hex, '
                           'binary, sexagesimal, date, merge or value)')
    return text


def _scalar(text: str):
    if text.startswith("'"):
        body = text[1:-1] if len(text) > 1 and text.endswith("'") else None
        if body is None or "'" in body.replace("''", ''):
            raise _Unsupported(f'unsupported quoted scalar {text}')
        return body.replace("''", "'")
    return _plain_scalar(text)


def _key(text: str) -> str:
    if not _KEY.match(text) or text in _BOOL or text in _NULL:
        raise _Unsupported(f'unsupported key {text!r}')
    return text


def parse_yaml(text: str, name: str = '<string>'):
    """Read ``text`` (the subset in the module docstring): a mapping, or
    None for a file with no content."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip()
        stripped = body.lstrip(' ')
        if not stripped or stripped.startswith('#'):
            continue
        if stripped[0] == '\t' or '\t' in body[:len(body) - len(stripped)]:
            raise ValueError(f'{name}:{n}: tab in indentation')
        lines.append((len(body) - len(stripped), stripped, n))
    if not lines:
        return None
    if lines[0][0] != 0:
        raise ValueError(f'{name}:{lines[0][2]}: the document must be a '
                         'mapping at column 0')

    def where(i):
        return f'{name}:{lines[i][2]}' if i < len(lines) else name

    def sequence(i, indent):
        items = []
        while i < len(lines) and lines[i][0] == indent \
                and lines[i][1].startswith('-'):
            text = lines[i][1]
            if not text.startswith('- '):
                raise ValueError(f'{where(i)}: unsupported sequence entry '
                                 f'{text!r}')
            try:
                items.append(_scalar(text[2:].strip()))
            except _Unsupported as e:
                raise ValueError(f'{where(i)}: {e}') from None
            i += 1
        return items, i

    def mapping(i, indent):
        out = {}
        while i < len(lines):
            ind, text, _ = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f'{where(i)}: unexpected indentation')
            key, sep, rest = text.partition(':')
            if not sep or (rest and not rest.startswith(' ')):
                raise ValueError(f'{where(i)}: expected "key: value", got '
                                 f'{text!r}')
            try:
                key = _key(key)
                if key in out:
                    raise _Unsupported(f'duplicate key {key!r}')
                rest = rest.strip()
                value = _scalar(rest) if rest else None
            except _Unsupported as e:
                raise ValueError(f'{where(i)}: {e}') from None
            i += 1
            if not rest and i < len(lines):
                ind2, text2, _ = lines[i]
                if ind2 >= indent and text2.startswith('-'):
                    value, i = sequence(i, ind2)
                elif ind2 > indent:
                    value, i = mapping(i, ind2)
            out[key] = value
        return out, i

    out, i = mapping(0, 0)
    if i < len(lines):
        raise ValueError(f'{where(i)}: unexpected line')
    return out


def _float_text(x: float) -> str:
    if math.isnan(x):
        return '.nan'
    if math.isinf(x):
        return '.inf' if x > 0 else '-.inf'
    text = repr(float(x))
    mant, e, exp = text.partition('e')
    if e and '.' not in mant:
        text = f'{mant}.0e{exp}'
    return text


def _scalar_text(value, key) -> str:
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, numbers.Real):
        return _float_text(float(value))
    if isinstance(value, str):
        if any(c in value for c in '\n\r\t') or not value.isprintable():
            raise ValueError(f'{key}: cannot write {value!r}')
        try:
            plain = value == value.strip() and value != '' \
                and _plain_scalar(value) == value
        except _Unsupported:
            plain = False
        return value if plain else "'" + value.replace("'", "''") + "'"
    raise TypeError(f'{key}: cannot write a {type(value).__name__} to YAML')


def dump_yaml(data: dict) -> str:
    """Write a nested dict as block YAML that :func:`parse_yaml` and
    ``yaml.safe_load`` both read back to ``data`` (tuples come back as
    lists)."""
    lines = []

    def emit(mapping, indent):
        pad = ' ' * indent
        for k, v in mapping.items():
            key = _key(str(k))
            if isinstance(v, (dict, list, tuple)) and not v:
                raise TypeError(f'{key}: an empty collection is outside the '
                                'YAML subset')
            if isinstance(v, dict):
                lines.append(f'{pad}{key}:')
                emit(v, indent + 2)
            elif isinstance(v, (list, tuple)):
                lines.append(f'{pad}{key}:')
                for item in v:
                    if isinstance(item, (dict, list, tuple)):
                        raise TypeError(f'{key}: nested collections in a '
                                        'sequence are not supported')
                    lines.append(f'{pad}- {_scalar_text(item, key)}')
            else:
                lines.append(f'{pad}{key}: {_scalar_text(v, key)}')

    emit(data, 0)
    return '\n'.join(lines) + '\n'


def load_config(config_path: PathLike) -> ConfigDict:
    """Read a YAML file into a ConfigDict (a missing file raises). A
    ``tpu.solver_backend`` of the JAX package ('xla', 'pallas') becomes
    this package's ('plain', 'kernel')."""
    path = Path(config_path)
    if not path.is_file():
        raise FileNotFoundError(f'no such config file: {path}')
    config = ConfigDict(parse_yaml(path.read_text(), str(path)) or {})
    tpu = config.get('tpu')
    if isinstance(tpu, dict) and tpu.get('solver_backend') in JAX_BACKENDS:
        tpu.solver_backend = JAX_BACKENDS[tpu.solver_backend]
    return config


def save_config(config: ConfigDict, output_path: PathLike) -> None:
    """Snapshot a ConfigDict as YAML, creating parent directories."""
    path = Path(output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dump_yaml(config.to_dict()))


def update_config(config: ConfigDict, **kwargs) -> ConfigDict:
    """Apply flat key=value overrides in place; unknown keys are added
    with a warning rather than rejected."""
    for key, value in kwargs.items():
        if not hasattr(config, key):
            warnings.warn(f'config has no field {key!r}; adding it',
                          stacklevel=2)
        setattr(config, key, value)
    return config


def print_config(config: ConfigDict, prefix: str = '') -> None:
    """Render the config tree to stdout, one indented key per line."""
    top_level = not prefix
    if top_level:
        bar = '-' * 60
        print(f'{bar}\nconfig\n{bar}')
    for key in sorted(config.keys()):
        value = config[key]
        if isinstance(value, ConfigDict):
            print(f'{prefix}{key}:')
            print_config(value, prefix=prefix + '  ')
        else:
            print(f'{prefix}{key}: {value}')
    if top_level:
        print('-' * 60)
