"""Nothing under h100_bench/ imports JAX, its libraries or the JAX
package (by whole top-level name: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""
import ast

import pytest

from conftest import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'red_diffeq_tpu'}
FILES = sorted((ROOT / 'h100_bench').rglob('*.py'))


def top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize('path', sorted(
    (ROOT / 'h100_bench' / 'reference').rglob('*.py')),
    ids=lambda p: p.name)
def test_reference_is_independent(path):
    names = top_names(path)
    assert 'red_diffeq_tpu_torch' not in names
    assert names <= {'math', 'contextlib', 'numpy', 'torch', 'h100_bench'}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                'h100_bench'):
            assert node.module.startswith('h100_bench.reference')


def test_the_prefix_rule():
    """A name that begins with a forbidden one is not forbidden."""
    assert not {'red_diffeq_tpu_torch', 'jaxtyping'} & FORBIDDEN
