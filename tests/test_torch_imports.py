"""The port stands alone and runs on the card unless asked for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'flax', 'optax', 'msgpack', 'yaml', 'ml_collections',
             'red_diffeq_tpu')
SOURCES = sorted((REPO / 'red_diffeq_tpu_torch').rglob('*.py')) + [
    REPO / 'chip_smoke.py']


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', None))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        assert name.split('.')[0] not in FORBIDDEN, f'{path.name}: {name}'


def test_import_walk_sees_every_form():
    src = ('import jax\nfrom flax import linen\nimport a.b as c\n'
           'importlib.import_module("red_diffeq_tpu.x")\n')
    assert list(_imported(ast.parse(src))) == [
        'jax', 'flax', 'a.b', 'red_diffeq_tpu.x']


def test_entry_points_raise_without_cuda_unless_given_cpu(monkeypatch):
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    ctx = dict(n_grid=8, nt=10, dx=10.0, dt=0.001, nbc=4, f=15.0, sz=10,
               gz=10, ng=8, ns=1)
    makers = {
        'FWIForward': lambda **d: FWIForward(ctx, **d),
        'GaussianDiffusion': lambda **d: GaussianDiffusion(
            Unet(dim=8, dim_mults=(1, 2)), image_size=8, **d),
        'InversionEngine': lambda **d: InversionEngine(**d),
    }
    for name, make in makers.items():
        for kw in ({}, {'device': 'cuda'}):
            with pytest.raises(RuntimeError, match='CUDA'):
                make(**kw)
        assert make(device='cpu').device.type == 'cpu', name
    op = FWIForward(ctx, device='cpu')
    assert op.backend == 'plain'
    with pytest.raises(ValueError, match='expected cpu'):
        op(torch.zeros(1, 1, 8, 8, device='meta'))


def test_kernel_wrappers_use_plain_versions_only_on_cpu():
    from red_diffeq_tpu_torch.ops import stencil
    z = torch.zeros(1, 1, 8, 8, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.fwd_chunk(z, z, z, z, z, z, z, isz=1, igz=1, g0=0, ng=2)
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.bwd_reverse_chunk(z, z, z, z, z, z, z, z, z, z, isz=1,
                                  igz=1, g0=0, ng=2)
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.tape_chunk(z, z, z, z, z, z, z, isz=1)
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.bwd_tape_chunk(z, z, z, z, z, z, z, z, isz=1, igz=1, g0=0,
                               ng=2)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from red_diffeq_tpu_torch.ops import stencil
    monkeypatch.setattr(stencil.shutil, 'which', lambda name: None)
    monkeypatch.setattr(stencil, '_DEFAULT_NVCC', str(tmp_path / 'nvcc'))
    monkeypatch.setattr(stencil, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        stencil.build()
    assert not (tmp_path / 'build').exists()
