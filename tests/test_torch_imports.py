"""The port stands alone and runs on the card unless asked for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'flax', 'optax', 'msgpack', 'yaml', 'ml_collections',
             'red_diffeq_tpu', 'convert_torch_checkpoint')
SOURCES = sorted((REPO / 'red_diffeq_tpu_torch').rglob('*.py')) + [
    REPO / 'chip_smoke.py', REPO / 'tools' / 'export_ema_torch.py',
    REPO / 'tools' / 'torch_layout_probe.py',
    REPO / 'tools' / 'torch_probe_breakdown.py',
    REPO / 'tools' / 'torch_bf16_breakdown.py',
    REPO / 'tools' / 'torch_convert_checkpoint.py'] + [
    REPO / 'tools' / f'torch_{name}.py' for name in (
        'quality', 'eval_quality', 'compare_methods', 'milestone_eval',
        'lambda_sweep', 'pick_best_milestone', 'quality_seeds',
        'red_parity')] + [
    REPO / 'examples' / f'torch_example_{name}.py'
    for name in ('openfwi', 'marmousi')]
# The quality slice's tools and examples, which the walk above must reach.
QUALITY_SLICE = ('tools/torch_eval_quality.py',
                 'tools/torch_compare_methods.py',
                 'tools/torch_milestone_eval.py',
                 'tools/torch_lambda_sweep.py',
                 'tools/torch_pick_best_milestone.py',
                 'examples/torch_example_openfwi.py',
                 'examples/torch_example_marmousi.py')
# The mesh slice's modules and the converter, which the walk above must
# reach (the converter must not lean on the JAX tool either).
MESH_SLICE = ('red_diffeq_tpu_torch/parallel/__init__.py',
              'red_diffeq_tpu_torch/parallel/mesh.py',
              'red_diffeq_tpu_torch/io/native_loader.py',
              'tools/torch_convert_checkpoint.py')
# The training slice's modules, which the walk above must reach.
TRAINING_SLICE = ('red_diffeq_tpu_torch/models/trainer.py',
                  'red_diffeq_tpu_torch/cli/datagen.py',
                  'red_diffeq_tpu_torch/cli/diffusion_train.py',
                  'tools/export_ema_torch.py')


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


def test_training_slice_is_walked():
    walked = {str(p.relative_to(REPO)) for p in SOURCES}
    assert set(TRAINING_SLICE) <= walked


def test_mesh_slice_is_walked():
    walked = {str(p.relative_to(REPO)) for p in SOURCES}
    assert set(MESH_SLICE) <= walked


def test_quality_slice_is_walked():
    walked = {str(p.relative_to(REPO)) for p in SOURCES}
    assert set(QUALITY_SLICE) <= walked


def test_import_walk_sees_every_form():
    src = ('import jax\nfrom flax import linen\nimport a.b as c\n'
           'importlib.import_module("red_diffeq_tpu.x")\n')
    assert list(_imported(ast.parse(src))) == [
        'jax', 'flax', 'a.b', 'red_diffeq_tpu.x']


def test_entry_points_raise_without_cuda_unless_given_cpu(monkeypatch):
    from red_diffeq_tpu_torch.bench_methods import (
        DiffusionFWI, ILVR_FWI, Resizer,
    )
    from red_diffeq_tpu_torch.cli import run_bench
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
        'DiffusionFWI': lambda **d: DiffusionFWI(None, None, **d),
        'ILVR_FWI': lambda **d: ILVR_FWI(None, None, **d),
        'Resizer': lambda **d: Resizer((1, 1, 8, 8), 0.5, **d),
    }
    for name, make in makers.items():
        for kw in ({}, {'device': 'cuda'}):
            with pytest.raises(RuntimeError, match='CUDA'):
                make(**kw)
        assert make(device='cpu').device.type == 'cpu', name
    from red_diffeq_tpu_torch.cli import datagen, diffusion_train
    for argv in ([], ['--device', 'cuda']):
        with pytest.raises(RuntimeError, match='CUDA'):
            run_bench.main(argv)
        with pytest.raises(RuntimeError, match='CUDA'):
            diffusion_train.main(argv)
        with pytest.raises(RuntimeError, match='CUDA'):
            datagen.main(['--out', 'unused', '--n', '1', *argv])
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
        stencil.bwd_reverse_steps(z, z, z, z, z, z, z, z, z, z, isz=1,
                                  igz=1, g0=0, ng=2)
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.tape_chunk(z, z, z, z, z, z, z, isz=1)
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.bwd_tape_chunk(z, z, z, z, z, z, z, z, isz=1, igz=1, g0=0,
                               ng=2)
    with pytest.raises(ValueError, match='unsupported device'):
        stencil.sum_shots(z, z, z)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from red_diffeq_tpu_torch.ops import stencil
    monkeypatch.setattr(stencil.shutil, 'which', lambda name: None)
    monkeypatch.setattr(stencil, '_DEFAULT_NVCC', str(tmp_path / 'nvcc'))
    monkeypatch.setattr(stencil, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        stencil.build()
    assert not (tmp_path / 'build').exists()
