"""Shared pieces of the benchmark's tests: the ``card`` marker (tests that
need an NVIDIA card; each decides inside itself and skips without one)
and a cell cut to a size the CPU runs in seconds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs an NVIDIA card')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)


def tiny(workload):
    """The cell ``workload`` as BENCHMARK.json has it, at a size the CPU
    runs: a 14-cell-deep model (14 or 30 wide), nbc 8, nt 60, 2 shots, a
    dim-8 U-Net at 16x16, batch 2 (16 for training), 300 steps a job;
    training's window is 100 steps, so that the EMA's next update after
    it blends (the warm-up decay is 0 through step 101)."""
    from h100_bench.lib import harness
    cell = harness.load_cell(workload)
    cfg = cell['config']
    wide = cfg['pde']['n_grid'] > cfg['model_rows']
    cfg['pde'].update(n_grid=30 if wide else 14, nt=60, nbc=8, ns=2)
    cfg['pde']['ng'] = cfg['pde']['n_grid']
    cfg['model_rows'] = 14
    cfg['model']['dim'] = 8
    cfg['diffusion']['image_size'] = 16
    cfg['data']['batch_size'] = min(cfg['data']['batch_size'], 2)
    if 'training' in cfg:
        cfg['training']['batch_size'] = 16
    cell['traffic'].update(pool=1, images=64, steps_per_train=100,
                           check_jobs=1)
    return cell
