"""The configurations that ``chip_smoke.py``'s phase 'configurations' runs
on the card, checked on the CPU without a card: each bench preset exists,
takes the tape-free route and differs from the all-tricks preset only where
it says; ILVR's stepwise schedule at its outer steps blends with every one
of its four factors at least twice (so each blend graph is captured and
replayed); the trainer keyword sets reach the ``Trainer`` the train CLI
builds; the headline batches and the quality rows' JAX SSIMs are those
the phase claims."""
import importlib.util
from pathlib import Path

import pytest
import torch

from red_diffeq_tpu_torch.bench_methods.ilvr_fwi import ilvr_down_schedule
from red_diffeq_tpu_torch.config import load_config
from red_diffeq_tpu_torch.models import trainer as ttrainer
from red_diffeq_tpu_torch.ops import stencil
from red_diffeq_tpu_torch.solvers import acoustic

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke_configs',
                                                  REPO / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRICKS = ('grad_norm', 'grad_smooth', 'model_blur', 'grad_clip')


def _tricks(path):
    o = load_config(REPO / path).optimization
    return {k: o.get(k) for k in TRICKS}, (o.diffusion_ts, o.ts)


@pytest.mark.parametrize('index', range(7))
def test_each_bench_configuration_is_the_preset_it_names(smoke, index):
    c = smoke.CONFIG_BENCH[index]
    family, flags, method, dts, extra = c
    path = smoke.config_preset(c)
    assert (REPO / path).is_file()
    cfg = load_config(REPO / path)
    tricks, depth = _tricks(path)
    base, _ = _tricks(f'configs/ablation/{family}_Ablation/'
                      'ablation_all_tricks_dt30_ts10.yaml')
    want = dict(base)
    if not flags.startswith('all_tricks'):
        kept = flags.split('_dt')[0]
        want.update(grad_norm=kept == 'grad_norm',
                    grad_smooth=1.0 if kept == 'grad_smooth' else None,
                    model_blur=kept == 'model_blur')
    assert tricks == want
    assert depth == ((300, 1) if flags.endswith('dt300_ts1') else (30, 10))
    assert 2 < dts < depth[0] and method in ('diffusionfwi', 'ilvr')
    geom = acoustic.Geometry.from_ctx(cfg.pde.to_dict())
    assert stencil.resolve_run_config(geom, int(cfg.tpu.solver_chunk),
                                      None)[0] == 'reverse'
    if extra:
        assert method == 'ilvr' and extra == ('--ilvr_down_schedule',
                                              'stepwise')
        down = ilvr_down_schedule('stepwise', dts)
        blends = [int(down[t]) for t in range(1, dts)]
        assert sorted(set(blends)) == [4, 8, 16, 32]
        assert min(blends.count(f) for f in (4, 8, 16, 32)) >= 2


def test_the_bench_configurations_cover_every_flag_set(smoke):
    flags = {c[1].split('_dt')[0] for c in smoke.CONFIG_BENCH}
    assert flags == {'no_tricks', 'grad_norm', 'grad_smooth', 'model_blur',
                     'all_tricks'}
    assert any(c[1].endswith('dt300_ts1') for c in smoke.CONFIG_BENCH)
    assert {c[0] for c in smoke.CONFIG_BENCH} == {'OpenFWI', 'Marmousi'}
    assert all(c[1] != 'all_tricks_dt30_ts10' for c in smoke.CONFIG_BENCH
               if c[0] == 'Marmousi')


@pytest.mark.parametrize('index', range(2))
def test_each_trainer_keyword_set_reaches_the_trainer(smoke, index,
                                                      tmp_path):
    _, kw = smoke.CONFIG_TRAIN[index]
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    torch.manual_seed(0)
    d = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=8,
                          timesteps=4, device='cpu')
    data = ttrainer.TensorDataset(torch.rand(4, 1, 8, 8).numpy())
    tr = ttrainer.Trainer(d, data, train_batch_size=32,
                          results_folder=str(tmp_path), **kw)
    assert tr.grad_accum == kw.get('gradient_accumulate_every', 1)
    assert tr._device_data == kw.get('device_data', True)


def test_the_headline_batches_and_quality_rows(smoke):
    assert smoke.CONFIG_BATCHES == (8, 16)
    assert smoke.CONFIG_QUALITY == dict(n=2, width=190, sigma=20.0, ts=300)
    table = (REPO / 'QUALITY_marmousi.md').read_text()
    for reg, ssim in smoke.CONFIG_QUALITY_SSIM.items():
        assert f'| refined | {reg} |' in table
        row = [r for r in table.splitlines()
               if r.startswith(f'| refined | {reg} |')][0]
        assert float(row.split('|')[5]) == ssim
