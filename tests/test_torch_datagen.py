"""``red-diffeq-torch-datagen`` against ``red-diffeq-datagen`` on a tiny
grid (2 models a family, 16x16, nt=100, 2 shots): the same velocity files,
and seismograms within max-rel 2e-5, the solver parity tests' tolerance on
whole fields (``test_torch_solver.py``: elementwise rtol fails near the
traces' zero crossings, where XLA's CPU fusion rounds differently; over
100 steps a few such samples differ by 1e-5 of a trace's peak)."""
import numpy as np
import pytest
import torch

from red_diffeq_tpu.cli import datagen as jax_datagen
from red_diffeq_tpu_torch.cli import datagen

FAMILIES = ['FlatVel', 'CurveFault']
TINY = ['--n', '2', '--height', '16', '--width', '16', '--nt', '100', '--ns',
        '2', '--nbc', '8', '--families', *FAMILIES]


def test_datagen_matches_the_jax_tool(tmp_path):
    """The port simulates one model at a time (``--sim_batch 1``), the JAX
    tool both at once: the pieces concatenate to the same seismograms."""
    jax_datagen.main(['--out', str(tmp_path / 'jax'), *TINY])
    root = datagen.main(['--out', str(tmp_path / 'port'), *TINY,
                         '--sim_batch', '1', '--device', 'cpu'])
    assert root == tmp_path / 'port'
    for fam in FAMILIES:
        vel = np.load(root / 'Velocity_Data' / f'{fam}.npy')
        np.testing.assert_array_equal(
            vel, np.load(tmp_path / 'jax' / 'Velocity_Data' / f'{fam}.npy'))
        assert vel.shape == (2, 1, 16, 16) and vel.dtype == np.float32
        seis = np.load(root / 'Seismic_Data' / f'{fam}.npy')
        want = np.load(tmp_path / 'jax' / 'Seismic_Data' / f'{fam}.npy')
        assert seis.shape == want.shape == (2, 2, 100, 16)
        assert seis.dtype == np.float32 and np.abs(want).max() > 0
        rel = np.abs(seis - want).max() / np.abs(want).max()
        assert rel < 2e-5, (fam, rel)


def test_velocity_only_writes_no_seismograms(tmp_path):
    datagen.main(['--out', str(tmp_path / 'ds'), '--n', '3', '--families',
                  'CurveVel', '--velocity_only', '--device', 'cpu'])
    vel = np.load(tmp_path / 'ds' / 'Velocity_Data' / 'CurveVel.npy')
    assert vel.shape == (3, 1, 70, 70)
    assert not (tmp_path / 'ds' / 'Seismic_Data').exists()


def test_simulation_raises_without_a_card_unless_given_cpu(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for extra in ([], ['--device', 'cuda'], ['--velocity_only']):
        with pytest.raises(RuntimeError, match='CUDA'):
            datagen.main(['--out', str(tmp_path / 'x'), *TINY, *extra])
    assert not (tmp_path / 'x').exists()
