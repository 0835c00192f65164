"""``InversionEngine.optimize``'s options beyond the step: the log interval,
checkpoint/resume, the trace, and the JAX engine's argument checks.

A 16x16 model at nbc=60, nt=20 on the plain path and a dim-8 U-Net on the
18x18 padded grid, on the CPU. A run resumed from its snapshot must repeat
the uninterrupted run bit for bit: the final model and every step's
metrics.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.core.inversion import InversionEngine as JaxEngine
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.core import inversion
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
from red_diffeq_tpu_torch.utils import data_trans as tdt
from red_diffeq_tpu_torch.utils import profiling

CTX = dict(n_grid=16, nt=20, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
           gz=10, ng=16, ns=2)
KEYS = ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The tiny shapes run fastest on one thread, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def problem():
    rng = np.random.RandomState(7)
    v_true = np.full((2, 1, 16, 16), 2000.0, np.float32)
    v_true[:, :, 9:] = 3200.0
    v_true += rng.uniform(-50, 50, v_true.shape).astype(np.float32)
    init = np.concatenate([tdt.prepare_initial_model(v_true[i:i + 1],
                                                     'smoothed', sigma=3.0)
                           for i in range(2)])
    mu0 = np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1)))
    op = FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                    s_norm_func=tdt.s_normalize_none, device='cpu')
    with torch.no_grad():
        y = op(tdt.v_normalize(torch.from_numpy(v_true)))
    torch.manual_seed(0)
    diff = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=18,
                             timesteps=20, device='cpu')
    return dict(v_true=v_true, mu0=mu0, y=y, op=op, diff=diff)


def _run(p, engine=None, op=None, **kw):
    engine = engine or inversion.InversionEngine(
        p['diff'], regularization='diffusion', device='cpu')
    args = dict(ts=6, lr=0.03, reg_lambda=0.75, noise_std=0.05,
                missing_number=3, progress=False,
                generator=torch.Generator().manual_seed(8888))
    args.update(kw)
    return engine.optimize(p['mu0'], p['v_true'], p['y'], op or p['op'],
                           **args)


def test_log_interval_picks_the_printed_steps(problem, capsys):
    _run(problem, ts=5, progress=True, log_interval=2)
    out = capsys.readouterr().out.splitlines()
    steps = [int(line.split()[1].split('/')[0]) for line in out
             if line.startswith('step')]
    assert steps == [0, 2, 4]
    assert out[-1].startswith('timing: 4 steps')


class Interrupted(Exception):
    pass


def test_resume_repeats_the_uninterrupted_run_bit_for_bit(problem, tmp_path):
    """Six steps with a snapshot every 3, cut in step 4 (its forward
    raises); a fresh engine resumes from step 3 with a generator in the
    first run's initial state (the observation noise and the missing
    traces draw from it first). Both runs' final models and all six
    steps' metrics equal the uninterrupted run's."""
    want_mu, want = _run(problem)
    path = tmp_path / 'ckpt' / 'state.pt'
    calls = []

    def cut(v):
        calls.append(1)
        if len(calls) == 4:
            raise Interrupted
        return problem['op'](v)

    with pytest.raises(Interrupted):
        _run(problem, op=cut, checkpoint_path=str(path), checkpoint_every=3)
    assert torch.load(path, weights_only=True)['step'] == 3
    for _ in range(2):
        # The second pass resumes from the finished run's last snapshot.
        got_mu, got = _run(problem, checkpoint_path=str(path),
                           checkpoint_every=3, resume=True)
        assert torch.equal(got_mu, want_mu)
        for g, w in zip(got, want):
            for k in KEYS:
                np.testing.assert_array_equal(np.array(g[k]), np.array(w[k]))
        assert torch.load(path, weights_only=True)['step'] == 6


def test_resume_without_a_file_starts_from_the_first_step(problem, tmp_path):
    want_mu, _ = _run(problem, ts=2)
    got_mu, got = _run(problem, ts=2, resume=True,
                       checkpoint_path=str(tmp_path / 'none.pt'))
    assert torch.equal(got_mu, want_mu) and len(got[0]['mae']) == 2


CHECKS = [dict(checkpoint_path='x.pt', use_scan=False),
          dict(segment_steps=2, use_scan=False),
          dict(segment_steps=2, checkpoint_path='x.pt')]


@pytest.mark.parametrize('kw', CHECKS, ids=['ckpt_no_scan', 'seg_no_scan',
                                            'seg_and_ckpt'])
def test_argument_checks_raise_as_in_jax(problem, kw):
    p = problem
    jop = JaxFWI(CTX, v_denorm_func=jdt.v_denormalize, backend='xla')
    with pytest.raises(ValueError) as want:
        JaxEngine().optimize(jnp.asarray(p['mu0']), jnp.asarray(p['v_true']),
                             jnp.asarray(p['y'].numpy()), jop, ts=2, **kw)
    with pytest.raises(ValueError) as got:
        _run(p, inversion.InversionEngine(device='cpu'), ts=2, **kw)
    assert str(got.value) == str(want.value)


def test_a_mesh_is_not_ported(problem):
    """A mesh is ported now (``tests/test_torch_parallel.py``); what is not
    a mesh of :func:`make_mesh` is refused, and so is a mesh of another
    device type than the engine's."""
    from red_diffeq_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(TypeError, match='make_mesh'):
        _run(problem, ts=1, mesh=object())
    with pytest.raises(ValueError, match='the mesh lies on meta'):
        _run(problem, ts=1, mesh=make_mesh(1, 1, ['meta']))


def test_profile_dir_writes_a_chrome_trace(problem, tmp_path, monkeypatch):
    _run(problem, ts=2, profile_dir=str(tmp_path / 'trace'))
    files = list((tmp_path / 'trace').glob('*.pt.trace.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    steps = [e for e in events if e.get('name') == 'inversion_step']
    unet = [e for e in events if e.get('name') == 'unet']
    assert len(steps) == 2 and len(unet) == 2

    def refuse(*a, **kw):
        raise AssertionError('traced without a profile_dir')

    monkeypatch.setattr(torch.profiler, 'profile', refuse)
    _run(problem, ts=1, profile_dir=None)
    with profiling.trace(None):
        pass
