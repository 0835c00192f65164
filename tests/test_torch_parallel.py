"""The port's device mesh on the CPU, against the JAX package.

The mesh runs over a device list that repeats the CPU (``['cpu'] * 8``),
as it runs over one card repeated. The sharded inversion on the kernel
backend (its plain versions here) is held to the JAX engine's *unsharded*
run (``tests/test_parallel.py`` holds the JAX sharded run to its
unsharded one): rtol 1e-5 / atol 1e-6 on the model, atol 1e-5 on MAE, the
JAX test's tolerances; and to the port's unsharded run bit for bit (the
sharded RED steps are in ``tests/test_torch_inversion.py``, beside the
JAX steps they are held to). The solver with its shots split over shot
shards gives the unsharded seismogram and gradient bit for bit on the
kernel backend, on both adjoint routes, and within rounding on the plain
one. A sharded run resumed from its snapshot repeats the
uninterrupted run bit for bit. The trainer's data-parallel step over
``['cpu'] * 4`` against one device: losses rtol 2e-5, the JAX test's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.core.inversion import InversionEngine as JaxEngine
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.core import inversion
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.trainer import TensorDataset, Trainer
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.parallel.mesh import (
    P, NamedSharding, batch_sharding, batch_shot_sharding, device_put,
    make_mesh, replicated, shard_inversion_inputs,
)
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward, shot_shards
from red_diffeq_tpu_torch.utils import data_trans as tdt
from test_torch_inversion import KEYS

CPU8 = ['cpu'] * 8
# tests/test_parallel.py's problem.
N, NT, NS, NBC = 16, 40, 2, 8
CTX = dict(n_grid=N, nt=NT, dx=10.0, dt=0.001, nbc=NBC, f=15.0, sz=10,
           gz=10, ng=N, ns=NS)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The tiny shapes run fastest on one thread, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_make_mesh_shapes():
    mesh = make_mesh(data=4, shot=2, devices=CPU8)
    assert mesh.shape == {'data': 4, 'shot': 2}
    assert make_mesh(data=-1, shot=2, devices=CPU8).shape == \
        {'data': 4, 'shot': 2}
    with pytest.raises(AssertionError):
        make_mesh(data=8, shot=2, devices=CPU8)
    with pytest.raises(AssertionError):
        make_mesh(data=-1, shot=3, devices=CPU8)
    assert make_mesh(data=2, shot=1, devices=CPU8).shape == \
        {'data': 2, 'shot': 1}


def test_shard_inversion_inputs_placement():
    mesh = make_mesh(data=4, shot=2, devices=CPU8)
    mu = torch.arange(4 * 64, dtype=torch.float32).reshape(4, 1, 8, 8)
    mu_true = mu + 1
    y = torch.arange(4 * 2 * 16 * 8, dtype=torch.float32).reshape(4, 2, 16, 8)
    mu_s, mt_s, y_s = shard_inversion_inputs(mesh, mu, mu_true, y)
    assert mu_s.sharding == batch_sharding(mesh)
    assert mu_s.sharding == NamedSharding(make_mesh(4, 2, CPU8), P('data'))
    assert y_s.sharding == batch_shot_sharding(mesh)
    assert y_s.sharding != mu_s.sharding
    assert {s.data.shape for s in y_s.addressable_shards} == {(1, 1, 16, 8)}
    assert {s.data.shape for s in mu_s.addressable_shards} == {(1, 1, 8, 8)}
    assert torch.equal(y_s.block(2, 1), y[2:3, 1:2])
    for t, s in ((mu, mu_s), (mu_true, mt_s), (y, y_s)):
        assert torch.equal(s.gather(), t)
    # Each device holds a copy of its own, also of a replicated block.
    r = device_put(mu, replicated(mesh))
    assert len({s.data.data_ptr() for s in r.addressable_shards}) == 8
    assert all(torch.equal(s.data, mu) for s in r.addressable_shards)


def test_a_mesh_axis_that_does_not_divide_raises():
    mesh = make_mesh(data=4, shot=2, devices=CPU8)
    with pytest.raises(ValueError, match='does not divide'):
        device_put(torch.zeros(6, 2, 3), batch_sharding(mesh))
    with pytest.raises(ValueError, match="mesh axis 'shot'"):
        device_put(torch.zeros(4, 3, 3), batch_shot_sharding(mesh))
    p = _problem()
    with pytest.raises(ValueError, match='does not divide'):
        _port(p, make_mesh(data=3, shot=1, devices=CPU8), ts=1)


def _problem():
    """tests/test_parallel.py's four models, observations and start."""
    op = JaxFWI(CTX, normalize=True, v_denorm_func=jdt.v_denormalize,
                s_norm_func=lambda s: s, backend='xla', chunk=10)
    v_true = np.full((4, 1, N, N), 2000.0, np.float32)
    for b in range(4):
        v_true[b, :, 6 + b:, :] = 2800.0
    y = np.array(op(jdt.v_normalize(jnp.asarray(v_true))))
    mu0 = np.array(jnp.pad(jdt.v_normalize(jnp.full((4, 1, N, N), 2400.0)),
                           ((0, 0), (0, 0), (1, 1), (1, 1))))
    return dict(op=op, v_true=v_true, y=y, mu0=mu0)


def _port(p, mesh, backend='kernel', **kw):
    op = FWIForward(CTX, normalize=True, v_denorm_func=tdt.v_denormalize,
                    s_norm_func=lambda s: s, backend=backend, chunk=10,
                    device='cpu')
    args = dict(ts=5, lr=0.05, progress=False,
                generator=torch.Generator().manual_seed(1), mesh=mesh)
    args.update(kw)
    return inversion.InversionEngine(regularization=None,
                                     device='cpu').optimize(
        torch.from_numpy(p['mu0']), torch.from_numpy(p['v_true']),
        torch.from_numpy(p['y']), op, **args)


@pytest.fixture(scope='module')
def jax_unsharded():
    p = _problem()
    mu, pm = JaxEngine(regularization=None).optimize(
        p['mu0'], p['v_true'], p['y'], p['op'], ts=5, lr=0.05,
        key=jax.random.PRNGKey(1), progress=False)
    return p, np.asarray(mu), pm


def test_sharded_engine_matches_the_unsharded_jax_run(jax_unsharded):
    p, want_mu, want = jax_unsharded
    mu, got = _port(p, make_mesh(data=4, shot=2, devices=CPU8))
    np.testing.assert_allclose(mu.numpy(), want_mu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0]['mae'], want[0]['mae'], atol=1e-5)
    # The port's own unsharded run: the model bit for bit, the loss of the
    # first step, before any update, to 1e-6 relative (each data shard
    # reduces its own rows).
    one_mu, one = _port(p, None)
    assert torch.equal(mu, one_mu)
    for g, w in zip(got, one):
        np.testing.assert_allclose(g['obs_losses'][0], w['obs_losses'][0],
                                   rtol=1e-6)


@pytest.mark.parametrize('nbc,route', [(8, 'tape'), (60, 'reverse')])
def test_shot_split_solver_is_the_unsharded_one(nbc, route):
    """The seismogram and the velocity gradient with the shots split over
    two shot shards: bit for bit on the kernel backend, whose data shard
    sums all shots' coefficient cotangents each chunk; within rounding on
    the plain backend, where autograd adds the shards' gradients."""
    from red_diffeq_tpu_torch.ops.stencil import resolve_run_config
    ctx = dict(CTX, nbc=nbc, nt=20)
    rng = np.random.RandomState(nbc)
    v = torch.from_numpy(rng.uniform(2000, 3000, (2, 1, N, N)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((2, NS, 20, N)).astype(
        np.float32))
    for backend in ('kernel', 'plain'):
        op = FWIForward(ctx, normalize=False, backend=backend, chunk=10,
                        device='cpu')
        assert resolve_run_config(op.geom, 10)[0] == route
        out = []
        for shard in (op, op.sharded(['cpu', 'cpu'])):
            s = shard(v)
            out.append((s.detach(),
                        torch.autograd.grad((s * w).sum(), v)[0]))
        for want, got in zip(*out):
            if backend == 'kernel':
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError, match='do not divide'):
        shot_shards(NS, ['cpu'] * 3)


class Interrupted(Exception):
    pass


def test_mesh_and_resume_repeat_the_uninterrupted_run_bit_for_bit(
        jax_unsharded, tmp_path, monkeypatch):
    """Five sharded steps with a snapshot every 2, cut right after the
    snapshot of step 2; a fresh run on the same mesh resumes there and
    repeats the uninterrupted run (model and every step's curves) bit for
    bit, as a second uninterrupted run does. The snapshot holds the
    gathered state: the unsharded engine resumes from it to the same
    model."""
    p = jax_unsharded[0]
    mesh = make_mesh(data=2, shot=2, devices=CPU8)
    want_mu, want = _port(p, mesh)
    again_mu, again = _port(p, mesh)
    assert torch.equal(again_mu, want_mu) and again == want
    path = tmp_path / 'state.pt'
    save = inversion._save_snapshot

    def cut(path, step, *args):
        save(path, step, *args)
        raise Interrupted

    monkeypatch.setattr(inversion, '_save_snapshot', cut)
    with pytest.raises(Interrupted):
        _port(p, mesh, checkpoint_path=str(path), checkpoint_every=2)
    monkeypatch.setattr(inversion, '_save_snapshot', save)
    snap = torch.load(path, weights_only=True)
    assert snap['step'] == 2 and snap['mu'].shape == (4, 1, N + 2, N + 2)
    got_mu, got = _port(p, mesh, checkpoint_path=str(path),
                        checkpoint_every=2, resume=True)
    assert torch.equal(got_mu, want_mu)
    for g, w in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(np.array(g[k]), np.array(w[k]))
    monkeypatch.setattr(inversion, '_save_snapshot', cut)
    with pytest.raises(Interrupted):
        _port(p, mesh, checkpoint_path=str(path), checkpoint_every=2)
    monkeypatch.setattr(inversion, '_save_snapshot', save)
    mu, _ = _port(p, None, checkpoint_path=str(path), checkpoint_every=2,
                  resume=True)
    assert torch.equal(mu, want_mu)


def _trainer(tmp_path, devices):
    torch.manual_seed(0)
    diff = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2), channels=1),
                             image_size=16, timesteps=20,
                             sampling_timesteps=5, objective='pred_noise',
                             device='cpu')
    data = np.random.RandomState(0).rand(64, 1, 16, 16).astype(np.float32)
    return Trainer(diff, TensorDataset(data), train_batch_size=16,
                   train_num_steps=6, save_and_sample_every=1000,
                   results_folder=str(tmp_path), seed=7, devices=devices)


def test_trainer_data_parallel_step_matches_one_device(tmp_path):
    """tests/test_parallel.py's trainer case in the port: six steps with
    each batch split over ['cpu'] * 4 (replicas of the U-Net, gradients
    added on the first device) against the unsplit steps."""
    losses = {}
    for devices in (None, ['cpu'] * 4):
        tr = _trainer(tmp_path / str(devices is None), devices)
        assert (tr.devices is None) is (devices is None)
        assert tr._device_data is (devices is None)
        tr.train(log_every=10000)
        losses[devices is None] = np.array(
            [e['loss'] for e in tr.training_losses])
    assert losses[True].shape == losses[False].shape == (6,)
    np.testing.assert_allclose(losses[False], losses[True], rtol=2e-5,
                               atol=1e-6)
