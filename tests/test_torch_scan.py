"""The whole-loop dispatch (``use_scan``, ``segment_steps``) on the CPU.

On the card ``InversionEngine.optimize(use_scan=True)`` replays a CUDA graph
of :meth:`StepBuffers.body` (``core/graphs.py``); on the CPU the same loop
calls the body directly. These tests hold that loop to the eager one: the
body run ``ts`` times equals the eager loop bit for bit (the model, every
curve, Adam's state) for every regulariser, RED patched and unpatched;
``use_scan`` True and False give equal runs, a mesh's too; the draws made
before the loop equal the eager step's; segments and a resumed run equal
the uninterrupted one; the graph key changes with each of its parts and
with a ``GaussianDiffusion.params`` assignment; and the port's scanned run
matches the JAX engine's scanned run at ``tests/test_torch_engine_extras.py``'s
problem, within ``tests/test_torch_inversion.py``'s tolerances (mu atol
1e-5, curves rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.core.inversion import InversionEngine as JaxEngine
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.core import graphs, inversion
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.parallel.mesh import make_mesh
from red_diffeq_tpu_torch.regularization.base import make_reg_fn
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
from red_diffeq_tpu_torch.utils import data_trans as tdt

CTX = dict(n_grid=16, nt=20, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
           gz=10, ng=16, ns=2)
# 16 rows by 40 columns: wider than the 18x18 denoiser, so RED is patched.
WIDE = dict(CTX, n_grid=40, ng=40)
KEYS = graphs.METRICS
TS = 5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(ctx, rows=16):
    cols = ctx['n_grid']
    rng = np.random.RandomState(7)
    v_true = np.full((2, 1, rows, cols), 2000.0, np.float32)
    v_true[:, :, rows // 2:] = 3200.0
    v_true += rng.uniform(-50, 50, v_true.shape).astype(np.float32)
    init = np.concatenate([tdt.prepare_initial_model(v_true[i:i + 1],
                                                     'smoothed', sigma=3.0)
                           for i in range(2)])
    mu0 = np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1)))
    op = FWIForward(ctx, v_denorm_func=tdt.v_denormalize,
                    s_norm_func=tdt.s_normalize_none, device='cpu')
    with torch.no_grad():
        y = op(tdt.v_normalize(torch.from_numpy(v_true)))
    return dict(v_true=v_true, mu0=mu0, y=y, op=op)


@pytest.fixture(scope='module')
def diff():
    torch.manual_seed(0)
    return GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=18,
                             timesteps=20, device='cpu')


@pytest.fixture(scope='module')
def problem():
    return _problem(CTX)


@pytest.fixture(scope='module')
def wide():
    return _problem(WIDE)


def _run(p, diff, reg='diffusion', **kw):
    engine = inversion.InversionEngine(diff, regularization=reg,
                                       device='cpu')
    args = dict(ts=TS, lr=0.03, reg_lambda=0.75, noise_std=0.05,
                missing_number=3, progress=False,
                generator=torch.Generator().manual_seed(8888))
    args.update(kw)
    return engine.optimize(p['mu0'], p['v_true'], p['y'], p['op'], **args)


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        for k in KEYS:
            np.testing.assert_array_equal(np.array(x[k]), np.array(y[k]),
                                          err_msg=k)


def _inputs(p, gen):
    """The engine's inputs after its corruption, drawn from ``gen``."""
    mu = torch.from_numpy(p['mu0'])
    y = tdt.add_noise_to_seismic(p['y'], 0.05, generator=gen)
    y, mask = tdt.missing_trace(y, 3, generator=gen)
    return mu, y, mask, tdt.v_normalize(torch.from_numpy(p['v_true']))


@pytest.mark.parametrize('reg,data', [('diffusion', 'problem'),
                                      ('diffusion', 'wide'), ('tv', 'problem'),
                                      ('l2', 'problem'), (None, 'problem')],
                         ids=['red', 'red_patched', 'tv', 'l2', 'none'])
def test_step_body_repeats_the_eager_loop(request, diff, reg, data):
    """:meth:`StepBuffers.body` run ``TS`` times against the eager step
    run ``TS`` times, both from one generator state: the model, every
    metric of every step, Adam's moments and count, bit for bit."""
    p = request.getfixturevalue(data)
    engine = inversion.InversionEngine(diff, regularization=reg,
                                       device='cpu')
    is_diffusion = reg == 'diffusion'
    reg_fn = make_reg_fn(reg, diff)
    optimizer = inversion.Adam(inversion.cosine_decay_schedule(0.03, TS))
    runs = []
    for scan in (False, True):
        gen = torch.Generator().manual_seed(8888)
        mu, y, mask, target = _inputs(p, gen)
        if scan:
            bufs = engine._scan_buffers(None, p['op'], reg_fn, optimizer,
                                        0.75, is_diffusion, mu.shape, TS, y,
                                        mask, target)
            state = optimizer.init(mu)
            bufs.load_state([mu], [state['mu']], [state['nu']], 0)
            bufs.fill_draws(lambda: inversion._step_draws(
                reg_fn, is_diffusion, mu.shape, gen, mu.device),
                range(TS), gen)
            for _ in range(TS):
                bufs.body()
            runs.append((bufs.mus[0], bufs.ms[0], bufs.vs[0],
                         int(bufs.count),
                         {k: h for k, h in bufs.history.items()}))
            continue
        step = inversion.make_inversion_step(p['op'], reg_fn, optimizer,
                                             0.75, 1e-4, is_diffusion)
        state = optimizer.init(mu)
        hist = []
        for _ in range(TS):
            mu, state, m = step(mu, state, y=y, mask=mask,
                                mu_true_norm=target, generator=gen)
            hist.append(m)
        runs.append((mu, state['mu'], state['nu'], int(state['count']),
                     {k: torch.stack([h[k] for h in hist]) for k in hist[0]}))
    (mu_a, m_a, v_a, c_a, h_a), (mu_b, m_b, v_b, c_b, h_b) = runs
    assert c_a == c_b == TS
    for a, b in ((mu_a, mu_b), (m_a, m_b), (v_a, v_b)):
        assert torch.equal(a, b)
    assert set(h_a) == set(h_b) == set(KEYS) | ({'t'} if is_diffusion
                                                 else set())
    for k in h_a:
        assert torch.equal(h_a[k], h_b[k]), k


@pytest.mark.parametrize('reg', ['diffusion', 'tv'])
def test_scan_and_eager_give_one_run(problem, diff, reg, capsys):
    _assert_same(_run(problem, diff, reg, use_scan=False),
                 _run(problem, diff, reg, use_scan=True))


def test_scan_and_eager_give_one_run_over_a_mesh(problem, diff):
    """A (2 x 2) mesh of the CPU repeated, on the kernel backend (its
    plain versions here): scanned and eager."""
    p = dict(problem, op=FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                                    s_norm_func=tdt.s_normalize_none,
                                    backend='kernel', device='cpu'))
    mesh = make_mesh(data=2, shot=2, devices=['cpu'] * 4)
    eager = _run(p, diff, mesh=mesh, use_scan=False)
    _assert_same(eager, _run(p, diff, mesh=mesh, use_scan=True))


def test_draws_before_the_loop_equal_the_eager_draws(problem, diff):
    """Every step's draws made before the loop, in the step's order, equal
    what the eager step draws: the step fed them repeats a step that drew
    for itself, and the generator ends in the same state."""
    reg_fn = make_reg_fn('diffusion', diff)
    shape = problem['mu0'].shape
    gen = torch.Generator().manual_seed(3)
    pre = [inversion._step_draws(reg_fn, True, shape, gen, 'cpu')
           for _ in range(3)]
    eager = torch.Generator().manual_seed(3)
    for d in pre:
        x0 = torch.randn(shape, generator=eager)
        t, noise = reg_fn.draws(shape, eager, 'cpu', torch.float32)
        assert torch.equal(d['x0_noise'], x0)
        assert torch.equal(d['t'], t) and torch.equal(d['reg_noise'], noise)
    assert torch.equal(gen.get_state(), eager.get_state())
    engine = inversion.InversionEngine(diff, regularization='diffusion',
                                       device='cpu')
    bufs = engine._scan_buffers(None, problem['op'], reg_fn, inversion.Adam(
        inversion.cosine_decay_schedule(0.03, 3)), 0.75, True, shape, 3,
        problem['y'], torch.ones_like(problem['y']),
        torch.zeros((2, 1, 16, 16)))
    gen = torch.Generator().manual_seed(3)
    kept = bufs.fill_draws(lambda: inversion._step_draws(
        reg_fn, True, shape, gen, 'cpu'), range(3), gen, {2})
    for i, d in enumerate(pre):
        for k, v in d.items():
            assert torch.equal(bufs.draws[k][i], v)
    replay = torch.Generator().manual_seed(3)
    inversion._step_draws(reg_fn, True, shape, replay, 'cpu')
    inversion._step_draws(reg_fn, True, shape, replay, 'cpu')
    assert list(kept) == [2] and torch.equal(kept[2], replay.get_state())


@pytest.mark.parametrize('seg', [1, 2, 3, TS])
def test_segments_equal_the_unsegmented_run(problem, diff, seg):
    _assert_same(_run(problem, diff), _run(problem, diff, segment_steps=seg))


class Interrupted(Exception):
    pass


@pytest.mark.parametrize('every', [2, 3])
def test_checkpoint_and_resume_equal_the_uninterrupted_run(
        problem, diff, tmp_path, every):
    """A run cut in its fourth step, resumed from its last snapshot by a
    fresh engine: the model and every curve of the uninterrupted run, and
    so does a run that only writes snapshots."""
    want = _run(problem, diff)
    path = tmp_path / 'state.pt'
    _assert_same(want, _run(problem, diff, checkpoint_path=str(path),
                            checkpoint_every=every))
    path.unlink()
    calls = []
    op = problem['op']

    def cut(v):
        calls.append(1)
        if len(calls) == 4:
            raise Interrupted
        return op(v)

    with pytest.raises(Interrupted):
        _run(dict(problem, op=cut), diff, checkpoint_path=str(path),
             checkpoint_every=every)
    assert torch.load(path, weights_only=True)['step'] == 3 // every * every
    _assert_same(want, _run(problem, diff, checkpoint_path=str(path),
                            checkpoint_every=every, resume=True))


def test_cache_key_changes_with_each_part(problem, diff):
    """Every part of :meth:`InversionEngine._cache_key`, and an assignment
    of the U-Net's weights, changes the key; an equal operator does not."""
    engine = inversion.InversionEngine(diff, regularization='diffusion',
                                       device='cpu')
    op = problem['op']
    base = dict(reg_name='diffusion', ts=5, lr=0.03, reg_lambda=0.75,
                mu_shape=(2, 1, 18, 18), y_shape=(2, 2, 20, 16),
                fwi_forward=op, mesh=None)

    def key(**kw):
        return engine._cache_key(**dict(base, **kw))

    want = key()
    assert key(fwi_forward=FWIForward(
        CTX, v_denorm_func=tdt.v_denormalize,
        s_norm_func=tdt.s_normalize_none, device='cpu')) == want
    other_ops = [
        FWIForward(dict(CTX, nbc=40), v_denorm_func=tdt.v_denormalize,
                   s_norm_func=tdt.s_normalize_none, device='cpu'),
        FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                   s_norm_func=tdt.s_normalize_none, chunk=10, device='cpu'),
        FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                   s_norm_func=tdt.s_normalize_none, backend='kernel',
                   device='cpu'),
        FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                   s_norm_func=tdt.s_normalize_none, backend='kernel',
                   adjoint='tape', device='cpu'),
        op.sharded(['cpu', 'cpu']), lambda v: op(v)]
    changed = [key(reg_name='tv'), key(ts=6), key(lr=0.01),
               key(reg_lambda=0.5), key(mu_shape=(1, 1, 18, 18)),
               key(y_shape=(2, 2, 21, 16)),
               key(mesh=make_mesh(1, 2, ['cpu'] * 2))]
    changed += [key(fwi_forward=o) for o in other_ops]
    for attr, value in (('sigma_x0', 1e-3), ('use_time_weight', True),
                        ('fixed_timestep', 10)):
        saved = getattr(engine, attr)
        setattr(engine, attr, value)
        changed.append(key())
        setattr(engine, attr, saved)
    diff.half_precision = True
    changed.append(key())
    diff.half_precision = False
    changed.append(inversion.InversionEngine(
        GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=18,
                          timesteps=20, device='cpu'),
        regularization='diffusion', device='cpu')._cache_key(**base))
    assert inversion.InversionEngine(
        diff, regularization='diffusion', device='meta')._cache_key(
            **base) != want
    for k in changed:
        assert k[0] != want[0], k
    # The weights: a params assignment copies in place and bumps their
    # versions, so the stamp changes and a cached graph is dropped.
    diff.params = diff.params
    assert key()[0] == want[0] and key()[1] != want[1]
    cache = graphs.GraphCache()

    class Graph:
        released = False

        def release(self):
            self.released = True

    g = Graph()
    cache.put(want[0], want[1], g)
    assert cache.get(want[0], want[1]) is g
    assert cache.get(*key()) is None and g.released and len(cache) == 0


def test_launch_counters_add_a_replay(problem):
    """A replay adds its captured launches to the wrappers' counters and
    the plain path's chunk count."""
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic
    before = graphs.launch_counts()
    graphs.add_launches({'fwd_step': 5, 'sum_shots': 1, 'plain_chunk': 2})
    after = graphs.launch_counts()
    assert after['fwd_step'] == before['fwd_step'] + 5
    assert after['sum_shots'] == before['sum_shots'] + 1
    assert acoustic.plain_chunk_calls['chunk'] == before['plain_chunk'] + 2
    graphs._set_counts(before)
    assert stencil.launches['fwd_step'] == before['fwd_step']


@pytest.fixture(scope='module')
def jax_scan(problem):
    """The JAX engine's scanned run (``use_scan=True``) of the problem,
    with the draws of its corruption."""
    p = problem
    jop = JaxFWI(CTX, v_denorm_func=jdt.v_denormalize,
                 s_norm_func=jdt.s_normalize_none, backend='xla')
    key = jax.random.PRNGKey(0)
    mu, per_model = JaxEngine().optimize(
        jnp.asarray(p['mu0']), jnp.asarray(p['v_true']),
        jnp.asarray(p['y'].numpy()), jop, ts=TS, lr=0.03, reg_lambda=0.75,
        regularization='tv', key=key, use_scan=True, progress=False)
    return np.asarray(mu), per_model


def test_scanned_run_matches_the_jax_scanned_run(problem, jax_scan):
    """TV (no draws) on the plain path, scanned in both packages."""
    want_mu, want = jax_scan
    mu, got = inversion.InversionEngine(regularization='tv',
                                        device='cpu').optimize(
        problem['mu0'], problem['v_true'], problem['y'], problem['op'],
        ts=TS, lr=0.03, reg_lambda=0.75, use_scan=True, progress=False)
    np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-5, rtol=0)
    for curves, want_curves in zip(got, want):
        for k in KEYS:
            np.testing.assert_allclose(curves[k], want_curves[k], rtol=1e-4,
                                       err_msg=k)
