"""The port's FD solver and its stencil kernels' plain versions against the
JAX package on the CPU.

The same numpy inputs go through ``red_diffeq_tpu`` (XLA stepper, and the
Pallas kernels in interpret mode with either adjoint) and through
``red_diffeq_tpu_torch`` (the plain path, and the kernel backend, which on
CPU tensors runs the kernels' plain versions). Tolerances are the JAX
suite's own (tests/test_pallas_interpret.py): forward rtol 2e-5 /
atol 1e-7, gradient max-rel 1e-4.

The tape-free 'reverse' adjoint is held at nbc=60 (``STABLE``), where the
t2 guard picks it; the taped adjoint at nbc=8 (``HARSH``), where the guard
picks 'tape' and even the JAX reverse adjoint disagrees with XLA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.ops import stencil as jstencil
from red_diffeq_tpu.solvers import acoustic as jacoustic
from red_diffeq_tpu.utils.data_trans import v_denormalize as jv_denorm
from red_diffeq_tpu_torch.ops import stencil as tstencil
from red_diffeq_tpu_torch.solvers import acoustic as tacoustic
from red_diffeq_tpu_torch.utils.data_trans import v_denormalize as tv_denorm

# nbc=60 keeps the bound on min(t2) above the guard (0.82 > 0.8), so the
# tape-free reverse adjoint is the one the guard itself selects.
STABLE = dict(n_grid=16, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10, gz=10,
              ng=16, ns=2)


# nbc=8: the bound on min(t2) is far below the guard, so the kernel backend
# takes the taped adjoint by itself.
HARSH = dict(STABLE, nbc=8)


def _ctx(**kw):
    return {**STABLE, 'nt': 40, **kw}


def _jax_op(ctx, backend, st=1, **kw):
    return jacoustic.FWIForward(ctx, sample_temporal=st, normalize=True,
                                v_denorm_func=jv_denorm,
                                s_norm_func=lambda s: s, backend=backend,
                                chunk=20, **kw)


def _torch_op(ctx, backend, st=1, adjoint=None):
    return tacoustic.FWIForward(ctx, sample_temporal=st,
                                v_denorm_func=tv_denorm,
                                s_norm_func=lambda s: s, backend=backend,
                                chunk=20, adjoint=adjoint, device='cpu')


def _velocity(batch=2, n=16, seed=0):
    rng = np.random.RandomState(seed)
    v = np.full((batch, 1, n, n), -0.4, np.float32)
    v[:, :, n // 2:, :] = 0.3
    return v + rng.uniform(-0.05, 0.05, v.shape).astype(np.float32)


def _max_rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.mark.parametrize('backend', ['plain', 'kernel'])
@pytest.mark.parametrize('st', [1, 2])
def test_forward_matches_xla(backend, st):
    """nt=50 with chunk 20 leaves an uneven tail; st=2 subsamples time."""
    ctx = _ctx(nt=50)
    v = _velocity()
    want = np.asarray(_jax_op(ctx, 'xla', st)(jnp.asarray(v)))
    got = _torch_op(ctx, backend, st)(torch.from_numpy(v)).numpy()
    assert got.shape == want.shape == (2, 2, -(-50 // st), 16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)


def _masked_l1_grad(op, v, y, mask):
    """Gradient of the masked-L1 observation loss through the port."""
    x = torch.from_numpy(v.copy()).requires_grad_(True)
    loss = ((op(x) - torch.tensor(y)).abs()
            * torch.tensor(mask)).sum() / mask.sum()
    loss.backward()
    return x.grad.numpy()


def _jax_masked_l1_grad(jop, v, y, mask):
    def jloss(x):
        return jnp.sum(jnp.abs(jop._forward(x) - y) * mask) / mask.sum()

    return np.asarray(jax.grad(jloss)(jnp.asarray(v)))


@pytest.mark.parametrize('backend,jax_backend', [
    ('plain', 'xla'), ('kernel', 'xla'), ('kernel', 'pallas_interpret')])
def test_grad_matches_jax(backend, jax_backend):
    """Gradient of a masked L1 observation loss w.r.t. the normalised
    velocity, max-rel 1e-4."""
    ctx = _ctx(nt=40)
    v = _velocity()
    y = np.asarray(_jax_op(ctx, 'xla')(jnp.asarray(v + 0.05)))
    mask = np.ones_like(y)
    mask[:, :, :, 3] = 0.0
    jop = _jax_op(ctx, jax_backend, adjoint='reverse')

    def jloss(x):
        return jnp.sum(jnp.abs(jop._forward(x) - y) * mask) / mask.sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    x = torch.from_numpy(v.copy()).requires_grad_(True)
    pred = _torch_op(ctx, backend)(x)
    loss = ((pred - torch.tensor(y)).abs()
            * torch.tensor(mask)).sum() / mask.sum()
    loss.backward()
    assert _max_rel(x.grad.numpy(), want) < 1e-4


def _chunk_inputs(seed=1, b=2, ns=2, hp=24, wp=28, chunk=20):
    geom = jacoustic.Geometry.from_ctx(dict(
        n_grid=12, nt=chunk, dx=10.0, dt=0.001, nbc=8, f=15.0, sz=10,
        gz=20, ng=12, ns=ns))
    rng = np.random.RandomState(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    alpha = rng.uniform(0.04, 0.09, (b, 1, hp, wp)).astype(np.float32)
    t2 = rng.uniform(0.9, 1.0, (b, 1, hp, wp)).astype(np.float32)
    t1 = (2.0 - 5.0 * alpha - (1.0 - t2)).astype(np.float32)
    inj = np.zeros((b, ns, 1, wp), np.float32)
    for s, col in enumerate(geom.isx):
        inj[:, s, 0, col] = rng.uniform(0.1, 0.5, b)
    return dict(geom=geom, p0=f(b, ns, hp, wp), p1=f(b, ns, hp, wp),
                gp0=f(b, ns, hp, wp), gp1=f(b, ns, hp, wp), alpha=alpha,
                t1=t1, t2=t2, inj=inj, src=f(chunk),
                grec=f(b, ns, chunk, geom.ng))


def _geo(geom):
    return dict(isz=geom.isz, igz=geom.igz, g0=geom.igx[0], ng=geom.ng)


def test_fwd_chunk_plain_matches_pallas_fwd_kernel():
    """``fwd_chunk`` on CPU tensors (the plain version of ``fwd_step``)
    against ``_run_fwd`` in interpret mode on random O(1) fields: max-rel
    2e-5 per output (elementwise rtol fails near the fields' zeros, where
    XLA's CPU fusion rounds differently)."""
    d = _chunk_inputs()
    g = d['geom']
    J = jnp.asarray
    want = jstencil._run_fwd(
        J(d['p0']), J(d['p1']), J(d['alpha']), J(d['t1']), J(d['t2']),
        J(d['inj']), J(d['src']), geom=g, chunk=20, unroll=10,
        interpret=True)
    T = torch.from_numpy
    got = tstencil.fwd_chunk(
        T(d['p0']), T(d['p1']), T(d['alpha']), T(d['t1']), T(d['t2']),
        T(d['inj']), T(d['src']), **_geo(g))
    for name, w, o in zip(('p0', 'p1', 'recs'), want, got):
        assert tuple(o.shape) == tuple(w.shape), name
        assert _max_rel(o.numpy(), np.asarray(w)) < 2e-5, name


def test_bwd_reverse_chunk_plain_matches_pallas_reverse_kernel():
    """``bwd_reverse_chunk`` on CPU tensors (the plain version of
    ``bwd_reverse_step``) against ``_run_bwd_reverse`` in interpret mode,
    on the same chunk-end states and cotangents: max-rel 1e-5 per output."""
    d = _chunk_inputs(seed=2)
    g = d['geom']
    J, T = jnp.asarray, torch.from_numpy
    p0o, p1o, _ = jstencil._run_fwd(
        J(d['p0']), J(d['p1']), J(d['alpha']), J(d['t1']), J(d['t2']),
        J(d['inj']), J(d['src']), geom=g, chunk=20, unroll=10,
        interpret=True)
    p0o, p1o = np.array(p0o), np.array(p1o)
    g0 = g.igx[0]
    grec_full = np.zeros((*d['grec'].shape[:3], d['p0'].shape[-1]),
                         np.float32)
    grec_full[..., g0:g0 + g.ng] = d['grec']
    want = jstencil._run_bwd_reverse(
        J(p0o), J(p1o), J(d['gp0']), J(d['gp1']), J(grec_full),
        J(d['alpha']), J(d['t1']), J(d['t2']), J(d['inj']), J(d['src']),
        geom=g, chunk=20, unroll=10, interpret=True)
    got = tstencil.bwd_reverse_chunk(
        T(p0o), T(p1o), T(d['gp0']), T(d['gp1']), T(d['grec']),
        T(d['alpha']), T(d['t1']), T(d['t2']), T(d['inj']), T(d['src']),
        **_geo(g))
    for name, w, o in zip(('gp0', 'gp1', 'galpha', 'gt1', 'gt2', 'ginj'),
                          want, got):
        assert tuple(o.shape) == tuple(w.shape), name
        assert _max_rel(o.numpy(), np.asarray(w)) < 1e-5, name


def test_stencil_chunk_autograd_matches_plain_autograd():
    """The per-chunk ``autograd.Function`` gives the plain path's gradients
    for every input, the coefficient fields and the injection row
    included (max-rel 1e-4)."""
    _stencil_chunk_vs_plain_autograd(seed=3, mode='reverse')


def _stencil_chunk_vs_plain_autograd(seed, mode):
    d = _chunk_inputs(seed=seed)
    g = d['geom']
    T = torch.from_numpy
    names = ('p0', 'p1', 'alpha', 't1', 't2', 'inj')

    def run(fn):
        xs = [T(d[n].copy()).requires_grad_(True) for n in names]
        out = fn(*xs)
        w = torch.from_numpy(np.random.RandomState(4).standard_normal(
            out[2].shape).astype(np.float32))
        ((out[2] * w).sum() + (out[1] ** 2).sum() + out[0].sum()).backward()
        return [x.grad.numpy() for x in xs]

    geo = (g.isz, g.igz, g.igx[0], g.ng)
    got = run(lambda *xs: tstencil.StencilChunk.apply(*xs, T(d['src']), geo,
                                                      mode))
    want = run(lambda *xs: tstencil.fwd_chunk_plain(*xs, T(d['src']),
                                                    **_geo(g)))
    for name, o, w in zip(names, got, want):
        assert _max_rel(o, w) < 1e-4, name


def test_t2_guard_routes_to_tape_which_the_kernels_refuse(monkeypatch):
    """The guard routes nbc=8 to 'tape' and the headline (nbc=120) to
    'reverse', with the JAX package's bound. The kernels used to refuse the
    taped route; now the kernel backend runs it, through the tape replay
    and the taped adjoint (their plain versions on the CPU) and not through
    the tape-free one."""
    safe = jacoustic.Geometry.from_ctx(_ctx())
    harsh = jacoustic.Geometry.from_ctx(_ctx(nbc=8))
    tsafe = tacoustic.Geometry.from_ctx(_ctx())
    tharsh = tacoustic.Geometry.from_ctx(_ctx(nbc=8))
    assert tstencil._t2_lower_bound(tsafe) == pytest.approx(
        jstencil._t2_lower_bound(safe))
    assert tstencil._t2_lower_bound(tharsh) == pytest.approx(
        jstencil._t2_lower_bound(harsh))
    assert tstencil.resolve_run_config(tsafe, 20) == ('reverse', 10)
    assert tstencil.resolve_run_config(tharsh, 20) == ('tape', 10)
    assert jstencil.resolve_run_config(harsh, 20, None, 'roll')[0] == 'tape'
    headline = tacoustic.Geometry.from_ctx(dict(
        n_grid=70, nt=1000, dx=10.0, dt=0.001, nbc=120, f=15.0, sz=10,
        gz=10, ng=70, ns=5))
    assert tstencil._t2_lower_bound(headline) == pytest.approx(0.909, abs=1e-3)
    calls = {'tape_chunk_plain': 0, 'bwd_tape_chunk_plain': 0,
             'bwd_reverse_chunk_plain': 0}
    for name in calls:
        def spy(*a, _name=name, _fn=getattr(tstencil, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tstencil, name, spy)
    v = torch.from_numpy(_velocity()).requires_grad_(True)
    seis = _torch_op(_ctx(nbc=8), 'kernel')(v)
    assert tuple(seis.shape) == (2, 2, 40, 16)
    seis.square().sum().backward()
    assert bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().max()) > 0
    assert calls == {'tape_chunk_plain': 2, 'bwd_tape_chunk_plain': 2,
                     'bwd_reverse_chunk_plain': 0}


def test_kernel_backend_refuses_an_unknown_adjoint():
    op = _torch_op(_ctx(), 'kernel', adjoint='taped')
    with pytest.raises(ValueError, match="unknown adjoint mode 'taped'"):
        op(torch.from_numpy(_velocity()))


def test_kernel_backend_refuses_scattered_receivers():
    op = tacoustic.FWIForward(
        tacoustic.refined_ctx(_ctx(), 2), sample_temporal=2,
        v_denorm_func=tv_denorm, backend='kernel', device='cpu')
    with pytest.raises(NotImplementedError, match='contiguous'):
        op(torch.zeros(1, 1, 32, 32))


@pytest.mark.parametrize('pick', [lambda m: m.ricker(15.0, 0.001, 300),
                                  lambda m: m.upsample_velocity(
                                      np.arange(12.0).reshape(1, 1, 3, 4))])
def test_host_helpers_match(pick):
    np.testing.assert_array_equal(pick(tacoustic), pick(jacoustic))


def test_refined_ctx_and_sponge_match():
    ctx = _ctx()
    assert tacoustic.refined_ctx(ctx, 2).keys() == \
        jacoustic.refined_ctx(ctx, 2).keys()
    for k, v in jacoustic.refined_ctx(ctx, 2).items():
        np.testing.assert_array_equal(tacoustic.refined_ctx(ctx, 2)[k], v)
    vpad = 1500.0 + 3000.0 * np.random.RandomState(5).rand(
        2, 1, 40, 44).astype(np.float32)
    want = np.asarray(jacoustic.sponge_profile(jnp.asarray(vpad), 12, 10.0))
    got = tacoustic.sponge_profile(torch.from_numpy(vpad), 12, 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pick_unroll_matches():
    for chunk in (1, 5, 7, 8, 12, 20, 25, 100):
        assert tstencil.pick_unroll(chunk) == jstencil.pick_unroll(chunk)


def _jax_tape_and_ours(d):
    g = d['geom']
    J, T = jnp.asarray, torch.from_numpy
    coef = ('alpha', 't1', 't2', 'inj')
    jtape = jstencil._run_tape(J(d['p0']), J(d['p1']),
                               *(J(d[k]) for k in coef), J(d['src']),
                               geom=g, chunk=20, unroll=10, interpret=True)
    tape = tstencil.tape_chunk(T(d['p0']), T(d['p1']),
                               *(T(d[k]) for k in coef), T(d['src']),
                               isz=g.isz)
    return np.asarray(jtape), tape


def test_tape_chunk_plain_matches_pallas_tape_kernel():
    """``tape_chunk`` on CPU tensors (the plain version of ``tape_step``)
    against ``_run_tape`` in interpret mode. JAX's haloed block j, slot i,
    holds s_{jU-1+i}: flat slot jU+i of the port's tape. Max-rel 1e-5 on
    every slot, relative to the slot's largest value (elementwise rtol
    fails near the fields' zeros, where XLA's CPU fusion rounds
    differently)."""
    d = _chunk_inputs(seed=5)
    jtape, tape = _jax_tape_and_ours(d)
    b, n_iter, slots, ns, hp, wp = jtape.shape
    assert (n_iter, slots) == (2, 12)
    assert tuple(tape.shape) == (22, b, ns, hp, wp)
    np.testing.assert_array_equal(tape[0].numpy(), d['p0'])
    np.testing.assert_array_equal(tape[1].numpy(), d['p1'])
    for j in range(n_iter):
        for i in range(slots):
            assert _max_rel(tape[10 * j + i].numpy(),
                            jtape[:, j, i]) < 1e-5, (j, i)


def test_bwd_tape_chunk_plain_matches_pallas_bwd_kernel():
    """``bwd_tape_chunk`` on CPU tensors (the plain version of
    ``bwd_tape_step``) against ``_run_bwd`` in interpret mode, each on its
    own package's tape of the same chunk: max-rel 1e-5 per output (the JAX
    kernel sums U steps before it adds them to its coefficient cotangents,
    so the fp32 order differs)."""
    d = _chunk_inputs(seed=6)
    g = d['geom']
    J, T = jnp.asarray, torch.from_numpy
    jtape, tape = _jax_tape_and_ours(d)
    g0 = g.igx[0]
    grec_full = np.zeros((*d['grec'].shape[:3], d['p0'].shape[-1]),
                         np.float32)
    grec_full[..., g0:g0 + g.ng] = d['grec']
    want = jstencil._run_bwd(
        J(jtape), J(d['gp0']), J(d['gp1']), J(grec_full), J(d['alpha']),
        J(d['t1']), J(d['t2']), J(d['src']), geom=g, chunk=20, unroll=10,
        interpret=True)
    got = tstencil.bwd_tape_chunk(
        tape, T(d['gp0']), T(d['gp1']), T(d['grec']), T(d['alpha']),
        T(d['t1']), T(d['t2']), T(d['src']), **_geo(g))
    for name, w, o in zip(('gp0', 'gp1', 'galpha', 'gt1', 'gt2', 'ginj'),
                          want, got):
        assert tuple(o.shape) == tuple(w.shape), name
        assert _max_rel(o.numpy(), np.asarray(w)) < 1e-5, name


def test_stencil_chunk_tape_mode_matches_plain_autograd():
    """``StencilChunk`` in 'tape' mode (saves the chunk-start carry, replays
    it into a tape in the backward) gives plain eager autograd's gradients
    for every input (max-rel 1e-4)."""
    _stencil_chunk_vs_plain_autograd(seed=7, mode='tape')


@pytest.mark.parametrize('jax_backend', ['xla', 'pallas_interpret'])
@pytest.mark.parametrize('nt', [40, 50])
def test_tape_route_grad_matches_jax(jax_backend, nt):
    """The kernel backend at nbc=8, where the guard itself takes the taped
    adjoint, against JAX's ``adjoint='tape'`` Pallas kernels in interpret
    mode and against XLA's ``jax.grad``: max-rel 1e-4 on the velocity
    gradient of a masked L1 loss, rtol 2e-5 / atol 1e-7 on the forward.
    nt=50 with chunk 20 leaves an uneven last chunk, padded with source
    zeros."""
    ctx = {**HARSH, 'nt': nt}
    assert tstencil.resolve_run_config(
        tacoustic.Geometry.from_ctx(ctx), 20)[0] == 'tape'
    v = _velocity()
    y = np.asarray(_jax_op(ctx, 'xla')(jnp.asarray(v + 0.05)))
    mask = np.ones_like(y)
    mask[:, :, :, 3] = 0.0
    jop = _jax_op(ctx, jax_backend, adjoint='tape')
    op = _torch_op(ctx, 'kernel')
    np.testing.assert_allclose(
        op(torch.from_numpy(v)).detach().numpy(),
        np.asarray(jop(jnp.asarray(v))), rtol=2e-5, atol=1e-7)
    want = _jax_masked_l1_grad(jop, v, y, mask)
    assert _max_rel(_masked_l1_grad(op, v, y, mask), want) < 1e-4


def test_tape_and_reverse_adjoints_agree():
    """At nbc=60 both adjoints are valid: the kernel backend's velocity
    gradients under ``adjoint='tape'`` and ``'reverse'`` agree to max-rel
    1e-4 (the JAX suite's reverse-vs-tape gate)."""
    ctx = _ctx(nt=40)
    v = _velocity(seed=3)
    y = np.asarray(_jax_op(ctx, 'xla')(jnp.asarray(v + 0.05)))
    mask = np.ones_like(y)
    grads = {mode: _masked_l1_grad(_torch_op(ctx, 'kernel', adjoint=mode),
                                   v, y, mask)
             for mode in ('tape', 'reverse')}
    assert float(np.abs(grads['tape']).max()) > 0
    assert _max_rel(grads['reverse'], grads['tape']) < 1e-4
