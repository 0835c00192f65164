"""The port's FD solver and its stencil kernels' plain versions against the
JAX package on the CPU.

The same numpy inputs go through ``red_diffeq_tpu`` (XLA stepper, and the
Pallas kernels in interpret mode with ``adjoint='reverse'``) and through
``red_diffeq_tpu_torch`` (the plain path, and the kernel backend, which on
CPU tensors runs the kernels' plain versions). Tolerances are the JAX
suite's own (tests/test_pallas_interpret.py): forward rtol 2e-5 /
atol 1e-7, gradient max-rel 1e-4.
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


def _ctx(**kw):
    return {**STABLE, 'nt': 40, **kw}


def _jax_op(ctx, backend, st=1, **kw):
    return jacoustic.FWIForward(ctx, sample_temporal=st, normalize=True,
                                v_denorm_func=jv_denorm,
                                s_norm_func=lambda s: s, backend=backend,
                                chunk=20, **kw)


def _torch_op(ctx, backend, st=1):
    return tacoustic.FWIForward(ctx, sample_temporal=st,
                                v_denorm_func=tv_denorm,
                                s_norm_func=lambda s: s, backend=backend,
                                chunk=20, device='cpu')


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
    d = _chunk_inputs(seed=3)
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
    got = run(lambda *xs: tstencil.StencilChunk.apply(*xs, T(d['src']), geo))
    want = run(lambda *xs: tstencil.fwd_chunk_plain(*xs, T(d['src']),
                                                    **_geo(g)))
    for name, o, w in zip(names, got, want):
        assert _max_rel(o, w) < 1e-4, name


def test_t2_guard_routes_to_tape_which_the_kernels_refuse():
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
    v = torch.from_numpy(_velocity())
    with pytest.raises(NotImplementedError, match='tape'):
        _torch_op(_ctx(nbc=8), 'kernel')(v)


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
