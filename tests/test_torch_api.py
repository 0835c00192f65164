"""The port's public surface against the JAX package's, on the CPU.

Coverage: the port's ``__all__`` holds every name of the JAX package's, and
each imports. Signatures: the constructors and functions a script calls
take the JAX parameters in the JAX order, with only the differences listed
in ``ALLOWED``. Parity, the same numpy inputs through both packages:
``FWIForward`` with ``normalize=False`` and with ``sample_spatial=0.5`` on
the plain backend (the solver tests' forward tolerance: rtol 2e-5 /
atol 1e-7); ``update_config`` and ``print_config``
(the same text, the same warning); ``MetricsCalculator`` (rtol 1e-5 /
atol 1e-6, the metrics tests'); the ``SSIM`` class (atol 1e-5, the SSIM
test's); ``RegularizationMethod`` (TV and Tikhonov rtol 1e-6, the RED
diffusion loss on JAX's draws rtol 1e-4, the regularisation tests');
``worker_init_fn`` (the same python and numpy draws).
"""
import ast
import contextlib
import inspect
import io
import random
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import red_diffeq_tpu as jpkg
import red_diffeq_tpu_torch as tpkg
from red_diffeq_tpu.bench_methods import DiffusionFWI as JDiffusionFWI
from red_diffeq_tpu.bench_methods import ILVR_FWI as JILVR_FWI
from red_diffeq_tpu.utils.data_trans import v_denormalize as jv_denorm
from red_diffeq_tpu_torch.bench_methods import DiffusionFWI, ILVR_FWI
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
from red_diffeq_tpu_torch.utils.data_trans import v_denormalize as tv_denorm

REPO = Path(__file__).resolve().parents[1]
CTX = dict(n_grid=16, nt=40, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
           gz=10, ng=16, ns=2)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The tiny shapes run fastest on one thread, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _all_of(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, 'id', None) == '__all__'
                        for t in node.targets)):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f'{path} has no __all__')


def test_all_covers_the_jax_package():
    jax_all = _all_of(REPO / 'red_diffeq_tpu' / '__init__.py')
    port_all = _all_of(REPO / 'red_diffeq_tpu_torch' / '__init__.py')
    assert len(jax_all) == 42
    assert sorted(set(jax_all) - set(port_all)) == []
    assert port_all == tpkg.__all__
    for name in port_all:
        assert getattr(tpkg, name) is not None, name


# The differences the port may have from the JAX signature, by name, each
# with its reason.
DEVICE = ('append', ['device'],
          'the entry point runs on the card unless given the CPU')
KEY = ('key', ['generator', 'noise_draw', 'trace_mask'],
       "a torch.Generator in place of the PRNG key, then the explicit "
       "draws that let tests feed JAX's")
FLAX = [('parent', [], "flax's module plumbing, which a torch module has "
          'no use for'),
        ('name', [], "flax's module name, likewise")]
ALLOWED = {
    'Unet': FLAX,
    'FWIForward': [DEVICE],
    'InversionEngine': [DEVICE],
    'InversionEngine.optimize': [KEY],
    'DiffusionFWI': [DEVICE],
    'ILVR_FWI': [DEVICE],
    'GaussianDiffusion': [DEVICE],
    'forward_modeling': [('append', ['shot_devices'],
                          "the devices of a data shard's shot shards, "
                          "which JAX's sharding annotations carry")],
    'RegularizationMethod': [],
}


def _expected(jax_fn, allowed):
    """The JAX parameters (name, kind) with the allowed differences made."""
    replace = {old: new for old, new, _ in allowed if old != 'append'}
    names = []
    for name, p in inspect.signature(jax_fn).parameters.items():
        names += [(n, p.kind) for n in replace.get(name, [name])]
    for old, new, _ in allowed:
        if old == 'append':
            names += [(n, names[-1][1]) for n in new]
    return names


@pytest.mark.parametrize('name', sorted(ALLOWED))
def test_signatures_follow_the_jax_package(name):
    obj, _, meth = name.partition('.')
    jfn, tfn = getattr(jpkg, obj, None), getattr(tpkg, obj)
    if jfn is None:
        jfn = {'DiffusionFWI': JDiffusionFWI, 'ILVR_FWI': JILVR_FWI}[obj]
    if meth:
        jfn, tfn = getattr(jfn, meth), getattr(tfn, meth)
    elif inspect.isclass(jfn):
        jfn, tfn = jfn.__init__, tfn.__init__
    got = [(n, p.kind) for n, p in inspect.signature(tfn).parameters.items()]
    assert got == _expected(jfn, ALLOWED[name])
    assert all(reason for *_, reason in ALLOWED[name])


def _velocity(seed=0):
    rng = np.random.RandomState(seed)
    v = np.full((2, 1, 16, 16), -0.4, np.float32)
    v[:, :, 8:, :] = 0.3
    return v + rng.uniform(-0.05, 0.05, v.shape).astype(np.float32)


@pytest.mark.parametrize('kw', [dict(normalize=False),
                                dict(sample_spatial=0.5)],
                         ids=['normalize_false', 'sample_spatial_half'])
def test_fwi_forward_options_match_jax(kw):
    """Without normalisation the input is in m/s and the seismogram raw;
    half the receivers lie every second column. The seismogram through the
    plain backend (the options change what enters and leaves the solver,
    whose gradient the solver tests hold)."""
    v = _velocity()
    if not kw.get('normalize', True):
        v = np.asarray(jv_denorm(jnp.asarray(v)))
    jop = jpkg.FWIForward(CTX, v_denorm_func=jv_denorm,
                          s_norm_func=lambda s: s * 2.0, backend='xla',
                          chunk=20, **kw)
    top = tpkg.FWIForward(CTX, v_denorm_func=tv_denorm,
                          s_norm_func=lambda s: s * 2.0, backend='xla',
                          chunk=20, device='cpu', **kw)
    assert top.backend == 'plain'
    want = np.asarray(jop(jnp.asarray(v)))
    got = top(torch.from_numpy(v)).numpy()
    ng = 8 if 'sample_spatial' in kw else 16
    assert got.shape == want.shape == (2, 2, 40, ng)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    assert top.geom.igx == jop.geom.igx


def test_scattered_receivers_raise_on_the_kernel_backend():
    """``sample_spatial=0.5`` leaves no contiguous receiver line: the kernel
    backend refuses it rather than running the plain path."""
    op = tpkg.FWIForward(CTX, sample_spatial=0.5, v_denorm_func=tv_denorm,
                         backend='pallas', device='cpu')
    assert op.backend == 'kernel'
    with pytest.raises(NotImplementedError, match='contiguous'):
        op(torch.from_numpy(_velocity()))


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_update_and_print_config_match_jax():
    jcfg, tcfg = jpkg.get_config(), tpkg.get_config()
    for pkg, cfg in ((jpkg, jcfg), (tpkg, tcfg)):
        pkg.update_config(cfg.optimization, lr=0.5, ts=7)
        with pytest.warns(UserWarning, match="config has no field 'extra'"):
            pkg.update_config(cfg.optimization, extra=3)
        assert (cfg.optimization.lr, cfg.optimization.extra) == (0.5, 3)
    want = _printed(jpkg.print_config, jcfg)
    assert _printed(tpkg.print_config, tcfg) == want
    assert 'extra: 3' in want and want.startswith('-' * 60)


def test_metrics_calculator_matches_jax():
    rng = np.random.RandomState(3)
    mu = rng.uniform(-1, 1, (3, 1, 20, 24)).astype(np.float32)
    mu_true = rng.uniform(1500, 4500, (3, 1, 20, 24)).astype(np.float32)
    want = jpkg.MetricsCalculator(None).calculate(jnp.asarray(mu),
                                                  jnp.asarray(mu_true))
    got = tpkg.MetricsCalculator(None).calculate(torch.from_numpy(mu),
                                                 torch.from_numpy(mu_true))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize('size_average', [True, False])
def test_ssim_class_matches_jax(size_average):
    rng = np.random.RandomState(4)
    a, b = (rng.rand(2, 1, 24, 20).astype(np.float32) for _ in range(2))
    want = jpkg.SSIM(window_size=7, size_average=size_average)(
        jnp.asarray(a), jnp.asarray(b))
    got = tpkg.SSIM(window_size=7, size_average=size_average)(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _jax_init(model, size, seed):
    """The JAX U-Net's initial parameters (``init`` jitted: op by op it
    takes several times longer)."""
    return jax.jit(model.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 1, size, size)),
                               jnp.zeros((1,)))['params']


def _mu(seed, shape=(2, 1, 18, 18)):
    return np.pad(np.random.RandomState(seed).uniform(
        -0.8, 0.8, (shape[0], shape[1], shape[2] - 2, shape[3] - 2)),
        ((0, 0), (0, 0), (1, 1), (1, 1))).astype(np.float32)


@pytest.mark.parametrize('name', ['tv', 'l2', None])
def test_regularization_method_matches_jax(name):
    mu = _mu(5)
    jr, _ = jpkg.RegularizationMethod(name).get_reg_loss(jnp.asarray(mu))
    tr, t = tpkg.RegularizationMethod(name).get_reg_loss(torch.from_numpy(mu))
    assert t is None
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)


def test_regularization_method_diffusion_matches_jax():
    """The RED loss of a dim-8 U-Net at 18x18 on JAX's draws: its t, then
    its noise, fed to the port."""
    jd = jpkg.GaussianDiffusion(jpkg.Unet(dim=8, dim_mults=(1, 2)),
                                image_size=18, timesteps=20)
    jd.params = _jax_init(jd.model, 18, 4)
    params = jax.tree.map(np.asarray,
                          flax.serialization.to_state_dict(jd.params))
    td = tpkg.GaussianDiffusion(tpkg.Unet(dim=8, dim_mults=(1, 2)),
                                image_size=18, timesteps=20, params=params,
                                device='cpu')
    mu = _mu(6)
    key = jax.random.PRNGKey(11)
    jreg, jt = jax.jit(jpkg.RegularizationMethod('diffusion',
                                                 jd).get_reg_loss)(
        jnp.asarray(mu), key)
    kt, kn = jax.random.split(key)
    noise = np.asarray(jax.random.normal(kn, mu.shape))
    treg, tt = tpkg.RegularizationMethod('diffusion', td).get_reg_loss(
        torch.from_numpy(mu), t=torch.from_numpy(np.array(jt)).long(),
        noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(kt, (2,), 0, 20)), np.asarray(jt))
    np.testing.assert_allclose(treg.numpy(), np.asarray(jreg), rtol=1e-4)


def test_gaussian_diffusion_takes_params_and_schedule_kwargs():
    """``params`` (a flax tree of numpy arrays) loads the U-Net as
    ``flax_to_state_dict`` does; ``schedule_fn_kwargs`` reach the beta
    schedule as in JAX (rtol 1e-6)."""
    jd = jpkg.GaussianDiffusion(jpkg.Unet(dim=8, dim_mults=(1, 2)),
                                image_size=16, timesteps=30,
                                beta_schedule='sigmoid',
                                schedule_fn_kwargs=dict(start=-2, end=4,
                                                        tau=0.7))
    jd.params = _jax_init(jd.model, 16, 2)
    params = jax.tree.map(np.asarray,
                          flax.serialization.to_state_dict(jd.params))
    td = tpkg.GaussianDiffusion(tpkg.Unet(dim=8, dim_mults=(1, 2)),
                                image_size=16, timesteps=30,
                                beta_schedule='sigmoid',
                                schedule_fn_kwargs=dict(start=-2, end=4,
                                                        tau=0.7),
                                params=params, device='cpu')
    np.testing.assert_allclose(td.schedule.betas.numpy(),
                               np.asarray(jd.schedule.betas), rtol=1e-6)
    want = flax_to_state_dict(params, tpkg.Unet(dim=8, dim_mults=(1, 2)))
    got = td.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_worker_init_fn_matches_jax():
    draws = []
    for pkg in (jpkg, tpkg):
        pkg.worker_init_fn(3, base_seed=5)
        draws.append((random.random(), np.random.rand(4).tolist()))
    assert draws[0] == draws[1]


def test_jax_style_constructor_calls_build():
    """The calls of the JAX package's scripts (``bench.py:135``, the
    engine and the competitor methods with ``ssim_loss`` positional)."""
    op = tpkg.FWIForward(CTX, normalize=True, v_denorm_func=tv_denorm,
                         s_norm_func=tpkg.s_normalize_none, backend='xla',
                         chunk=20, device='cpu')
    assert (op.normalize, op.backend, op.remat) == (True, 'plain', True)
    d = tpkg.GaussianDiffusion(tpkg.Unet(dim=8, dim_mults=(1, 2)),
                               image_size=16, timesteps=10, device='cpu')
    engine = tpkg.InversionEngine(d, None, 'diffusion', device='cpu')
    assert engine.regularization == 'diffusion'
    for cls in (DiffusionFWI, ILVR_FWI):
        m = cls(d, op, None, device='cpu')
        assert (m.diffusion_model, m.fwi_forward) == (d, op)
