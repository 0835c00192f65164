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


# Every public function and method of the JAX package, by an AST walk of
# both packages' sources: its parameters in the port, at the same module
# path, in the JAX order. JAX's ``key`` is the port's ``generator`` at that
# place, which explicit draws of its own (DRAWS) may follow, as above; the
# port may add parameters only after the JAX ones. Exempt, each with its
# reason:
JAX_ONLY = {
    'ops.stencil:pallas_chunk': 'the Pallas chunk with its custom VJP; the '
    "port's is StencilChunk, a torch.autograd.Function",
    'ops.stencil:pallas_chunk_fn': "the Pallas chunk's adapter; the port's "
    'is stencil_chunk_fn',
    'ops.stencil:band_circulant_x': "the TPU-only 'mxu' x-stencil layout's "
    'circulant, not ported (ops/layout_probe.py ports the layouts probe)',
    'ops.stencil:pick_even_unroll': "the TPU-only 'roll' layout's unroll; "
    'the CUDA kernels pick their steps a launch from the field '
    '(pick_blocking)',
    'utils.cache:enable_persistent_cache': "JAX's persistent compilation "
    'cache; the port builds its kernels into a library kept by its hash',
    'models.diffusion:GaussianDiffusion.init_params': 'flax initialises the '
    "U-Net's parameters in a call; a torch module makes them in its "
    'constructor',
}
FLAX_CALL = ("a flax module's __call__; a torch module's is forward, called "
             'through __call__')
# JAX parameters the port leaves out.
DROPPED = {
    'ops.stencil:resolve_run_config': (
        ['layout'], "the TPU-only x-stencil layout the JAX kernels bake in; "
        'the CUDA kernels have one'),
}
# Functions whose JAX form differs as a whole.
OTHER_FORM = {
    'models.diffusion:GaussianDiffusion.p_losses': 'the JAX form takes the '
    'weights and a key explicitly for jax.grad; the port differentiates '
    "the module's own weights (or params, last) and takes its draws",
    'models.diffusion:GaussianDiffusion.loss': "p_losses's explicit "
    'params/key form, likewise',
}
DRAWS = ('noise', 'noise_draw', 'trace_mask', 'draw', 'ilvr_noise', 't',
         'offset')


def _params(fn):
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if names and names[0] in ('self', 'cls'):
        names = names[1:]
    return (names + ([f'*{a.vararg.arg}'] if a.vararg else [])
            + [p.arg for p in a.kwonlyargs]
            + ([f'**{a.kwarg.arg}'] if a.kwarg else []))


def _public(path):
    """{name: parameter names} of the public functions and methods
    (``__init__`` and ``__call__`` included, properties not) of the module
    at ``path``."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith('_'):
            out[node.name] = _params(node)
        if isinstance(node, ast.ClassDef) and not node.name.startswith('_'):
            for m in node.body:
                decorators = [ast.unparse(d) for d in m.decorator_list] \
                    if isinstance(m, ast.FunctionDef) else []
                if (isinstance(m, ast.FunctionDef)
                        and (not m.name.startswith('_')
                             or m.name in ('__init__', '__call__'))
                        and 'property' not in decorators
                        and not any(d.endswith('.setter')
                                    for d in decorators)):
                    out[f'{node.name}.{m.name}'] = _params(m)
    return out


def _follows(want, got):
    """Whether ``got`` holds ``want`` in order, ``key`` as ``generator``
    and then any DRAWS, the port's own parameters only after."""
    i = 0
    for n, p in enumerate(want):
        if p == 'key':
            if got[i:i + 1] != ['generator']:
                return False
            i += 1
            after = want[n + 1] if n + 1 < len(want) else None
            while i < len(got) and got[i] in DRAWS and got[i] != after:
                i += 1
        elif got[i:i + 1] == [p]:
            i += 1
        else:
            return False
    return True


JAX_MODULES = sorted(str(p.relative_to(REPO / 'red_diffeq_tpu'))
                     for p in (REPO / 'red_diffeq_tpu').rglob('*.py'))


@pytest.mark.parametrize('module', JAX_MODULES)
def test_public_functions_and_methods_follow_the_jax_package(module):
    """Each public function and method of one JAX module against the
    port's (see JAX_ONLY above)."""
    jax_fns = _public(REPO / 'red_diffeq_tpu' / module)
    port_path = REPO / 'red_diffeq_tpu_torch' / module
    port_fns = _public(port_path) if port_path.exists() else {}
    mod = module[:-3].replace('/', '.')
    for name, want in jax_fns.items():
        key = f'{mod}:{name}'
        if key in JAX_ONLY or key in OTHER_FORM or (
                name.endswith('.__call__') and name not in port_fns):
            assert key not in port_fns or key in OTHER_FORM, key
            continue
        assert name in port_fns, f'{key} is not in the port'
        dropped = DROPPED.get(key, ([], ''))[0]
        assert _follows([p for p in want if p not in dropped],
                        port_fns[name]), (key, want, port_fns[name])
    assert all(JAX_ONLY.values()) and all(OTHER_FORM.values())
    assert FLAX_CALL and all(r for _, r in DROPPED.values())


def test_the_repaired_signatures_take_jax_calls(tmp_path):
    """The calls that ran in JAX and failed or differed in the port."""
    from red_diffeq_tpu.models.unet import Unet as JUnet
    from red_diffeq_tpu_torch.io import checkpoints
    from red_diffeq_tpu_torch.utils import data_trans, profiling
    torch.manual_seed(0)
    diff = tpkg.GaussianDiffusion(tpkg.Unet(dim=8, dim_mults=(1, 2)),
                                  image_size=16, timesteps=10, device='cpu')
    # RED_DiffEq(d, use_time_weight, sigma_x0, fixed_timestep).
    red = tpkg.RED_DiffEq(diff, False, 1e-4)
    assert red.sigma_x0 == 1e-4 and red.fixed_timestep is None
    assert tpkg.RED_DiffEq(diff, False, 1e-4, 5).fixed_timestep == 5
    # The key's place takes the generator.
    mu = torch.rand(2, 1, 16, 16) * 2 - 1
    a = red.get_reg_loss(mu, torch.Generator().manual_seed(1))
    b = red.get_reg_loss(mu, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    x = torch.randn(2, 1, 16, 16)
    assert torch.equal(
        diff.p_sample(x, 3, torch.Generator().manual_seed(2))[0],
        diff.p_sample(x, 3, generator=torch.Generator().manual_seed(2))[0])
    assert torch.equal(
        diff.q_sample(x, torch.tensor([1, 2]), None,
                      torch.Generator().manual_seed(4)),
        diff.q_sample(x, torch.tensor([1, 2]), torch.randn(
            x.shape, generator=torch.Generator().manual_seed(4))))
    assert diff.interpolate(x, x, torch.Generator().manual_seed(3),
                            2).shape == x.shape
    # missing_trace(y, num_missing, return_mask, key).
    y = torch.rand(2, 2, 5, 8)
    got = data_trans.missing_trace(y, 3, False,
                                   torch.Generator().manual_seed(5))
    want, _ = data_trans.missing_trace(
        y, 3, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    assert data_trans.missing_trace(y, 0, False) is y
    # StepTimer(skip_first).
    timer = profiling.StepTimer(skip_first=2)
    for _ in range(5):
        with timer:
            pass
    assert len(timer.times) == 3 and timer.skip_first == 2
    # load_params(path, template), load_diffusion_params(..., verbose).
    path = tmp_path / 'p.ckpt'
    tree = {'a': {'w': np.arange(3.0)}, 'b': [np.ones(2), np.zeros(1)]}
    checkpoints.save_params(tree, path)
    back = checkpoints.load_params(path, {'a': {'w': None},
                                          'b': [None, None]})
    assert isinstance(back['b'], list)
    np.testing.assert_array_equal(back['a']['w'], tree['a']['w'])
    np.testing.assert_array_equal(back['b'][1], tree['b'][1])
    with pytest.raises(ValueError, match='missing'):
        checkpoints.load_params(path, {'c': None})
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert checkpoints.load_diffusion_params(
            diff, tmp_path / 'absent.ckpt', verbose=False) is diff
    # GaussianDiffusion.with_params: a new bundle, this one unchanged.
    params = diff.params
    zeroed = jax.tree_util.tree_map(np.zeros_like, params)
    other = diff.with_params(zeroed)
    assert other is not diff and other.model is not diff.model
    assert all(float(p.detach().abs().sum()) == 0
               for p in other.model.parameters())
    assert any(float(p.detach().abs().sum()) > 0
               for p in diff.model.parameters())
    # Unet.downsample_factor.
    for mults in ((1, 2), (1, 2, 4, 8)):
        assert tpkg.Unet(dim=8, dim_mults=mults).downsample_factor == \
            JUnet(dim=8, dim_mults=mults).downsample_factor


def test_trainer_train_takes_steps_per_call(tmp_path, capsys):
    """``Trainer.train(log_every, steps_per_call)``, the JAX trainer's
    call: no call crosses a milestone (saved after the call that reaches
    it), and a loss line follows each call that crosses a multiple of
    ``log_every``. 5 steps in calls of up to 2 with a milestone at 3: calls
    of 2, 1 and 2 steps, lines at steps 2 and 5, the milestone at 3."""
    from red_diffeq_tpu_torch.models import trainer as ttrainer
    torch.manual_seed(0)
    diff = tpkg.GaussianDiffusion(tpkg.Unet(dim=8, dim_mults=(1, 2)),
                                  image_size=16, timesteps=8, device='cpu')
    images = np.random.RandomState(2).rand(16, 1, 16, 16).astype(np.float32)
    tr = ttrainer.Trainer(diff, ttrainer.TensorDataset(images),
                          train_batch_size=4, gradient_accumulate_every=4,
                          train_num_steps=5,
                          save_and_sample_every=3, num_samples=4,
                          results_folder=str(tmp_path), seed=3)
    tr.train(2, 2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('step ')]
    assert [ln.split()[1] for ln in lines] == ['2/5', '5/5']
    assert tr.step == 5 and len(tr.training_losses) == 5
    assert sorted(p.name for p in tmp_path.glob('model-*.ckpt')) == \
        ['model-1.ckpt']


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
