"""The port's quality and prior-selection tools against the JAX package's.

The tools (``tools/torch_eval_quality.py``, ``torch_compare_methods.py``,
``torch_milestone_eval.py``, ``torch_lambda_sweep.py``,
``torch_pick_best_milestone.py``, the held-out problem of
``tools/torch_quality.py``) are shrunk by setting their module constants:
a 16x16 model at nbc=10, nt=40, 2 shots, a dim-8 U-Net on the 18x18
padded grid, 20 diffusion steps, 2 samples, 3 inversion steps. On the CPU
the operator takes the plain path, as the JAX tools take 'xla' there.

Tolerances: the truths and initial models equal JAX's exactly (the same
numpy code); the clean and refined observations rtol 1e-5 (atol 1e-6 of
their largest value: fp32 FD steps summed in another order); the final
MAE and SSIM of a ``tv`` and a ``none`` row rtol 1e-4 (the inversion
tests' tolerance on metrics; the ``diffusion`` rows draw from a
``torch.Generator`` where JAX draws from keys, so they are not compared);
``warm_compile`` leaves ``optimize`` bit for bit; the loss-curve summary
and the milestone pick equal the JAX tools'.
"""
import ast
import importlib.util
import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.core.inversion import InversionEngine as JaxEngine
from red_diffeq_tpu.io.synthetic import \
    generate_mixed_dataset as jax_generate
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.solvers.acoustic import refined_ctx as jax_refined_ctx
from red_diffeq_tpu.solvers.acoustic import \
    upsample_velocity as jax_upsample
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.core.inversion import InversionEngine
from red_diffeq_tpu_torch.io.checkpoints import (
    load_diffusion_params, load_params, save_params,
)
from red_diffeq_tpu_torch.models import trainer as ttrainer
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.utils.seed_utils import set_seed

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / 'tools'
CTX = dict(n_grid=16, nt=40, dx=10.0, dt=0.001, nbc=10, f=15.0, sz=10,
           gz=10, ng=16, ns=2)
HEIGHT, IMAGE, STEPS, N, TS = 16, 18, 20, 2, 3
UNET = dict(dim=8, dim_mults=(1, 2), channels=1)
LAMBDAS = {'none': 0.0, 'tv': 0.01}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The small U-Nets and solver run fastest on one thread, and the
    suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def Q():
    """``tools/torch_quality.py`` at the tests' size."""
    q = _tool('torch_quality')
    q.CTX, q.HEIGHT, q.UNET, q.IMAGE_SIZE, q.TIMESTEPS = (
        CTX, HEIGHT, UNET, IMAGE, STEPS)
    return q


@pytest.fixture(scope='module')
def tools(Q):
    """The port's tools, importing the shrunk ``torch_quality``."""
    import sys
    sys.modules['torch_quality'] = Q
    mods = {n: _tool(f'torch_{n}') for n in (
        'eval_quality', 'compare_methods', 'milestone_eval', 'lambda_sweep',
        'pick_best_milestone', 'quality_seeds')}
    mods['compare_methods'].RED_TS = TS
    mods['compare_methods'].BENCH_KW = dict(
        mods['compare_methods'].BENCH_KW, ts=2, diffusion_ts=2)
    mods['lambda_sweep'].N, mods['lambda_sweep'].TS = N, TS
    mods['quality_seeds'].N, mods['quality_seeds'].TS = N, 2
    yield mods
    sys.modules.pop('torch_quality', None)


@pytest.fixture(scope='module')
def prior(tmp_path_factory, Q):
    """A checkpoint of the tests' U-Net: random weights, seeded."""
    torch.manual_seed(11)
    d = GaussianDiffusion(Unet(**UNET), image_size=IMAGE, timesteps=STEPS,
                          device='cpu')
    path = tmp_path_factory.mktemp('prior') / 'prior.ckpt'
    save_params(d.params, path)
    return path


def _jax_problem(obs):
    """The JAX tools' held-out problem at the tests' size."""
    v_true = jax_generate(N, h=HEIGHT, w=CTX['n_grid'], seed=7777)
    op = JaxFWI(CTX, normalize=True, v_denorm_func=jdt.v_denormalize,
                s_norm_func=jdt.s_normalize_none, backend='xla', chunk=20)
    ys = {}
    if 'clean' in obs:
        ys['clean'] = op(jdt.v_normalize(jnp.asarray(v_true)))
    if 'refined' in obs:
        op_obs = JaxFWI(jax_refined_ctx(CTX, factor=2), sample_temporal=2,
                        normalize=True, v_denorm_func=jdt.v_denormalize,
                        s_norm_func=jdt.s_normalize_none, backend='xla',
                        chunk=20)
        ys['refined'] = op_obs(jdt.v_normalize(jnp.asarray(
            jax_upsample(v_true, factor=2))))
    init = np.concatenate([
        jdt.prepare_initial_model(v_true[b:b + 1], 'smoothed', sigma=10.0)
        for b in range(N)])
    return v_true, op, ys, init


def test_warm_compile_signature_matches_jax():
    jax_params = list(inspect.signature(JaxEngine.warm_compile).parameters
                      .values())
    port = list(inspect.signature(InversionEngine.warm_compile).parameters
                .values())
    if port[-1].name == 'device':
        port = port[:-1]
    assert [(p.name, p.default, p.kind) for p in port] == [
        (p.name, p.default, p.kind) for p in jax_params]


def _run(engine, prob, reg, generator, **kw):
    mu, pm = engine.optimize(prob.mu0, prob.v_true_t,
                             prob.observations['refined'], prob.op, ts=TS,
                             lr=0.03, reg_lambda=0.75, regularization=reg,
                             generator=generator, progress=False, **kw)
    return mu, pm


@pytest.mark.parametrize('half', [False, True], ids=['fp32', 'bf16'])
def test_optimize_after_warm_compile_is_bit_for_bit(Q, prior, half):
    """RED-DiffEq draws every step: a warm-up that drew from the caller's
    generator or the global sequence, or left any state behind, would
    change the run. Both with an explicit generator and with the global
    sequence (``set_seed``)."""
    prob = Q.held_out_problem('cpu', n=N, obs=('refined',), ckpt=prior)
    prob.diffusion.half_precision = half
    y = prob.observations['refined']
    runs = []
    for warm in (False, True):
        engine = InversionEngine(prob.diffusion, regularization='diffusion',
                                 device='cpu')
        gen = Q.draws('cpu')
        set_seed(5)
        if warm:
            rec = engine.warm_compile(prob.mu0.shape, y.shape, prob.op,
                                      ts=TS, reg_lambda=0.75)
            assert rec['backend'] == rec['route'] == 'plain'
            assert rec['launches'] == {} and rec['seconds'] > 0
        runs.append((_run(engine, prob, None, gen),
                     _run(engine, prob, None, None)))
    for got in runs[1:]:
        for (mu_a, pm_a), (mu_b, pm_b) in zip(runs[0], got):
            assert torch.equal(mu_a, mu_b)
            for a, b in zip(pm_a, pm_b):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_warm_compile_checks_and_route(Q, prior):
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    prob = Q.held_out_problem('cpu', n=N, obs=(), ckpt=prior)
    shape = (N, CTX['ns'], CTX['nt'], CTX['ng'])
    bare = InversionEngine(None, regularization='diffusion', device='cpu')
    with pytest.raises(ValueError, match='Diffusion model required'):
        bare.warm_compile(prob.mu0.shape, shape, prob.op)
    with pytest.raises(ValueError, match='Unknown regularization'):
        bare.warm_compile(prob.mu0.shape, shape, prob.op,
                          regularization='bogus')
    with pytest.raises(ValueError, match='Batch size mismatch'):
        bare.warm_compile(prob.mu0.shape, (N + 1,) + shape[1:], prob.op,
                          regularization='tv')
    engine = InversionEngine(prob.diffusion, regularization='diffusion',
                             device='cpu')
    with pytest.raises(KeyError, match='bogus'):
        engine.warm_compile(prob.mu0.shape, shape, prob.op,
                            params_template={'bogus': np.zeros(3)})
    wrong = prob.diffusion.params
    wrong['init_conv']['bias'] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match='shape'):
        engine.warm_compile(prob.mu0.shape, shape, prob.op,
                            params_template=wrong)
    engine.warm_compile(prob.mu0.shape, shape, prob.op,
                        params_template=prob.diffusion.params)
    # The kernel backend names its adjoint route, as the t2 guard picks it:
    # on the CPU its wrappers run their plain versions and count nothing.
    for nbc, route in ((60, 'reverse'), (10, 'tape')):
        op = FWIForward(dict(CTX, nbc=nbc), v_denorm_func=Q.v_denormalize,
                        s_norm_func=Q.s_normalize_none, backend='kernel',
                        device='cpu')
        rec = bare.warm_compile(prob.mu0.shape, shape, op, ts=TS,
                                regularization='tv')
        assert (rec['backend'], rec['route'], rec['launches']) == (
            'kernel', route, {})


def test_held_out_problem_matches_jax(Q, prior):
    prob = Q.held_out_problem('cpu', n=N, obs=('clean', 'refined'),
                              ckpt=prior)
    v_true, _, ys, init = _jax_problem(('clean', 'refined'))
    np.testing.assert_array_equal(prob.v_true, v_true)
    np.testing.assert_array_equal(prob.init, init)
    np.testing.assert_array_equal(
        prob.mu0.numpy(), np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1))))
    assert list(prob.observations) == ['clean', 'refined']
    for name, y in ys.items():
        want = np.asarray(y)
        got = prob.observations[name].numpy()
        assert got.shape == want.shape == (N, CTX['ns'], CTX['nt'],
                                           CTX['ng'])
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    assert prob.backend == 'plain'
    torch.manual_seed(0)
    other = GaussianDiffusion(Unet(**UNET), image_size=IMAGE,
                              timesteps=STEPS, device='cpu')
    load_diffusion_params(other, prior)
    for (n, a), b in zip(prob.diffusion.model.named_parameters(),
                         other.model.parameters()):
        assert torch.equal(a, b), n


def test_eval_quality_rows_match_jax_engine(tools, prior, tmp_path, capsys):
    out = tmp_path / 'quality.md'
    results = tools['eval_quality'].main([
        '--n', str(N), '--ts', str(TS), '--width', str(CTX['n_grid']),
        '--obs', 'refined', '--regs', 'none', 'tv', '--ckpt', str(prior),
        '--device', 'cpu', '--out', str(out), '--save_curves',
        str(tmp_path / 'curves')])
    printed = capsys.readouterr().out
    assert json.loads([ln for ln in printed.splitlines()
                       if ln.startswith('{')][0]) == results
    v_true, op, ys, init = _jax_problem(('refined',))
    mu0 = jnp.pad(jnp.asarray(init), ((0, 0), (0, 0), (1, 1), (1, 1)))
    for reg, lam in LAMBDAS.items():
        engine = JaxEngine(None, regularization=reg, sigma_x0=1e-4)
        _, pm = engine.optimize(
            mu0, jnp.asarray(v_true), ys['refined'], op, ts=TS, lr=0.03,
            reg_lambda=lam, regularization=None if reg == 'none' else reg,
            key=jax.random.PRNGKey(8888), use_scan=True, progress=False)
        got = results[f'refined/{reg}']
        for k in ('MAE', 'SSIM'):
            want = float(np.mean([m[k.lower()][-1] for m in pm]))
            np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                       err_msg=f'{reg} {k}')
        curves = np.load(tmp_path / 'curves' / f'refined_{reg}.npz')
        assert curves['ssim'].shape == (N, TS)
    table = out.read_text()
    assert 'backend=plain' in table and 'Card: none (cpu)' in table
    assert table.count('| refined |') == 2


def _jax_keys(name):
    """String keys of the JAX tool's dict literals that hold 'MAE' or
    'ckpt' (its JSON rows)."""
    tree = ast.parse((TOOLS / f'{name}.py').read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            ks = {k.value for k in node.keys
                  if isinstance(k, ast.Constant)}
            if ks & {'MAE', 'ckpt'}:
                keys |= ks
    return keys


def _jax_headers(name):
    """The JAX tool's markdown table header rows (string constants)."""
    tree = ast.parse((TOOLS / f'{name}.py').read_text())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith('| ') and n.value.endswith(' |')}


def _keys(obj, skip=('clean', 'refined')):
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            if k not in skip and '/' not in k:
                out.add(k)
            out |= _keys(v, skip)
        return out
    if isinstance(obj, list):
        return set().union(*map(_keys, obj)) if obj else set()
    return set()


def test_tools_keep_the_jax_keys_and_columns(tools, prior, tmp_path):
    """Each port tool's JSON keys and markdown header rows are the JAX
    tool's; compare_methods and lambda_sweep run the diffusion prior."""
    q = tools['eval_quality'].main([
        '--n', str(N), '--ts', '2', '--width', str(CTX['n_grid']), '--obs',
        'refined', '--regs', 'l2', 'diffusion', '--ckpt', str(prior),
        '--device', 'cpu', '--out', str(tmp_path / 'q.md')])
    assert list(q) == ['refined/l2', 'refined/diffusion']
    c = tools['compare_methods'].main([
        '--n', str(N), '--ckpt', str(prior), '--device', 'cpu', '--out',
        str(tmp_path / 'c.md')])
    assert list(c) == [f'{o}/{m}' for o in ('refined', 'clean')
                       for m in ('RED-DiffEq', 'DiffusionFWI', 'ILVR-FWI')]
    # The seeds tool repeats the eval tool's row at its seed, and its
    # draws move the row at another.
    rows, summary = tools['quality_seeds'].main([
        '--seeds', '8888', '3', '--ckpt', str(prior), '--device', 'cpu'])
    want = {k: q['refined/diffusion'][k] for k in ('MAE', 'RMSE', 'SSIM')}
    assert rows[0] == want and rows[1] != want
    assert summary['SSIM']['min'] <= want['SSIM'] <= summary['SSIM']['max']
    sweep = tools['lambda_sweep'].main([str(prior), '0.5,0.1', '--device',
                                        'cpu'])
    assert [r['lambda'] for r in sweep] == [0.5, 0.1]
    for name, got, md in (('eval_quality', q, 'q.md'),
                          ('compare_methods', c, 'c.md'),
                          ('lambda_sweep', sweep, None)):
        assert _keys(got) == _jax_keys(name), name
        if md:
            table = (tmp_path / md).read_text().splitlines()
            assert _jax_headers(name) <= set(table), name
        for row in (got.values() if isinstance(got, dict) else got):
            assert all(np.isfinite(v) for v in row.values()
                       if isinstance(v, float))


def test_loss_curve_summary_equals_jax(tools, tmp_path):
    jax_tool = _tool('milestone_eval')
    rng = np.random.RandomState(3)
    for n, milestone in ((2600, 2), (37, 5)):
        run = tmp_path / f'run{n}'
        run.mkdir()
        losses = [{'step': i, 'loss': float(v)}
                  for i, v in enumerate(rng.rand(n))]
        (run / f'training_losses-{milestone}.json').write_text(json.dumps(
            {'step': n, 'milestone': milestone, 'losses': losses}))
        (run / 'training_losses-1.json').write_text(json.dumps(
            {'losses': [{'step': 0, 'loss': 9.0}]}))
        got = tools['milestone_eval'].loss_curve_summary(run)
        assert got == jax_tool.loss_curve_summary(run) and got
    assert tools['milestone_eval'].loss_curve_summary(tmp_path) == []


def _tiny_trainer(folder, steps, seed):
    torch.manual_seed(seed)
    d = GaussianDiffusion(Unet(**UNET), image_size=IMAGE, timesteps=STEPS,
                          device='cpu')
    images = np.random.RandomState(seed).rand(8, 1, IMAGE, IMAGE).astype(
        np.float32)
    return ttrainer.Trainer(
        d, ttrainer.TensorDataset(images), train_batch_size=4,
        gradient_accumulate_every=4, train_lr=1e-2, train_num_steps=steps,
        save_and_sample_every=2, num_samples=4, ema_update_every=1,
        ema_decay=0.5, results_folder=str(folder), seed=seed)


def test_milestones_of_a_port_trainer_evaluate_and_pick(tools, prior,
                                                         tmp_path, capsys):
    """A 4-step port ``Trainer`` run writes milestones 1 and 2; the
    milestone tool evaluates them and the shipped-prior stand-in, orders
    rows by step, writes the loss summary, and the pick exports an EMA
    that both packages' loaders read."""
    from red_diffeq_tpu.io.checkpoints import \
        load_diffusion_params as jax_load
    from red_diffeq_tpu.models.diffusion import \
        GaussianDiffusion as JaxDiffusion
    from red_diffeq_tpu.models.unet import Unet as JaxUnet
    run = tmp_path / 'run'
    _tiny_trainer(run, 4, 3).train(log_every=100)
    ckpts = [run / 'model-2.ckpt', prior, run / 'model-1.ckpt']
    out = tmp_path / 'milestones.md'
    rows = tools['milestone_eval'].main([
        '--ckpts', *map(str, ckpts), '--run', str(run), '--n', str(N),
        '--ts', '2', '--out', str(out), '--device', 'cpu'])
    assert [r['step'] for r in rows] == [2, 4, '?']
    table = out.read_text()
    assert _jax_headers('milestone_eval') <= set(table.splitlines())
    assert '## Training loss (trailing-1k mean)' in table
    assert _keys(rows) == _jax_keys('milestone_eval')
    sidecar = json.loads(out.with_suffix('.json').read_text())
    assert sidecar == rows
    # The refined SSIMs differ between milestones: each run used its own
    # weights, not the first one's.
    assert len({r['refined']['SSIM'] for r in rows}) == 3

    picks = {}
    for name, tool in (('port', tools['pick_best_milestone']),
                       ('jax', _tool('pick_best_milestone'))):
        capsys.readouterr()
        tool.main(['--eval', str(out), '--out',
                   str(tmp_path / f'{name}.ckpt')])
        picks[name] = capsys.readouterr().out.splitlines()[0]
    assert picks['port'] == picks['jax']
    best = max(rows, key=lambda r: (r['refined']['SSIM'],
                                    r['clean']['SSIM']))
    assert best['ckpt'] in picks['port']
    state = load_params(best['ckpt'])
    want = state.get('ema_params', state)
    d = GaussianDiffusion(Unet(**UNET), image_size=IMAGE, timesteps=STEPS,
                          device='cpu')
    load_diffusion_params(d, tmp_path / 'port.ckpt')
    ref = GaussianDiffusion(Unet(**UNET), image_size=IMAGE,
                            timesteps=STEPS, params=want, device='cpu')
    for a, b in zip(d.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
    jd = JaxDiffusion(JaxUnet(**UNET), image_size=IMAGE, timesteps=STEPS)
    jax_load(jd, str(tmp_path / 'port.ckpt'), verbose=False)
    got = jax.tree_util.tree_leaves(jd.params)
    assert len(got) == len(jax.tree_util.tree_leaves(want))
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        got, jax.tree_util.tree_leaves(want)))


def test_swapping_milestones_refreshes_the_denoiser(tmp_path):
    """Assigning ``params`` copies a milestone's EMA into the U-Net, and
    the bf16 copy follows: the output after a swap is a fresh bundle's on
    that milestone, in fp32 and in bf16."""
    run = tmp_path / 'run'
    _tiny_trainer(run, 4, 5).train(log_every=100)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 1, IMAGE, IMAGE).astype(np.float32))
    t = torch.tensor([3, 11])
    d = GaussianDiffusion(Unet(**UNET), image_size=IMAGE, timesteps=STEPS,
                          device='cpu')
    outs = {}
    for half in (False, True):
        d.half_precision = half
        for k in (1, 2, 1):
            d.params = load_params(run / f'model-{k}.ckpt')['ema_params']
            got = d.apply_fn(x, t)
            fresh = GaussianDiffusion(
                Unet(**UNET), image_size=IMAGE, timesteps=STEPS,
                params=load_params(run / f'model-{k}.ckpt')['ema_params'],
                half_precision=half, device='cpu')
            assert torch.equal(got, fresh.apply_fn(x, t)), (half, k)
            outs[half, k] = got
        assert not torch.equal(outs[half, 1], outs[half, 2])
    tree = d.params
    again = GaussianDiffusion(Unet(**UNET), image_size=IMAGE,
                              timesteps=STEPS, params=tree, device='cpu')
    for a, b in zip(d.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
