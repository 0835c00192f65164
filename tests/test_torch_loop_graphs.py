"""The port's one-program loops as bodies on fixed buffers, on the CPU.

On the card DiffusionFWI's and ILVR-FWI's denoise, blend, inner FWI step
and metrics, the samplers' and RED's post-process chain's step, and the
trainer's train step are CUDA graphs, captured once and replayed
(``core/graphs.py``); on the CPU the same bodies run eagerly. These tests
hold each loop to a copy of the host loop it replaced (kept here as the
reference, bit for bit with the same draws, drawn or fed) and to the JAX
function with JAX's draws fed in, at the existing parity tests'
tolerances: the methods' final model atol 3e-5 and curves rtol 1e-4
(``tests/test_torch_bench_methods.py``), the samplers and the post-process
atol 1e-5 / rtol 1e-4 (``tests/test_torch_diffusion.py``), the trainer's
K-step losses and parameters rtol 1e-4 against JAX's ``_train_multi_idx``
(``tests/test_torch_trainer.py``). A :class:`StepGraph` of a generic body
raises on the CPU and, with the capture stubbed, counts launches only
through the capture.
"""
import contextlib
import copy
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from red_diffeq_tpu.bench_methods import ilvr_fwi as jilvr
from red_diffeq_tpu.models import diffusion as jdiff
from red_diffeq_tpu.models import trainer as jtrainer
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu.regularization.red import \
    RED_DiffEq_POST_PROCESS as JaxPost
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.bench_methods import diffusion_fwi as tfwi
from red_diffeq_tpu_torch.bench_methods import ilvr_fwi as tilvr
from red_diffeq_tpu_torch.bench_methods.filters import (
    clip_total_norm, gaussian_blur_3x3, gaussian_smooth,
)
from red_diffeq_tpu_torch.core import graphs
from red_diffeq_tpu_torch.core.inversion import Adam, constant_schedule
from red_diffeq_tpu_torch.core.losses import observation_loss
from red_diffeq_tpu_torch.core.metrics import calculate_metrics
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
from red_diffeq_tpu_torch.models import trainer as ttrainer
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.ops import stencil
from red_diffeq_tpu_torch.regularization.red import RED_DiffEq_POST_PROCESS
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
from red_diffeq_tpu_torch.utils import data_trans as tdt
from red_diffeq_tpu_torch.utils.data_trans import (
    add_noise_to_seismic, missing_trace, v_normalize,
)

CURVES = tfwi.CURVES


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tt(a):
    return torch.from_numpy(np.array(a))


def _pair(image_size, timesteps, **kw):
    """A dim-8 (1, 2) denoiser in both packages, the port's with the JAX
    weights."""
    jd = jdiff.GaussianDiffusion(JaxUnet(dim=8, dim_mults=(1, 2),
                                         channels=1),
                                 image_size=image_size, timesteps=timesteps,
                                 **kw)
    jd.init_params(jax.random.PRNGKey(0))
    unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
    unet.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            jd.params)), unet))
    return jd, GaussianDiffusion(unet, image_size=image_size,
                                 timesteps=timesteps, device='cpu', **kw)


# -- the generic graph -----------------------------------------------------

@pytest.fixture
def stub_capture(monkeypatch):
    """torch.cuda's stream, synchronisation and graph calls replaced by
    no-ops, so that a StepGraph is built on the CPU: its warm-up and its
    "capture" both run the body; a replay runs nothing."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)

        def reset(self):
            pass

    stream = types.SimpleNamespace(wait_stream=lambda s: None)
    for name, value in (
            ('device', lambda dev: contextlib.nullcontext()),
            ('Stream', lambda dev=None: stream),
            ('current_stream', lambda dev=None: stream),
            ('stream', lambda s: contextlib.nullcontext()),
            ('synchronize', lambda dev=None: None),
            ('empty_cache', lambda: None),
            ('memory_reserved', lambda dev=None: 0),
            ('CUDAGraph', Graph),
            ('graph', lambda g, stream=None: contextlib.nullcontext()),
            ('is_available', lambda: True)):
        monkeypatch.setattr(torch.cuda, name, value)
    return replays


def _counting_body(device, calls):
    """A body that stands for a kernel wrapper: each run adds 2 launches of
    ``fwd_step`` and one of ``sum_shots``, and appends to ``calls``."""
    def fn():
        calls.append(1)
        stencil.launches['fwd_step'] += 2
        stencil.launches['sum_shots'] += 1
    return graphs.Body(fn, device)


def test_graph_cache_keeps_one_graph_of_each_kind(stub_capture):
    """A cache with ``kind`` releases the graphs that a new key of the same
    kind replaces (their pool) and keeps the other kinds'."""
    cache = graphs.GraphCache(kind=lambda key: key[0])
    body = _counting_body('cuda', [])
    before = graphs.launch_counts()
    made = {}
    for key in (('ddim', 4), ('ancestral', 4), ('ddim', 16)):
        made[key] = graphs.loop_graphs(cache, key, 1, 'cuda', lambda: 's')
        made[key].run('step', body)
    graphs._set_counts(before)
    assert len(cache) == 2 and cache.captures == 3
    assert made[('ddim', 4)].graphs == {}
    assert list(made[('ancestral', 4)].graphs) == ['step']
    assert list(made[('ddim', 16)].graphs) == ['step']
    assert graphs.loop_graphs(cache, ('ancestral', 4), 1, 'cuda',
                              None) is made[('ancestral', 4)]


def test_a_copied_bundle_keeps_graphs_of_its_own():
    """A shallow copy of a bundle (the trainer's EMA bundle, a replica)
    samples through a graph cache of its own, one graph a chain kind; the
    weights' stamp moves with an in-place change of a parameter."""
    td = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=SIZE,
                           timesteps=4, device='cpu')
    twin = copy.copy(td)
    assert twin._graphs is not td._graphs and twin._bf16 is None
    assert twin._graphs.kind(('ddim', 1)) == td._graphs.kind(('ddim', 2))
    stamp = td.weights_stamp()
    with torch.no_grad():
        next(td.model.parameters()).add_(0.0)
    assert td.weights_stamp() != stamp


def test_a_milestone_releases_the_train_and_sampler_graphs(tmp_path):
    """``_sample_and_save`` releases the train step's graph before the EMA
    bundle samples and the sampler's graphs after, so that the card holds
    one set of pools at a time."""
    torch.manual_seed(0)
    td = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=SIZE,
                           timesteps=T_TRAIN, device='cpu')
    tr = _trainer(td, tmp_path)
    assert tr.ema_diffusion._graphs is not td._graphs
    released = []
    tr._graphs.put(('train',), 1, types.SimpleNamespace(
        release=lambda: released.append('train')))
    tr.ema_diffusion._graphs.put(('ddim',), 1, types.SimpleNamespace(
        release=lambda: released.append('chain')))
    tr._sample_and_save(1)
    assert released == ['train', 'chain']
    assert len(tr._graphs) == 0 and len(tr.ema_diffusion._graphs) == 0
    assert (tmp_path / 'model-1.ckpt').exists()


def test_step_graph_of_a_generic_body_raises_on_the_cpu():
    calls = []
    with pytest.raises(RuntimeError, match='CUDA device'):
        graphs.StepGraph(_counting_body('cpu', calls))
    assert calls == []
    assert not graphs.graphed('cpu')


def test_step_graph_counts_launches_only_through_the_capture(stub_capture):
    calls = []
    before = graphs.launch_counts()
    n = graphs.captures['n']
    g = graphs.StepGraph(_counting_body('cuda', calls))
    # The warm-up (a real step) counts; the capture's launches become one
    # replay's, not the counters'.
    assert len(calls) == 2 and graphs.captures['n'] == n + 1
    assert g.launches == {'fwd_step': 2, 'sum_shots': 1}
    after = graphs.launch_counts()
    assert after['fwd_step'] == before['fwd_step'] + 2
    assert after['sum_shots'] == before['sum_shots'] + 1
    for _ in range(3):
        g.replay()
    assert len(calls) == 2 and len(stub_capture) == 3
    now = graphs.launch_counts()
    assert now['fwd_step'] == before['fwd_step'] + 8
    assert now['sum_shots'] == before['sum_shots'] + 4
    graphs._set_counts(before)


def test_loop_graphs_capture_once_and_eager_loops_capture_none(stub_capture):
    cache = graphs.GraphCache()
    calls = []
    assert graphs.graphed('cuda')
    loops = graphs.loop_graphs(cache, 'key', 1, 'cuda', lambda: 'state')
    body = _counting_body('cuda', calls)
    before = graphs.launch_counts()
    for i in range(4):
        loops.run('step', body, capture=i + 1 < 4)
    # Warm-up and capture, then three replays.
    assert len(calls) == 2 and len(stub_capture) == 3
    assert graphs.loop_graphs(cache, 'key', 1, 'cuda', None) is loops
    assert list(loops.info()) == ['step'] and cache.captures == 1
    # Another stamp (new weights) drops the graphs.
    again = graphs.loop_graphs(cache, 'key', 2, 'cuda', lambda: 'state')
    assert again is not loops and loops.graphs == {}
    with graphs.eager_loops():
        with graphs.eager_loops():
            assert not graphs.graphed('cuda')
        assert not graphs.graphed('cuda')
        eager = graphs.loop_graphs(cache, 'key', 2, 'cuda', lambda: 'x')
        assert eager.state == 'x' and eager is not again
        for _ in range(3):
            eager.run('step', body)
    assert graphs.graphed('cuda') and eager.graphs == {}
    assert len(calls) == 5 and len(stub_capture) == 3
    graphs._set_counts(before)
    # A one-step loop is not captured.
    one = graphs.LoopGraphs('s', True)
    one.run('step', body, capture=False)
    assert one.graphs == {} and len(calls) == 6
    graphs._set_counts(before)


# -- the competitor methods ------------------------------------------------

N, NT, NS, NBC = 16, 50, 2, 8
CTX = dict(n_grid=N, nt=NT, dx=10.0, dt=0.001, nbc=NBC, f=15.0, sz=10,
           gz=10, ng=N, ns=NS)
TS, DTS = 2, 3


@pytest.fixture(scope='module')
def bench_pair():
    return _pair(18, 12)


@pytest.fixture(scope='module')
def bench_problem():
    v_true = np.full((2, 1, N, N), 2000.0, np.float32)
    v_true[0, :, 8:] = 3000.0
    v_true[1, :, 5:] = 2600.0
    mu0 = np.asarray(jdt.v_normalize(
        np.full((2, 1, N, N), 2400.0, np.float32)))
    top = FWIForward(CTX, v_denorm_func=tdt.v_denormalize,
                     s_norm_func=lambda s: s, backend='plain', chunk=10,
                     device='cpu')
    with torch.no_grad():
        y = top(tdt.v_normalize(torch.from_numpy(v_true)))
    return v_true, mu0, y, top


def host_fwi_loop(method, mu, y, mask, ts, lr, grad_norm, grad_smooth,
                  model_blur, grad_clip):
    """The host loop that DiffusionFWI's inner step replaced (a copy)."""
    optimizer = Adam(constant_schedule(lr))
    state = optimizer.init(mu)
    smooth = grad_smooth is not None and grad_smooth > 0
    has_grad_max = bool(grad_norm) or smooth
    clip = grad_clip is not None and grad_clip > 0 and has_grad_max
    grad_max = torch.zeros((), dtype=torch.float32, device=mu.device)
    for it in range(ts):
        x = mu.detach().requires_grad_(True)
        g, = torch.autograd.grad(
            observation_loss(method.fwi_forward(x), y, mask).sum(), x)
        if grad_norm:
            if it == 0:
                grad_max = g.abs().max()
            g = torch.where(grad_max > 0, g / grad_max, g)
        if smooth:
            g = gaussian_smooth(g, grad_smooth)
            grad_max = g.abs().max()
        if clip:
            g = torch.where(grad_max > 0,
                            clip_total_norm(g, grad_clip * grad_max), g)
        updates, state = optimizer.update(g, state)
        mu = mu + updates
        if model_blur:
            mu = gaussian_blur_3x3(mu)
        mu = mu.clamp(-1.0, 1.0)
    return mu


@torch.no_grad()
def host_ilvr_hook(method, denoised, prev_model, step, generator,
                   ilvr_noise):
    """The host-loop ILVR blend that the blend program replaced (a copy)."""
    if not method.use_ilvr or step <= 0:
        return denoised
    lowpass = method._lowpass(denoised.shape, method.down_n[step])
    t = torch.full((denoised.shape[0],), step, dtype=torch.long)
    if ilvr_noise is not None:
        noise = ilvr_noise[step]
    else:
        noise = torch.randn(prev_model.shape, generator=generator,
                            dtype=prev_model.dtype)
    noised_current = method.diffusion_model.q_sample(prev_model, t, noise)
    conditioned = (denoised
                   - method.ilvr_weight * lowpass(denoised)
                   + method.ilvr_weight * lowpass(noised_current))
    return conditioned.clamp(-1.0, 1.0)


def host_optimize(method, mu, mu_true, y, op, *, ts, diffusion_ts, lr,
                  noise_std=0.0, missing_number=0, grad_norm=True,
                  grad_smooth=None, model_blur=False, grad_clip=1.0,
                  use_patches=False, patch_kernel_size=None,
                  patch_stride=None, generator=None, ilvr=None,
                  ilvr_noise=None):
    """DiffusionFWI's (with ``ilvr``, ILVR-FWI's) host loop before the
    loops became graphs (a copy): the same denoise, the inner loop and the
    metrics, one PyTorch call at a time."""
    method.fwi_forward = op
    if ilvr is not None:
        method.use_ilvr, method.ilvr_weight = True, ilvr['ilvr_weight']
        method.down_n = tilvr.ilvr_down_schedule(ilvr['ilvr_down_schedule'],
                                                 diffusion_ts)
    mu = torch.as_tensor(mu, dtype=torch.float32)
    mu_true_norm = v_normalize(torch.as_tensor(mu_true, dtype=torch.float32))
    y = add_noise_to_seismic(torch.as_tensor(y), noise_std,
                             generator=generator)
    y, mask = missing_trace(y, missing_number, generator=generator)
    current, history = mu, []
    for step in range(diffusion_ts - 1, -1, -1):
        prev = current
        current = method._apply_diffusion_denoising_with_patches(
            current, step, kernel_size=patch_kernel_size,
            stride=patch_stride, use_patches=use_patches)
        if ilvr is not None:
            current = host_ilvr_hook(method, current, prev, step, generator,
                                     ilvr_noise)
        if step != 0:
            current = host_fwi_loop(method, current, y, mask, ts, lr,
                                    grad_norm, grad_smooth, model_blur,
                                    grad_clip)
        with torch.no_grad():
            obs = observation_loss(method.fwi_forward(current), y, mask)
        mae, rmse, ssim_v = calculate_metrics(current, mu_true_norm)
        history.append(dict(total_losses=obs, obs_losses=obs, mae=mae,
                            rmse=rmse, ssim=ssim_v))
    curves = {k: torch.stack([h[k] for h in history]).numpy()
              for k in CURVES}
    return current.detach(), [{k: list(curves[k][:, i]) for k in CURVES}
                              for i in range(mu.shape[0])]


METHOD_CASES = {
    'all_tricks': (None, dict(grad_norm=True, grad_smooth=1.0,
                              model_blur=True, grad_clip=1.1,
                              noise_std=0.05, missing_number=3)),
    'no_tricks': (None, dict(grad_norm=False, grad_smooth=None,
                             model_blur=False, grad_clip=1.0)),
    'ilvr_linear': (dict(ilvr_weight=0.1, ilvr_down_schedule='linear'),
                    dict(grad_smooth=1.0, model_blur=True)),
    'ilvr_stepwise': (dict(ilvr_weight=0.1, ilvr_down_schedule='stepwise'),
                      dict(grad_norm=True)),
    # The ablation presets' other flag sets, each trick alone.
    'grad_norm': (None, dict(grad_norm=True, grad_smooth=None,
                             model_blur=False, grad_clip=1.0)),
    'grad_smooth': (None, dict(grad_norm=False, grad_smooth=1.0,
                               model_blur=False, grad_clip=1.0)),
    'model_blur': (None, dict(grad_norm=False, grad_smooth=None,
                              model_blur=True, grad_clip=1.0)),
    # The dt300_ts1 depth: one inner step an outer step, so every inner
    # step starts Adam's state anew.
    'ts1': (None, dict(ts=1, diffusion_ts=4, grad_norm=True, grad_smooth=1.0,
                       model_blur=True, grad_clip=1.0)),
    # Twelve outer steps: each of the stepwise factors 4, 8, 16 and 32
    # blends at two or more of them.
    'ilvr_stepwise_12': (dict(ilvr_weight=0.1,
                              ilvr_down_schedule='stepwise'),
                         dict(ts=1, diffusion_ts=12, grad_norm=True,
                              grad_smooth=1.0, model_blur=True)),
}


def _same_run(got, want):
    assert torch.equal(got[0], want[0])
    for c, w in zip(got[1], want[1]):
        for k in CURVES:
            np.testing.assert_array_equal(np.asarray(c[k]),
                                          np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize('case', sorted(METHOD_CASES))
def test_method_programs_repeat_the_host_loop(bench_pair, bench_problem,
                                              case):
    """The denoise, blend, inner-step and metrics bodies, run eagerly, give
    the host loop's final model and curves bit for bit, the draws (the
    corruption's and ILVR's) from one generator seed; twice on one method,
    so that the second run goes through the kept buffers' reload."""
    _, td = bench_pair
    v_true, mu0, y, top = bench_problem
    ilvr, kw = METHOD_CASES[case]
    common = {**dict(ts=TS, diffusion_ts=DTS, lr=0.05), **kw}
    cls = tfwi.DiffusionFWI if ilvr is None else tilvr.ILVR_FWI
    method = cls(td, top, device='cpu')
    for _ in range(2):
        got = method.optimize(mu0, v_true, y, top, progress=False,
                              generator=torch.Generator().manual_seed(3),
                              **common, **(ilvr or {}))
        want = host_optimize(cls(td, top, device='cpu'), mu0, v_true, y,
                             top, generator=torch.Generator().manual_seed(3),
                             ilvr=ilvr, **common)
        _same_run(got, want)


def test_patched_method_repeats_the_host_loop(bench_pair):
    """A 16x44 model in 16x20 windows at stride (1, 12)."""
    _, td = bench_pair
    w = 44
    ctx = dict(CTX, nt=40, ng=w, gx=list(range(w)), sx=[5, 38])
    top = FWIForward(ctx, v_denorm_func=tdt.v_denormalize,
                     s_norm_func=lambda s: s, backend='plain', chunk=10,
                     device='cpu')
    v_true = np.full((1, 1, N, w), 2000.0, np.float32)
    v_true[:, :, 9:] = 2800.0
    mu0 = np.asarray(jdt.v_normalize(np.full_like(v_true, 2400.0)))
    with torch.no_grad():
        y = top(tdt.v_normalize(torch.from_numpy(v_true)))
    common = dict(ts=TS, diffusion_ts=DTS, lr=0.05, grad_smooth=1.0,
                  use_patches=True, patch_kernel_size=[16, 20],
                  patch_stride=[1, 12])
    got = tfwi.DiffusionFWI(td, top, device='cpu').optimize(
        mu0, v_true, y, top, progress=False, **common)
    want = host_optimize(tfwi.DiffusionFWI(td, top, device='cpu'), mu0,
                         v_true, y, top, **common)
    _same_run(got, want)


def test_ilvr_programs_match_jax_with_fed_draws(bench_pair, bench_problem):
    """ILVR-FWI (every program: the denoise, the blend, the inner step,
    the metrics) against the JAX method with its draws fed in."""
    jd, td = bench_pair
    v_true, mu0, y, top = bench_problem
    jop = JaxFWI(CTX, normalize=True, v_denorm_func=jdt.v_denormalize,
                 s_norm_func=lambda s: s, backend='xla', chunk=10)
    key = jax.random.PRNGKey(6)
    common = dict(ts=TS, diffusion_ts=DTS, lr=0.05, grad_smooth=1.0,
                  model_blur=True, ilvr_weight=0.1,
                  ilvr_down_schedule='linear', progress=False)
    jmu, jcurves = jilvr.ILVR_FWI(jd, jop).optimize(
        jnp.asarray(mu0), jnp.asarray(v_true), jnp.asarray(y.numpy()), jop,
        key=key, **common)
    step_key, _, _ = jax.random.split(key, 3)
    ilvr_noise = torch.stack([_tt(jax.random.normal(
        jax.random.fold_in(step_key, s), mu0.shape)) for s in range(DTS)])
    mu, curves = tilvr.ILVR_FWI(td, top, device='cpu').optimize(
        mu0, v_true, y, top, ilvr_noise=ilvr_noise, **common)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=3e-5,
                               rtol=0)
    for c, jc in zip(curves, jcurves):
        for k in CURVES:
            np.testing.assert_allclose(np.asarray(c[k]), np.asarray(jc[k]),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


# -- the samplers and the post-process chain -------------------------------

SIZE = 16


@pytest.fixture(scope='module')
def ddpm_pair():
    return _pair(SIZE, 5)


@pytest.fixture(scope='module', params=[0.0, 0.5], ids=['eta0', 'eta05'])
def ddim_pair(request):
    return _pair(SIZE, 20, sampling_timesteps=4,
                 ddim_sampling_eta=request.param)


def _host_draw(d, noise, i, shape, generator):
    if noise is not None:
        return noise[i]
    return torch.randn(shape, generator=generator)


def host_p_sample_loop(d, shape, generator=None, noise=None,
                       return_all_timesteps=False):
    """The ancestral chain's host loop (a copy)."""
    img = _host_draw(d, noise, 0, shape, generator)
    trail = [img]
    for i, t in enumerate(range(d.num_timesteps - 1, -1, -1)):
        img, _ = d.p_sample(img, t, noise=_host_draw(d, noise, i + 1, shape,
                                                     generator))
        if return_all_timesteps:
            trail.append(img)
    if return_all_timesteps:
        img = torch.stack(trail, dim=1)
    return d.unnormalize(img)


@torch.no_grad()
def host_ddim_sample(d, shape, generator=None, noise=None,
                     return_all_timesteps=False):
    """DDIM's host loop (a copy)."""
    total, eta = d.num_timesteps, d.ddim_sampling_eta
    times = np.linspace(-1, total - 1,
                        d.sampling_timesteps + 1).astype(int)[::-1]
    ac = d.schedule.alphas_cumprod
    img = _host_draw(d, noise, 0, shape, generator)
    trail = [img]
    for i, (time, time_next) in enumerate(zip(times[:-1], times[1:])):
        pred_noise, x_start = d.model_predictions(
            img, d._batch_t(img, time), clip_x_start=True,
            rederive_pred_noise=True)
        step_noise = _host_draw(d, noise, i + 1, shape, generator)
        if time_next < 0:
            img = x_start
        else:
            alpha, alpha_next = ac[time], ac[time_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next)
                                     * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt((1 - alpha_next - sigma ** 2).clamp_min(0.0))
            img = (x_start * torch.sqrt(alpha_next) + c * pred_noise
                   + sigma * step_noise)
        if return_all_timesteps:
            trail.append(img)
    if return_all_timesteps:
        img = torch.stack(trail, dim=1)
    return d.unnormalize(img)


@torch.no_grad()
def host_interpolate(d, x1, x2, generator=None, t=None, lam=0.5,
                     noise=None):
    """interpolate's host loop (a copy)."""
    t = d.num_timesteps - 1 if t is None else t
    bt = d._batch_t(x1, t)
    xt1 = d.q_sample(x1, bt, _host_draw(d, noise, 0, x1.shape, generator))
    xt2 = d.q_sample(x2, bt, _host_draw(d, noise, 1, x1.shape, generator))
    img = (1 - lam) * xt1 + lam * xt2
    for i, ti in enumerate(range(t - 1, -1, -1)):
        img, _ = d.p_sample(
            img, ti, noise=_host_draw(d, noise, i + 2, x1.shape, generator))
    return img


@torch.no_grad()
def host_diffusion_denoise(d, mu, timesteps, generator=None, noise=None):
    """RED's post-process chain's host loop (a copy)."""
    mu01 = (mu + 1.0) / 2.0
    t_full = torch.full((mu.shape[0],), min(timesteps, d.num_timesteps - 1),
                        dtype=torch.long)
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, dtype=mu.dtype)
    x_t = d.unnormalize(d.q_sample(d.normalize(mu01), t_full, noise))
    for ti in range(timesteps - 1, -1, -1):
        x_norm, _ = d.p_sample_deterministic(d.normalize(x_t), ti)
        x_t = d.unnormalize(x_norm)
    return x_t


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize('trail', [False, True], ids=['last', 'trail'])
@pytest.mark.parametrize('fed', [False, True], ids=['drawn', 'fed'])
def test_sampler_chains_repeat_the_host_loop(ddpm_pair, ddim_pair, trail,
                                             fed):
    """The chain's step, run eagerly from a device count, equals the host
    loop bit for bit: the ancestral chain and DDIM (eta 0 and 0.5, its
    last step's flag a table), the last image and the trail, the draws
    from one generator seed (all made before the chain) or fed."""
    shape = (2, 1, SIZE, SIZE)
    for (_, d), host, fn in ((ddpm_pair, host_p_sample_loop,
                              'p_sample_loop'),
                             (ddim_pair, host_ddim_sample, 'ddim_sample')):
        steps = (d.sampling_timesteps if fn == 'ddim_sample'
                 else d.num_timesteps)
        noise = torch.randn((steps + 1, *shape), generator=_gen(9))
        kw = dict(noise=noise) if fed else {}
        got = getattr(d, fn)(shape, generator=_gen(4),
                             return_all_timesteps=trail, **kw)
        want = host(d, shape, generator=_gen(4),
                    return_all_timesteps=trail, **kw)
        assert got.shape == want.shape
        assert torch.equal(got, want), fn


@pytest.mark.parametrize('fed', [False, True], ids=['drawn', 'fed'])
def test_interpolate_and_post_process_repeat_the_host_loop(ddpm_pair, fed):
    _, d = ddpm_pair
    rng = np.random.RandomState(3)
    x1, x2, mu = (torch.from_numpy(rng.uniform(
        -1, 1, (2, 1, SIZE, SIZE)).astype(np.float32)) for _ in range(3))
    noise = torch.randn((5, 2, 1, SIZE, SIZE), generator=_gen(8))
    for t in (3, 0):
        kw = dict(noise=noise[:t + 2]) if fed else {}
        got = d.interpolate(x1, x2, generator=_gen(5), t=t, lam=0.3, **kw)
        want = host_interpolate(d, x1, x2, generator=_gen(5), t=t, lam=0.3,
                                **kw)
        assert torch.equal(got, want), t
    post = RED_DiffEq_POST_PROCESS(d)
    kw = dict(noise=noise[0]) if fed else {}
    for steps in (4, 0):
        got = post.diffusion_denoise(mu, steps, generator=_gen(6), **kw)
        want = host_diffusion_denoise(d, mu, steps, generator=_gen(6), **kw)
        assert torch.equal(got, want), steps


def _jax_chain_draws(key, shape, steps):
    key, init_key = jax.random.split(key)
    return torch.stack([_tt(jax.random.normal(init_key, shape))]
                       + [_tt(jax.random.normal(k, shape))
                          for k in jax.random.split(key, steps)])


def test_ddim_matches_jax_with_fed_draws(ddim_pair):
    """DDIM with its trail against the JAX package's ``lax.scan`` chain."""
    jd, td = ddim_pair
    key = jax.random.PRNGKey(11)
    want = np.asarray(jd.sample(batch_size=2, key=key,
                                return_all_timesteps=True))
    got = td.sample(2, noise=_jax_chain_draws(key, (2, 1, SIZE, SIZE), 4),
                    return_all_timesteps=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_chains_match_jax_with_fed_draws(ddpm_pair):
    """The ancestral chain, interpolate and the post-process against the
    JAX package's ``lax.scan`` chains."""
    shape = (2, 1, SIZE, SIZE)
    tol = dict(atol=1e-5, rtol=1e-4)
    jd, td = ddpm_pair
    key = jax.random.PRNGKey(12)
    np.testing.assert_allclose(
        td.sample(2, noise=_jax_chain_draws(key, shape, 5)).numpy(),
        np.asarray(jd.sample(batch_size=2, key=key)), **tol)
    rng = np.random.RandomState(4)
    x1, x2, mu = (rng.uniform(-1, 1, shape).astype(np.float32)
                  for _ in range(3))
    key = jax.random.PRNGKey(13)
    want = jd.interpolate(jnp.asarray(x1), jnp.asarray(x2), key, t=3,
                          lam=0.3)
    key, k1, k2 = jax.random.split(key, 3)
    draws = torch.stack([_tt(jax.random.normal(k, shape))
                         for k in (k1, k2, *jax.random.split(key, 3))])
    got = td.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), t=3,
                         lam=0.3, noise=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    key = jax.random.PRNGKey(14)
    want = JaxPost(jd).diffusion_denoise(jnp.asarray(mu), 4, key)
    _, kn = jax.random.split(key)
    got = RED_DiffEq_POST_PROCESS(td).diffusion_denoise(
        torch.from_numpy(mu), 4, noise=_tt(jax.random.normal(kn, shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# -- the trainer's K steps a call -------------------------------------------

T_TRAIN = 8


def _images(seed, n):
    return np.random.RandomState(seed).rand(n, 1, SIZE, SIZE).astype(
        np.float32)


def _trainer(td, tmp_path, **kw):
    args = dict(train_batch_size=8, gradient_accumulate_every=2,
                train_lr=1e-3, train_num_steps=6, save_and_sample_every=3,
                num_samples=4, ema_update_every=2, seed=3,
                results_folder=str(tmp_path))
    args.update(kw)
    tr = ttrainer.Trainer(td, ttrainer.TensorDataset(_images(1, 24)),
                          **args)
    tr.ema_cfg.update_after_step = 2
    return tr


def host_train(tr, log_every=100, steps_per_call=20):
    """``Trainer.train``'s host loop before the K steps became a body (a
    copy): k calls of ``train_step`` a call, milestones between calls."""
    if tr._device_data and tr._data_dev is None:
        tr._data_dev = torch.from_numpy(tr.dataset.data).to(tr.device)
    while tr.step < tr.train_num_steps:
        to_milestone = tr.save_and_sample_every - (
            tr.step % tr.save_and_sample_every)
        k = min(max(1, int(steps_per_call)), tr.train_num_steps - tr.step,
                to_milestone)
        for _ in range(k):
            step = tr.step
            loss = tr.train_step(tr._next_batches())
            tr._pending.append((step, loss))
        if tr.step % log_every < k:
            tr._flush_losses()
        if tr.step % tr.save_and_sample_every == 0:
            tr._sample_and_save(tr.step // tr.save_and_sample_every)
    tr._flush_losses()


TRAIN_CASES = {
    'resident': dict(),
    'host_batches_offset': dict(device_data=False, offset=0.1),
    'one_micro_batch': dict(gradient_accumulate_every=1, train_batch_size=16),
}


@pytest.mark.parametrize('case', sorted(TRAIN_CASES))
def test_train_calls_repeat_the_host_loop(tmp_path, case):
    """Two calls of 3 steps (a milestone after each: the ancestral sampler
    from the trainer's generator) against the host loop: the losses, the
    weights, the EMA (a copy, then the decay), Adam's moments and count,
    both streams' states and the milestones' samples, bit for bit."""
    kw = dict(TRAIN_CASES[case])
    ons = kw.pop('offset', 0.0)
    runs = []
    for graphed in (True, False):
        torch.manual_seed(0)
        td = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)),
                               image_size=SIZE, timesteps=T_TRAIN,
                               offset_noise_strength=ons, device='cpu')
        tr = _trainer(td, tmp_path / str(graphed), **kw)
        if graphed:
            tr.train(log_every=2, steps_per_call=4)
        else:
            host_train(tr, log_every=2, steps_per_call=4)
        runs.append(tr)
    got, want = runs
    assert got.training_losses == want.training_losses
    assert [e['step'] for e in got.training_losses] == list(range(6))
    assert got.step == want.step == 6
    assert got.optimizer.count == want.optimizer.count == 6
    for a, b in ((got.params, want.params), (got.ema_params, want.ema_params),
                 (got.optimizer.mu, want.optimizer.mu),
                 (got.optimizer.nu, want.optimizer.nu)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(e, p) for e, p in zip(got.ema_params,
                                                     got.params))
    assert torch.equal(got._gen.get_state(), want._gen.get_state())
    assert got._np_rng.randint(1 << 30) == want._np_rng.randint(1 << 30)
    for m in (1, 2):
        np.testing.assert_array_equal(
            np.load(tmp_path / 'True' / f'sample-{m}.npy'),
            np.load(tmp_path / 'False' / f'sample-{m}.npy'))


def test_train_call_matches_jax_train_multi_idx(tmp_path, monkeypatch):
    """One call of K = 3 steps (2 micro-batches each, the EMA's copy and
    decay both reached) against JAX's ``_train_multi_idx`` on the same
    weights, batch indices and draws (JAX's keys' draws fed in): each
    step's loss, the weights and the EMA weights rtol 1e-4 (atol 1e-6),
    but for the biases of the convolutions that a GroupNorm follows: their
    gradient is all but rounding (the norm takes a shift of its group
    away), which Adam's normalised step turns into a different step in
    each package. The first step's clipped, averaged gradient of every
    leaf, those biases' included, is held against JAX's at rtol 1e-4,
    atol 1e-6 (``test_torch_trainer.py``'s), and those biases' weights to
    the K steps' bound on Adam's step (lr each)."""
    k_steps, a, b = 3, 2, 8
    jd, td = _pair(SIZE, T_TRAIN)
    data = _images(2, 24)
    tr = ttrainer.Trainer(td, ttrainer.TensorDataset(data),
                          train_batch_size=b, gradient_accumulate_every=a,
                          train_lr=1e-3, ema_update_every=1, seed=7,
                          results_folder=str(tmp_path))
    cfg = jtrainer.EMAConfig(decay=0.995, update_every=1,
                             update_after_step=1)
    tr.ema_cfg.update_after_step = cfg.update_after_step
    fake = types.SimpleNamespace(
        diffusion=jd, grad_accum=a, ema_cfg=cfg, amp=False,
        optimizer=optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adam(1e-3, b1=0.9, b2=0.99)))
    fake._make_train_step = lambda: jtrainer.Trainer._make_train_step(fake)
    multi = jax.jit(jtrainer.Trainer._make_train_multi_idx(fake))
    idx = np.random.RandomState(7).randint(0, len(data), size=(k_steps, a, b))
    key = jax.random.PRNGKey(21)
    params = jd.params
    params_j, _, ema_j, step_j, losses_j = multi(
        params, fake.optimizer.init(params),
        jax.tree.map(jnp.copy, params), 0, jnp.asarray(idx, jnp.int32), key,
        jnp.asarray(data))
    assert int(step_j) == k_steps
    draws = []
    for k in jax.random.split(key, k_steps):
        for km in jax.random.split(k, a):
            km, kt = jax.random.split(km)
            _, k_noise, _ = jax.random.split(km, 3)
            draws.append(dict(
                t=_tt(jax.random.randint(kt, (b,), 0, T_TRAIN)).long(),
                noise=_tt(jax.random.normal(k_noise, (b, 1, SIZE, SIZE)))))
    init = [p.detach().numpy().copy() for p in tr.params]
    clipped = []
    clip = ttrainer.clip_by_global_norm

    def spy(grads, max_norm):
        norm = clip(grads, max_norm)
        clipped.append([g.detach().numpy().copy() for g in grads])
        return norm

    monkeypatch.setattr(ttrainer, 'clip_by_global_norm', spy)
    tr._data_dev = torch.from_numpy(data)
    tr._np_rng = types.SimpleNamespace(
        randint=lambda lo, hi, size, _it=iter(idx.reshape(-1, b)): next(_it))
    tr._train_call(k_steps, k_steps, draws)
    got = [float(v) for _, v in tr._pending]
    np.testing.assert_allclose(got, np.asarray(losses_j), rtol=1e-4)
    assert len(clipped) == k_steps
    # JAX's first step: the micro-batches' gradients summed as its scan
    # adds them, over their number, then the clip.
    vg = jax.jit(jax.value_and_grad(jd.loss))
    g_sum = None
    for j, km in enumerate(jax.random.split(
            jax.random.split(key, k_steps)[0], a)):
        g = vg(params, jnp.asarray(data[idx[0, j]]), km)[1]
        g_sum = g if g_sum is None else jax.tree.map(jnp.add, g_sum, g)
    clip_j = optax.clip_by_global_norm(1.0)
    grads_j = clip_j.update(jax.tree.map(lambda x: x / a, g_sum),
                            clip_j.init(params))[0]
    want_g = flax_to_state_dict(jax.tree.map(
        np.asarray, flax.serialization.to_state_dict(grads_j)), td.model)
    assert any(n.endswith('.proj.bias') for n in tr.names)
    for name, g in zip(tr.names, clipped[0]):
        np.testing.assert_allclose(g, want_g[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    lr = 1e-3
    for mine, theirs in ((tr.params, params_j), (tr.ema_params, ema_j)):
        sd = flax_to_state_dict(jax.tree.map(
            np.asarray, flax.serialization.to_state_dict(theirs)),
            td.model)
        for name, p, p0 in zip(tr.names, mine, init):
            got, want = p.detach().numpy(), sd[name].numpy()
            if name.endswith('.proj.bias'):
                # A GroupNorm follows: the gradient is mostly rounding,
                # which Adam scales to steps of up to lr in either
                # package. Both moved, within the K steps' bound.
                for v in (got, want):
                    assert np.abs(v - p0).max() <= k_steps * lr * 1.01, name
                continue
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
