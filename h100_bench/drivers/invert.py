"""Driver ``invert``: RED-DiffEq inversion jobs through the CLI's per-batch
function, back to back.

Set-up makes the jobs' models and observations (the benchmark's own plain
solver on the refined grid) and the U-Net's weights from the seed, builds
the program as ``red-diffeq-torch-invert`` does (the denoiser, the forward
operator, the engine) and calls ``InversionEngine.warm_compile``, which
builds the kernels and captures the step's CUDA graph. The window runs
jobs of ``ts`` steps, each a fresh batch and generator, through
``cli.run_inversion.process_batch`` (the graphed ``optimize``), and starts
no job once ``--seconds`` have passed: s/sample is the window's seconds
over the samples it inverted. A traced run's window is ``trace_jobs``
jobs.

The output check (after the window, the program freed): a chaotic
optimisation (one-ulp differences grow to whole steps through Adam's
sign-like first steps) cannot be followed for 300 steps by an independent
reference, so the reference follows the run's first ``follow_steps``
steps from the shared inputs, and checks its end from the program's own
output. Start: step 0's observation loss (the initial model and the
forward solver) and RED loss (the U-Net's score) and the fit after step 0
(the adjoint and Adam's first, sign-like, update); then the losses of the
following steps (each with that step's own draws) and the fit after each
(Adam's moments and bias corrections over the adjoint's gradients of
several steps). End: the output's observation loss, and where RED scores
the unpadded model (on windows) its RED loss, with the last step's draws
(the last rate is under 1e-6, so the output is the state that step saw),
and the output's fit, against the run's own last curves.
"""
import copy
import time

import numpy as np
import torch

from h100_bench.lib import counts, faults, harness, inputs, tracing
from h100_bench.reference import diffusion as rdiff, inversion as rinv
from h100_bench.reference import solver as rsolver
from h100_bench.reference.arith import Arith, fp32_math
from h100_bench.reference.unet import Unet as RefUnet

SECTIONS = ('pde', 'model', 'diffusion', 'optimization', 'data',
            'experiment', 'tpu')
CURVES = ('obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


def program_config(cfg):
    from red_diffeq_tpu_torch.config import ConfigDict
    return ConfigDict({k: copy.deepcopy(cfg[k]) for k in SECTIONS})


def job_seed(seed: int, j: int) -> int:
    return inputs.subseed(seed, 'job', j)


def build(cfg, dev, weights):
    """The program as the inversion CLI builds it, with ``weights``."""
    from red_diffeq_tpu_torch.cli import run_inversion as cli
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    config = program_config(cfg)
    d = cli.build_diffusion_model(config, load_weights=False, device=dev)
    d.model.load_state_dict(weights)
    fwi = cli.build_forward_operator(config, device=dev)
    o = config.optimization
    engine = InversionEngine(
        d, regularization=o.regularization,
        use_time_weight=bool(o.get('use_time_weight', False)),
        sigma_x0=float(o.get('sigma_x0', 0.0001)),
        fixed_timestep=o.get('fixed_timestep', None), device=dev)
    return config, d, fwi, engine


def shapes_of(cfg):
    p = cfg['pde']
    b, rows, w = cfg['data']['batch_size'], cfg['model_rows'], p['n_grid']
    return (b, 1, rows + 2, w + 2), (b, p['ns'], p['nt'], p['ng'])


def run(cell, dev, seed, seconds, trace, t_start) -> harness.Outcome:
    from red_diffeq_tpu_torch.cli.run_inversion import process_batch
    from red_diffeq_tpu_torch.ops import stencil
    cfg, tr = cell['config'], cell['traffic']
    opt, ts = cfg['optimization'], cfg['optimization']['ts']
    mu_shape, y_shape = shapes_of(cfg)
    t_inputs = time.perf_counter()
    jobs = inputs.invert_jobs(cfg['pde'], mu_shape[0], tr['pool'],
                              cfg['model_rows'], seed, dev)
    weights = inputs.unet_weights(cfg['model'], seed, dev)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_build = time.perf_counter()

    config, diff, fwi, engine = build(cfg, dev, weights)
    before = dict(stencil.launches)
    with torch.no_grad():
        fwi(torch.zeros(mu_shape[0], 1, mu_shape[2] - 2, mu_shape[3] - 2,
                        device=dev))
    forward_keys = [k for k, n in stencil.launches.items() if n > before[k]]
    seen = {}

    def precision(*_):
        seen.setdefault('tf32', torch.backends.cudnn.allow_tf32)

    hook = diff.model.init_conv.register_forward_pre_hook(precision)
    t_warm = time.perf_counter()
    warm = engine.warm_compile(mu_shape, y_shape, fwi, ts=ts, lr=opt['lr'],
                               reg_lambda=opt['reg_lambda'],
                               regularization=opt['regularization'],
                               use_scan=bool(cfg['tpu']['use_scan']))
    hook.remove()
    graphs = engine.graph_info()
    setup_s = time.perf_counter() - t_start

    spans = tracing.Spans(trace, dev)
    done = []
    t0 = time.perf_counter()
    with spans.window():
        while (len(done) < tr['trace_jobs'] if trace else
               not done or time.perf_counter() - t0 < seconds):
            j = len(done)
            vel, seis = jobs[j % len(jobs)]
            gen = torch.Generator(device=dev).manual_seed(job_seed(seed, j))
            with spans.span('job'):
                mu, per_model, _ = process_batch(seis, vel, config, engine,
                                                 fwi, generator=gen)
            done.append((j, mu, per_model))
    window_s = time.perf_counter() - t0
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
              else 0)
    print(f'set-up {setup_s:.3f} s (imports {t_inputs - t_start:.3f}, '
          f'inputs {t_build - t_inputs:.3f}, build {t_warm - t_build:.3f}, '
          f'warm-up {t0 - t_warm:.3f}), window {window_s:.3f} s, '
          f'{len(done)} jobs of {mu_shape[0]}; '
          f'warm_compile {warm["seconds"]:.3f} s, '
          f'route {warm["route"]}, graphs {graphs}; the U-Net ran with '
          f'cudnn.allow_tf32={seen.get("tf32")}', flush=True)

    b = mu_shape[0]
    solver = counts.solver_pass(b, cfg['pde']['ns'],
                                mu_shape[2] - 2 + 2 * cfg['pde']['nbc'],
                                mu_shape[3] - 2 + 2 * cfg['pde']['nbc'],
                                cfg['pde']['nt'], cfg['pde']['ng'])
    windows = (len(rdiff.windows(mu_shape[3] - 2, mu_shape[2] - 2))
               if max(mu_shape[2:]) > cfg['diffusion']['image_size'] else 1)
    unet_batch = b * windows
    m = cfg['model']
    context = dict(
        trace=spans.trace, steps=len(done) * ts, solver=solver,
        solver_keys=list(stencil.launches), forward_keys=forward_keys,
        unet_flops_per_step=counts.unet_flops(
            m['dim'], m['dim_mults'], cfg['diffusion']['image_size'],
            unet_batch),
        unet_precision='tf32' if seen.get('tf32') else 'fp32',
        warm_compile_s=warm['seconds'])
    metrics = {'inversion_s_per_sample': window_s / (len(done) * b),
               'setup_s': setup_s}

    engine.release_graphs()
    del engine, diff, fwi
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    pick = np.random.RandomState(inputs.subseed(seed, 'check')).permutation(
        len(done))[:tr['check_jobs']]
    checks, failed = {}, 0
    for i in sorted(pick):
        j, mu, per_model = done[i]
        vel, seis = jobs[j % len(jobs)]
        curves = {k: np.array([pm[k] for pm in per_model]).T for k in CURVES}
        got = check_job(cfg, tr, weights, vel, seis, job_seed(seed, j), dev,
                        dict(mu=mu, curves=curves))
        bad = False
        for k, v in got.items():
            lim = tr['limits'][k]
            bad |= not (v <= lim)
            if k not in checks or not (v <= checks[k][0]):
                checks[k] = (v, lim)
        failed += bad
    return harness.Outcome(metrics=metrics, context=context, checks=checks,
                           attempted=len(done), failed=failed,
                           memory_peak_bytes=int(memory), trace=spans.trace)


def draws(cfg, jseed, dev, keep):
    """The job's draws at the steps in ``keep``, made as the engine makes
    them: per step the ``sigma_x0`` noise, RED's timesteps and noise (of
    the unpadded shape where RED runs on windows), from a generator seeded
    with the job's seed."""
    mu_shape, _ = shapes_of(cfg)
    b, c, h, w = mu_shape
    patched = max(h, w) > cfg['diffusion']['image_size']
    noise_shape = (b, c, h - 2, w - 2) if patched else mu_shape
    gen = torch.Generator(device=dev).manual_seed(jseed)
    out = {}
    for i in range(cfg['optimization']['ts']):
        d = {'x0_noise': torch.randn(mu_shape, generator=gen, device=dev),
             't': torch.randint(0, cfg['diffusion']['timesteps'], (b,),
                                generator=gen, device=dev),
             'reg_noise': torch.randn(noise_shape, generator=gen, device=dev)}
        if i in keep:
            out[i] = d
    return out


def reference_problem(cfg, weights, vel, seis, dev, ar):
    unet = RefUnet(dim=cfg['model']['dim'],
                   dim_mults=tuple(cfg['model']['dim_mults']), ar=ar).to(dev)
    unet.load_state_dict(weights)
    o = cfg['optimization']
    return rinv.Problem(
        cfg['pde'], torch.from_numpy(seis).to(dev),
        rsolver.v_normalize(torch.from_numpy(vel).to(dev)), unet,
        rdiff.Schedule(cfg['diffusion']['timesteps'], dev), o['reg_lambda'],
        o['sigma_x0'], o['lr'], o['ts'], cfg['diffusion']['image_size'])


def patched(cfg) -> bool:
    """Whether RED scores the model on windows of its unpadded part (a
    model wider than the denoiser's input)."""
    _, _, h, w = shapes_of(cfg)[0]
    return max(h, w) > cfg['diffusion']['image_size']


def follow(p, mu0, dr, steps, ar):
    """The reference's first ``steps`` steps from the padded ``mu0`` with
    empty moments: each step's report."""
    mu = torch.from_numpy(mu0).to(dr[0]['t'].device)
    m = v = torch.zeros_like(mu)
    reports = []
    for k in range(steps):
        mu, m, v, r = rinv.step(p, mu, m, v, k, dr[k], ar)
        reports.append(r)
    return reports


def check_job(cfg, tr, weights, vel, seis, jseed, dev, prog) -> dict:
    """The numbers of one job: ``prog`` holds what the timed path returned
    (``mu``, the output; ``curves``, (ts, B) per curve). The initial
    model enters through step 0's losses: the reference makes its own."""
    ts, n = cfg['optimization']['ts'], tr['follow_steps']
    with fp32_math():
        ar = Arith()
        p = reference_problem(cfg, weights, vel, seis, dev, ar)
        mu0 = rinv.initial_model(vel, cfg['optimization']['sigma'])
        dr = draws(cfg, jseed, dev, set(range(n)) | {ts - 1})
        reports = follow(p, mu0, dr, n, ar)
        out = prog['mu'].to(dev)
        last = dr[ts - 1]
        with torch.no_grad():
            x0 = out + p.sigma_x0 * last['x0_noise'][:, :, 1:-1, 1:-1]
            obs_end = rinv.l1(rsolver.forward(x0, p.ctx, ar), p.y)
            fit_end = rinv.fit(out, p.target, ar)
            if patched(cfg):
                reg_end = rdiff.red_loss(
                    p.unet, p.sched, torch.nn.functional.pad(x0, (1,) * 4),
                    last['t'], last['reg_noise'], p.input_size)
    c = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in prog['curves'].items()}

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    def fit_gap(row, ref):
        mae, rmse, ssim = ref
        return max(rel(c['mae'][row], mae), rel(c['rmse'][row], rmse),
                   float((c['ssim'][row] - ssim).abs().max()))

    def reg_gap(row, ref):
        reg, scale = ref
        return float(((c['reg_losses'][row] - reg).abs() / scale).max())

    def fit_of(r):
        return r['mae'], r['rmse'], r['ssim']

    r0, rest = reports[0], range(1, n)
    got = {
        'obs0': rel(c['obs_losses'][0], r0['obs']),
        'reg0': reg_gap(0, (r0['reg'], r0['scale'])),
        'fit1': fit_gap(0, fit_of(r0)),
        'obs_next': max(rel(c['obs_losses'][i], reports[i]['obs'])
                        for i in rest),
        'reg_next': max(reg_gap(i, (reports[i]['reg'], reports[i]['scale']))
                        for i in rest),
        'fit_next': max(fit_gap(i, fit_of(reports[i])) for i in rest),
        'obs_end': rel(c['obs_losses'][ts - 1], obs_end),
        'fit_end': fit_gap(ts - 1, fit_end),
    }
    if patched(cfg):
        got['reg_end'] = reg_gap(ts - 1, reg_end)
    return got


def control_outputs(cfg, tr, weights, vel, seis, jseed, dev) -> dict:
    """The reference in TF32 put in the program's place: what it returns
    for the numbers ``check_job`` reads: the first ``follow_steps`` steps
    from the initial model, and the last step from the initial model with
    Adam's count at its last value and empty moments (the last step's
    numbers depend on that step alone)."""
    ts, n = cfg['optimization']['ts'], tr['follow_steps']
    b = vel.shape[0]
    with fp32_math():
        ar = Arith(tf32=True)
        p = reference_problem(cfg, weights, vel, seis, dev, ar)
        mu0 = rinv.initial_model(vel, cfg['optimization']['sigma'])
        dr = draws(cfg, jseed, dev, set(range(n)) | {ts - 1})
        rows = dict(enumerate(follow(p, mu0, dr, n, ar)))
        mu = torch.from_numpy(mu0).to(dev)
        zeros = torch.zeros_like(mu)
        out, _, _, rows[ts - 1] = rinv.step(p, mu, zeros, zeros, ts - 1,
                                            dr[ts - 1], ar)
    curves = {k: np.zeros((ts, b), np.float32) for k in CURVES}
    for row, r in rows.items():
        for k, name in (('obs_losses', 'obs'), ('reg_losses', 'reg'),
                        ('mae', 'mae'), ('rmse', 'rmse'), ('ssim', 'ssim')):
            curves[k][row] = r[name].cpu().numpy()
    return dict(mu=out[:, :, 1:-1, 1:-1], curves=curves)


def control(cell, dev, seed) -> dict:
    """The numbers of the control on the first job of ``seed``."""
    cfg = cell['config']
    mu_shape, _ = shapes_of(cfg)
    vel, seis = inputs.invert_jobs(cfg['pde'], mu_shape[0], 1,
                                   cfg['model_rows'], seed, dev)[0]
    weights = inputs.unet_weights(cfg['model'], seed, dev)
    js = job_seed(seed, 0)
    tr = cell['traffic']
    prog = control_outputs(cfg, tr, weights, vel, seis, js, dev)
    return check_job(cfg, tr, weights, vel, seis, js, dev, prog)


def fault(name: str):
    """The fault ``name`` of ``lib/faults.py`` planted in the program."""
    from red_diffeq_tpu_torch.core import inversion

    if name == 'unchanged':
        def make(orig):
            def update(self, grads, state):
                updates, state = orig(self, grads, state)
                return updates * 0.0, state
            return update
        return faults.patched(inversion.Adam, 'update', make)
    if name == 'half':
        def make(orig):
            def total(obs, reg, lam):
                tot = orig(obs, reg, lam)
                b = tot.shape[0]
                keep = tot.new_zeros(b)
                keep[:max(b // 2, 1)] = b / max(b // 2, 1)
                return tot * keep
            return total
        return faults.patched(inversion, 'total_loss', make)
    if name == 'altered':
        def make(orig):
            def optimize(self, *a, **kw):
                mu, curves = orig(self, *a, **kw)
                mu = mu.clone()
                mu[0] += 0.05
                return mu, curves
            return optimize
        return faults.patched(inversion.InversionEngine, 'optimize', make)
    if name == 'stale':
        from red_diffeq_tpu_torch.core import graphs

        def make(orig):
            def fill_draws(self, draw_fn, rows, *a, **kw):
                rows = list(rows)
                out = orig(self, draw_fn, rows, *a, **kw)
                for buf in self.draws.values():
                    buf[rows[1:]] = buf[rows[0]].clone()
                return out
            return fill_draws
        return faults.patched(graphs.StepBuffers, 'fill_draws', make)
    if name == 'b1':
        def make(orig):
            def update(self, grads, state):
                b1, self.b1 = self.b1, 0.8
                try:
                    return orig(self, grads, state)
                finally:
                    self.b1 = b1
            return update
        return faults.patched(inversion.Adam, 'update', make)
    if name == 'obsgrad':
        def make(orig):
            def loss(*a, **kw):
                obs = orig(*a, **kw)
                return 2.0 * obs - obs.detach()
            return loss
        return faults.patched(inversion, 'observation_loss', make)
    raise ValueError(name)
