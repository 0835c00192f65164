#!/usr/bin/env python3
"""Drive the PyTorch port of RED-DiffEq on one NVIDIA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its wall time:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``red_diffeq_tpu_torch/ops/csrc`` with nvcc;
3. the forward kernel ``fwd_step`` against its plain PyTorch version at the
   headline shape (B=4, ns=5, 310x310, chunk 20, nt=1000), full
   seismogram: rtol 2e-5 / atol 1e-7;
4. the adjoint kernel ``bwd_reverse_step`` against its plain version chunk
   by chunk over a whole reverse pass (max-rel 2e-5 per output), and the
   velocity gradient of a masked-L1 observation loss through the kernels
   against plain eager autograd (max-rel 1e-4);
5. the tape kernels at the same shape, with the taped route forced:
   ``tape_step`` against its plain version on every slot of every chunk's
   tape of one pass, ``bwd_tape_step`` against its plain version chunk by
   chunk over a whole reverse pass (max-rel 2e-5 per output), and the
   velocity gradient under ``adjoint='tape'`` against ``'reverse'``
   (max-rel 1e-4; at nbc=120 both adjoints are valid);
6. a small inversion (16x16 model, dim-8 U-Net) run on the card through
   the kernels and on the CPU through the plain path with the same draws:
   mu atol 1e-4 (Adam divides each gradient by its own RMS, so a relative
   gradient error shows up scaled by the 0.03 step), losses and metrics
   rtol 1e-4;
7. the slice: the shipped prior read by the port's own reader, observations
   from the refined operator as ``bench.py`` makes them, and a few
   RED-DiffEq steps of ``InversionEngine.optimize`` at the headline
   settings, where the t2 guard takes the tape-free adjoint, with the
   forward and that adjoint launched every step, the tape kernels never
   and the plain path unused; then the same steps with the taped adjoint
   forced, for its time per step;
8. the narrow-sponge slice: the headline settings with nbc=40, where the
   guard itself takes the taped adjoint. The velocity gradient through the
   tape kernels against plain eager autograd (max-rel 1e-4), then a few
   RED-DiffEq steps with the tape kernels launched every step, the
   tape-free adjoint never and the plain path unused.

Then one JSON line with each kernel's launches (from the slice that takes
its route), error, times and bound, the card's line from nvidia-smi, and
last ``{"ok": true, "device": ...}``.
Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""
import json
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(n_grid=70, nt=1000, dx=10.0, dt=0.001, nbc=120, f=15.0,
                sz=10, gz=10, ng=70, ns=5)
# A narrow sponge: the bound on min(t2) falls below the guard (any nbc <= 55
# at dx=10, dt=1e-3), so the solver takes the taped adjoint by itself.
NARROW = dict(HEADLINE, nbc=40)
BATCH, CHUNK, TS = 4, 20, 20
CKPT = 'pretrained_models/model-synthetic-ema.ckpt'
SOURCE = 'red_diffeq_tpu_torch/ops/csrc/stencil.cu'
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor
# cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


class Phase:
    """Print a phase's wall time when it ends; an exception ends the run."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f'== {self.name}', flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            import torch
            torch.cuda.synchronize()
            print(f'phase {self.name}: {time.perf_counter() - self.t0:.2f} s',
                  flush=True)
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    between CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def headline_problem(dev):
    import torch
    import torch.nn.functional as F
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    geom = acoustic.Geometry.from_ctx(HEADLINE)
    n = HEADLINE['n_grid']
    v_true = generate_mixed_dataset(BATCH, h=n, w=n, seed=8888)
    v_pad = F.pad(torch.from_numpy(v_true).to(dev), (geom.nbc,) * 4,
                  mode='replicate')
    alpha, t1, t2, beta_pts = acoustic.coefficients(v_pad, geom)
    inj = stencil.build_injection_field(beta_pts, geom.isx,
                                        v_pad.shape[-1]).contiguous()
    src = acoustic.source_chunks(geom, CHUNK, dev)
    geo = dict(isz=geom.isz, igz=geom.igz, g0=geom.igx[0], ng=geom.ng)
    return dict(v_true=v_true, alpha=alpha, t1=t1, t2=t2,
                inj=inj, src=src, geo=geo,
                shape=(BATCH, geom.ns, *v_pad.shape[-2:]))


def forward_pass(fn, p, keep=False):
    """Every chunk of one forward through ``fn``; returns the seismogram
    (B, ns, steps, ng) and, with ``keep``, every chunk-boundary carry."""
    import torch
    p0 = torch.zeros(p['shape'], device=p['alpha'].device)
    p1 = torch.zeros_like(p0)
    carries, recs = [(p0, p1)], []
    for src_chunk in p['src']:
        p0, p1, r = fn(p0, p1, p['alpha'], p['t1'], p['t2'], p['inj'],
                       src_chunk, **p['geo'])
        recs.append(r)
        if keep:
            carries.append((p0, p1))
    return torch.cat(recs, dim=2), carries


def bounds(p, steps, n_calls):
    """Least time (ms) for each kernel's work over one full pass, by bytes
    (each input read once and each output written once per chunk call) and
    by fp32 operations, counted from the kernels' arithmetic."""
    b, ns, h, w = p['shape']
    ng, chunk = p['geo']['ng'], CHUNK
    field, coef, row, recs = b * ns * h * w, b * h * w, b * ns * w, \
        b * ns * chunk * ng
    fwd_ops = steps * (14 * field + 2 * row)
    work = {
        'fwd_step': (4 * n_calls * (4 * field + 3 * coef + row + chunk
                                    + recs), fwd_ops),
        'bwd_reverse_step': (
            4 * n_calls * (6 * field + recs + 6 * coef + 2 * row + chunk),
            steps * (35 * field + coef + b * ns * ng + 2 * row)),
        # The replay reads the start carry and writes the chunk + 2 slots.
        'tape_step': (4 * n_calls * ((chunk + 4) * field + 3 * coef + row
                                     + chunk), fwd_ops),
        # The taped adjoint needs tape slots 0 .. chunk (not the chunk-end
        # state), the two cotangents in and the two out.
        'bwd_tape_step': (
            4 * n_calls * ((chunk + 5) * field + recs + 6 * coef + row
                           + chunk),
            steps * (30 * field + b * ns * ng + 2 * row)),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_FP32_PER_S * 1e3
        out[name] = dict(bound_ms=max(by_bytes, by_ops),
                         bound_by='bytes' if by_bytes >= by_ops
                         else 'operations', bytes=nbytes, ops=ops)
    return out


def phase_forward(p):
    import torch
    from red_diffeq_tpu_torch.ops import stencil

    seis_k, carries_k = forward_pass(stencil.fwd_chunk, p, keep=True)
    seis_p, carries_p = forward_pass(stencil.fwd_chunk_plain, p, keep=True)
    torch.testing.assert_close(seis_k, seis_p, rtol=2e-5, atol=1e-7)
    for (a0, a1), (b0, b1) in zip(carries_k, carries_p):
        torch.testing.assert_close(a0, b0, rtol=2e-5, atol=1e-7)
        torch.testing.assert_close(a1, b1, rtol=2e-5, atol=1e-7)
    err = max(float((seis_k - seis_p).abs().max()),
              float((carries_k[-1][1] - carries_p[-1][1]).abs().max()))
    check(torch.isfinite(seis_k).all() and float(seis_k.abs().max()) > 0,
          'forward seismogram is not finite or is all zero')
    print(f'fwd_step vs plain: seismogram {tuple(seis_k.shape)}, '
          f'max abs err {err:.3e} (max |seis| '
          f'{float(seis_p.abs().max()):.3e})', flush=True)
    ms = cuda_ms(lambda: forward_pass(stencil.fwd_chunk, p), 5)
    plain_ms = cuda_ms(lambda: forward_pass(stencil.fwd_chunk_plain, p), 2)
    print(f'fwd pass ({seis_k.shape[2]} steps): kernel {ms:.3f} ms, plain '
          f'{plain_ms:.3f} ms', flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms), carries_k, seis_k


def random_grecs(p):
    """One random receiver cotangent (B, ns, chunk, ng) per chunk."""
    import torch
    dev = p['alpha'].device
    gen = torch.Generator(device=dev).manual_seed(4)
    return [torch.randn((*p['shape'][:2], CHUNK, p['geo']['ng']),
                        generator=gen, device=dev)
            for _ in range(len(p['src']))]


def check_outputs(kernel, names, got, want, where):
    """Gate each output at max-rel 2e-5; return the largest abs error."""
    err = 0.0
    for name, o, w in zip(names, got, want):
        r = max_rel(o, w)
        check(r <= 2e-5, f'{kernel} {where} {name}: max-rel {r:.3e} > 2e-5')
        err = max(err, float((o - w).abs().max()))
    return err


GRADS = ('gp0', 'gp1', 'galpha', 'gt1', 'gt2', 'ginj')


def velocity_grad(ctx, backend, mu, y, mask, **kw):
    """Gradient of a masked-L1 observation loss w.r.t. the normalised
    velocity ``mu``, through ``FWIForward(ctx, backend=backend, **kw)``."""
    from red_diffeq_tpu_torch.core.losses import observation_loss
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize,
    )
    op = FWIForward(ctx, v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend=backend,
                    chunk=CHUNK, device=mu.device, **kw)
    x = mu.clone().requires_grad_(True)
    observation_loss(op(x), y, mask).sum().backward()
    return x.grad


def gradient_problem(v_true, y):
    """A model near the truth ``v_true`` (m/s), and the observations ``y``
    with a few receivers masked out."""
    import torch
    from red_diffeq_tpu_torch.utils.data_trans import v_normalize
    mask = torch.ones_like(y)
    mask[:, :, :, 10:13] = 0.0
    v = torch.from_numpy(v_true).to(y.device)
    return v_normalize(v) * 0.97, y, mask


def reverse_pass(p, fn, chunk_args, compare=None, kernel=None):
    """Sweep the carry's cotangent through every chunk from the last, with
    ``fn(*chunk_args(i, gp0, gp1), **geo)``; with ``compare``, gate each
    chunk's outputs against it and return the largest abs error."""
    import torch
    gp0 = torch.zeros(p['shape'], device=p['alpha'].device)
    gp1 = torch.zeros_like(gp0)
    err = 0.0
    for i in range(len(p['src']) - 1, -1, -1):
        args = chunk_args(i, gp0, gp1)
        out = fn(*args, **p['geo'])
        if compare is not None:
            err = max(err, check_outputs(kernel, GRADS, out,
                                         compare(*args, **p['geo']),
                                         f'chunk {i}'))
        gp0, gp1 = out[0], out[1]
    return err


def time_reverse_pass(p, name, fn, plain_fn, chunk_args):
    """Gate kernel ``name`` (wrapper ``fn``) against ``plain_fn`` over a
    whole reverse pass, then time both passes."""
    err = reverse_pass(p, fn, chunk_args, compare=plain_fn, kernel=name)
    print(f'{name} vs plain over {len(p["src"])} chunks: max abs err '
          f'{err:.3e}', flush=True)
    ms = cuda_ms(lambda: reverse_pass(p, fn, chunk_args), 5)
    plain_ms = cuda_ms(lambda: reverse_pass(p, plain_fn, chunk_args), 2)
    print(f'{name} pass ({len(p["src"]) * CHUNK} steps): kernel {ms:.3f} '
          f'ms, plain {plain_ms:.3f} ms', flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_adjoint(p, carries, grad_problem):
    from red_diffeq_tpu_torch.ops import stencil

    grecs = random_grecs(p)
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    res = time_reverse_pass(
        p, 'bwd_reverse_step', stencil.bwd_reverse_chunk,
        stencil.bwd_reverse_chunk_plain,
        lambda i, gp0, gp1: (*carries[i + 1], gp0, gp1, grecs[i], *coef,
                             p['src'][i]))
    # Velocity gradient of a masked-L1 observation loss: kernels vs plain
    # eager autograd through the checkpointed plain path.
    res['grad_max_rel'] = compare_grads(
        HEADLINE, *grad_problem, 'kernels vs plain autograd', ('plain', {}))
    return res


def compare_grads(ctx, mu, y, mask, label, ref, **kw):
    """Velocity gradient through the kernel backend (``kw`` for its
    ``FWIForward``) against ``ref`` = (backend, kwargs): max-rel 1e-4."""
    import torch
    got = velocity_grad(ctx, 'kernel', mu, y, mask, **kw)
    want = velocity_grad(ctx, ref[0], mu, y, mask, **ref[1])
    r = max_rel(got, want)
    check(bool(torch.isfinite(got).all())
          and float(want.abs().max()) > 0, 'gradient is degenerate')
    check(r <= 1e-4, f'velocity gradient ({label}) max-rel {r:.3e} > 1e-4')
    print(f'velocity gradient, {label}: max-rel {r:.3e}', flush=True)
    return r


def phase_tape(p, carries, grad_problem):
    """The tape kernels at the headline shape with the taped route forced:
    each against its plain version over a whole pass, their pass times,
    and the taped gradient against the tape-free one."""
    from red_diffeq_tpu_torch.ops import stencil

    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    isz = p['geo']['isz']

    def replay(fn, i):
        return fn(*carries[i], *coef, p['src'][i], isz=isz)

    tapes, err = [], 0.0
    for i in range(len(p['src'])):
        tape = replay(stencil.tape_chunk, i)
        err = max(err, check_outputs(
            'tape_step', [f'slot {j}' for j in range(len(tape))], tape,
            replay(stencil.tape_chunk_plain, i), f'chunk {i}'))
        # The last two slots are the forward kernel's end carry.
        check_outputs('tape_step', ('s_{K-1}', 's_K'), tape[-2:],
                      carries[i + 1], f'chunk {i} vs fwd_step')
        tapes.append(tape)
    print(f'tape_step vs plain: {len(tapes)} tapes of {len(tapes[0])} '
          f'slots, max abs err {err:.3e}', flush=True)

    def tape_pass(fn):
        for i in range(len(tapes)):
            replay(fn, i)

    tape_ms = cuda_ms(lambda: tape_pass(stencil.tape_chunk), 5)
    tape_plain_ms = cuda_ms(lambda: tape_pass(stencil.tape_chunk_plain), 2)
    print(f'tape pass ({len(tapes) * CHUNK} steps): kernel {tape_ms:.3f} ms, '
          f'plain {tape_plain_ms:.3f} ms', flush=True)

    grecs = random_grecs(p)
    bwd = time_reverse_pass(
        p, 'bwd_tape_step', stencil.bwd_tape_chunk,
        stencil.bwd_tape_chunk_plain,
        lambda i, gp0, gp1: (tapes[i], gp0, gp1, grecs[i], *coef[:3],
                             p['src'][i]))
    del tapes
    r = compare_grads(HEADLINE, *grad_problem,
                      f"adjoint='tape' vs 'reverse' at nbc={HEADLINE['nbc']}",
                      ('kernel', {'adjoint': 'reverse'}), adjoint='tape')
    return dict(tape_step=dict(max_abs_err=err, ms=tape_ms,
                               plain_ms=tape_plain_ms),
                bwd_tape_step=bwd, grad_max_rel=r)


def phase_small_reference(dev):
    """A few inversion steps through the kernels on the card against the
    plain path on the CPU, with the same weights and draws."""
    import torch
    from red_diffeq_tpu_torch.core import inversion
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    from red_diffeq_tpu_torch.regularization.base import make_reg_fn
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize, v_normalize,
    )

    ctx = dict(n_grid=16, nt=100, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
               gz=10, ng=16, ns=2)
    rng = np.random.RandomState(3)
    v_true = np.full((2, 1, 16, 16), 2000.0, np.float32)
    v_true[:, :, 9:] = 3200.0
    mu0 = np.pad(np.full((2, 1, 16, 16), -0.2, np.float32),
                 ((0, 0), (0, 0), (1, 1), (1, 1)))
    draws = [dict(x0_noise=rng.standard_normal(mu0.shape).astype(np.float32),
                  t=rng.randint(0, 20, 2),
                  reg_noise=rng.standard_normal(mu0.shape).astype(np.float32))
             for _ in range(3)]
    torch.manual_seed(0)
    state = Unet(dim=8, dim_mults=(1, 2), channels=1).state_dict()
    runs = {}
    for device, backend in (('cpu', 'plain'), (dev, 'kernel')):
        op = FWIForward(ctx, v_denorm_func=v_denormalize,
                        s_norm_func=s_normalize_none, backend=backend,
                        chunk=CHUNK, device=device)
        unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
        unet.load_state_dict(state)
        diff = GaussianDiffusion(unet, image_size=18, timesteps=20,
                                 device=device)
        opt = inversion.Adam(inversion.cosine_decay_schedule(0.03, 3))
        step = inversion.make_inversion_step(
            op, make_reg_fn('diffusion', diff), opt, 0.75, 1e-4, True)
        vt = torch.from_numpy(v_true).to(device)
        with torch.no_grad():
            y = op(v_normalize(vt))
        mu = torch.from_numpy(mu0).to(device)
        st = opt.init(mu)
        out = []
        for d in draws:
            mu, st, m = step(mu, st, y=y, mask=torch.ones_like(y),
                             mu_true_norm=v_normalize(vt),
                             **{k: torch.from_numpy(np.asarray(a)).to(device)
                                for k, a in d.items()})
            out.append((mu.cpu(), {k: t.cpu() for k, t in m.items()}))
        runs[backend] = out
    for (mu_c, m_c), (mu_g, m_g) in zip(runs['plain'], runs['kernel']):
        torch.testing.assert_close(mu_g, mu_c, atol=1e-4, rtol=0)
        for k in ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse',
                  'ssim'):
            torch.testing.assert_close(m_g[k], m_c[k], rtol=1e-4, atol=1e-7)
    d = float((runs['kernel'][-1][0] - runs['plain'][-1][0]).abs().max())
    print(f'small inversion, card kernels vs CPU plain: 3 steps, max |d mu| '
          f'{d:.3e}', flush=True)


def load_prior(dev):
    """The dim-64 U-Net diffusion prior with the shipped weights, read by
    the port's own reader."""
    from red_diffeq_tpu_torch.io import checkpoints
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet

    t0 = time.perf_counter()
    diffusion = GaussianDiffusion(Unet(dim=64, dim_mults=(1, 2, 4, 8),
                                       channels=1),
                                  image_size=72, timesteps=1000,
                                  objective='pred_noise', device=dev)
    raw = checkpoints.load_params(CKPT)
    n_leaves = len(checkpoints.flax_to_state_dict(raw, diffusion.model))
    check(n_leaves == 283, f'prior has {n_leaves} leaves, expected 283')
    checkpoints.load_diffusion_params(diffusion, CKPT)
    print(f'prior: {n_leaves} leaves loaded in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    return diffusion


def slice_problem(dev, ctx):
    """The headline's velocity models at ``ctx``, their observations from
    the refined operator as ``bench.py`` makes them, and the smoothed
    initial models."""
    import torch
    import torch.nn.functional as F
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        prepare_initial_model, s_normalize_none, v_denormalize, v_normalize,
    )

    t0 = time.perf_counter()
    n, nt, ns, ng = (ctx[k] for k in ('n_grid', 'nt', 'ns', 'ng'))
    v_true = generate_mixed_dataset(BATCH, h=n, w=n, seed=8888)
    op_obs = acoustic.FWIForward(
        acoustic.refined_ctx(ctx, factor=2), sample_temporal=2,
        v_denorm_func=v_denormalize,
        s_norm_func=s_normalize_none, backend='plain', chunk=CHUNK,
        device=dev)
    with torch.no_grad():
        y = op_obs(v_normalize(torch.from_numpy(
            acoustic.upsample_velocity(v_true, 2)).to(dev)))
    torch.cuda.synchronize()
    check(tuple(y.shape) == (BATCH, ns, nt, ng)
          and bool(torch.isfinite(y).all()), 'observations are malformed')
    print(f'observations {tuple(y.shape)} at nbc={ctx["nbc"]} (refined x2, '
          f'plain path) in {time.perf_counter() - t0:.2f} s', flush=True)
    init = np.concatenate([prepare_initial_model(v_true[b:b + 1], 'smoothed',
                                                 sigma=10.0)
                           for b in range(BATCH)])
    mu0 = F.pad(torch.from_numpy(init), (1, 1, 1, 1))
    return dict(v_true=v_true, y=y, mu0=mu0)


def phase_slice(dev, diffusion, ctx, problem, route, adjoint=None):
    """``TS`` RED-DiffEq steps of ``InversionEngine.optimize`` at ``ctx``
    after a one-step warm-up. Checks that the solver took ``route``, that
    the forward kernel and that route's two kernels (the tape-free adjoint,
    or the tape replay and the taped adjoint) each launched once per FD
    step, the other route's kernels never, the plain path never, and that
    every sample's observation loss fell. Returns (launches, s/step)."""
    import torch
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize,
    )

    n = ctx['n_grid']
    op = acoustic.FWIForward(ctx,
                             v_denorm_func=v_denormalize,
                             s_norm_func=s_normalize_none, chunk=CHUNK,
                             adjoint=adjoint, device=dev)
    check(op.backend == 'kernel', f'auto picked {op.backend!r} on the card')
    mode = stencil.resolve_run_config(op.geom, CHUNK, adjoint)[0]
    check(mode == route, f'nbc={ctx["nbc"]}: the solver takes {mode!r}, '
          f'expected {route!r}')
    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)

    def run(ts):
        gen = torch.Generator(device=dev).manual_seed(8888)
        out = engine.optimize(problem['mu0'], problem['v_true'],
                              problem['y'], op, ts=ts, lr=0.03,
                              reg_lambda=0.75, generator=gen)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run(1)                      # warm-up: cuDNN plans, allocator
    warm_s = time.perf_counter() - t0

    stencil.reset_launches()
    acoustic.plain_chunk_calls['chunk'] = 0
    t0 = time.perf_counter()
    mu, per_model = run(TS)
    run_s = time.perf_counter() - t0
    counts = dict(stencil.launches)
    plain_calls = acoustic.plain_chunk_calls['chunk']

    steps = TS * len(acoustic.source_chunks(op.geom, CHUNK, 'cpu')) * CHUNK
    route_kernels = (('bwd_reverse_step',) if route == 'reverse'
                     else ('tape_step', 'bwd_tape_step'))
    print(f'nbc={ctx["nbc"]}, adjoint {route!r}: launches {counts}, plain '
          f'chunks {plain_calls}', flush=True)
    for name in counts:
        want = steps if name == 'fwd_step' or name in route_kernels else 0
        check(counts[name] == want,
              f'{name} launched {counts[name]} times, expected {want}')
    check(plain_calls == 0, f'the plain path ran {plain_calls} chunks')
    check(tuple(mu.shape) == (BATCH, 1, n, n)
          and bool(torch.isfinite(mu).all())
          and float(mu.abs().max()) <= 1.0, 'inverted model is malformed')
    for i, curves in enumerate(per_model):
        for k, c in curves.items():
            check(len(c) == TS and np.isfinite(c).all(),
                  f'sample {i} {k} is not finite')
        obs = curves['obs_losses']
        check(obs[-1] < obs[1], f'sample {i}: obs loss did not fall '
              f'({obs[1]:.5g} -> {obs[-1]:.5g})')
        print(f'sample {i}: obs {obs[0]:.5g} -> {obs[-1]:.5g}, '
              f'SSIM {curves["ssim"][0]:.4f} -> {curves["ssim"][-1]:.4f}, '
              f'MAE {curves["mae"][-1]:.4f}', flush=True)
    print(f'inversion at nbc={ctx["nbc"]}, adjoint {route!r}: {TS} steps in '
          f'{run_s:.3f} s, {run_s / TS:.4f} s/step (warm-up step '
          f'{warm_s:.2f} s)', flush=True)
    return counts, run_s / TS


def phase_narrow(dev, diffusion):
    """The narrow-sponge slice: the taped gradient against plain eager
    autograd at nbc=40, then the inversion with the guard's own route."""
    problem = slice_problem(dev, NARROW)
    r = compare_grads(NARROW,
                      *gradient_problem(problem['v_true'], problem['y']),
                      f'tape kernels vs plain autograd at nbc={NARROW["nbc"]}',
                      ('plain', {}))
    counts, s_step = phase_slice(dev, diffusion, NARROW, problem, 'tape')
    return counts, s_step, r


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    try:
        import red_diffeq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}',
              file=sys.stderr)
        return 1
    from red_diffeq_tpu_torch.ops import stencil

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}', flush=True)

    with Phase('card'):
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    with Phase('build'):
        print(f'built {stencil.build(verbose=True)}', flush=True)
    with Phase('forward kernel'):
        p = headline_problem(dev)
        fwd, carries, seis = phase_forward(p)
        grad_problem = gradient_problem(p['v_true'],
                                        seis[:, :, :HEADLINE['nt']])
    with Phase('adjoint kernel'):
        bwd = phase_adjoint(p, carries, grad_problem)
    with Phase('tape kernels'):
        tape = phase_tape(p, carries, grad_problem)
        del carries
    with Phase('small inversion vs CPU'):
        phase_small_reference(dev)
    with Phase('slice'):
        diffusion = load_prior(dev)
        problem = slice_problem(dev, HEADLINE)
        counts, s_per_step = phase_slice(dev, diffusion, HEADLINE, problem,
                                         'reverse')
        _, s_tape_forced = phase_slice(dev, diffusion, HEADLINE, problem,
                                       'tape', adjoint='tape')
        del problem
    with Phase('narrow-sponge slice'):
        narrow_counts, s_narrow, narrow_grad = phase_narrow(dev, diffusion)

    steps = len(p['src']) * CHUNK
    bnd = bounds(p, steps, len(p['src']))
    kernels = []
    # Each kernel's launches come from the slice that takes its route.
    for name, res, line, launched in (
            ('fwd_step', fwd, 150, counts),
            ('bwd_reverse_step', bwd, 352, counts),
            ('tape_step', tape['tape_step'], 233, narrow_counts),
            ('bwd_tape_step', tape['bwd_tape_step'], 271, narrow_counts)):
        kernels.append(dict(
            name=name, route='cuda', source=SOURCE,
            replaces=f'red_diffeq_tpu/ops/stencil.py:{line}',
            launches=launched[name], max_abs_err=res['max_abs_err'],
            ms=res['ms'], plain_ms=res['plain_ms'],
            bound_ms=bnd[name]['bound_ms'], bound_by=bnd[name]['bound_by'],
            library_ms=None))
    print(f'slice: {s_per_step:.4f} s per inversion step at the headline '
          f"(adjoint 'reverse'), {s_tape_forced:.4f} with 'tape' forced, "
          f"{s_narrow:.4f} at nbc={NARROW['nbc']} ('tape'); velocity "
          f'gradient max-rel {bwd["grad_max_rel"]:.3e} (kernels vs plain), '
          f'{tape["grad_max_rel"]:.3e} (tape vs reverse), {narrow_grad:.3e} '
          f'(tape kernels vs plain, nbc={NARROW["nbc"]})', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
