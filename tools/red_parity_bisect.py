#!/usr/bin/env python3
"""One RED-DiffEq inversion step of a parity reference, taken apart in the
JAX package and in the port, side by side on the CPU.

Reads a reference of ``tools/make_red_parity_reference.py`` and, for step
``--step`` s, starts both packages from the same model (the reference's
``mu`` before step s: ``mu0`` for s = 1) with the reference's draws of
step s, and compares each quantity of the step in turn:

1. ``x0_pred = mu + sigma_x0 * noise`` and the predicted seismogram of its
   crop (JAX ``backend='xla'``, the port ``backend='plain'``);
2. the observation loss (per-sample L1) and its gradient in ``mu``
   (``--backend kernel``: the port's kernel route, on the kernels' plain
   versions);
3. RED at the step's t: ``q_sample``, the U-Net's output, the rederived
   ``pred_noise`` and the score (``pred_noise - noise``), the RED loss and
   its gradient (lambda times the score over the cell count);
4. the total gradient: the cells where the two signs differ, and where
   each package's |gradient| is below 1e-6 of its largest;
5. at s = 1, Adam's first update (the sign of the gradient, to within
   its eps) and the clamp, against the reference's ``mu`` after step 1.

Each line gives the largest |difference|, the largest |value| (JAX) and
their ratio. The first quantity whose ratio is far above fp32 rounding
(1e-6) is where the packages part. ``--trace_zero`` also counts the
seismogram samples whose residual is exactly zero (where JAX's |x| has
gradient +1 and the port's 0).

Usage (from the repo root; a few minutes at the full width):

    JAX_PLATFORMS=cpu python3 tools/red_parity_bisect.py [--reference
        tests/data/red_parity_reference.npz] [--step 1]
"""
import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from red_diffeq_tpu.core.losses import \
    observation_loss as jax_obs_loss  # noqa: E402
from red_diffeq_tpu.io.checkpoints import \
    load_diffusion_params as jax_load  # noqa: E402
from red_diffeq_tpu.models.diffusion import \
    GaussianDiffusion as JaxDiffusion  # noqa: E402
from red_diffeq_tpu.models.unet import Unet as JaxUnet  # noqa: E402
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI  # noqa: E402
from red_diffeq_tpu.utils import data_trans as jdt  # noqa: E402
from red_diffeq_tpu_torch.core.losses import observation_loss  # noqa: E402
from red_diffeq_tpu_torch.io.checkpoints import \
    load_diffusion_params  # noqa: E402
from red_diffeq_tpu_torch.models.diffusion import \
    GaussianDiffusion  # noqa: E402
from red_diffeq_tpu_torch.models.unet import Unet  # noqa: E402
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward  # noqa: E402
from red_diffeq_tpu_torch.utils import data_trans as tdt  # noqa: E402

CKPT = Path('pretrained_models/model-synthetic-ema.ckpt')


def load_reference(path):
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    ref['meta'] = json.loads(str(ref['meta']))
    return ref


def line(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    big = np.abs(want).max()
    print(f'{name:28s} max |d| {d.max():.3e}  max |jax| {big:.3e}  ratio '
          f'{d.max() / max(big, 1e-30):.3e}', flush=True)
    return d


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--reference', type=Path,
                   default=Path('tests/data/red_parity_reference.npz'))
    p.add_argument('--ckpt', type=Path, default=CKPT)
    p.add_argument('--step', type=int, default=1)
    p.add_argument('--trace_zero', action='store_true')
    p.add_argument('--backend', default='plain', choices=['plain', 'kernel'],
                   help="the port's solver: 'kernel' runs the kernels' "
                        "route ('reverse' at nbc=120: the forward field "
                        "rebuilt backward in time) on their plain versions "
                        "on the CPU")
    args = p.parse_args(argv)
    ref = load_reference(args.reference)
    meta, s = ref['meta'], args.step
    i = s - 1
    mu = ref['mu0'] if s == 1 else ref['mu'][meta['snap_steps'].index(s - 1)]
    x0n, t, noise = ref['x0_noise'][i], ref['t'][i], ref['reg_noise'][i]
    y, lam, sigma = ref['y'], meta['reg_lambda'], meta['sigma_x0']
    ctx, u = meta['ctx'], meta['unet']
    print(f'step {s} of {meta["ts"]}: t {t.tolist()}', flush=True)

    # JAX.
    jop = JaxFWI(ctx, normalize=True, v_denorm_func=jdt.v_denormalize,
                 s_norm_func=jdt.s_normalize_none, backend='xla',
                 chunk=meta['chunk'])
    jd = JaxDiffusion(JaxUnet(dim=u['dim'], dim_mults=tuple(u['dim_mults']),
                              channels=u['channels']),
                      image_size=meta['image_size'],
                      timesteps=meta['timesteps'], objective=meta['objective'])
    jax_load(jd, str(args.ckpt))

    def j_obs(m):
        x0 = m + sigma * x0n
        pred = jop._forward(x0[:, :, 1:-1, 1:-1])
        return jax_obs_loss(pred, y, jnp.ones_like(y)).sum(), pred

    (j_loss, j_pred), j_gobs = jax.jit(jax.value_and_grad(
        j_obs, has_aux=True))(jnp.asarray(mu))

    @jax.jit
    def j_red(params, m):
        d = jd.with_params(params)
        x0 = m + sigma * x0n
        x_t = d.q_sample(x0, t, noise=noise)
        out = d.apply_fn(x_t, t)
        p = d.model_predictions(x_t, t, clip_x_start=True,
                                rederive_pred_noise=True)
        score = p.pred_noise - noise
        return x_t, out, p.pred_noise, score, (score * x0).reshape(
            x0.shape[0], -1).mean(axis=1)

    j_xt, j_out, j_pn, j_score, j_reg = j_red(jd.params, jnp.asarray(mu))
    n_cells = mu[0].size
    j_greg = lam * np.asarray(j_score) / n_cells
    j_g = np.asarray(j_gobs) + j_greg

    # The port.
    top = FWIForward(ctx, normalize=True, v_denorm_func=tdt.v_denormalize,
                     s_norm_func=tdt.s_normalize_none, backend=args.backend,
                     chunk=meta['chunk'], device='cpu')
    td = GaussianDiffusion(Unet(dim=u['dim'], dim_mults=tuple(u['dim_mults']),
                                channels=u['channels']),
                           image_size=meta['image_size'],
                           timesteps=meta['timesteps'],
                           objective=meta['objective'], device='cpu')
    load_diffusion_params(td, str(args.ckpt))
    m_t = torch.from_numpy(mu).requires_grad_(True)
    x0 = m_t + sigma * torch.from_numpy(x0n)
    pred = top(x0[:, :, 1:-1, 1:-1])
    y_t = torch.from_numpy(y)
    loss = observation_loss(pred, y_t, torch.ones_like(y_t)).sum()
    t_gobs, = torch.autograd.grad(loss, m_t, retain_graph=True)
    # The port's solver fed JAX's cotangent of the loss in the seismogram.
    j_cot = jax.grad(lambda q: jax_obs_loss(q, y, jnp.ones_like(y)).sum())(
        j_pred)
    t_gfed, = torch.autograd.grad(pred, m_t, torch.from_numpy(
        np.array(j_cot)))
    with torch.no_grad():
        tt = torch.from_numpy(t).long()
        x0 = x0.detach()
        x_t = td.q_sample(x0, tt, torch.from_numpy(noise))
        out = td.model(x_t, tt)
        p = td.model_predictions(x_t, tt, clip_x_start=True,
                                 rederive_pred_noise=True)
        score = p.pred_noise - torch.from_numpy(noise)
        reg = (score * x0).reshape(x0.shape[0], -1).mean(dim=1)
    t_greg = lam * score.numpy() / n_cells
    t_g = t_gobs.numpy() + t_greg

    line('predicted seismogram', pred.detach().numpy(), j_pred)
    line('observation loss', loss.item(), float(j_loss))
    line('observation gradient', t_gobs.numpy(), j_gobs)
    line('  ... fed JAX\'s cotangent', t_gfed.numpy(), j_gobs)
    r_j = y - np.asarray(j_pred)
    r_t = y - pred.detach().numpy()
    sign = (np.sign(r_j) != np.sign(r_t)) & (r_j != 0) & (r_t != 0)
    print(f'residual signs differ at {int(sign.sum())} of {sign.size} '
          f'samples, |residual| there at most '
          f'{np.abs(r_j[sign]).max() if sign.any() else 0:.3e}', flush=True)
    line('q_sample', x_t.numpy(), j_xt)
    line('U-Net output', out.numpy(), j_out)
    line('pred_noise (rederived)', p.pred_noise.numpy(), j_pn)
    line('score', score.numpy(), j_score)
    line('RED loss', reg.numpy(), j_reg)
    line('RED gradient', t_greg, j_greg)
    line('total gradient', t_g, j_g)
    flips = np.sign(t_g) != np.sign(j_g)
    j_gobs = np.asarray(j_gobs)
    small = np.abs(j_g) < 1e-6 * np.abs(j_g).max()
    rows = sorted(set(np.nonzero(flips)[2].tolist()))
    print(f'gradient signs differ at {int(flips.sum())} of {flips.size} '
          f'cells (rows {rows[:12]}{" ..." if len(rows) > 12 else ""}); '
          f'|JAX gradient| below 1e-6 of its largest at {int(small.sum())}; '
          f'at the flipped cells |JAX gradient| at most '
          f'{np.abs(j_g[flips]).max() if flips.any() else 0:.3e} '
          f'(largest {np.abs(j_g).max():.3e}), the observation part at most '
          f'{np.abs(j_gobs[flips]).max() if flips.any() else 0:.3e}',
          flush=True)
    ring = np.zeros(mu.shape, bool)
    ring[..., 0, :] = ring[..., -1, :] = True
    ring[..., :, 0] = ring[..., :, -1] = True
    print(f'of those on the pad ring (no observation gradient): '
          f'{int((flips & ring).sum())}', flush=True)
    if args.trace_zero:
        res = np.asarray(y, np.float64) - np.asarray(j_pred, np.float64)
        print(f'seismogram samples with residual exactly 0: JAX '
              f'{int((np.asarray(y) - np.asarray(j_pred) == 0).sum())}, '
              f'port {int((y - pred.detach().numpy() == 0).sum())} of '
              f'{res.size}', flush=True)
    if s == 1:
        lr = meta['lr']
        for name, g in (('port', t_g), ('jax', j_g)):
            step = g / (np.abs(g) + 1e-8)
            got = np.clip(mu - lr * step, -1, 1)
            d = np.abs(got - ref['mu'][0])
            print(f'Adam step 1 from the {name} gradient against the '
                  f'reference mu: max |d| {d.max():.3e}, cells beyond 1e-4 '
                  f'{int((d > 1e-4).sum())}', flush=True)


if __name__ == '__main__':
    main()
