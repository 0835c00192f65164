"""Make a JAX reference of the RED-DiffEq inversion loop for the port.

Builds the held-out problem of ``tools/eval_quality.py`` (nbc=120, nt=1000,
5 shots; truths ``generate_mixed_dataset(4, seed=7777)``, the
smoothed sigma=10 initial model, refined or clean observations; the dim-64
(1, 2, 4, 8) U-Net at 72x72, T=1000, ``pred_noise``, the shipped prior;
lambda 0.75, lr 0.03, ``sigma_x0`` 1e-4) for the chosen samples, runs the
JAX engine's ``optimize`` for ``--steps`` steps with ``PRNGKey(8888)`` on
the CPU (``backend='xla'``) and writes one ``.npz``:

* every step's draws as JAX's key path makes them: ``optimize`` splits the
  key three ways (the corruption's two keys), then into ``ts`` step keys;
  each step splits its key into ``key_x0, key_reg`` (the ``sigma_x0``
  noise), and RED splits ``key_reg`` into ``kt, kn`` (the timesteps and
  the noise). The draws are read back with ``jax.random`` on those keys,
  and the timesteps are checked against the ones the step reports;
* ``mu`` after every ``--snap_every``-th step and the last (padded), and
  every step's losses and metrics, from the engine's own step program
  (``optimize(use_scan=False)`` runs the same program on the same keys:
  with ``--confirm`` it is run too and its result must be the stepped
  loop's, bit for bit);
* with ``--spread`` (the default), the JAX package's own spread under
  rounding: the same run from ``mu0`` nudged up by one ulp in every cell
  (``spread_mu``, ``spread_<curve>``): the L1 loss's sign turns rounding
  in the seismogram into whole terms of the gradient, and Adam turns a
  gradient near zero into whole steps, so two runs that differ only in
  rounding part by more than rounding;
* the problem: ``mu0``, ``v_true``, the observations ``y``, and ``meta``
  (JSON: the acquisition, the optimiser's settings, the key, the samples).

``--draws_only`` writes the draws (and ``meta``) alone, for a quality row
of the truths (no inversion is run): e.g. the draws of
``tools/eval_quality.py``'s RED rows, ``--samples 0 1 2 3 --steps 300``,
about 50 MB, which both observation protocols share.

Imports the JAX package; not part of the port, whose counterpart is
``tools/torch_red_parity.py``. Usage (from the repo root):

    JAX_PLATFORMS=cpu python tools/make_red_parity_reference.py \\
        [--steps 16] [--samples 0] [--obs refined] \\
        [--out tests/data/red_parity_reference.npz]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED_TRUTHS = 7777
# The truths generated, of which --samples picks (the quality tools' n).
N_TRUTHS = 4
KEY = 8888
LR, LAMBDA, SIGMA_X0 = 0.03, 0.75, 1e-4
CTX = dict(n_grid=70, nt=1000, dx=10.0, dt=0.001, nbc=120, f=15.0, sz=10,
           gz=10, ng=70, ns=5)
UNET = dict(dim=64, dim_mults=[1, 2, 4, 8], channels=1)
IMAGE_SIZE, TIMESTEPS = 72, 1000
CURVES = ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


def step_draws(key, ts: int, shape, num_timesteps: int):
    """The draws of ``optimize(key=key, ts=ts)`` for a padded model of
    ``shape`` (B, 1, H+2, W+2) under the unpatched RED, in step order:
    (x0_noise (ts, *shape), t (ts, B), reg_noise (ts, *shape))."""
    import jax
    import jax.numpy as jnp
    key, _, _ = jax.random.split(key, 3)
    x0, ts_, noise = [], [], []
    for k in jax.random.split(key, ts):
        key_x0, key_reg = jax.random.split(k)
        kt, kn = jax.random.split(key_reg)
        x0.append(np.asarray(jax.random.normal(key_x0, shape, jnp.float32)))
        ts_.append(np.asarray(jax.random.randint(kt, (shape[0],), 0,
                                                 num_timesteps)))
        noise.append(np.asarray(jax.random.normal(kn, shape, jnp.float32)))
    return (np.stack(x0), np.stack(ts_).astype(np.int32), np.stack(noise))


def problem(samples, obs: str, sigma: float = 10.0):
    """(ctx, op, v_true, y, mu0) of the held-out problem for ``samples``
    of the ``N_TRUTHS`` truths, as ``tools/eval_quality.py`` builds it."""
    import jax.numpy as jnp
    from red_diffeq_tpu.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu.solvers.acoustic import (
        FWIForward, refined_ctx, upsample_velocity,
    )
    from red_diffeq_tpu.utils.data_trans import (
        prepare_initial_model, s_normalize_none, v_denormalize, v_normalize,
    )
    ctx = dict(CTX)
    op = FWIForward(ctx, normalize=True, v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend='xla', chunk=20)
    v_true = generate_mixed_dataset(N_TRUTHS, h=70, w=ctx['n_grid'],
                                    seed=SEED_TRUTHS)[list(samples)]
    if obs == 'clean':
        y = op(v_normalize(jnp.asarray(v_true)))
    else:
        op_obs = FWIForward(refined_ctx(ctx, factor=2), sample_temporal=2,
                            normalize=True, v_denorm_func=v_denormalize,
                            s_norm_func=s_normalize_none, backend='xla',
                            chunk=20)
        v_fine = jnp.asarray(upsample_velocity(v_true, factor=2))
        y = op_obs(v_normalize(v_fine))
    init = np.concatenate([
        prepare_initial_model(v_true[b:b + 1], 'smoothed', sigma=sigma)
        for b in range(len(samples))])
    mu0 = np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1)))
    return ctx, op, v_true, np.asarray(y), mu0.astype(np.float32)


def prior_bundle(ckpt, image_size: int = IMAGE_SIZE,
                 timesteps: int = TIMESTEPS):
    """The JAX GaussianDiffusion of the dim-64 U-Net holding ``ckpt`` (its
    tree as stored, or a training state's ``ema_params``, as
    ``load_diffusion_params`` reads it, without its random
    initialisation first)."""
    import jax
    import jax.numpy as jnp
    from red_diffeq_tpu.io.checkpoints import load_params
    from red_diffeq_tpu.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu.models.unet import Unet
    raw = load_params(str(ckpt))
    if 'ema_params' in raw:
        raw = raw['ema_params']
    return GaussianDiffusion(Unet(dim=UNET['dim'],
                                  dim_mults=tuple(UNET['dim_mults']),
                                  channels=UNET['channels']),
                             image_size=image_size, timesteps=timesteps,
                             objective='pred_noise',
                             params=jax.tree.map(jnp.asarray, raw))


def run(diffusion, ts, op, v_true, y, mu0, snap_steps, confirm,
        log=print):
    """The engine's stepped loop (the program ``optimize(use_scan=False)``
    runs) on ``PRNGKey(KEY)``. Returns (mu at ``snap_steps``, curves (ts,
    B) by name, the step's reported timesteps (ts, B), seconds)."""
    import jax
    import jax.numpy as jnp
    from red_diffeq_tpu.core.inversion import InversionEngine
    from red_diffeq_tpu.utils.data_trans import missing_trace, v_normalize

    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=SIGMA_X0)
    mu = jnp.asarray(mu0)
    y_j = jnp.asarray(y)
    key, _, k_miss = jax.random.split(jax.random.PRNGKey(KEY), 3)
    y_j, mask = missing_trace(y_j, 0, return_mask=True, key=k_miss)
    optimizer, _, run_step = engine._get_program(
        'diffusion', ts, LR, LAMBDA, False, mu.shape, y_j.shape, op)
    carry = (mu, optimizer.init(mu))
    target = v_normalize(jnp.asarray(v_true, jnp.float32))
    snaps, curves, t_seen = [], {k: [] for k in CURVES}, []
    t0 = time.time()
    for i, k in enumerate(jax.random.split(key, ts)):
        carry, m = run_step(carry, k, y_j, mask, target, diffusion.params)
        for name in CURVES:
            curves[name].append(np.asarray(m[name]))
        t_seen.append(np.asarray(m['t']))
        if i + 1 in snap_steps:
            snaps.append(np.asarray(carry[0]))
        log(f'step {i + 1}/{ts}: SSIM {float(m["ssim"].mean()):.4f}, '
            f't {np.asarray(m["t"]).tolist()}, {time.time() - t0:.1f} s')
    seconds = time.time() - t0
    curves = {k: np.stack(v) for k, v in curves.items()}
    if confirm:
        got, per_model = engine.optimize(
            mu0, v_true, y, op, ts=ts, lr=LR, reg_lambda=LAMBDA,
            regularization='diffusion', key=jax.random.PRNGKey(KEY),
            use_scan=False, progress=False)
        np.testing.assert_array_equal(np.asarray(got),
                                      snaps[-1][:, :, 1:-1, 1:-1])
        for name in CURVES:
            np.testing.assert_array_equal(
                np.stack([pm[name] for pm in per_model], axis=1),
                curves[name])
        log('optimize(use_scan=False) is the stepped loop bit for bit')
    return np.stack(snaps), curves, np.stack(t_seen), seconds


def make_reference(diffusion, ctx, op, v_true, y, mu0, ts: int,
                   snap_every: int = 1, confirm: bool = True,
                   spread: bool = True, log=print, **meta):
    """The reference of a ``ts``-step run on one problem, as written to
    the ``.npz`` (``meta`` a dict; ``meta`` keywords are added to it).
    With ``spread``, also the JAX package's own spread under rounding:
    the same run from ``mu0`` nudged up by one ulp in every cell, its
    ``mu`` (``spread_mu``) and curves (``spread_<name>``)."""
    import jax
    shape = tuple(mu0.shape)
    x0_noise, t, reg_noise = step_draws(jax.random.PRNGKey(KEY), ts, shape,
                                        diffusion.num_timesteps)
    snap_steps = sorted(set(range(snap_every, ts + 1, snap_every)) | {ts})
    mus, curves, t_seen, seconds = run(diffusion, ts, op, v_true, y, mu0,
                                       set(snap_steps), confirm, log)
    np.testing.assert_array_equal(t_seen, t)
    extra = {}
    if spread:
        nudged = np.nextafter(np.asarray(mu0, np.float32), np.float32(np.inf))
        s_mus, s_curves, _, _ = run(diffusion, ts, op, v_true, y, nudged,
                                    set(snap_steps), False, log)
        extra = dict(spread_mu=s_mus,
                     **{f'spread_{k}': v for k, v in s_curves.items()})
    u = diffusion.model
    meta = dict(ctx=ctx, lr=LR, reg_lambda=LAMBDA, sigma_x0=SIGMA_X0,
                key=KEY, ts=ts, unet=dict(dim=u.dim,
                                          dim_mults=list(u.dim_mults),
                                          channels=u.channels),
                image_size=diffusion.image_size[0],
                timesteps=diffusion.num_timesteps,
                objective=diffusion.objective, chunk=op.chunk,
                backend=op.backend, jax=jax.__version__,
                platform=jax.default_backend(), snap_steps=snap_steps,
                seconds=seconds, **meta)
    return dict(meta=meta, x0_noise=x0_noise, t=t, reg_noise=reg_noise,
                mu0=np.asarray(mu0, np.float32),
                v_true=np.asarray(v_true, np.float32),
                y=np.asarray(y, np.float32), mu=mus, **curves, **extra)


def save(path: Path, ref: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: np.array(json.dumps(v)) if k == 'meta'
                                 else v for k, v in ref.items()})
    print(f'wrote {path} ({path.stat().st_size / 2**20:.2f} MiB)')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--ckpt', type=Path,
                   default=Path('pretrained_models/model-synthetic-ema.ckpt'))
    p.add_argument('--steps', type=int, default=16,
                   help='ts of the run: its cosine schedule and its '
                        'split(key, ts) (the quality rows: 300)')
    p.add_argument('--samples', type=int, nargs='+', default=[0],
                   help='which of the truths make the batch')
    p.add_argument('--obs', choices=['refined', 'clean'], default='refined')
    p.add_argument('--snap_every', type=int, default=1,
                   help='record mu after every this many steps (and the '
                        'last)')
    p.add_argument('--draws_only', action='store_true',
                   help='write the draws alone; run no inversion')
    p.add_argument('--confirm', action=argparse.BooleanOptionalAction,
                   default=True,
                   help='also run optimize(use_scan=False) and require the '
                        'stepped loop\'s result bit for bit (doubles the '
                        'time)')
    p.add_argument('--spread', action=argparse.BooleanOptionalAction,
                   default=True,
                   help='also run from mu0 nudged one ulp up (the JAX '
                        'package\'s own spread under rounding)')
    p.add_argument('--out', type=Path,
                   default=Path('tests/data/red_parity_reference.npz'))
    args = p.parse_args(argv)

    meta = dict(n_truths=N_TRUTHS, samples=args.samples,
                obs=args.obs, sigma=10.0, seed_truths=SEED_TRUTHS)
    if args.draws_only:
        import jax
        shape = (len(args.samples), 1, IMAGE_SIZE, IMAGE_SIZE)
        x0_noise, t, reg_noise = step_draws(jax.random.PRNGKey(KEY),
                                            args.steps, shape, TIMESTEPS)
        meta.update(ctx=CTX, lr=LR, reg_lambda=LAMBDA, sigma_x0=SIGMA_X0,
                    key=KEY, ts=args.steps, jax=jax.__version__)
        save(args.out, dict(meta=meta, x0_noise=x0_noise, t=t,
                            reg_noise=reg_noise))
        return
    ctx, op, v_true, y, mu0 = problem(args.samples, args.obs)
    ref = make_reference(prior_bundle(args.ckpt), ctx, op, v_true, y, mu0,
                         args.steps, args.snap_every, args.confirm,
                         args.spread, log=lambda m: print(m, flush=True),
                         **meta)
    print(f'final MAE {ref["mae"][-1].mean():.4f} RMSE '
          f'{ref["rmse"][-1].mean():.4f} SSIM {ref["ssim"][-1].mean():.4f} '
          f'({ref["meta"]["seconds"]:.1f} s)', flush=True)
    save(args.out, ref)


if __name__ == '__main__':
    main()
