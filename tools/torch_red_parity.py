"""Hold the port's RED-DiffEq loop to a JAX reference on JAX's own draws.

Reads a reference written by ``tools/make_red_parity_reference.py`` (the
JAX engine's run of the quality tools' held-out problem at the full width:
every step's draws, ``mu`` after recorded steps, every step's losses and
metrics, the problem itself) and runs the port's ``optimize`` on it, with
the reference's draws fed through the seam the loop already calls for
them, ``core/inversion.py:_step_draws`` (patched for the call; the port has
no public parameter for it, as the JAX engine has none). ``mu`` after each
recorded step is read through ``_save_snapshot`` (a ``checkpoint_path`` in
a temporary directory, the snapshot kept in memory instead of written).
By default the loop is the graphed one (``use_scan=True``) on
``backend='auto'``: the kernels on the card, the plain path on the CPU.

The tolerance starts from PR 10's rule for two runs of Adam: ``mu``
within ``CELL_TOL`` (1e-4) on all but ``CELL_SHARE`` (1%) of its cells
and within ``STEP_FRACTION`` (0.1) of one step (0.1 lr) on every cell; the
losses and metrics within ``CURVE_RTOL`` (1e-4, relative; ``CURVE_ATOL``
1e-6 absolute). At the full width that rule cannot hold over depth even
between two runs of the JAX package: the L1 loss's sign turns rounding in
the seismogram into whole terms of the gradient, and Adam turns a
gradient near zero into a whole step, so the JAX run from ``mu0`` nudged
by one ulp (the reference's ``spread_mu`` and ``spread_<curve>``) leaves
it at step 1 and has 75% of the cells beyond 1e-4 by step 16. Each
measure (the largest ``|d mu|``, the share beyond 1e-4, the mean
``|d mu|``, each curve's relative difference) is therefore allowed PR
10's value (for the mean, the most the rule permits: 1.29e-4) or
``SPREAD_FACTOR`` (2) times the largest that the JAX package's own spread
reached over the run, whichever is larger (:func:`allowance`). It
prints, for each recorded step, the largest ``|d mu|``, its cell, the
share of cells beyond 1e-4 and the allowance, the first step where
``mu`` leaves PR 10's rule and where it leaves the allowance, the first
step whose losses or metrics leave theirs, and the final MAE, RMSE and
SSIM of both.

A reference of draws alone (``--draws_only`` there: e.g. the quality
rows' n=4, 300-step draws) runs the RED rows of ``tools/eval_quality.py``
on those draws instead: the held-out problem of ``tools/torch_quality.py``
(the port's own observations) for each of ``--obs``, and prints each
row's final MAE, RMSE and SSIM, per sample and averaged.

Imports only the port. Usage (from the repo root):

    python tools/torch_red_parity.py [--reference
        tests/data/red_parity_reference.npz] [--device cuda|cpu]
        [--save mu.npz]
    python tools/torch_red_parity.py --reference DRAWS.npz --obs refined clean
"""
import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import torch_quality as Q  # noqa: E402
from red_diffeq_tpu_torch.core import inversion  # noqa: E402
from red_diffeq_tpu_torch.io.checkpoints import (  # noqa: E402
    load_diffusion_params,
)
from red_diffeq_tpu_torch.models.diffusion import (  # noqa: E402
    GaussianDiffusion,
)
from red_diffeq_tpu_torch.models.unet import Unet  # noqa: E402
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward  # noqa: E402
from red_diffeq_tpu_torch.utils.data_trans import (  # noqa: E402
    s_normalize_none, v_denormalize,
)
from red_diffeq_tpu_torch.utils.device import resolve_device  # noqa: E402

REFERENCE = Path('tests/data/red_parity_reference.npz')
CELL_TOL, CELL_SHARE, STEP_FRACTION = 1e-4, 0.01, 0.1
CURVE_RTOL, CURVE_ATOL = 1e-4, 1e-6
SPREAD_FACTOR = 2.0
CURVES = ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


def load_reference(path=REFERENCE) -> dict:
    """The reference's arrays by name, ``meta`` parsed from its JSON."""
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    ref['meta'] = json.loads(str(ref['meta']))
    return ref


def mu_gap(got, want):
    """(max |d mu|, its cell as (sample, row, column), share of cells
    beyond ``CELL_TOL``, mean |d mu|) of two padded models (B, 1, H,
    W)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    b, _, r, c = np.unravel_index(int(np.argmax(d)), d.shape)
    return (float(d.max()), (int(b), int(r), int(c)),
            float((d > CELL_TOL).mean()), float(d.mean()))


def allowance(ref):
    """The allowance of every recorded step: (max |d mu|, share beyond
    CELL_TOL, mean |d mu|, {curve: relative difference}). PR 10's rule
    (for the mean, the most it permits: all but CELL_SHARE of the cells at
    CELL_TOL, those at STEP_FRACTION lr), widened where the reference's own
    spread (its run from ``mu0`` nudged one ulp, if it holds one) is wider:
    SPREAD_FACTOR times the most the spread reaches over the run. Over the
    run, not at the same step: where two runs part is as much chance as
    how far, and the port may part earlier than the nudged run."""
    lr = ref['meta']['lr']
    d_max = share_max = mean_max = 0.0
    rel_max = dict.fromkeys(CURVES, 0.0)
    if 'spread_mu' in ref:
        for spread, mu in zip(ref['spread_mu'], ref['mu']):
            d, _, share, mean = mu_gap(spread, mu)
            d_max, share_max = max(d_max, d), max(share_max, share)
            mean_max = max(mean_max, mean)
        for k in CURVES:
            w = ref[k].astype(np.float64)
            rel_max[k] = float((np.abs(ref[f'spread_{k}'] - w) / np.maximum(
                np.abs(w), 1e-30)).max())
    mean_floor = (1 - CELL_SHARE) * CELL_TOL + CELL_SHARE * STEP_FRACTION * lr
    return (max(STEP_FRACTION * lr, SPREAD_FACTOR * d_max),
            max(CELL_SHARE, SPREAD_FACTOR * share_max),
            max(mean_floor, SPREAD_FACTOR * mean_max),
            {k: max(CURVE_RTOL, SPREAD_FACTOR * r)
             for k, r in rel_max.items()})


def curves_within(got, want, rtol) -> bool:
    return bool(np.all(np.abs(np.asarray(got, np.float64) - want)
                       <= CURVE_ATOL + rtol * np.abs(want)))


@contextlib.contextmanager
def fed_draws(ref, dev):
    """``core/inversion.py:_step_draws`` yields the reference's draws, one
    step a call, in step order, on ``dev``."""
    steps = iter(range(ref['t'].shape[0]))
    real = inversion._step_draws

    def draws(reg_fn, is_diffusion, shape, generator, device):
        i = next(steps)
        out = {'x0_noise': ref['x0_noise'][i], 't': ref['t'][i],
               'reg_noise': ref['reg_noise'][i]}
        if tuple(out['x0_noise'].shape) != tuple(shape):
            raise ValueError(f'the reference draws {out["x0_noise"].shape}, '
                             f'the loop asks for {tuple(shape)}')
        return {k: torch.from_numpy(np.asarray(
            v, np.int64 if k == 't' else np.float32)).to(device)
            for k, v in out.items()}

    inversion._step_draws = draws
    try:
        yield
    finally:
        inversion._step_draws = real


@contextlib.contextmanager
def kept_snapshots():
    """``core/inversion.py:_save_snapshot`` keeps each snapshot's ``mu``
    (padded, on the host) by step in the yielded dict, and writes
    nothing."""
    kept = {}
    real = inversion._save_snapshot

    def keep(path, step, mu, opt_state, metrics, generator_state):
        kept[step] = mu.detach().cpu().numpy().copy()

    inversion._save_snapshot = keep
    try:
        yield kept
    finally:
        inversion._save_snapshot = real


def build(ref, dev, backend='auto', ckpt=Q.CKPT):
    """(operator, diffusion bundle holding ``ckpt``) of the reference's
    problem on ``dev``."""
    meta = ref['meta']
    op = FWIForward(dict(meta['ctx']), normalize=True,
                    v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend=backend,
                    chunk=meta['chunk'], device=dev)
    u = meta['unet']
    diffusion = GaussianDiffusion(
        Unet(dim=u['dim'], dim_mults=tuple(u['dim_mults']),
             channels=u['channels']),
        image_size=meta['image_size'], timesteps=meta['timesteps'],
        objective=meta['objective'], device=dev)
    load_diffusion_params(diffusion, str(ckpt))
    return op, diffusion


def run_trajectory(ref, dev, backend='auto', ckpt=Q.CKPT):
    """The port's ``optimize`` on the reference's problem (its ``mu0``,
    truths and observations) and draws. Returns a dict: ``mu`` {step:
    padded mu} at the reference's recorded steps, ``curves`` {name: (ts,
    B)}, ``seconds`` of the call, ``backend``."""
    dev = resolve_device(dev)
    meta = ref['meta']
    op, diffusion = build(ref, dev, backend, ckpt)
    engine = inversion.InversionEngine(
        diffusion, regularization='diffusion', sigma_x0=meta['sigma_x0'],
        device=dev)
    snaps = meta['snap_steps']
    every = snaps[0]
    if snaps != sorted(set(range(every, meta['ts'] + 1, every))
                       | {meta['ts']}):
        raise ValueError(f'recorded steps {snaps} are not every '
                         f'{every}th and the last')
    with tempfile.TemporaryDirectory() as tmp, fed_draws(ref, dev), \
            kept_snapshots() as kept:
        Q.sync(dev)
        t0 = time.perf_counter()
        _, per_model = engine.optimize(
            torch.tensor(ref['mu0']), torch.tensor(ref['v_true']),
            torch.tensor(ref['y']), op, ts=meta['ts'], lr=meta['lr'],
            reg_lambda=meta['reg_lambda'], regularization='diffusion',
            generator=Q.draws(dev), progress=False,
            checkpoint_path=str(Path(tmp) / 'snapshot.pt'),
            checkpoint_every=every)
        Q.sync(dev)
        seconds = time.perf_counter() - t0
    curves = {k: np.stack([pm[k] for pm in per_model], axis=1)
              for k in CURVES}
    return dict(mu=kept, curves=curves, seconds=seconds, backend=op.backend)


def compare(ref, res):
    """The step-by-step comparison of a :func:`run_trajectory` result with
    the reference, under :func:`allowance`. Returns a dict: ``steps``
    [(step, max |d mu|, cell, share beyond CELL_TOL, mean |d mu|, within
    PR 10's rule, within the allowance, the allowance)], ``spread`` the
    reference's own gap at each step (a :func:`mu_gap`; empty without
    ``spread_mu``), ``first_mu``
    (step, cell) where
    mu first leaves its allowance or None, ``first_pr10`` the step where
    it first leaves PR 10's rule or None, ``first_curve`` (step, name)
    where a loss or metric first leaves its allowance or None, ``ok``, and
    ``final`` {'jax'|'port': {MAE, RMSE, SSIM}}."""
    lr = ref['meta']['lr']
    allow = allowance(ref)
    steps, first_mu, first_pr10, first_curve = [], None, None, None
    spread = []
    for i, step in enumerate(ref['meta']['snap_steps']):
        if 'spread_mu' in ref:
            spread.append(mu_gap(ref['spread_mu'][i], ref['mu'][i]))
        d, cell, share, mean = mu_gap(res['mu'][step], ref['mu'][i])
        pr10 = d <= STEP_FRACTION * lr and share <= CELL_SHARE
        ok = d <= allow[0] and share <= allow[1] and mean <= allow[2]
        steps.append((step, d, cell, share, mean, pr10, ok, allow))
        if not pr10 and first_pr10 is None:
            first_pr10 = step
        if not ok and first_mu is None:
            first_mu = (step, cell)
        for k in CURVES:
            if first_curve is None and not curves_within(
                    res['curves'][k][step - 1], ref[k][step - 1],
                    allow[3][k]):
                first_curve = (step, k)
    final = {who: {k.upper(): float(np.mean(c[k][-1]))
                   for k in ('mae', 'rmse', 'ssim')}
             for who, c in (('jax', ref), ('port', res['curves']))}
    return dict(steps=steps, spread=spread, first_mu=first_mu,
                first_pr10=first_pr10, first_curve=first_curve,
                ok=first_mu is None and first_curve is None, final=final)


def report(ref, res, cmp) -> None:
    meta = ref['meta']
    print(f'reference: samples {meta.get("samples")} of '
          f'{meta.get("n_truths")}, {meta.get("obs")} observations, '
          f'ts={meta["ts"]}, JAX '
          f'{meta.get("jax")} on {meta.get("platform")}; port: '
          f'{res["backend"]} backend, {res["seconds"]:.2f} s', flush=True)
    for i, (step, d, cell, share, mean, pr10, ok,
            (a_d, a_share, a_mean, _)) in enumerate(cmp['steps']):
        own = ''
        if cmp['spread']:
            s_d, _, s_share, s_mean = cmp['spread'][i]
            own = (f'; JAX\'s own spread {s_d:.3e}, {s_share:.3%}, mean '
                   f'{s_mean:.3e}')
        print(f'step {step:4d}: max |d mu| {d:.3e} at (sample, row, col) '
              f'{cell}, {share:.3%} of cells beyond {CELL_TOL:g}, mean '
              f'{mean:.3e}{own} (allowed {a_d:.3e}, {a_share:.3%}, '
              f'{a_mean:.3e})'
              + ('' if pr10 else ', outside PR 10\'s rule')
              + ('' if ok else '  OUTSIDE THE ALLOWANCE'), flush=True)
    for k in CURVES:
        rel = np.abs(res['curves'][k] - ref[k]) / np.maximum(
            np.abs(ref[k]), 1e-30)
        own = ''
        if f'spread_{k}' in ref:
            s_rel = np.abs(ref[f'spread_{k}'] - ref[k]) / np.maximum(
                np.abs(ref[k]), 1e-30)
            own = f' (JAX\'s own spread {s_rel.max():.3e})'
        print(f'{k}: max rel diff {rel.max():.3e} (step '
              f'{int(np.argmax(rel.max(axis=1))) + 1}){own}', flush=True)
    print(f'first step where mu leaves PR 10\'s rule: {cmp["first_pr10"]}; '
          f'where it leaves the allowance: {cmp["first_mu"]}; where a loss '
          f'or metric leaves it: {cmp["first_curve"]}', flush=True)
    for who, m in cmp['final'].items():
        print(f'final {who}: MAE {m["MAE"]:.4f}  RMSE {m["RMSE"]:.4f}  '
              f'SSIM {m["SSIM"]:.4f}', flush=True)


def run_rows(ref, dev, obs=('refined', 'clean'), ckpt=Q.CKPT):
    """The RED rows of ``tools/eval_quality.py`` on a draws-only
    reference: {protocol: {'samples': [{MAE, RMSE, SSIM}], 'mean': {...},
    'seconds': s}}."""
    dev = resolve_device(dev)
    meta = ref['meta']
    n = meta['n_truths']
    if meta['samples'] != list(range(n)):
        raise ValueError('a quality row runs every truth: samples '
                         f'{meta["samples"]} of {n}')
    prob = Q.held_out_problem(dev, n=n, obs=tuple(obs), ckpt=ckpt)
    engine = inversion.InversionEngine(
        prob.diffusion, regularization='diffusion',
        sigma_x0=meta['sigma_x0'], device=dev)
    engine.warm_compile(prob.mu0.shape, prob.observations[obs[0]].shape,
                        prob.op, ts=meta['ts'], lr=meta['lr'],
                        reg_lambda=meta['reg_lambda'])
    rows = {}
    for name in obs:
        with fed_draws(ref, dev):
            Q.sync(dev)
            t0 = time.perf_counter()
            _, per_model = engine.optimize(
                prob.mu0, prob.v_true_t, prob.observations[name], prob.op,
                ts=meta['ts'], lr=meta['lr'], reg_lambda=meta['reg_lambda'],
                regularization='diffusion', generator=Q.draws(dev),
                progress=False)
            Q.sync(dev)
            seconds = time.perf_counter() - t0
        samples = [{k.upper(): float(pm[k][-1]) for k in ('mae', 'rmse',
                                                          'ssim')}
                   for pm in per_model]
        rows[name] = dict(samples=samples, mean=Q.final_metrics(per_model),
                          seconds=seconds)
        m = rows[name]['mean']
        print(f'{name:8s} diffusion on JAX\'s draws: MAE {m["MAE"]:.4f}  '
              f'RMSE {m["RMSE"]:.4f}  SSIM {m["SSIM"]:.4f}  '
              f'({seconds / n:.2f} s/sample); per sample SSIM '
              + ' '.join(f'{s["SSIM"]:.4f}' for s in samples), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--reference', type=Path, default=REFERENCE)
    p.add_argument('--ckpt', type=Path, default=Q.CKPT)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument('--save', type=Path, default=None,
                   help='write the port\'s mu at every recorded step and '
                        'its curves to this .npz')
    p.add_argument('--obs', nargs='+', default=['refined', 'clean'],
                   choices=['refined', 'clean'],
                   help='the protocols a draws-only reference runs')
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f'card: {Q.card_line(dev)}', flush=True)
    ref = load_reference(args.reference)
    if 'mu' not in ref:
        rows = run_rows(ref, dev, args.obs, args.ckpt)
        print(json.dumps({'rows': rows, 'card': Q.card_line(dev)}))
        return 0
    res = run_trajectory(ref, dev, ckpt=args.ckpt)
    if args.save is not None:
        steps = sorted(res['mu'])
        np.savez(args.save, steps=np.array(steps),
                 mu=np.stack([res['mu'][s] for s in steps]), **res['curves'])
    cmp = compare(ref, res)
    report(ref, res, cmp)
    print(json.dumps({'ok': cmp['ok'], 'first_mu': cmp['first_mu'],
                      'first_pr10': cmp['first_pr10'],
                      'first_curve': cmp['first_curve'],
                      'final': cmp['final'], 'seconds': res['seconds'],
                      'card': Q.card_line(dev)}))
    return 0 if cmp['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
