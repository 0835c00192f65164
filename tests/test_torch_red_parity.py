"""The RED-DiffEq inversion loop over depth, port against JAX, on JAX's own
draws.

Both cases run the port through ``tools/torch_red_parity.py`` (its draws
fed through ``core/inversion.py:_step_draws``, ``mu`` read at every step)
and hold it to the tool's allowance: PR 10's rule for two runs of Adam
(``mu`` within 1e-4 on all but 1% of the cells and within 0.1 lr on every
cell, the losses and metrics within rtol 1e-4, atol 1e-6), each measure
widened to twice the most the JAX package's own run from ``mu0`` nudged
one ulp departs over the run, where that is wider.

* A small grid over depth: the shipped prior (dim-64 (1, 2, 4, 8) U-Net)
  at T=1000 on a 22x22 model padded to 24x24 (divisible by 8), nbc=16,
  nt=150, 2 shots, batch 2, for 20 ``optimize`` steps of
  ``tools/make_red_parity_reference.py``'s JAX run (``backend='xla'``)
  against the port's plain path.
* The committed full-width reference (``tests/data/red_parity_reference.npz``:
  the quality tools' held-out problem, sample 0, refined observations,
  nbc=120, nt=1000, 5 shots, 72x72): its first step against the port's
  plain path. Adam's first step does not depend on ``ts`` (the cosine
  schedule starts at lr), so the reference's first step is run as a
  one-step run.

The per-sample L1 is held to JAX's gradient at exact ties (residual 0),
with and without a trace mask: ``torch.abs`` has gradient 0 there, and
the port's loss had it until the card's quality rows showed the
difference (``PERF.md`` §6, PR 22).
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.core.losses import observation_loss as jax_obs_loss
from red_diffeq_tpu.io.synthetic import generate_mixed_dataset
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI
from red_diffeq_tpu.utils import data_trans as jdt
from red_diffeq_tpu_torch.core.losses import observation_loss

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / 'pretrained_models' / 'model-synthetic-ema.ckpt'
REFERENCE = REPO / 'tests' / 'data' / 'red_parity_reference.npz'
SMALL = dict(n_grid=22, nt=150, dx=10.0, dt=0.001, nbc=16, f=15.0, sz=10,
             gz=10, ng=22, ns=2)
STEPS = 20



@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The port runs on one thread here: the suite's workers share the
    cores, and a full-width step's many small operations on more threads a
    worker only wait on each other (40x slower under a full run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tools():
    return _tool('make_red_parity_reference'), _tool('torch_red_parity')


def _check(tool, ref, res):
    cmp = tool.compare(ref, res)
    tool.report(ref, res, cmp)
    assert cmp['first_mu'] is None, f'mu leaves the tolerance at {cmp}'
    assert cmp['first_curve'] is None, f'a curve leaves it at {cmp}'
    return cmp


@pytest.mark.parametrize('masked', [False, True])
def test_observation_loss_gradient_at_zero_residual_matches_jax(masked):
    """A third of the samples have a residual of exactly 0; the gradient in
    the prediction is held to ``jax.grad`` bit for bit."""
    rng = np.random.RandomState(3)
    y = rng.standard_normal((2, 3, 40, 8)).astype(np.float32)
    pred = y + rng.standard_normal(y.shape).astype(np.float32)
    pred[:, :, :14] = y[:, :, :14]
    mask = np.ones_like(y)
    if masked:
        mask[:, :, :, 2] = 0.0
    want_loss, want = jax.value_and_grad(lambda p: jax_obs_loss(
        p, jnp.asarray(y), jnp.asarray(mask)).sum())(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = observation_loss(p, torch.from_numpy(y),
                            torch.from_numpy(mask)).sum()
    got, = torch.autograd.grad(loss, p)
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    assert np.count_nonzero(np.asarray(want)[:, :, :14] * mask[:, :, :14])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_red_loop_over_depth_matches_jax_on_its_draws(tools):
    maker, tool = tools
    v_true = generate_mixed_dataset(4, h=22, w=22, seed=7777)[:2]
    op = JaxFWI(SMALL, normalize=True, v_denorm_func=jdt.v_denormalize,
                s_norm_func=jdt.s_normalize_none, backend='xla', chunk=20)
    y = np.asarray(op(jdt.v_normalize(jnp.asarray(v_true))))
    init = np.concatenate([jdt.prepare_initial_model(
        v_true[b:b + 1], 'smoothed', sigma=3.0) for b in range(2)])
    mu0 = np.pad(init, ((0, 0), (0, 0), (1, 1), (1, 1))).astype(np.float32)
    ref = maker.make_reference(
        maker.prior_bundle(CKPT, image_size=24), SMALL, op, v_true, y, mu0,
        STEPS, confirm=False, log=lambda m: None)
    assert len(set(ref['t'].ravel().tolist())) > 20
    res = tool.run_trajectory(ref, 'cpu', 'plain', ckpt=CKPT)
    cmp = _check(tool, ref, res)
    assert len(cmp['steps']) == STEPS
    assert ref['ssim'][-1].mean() > ref['ssim'][0].mean()


def test_full_width_reference_first_step_matches_the_plain_path(tools):
    _, tool = tools
    ref = tool.load_reference(REFERENCE)
    meta = ref['meta']
    assert (meta['ctx']['n_grid'], meta['ctx']['nt'], meta['ctx']['nbc'],
            meta['image_size'], meta['timesteps']) == (70, 1000, 120, 72,
                                                       1000)
    assert ref['mu'].shape == (meta['ts'], 1, 1, 72, 72)
    first = {k: v[:1] for k, v in ref.items()
             if k not in ('meta', 'mu0', 'v_true', 'y')}
    first.update(mu0=ref['mu0'], v_true=ref['v_true'], y=ref['y'],
                 meta=dict(meta, ts=1, snap_steps=[1]))
    res = tool.run_trajectory(first, 'cpu', 'plain', ckpt=CKPT)
    _check(tool, first, res)
