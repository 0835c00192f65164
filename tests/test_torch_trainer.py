"""The port's training loss and trainer against the JAX package's.

Both packages get the same numpy inputs; where the JAX function draws from
a key, the test draws with that key as the JAX code does and feeds the
draws to the port. Tolerances: the loss rtol 1e-5; its gradient atol 1e-5
/ rtol 1e-4 (the diffusion parity tests'); one train step's clipped,
averaged gradient rtol 1e-4 / atol 1e-6 (a tenth of the gradient's atol:
the clip scales it by a third; entries near 0 carry the summation
order); Adam's update on a fed gradient rtol 1e-6;
the EMA decay schedule rtol 1e-6; the frozen FID features atol 1e-5. The
JAX ``Trainer`` is not built (its scans compile slowly): its loss, optax's
clip and Adam, and its data and EMA functions are called directly.
"""
import json
import types
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from red_diffeq_tpu.models import diffusion as jdiff
from red_diffeq_tpu.models import trainer as jtrainer
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu_torch.io.checkpoints import (
    flax_to_state_dict, load_diffusion_params, state_dict_to_flax,
)
from red_diffeq_tpu_torch.models import trainer as ttrainer
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet

REPO = Path(__file__).resolve().parents[1]
SIZE, T = 16, 16


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The dim-8 U-Net at 16x16 runs fastest on one thread, and the suite's
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(params):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_PARAMS = {}


def _jax_params():
    """The JAX U-Net's initial weights, made once (``init`` jitted: op by op
    it takes several times longer)."""
    if not _PARAMS:
        init = jax.jit(JaxUnet(dim=8, dim_mults=(1, 2), channels=1).init)
        _PARAMS['p'] = init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, SIZE, SIZE)), jnp.zeros((1,)))[
            'params']
    return _PARAMS['p']


_JAX = {}


def _jax_diffusion(objective, kw):
    """The JAX denoiser of a case, with the JITted functions of its loss
    (one compile per case, shared by the tests)."""
    kw = dict(dict(min_snr_loss_weight=False, offset_noise_strength=0.0),
              **kw)
    key = (objective, tuple(sorted(kw.items())))
    if key not in _JAX:
        jd = jdiff.GaussianDiffusion(
            JaxUnet(dim=8, dim_mults=(1, 2), channels=1), image_size=SIZE,
            timesteps=T, objective=objective, **kw)
        jd.params = _jax_params()
        jd.value_and_grad = jax.jit(jax.value_and_grad(jd.loss))
        jd.p_losses_jit = jax.jit(jd.p_losses)
        _JAX[key] = jd
    return _JAX[key]


def _pair(objective='pred_noise', **kw):
    """A dim-8 (1, 2) denoiser at 16x16 in both packages, the port's with
    the JAX weights."""
    jd = _jax_diffusion(objective, kw)
    model = Unet(dim=8, dim_mults=(1, 2), channels=1)
    model.load_state_dict(flax_to_state_dict(_np_tree(jd.params), model))
    td = GaussianDiffusion(model, image_size=SIZE, timesteps=T,
                           objective=objective, device='cpu', **kw)
    return jd, td


def _images(seed, n=4):
    return np.random.RandomState(seed).rand(n, 1, SIZE, SIZE).astype(
        np.float32)


def _loss_draws(key, b, ons):
    """The draws of JAX's ``loss(params, img, key)``: t, then the noise and
    the offset of ``p_losses``."""
    key, kt = jax.random.split(key)
    t = jax.random.randint(kt, (b,), 0, T)
    _, k_noise, k_off = jax.random.split(key, 3)
    draws = dict(t=torch.from_numpy(np.array(t)).long(),
                 noise=torch.from_numpy(np.asarray(
                     jax.random.normal(k_noise, (b, 1, SIZE, SIZE)))))
    if ons > 0:
        draws['offset'] = torch.from_numpy(np.asarray(
            jax.random.normal(k_off, (b, 1))))
    return draws


CASES = [('pred_noise', False, 0.0), ('pred_x0', False, 0.0),
         ('pred_v', False, 0.0), ('pred_v', True, 0.1)]


@pytest.mark.parametrize('objective,min_snr,ons', CASES,
                         ids=lambda v: str(v))
def test_loss_and_its_gradient_match_jax(objective, min_snr, ons):
    """``p_losses`` on fed t, noise and offset, ``loss`` on JAX's draws
    (rtol 1e-5), and the gradient of ``loss`` against ``jax.grad``."""
    jd, td = _pair(objective, min_snr_loss_weight=min_snr,
                   offset_noise_strength=ons)
    img = _images(1, 8)
    key = jax.random.PRNGKey(7)
    draws = _loss_draws(key, len(img), ons)

    # p_losses on a normalised batch, its draws from the key it is given.
    x0 = img * 2.0 - 1.0
    t = np.array([0, 5, 11, 15, 1, 2, 8, 14])
    kp = jax.random.PRNGKey(3)
    want = jd.p_losses_jit(jd.params, jnp.asarray(x0), jnp.asarray(t), kp)
    _, k_noise, k_off = jax.random.split(kp, 3)
    noise = torch.from_numpy(np.asarray(jax.random.normal(k_noise, x0.shape)))
    offset = torch.from_numpy(np.asarray(jax.random.normal(k_off, (8, 1))))
    got = td.p_losses(torch.from_numpy(x0), torch.from_numpy(t), noise=noise,
                      offset=offset)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)

    loss, grads = jd.value_and_grad(jd.params, jnp.asarray(img), key)
    got = td.loss(torch.from_numpy(img), **draws)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    got.backward()
    g_port = state_dict_to_flax({n: p.grad for n, p in
                                 td.model.named_parameters()})
    want_g = dict(_flat(_np_tree(grads)))
    got_g = dict(_flat(g_port))
    assert got_g.keys() == want_g.keys()
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], atol=1e-5, rtol=1e-4,
                                   err_msg='/'.join(k))


def _trainer(td, tmp_path, **kw):
    args = dict(train_batch_size=4, gradient_accumulate_every=4,
                train_lr=1e-3, train_num_steps=6, save_and_sample_every=1000,
                num_samples=4, results_folder=str(tmp_path), seed=3)
    args.update(kw)
    return ttrainer.Trainer(td, ttrainer.TensorDataset(_images(2, 32)),
                            **args)


def test_train_step_clipped_accumulated_gradient_matches_optax(tmp_path):
    """Accumulation over 2 micro-batches with a clip that trips: the
    gradients summed and averaged as JAX's scan does, then optax's
    ``clip_by_global_norm`` (rtol 1e-4); the step's loss is the mean of the
    micro-batches' (rtol 1e-5)."""
    jd, td = _pair()
    data = _images(3, 16)
    mbs = [data[:8], data[8:]]
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    (l1, g1), (l2, g2) = (jd.value_and_grad(jd.params, jnp.asarray(mb), k)
                          for mb, k in zip(mbs, keys))

    @jax.jit
    def average(g1, g2):
        # JAX's scan: (0 + g1) + g2, over the micro-batch count.
        grads = jax.tree.map(lambda a, b: (a + b) / 2, g1, g2)
        return grads, optax.global_norm(grads)

    grads, norm = average(g1, g2)
    max_norm = float(norm) / 3.0
    clip = optax.clip_by_global_norm(max_norm)
    want = jax.jit(lambda g: clip.update(g, clip.init(g))[0])(grads)
    l_sum = float(l1) + float(l2)

    tr = _trainer(td, tmp_path, train_batch_size=8,
                  gradient_accumulate_every=2, max_grad_norm=max_norm)
    loss = tr.train_step([torch.from_numpy(mb) for mb in mbs],
                         draws=[_loss_draws(k, 8, 0.0) for k in keys])
    np.testing.assert_allclose(float(loss), l_sum / 2, rtol=1e-5)
    got = dict(_flat(state_dict_to_flax({n: p.grad for n, p in zip(
        tr.names, tr.params)})))
    for k, w in _flat(_np_tree(want)):
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                   err_msg='/'.join(k))
    assert tr.step == 1


def test_clip_below_the_norm_leaves_the_gradient_alone():
    g = [torch.tensor([3.0, -4.0]), torch.tensor([[0.5]])]
    want = [t.clone() for t in g]
    ttrainer.clip_by_global_norm(g, 100.0)
    assert all(torch.equal(a, b) for a, b in zip(g, want))
    norm = ttrainer.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(25.25), rtol=1e-7)
    np.testing.assert_allclose(
        float(torch.linalg.vector_norm(torch.cat([t.ravel() for t in g]))),
        1.0, rtol=1e-6)


def test_adam_update_matches_optax():
    """optax's ``adam(lr, b1=0.9, b2=0.99)`` (eps 1e-8, eps_root 0) and the
    port's on the same fed gradients, three steps: rtol 1e-6."""
    rng = np.random.RandomState(5)
    shapes = [(3, 4), (7,), (2, 1, 3, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = optax.adam(2e-4, b1=0.9, b2=0.99)
    state = opt.init([jnp.asarray(p) for p in params])
    port = ttrainer.Adam([torch.from_numpy(p) for p in params], 2e-4,
                         b1=0.9, b2=0.99)
    for _ in range(3):
        g = [rng.standard_normal(s).astype(np.float32) * 1e-2
             for s in shapes]
        want, state = opt.update([jnp.asarray(x) for x in g], state)
        got = port.update([torch.from_numpy(x) for x in g])
        for w, o in zip(want, got):
            np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6)
    assert port.count == 3


def test_ema_decay_schedule_matches_jax():
    cfg = jtrainer.EMAConfig(decay=0.995, update_every=10)
    want = np.asarray(jtrainer._ema_decay_at(jnp.arange(2001), cfg))
    got = np.array([ttrainer._ema_decay_at(s, ttrainer.EMAConfig(
        decay=0.995, update_every=10)) for s in range(2001)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[101] == 0.0 and got[102] > 0.0 and got[-1] <= 0.995


def test_ema_gate_and_warmup(tmp_path):
    """The EMA moves only when the step is a multiple of update_every; a
    copy of the params while the decay is 0, then e*d + p*(1 - d)."""
    _, td = _pair()
    tr = _trainer(td, tmp_path, ema_update_every=3, device_data=False)
    before = [e.clone() for e in tr.ema_params]
    for step in range(1, 7):
        ema_prev = [e.clone() for e in tr.ema_params]
        tr.train_step(tr._next_batches())
        moved = any(not torch.equal(a, b)
                    for a, b in zip(ema_prev, tr.ema_params))
        assert moved == (step % 3 == 0), step
        if step % 3 == 0:
            assert all(torch.equal(e, p) for e, p in
                       zip(tr.ema_params, tr.params))
    assert not all(torch.equal(a, b) for a, b in zip(before, tr.ema_params))
    tr.ema_cfg.update_after_step = 0
    ema_prev = [e.clone() for e in tr.ema_params]
    for _ in range(3):
        tr.train_step(tr._next_batches())
    d = np.float32(ttrainer._ema_decay_at(tr.step, tr.ema_cfg))
    assert 0.0 < d < 0.995
    for e, e0, p in zip(tr.ema_params, ema_prev, tr.params):
        want = (e0.numpy() * d + p.detach().numpy() * (np.float32(1) - d))
        np.testing.assert_array_equal(e.numpy(), want.astype(np.float32))


def test_batch_stream_matches_jax(tmp_path):
    """The micro-batches of the port's trainer, gathered on the device or
    sampled on the host, are the JAX trainer's for the same seed
    (``_next_idx_np``, ``TensorDataset.sample_batch``)."""
    _, td = _pair()
    data = _images(4, 40)
    fake = types.SimpleNamespace(dataset=jtrainer.TensorDataset(data),
                                 _np_rng=np.random.RandomState(9),
                                 batch_size=5, grad_accum=3)
    idx = jtrainer.Trainer._next_idx_np(fake, 4)           # (4, 3, 5)
    for device_data in (True, False):
        tr = ttrainer.Trainer(td, ttrainer.TensorDataset(data),
                              train_batch_size=5,
                              gradient_accumulate_every=4, seed=9,
                              results_folder=str(tmp_path),
                              device_data=device_data)
        tr.grad_accum = 3
        assert tr._device_data == device_data
        tr._data_dev = torch.from_numpy(data)
        for k in range(4):
            got = torch.stack(tr._next_batches()).numpy()
            np.testing.assert_array_equal(got, data[idx[k]])
    off = ttrainer.Trainer(td, ttrainer.TensorDataset(data),
                           train_batch_size=16, results_folder=str(tmp_path),
                           device_data_max_bytes=data.nbytes - 1)
    assert not off._device_data


def test_fid_weights_and_features_match_jax():
    """The shipped weights equal ``_frozen_feature_weights()`` bit for bit;
    the features (XLA 'SAME' padding at stride 2: 72 -> 36 -> 18 -> 9 -> 5)
    match ``_frozen_feature_apply`` at atol 1e-5; the Frechet distance
    matches JAX's."""
    ws = ttrainer.frozen_feature_weights()
    for a, b in zip(ws, jtrainer._frozen_feature_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    w_t = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
           for w in ws]
    rng = np.random.RandomState(6)
    feats = {}
    for size in (72, 16, 9):
        x = rng.rand(5, 1, size, size).astype(np.float32) * 2 - 1
        want = np.asarray(jtrainer._frozen_feature_apply(
            jtrainer._frozen_feature_weights(),
            jnp.asarray(x.transpose(0, 2, 3, 1))))
        got = ttrainer.frozen_feature_apply(w_t, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        feats[size] = got.astype(np.float64)
    a, b = rng.randn(60, 8), rng.randn(50, 8) + 0.5
    assert ttrainer.frechet_distance(a, b) == pytest.approx(
        jtrainer.frechet_distance(a, b), rel=1e-12)
    assert ttrainer.frechet_distance(a, a.copy()) == pytest.approx(0.0,
                                                                  abs=1e-6)


def test_image_folder_dataset_matches_jax(tmp_path):
    """The same files and RandomState give JAX's batches; PIL decodes."""
    from PIL import Image
    sub = tmp_path / 'a' / 'b'
    sub.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, (w, h) in enumerate([(20, 30), (16, 16), (40, 18)]):
        Image.fromarray(rng.randint(0, 255, size=(h, w), dtype=np.uint8),
                        mode='L').save(sub / f'img{i}.png')
    for flip in (False, True):
        kw = dict(image_size=16, convert_image_to='L',
                  augment_horizontal_flip=flip)
        got = ttrainer.ImageFolderDataset(tmp_path, **kw).sample_batch(
            np.random.RandomState(1), 6)
        want = jtrainer.ImageFolderDataset(tmp_path, **kw).sample_batch(
            np.random.RandomState(1), 6)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        ttrainer.ImageFolderDataset(tmp_path / 'empty', image_size=16)


def test_amp_and_batch_asserts_raise(tmp_path):
    """``amp`` is ported (its parity is in test_torch_bf16.py): a train
    step keeps fp32 master weights with finite gradients. The batch
    asserts raise as in JAX."""
    _, td = _pair()
    tr = _trainer(td, tmp_path, amp=True)
    loss = tr.train_step([torch.from_numpy(_images(5, 4))] * 4)
    assert np.isfinite(float(loss))
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tr.params)
    with pytest.raises(AssertionError, match='at least 16'):
        _trainer(td, tmp_path, gradient_accumulate_every=1)
    with pytest.raises(AssertionError, match='square root'):
        _trainer(td, tmp_path, num_samples=5)


def test_resume_continues_the_streams_and_keeps_history(tmp_path):
    """An uninterrupted 6-step run and 3 steps + milestone + load + 3 give
    the same losses (the RNG sidecar restores the batch-index stream and
    the noise generator); ``keep_last_checkpoints`` prunes; the FID history
    is truncated to the resumed step; saves leave no .tmp file."""
    _, td = _pair()
    state = {k: v.clone() for k, v in td.model.state_dict().items()}

    def make(steps, folder, **kw):
        td.model.load_state_dict(state)
        return _trainer(td, folder, train_num_steps=steps,
                        save_and_sample_every=3, **kw)

    straight = make(6, tmp_path / 'a')
    straight.train(log_every=1000)
    ref = [e['loss'] for e in straight.training_losses]
    assert [e['step'] for e in straight.training_losses] == list(range(6))

    first = make(3, tmp_path / 'b')
    first.train(log_every=1000)
    assert (tmp_path / 'b' / 'rng-1.npz').exists()
    second = make(6, tmp_path / 'b', keep_last_checkpoints=1)
    second.load(1)
    assert second.step == 3
    second.train(log_every=1000)
    np.testing.assert_allclose([e['loss'] for e in second.training_losses],
                               ref, rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / 'b').glob('model-*.ckpt')) \
        == ['model-2.ckpt']
    assert np.load(tmp_path / 'b' / 'sample-2.npy').shape == (4, 1, SIZE,
                                                              SIZE)
    meta = json.loads((tmp_path / 'b' / 'training_losses-2.json')
                      .read_text())
    assert meta['num_losses'] == 6 and meta['step'] == 6
    for a, b in zip(straight.params, second.params):
        assert torch.equal(a, b)

    prior = [{'step': 3, 'milestone': 1, 'fid_frozen': 12.5},
             {'step': 99, 'milestone': 7, 'fid_frozen': 9.9}]
    (tmp_path / 'b' / 'fid_scores.json').write_text(json.dumps(prior))
    third = make(6, tmp_path / 'b')
    third.load(2)
    assert third.fid_scores == prior[:1]
    assert list((tmp_path / 'b').glob('*.tmp')) == []


def test_milestone_fid_and_ema_load_in_both_packages(tmp_path):
    """A milestone with ``calculate_fid``: a finite score in
    ``fid_scores.json``, and the checkpoint's ``ema_params`` loaded by the
    port's and JAX's ``load_diffusion_params`` equal the trainer's EMA."""
    from red_diffeq_tpu.io.checkpoints import \
        load_diffusion_params as jax_load
    jd, td = _pair()
    tr = _trainer(td, tmp_path, train_num_steps=2, save_and_sample_every=2,
                  calculate_fid=True, num_fid_samples=6, ema_update_every=1)
    tr.train(log_every=1)
    scores = json.loads((tmp_path / 'fid_scores.json').read_text())
    assert len(scores) == 1 and np.isfinite(scores[0]['fid_frozen'])
    ckpt = tmp_path / 'model-1.ckpt'
    fresh = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=SIZE,
                              timesteps=T, device='cpu')
    load_diffusion_params(fresh, ckpt)
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, dict(zip(tr.names, tr.ema_params))[n]), n
    jax_load(jd, str(ckpt), verbose=False)
    want = state_dict_to_flax(dict(zip(tr.names, tr.ema_params)))
    for k, v in _flat(_np_tree(jd.params)):
        np.testing.assert_array_equal(v, dict(_flat(want))[k])


def test_train_cli_end_to_end_and_export(tmp_path):
    """``red-diffeq-torch-train`` on the CPU for two steps on velocities
    from ``red-diffeq-torch-datagen``: a milestone that
    ``tools/export_ema_torch.py`` turns into a bare EMA prior, which the
    port loads into a fresh dim-8 U-Net."""
    import importlib.util
    from red_diffeq_tpu_torch.cli import datagen, diffusion_train

    datagen.main(['--out', str(tmp_path / 'ds'), '--n', '10', '--height',
                  '14', '--width', '14', '--families', 'FlatVel',
                  'CurveFault', '--velocity_only', '--device', 'cpu'])
    run = tmp_path / 'run'
    tr = diffusion_train.main([
        '--data_dir', str(tmp_path / 'ds' / 'Velocity_Data'),
        '--image_size', '16', '--dim', '8', '--batch_size', '16',
        '--train_num_steps', '2', '--save_every', '2', '--timesteps', '250',
        '--results_folder', str(run), '--device', 'cpu'])
    assert tr.step == 2 and len(tr.training_losses) == 2
    assert len(tr.dataset) == 18           # 9 of 10 per family
    sample = np.load(run / 'sample-1.npy')
    assert sample.shape == (25, 1, 16, 16)
    assert sample.min() >= 0.0 and sample.max() <= 1.0

    spec = importlib.util.spec_from_file_location(
        'export_ema_torch', REPO / 'tools' / 'export_ema_torch.py')
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.main(['--run', str(run), '--out', str(tmp_path / 'ema.ckpt')])
    prior = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2, 4, 8)),
                              image_size=16, timesteps=250, device='cpu')
    load_diffusion_params(prior, out)
    for n, p in prior.model.named_parameters():
        assert torch.equal(p, dict(zip(tr.names, tr.ema_params))[n]), n
