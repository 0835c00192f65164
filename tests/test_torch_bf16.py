"""The bf16 U-Net (``GaussianDiffusion(half_precision=True)``) and the
trainer's ``amp`` against the JAX package's, on the CPU.

A dim-8 (1, 2) U-Net at 16x16 with the JAX weights carried across. Both
packages run it in bf16 with fp32 input and output, and round in
different places (bf16 GroupNorm, attention and convolution
accumulations), so they agree to bf16's precision, not bit for bit:
measured on three seeds on the CPU, the outputs differ by 1.2-1.7% of the
largest fp32 output (each package's bf16 output lies as far from its own
fp32 output) and the amp losses by 0.02-0.08%. The bounds below are 5% of
that output and rtol 1e-2 on the loss. Each package's bf16 output stays within
0.1 of its fp32 output, relative to the largest fp32 value (the JAX
test's bound, ``tests/test_misc_coverage.py:46-55``).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.models import diffusion as jdiff
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu_torch.models import trainer as ttrainer
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet

SIZE, T = 16, 1000
BF16_GAP = 0.05       # port vs JAX, relative to the largest fp32 output
FP32_GAP = 0.1        # bf16 vs fp32 in each package, the JAX test's bound
LOSS_RTOL = 1e-2      # the amp loss, port vs JAX


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The tiny shapes run fastest on one thread, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair():
    jd = jdiff.GaussianDiffusion(JaxUnet(dim=8, dim_mults=(1, 2)),
                                 image_size=SIZE, timesteps=T,
                                 half_precision=True)
    jd.params = jax.jit(jd.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, SIZE, SIZE)),
        jnp.zeros((1,)))['params']
    params = jax.tree.map(np.asarray,
                          flax.serialization.to_state_dict(jd.params))
    td = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=SIZE,
                           timesteps=T, params=params, half_precision=True,
                           device='cpu')
    return jd, td, params


def _x(seed, n=2):
    return np.random.RandomState(seed).standard_normal(
        (n, 1, SIZE, SIZE)).astype(np.float32)


def test_bf16_apply_matches_jax_and_stays_near_fp32(pair):
    jd, td, _ = pair
    x, t = _x(1), np.array([3, 500])
    jbf16 = np.asarray(jax.jit(jd.apply_fn)(jnp.asarray(x), jnp.asarray(t)))
    j32 = np.asarray(jax.jit(jd.model.apply)(
        {'params': jd.params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = td.apply_fn(torch.from_numpy(x), torch.from_numpy(t))
        t32 = td.model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.dtype == torch.float32 and jbf16.dtype == np.float32
    got = got.numpy()
    scale = np.abs(j32).max()
    assert np.abs(got - jbf16).max() / scale < BF16_GAP
    assert np.abs(jbf16 - j32).max() / scale < FP32_GAP
    assert np.abs(got - t32).max() / np.abs(t32).max() < FP32_GAP
    assert np.abs(got - t32).max() > 0      # the bf16 path really ran


def test_bf16_keeps_adjacent_timesteps_apart(pair):
    """The timestep reaches the embedding in fp32: in bf16, 998 and 999
    would be one number."""
    _, td, _ = pair
    x = torch.from_numpy(np.repeat(_x(2, 1), 2, axis=0))
    with torch.no_grad():
        out = td.apply_fn(x, torch.tensor([998, 999]))
    assert not torch.equal(out[0], out[1])


def test_bf16_copy_follows_loaded_weights(pair):
    """The bf16 copy of the weights is made again after they change."""
    _, td, _ = pair
    first = td.bf16_params()
    assert td.bf16_params() is first
    with torch.no_grad():
        td.model.init_conv.bias.add_(1.0)
    try:
        second = td.bf16_params()
        assert second is not first
        assert torch.equal(second['init_conv.bias'],
                           td.model.init_conv.bias.to(torch.bfloat16))
    finally:
        with torch.no_grad():
            td.model.init_conv.bias.sub_(1.0)


def test_trainer_amp_loss_matches_jax(pair, tmp_path):
    """One amp train step on JAX's draws: the loss against the JAX
    trainer's amp loss (the U-Net on a bf16 cast of the fp32 weights); the
    master weights stay fp32 with finite gradients, as JAX's do."""
    jd, _, params = pair
    td = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=SIZE,
                           timesteps=T, params=params, device='cpu')
    img = np.random.RandomState(3).rand(16, 1, SIZE, SIZE).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def amp_loss(params, batch, k):
        p16 = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
        return jd.loss(p16, batch, k).astype(jnp.float32)

    want, grads = jax.jit(jax.value_and_grad(amp_loss))(
        jd.params, jnp.asarray(img), key)
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(grads))
    k, kt = jax.random.split(key)
    _, k_noise, _ = jax.random.split(k, 3)
    draws = dict(t=torch.from_numpy(np.array(
        jax.random.randint(kt, (16,), 0, T))).long(),
        noise=torch.from_numpy(np.asarray(
            jax.random.normal(k_noise, img.shape))))
    tr = ttrainer.Trainer(td, ttrainer.TensorDataset(img),
                          train_batch_size=16, save_and_sample_every=1000,
                          num_samples=4, results_folder=str(tmp_path),
                          amp=True)
    got = tr.train_step([torch.from_numpy(img)], draws=[draws])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tr.params)
