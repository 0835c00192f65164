"""The port's TV, Tikhonov and patched RED against the JAX package on the
CPU: TV and Tikhonov and their gradients rtol 1e-6 (JAX's gradient of |x|
at 0 included); the window layout
exactly; the patched RED on a (2, 1, 18, 42) padded model (3 windows of a
dim-8 U-Net at 18x18) with JAX's draws, reg rtol 1e-4 and the gradient
field atol 1e-5, the k*B windows in one U-Net call."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu.regularization import benchmark as jbench
from red_diffeq_tpu.regularization import red as jred
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.regularization import benchmark, red

REG_FNS = {'tv': (jbench.total_variation_loss, benchmark.total_variation_loss),
           'l2': (jbench.tikhonov_loss, benchmark.tikhonov_loss)}


@pytest.mark.parametrize('name', sorted(REG_FNS))
def test_tv_and_tikhonov_match_jax(name):
    jfn, tfn = REG_FNS[name]
    # A zero pad ring, as the engine's models have: zero differences,
    # where JAX's |x| has gradient 1.
    mu = np.pad(np.random.RandomState(1).uniform(-1, 1, (3, 1, 12, 20)),
                ((0, 0), (0, 0), (1, 1), (1, 1))).astype(np.float32)
    want = jfn(jnp.asarray(mu))
    want_grad = jax.grad(lambda m: jfn(m).sum())(jnp.asarray(mu))
    x = torch.from_numpy(mu).requires_grad_(True)
    got = tfn(x)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize('w, h', [(190, 70), (70, 70), (100, 70), (141, 70),
                                  (40, 16)])
def test_calculate_patches_matches_jax(w, h):
    assert red.calculate_patches(w, h) == jred.calculate_patches(w, h)


@pytest.fixture(scope='module')
def pair():
    jd = JaxDiffusion(JaxUnet(dim=8, dim_mults=(1, 2), channels=1),
                      image_size=18, timesteps=20)
    jd.init_params(jax.random.PRNGKey(4))
    unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
    unet.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, flax.serialization.to_state_dict(
            jd.params)), unet))
    return jd, GaussianDiffusion(unet, image_size=18, timesteps=20,
                                 device='cpu')


def test_patched_red_matches_jax(pair):
    jd, td = pair
    mu = np.pad(np.random.RandomState(2).uniform(
        -0.8, 0.8, (2, 1, 16, 40)).astype(np.float32),
        ((0, 0), (0, 0), (1, 1), (1, 1)))
    key = jax.random.PRNGKey(9)
    jr = jred.RED_DiffEq(jd)

    def jloss(m):
        reg, grad_mean, t = jr.get_reg_loss_patched(m, key)
        return reg.sum(), (reg, grad_mean, t)

    jgrad, (jreg, jmean, jt) = jax.grad(jloss, has_aux=True)(
        jnp.asarray(mu))
    # JAX's draws: t, then the noise at the unpadded shape.
    kt, kn = jax.random.split(key)
    noise = np.array(jax.random.normal(kn, (2, 1, 16, 40)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(kt, (2,), 0, 20)), np.asarray(jt))

    calls = []
    hook = td.model.register_forward_hook(
        lambda m, args, out: calls.append(tuple(args[0].shape)))
    try:
        x = torch.from_numpy(mu).requires_grad_(True)
        reg, mean, t = red.RED_DiffEq(td).get_reg_loss_patched(
            x, t=torch.from_numpy(np.array(jt)).long(),
            noise=torch.from_numpy(noise))
        reg.sum().backward()
    finally:
        hook.remove()
    assert calls == [(6, 1, 18, 18)]
    np.testing.assert_allclose(reg.detach().numpy(), np.asarray(jreg),
                               rtol=1e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-4,
                               atol=1e-7)
    # d(reg_b)/d(mu) is the gradient field over the model's 16*40 cells,
    # zero on the pad ring.
    np.testing.assert_allclose(x.grad.numpy() * 640, np.asarray(jgrad) * 640,
                               atol=1e-5)
    assert not x.grad[:, :, 0].any() and not x.grad[:, :, :, -1].any()
