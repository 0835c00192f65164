"""The port's U-Net on weights carried across from flax, against the JAX
``Unet.apply`` on the CPU (max abs difference 1e-4 on O(1) outputs; both
sides run fp32, the gap is summation order in convolutions and norms)."""
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu.models.unet import nearest_upsample as jax_upsample
from red_diffeq_tpu.models.unet import space_to_depth as jax_s2d
from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict, load_params
from red_diffeq_tpu_torch.models.unet import Unet, nearest_upsample, \
    space_to_depth

CKPT = (Path(__file__).resolve().parents[1] / 'pretrained_models'
        / 'model-synthetic-ema.ckpt')


def _numpy_tree(params):
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(params))


def test_small_unet_matches_flax():
    """dim 8, mults (1, 2): linear attention in stage 0, full attention in
    stage 1 and the middle."""
    jm = JaxUnet(dim=8, dim_mults=(1, 2), channels=1)
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t))[
        'params']
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x),
                               jnp.asarray(t)))
    tm = Unet(dim=8, dim_mults=(1, 2), channels=1)
    tm.load_state_dict(flax_to_state_dict(_numpy_tree(params), tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_shipped_prior_unet_matches_flax_at_full_width():
    """The dim-64 (1, 2, 4, 8) U-Net at 72x72 holding the shipped prior,
    read by the port's own reader."""
    raw = load_params(CKPT)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((1, 1, 72, 72)).astype(np.float32)
    t = np.array([500], np.int32)
    jm = JaxUnet(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
    want = np.asarray(jm.apply({'params': jax.tree.map(jnp.asarray, raw)},
                               jnp.asarray(x), jnp.asarray(t)))
    tm = Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
    tm.load_state_dict(flax_to_state_dict(raw, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('fn', ['space_to_depth', 'nearest_upsample'])
def test_resampling_matches_nhwc_layout(fn):
    """NCHW ops against the JAX NHWC ops, channels packed as (p1, p2, c)."""
    x = np.arange(2 * 3 * 4 * 6, dtype=np.float32).reshape(2, 3, 4, 6)
    port, ref = {'space_to_depth': (space_to_depth, jax_s2d),
                 'nearest_upsample': (nearest_upsample, jax_upsample)}[fn]
    want = np.asarray(ref(jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = port(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)


def test_unet_rejects_indivisible_input():
    tm = Unet(dim=8, dim_mults=(1, 2), channels=1)
    with pytest.raises(ValueError, match='divide'):
        tm(torch.zeros(1, 1, 15, 16), torch.zeros(1))
