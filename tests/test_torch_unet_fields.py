"""The U-Net's full constructor and the reference-checkpoint converter,
against the JAX package on the CPU.

Each of the 13 fields beyond ``dim``, ``dim_mults`` and ``channels`` at
dim 8: the port's ``Unet`` with it, its weights carried across by
``state_dict_to_flax`` into the JAX ``Unet`` with it (the tree the JAX
model's ``init`` would make, leaf for leaf and shape for shape; back by
``flax_to_state_dict`` bit for bit), the two forwards on the same input
within max abs 1e-4
(``tests/test_torch_unet.py``'s tolerance). ``x_self_cond`` through
``GaussianDiffusion.p_sample_deterministic``. ``tools/
torch_convert_checkpoint.py`` and ``tools/convert_torch_checkpoint.py``
on one state dict in the upstream layout, made from the shipped prior by
the port tool's inverse: equal trees, and the prior back bit for bit.
"""
import inspect
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_diffeq_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from red_diffeq_tpu.models.unet import Unet as JaxUnet
from red_diffeq_tpu_torch.io.checkpoints import (
    _flatten, flax_to_state_dict, load_params, state_dict_to_flax,
)
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / 'pretrained_models' / 'model-synthetic-ema.ckpt'
sys.path.insert(0, str(REPO / 'tools'))
import convert_torch_checkpoint as jax_tool  # noqa: E402
import torch_convert_checkpoint as port_tool  # noqa: E402

BASE = dict(dim=8, dim_mults=(1, 2), channels=1)
# One case per field of the JAX Unet beyond BASE's.
FIELDS = {
    'init_dim': dict(init_dim=16),
    'out_dim': dict(out_dim=3),
    'self_condition': dict(self_condition=True),
    'resnet_block_groups': dict(resnet_block_groups=4),
    'learned_variance': dict(learned_variance=True),
    'learned_sinusoidal_cond': dict(learned_sinusoidal_cond=True),
    'random_fourier_features': dict(random_fourier_features=True),
    'learned_sinusoidal_dim': dict(learned_sinusoidal_cond=True,
                                   learned_sinusoidal_dim=8),
    'sinusoidal_pos_emb_theta': dict(sinusoidal_pos_emb_theta=100.0),
    'attn_dim_head': dict(attn_dim_head=(8, 16)),
    'attn_heads': dict(attn_heads=(2, 3)),
    'full_attn': dict(full_attn=(True, False)),
    'flash_attn': dict(flash_attn=True),
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(kw, seed=1):
    """The JAX U-Net with ``kw``, the port's U-Net with ``kw`` and random
    weights (torch's generator seeded with ``seed``), and those weights as
    a flax tree, which must have the JAX model's structure and shapes."""
    jm = JaxUnet(**BASE, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 16, 16)), jnp.zeros((1,)))
    torch.manual_seed(seed)
    tm = Unet(**BASE, **kw)
    params = state_dict_to_flax(tm.state_dict())
    want = {k: v.shape for k, v in _flatten(
        flax.serialization.to_state_dict(shapes['params']))}
    assert {k: v.shape for k, v in _flatten(params)} == want
    return jm, params, tm


def test_the_fields_follow_the_jax_order_and_defaults():
    jsig = inspect.signature(JaxUnet.__init__).parameters
    tsig = inspect.signature(Unet.__init__).parameters
    fields = [n for n in jsig if n not in ('self', 'parent', 'name')]
    assert len(fields) == 16 and list(tsig)[1:] == fields
    for n in fields:
        assert tsig[n].default == jsig[n].default, n
    assert set(FIELDS) == set(fields) - set(BASE)


@pytest.mark.parametrize('field', sorted(FIELDS))
def test_each_field_matches_jax(field):
    kw = FIELDS[field]
    jm, params, tm = _pair(kw)
    assert all(torch.equal(v, tm.state_dict()[k])
               for k, v in flax_to_state_dict(params, tm).items())
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    cond = rng.standard_normal(x.shape).astype(np.float32)
    apply = jax.jit(jm.apply)
    for c in ((None, cond) if kw.get('self_condition') else (None,)):
        want = np.asarray(apply(
            {'params': params}, jnp.asarray(x), jnp.asarray(t),
            None if c is None else jnp.asarray(c)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), torch.from_numpy(t),
                     None if c is None else torch.from_numpy(c)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_random_fourier_weights_stay_fixed_in_training(tmp_path):
    """The JAX model stops their gradient; the port's train step leaves
    them where they were, and learns the learned ones."""
    from red_diffeq_tpu_torch.models.trainer import TensorDataset, Trainer
    data = np.random.RandomState(0).rand(16, 1, 16, 16).astype(np.float32)
    kept = {}
    for fixed in (True, False):
        torch.manual_seed(0)
        unet = Unet(**BASE, learned_sinusoidal_cond=not fixed,
                    random_fourier_features=fixed)
        d = GaussianDiffusion(unet, image_size=16, timesteps=20,
                              device='cpu')
        before = unet.sinu_pos_emb.weights.detach().clone()
        tr = Trainer(d, TensorDataset(data), train_batch_size=16,
                     train_num_steps=1, save_and_sample_every=1000,
                     results_folder=str(tmp_path / str(fixed)),
                     device_data=False)
        tr.train_step(tr._next_batches())
        kept[fixed] = torch.equal(unet.sinu_pos_emb.weights, before)
    assert kept == {True: True, False: False}


def test_self_condition_through_p_sample_deterministic():
    """The posterior mean and x_start with ``x_self_cond`` against JAX's;
    without it the port conditions on zeros, as the JAX model does."""
    jm, params, tm = _pair(dict(self_condition=True), seed=4)
    jd = JaxDiffusion(jm, image_size=16, timesteps=20, params=params)
    td = GaussianDiffusion(tm, image_size=16, timesteps=20, device='cpu')
    assert td.self_condition and jd.self_condition
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 1, 16, 16)).astype(np.float32)
    cond = rng.uniform(-1, 1, x.shape).astype(np.float32)
    want = jax.jit(jd.p_sample_deterministic)(
        jnp.asarray(x), jnp.int32(7), jnp.asarray(cond))
    with torch.no_grad():
        got = td.p_sample_deterministic(torch.from_numpy(x), 7,
                                        torch.from_numpy(cond))
        bare = td.p_sample_deterministic(torch.from_numpy(x), 7)
        zeros = td.p_sample_deterministic(torch.from_numpy(x), 7,
                                          torch.zeros(x.shape))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(bare, zeros))
    assert not torch.equal(bare[0], got[0])


def test_both_converters_give_equal_trees_and_the_prior_back(tmp_path):
    """The shipped prior in the upstream layout (``model.``-prefixed in a
    ``model-<k>.pt`` dict) through the port tool's ``main``, and the same
    state dict through the JAX tool's ``convert_state_dict``."""
    tree = load_params(CKPT)
    upstream = port_tool.to_upstream(tree, 64, (1, 2, 4, 8))
    pt = tmp_path / 'model-4.pt'
    torch.save({'step': 4, 'version': '1.0', 'model': {
        f'model.{k}': torch.from_numpy(np.array(v))
        for k, v in upstream.items()}}, pt)
    out = tmp_path / 'model-4.ckpt'
    got = port_tool.main([str(pt), str(out), '--source', 'model'])
    want = jax_tool.convert_state_dict(upstream, 64, (1, 2, 4, 8))
    got, want = dict(_flatten(got)), dict(_flatten(want))
    prior, written = dict(_flatten(tree)), dict(_flatten(load_params(out)))
    assert got.keys() == want.keys() == prior.keys() == written.keys()
    assert len(prior) == 283
    for k in prior:
        for other in (got, want, written):
            assert other[k].dtype == prior[k].dtype
            np.testing.assert_array_equal(other[k], prior[k], err_msg=str(k))
