"""The port's msgpack reader and writer, and its converters between flax
parameter trees and the U-Net's ``state_dict``."""
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

from red_diffeq_tpu_torch.io import checkpoints
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet

CKPT = (Path(__file__).resolve().parents[1] / 'pretrained_models'
        / 'model-synthetic-ema.ckpt')


def _ext_hook(code, data):
    assert code == 1
    shape, dtype, buf = msgpack.unpackb(data)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_reader_matches_msgpack_on_shipped_prior():
    data = CKPT.read_bytes()
    want = _flat(msgpack.unpackb(data, ext_hook=_ext_hook))
    got = _flat(checkpoints.unpackb(data))
    assert len(got) == len(want) == 283
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def _ndarray_ext(a):
    return msgpack.ExtType(1, msgpack.packb(
        (list(a.shape), a.dtype.name, a.tobytes())))


@pytest.mark.parametrize('obj', [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, 1.5, -2.25e300,
    '', 'a' * 31, 'b' * 32, 'c' * 300, 'd' * 70000, b'', b'x' * 300,
    b'y' * 70000, [], list(range(15)), list(range(16)), list(range(70000)),
    {'k': 1}, {str(i): i for i in range(16)},
    {'nested': {'deep': [1, {'x': 'y'}]}},
])
def test_reader_matches_msgpack_on_every_type(obj):
    data = msgpack.packb(obj, use_single_float=False)
    assert checkpoints.unpackb(data) == msgpack.unpackb(data,
                                                        strict_map_key=False)


def test_reader_float32_and_ndarray_ext():
    assert checkpoints.unpackb(msgpack.packb(0.5, use_single_float=True)) \
        == 0.5
    for a in (np.arange(6, dtype=np.float32).reshape(2, 3),
              np.zeros((0,), np.int32), np.ones((1, 1, 1, 4), np.float64)):
        got = checkpoints.unpackb(msgpack.packb(_ndarray_ext(a)))
        assert got.dtype == a.dtype and got.shape == a.shape
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize('data', [b'\xc1', b'\x92\x01', b'\x01\x02',
                                  msgpack.packb(msgpack.ExtType(5, b'ab'))])
def test_reader_rejects_malformed(data):
    with pytest.raises(ValueError):
        checkpoints.unpackb(data)


def test_converter_matches_every_leaf_of_the_shipped_prior():
    raw = checkpoints.load_params(CKPT)
    model = Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
    sd = checkpoints.flax_to_state_dict(raw, model)
    assert len(sd) == len(model.state_dict()) == 283
    flat = _flat(raw)
    conv = sd['down_0_block1.block1.proj.weight'].numpy()
    np.testing.assert_array_equal(
        conv, flat[('down_0_block1', 'block1', 'proj', 'kernel')]
        .transpose(3, 2, 0, 1))
    dense = sd['time_dense_0.weight'].numpy()
    np.testing.assert_array_equal(dense,
                                  flat[('time_dense_0', 'kernel')].T)
    np.testing.assert_array_equal(
        sd['mid_attn.norm.g'].numpy()[0, :, 0, 0],
        flat[('mid_attn', 'norm', 'g')][0, 0, 0])
    np.testing.assert_array_equal(
        sd['down_0_block1.block1.norm.weight'].numpy(),
        flat[('down_0_block1', 'block1', 'norm', 'scale')])


def test_converter_raises_on_leftover_missing_or_misshapen_leaves():
    raw = checkpoints.load_params(CKPT)
    model = Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
    extra = dict(raw, stray={'kernel': np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match='stray'):
        checkpoints.flax_to_state_dict(extra, model)
    missing = {k: v for k, v in raw.items() if k != 'final_conv'}
    with pytest.raises(KeyError, match='final_conv'):
        checkpoints.flax_to_state_dict(missing, model)
    with pytest.raises(ValueError, match='shape'):
        checkpoints.flax_to_state_dict(
            raw, Unet(dim=32, dim_mults=(1, 2, 4, 8), channels=1))


def test_load_diffusion_params_accepts_bare_and_ema_trees(tmp_path):
    raw = checkpoints.load_params(CKPT)
    for name, tree in (('bare', raw), ('state', {'step': 3,
                                                 'ema_params': raw})):
        def pack(t):
            return {k: pack(v) if isinstance(v, dict) else
                    (_ndarray_ext(v) if isinstance(v, np.ndarray) else v)
                    for k, v in t.items()}
        path = tmp_path / f'{name}.ckpt'
        path.write_bytes(msgpack.packb(pack(tree)))
        diff = GaussianDiffusion(Unet(dim=64, dim_mults=(1, 2, 4, 8)),
                                 image_size=72, device='cpu')
        checkpoints.load_diffusion_params(diff, path)
        np.testing.assert_array_equal(
            diff.model.final_conv.bias.detach().numpy(),
            raw['final_conv']['bias'])
    # A missing file warns, naming the path, and keeps the weights, as the
    # JAX loader does.
    before = {k: t.clone() for k, t in diff.model.state_dict().items()}
    with pytest.warns(UserWarning, match='absent.ckpt'):
        out = checkpoints.load_diffusion_params(diff, tmp_path / 'absent.ckpt')
    assert out is diff
    for k, t in diff.model.state_dict().items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize('missing', ['absent.ckpt', None])
def test_load_diffusion_params_warns_on_a_missing_file(tmp_path, missing):
    """As ``red_diffeq_tpu.io.checkpoints.load_diffusion_params``: a missing
    file (or no path) warns and the model keeps its random weights."""
    path = None if missing is None else tmp_path / missing
    torch.manual_seed(1)
    diff = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=8,
                             device='cpu')
    before = {k: t.clone() for k, t in diff.model.state_dict().items()}
    named = 'None' if missing is None else f'.*{missing}'
    with pytest.warns(UserWarning,
                      match=f'pretrained model not found at {named}'):
        assert checkpoints.load_diffusion_params(diff, path) is diff
    after = diff.model.state_dict()
    assert all(torch.equal(after[k], t) for k, t in before.items())


OBJECTS = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
    -2 ** 63, 1.5, -2.25e300, '', 'a' * 31, 'b' * 32, 'c' * 300,
    'd' * 70000, b'', b'x' * 300, b'y' * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {'k': 1},
    {str(i): i for i in range(16)}, {'nested': {'deep': [1, {'x': 'y'}]}},
    (1, 'two')]


@pytest.mark.parametrize('obj', OBJECTS, ids=lambda o: repr(o)[:20])
def test_writer_matches_msgpack_on_every_type(obj):
    """``packb`` writes what ``msgpack.packb(..., use_bin_type=True)`` (as
    flax calls it) writes, byte for byte."""
    assert checkpoints.packb(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize('arr', [
    np.arange(6, dtype=np.float32).reshape(2, 3),
    np.arange(6, dtype=np.float32).reshape(2, 3).T, np.zeros((0,), np.int32),
    np.ones(()), np.ones((1, 1, 1, 4)), np.zeros(3, np.int8),
    np.zeros(70000, np.float32)], ids=lambda a: f'{a.dtype}{a.shape}')
def test_writer_ndarray_ext_matches_flax(arr):
    """An ndarray leaf is flax's ext type 1 around (shape, dtype name, C
    bytes), 0-d and transposed arrays included."""
    from flax import serialization
    want = serialization.msgpack_serialize({'a': arr})
    got = checkpoints.packb({'a': arr})
    assert got == want
    back = checkpoints.unpackb(got)['a']
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_writer_rewrites_the_shipped_prior_byte_for_byte():
    data = CKPT.read_bytes()
    assert checkpoints.packb(checkpoints.unpackb(data)) == data


def test_state_dict_to_flax_inverts_the_converter():
    raw = checkpoints.load_params(CKPT)
    model = Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
    back = checkpoints.state_dict_to_flax(
        checkpoints.flax_to_state_dict(raw, model))
    want, got = _flat(raw), _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def _small_unet_io(seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((2, 1, 16, 16)).astype(np.float32),
            np.array([3, 11], np.int32))


def test_save_params_round_trip_between_the_packages(tmp_path):
    """The port writes a dim-8 U-Net's weights with ``save_params``; JAX's
    ``load_params`` and ``load_diffusion_params`` read them and its U-Net
    gives the port's output (atol 1e-4, as the U-Net parity tests). Then
    the reverse: JAX's ``save_params`` writes, the port's
    ``load_diffusion_params`` reads."""
    import jax
    import jax.numpy as jnp
    from red_diffeq_tpu.io import checkpoints as jck
    from red_diffeq_tpu.models.diffusion import \
        GaussianDiffusion as JaxDiffusion
    from red_diffeq_tpu.models.unet import Unet as JaxUnet

    x, t = _small_unet_io(0)
    torch.manual_seed(4)
    port = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=16,
                             timesteps=10, device='cpu')
    path = tmp_path / 'port.ckpt'
    checkpoints.save_params(
        checkpoints.state_dict_to_flax(port.model.state_dict()), path)
    with torch.no_grad():
        want = port.model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    raw = jck.load_params(path)
    assert _flat(raw).keys() == _flat(checkpoints.load_params(path)).keys()
    jd = JaxDiffusion(JaxUnet(dim=8, dim_mults=(1, 2), channels=1),
                      image_size=16, timesteps=10)
    jck.load_diffusion_params(jd, str(path), verbose=False)
    got = np.asarray(jd.model.apply({'params': jd.params}, jnp.asarray(x),
                                    jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    jd.params = jax.tree.map(lambda p: p * 1.5, jd.params)
    back = tmp_path / 'jax.ckpt'
    jck.save_params(jd.params, back)
    fresh = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2)), image_size=16,
                              timesteps=10, device='cpu')
    checkpoints.load_diffusion_params(fresh, back)
    want = np.asarray(jd.model.apply({'params': jd.params}, jnp.asarray(x),
                                     jnp.asarray(t)))
    with torch.no_grad():
        got = fresh.model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not list(tmp_path.glob('*.tmp'))


def test_export_ema_reads_a_milestone_and_refuses_bare_trees(tmp_path):
    raw = checkpoints.load_params(CKPT)
    run = tmp_path / 'run'
    run.mkdir()
    with pytest.raises(FileNotFoundError, match='model-<k>.ckpt'):
        checkpoints.export_ema(run, 'latest', tmp_path / 'out.ckpt')
    for k in (2, 10):
        checkpoints.save_params({'step': k, 'ema_params': raw, 'version': ''},
                                run / f'model-{k}.ckpt')
    src = checkpoints.export_ema(run, 'latest', tmp_path / 'out.ckpt')
    assert src.name == 'model-10.ckpt'
    assert (tmp_path / 'out.ckpt').read_bytes() == CKPT.read_bytes()
    checkpoints.save_params(raw, run / 'model-11.ckpt')
    with pytest.raises(KeyError, match='ema_params'):
        checkpoints.export_ema(run, 11, tmp_path / 'bare.ckpt')
