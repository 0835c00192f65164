"""The port's msgpack reader and flax-to-state_dict converter."""
from pathlib import Path

import msgpack
import numpy as np
import pytest

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
    with pytest.raises(FileNotFoundError):
        checkpoints.load_diffusion_params(diff, tmp_path / 'absent.ckpt')
