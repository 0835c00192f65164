"""Denoiser weights: the flax msgpack checkpoint into the port's U-Net.

The shipped prior (``pretrained_models/model-synthetic-ema.ckpt``) is a flax
``serialization.to_bytes`` file: a msgpack map of maps whose leaves are
msgpack ext type 1, each payload a msgpack-packed
``(shape, dtype name, raw bytes)``. :func:`unpackb` reads that format in
pure Python and numpy, so the port needs neither ``msgpack`` nor ``flax``.
:func:`flax_to_state_dict` carries a flax parameter tree across to the
``state_dict`` of :class:`red_diffeq_tpu_torch.models.unet.Unet`, inverting
the layout moves of ``tools/convert_torch_checkpoint.py``.
"""
import struct
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

# flax's ext type for a numpy array (flax/serialization.py _MsgpackExtType).
_EXT_NDARRAY = 1


class _Reader:
    """Decoder for the msgpack subset that flax writes: maps, arrays, str,
    bin, ints, floats, nil, bool and ext type 1 (ndarray)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in fixed:
            return fixed[b]
        sized = {
            0xc4: ('>B', self.bin), 0xc5: ('>H', self.bin),
            0xc6: ('>I', self.bin),
            0xd9: ('>B', self.str), 0xda: ('>H', self.str),
            0xdb: ('>I', self.str),
            0xdc: ('>H', self.array), 0xdd: ('>I', self.array),
            0xde: ('>H', self.map), 0xdf: ('>I', self.map),
            0xc7: ('>B', self.ext), 0xc8: ('>H', self.ext),
            0xc9: ('>I', self.ext),
        }
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        scalars = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def array(self, n):
        return [self.read() for _ in range(n)]

    def str(self, n):
        return bytes(self.take(n)).decode('utf-8')

    def bin(self, n):
        return bytes(self.take(n))

    def ext(self, n):
        code = self.unpack('>b')
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f'unsupported msgpack ext type {code}')
        shape, dtype, buf = unpackb(payload)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def unpackb(data: bytes):
    """Decode one msgpack object; flax ndarray leaves become numpy arrays."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError('trailing bytes after the msgpack object')
    return out


def load_params(path) -> dict:
    """The raw flax state dict stored at ``path``."""
    return unpackb(Path(path).read_bytes())


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(tree: dict, model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """Carry a flax U-Net parameter tree of numpy arrays across to
    ``model``'s ``state_dict``.

    Layout moves (the inverse of ``tools/convert_torch_checkpoint.py``):
    conv kernel HWIO -> OIHW, dense kernel (I, O) -> (O, I), GroupNorm
    ``scale`` -> ``weight``, RMSNorm ``g`` (1, 1, 1, C) -> (1, C, 1, 1).
    Raises on a leaf left over, a parameter missing, or a shape mismatch."""
    want = model.state_dict()
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        *mods, name = path
        if name == 'kernel':
            name = 'weight'
            arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                   else arr.transpose(1, 0))
        elif name == 'scale':
            name = 'weight'
        elif name == 'g':
            arr = arr.transpose(0, 3, 1, 2)
        key = '.'.join([*mods, name])
        if key not in want:
            raise KeyError(f'checkpoint leaf {"/".join(path)} has no '
                           f'counterpart {key!r} in the model')
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f'{key}: checkpoint shape {arr.shape} vs model '
                             f'{tuple(want[key].shape)}')
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f'model parameters missing from the checkpoint: '
                       f'{missing}')
    return out


def load_diffusion_params(diffusion, path: Union[str, Path]):
    """Load the U-Net weights of ``diffusion`` from a flax checkpoint: the
    bare parameter tree or a training state ``{'ema_params': ...}``
    (counterpart of ``red_diffeq_tpu/io/checkpoints.py:37-66``). Unlike the
    JAX loader, a missing file raises."""
    raw = load_params(path)
    if 'ema_params' in raw:
        raw = raw['ema_params']
    sd = flax_to_state_dict(raw, diffusion.model)
    diffusion.model.load_state_dict(sd)
    return diffusion
