"""Denoiser weights: the flax msgpack checkpoint into the port's U-Net and
back.

The shipped prior (``pretrained_models/model-synthetic-ema.ckpt``) is a flax
``serialization.to_bytes`` file: a msgpack map of maps whose leaves are
msgpack ext type 1, each payload a msgpack-packed
``(shape, dtype name, raw bytes)``. :func:`unpackb` reads that format and
:func:`packb` writes it, in pure Python and numpy, so the port needs neither
``msgpack`` nor ``flax``. :func:`flax_to_state_dict` carries a flax
parameter tree across to the ``state_dict`` of
:class:`red_diffeq_tpu_torch.models.unet.Unet`, inverting the layout moves
of ``tools/convert_torch_checkpoint.py``; :func:`state_dict_to_flax` is its
inverse. So a prior the port trains (:func:`save_params`,
:func:`export_ema`) is a file in the shipped prior's own format, which both
packages load.
"""
import os
import re
import struct
import warnings
from pathlib import Path
from typing import Dict, Optional, Union

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


class _Writer:
    """Encoder for the msgpack subset that :class:`_Reader` decodes, as
    flax writes it (``msgpack.packb(..., use_bin_type=True)``): maps with
    str keys, lists and tuples as arrays, str, bytes as bin, bool, None,
    ints, Python floats as float 64, numpy arrays as ext type 1."""

    def __init__(self):
        self.parts = []

    def put(self, fmt: str, *vals):
        self.parts.append(struct.pack(fmt, *vals))

    def sized(self, n: int, fix, fix_max: int, codes):
        """A header for ``n`` items: the fix form ``fix | n`` up to
        ``fix_max`` (if any), else the smallest of ``codes`` (8, 16, 32-bit
        lengths)."""
        if fix is not None and n <= fix_max:
            self.put('>B', fix | n)
            return
        for code, fmt, limit in zip(codes, ('>B', '>H', '>I'),
                                    (0xff, 0xffff, 0xffffffff)):
            if code is not None and n <= limit:
                self.put('>B' + fmt[1], code, n)
                return
        raise ValueError(f'msgpack object of {n} items or bytes is too large')

    def write(self, obj):
        if obj is None:
            self.put('>B', 0xc0)
        elif isinstance(obj, bool):
            self.put('>B', 0xc3 if obj else 0xc2)
        elif isinstance(obj, int):
            self.int(obj)
        elif isinstance(obj, float):
            self.put('>Bd', 0xcb, obj)
        elif isinstance(obj, str):
            data = obj.encode('utf-8')
            self.sized(len(data), 0xa0, 31, (0xd9, 0xda, 0xdb))
            self.parts.append(data)
        elif isinstance(obj, (bytes, bytearray)):
            self.sized(len(obj), None, 0, (0xc4, 0xc5, 0xc6))
            self.parts.append(bytes(obj))
        elif isinstance(obj, dict):
            self.sized(len(obj), 0x80, 15, (None, 0xde, 0xdf))
            for k, v in obj.items():
                self.write(k)
                self.write(v)
        elif isinstance(obj, (list, tuple)):
            self.sized(len(obj), 0x90, 15, (None, 0xdc, 0xdd))
            for v in obj:
                self.write(v)
        elif isinstance(obj, np.ndarray):
            payload = packb([list(obj.shape), obj.dtype.name,
                             obj.tobytes('C')])
            n = len(payload)
            fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
            if n in fixext:
                self.put('>B', fixext[n])
            else:
                self.sized(n, None, 0, (0xc7, 0xc8, 0xc9))
            self.put('>b', _EXT_NDARRAY)
            self.parts.append(payload)
        else:
            raise TypeError(f'cannot pack {type(obj).__name__}')

    def int(self, v: int):
        if 0 <= v <= 0x7f or -32 <= v < 0:
            self.put('>b' if v < 0 else '>B', v)
            return
        forms = ((0xcc, '>BB', 0, 0xff), (0xcd, '>BH', 0, 0xffff),
                 (0xce, '>BI', 0, 0xffffffff), (0xcf, '>BQ', 0, 2 ** 64 - 1),
                 (0xd0, '>Bb', -2 ** 7, 2 ** 7 - 1),
                 (0xd1, '>Bh', -2 ** 15, 2 ** 15 - 1),
                 (0xd2, '>Bi', -2 ** 31, 2 ** 31 - 1),
                 (0xd3, '>Bq', -2 ** 63, 2 ** 63 - 1))
        for code, fmt, lo, hi in forms:
            if (v >= 0) == (lo == 0) and lo <= v <= hi:
                self.put(fmt, code, v)
                return
        raise ValueError(f'integer {v} does not fit in 64 bits')


def packb(obj) -> bytes:
    """Encode ``obj`` as one msgpack object, numpy arrays as flax's ext
    type 1 leaves; :func:`unpackb` reads it back."""
    w = _Writer()
    w.write(obj)
    return b''.join(w.parts)


def atomic_write_bytes(path, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file and
    ``os.replace``, so that a kill in mid-write cannot truncate the only
    copy (``red_diffeq_tpu/io/checkpoints.py:20-28``)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, path)


def save_params(params: dict, path) -> None:
    """Write a flax state dict (a tree of dicts with numpy leaves, e.g. from
    :func:`state_dict_to_flax`) to ``path`` in flax's msgpack format."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_bytes(path, packb(params))


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
    ``scale`` -> ``weight``, RMSNorm ``g`` (1, 1, 1, C) -> (1, C, 1, 1);
    other leaves (``mem_kv``, the Fourier embedding's ``sinu_pos_emb``
    ``weights``) as they are. Every field of the U-Net's constructor is
    carried across: the shapes (per-stage attention widths, a wider
    ``init_conv`` under self-conditioning, a wider ``final_conv`` under
    learned variance) come from ``model``. Raises on a leaf left over, a
    parameter missing, or a shape mismatch."""
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


def state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> dict:
    """Carry a U-Net ``state_dict`` (or any dict of tensors keyed as one,
    such as Adam's moments) across to a flax parameter tree of float32
    numpy arrays: the inverse of :func:`flax_to_state_dict`. Conv weight
    OIHW -> kernel HWIO, dense weight (O, I) -> kernel (I, O), a 1-D weight
    (GroupNorm) -> ``scale``, RMSNorm ``g`` (1, C, 1, 1) -> (1, 1, 1, C)."""
    tree = {}
    for key, t in sd.items():
        arr = t.detach().to('cpu', torch.float32).numpy()
        *mods, name = key.split('.')
        if name == 'weight':
            if arr.ndim == 4:
                name, arr = 'kernel', arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                name, arr = 'kernel', arr.transpose(1, 0)
            else:
                name = 'scale'
        elif name == 'g':
            arr = arr.transpose(0, 2, 3, 1)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def export_ema(run, milestone='latest', out=None) -> Path:
    """Write the bare EMA parameter tree of a :class:`Trainer` milestone
    ``<run>/model-<milestone>.ckpt`` (``'latest'``: the highest) to
    ``out`` in the shipped prior's format (counterpart of
    ``tools/export_ema.py``). Returns the path of the milestone read."""
    run = Path(run)
    if milestone == 'latest':
        cands = {int(m.group(1)): f for f in run.glob('model-*.ckpt')
                 if (m := re.match(r'model-(\d+)\.ckpt$', f.name))}
        if not cands:
            raise FileNotFoundError(f'no model-<k>.ckpt under {run}')
        src = cands[max(cands)]
    else:
        src = run / f'model-{int(milestone)}.ckpt'
    state = load_params(src)
    if 'ema_params' not in state:
        raise KeyError(f'{src} has keys {sorted(state)}; expected a Trainer '
                       'checkpoint with ema_params')
    save_params(state['ema_params'], out)
    return src


def load_diffusion_params(diffusion, path: Optional[Union[str, Path]]):
    """Load the U-Net weights of ``diffusion`` from a flax checkpoint: the
    bare parameter tree or a training state ``{'ema_params': ...}``, the
    JAX trainer's or the port's milestone
    (counterpart of ``red_diffeq_tpu/io/checkpoints.py:47-70``). As the JAX
    loader does, a missing file warns, naming the path, and keeps the
    model's random weights."""
    if not path or not Path(path).exists():
        warnings.warn(f'pretrained model not found at {path}; continuing '
                      'with randomly initialized weights')
        return diffusion
    raw = load_params(path)
    if 'ema_params' in raw:
        raw = raw['ema_params']
    sd = flax_to_state_dict(raw, diffusion.model)
    diffusion.model.load_state_dict(sd)
    return diffusion
