"""Device mesh and sharding helpers.

Counterpart of ``red_diffeq_tpu/parallel/mesh.py``. The inversion is
embarrassingly parallel over (sample, shot): the model, the observations
and the metrics carry a leading batch axis, and every shot propagates on
its own until the per-sample loss sums over shots. The mesh is a
('data', 'shot') grid of ``torch.device``s:

* 'data' splits the batch: nothing passes between data shards;
* 'shot' splits each sample's sources: each shot shard steps its shots'
  fields, and the receiver rows and each chunk's per-shot coefficient
  cotangents are gathered on the data shard's first device and summed
  there (``core/inversion.py``, ``solvers/acoustic.py:forward_modeling``).

A mesh is plain PyTorch: its placement is a copy of each block to its
device, with no collective library. The device list may repeat a device
(``['cpu'] * 8``, ``[cuda:0] * 10``): the sharded code then runs its
shards one after another on that device, which is how it runs where only
one device exists.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ('data', 'shot')


class Mesh:
    """A (data, shot) grid of devices; ``shape`` is ``{'data': d, 'shot':
    s}`` as JAX's ``Mesh.shape``."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        return self.devices[0, 0]

    def device(self, d: int, s: int) -> torch.device:
        return self.devices[d, s]

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __hash__(self):
        return hash((self.axis_names, tuple(self.devices.flat)))

    def __repr__(self):
        return f'Mesh({self.shape}, devices={list(self.devices.flat)})'


def _cuda_devices() -> List[torch.device]:
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = -1, shot: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'shot') mesh over the first ``data * shot`` of
    ``devices``; ``data=-1`` takes every device left after ``shot``.
    ``devices=None`` means every visible CUDA device (never the CPU); an
    explicit list is taken as given and may name one device more than
    once."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _cuda_devices())]
    n = len(devices)
    if data == -1:
        assert n % shot == 0, f'{n} devices not divisible by shot={shot}'
        data = n // shot
    assert data * shot <= n, (data, shot, n)
    grid = np.empty((data, shot), dtype=object)
    for i, dev in enumerate(devices[:data * shot]):
        grid[i // shot, i % shot] = dev
    return Mesh(grid)


class PartitionSpec(tuple):
    """The mesh axis each array axis is split over (``None``: not split);
    trailing axes are not split. ``P('data', 'shot')``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``; two shardings are equal when their meshes
    and specs are, as JAX's ``NamedSharding`` are."""
    mesh: Mesh
    spec: PartitionSpec

    def index(self, shape: Sequence[int], d: int, s: int
              ) -> Tuple[slice, ...]:
        """The block of an array of ``shape`` that device (d, s) holds;
        raises where a mesh axis does not divide its array axis."""
        pos = {'data': d, 'shot': s}
        idx = []
        for axis, size in enumerate(shape):
            name = self.spec[axis] if axis < len(self.spec) else None
            if name is None:
                idx.append(slice(None))
                continue
            parts = self.mesh.shape[name]
            if size % parts:
                raise ValueError(
                    f'axis {axis} of size {size} does not divide over mesh '
                    f'axis {name!r} of size {parts}')
            step = size // parts
            idx.append(slice(pos[name] * step, (pos[name] + 1) * step))
        return tuple(idx)


@dataclass(frozen=True)
class Shard:
    """One device's block: ``index`` into the global array, ``data`` on
    ``device``."""
    device: torch.device
    index: Tuple[slice, ...]
    data: torch.Tensor


class ShardedTensor:
    """A tensor placed over a mesh: one :class:`Shard` per mesh device, in
    (data, shot) order (``addressable_shards``, as a JAX array's)."""

    def __init__(self, shape, dtype, sharding: NamedSharding,
                 shards: List[Shard]):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.addressable_shards = shards

    def block(self, d: int, s: int = 0) -> torch.Tensor:
        """The block that device (d, s) holds."""
        return self.addressable_shards[d * self.sharding.mesh.shape['shot']
                                       + s].data

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first)."""
        device = torch.device(device or self.sharding.mesh.first_device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for sh in self.addressable_shards:
            out[sh.index] = sh.data.to(device)
        return out


def device_put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Copy each block of ``x`` to its mesh device (a copy of its own on
    every device, also where the device repeats or is ``x``'s)."""
    mesh = sharding.mesh
    data, shot = mesh.devices.shape
    shards = []
    for d in range(data):
        for s in range(shot):
            idx = sharding.index(x.shape, d, s)
            dev = mesh.device(d, s)
            shards.append(Shard(dev, idx, x[idx].to(dev, copy=True)
                                .contiguous()))
    return ShardedTensor(x.shape, x.dtype, sharding, shards)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """(B, ...) arrays: the batch over 'data'."""
    return NamedSharding(mesh, P('data'))


def batch_shot_sharding(mesh: Mesh) -> NamedSharding:
    """(B, ns, ...) arrays: the batch over 'data', the shots over 'shot'."""
    return NamedSharding(mesh, P('data', 'shot'))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_inversion_inputs(mesh: Mesh, mu, mu_true, y):
    """Place the engine's inputs for data x shot execution: ``mu`` and
    ``mu_true`` (B, 1, H, W) over 'data', ``y`` (B, ns, nt, ng) over
    ('data', 'shot'). Returns three :class:`ShardedTensor`s."""
    return (device_put(mu, batch_sharding(mesh)),
            device_put(mu_true, batch_sharding(mesh)),
            device_put(y, batch_shot_sharding(mesh)))
