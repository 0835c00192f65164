"""Seeds and the global sequence of generators.

Counterpart of ``red_diffeq_tpu/utils/seed_utils.py``. The JAX package keeps
one global PRNG key and splits a fresh subkey off it for each caller that
is given none (``next_key``). Here the root of the sequence is one CPU
``torch.Generator``: :func:`next_key` draws a seed from it and returns a
fresh generator on the requested device (the card unless the caller asks
for the CPU), seeded with that draw. Two calls
give different generators; :func:`set_seed` with the same seed makes the
sequence repeat. The numbers differ from JAX's, the behaviour does not.
"""
import random
from typing import Optional, Union

import numpy as np
import torch

from red_diffeq_tpu_torch.utils.device import resolve_device

_ROOT: Optional[torch.Generator] = None


def set_seed(seed: int, verbose: bool = False) -> torch.Generator:
    """Seed python, numpy and torch's default generator, and install a
    root generator seeded with ``seed``. Returns the root."""
    global _ROOT
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    _ROOT = torch.Generator().manual_seed(seed)
    if verbose:
        print(f'Random seed set to {seed} (python, numpy, torch, root '
              'generator)')
    return _ROOT


def get_key() -> torch.Generator:
    """The root generator, seeded with 0 if none was installed."""
    global _ROOT
    if _ROOT is None:
        _ROOT = torch.Generator().manual_seed(0)
    return _ROOT


def next_key(device: Union[str, torch.device, None] = None
             ) -> torch.Generator:
    """A fresh generator on ``device`` (``None`` means the card, as for
    every entry point of the port; pass ``'cpu'`` for the CPU), seeded with
    the next draw from the root."""
    dev = resolve_device(device)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=get_key()))
    return torch.Generator(device=dev).manual_seed(seed)


def get_rng_state():
    """Snapshot of python's, numpy's, torch's default and the root
    generator's state."""
    return {
        'python': random.getstate(),
        'numpy': np.random.get_state(),
        'torch': torch.get_rng_state(),
        'root': None if _ROOT is None else _ROOT.get_state(),
    }


def set_rng_state(state) -> None:
    """Restore a snapshot from :func:`get_rng_state`."""
    global _ROOT
    random.setstate(state['python'])
    np.random.set_state(state['numpy'])
    torch.set_rng_state(state['torch'])
    if state['root'] is None:
        _ROOT = None
    else:
        _ROOT = torch.Generator()
        _ROOT.set_state(state['root'])


class SeedContext:
    """Seeds on entry and restores the state on exit."""

    def __init__(self, seed: int):
        self.seed = seed
        self._saved = None

    def __enter__(self):
        self._saved = get_rng_state()
        return set_seed(self.seed)

    def __exit__(self, *exc):
        set_rng_state(self._saved)
        return False



def worker_init_fn(worker_id: int, base_seed: int = 0) -> None:
    """Seed a data-loading worker process: python's and numpy's generators
    with ``base_seed + worker_id``."""
    seed = base_seed + worker_id
    random.seed(seed)
    np.random.seed(seed)
