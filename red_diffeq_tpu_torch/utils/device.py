"""Device selection for the port's entry points, and index constants.

Entry points run on the card unless the caller asks for the CPU. Without a
card they raise: nothing quietly falls back to the CPU.
"""
import functools
from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``'cuda'``. A CUDA device without a card raises."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            'CPU')
    return dev


def check_on(t: torch.Tensor, device: torch.device, name: str) -> None:
    """Raise unless ``t`` lies on ``device``'s type."""
    if t.device.type != device.type:
        raise ValueError(f'{name} is on {t.device}, expected {device}')


@functools.lru_cache(maxsize=None)
def device_index(values: Tuple[int, ...], device: torch.device
                 ) -> torch.Tensor:
    """``values`` as an int64 tensor on ``device``, made once per (values,
    device) and kept for the process. A step indexes with it instead of a
    Python list, whose copy from the host a CUDA graph's capture does not
    allow, and a captured graph never reads a freed one. Read-only."""
    return torch.tensor(values, dtype=torch.int64, device=device)
