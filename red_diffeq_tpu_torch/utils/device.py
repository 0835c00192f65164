"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card they raise: nothing quietly falls back to the CPU.
"""
from typing import Optional, Union

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
