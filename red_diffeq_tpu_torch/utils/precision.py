"""Keep convolutions in full fp32 on the card.

PyTorch lets cuDNN run fp32 convolutions in TF32 by default, which keeps
about three decimal digits. The port holds the U-Net and SSIM to the JAX
package's fp32 results, so both run under this context.
"""
from contextlib import contextmanager

import torch


@contextmanager
def fp32_convolutions():
    """Turn cuDNN's TF32 off for the block, then restore the setting."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved
