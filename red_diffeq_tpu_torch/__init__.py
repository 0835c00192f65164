"""RED-DiffEq in PyTorch for an NVIDIA H100: the port of ``red_diffeq_tpu``.

The forward FD stepper and its tape-free adjoint run as hand-written CUDA
kernels (``ops/csrc/stencil.cu``); everything else is plain PyTorch. Entry
points run on ``'cuda'`` unless given ``device='cpu'``, and raise without
a card. The package imports nothing of JAX or of ``red_diffeq_tpu``.
"""
__version__ = '0.1.0'

from red_diffeq_tpu_torch.core.inversion import (
    InversionEngine, make_inversion_step,
)
from red_diffeq_tpu_torch.io.checkpoints import load_diffusion_params
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward, Geometry

__all__ = ['InversionEngine', 'make_inversion_step', 'load_diffusion_params',
           'GaussianDiffusion', 'Unet', 'FWIForward', 'Geometry']
