"""RED-DiffEq in PyTorch for an NVIDIA H100: the port of ``red_diffeq_tpu``.

The FD solver's forward and adjoints run as hand-written CUDA kernels
(``ops/csrc/stencil.cu``); everything else is plain PyTorch. Entry
points run on ``'cuda'`` unless given ``device='cpu'``, and raise without
a card. The package imports nothing of JAX or of ``red_diffeq_tpu``.

It exports every name the JAX package exports, with the same constructor
parameters in the same order, so that a script written against the JAX
package runs here by changing its import line; ``device`` comes last, and
where the JAX package takes a ``key`` this package takes a
``torch.Generator``. Its own additions: ``make_inversion_step``,
``DiffusionFWI`` and ``ILVR_FWI``.
"""
__version__ = '0.1.0'

from red_diffeq_tpu_torch.bench_methods import DiffusionFWI, ILVR_FWI
from red_diffeq_tpu_torch.config import (
    get_config, get_marmousi_config, load_config, print_config, save_config,
    update_config,
)
from red_diffeq_tpu_torch.core.inversion import (
    InversionEngine, make_inversion_step,
)
from red_diffeq_tpu_torch.core.metrics import (
    MetricsCalculator, calculate_metrics,
)
from red_diffeq_tpu_torch.io.checkpoints import (
    load_diffusion_params, load_params, save_params,
)
from red_diffeq_tpu_torch.io.results import load_marmousi, load_openfwi
from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
from red_diffeq_tpu_torch.models.trainer import TensorDataset, Trainer
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.regularization.base import RegularizationMethod
from red_diffeq_tpu_torch.regularization.benchmark import (
    tikhonov_loss, total_variation_loss,
)
from red_diffeq_tpu_torch.regularization.red import (
    RED_DiffEq, RED_DiffEq_POST_PROCESS, calculate_patches,
)
from red_diffeq_tpu_torch.solvers.acoustic import (
    FWIForward, Geometry, forward_modeling,
)
from red_diffeq_tpu_torch.utils.data_trans import (
    add_noise_to_seismic, missing_trace, prepare_initial_model, s_denormalize,
    s_normalize, s_normalize_none, v_denormalize, v_normalize,
)
from red_diffeq_tpu_torch.utils.seed_utils import (
    SeedContext, get_rng_state, set_rng_state, set_seed, worker_init_fn,
)
from red_diffeq_tpu_torch.utils.ssim import SSIM, ssim

__all__ = [
    'get_config', 'get_marmousi_config', 'load_config', 'save_config',
    'update_config', 'print_config',
    'InversionEngine', 'MetricsCalculator', 'calculate_metrics',
    'GaussianDiffusion', 'Unet', 'Trainer', 'TensorDataset',
    'FWIForward', 'Geometry', 'forward_modeling',
    'RED_DiffEq', 'RED_DiffEq_POST_PROCESS', 'calculate_patches',
    'total_variation_loss', 'tikhonov_loss', 'RegularizationMethod',
    'prepare_initial_model', 'v_denormalize', 'v_normalize',
    's_normalize', 's_denormalize', 's_normalize_none',
    'add_noise_to_seismic', 'missing_trace',
    'SSIM', 'ssim',
    'set_seed', 'SeedContext', 'get_rng_state', 'set_rng_state',
    'worker_init_fn',
    'save_params', 'load_params', 'load_diffusion_params',
    'load_openfwi', 'load_marmousi',
    'make_inversion_step', 'DiffusionFWI', 'ILVR_FWI',
]
