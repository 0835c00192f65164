from red_diffeq_tpu_torch.bench_methods.diffusion_fwi import (
    DiffusionFWI, merge_patches_to_data, split_data_to_patches,
)
from red_diffeq_tpu_torch.bench_methods.ilvr_fwi import ILVR_FWI
from red_diffeq_tpu_torch.bench_methods.resizer import Resizer, resize_matrix
from red_diffeq_tpu_torch.bench_methods.filters import (
    gaussian_smooth, gaussian_blur_3x3, clip_total_norm,
)
