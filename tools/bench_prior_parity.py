#!/usr/bin/env python3
"""DiffusionFWI in the JAX package and in the port, side by side on the CPU.

Run from the repository root (the shipped prior's path is relative):

    JAX_PLATFORMS=cpu python3 tools/bench_prior_parity.py [--nt 300]
        [--diffusion_ts 4] [--ts 3]

Three checks, each printed:

1. one posterior-mean denoise of the same model in both packages at the
   CPU tests' tiny shapes (dim-8 U-Net on weights carried across, 18x18,
   12 diffusion steps), max |difference| at t = 0, 2, 5 and 11;
2. how far one denoise with the shipped prior moves the smoothed initial
   model of a 70x70 synthetic sample, at t = 0, 1, 5 and 29;
3. DiffusionFWI with the shipped prior at the OpenFWI ablation preset's
   width (70x70, nbc=120) and tricks, nt cut to ``--nt``, over
   ``--diffusion_ts`` x ``--ts`` steps in both packages on the same
   observations: the observation loss and SSIM of every outer step, and the
   max |difference| of the final models.

Several minutes at the defaults; CPU times only, no device numbers.
"""
import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from red_diffeq_tpu.bench_methods.diffusion_fwi import \
    DiffusionFWI as JaxDiffusionFWI  # noqa: E402
from red_diffeq_tpu.io.checkpoints import \
    load_diffusion_params as jax_load  # noqa: E402
from red_diffeq_tpu.models.diffusion import \
    GaussianDiffusion as JaxDiffusion  # noqa: E402
from red_diffeq_tpu.models.unet import Unet as JaxUnet  # noqa: E402
from red_diffeq_tpu.solvers.acoustic import FWIForward as JaxFWI  # noqa: E402
from red_diffeq_tpu.utils import data_trans as jdt  # noqa: E402
from red_diffeq_tpu_torch.bench_methods import DiffusionFWI  # noqa: E402
from red_diffeq_tpu_torch.cli.run_inversion import \
    build_diffusion_model  # noqa: E402
from red_diffeq_tpu_torch.config import load_config  # noqa: E402
from red_diffeq_tpu_torch.io.checkpoints import \
    flax_to_state_dict  # noqa: E402
from red_diffeq_tpu_torch.io.synthetic import \
    generate_mixed_dataset  # noqa: E402
from red_diffeq_tpu_torch.models.diffusion import \
    GaussianDiffusion  # noqa: E402
from red_diffeq_tpu_torch.models.unet import Unet  # noqa: E402
from red_diffeq_tpu_torch.solvers.acoustic import FWIForward  # noqa: E402
from red_diffeq_tpu_torch.utils import data_trans as tdt  # noqa: E402

PRESET = 'configs/ablation/OpenFWI_Ablation/ablation_all_tricks_dt30_ts10.yaml'
PRIOR = 'pretrained_models/model-synthetic-ema.ckpt'


def tiny_denoise():
    jd = JaxDiffusion(JaxUnet(dim=8, dim_mults=(1, 2), channels=1),
                      image_size=18, timesteps=12)
    jd.init_params(jax.random.PRNGKey(0))
    unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
    unet.load_state_dict(flax_to_state_dict(jax.tree.map(
        np.asarray, flax.serialization.to_state_dict(jd.params)), unet))
    td = GaussianDiffusion(unet, image_size=18, timesteps=12, device='cpu')
    mu = np.asarray(jdt.v_normalize(np.full((2, 1, 16, 16), 2400.0,
                                            np.float32)))
    mu[0, :, 8:] = 0.3
    jbench, bench = JaxDiffusionFWI(jd, None), DiffusionFWI(td, None,
                                                            device='cpu')
    for t in (0, 2, 5, 11):
        a = np.asarray(jbench._denoise(jnp.asarray(mu), jnp.int32(t)))
        b = bench._denoise(torch.from_numpy(mu), t).numpy()
        print(f'tiny denoise at t={t}: max |JAX - port| '
              f'{np.abs(a - b).max():.3e}', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--nt', type=int, default=300)
    ap.add_argument('--diffusion_ts', type=int, default=4)
    ap.add_argument('--ts', type=int, default=3)
    args = ap.parse_args()

    tiny_denoise()

    cfg = load_config(PRESET)
    cfg.diffusion.model_path = PRIOR
    ctx = dict(cfg.pde.to_dict(), nt=args.nt)
    td = build_diffusion_model(cfg, device='cpu')
    jd = JaxDiffusion(JaxUnet(dim=64, dim_mults=(1, 2, 4, 8), channels=1),
                      image_size=72, timesteps=1000)
    jax_load(jd, PRIOR)
    v = generate_mixed_dataset(2, 70, 70, seed=4321)[:1]
    mu0 = tdt.prepare_initial_model(v, 'smoothed', sigma=cfg.optimization.sigma)

    probe = DiffusionFWI(td, None, device='cpu')
    for t in (0, 1, 5, 29):
        d = (probe._denoise(torch.from_numpy(mu0), t)
             - torch.from_numpy(mu0)).abs()
        print(f'prior denoise of the initial model at t={t}: max move '
              f'{float(d.max()):.4f} (interior {float(d[..., 2:-2, 2:-2].max()):.4f}), '
              f'mean {float(d.mean()):.5f}', flush=True)

    top = FWIForward(ctx, v_denorm_func=tdt.v_denormalize,
                     s_norm_func=tdt.s_normalize_none, device='cpu')
    jop = JaxFWI(ctx, normalize=True, v_denorm_func=jdt.v_denormalize,
                 s_norm_func=lambda s: s, backend='xla', chunk=20)
    y = np.array(jop(jdt.v_normalize(jnp.asarray(v))))
    o = cfg.optimization
    kw = dict(ts=args.ts, diffusion_ts=args.diffusion_ts, lr=o.lr,
              grad_norm=o.grad_norm, grad_smooth=o.grad_smooth,
              model_blur=o.model_blur, grad_clip=o.grad_clip, progress=False)
    jmu, jc = JaxDiffusionFWI(jd, jop).optimize(
        jnp.asarray(mu0), jnp.asarray(v), jnp.asarray(y), jop,
        key=jax.random.PRNGKey(0), **kw)
    mu, c = DiffusionFWI(td, top, device='cpu').optimize(mu0, v, y, top,
                                                         **kw)
    print(f'DiffusionFWI, nt={args.nt}, {args.diffusion_ts} x {args.ts} '
          f'steps: max |JAX - port| of the final model '
          f'{float(np.abs(mu.numpy() - np.asarray(jmu)).max()):.4f}')
    for k in ('obs_losses', 'ssim'):
        for name, curves in (('JAX ', jc), ('port', c)):
            print(f'{k} {name}: '
                  + ' '.join(f'{float(x):.4f}' for x in curves[0][k]))


if __name__ == '__main__':
    main()
