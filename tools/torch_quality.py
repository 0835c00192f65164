"""The held-out quality problem of the port's quality tools, built once.

``tools/eval_quality.py``, ``compare_methods.py``, ``milestone_eval.py`` and
``lambda_sweep.py`` each build the same problem; their counterparts for
``red_diffeq_tpu_torch`` (``tools/torch_*.py``) take it from
:func:`held_out_problem`:

* the acquisition ``CTX`` (70 x width model, nt=1000, 5 shots, nbc=120)
  and its operator at ``backend='auto'`` (the kernels on the card);
* the dim-64 U-Net prior at 72x72, with ``ckpt`` loaded when given;
* held-out truths ``generate_mixed_dataset(n, h=70, w=width, seed=7777)``
  (far from the pretraining seeds);
* observations: ``clean`` from the inversion's own operator, ``refined``
  from a dt/2 + dx/2 grid at the same physical acquisition
  (``refined_ctx``, ``sample_temporal=2``, ``upsample_velocity``). The
  refined operator's receiver line is strided, so it runs the plain path,
  as the JAX tools run it on ``backend='xla'``: the kernels take only a
  contiguous receiver line;
* the smoothed initial models at ``sigma`` and ``mu0``, padded by one.

The module constants are the problem's size; the tests shrink them.
Imports only the port.
"""
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from red_diffeq_tpu_torch.io.checkpoints import (  # noqa: E402
    load_diffusion_params,
)
from red_diffeq_tpu_torch.io.synthetic import (  # noqa: E402
    generate_mixed_dataset,
)
from red_diffeq_tpu_torch.models.diffusion import (  # noqa: E402
    GaussianDiffusion,
)
from red_diffeq_tpu_torch.models.unet import Unet  # noqa: E402
from red_diffeq_tpu_torch.solvers.acoustic import (  # noqa: E402
    FWIForward, refined_ctx, upsample_velocity,
)
from red_diffeq_tpu_torch.utils.data_trans import (  # noqa: E402
    prepare_initial_model, s_normalize_none, v_denormalize, v_normalize,
)
from red_diffeq_tpu_torch.utils.device import resolve_device  # noqa: E402
from red_diffeq_tpu_torch.utils.ssim import ssim  # noqa: E402

CTX = dict(n_grid=70, nt=1000, dx=10.0, dt=0.001, nbc=120, f=15.0, sz=10,
           gz=10, ng=70, ns=5)
HEIGHT = 70
UNET = dict(dim=64, dim_mults=(1, 2, 4, 8), channels=1)
IMAGE_SIZE = 72
TIMESTEPS = 1000
CHUNK = 20
# Held-out truths: a generator seed far from the pretraining seeds (42..145).
SEED = 7777
# The draws of every inversion (the JAX tools' PRNGKey(8888)).
DRAW_SEED = 8888
CKPT = Path('pretrained_models/model-synthetic-ema.ckpt')
OBS_CHOICES = {'both': ('clean', 'refined'), 'clean': ('clean',),
               'refined': ('refined',)}


def draws(dev, seed: int = DRAW_SEED) -> torch.Generator:
    """A fresh generator on ``dev`` seeded ``seed``: each inversion of a
    tool draws the same sequence, as each JAX call gets the same key."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def sync(dev) -> None:
    """Wait for the card's queued work (a start or end of a timed run)."""
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize(dev)


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or the device's type."""
    dev = torch.device(dev)
    if dev.type != 'cuda':
        return f'none ({dev.type})'
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f'{torch.cuda.get_device_name(dev)}, power limit not read'


def final_metrics(per_model, keys=('MAE', 'RMSE', 'SSIM')) -> dict:
    """Each metric's last value, averaged over the samples."""
    return {k: float(np.mean([pm[k.lower()][-1] for pm in per_model]))
            for k in keys}


def held_out_problem(dev, n: int = 4, width=None, sigma: float = 10.0,
                     obs=('clean', 'refined'), ckpt=CKPT):
    """The held-out problem on ``dev`` (see the module's docstring).
    ``obs`` names the observation protocols, in the order the tool runs
    them; ``width`` None is ``CTX``'s; ``ckpt`` None leaves the U-Net's
    random weights (a tool that loads its own). Returns a namespace: ``ctx``, ``op``, ``backend``,
    ``diffusion``, ``v_true`` (numpy, m/s) and ``v_true_t`` (on ``dev``),
    ``observations`` ({protocol: seismogram on ``dev``}),
    ``obs_seconds`` ({protocol: seconds to make it}), ``init`` (numpy,
    normalised), ``init_t`` and ``mu0`` (padded by one), both on
    ``dev``."""
    dev = resolve_device(dev)
    width = CTX['n_grid'] if width is None else width
    ctx = dict(CTX, n_grid=width, ng=width)
    op = FWIForward(ctx, normalize=True, v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend='auto',
                    chunk=CHUNK, device=dev)
    diffusion = GaussianDiffusion(Unet(**UNET), image_size=IMAGE_SIZE,
                                  timesteps=TIMESTEPS,
                                  objective='pred_noise', device=dev)
    if ckpt is not None:
        load_diffusion_params(diffusion, str(ckpt))

    v_true = generate_mixed_dataset(n, h=HEIGHT, w=width, seed=SEED)
    v_true_t = torch.from_numpy(v_true).to(dev)
    observations, obs_seconds = {}, {}
    for name in obs:
        t0 = time.perf_counter()
        with torch.no_grad():
            if name == 'clean':
                y = op(v_normalize(v_true_t))
            elif name == 'refined':
                op_obs = FWIForward(
                    refined_ctx(ctx, factor=2), sample_temporal=2,
                    normalize=True, v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend='plain',
                    chunk=CHUNK, device=dev)
                v_fine = torch.from_numpy(
                    upsample_velocity(v_true, factor=2)).to(dev)
                y = op_obs(v_normalize(v_fine))
            else:
                raise ValueError(f'unknown observation protocol {name!r}')
        sync(dev)
        observations[name] = y
        obs_seconds[name] = time.perf_counter() - t0

    init = np.concatenate([
        prepare_initial_model(v_true[b:b + 1], 'smoothed', sigma=sigma)
        for b in range(n)])
    init_t = torch.from_numpy(init).to(dev)
    return SimpleNamespace(
        ctx=ctx, op=op, backend=op.backend, diffusion=diffusion,
        v_true=v_true, v_true_t=v_true_t, observations=observations,
        obs_seconds=obs_seconds, init=init, init_t=init_t,
        mu0=F.pad(init_t, (1, 1, 1, 1)))


def initial_ssim(problem) -> float:
    """SSIM of the smoothed initial models against the truths, by the
    formula of the engine's per-step metric (fields mapped to [0, 1]);
    ``init`` is already normalised."""
    truth = v_normalize(problem.v_true_t)
    return float(ssim((problem.init_t + 1) / 2, (truth + 1) / 2,
                      size_average=False).mean())
