"""ILVR-FWI: DiffusionFWI with ILVR conditioning after each denoise.

Counterpart of ``red_diffeq_tpu/bench_methods/ilvr_fwi.py`` (ILVR: Choi et
al., ICCV 2021). After the denoise of outer step t > 0, the low-frequency
band of the denoised model is replaced, with weight ``ilvr_weight``, by
that of the pre-denoise model diffused to t:

    denoised' = denoised - a*LF(denoised) + a*LF(q_sample(current, t))

then clamped to [-1, 1]. LF is an anti-aliased down/up resampling pair
(two :class:`Resizer` s, built once per shape and factor on the device).
The down factor of step t is ``down_n[t]`` of a 'linear' (16 -> 2) or
'stepwise' ([32, 16, 8, 4]) schedule. The blend is a program of its own
on the run's buffers (one a factor: the low-pass matrices are device
constants of that factor's graph on the card), its q_sample draws made
before the loop.
"""
from typing import Optional

import numpy as np
import torch

from red_diffeq_tpu_torch.bench_methods.diffusion_fwi import DiffusionFWI
from red_diffeq_tpu_torch.bench_methods.resizer import Resizer


def ilvr_down_schedule(name: str, diffusion_ts: int) -> np.ndarray:
    """Down factor of each outer step: 'linear' sweeps 16 -> 2; 'stepwise'
    takes equal [32, 16, 8, 4] blocks, any remainder (the whole schedule
    when diffusion_ts < 4) filled with the finest factor."""
    if name == 'linear':
        return np.linspace(16, 2, diffusion_ts).astype(int)
    if name == 'stepwise':
        ns = [32, 16, 8, 4]
        down = np.repeat(ns, diffusion_ts // len(ns))
        if len(down) < diffusion_ts:
            down = np.pad(down, (0, diffusion_ts - len(down)),
                          constant_values=ns[-1])
        return down[:diffusion_ts]
    raise ValueError(f'Unknown ilvr_down_schedule: {name}')


# optimize()'s keyword of the same name shadows the function in its scope
ilvr_down_schedule_fn = ilvr_down_schedule


class ILVR_FWI(DiffusionFWI):
    """DiffusionFWI with the ILVR low-frequency blend after each denoise."""

    def __init__(self, diffusion_model, fwi_forward, ssim_loss=None,
                 device=None):
        super().__init__(diffusion_model, fwi_forward, ssim_loss,
                         device=device)
        self.use_ilvr = True
        self.ilvr_weight = 0.05
        self.down_n = None
        self._ilvr_noise = None
        self._lowpass_cache = {}

    def optimize(self, mu, mu_true, y, fwi_forward, ts: int = 300,
                 diffusion_ts: int = 500, lr: float = 0.03,
                 noise_std: float = 0.0, noise_type: str = 'gaussian',
                 missing_number: int = 0, grad_norm: bool = True,
                 grad_smooth: Optional[float] = None,
                 model_blur: bool = False, grad_clip: float = 1.0,
                 use_ilvr: bool = True, ilvr_weight: float = 0.05,
                 ilvr_down_schedule: str = 'linear',
                 use_patches: bool = False, patch_kernel_size=None,
                 patch_stride=None,
                 generator: Optional[torch.Generator] = None,
                 noise_draw: Optional[torch.Tensor] = None,
                 trace_mask: Optional[torch.Tensor] = None,
                 ilvr_noise: Optional[torch.Tensor] = None,
                 progress: bool = True):
        """As :meth:`DiffusionFWI.optimize`. ``ilvr_noise``
        (diffusion_ts, *mu.shape), if given, holds the q_sample draw of
        each outer step, indexed by its timestep; otherwise each is drawn
        from the generator when the step runs."""
        self.use_ilvr = use_ilvr
        self.ilvr_weight = ilvr_weight
        self.down_n = ilvr_down_schedule_fn(ilvr_down_schedule,
                                            diffusion_ts)
        self._ilvr_noise = ilvr_noise
        try:
            return super().optimize(
                mu, mu_true, y, fwi_forward, ts=ts,
                diffusion_ts=diffusion_ts, lr=lr, noise_std=noise_std,
                noise_type=noise_type, missing_number=missing_number,
                grad_norm=grad_norm, grad_smooth=grad_smooth,
                model_blur=model_blur, grad_clip=grad_clip,
                use_patches=use_patches, patch_kernel_size=patch_kernel_size,
                patch_stride=patch_stride, generator=generator,
                noise_draw=noise_draw, trace_mask=trace_mask,
                progress=progress)
        finally:
            self._ilvr_noise = None

    def _lowpass(self, shape, down_factor: int):
        """The cached low-pass (down then up) of one shape and factor."""
        key = (tuple(shape), int(down_factor))
        if key not in self._lowpass_cache:
            down = Resizer(shape, 1.0 / down_factor, device=self.device)
            up = Resizer((shape[0], shape[1], *down.out_hw),
                         output_shape=shape[2:], device=self.device)
            self._lowpass_cache[key] = lambda x: up(down(x))
        return self._lowpass_cache[key]

    def _blend_factor(self, step):
        """The down factor of the blend after the denoise of ``step``;
        none at t = 0 or without ILVR."""
        if not self.use_ilvr or step <= 0:
            return None
        return int(self.down_n[step])

    def _blend_key(self):
        return (bool(self.use_ilvr), float(self.ilvr_weight),
                tuple(int(f) for f in self.down_n))

    def _blend_draws(self, b, steps, generator) -> None:
        """The q_sample draw of each outer step that blends, into its row
        of ``b.noise``, in the order the steps run: ``ilvr_noise[t]`` where
        given, else one draw each from ``generator`` (the draws the eager
        loop made after each denoise; nothing else draws in between)."""
        for i, step in enumerate(steps):
            if self._blend_factor(step) is None:
                continue
            if self._ilvr_noise is not None:
                noise = self._ilvr_noise[step]
            else:
                noise = torch.randn(b.cur.shape, generator=generator,
                                    device=b.device, dtype=b.cur.dtype)
            b.noise[i].copy_(noise)

    @torch.no_grad()
    def _blend_body(self, b, factor) -> None:
        """The ILVR blend after the denoise of outer step ``b.outer``: the
        low band of ``b.cur`` exchanged, with weight ``ilvr_weight``, for
        that of the pre-denoise model ``b.prev`` diffused to the step's
        timestep with its draw; clamped to [-1, 1]."""
        lowpass = self._lowpass(b.cur.shape, factor)
        k = b.outer.reshape(1)
        t = b.times.index_select(0, k).repeat(b.cur.shape[0])
        noised_current = self.diffusion_model.q_sample(
            b.prev, t, b.noise.index_select(0, k)[0])
        denoised = b.cur
        conditioned = (denoised
                       - self.ilvr_weight * lowpass(denoised)
                       + self.ilvr_weight * lowpass(noised_current))
        b.cur.copy_(conditioned.clamp(-1.0, 1.0))
