"""DiffusionFWI: the diffusion-guided FWI competitor method.

Counterpart of ``red_diffeq_tpu/bench_methods/diffusion_fwi.py``: an outer
reverse-diffusion loop (t from ``diffusion_ts - 1`` down to 0) that
alternates a posterior-mean denoise of the velocity model with an inner
Adam FWI loop of ``ts`` steps under gradient tricks (the first step's
max-abs normalisation, Gaussian gradient smoothing, total-norm clipping, a
3x3 model blur, the clamp to [-1, 1]), and no FWI at t = 0. After each
outer step the model is evaluated (forward only): the observation loss,
MAE, RMSE and SSIM, per sample.

Both loops are host loops (the JAX package's inner loop is one
``lax.scan``). A model wider than the denoiser is cut into windows that
all go to the U-Net in one call.
"""
from typing import Optional

import torch

from red_diffeq_tpu_torch.bench_methods.filters import (
    clip_total_norm, gaussian_blur_3x3, gaussian_smooth,
)
from red_diffeq_tpu_torch.bench_methods.resizer import bilinear_resize
from red_diffeq_tpu_torch.core.inversion import Adam, constant_schedule
from red_diffeq_tpu_torch.core.losses import observation_loss
from red_diffeq_tpu_torch.core.metrics import calculate_metrics
from red_diffeq_tpu_torch.utils.data_trans import (
    add_noise_to_seismic, missing_trace, v_normalize,
)
from red_diffeq_tpu_torch.utils.device import resolve_device
from red_diffeq_tpu_torch.utils.diffusion_utils import (
    diffusion_crop, diffusion_pad,
)
from red_diffeq_tpu_torch.utils.seed_utils import next_key

_F32 = torch.float32
CURVES = ('total_losses', 'obs_losses', 'ssim', 'mae', 'rmse')


def split_data_to_patches(data: torch.Tensor, kernel_size, stride
                          ) -> torch.Tensor:
    """Unfold (B, C, H, W) into (B*nh*nw, C, ph, pw) windows, sample-major,
    then row-major."""
    b, _, h, w = data.shape
    ph, pw = kernel_size
    sh, sw = stride
    nh = (h - ph) // sh + 1
    nw = (w - pw) // sw + 1
    return torch.cat([data[bi:bi + 1, :, i * sh:i * sh + ph,
                           j * sw:j * sw + pw]
                      for bi in range(b) for i in range(nh)
                      for j in range(nw)])


def merge_patches_to_data(patches: torch.Tensor, output_size, kernel_size,
                          stride) -> torch.Tensor:
    """Overlap-average merge, the inverse of :func:`split_data_to_patches`;
    the batch is the patch count over the windows per sample."""
    n, c, ph, pw = patches.shape
    h, w = output_size
    sh, sw = stride
    nh = (h - ph) // sh + 1
    nw = (w - pw) // sw + 1
    per_sample = nh * nw
    if n % per_sample != 0:
        raise ValueError(
            f'{n} patches is not a multiple of the {per_sample} windows per '
            f'sample for output {output_size} / kernel {kernel_size} / '
            f'stride {stride}')
    b = n // per_sample
    merged = patches.new_zeros((b, c, h, w))
    count = patches.new_zeros((b, c, h, w))
    for i in range(nh):
        for j in range(nw):
            ys, xs = i * sh, j * sw
            # Window (i, j) of every sample.
            merged[:, :, ys:ys + ph, xs:xs + pw] += \
                patches[i * nw + j::per_sample]
            count[:, :, ys:ys + ph, xs:xs + pw] += 1.0
    return merged / count.clamp_min(1.0)


class DiffusionFWI:
    """The method over a GaussianDiffusion bundle and an FWI forward
    operator, on ``device`` (default ``'cuda'``; without a card it raises
    unless ``device='cpu'``). ``ssim_loss`` is accepted for the JAX
    signature and unused, as there."""

    def __init__(self, diffusion_model, fwi_forward, ssim_loss=None,
                 device=None):
        del ssim_loss
        self.device = resolve_device(device)
        self.diffusion_model = diffusion_model
        self.fwi_forward = fwi_forward

    # -- denoising -------------------------------------------------------

    @torch.no_grad()
    def _posterior_mean(self, padded: torch.Tensor, t: int) -> torch.Tensor:
        """The clamped posterior mean of the padded models at timestep
        ``t``, cropped back."""
        bt = torch.full((padded.shape[0],), t, dtype=torch.long,
                        device=padded.device)
        mean, _, _, _ = self.diffusion_model.p_mean_variance(
            padded, bt, clip_denoised=True)
        return diffusion_crop(mean).clamp(-1.0, 1.0)

    def _denoise(self, current_model: torch.Tensor, t: int) -> torch.Tensor:
        """Posterior-mean denoise through the 1-cell padded grid."""
        return self._posterior_mean(diffusion_pad(current_model), t)

    def _denoise_patched(self, current_model: torch.Tensor, t: int,
                         kernel_size, stride) -> torch.Tensor:
        """Cut into windows, resize each to the denoiser's unpadded size,
        denoise all in one U-Net call, resize back and merge."""
        h, w = current_model.shape[2], current_model.shape[3]
        unpadded = self.diffusion_model.image_size[0] - 2
        patches = split_data_to_patches(current_model, kernel_size, stride)
        resized = bilinear_resize(patches, (unpadded, unpadded))
        den = self._posterior_mean(diffusion_pad(resized), t)
        back = bilinear_resize(den, tuple(kernel_size))
        return merge_patches_to_data(back, (h, w), kernel_size, stride)

    def _apply_diffusion_denoising_with_patches(self, current_model, t,
                                                kernel_size=None,
                                                stride=None,
                                                use_patches=False):
        """Patch only if ``use_patches`` and the model is not square or is
        wider than the denoiser."""
        h, w = current_model.shape[2], current_model.shape[3]
        if kernel_size is None:
            kernel_size = [h, h]
        if stride is None:
            stride = [1, 1]
        image_size = self.diffusion_model.image_size[0]
        if use_patches and (w != h or w > image_size):
            return self._denoise_patched(current_model, t, kernel_size,
                                         stride)
        return self._denoise(current_model, t)

    # -- inner FWI loop --------------------------------------------------

    def _fwi_loop(self, mu, y, mask, ts, lr, grad_norm, grad_smooth,
                  model_blur, grad_clip):
        """``ts`` Adam steps at the constant rate ``lr`` on the summed
        observation loss, Adam's state new for this call. With
        ``grad_norm`` the gradients are divided by the first step's max |g|
        over the whole batch; ``grad_smooth`` smooths them and takes the
        max anew every step; the clip to ``grad_clip`` times that max
        applies only when one of the two set it."""
        optimizer = Adam(constant_schedule(lr))
        state = optimizer.init(mu)
        smooth = grad_smooth is not None and grad_smooth > 0
        has_grad_max = bool(grad_norm) or smooth
        clip = grad_clip is not None and grad_clip > 0 and has_grad_max
        grad_max = torch.zeros((), dtype=_F32, device=mu.device)
        for it in range(ts):
            x = mu.detach().requires_grad_(True)
            g, = torch.autograd.grad(
                observation_loss(self.fwi_forward(x), y, mask).sum(), x)
            if grad_norm:
                if it == 0:
                    grad_max = g.abs().max()
                g = torch.where(grad_max > 0, g / grad_max, g)
            if smooth:
                g = gaussian_smooth(g, grad_smooth)
                grad_max = g.abs().max()
            if clip:
                g = torch.where(grad_max > 0,
                                clip_total_norm(g, grad_clip * grad_max), g)
            updates, state = optimizer.update(g, state)
            mu = mu + updates
            if model_blur:
                mu = gaussian_blur_3x3(mu)
            mu = mu.clamp(-1.0, 1.0)
        return mu

    # -- main loop -------------------------------------------------------

    def optimize(self, mu, mu_true, y, fwi_forward, ts: int = 300,
                 diffusion_ts: int = 500, lr: float = 0.03,
                 noise_std: float = 0.0, noise_type: str = 'gaussian',
                 missing_number: int = 0, grad_norm: bool = True,
                 grad_smooth: Optional[float] = None,
                 model_blur: bool = False, grad_clip: float = 1.0,
                 use_patches: bool = False, patch_kernel_size=None,
                 patch_stride=None,
                 generator: Optional[torch.Generator] = None,
                 noise_draw: Optional[torch.Tensor] = None,
                 trace_mask: Optional[torch.Tensor] = None,
                 progress: bool = True):
        """Run the method; returns (final model, per-sample metric curves,
        one entry per outer step).

        ``mu``: the initial model (B, 1, H, W) in [-1, 1], not padded.
        ``mu_true``: the truth in m/s. ``y``: the observations, corrupted
        once before the loop as ``InversionEngine.optimize`` does
        (``noise_std``/``noise_type`` with the draw ``noise_draw``,
        ``missing_number`` with the (B, ng) mask ``trace_mask``, each from
        ``generator`` unless given; without a generator, the next of the
        global sequence)."""
        if mu.shape[0] != y.shape[0]:
            raise ValueError(
                'Batch size mismatch between velocity and seismic data')
        if fwi_forward is None or not callable(fwi_forward):
            raise ValueError(
                'fwi_forward must be a callable forward modeling function')
        self.fwi_forward = fwi_forward
        dev = self.device
        if generator is None:
            generator = next_key(dev)

        mu = torch.as_tensor(mu, dtype=_F32, device=dev)
        mu_true_norm = v_normalize(torch.as_tensor(mu_true, dtype=_F32,
                                                   device=dev))
        y = torch.as_tensor(y, dtype=_F32, device=dev)
        y = add_noise_to_seismic(y, noise_std, noise_type=noise_type,
                                 generator=generator, draw=noise_draw)
        y, mask = missing_trace(y, missing_number, generator=generator,
                                trace_mask=trace_mask)

        current = mu
        history = []
        for step in range(diffusion_ts - 1, -1, -1):
            prev = current
            current = self._apply_diffusion_denoising_with_patches(
                current, step, kernel_size=patch_kernel_size,
                stride=patch_stride, use_patches=use_patches)
            current = self._post_denoise_hook(current, prev, step, generator)
            if step != 0:
                current = self._fwi_loop(current, y, mask, ts, lr, grad_norm,
                                         grad_smooth, model_blur, grad_clip)
            with torch.no_grad():
                obs = observation_loss(self.fwi_forward(current), y, mask)
            mae, rmse, ssim_v = calculate_metrics(current, mu_true_norm)
            history.append(dict(total_losses=obs, obs_losses=obs, mae=mae,
                                rmse=rmse, ssim=ssim_v))
            if progress and (step % 10 == 0 or step == diffusion_ts - 1):
                print(f'  t={step:4d}  SSIM {float(ssim_v.mean()):.4f}',
                      flush=True)

        curves = {k: torch.stack([h[k] for h in history]).cpu().numpy()
                  for k in CURVES}
        per_model = [{k: list(curves[k][:, i]) for k in CURVES}
                     for i in range(mu.shape[0])]
        return current.detach(), per_model

    def _post_denoise_hook(self, denoised, prev_model, step, generator):
        """Extension point; ILVR overrides it with its low-frequency blend
        against the pre-denoise model."""
        return denoised
