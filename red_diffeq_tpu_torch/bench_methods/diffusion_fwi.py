"""DiffusionFWI: the diffusion-guided FWI competitor method.

Counterpart of ``red_diffeq_tpu/bench_methods/diffusion_fwi.py``: an outer
reverse-diffusion loop (t from ``diffusion_ts - 1`` down to 0) that
alternates a posterior-mean denoise of the velocity model with an inner
Adam FWI loop of ``ts`` steps under gradient tricks (the first step's
max-abs normalisation, Gaussian gradient smoothing, total-norm clipping, a
3x3 model blur, the clamp to [-1, 1]), and no FWI at t = 0. After each
outer step the model is evaluated (forward only): the observation loss,
MAE, RMSE and SSIM, per sample.

The JAX package runs three programs an outer step: the jitted denoise
(with a traced t), the inner loop as one ``lax.scan`` and the jitted
metrics. Here each is a body on the fixed buffers of a run
(:class:`_RunBuffers`: the model, the observations, Adam's moments, an
outer and an inner step count on the device, the timesteps as a table,
ILVR's draws made before the loop, the (diffusion_ts, B) curves), and on
the card each is a CUDA graph (``core/graphs.py``), captured once per
configuration and U-Net weights and replayed: one replay of the denoise
(and ILVR's blend) and of the metrics an outer step, one of the inner
step a step. The outer loop stays on the host, as in the JAX package. On
the CPU the same bodies run eagerly. A model wider than the denoiser is
cut into windows that all go to the U-Net in one call.
"""
from typing import Optional

import torch

from red_diffeq_tpu_torch.bench_methods.filters import (
    clip_total_norm, gaussian_blur_3x3, gaussian_smooth,
)
from red_diffeq_tpu_torch.bench_methods.resizer import bilinear_resize
from red_diffeq_tpu_torch.core import graphs
from red_diffeq_tpu_torch.core.inversion import (
    Adam, _operator_key, constant_schedule,
)
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
        # The graphs of the last configuration run (``optimize``).
        self._graphs = graphs.GraphCache(kind=lambda key: key[0])

    # -- denoising -------------------------------------------------------

    @torch.no_grad()
    def _posterior_mean(self, padded: torch.Tensor, t) -> torch.Tensor:
        """The clamped posterior mean of the padded models at timestep
        ``t`` (a number, or a (1,) tensor on the device), cropped back."""
        n = padded.shape[0]
        bt = (t.repeat(n) if torch.is_tensor(t) else
              torch.full((n,), t, dtype=torch.long, device=padded.device))
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

    # -- the programs of an outer step, on a run's buffers ---------------

    def _denoise_body(self, b, kernel_size, stride, use_patches) -> None:
        """The denoise of outer step ``b.outer`` (its timestep from the
        table); the model before it kept in ``b.prev``."""
        t = b.times.index_select(0, b.outer.reshape(1))
        den = self._apply_diffusion_denoising_with_patches(
            b.cur, t, kernel_size=kernel_size, stride=stride,
            use_patches=use_patches)
        b.prev.copy_(b.cur)
        b.cur.copy_(den)

    def _inner_body(self, b, ts, lr, grad_norm, grad_smooth, model_blur,
                    grad_clip) -> None:
        """One inner Adam step at the constant rate ``lr`` on the summed
        observation loss; step ``b.inner % ts`` of its outer step, whose
        first step starts Adam's state anew. With ``grad_norm`` the
        gradients are divided by the first step's max |g| over the whole
        batch; ``grad_smooth`` smooths them and takes the max anew every
        step; the clip to ``grad_clip`` times that max applies only when
        one of the two set it. Then the blur and the clamp."""
        smooth = grad_smooth is not None and grad_smooth > 0
        has_grad_max = bool(grad_norm) or smooth
        clip = grad_clip is not None and grad_clip > 0 and has_grad_max
        optimizer = Adam(constant_schedule(lr))
        it = b.inner % ts
        first = it == 0
        x = b.cur.detach().requires_grad_(True)
        g, = torch.autograd.grad(
            observation_loss(self.fwi_forward(x), b.y, b.mask).sum(), x)
        grad_max = b.grad_max
        if grad_norm:
            grad_max = torch.where(first, g.abs().max(), grad_max)
            g = torch.where(grad_max > 0, g / grad_max, g)
        if smooth:
            g = gaussian_smooth(g, grad_smooth)
            grad_max = g.abs().max()
        if clip:
            g = torch.where(grad_max > 0,
                            clip_total_norm(g, grad_clip * grad_max), g)
        updates, state = optimizer.update(g, {
            'count': it, 'mu': torch.where(first, 0.0, b.m),
            'nu': torch.where(first, 0.0, b.v)})
        with torch.no_grad():
            mu = b.cur + updates
            if model_blur:
                mu = gaussian_blur_3x3(mu)
            b.cur.copy_(mu.clamp(-1.0, 1.0))
            b.m.copy_(state['mu'])
            b.v.copy_(state['nu'])
            b.grad_max.copy_(grad_max)
            b.inner += 1

    @torch.no_grad()
    def _metrics_body(self, b) -> None:
        """The evaluation of outer step ``b.outer`` (the observation loss,
        MAE, RMSE, SSIM) into its row of the curves; the next outer
        step."""
        k = b.outer.reshape(1)
        obs = observation_loss(self.fwi_forward(b.cur), b.y, b.mask)
        mae, rmse, ssim_v = calculate_metrics(b.cur, b.target)
        for name, v in (('total_losses', obs), ('obs_losses', obs),
                        ('mae', mae), ('rmse', rmse), ('ssim', ssim_v)):
            b.history[name].index_copy_(0, k, v[None])
        b.outer += 1

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
        global sequence). On the card each program of an outer step
        replays its CUDA graph, which this method keeps per configuration
        (the shapes, ``ts``, the tricks, ``lr``, the operator, the U-Net
        and its weights) for later runs."""
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
        steps = list(range(diffusion_ts - 1, -1, -1))
        blends = [self._blend_factor(step) for step in steps]

        d = self.diffusion_model
        key = (type(self), tuple(mu.shape), tuple(y.shape),
               tuple(mask.shape), tuple(mu_true_norm.shape), diffusion_ts,
               ts, float(lr), bool(grad_norm), grad_smooth, bool(model_blur),
               grad_clip, bool(use_patches),
               None if patch_kernel_size is None else tuple(patch_kernel_size),
               None if patch_stride is None else tuple(patch_stride),
               _operator_key(fwi_forward), d.model, bool(d.half_precision),
               self._blend_key())
        loops = graphs.loop_graphs(
            self._graphs, key, d.weights_stamp(), dev,
            lambda: _RunBuffers(mu.shape, y.shape, mask.shape,
                                mu_true_norm.shape, steps, dev))
        b = loops.state
        b.load(mu, y, mask, mu_true_norm)
        self._blend_draws(b, steps, generator)

        denoise = graphs.Body(lambda: self._denoise_body(
            b, patch_kernel_size, patch_stride, use_patches), dev)
        inner = graphs.Body(lambda: self._inner_body(
            b, ts, lr, grad_norm, grad_smooth, model_blur, grad_clip), dev)
        metrics = graphs.Body(lambda: self._metrics_body(b), dev)
        more_inner = (diffusion_ts - 1) * ts > 1
        for i, step in enumerate(steps):
            later = i + 1 < diffusion_ts
            loops.run('denoise', denoise, capture=later)
            if blends[i] is not None:
                f = blends[i]
                loops.run(f'blend {f}', graphs.Body(
                    lambda: self._blend_body(b, f), dev))
            if step != 0:
                for _ in range(ts):
                    loops.run('inner', inner, capture=more_inner)
            loops.run('metrics', metrics, capture=later)
            if progress and (step % 10 == 0 or step == diffusion_ts - 1):
                print(f'  t={step:4d}  SSIM '
                      f'{float(b.history["ssim"][i].mean()):.4f}',
                      flush=True)

        curves = {k: b.history[k].cpu().numpy() for k in CURVES}
        per_model = [{k: list(curves[k][:, i]) for k in CURVES}
                     for i in range(mu.shape[0])]
        return b.cur.clone(), per_model

    # -- the blend after the denoise (ILVR) -------------------------------

    def _blend_factor(self, step):
        """The blend after the denoise of ``step`` (its name's part), or
        None for none: DiffusionFWI blends never."""
        return None

    def _blend_key(self):
        """What the blend reads from the method's settings (graph key)."""
        return None

    def _blend_draws(self, b, steps, generator) -> None:
        """Draws the blends take, made into ``b`` before the loop."""

    def _blend_body(self, b, factor) -> None:
        raise NotImplementedError


class _RunBuffers:
    """The fixed buffers of a DiffusionFWI run: the model ``cur`` and its
    value before the last denoise ``prev``; the observations, their mask
    and the normalised truth; the outer step count (int64) and the inner
    step count (int32) on the device; the timestep of each outer step
    (``times``); Adam's moments and the gradient max; ILVR's draw of each
    outer step (``noise``); the (diffusion_ts, B) curves."""

    def __init__(self, shape, y_shape, mask_shape, target_shape, steps,
                 device):
        dev = torch.device(device)
        self.device = dev
        self.cur, self.prev, self.m, self.v = (
            torch.zeros(shape, dtype=_F32, device=dev) for _ in range(4))
        self.y = torch.zeros(y_shape, dtype=_F32, device=dev)
        self.mask = torch.ones(mask_shape, dtype=_F32, device=dev)
        self.target = torch.zeros(target_shape, dtype=_F32, device=dev)
        self.outer = torch.zeros((), dtype=torch.int64, device=dev)
        self.inner = torch.zeros((), dtype=torch.int32, device=dev)
        self.grad_max = torch.zeros((), dtype=_F32, device=dev)
        self.times = torch.tensor(steps, dtype=torch.int64, device=dev)
        self.noise = torch.zeros((len(steps), *shape), dtype=_F32,
                                 device=dev)
        self.history = {k: torch.zeros((len(steps), shape[0]), dtype=_F32,
                                       device=dev) for k in CURVES}

    def load(self, mu, y, mask, target) -> None:
        """A run's initial model and inputs; both counts back to 0."""
        self.cur.copy_(mu)
        self.y.copy_(y)
        self.mask.copy_(mask)
        self.target.copy_(target)
        self.outer.zero_()
        self.inner.zero_()
