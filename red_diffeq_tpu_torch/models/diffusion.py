"""Gaussian diffusion: the schedule, the forward process, the model's
predictions, the reverse process (ancestral and DDIM sampling) and the
training loss.

Counterpart of ``red_diffeq_tpu/models/diffusion.py:82-431``. Schedule
coefficients are computed in float64 on the host and stored as float32
tensors on the device. Public functions keep the JAX package's
(B, 1, H, W) layout. The samplers (the JAX package's are one
``lax.scan`` each) run one step as a body on fixed buffers
(:class:`_Chain`) that on the card is a CUDA graph, captured once per
configuration and replayed a step (``core/graphs.py``); on the CPU the
same body runs eagerly. Their draws come from a ``torch.Generator``, all
made before the chain in the order the steps take them, unless given as
one stacked tensor, so that tests can feed JAX's draws. So do the
training loss's (:meth:`GaussianDiffusion.loss`: the timesteps, the noise
and the offset noise).
"""
import copy
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from red_diffeq_tpu_torch.core import graphs
from red_diffeq_tpu_torch.models.unet import Unet
from red_diffeq_tpu_torch.utils.device import resolve_device
from red_diffeq_tpu_torch.utils.diffusion_utils import extract
from red_diffeq_tpu_torch.utils.seed_utils import next_key


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps: int, start: float = -3, end: float = 3,
                          tau: float = 1.0) -> np.ndarray:
    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start, v_end = sigmoid(start / tau), sigmoid(end / tau)
    ac = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    betas = 1 - ac[1:] / ac[:-1]
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {
    'linear': linear_beta_schedule,
    'cosine': cosine_beta_schedule,
    'sigmoid': sigmoid_beta_schedule,
}


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed fp32 coefficient tensors."""
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor

    @staticmethod
    def create(timesteps: int, beta_schedule: str = 'sigmoid',
               objective: str = 'pred_noise', min_snr_loss_weight: bool = False,
               min_snr_gamma: float = 5.0,
               schedule_fn_kwargs: Optional[dict] = None,
               device='cpu') -> 'DiffusionSchedule':
        betas = _SCHEDULES[beta_schedule](timesteps,
                                          **(schedule_fn_kwargs or {}))
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        snr = ac / (1 - ac)
        clipped_snr = np.minimum(snr, min_snr_gamma) if min_snr_loss_weight \
            else snr
        if objective == 'pred_noise':
            loss_weight = clipped_snr / snr
        elif objective == 'pred_x0':
            loss_weight = clipped_snr
        elif objective == 'pred_v':
            loss_weight = clipped_snr / (snr + 1)
        else:
            raise ValueError(f'unknown objective {objective}')

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return DiffusionSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(
                np.log(np.clip(post_var, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas)
                                     / (1.0 - ac)),
            loss_weight=f32(loss_weight),
        )


def _normalize(x):
    return x * 2.0 - 1.0


def _unnormalize(x):
    return (x + 1.0) * 0.5


def _identity(x):
    return x


class GaussianDiffusion:
    """The U-Net and its schedule on one device (default ``'cuda'``; without
    a card it raises unless ``device='cpu'``). ``sampling_timesteps`` below
    ``timesteps`` makes :meth:`sample` take DDIM (with ``ddim_sampling_eta``)
    instead of the ancestral chain; ``auto_normalize`` maps images in
    [0, 1] to the model's [-1, 1] and back. The training loss adds
    ``offset_noise_strength`` times a per-(sample, channel) offset to the
    noise, and ``min_snr_loss_weight`` clips each timestep's SNR weight at
    ``min_snr_gamma``. ``schedule_fn_kwargs`` go to the beta schedule.
    ``params``, a flax-style tree of numpy arrays (the JAX package's U-Net
    parameters), is loaded into ``model``. With ``half_precision``
    :meth:`apply_fn` runs the U-Net in bf16 (:meth:`apply_fn`)."""

    def __init__(self, model: Unet, *, image_size, timesteps: int = 1000,
                 sampling_timesteps: Optional[int] = None,
                 objective: str = 'pred_noise', beta_schedule: str = 'sigmoid',
                 schedule_fn_kwargs: Optional[dict] = None,
                 ddim_sampling_eta: float = 0.0, auto_normalize: bool = True,
                 offset_noise_strength: float = 0.0,
                 min_snr_loss_weight: bool = False,
                 min_snr_gamma: float = 5.0, params=None,
                 half_precision: bool = False, device=None):
        if objective not in ('pred_noise', 'pred_x0', 'pred_v'):
            raise ValueError(f'unknown objective {objective}')
        self.device = resolve_device(device)
        # Eval mode throughout, training included: the U-Net has neither
        # dropout nor running statistics, so its output is the same in
        # both modes, as the JAX model's is.
        self.model = model.to(self.device).eval()
        if params is not None:
            self.params = params
        self.channels = model.channels
        self.self_condition = model.self_condition
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self.image_size = tuple(image_size)
        self.objective = objective
        self.num_timesteps = int(timesteps)
        self.sampling_timesteps = int(sampling_timesteps or timesteps)
        if self.sampling_timesteps > self.num_timesteps:
            raise ValueError(f'sampling_timesteps ({self.sampling_timesteps}) '
                             f'exceeds timesteps ({self.num_timesteps})')
        self.is_ddim_sampling = self.sampling_timesteps < self.num_timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.offset_noise_strength = offset_noise_strength
        self.auto_normalize = auto_normalize
        self.half_precision = half_precision
        self.normalize = _normalize if auto_normalize else _identity
        self.unnormalize = _unnormalize if auto_normalize else _identity
        self.schedule = DiffusionSchedule.create(
            timesteps, beta_schedule, objective, min_snr_loss_weight,
            min_snr_gamma, schedule_fn_kwargs, device=self.device)
        self._bf16 = None
        # Sampler chains' CUDA graphs, one per kind (``_chain``).
        self._graphs = _chain_graphs()

    @property
    def params(self) -> dict:
        """The U-Net's weights as a flax parameter tree of float32 numpy
        arrays, the JAX bundle's ``params``. Assigning a tree (the shipped
        prior's, a milestone's ``ema_params``) copies it into the U-Net in
        place, which bumps the parameters' versions, so the bf16 copy
        (:meth:`bf16_params`) is made again at its next use."""
        from red_diffeq_tpu_torch.io.checkpoints import state_dict_to_flax
        return state_dict_to_flax(self.model.state_dict())

    @params.setter
    def params(self, tree) -> None:
        from red_diffeq_tpu_torch.io.checkpoints import flax_to_state_dict
        self.model.load_state_dict(flax_to_state_dict(tree, self.model))

    def with_params(self, params) -> 'GaussianDiffusion':
        """A bundle like this one whose U-Net holds ``params`` (a flax
        parameter tree), as the JAX bundle's ``with_params``: a copy of the
        U-Net, so this bundle's weights stay as they are."""
        new = copy.copy(self)
        new.model = copy.deepcopy(self.model)
        new.params = params
        return new

    def __copy__(self) -> 'GaussianDiffusion':
        """A shallow copy with a bf16 copy and sampler graphs of its own:
        both belong to the U-Net's weights, which a copy mostly replaces
        (``with_params``, the trainer's EMA bundle, a replica)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._bf16 = None
        new._graphs = _chain_graphs()
        return new

    def release_graphs(self) -> None:
        """Drop the sampler chains' graphs and return their pools to the
        card."""
        self._graphs.release()

    def weights_stamp(self) -> tuple:
        """The address and version of each U-Net parameter. A ``params``
        assignment (an in-place copy) or a train step changes it, and so
        does a parameter tensor at another address; a CUDA graph of a step
        that reads the weights (or their bf16 copy) is kept only under its
        stamp."""
        return tuple((p.data_ptr(), p._version)
                     for p in self.model.parameters())

    def bf16_params(self) -> Dict[str, torch.Tensor]:
        """A bf16 copy of the U-Net's parameters, made again whenever a
        parameter has changed in place since the last copy (a loaded
        checkpoint, a train step)."""
        params = dict(self.model.named_parameters())
        stamp = self.weights_stamp()
        if self._bf16 is None or self._bf16[0] != stamp:
            with torch.no_grad():
                self._bf16 = (stamp, {n: p.detach().to(torch.bfloat16)
                                      for n, p in params.items()})
        return self._bf16[1]

    def run_model(self, x, t, params: Optional[Dict[str, torch.Tensor]] = None,
                  x_self_cond=None):
        """The U-Net on ``x`` (and ``x_self_cond`` under self-conditioning)
        at timesteps ``t`` with ``params`` (a dict of parameter tensors by
        name, differentiable) in place of its own; the inputs are cast to
        the parameters' dtype, so bf16 parameters run the U-Net in bf16 (the
        embedding of ``t`` is computed in fp32 first)."""
        if params is None:
            return self.model(x, t, x_self_cond)
        dtype = next(iter(params.values())).dtype
        if x_self_cond is not None:
            x_self_cond = x_self_cond.to(dtype)
        return torch.func.functional_call(self.model, params,
                                          (x.to(dtype), t, x_self_cond))

    def apply_fn(self, x, t, x_self_cond=None):
        """One denoiser forward pass (the profiler range ``unet``). With
        ``half_precision`` the weights and activations are bf16 and the
        input and output fp32; the schedule's arithmetic stays fp32."""
        with record_function('unet'):
            if self.half_precision:
                return self.run_model(x, t, self.bf16_params(),
                                      x_self_cond).float()
            return self.model(x, t, x_self_cond)

    def q_sample(self, x_start, t, noise=None, generator=None):
        """Diffuse ``x_start`` to timestep ``t`` with ``noise``, drawn from
        ``generator`` (the JAX method's ``key``) when not given."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device, dtype=x_start.dtype)
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        s = self.schedule
        return ((extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def predict_v(self, x_start, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.ndim) * noise
                - extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * x_start)

    def predict_start_from_v(self, x_t, t, v):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(s.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)

    def model_predictions(self, x, t, x_self_cond=None, clip_x_start=False,
                          rederive_pred_noise=False) -> ModelPrediction:
        out = self.apply_fn(x, t, x_self_cond)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start \
            else (lambda v: v)
        if self.objective == 'pred_noise':
            pred_noise = out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
            if clip_x_start and rederive_pred_noise:
                pred_noise = self.predict_noise_from_start(x, t, x_start)
        elif self.objective == 'pred_x0':
            x_start = clip(out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return ModelPrediction(pred_noise, x_start)

    def q_posterior(self, x_start, x_t, t):
        """Mean, variance and clipped log variance of q(x_{t-1} | x_t, x_0)."""
        s = self.schedule
        mean = (extract(s.posterior_mean_coef1, t, x_t.ndim) * x_start
                + extract(s.posterior_mean_coef2, t, x_t.ndim) * x_t)
        var = extract(s.posterior_variance, t, x_t.ndim)
        log_var = extract(s.posterior_log_variance_clipped, t, x_t.ndim)
        return mean, var, log_var

    def p_mean_variance(self, x, t, x_self_cond=None,
                        clip_denoised: bool = True):
        """(mean, variance, log variance, x_start) of p(x_{t-1} | x_t), the
        predicted x_start clamped to [-1, 1] with ``clip_denoised``."""
        x_start = self.model_predictions(x, t, x_self_cond).pred_x_start
        if clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        mean, var, log_var = self.q_posterior(x_start, x, t)
        return mean, var, log_var, x_start

    def _batch_t(self, x, t: int) -> torch.Tensor:
        return torch.full((x.shape[0],), int(t), dtype=torch.long,
                          device=x.device)

    def _draws(self, noise, n, shape, generator) -> torch.Tensor:
        """A chain's ``n`` draws of ``shape``: ``noise`` (n, *shape) as
        given, else ``n`` standard normals from ``generator``, one call
        each, in the eager chain's order, stacked."""
        if noise is not None:
            return noise
        return torch.stack([torch.randn(shape, generator=generator,
                                        device=self.device)
                            for _ in range(n)])

    @torch.no_grad()
    def p_sample(self, x, t: int, generator=None, noise=None,
                 x_self_cond=None):
        """One ancestral reverse step from timestep ``t``: the posterior
        mean plus its standard deviation times ``noise`` (drawn from
        ``generator`` unless given), except at t == 0. Returns
        (x_{t-1}, x_start)."""
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        return self._ancestral_step(x, self._batch_t(x, t), float(t > 0),
                                    noise, x_self_cond)

    def _ancestral_step(self, x, bt, nz, noise, x_self_cond=None):
        """:meth:`p_sample` at timesteps ``bt`` (B,), ``nz`` 1 or 0 (a
        number or a device scalar)."""
        mean, _, log_var, x_start = self.p_mean_variance(x, bt, x_self_cond)
        return mean + nz * torch.exp(0.5 * log_var) * noise, x_start

    @torch.no_grad()
    def p_sample_deterministic(self, x, t: int, x_self_cond=None):
        """The posterior mean without noise. Returns (mean, x_start)."""
        mean, _, _, x_start = self.p_mean_variance(x, self._batch_t(x, t),
                                                   x_self_cond)
        return mean, x_start

    def _chain(self, kind, start, times, draws=None, tables=None,
               trail=False):
        """Run one sampler chain (a step a timestep of ``times``) from
        ``start`` as a body on fixed buffers (:class:`_Chain`): on the card
        a CUDA graph of the step, captured once per configuration and
        weights (``weights_stamp``) and replayed, else eagerly. ``draws``
        (steps, *shape) are the steps' draws; ``tables()`` makes DDIM's
        per-step coefficients. Returns the last image (a new tensor), or
        with ``trail`` the start and every step's image stacked on axis
        1."""
        n = len(times)
        key = (kind, self.model, tuple(start.shape), tuple(times), trail,
               bool(self.half_precision), float(self.ddim_sampling_eta))
        loops = graphs.loop_graphs(
            self._graphs, key, self.weights_stamp(), self.device,
            lambda: _Chain(self, kind, start.shape, times,
                           draws is not None, tables, trail))
        chain = loops.state
        chain.load(start, draws)
        for i in range(n):
            loops.run('step', chain, capture=i + 1 < n)
        return (chain.trail if trail else chain.img).clone()

    @torch.no_grad()
    def p_sample_loop(self, shape, generator=None, noise=None,
                      return_all_timesteps: bool = False):
        """The ancestral chain from pure noise over every timestep, one
        step a replay of its CUDA graph on the card (the JAX package's one
        ``lax.scan``). ``noise`` (num_timesteps + 1, *shape), if given,
        holds the start image, then each step's draw in the order the steps
        run (t from num_timesteps - 1 down to 0); else all are drawn from
        ``generator`` before the chain, in that order. Returns images in
        [0, 1] (with ``auto_normalize``), or with ``return_all_timesteps``
        every image of the chain stacked on axis 1."""
        draws = self._draws(noise, self.num_timesteps + 1, shape, generator)
        out = self._chain('ancestral', draws[0],
                          list(range(self.num_timesteps - 1, -1, -1)),
                          draws[1:], trail=return_all_timesteps)
        return self.unnormalize(out)

    def _ddim_tables(self, times):
        """DDIM's per-step coefficients on the device, each computed as
        the eager step computes it (scalar by scalar): sqrt(alpha_next),
        c and sigma, and the last step's flag (time_next < 0)."""
        eta, ac = self.ddim_sampling_eta, self.schedule.alphas_cumprod
        rows = {'sqrt_alpha_next': [], 'c': [], 'sigma': []}
        one = torch.ones((), device=self.device)
        for time, time_next in zip(times[:-1], times[1:]):
            alpha = ac[time]
            alpha_next = one if time_next < 0 else ac[time_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next)
                                     * (1 - alpha_next) / (1 - alpha))
            rows['sqrt_alpha_next'].append(torch.sqrt(alpha_next))
            rows['c'].append(torch.sqrt(
                (1 - alpha_next - sigma ** 2).clamp_min(0.0)))
            rows['sigma'].append(sigma)
        tables = {k: torch.stack(v) for k, v in rows.items()}
        tables['last'] = torch.tensor([bool(t < 0) for t in times[1:]],
                                      device=self.device)
        return tables

    @torch.no_grad()
    def ddim_sample(self, shape, generator=None, noise=None,
                    return_all_timesteps: bool = False):
        """The DDIM sampler over ``sampling_timesteps`` steps of the grid
        ``linspace(-1, T - 1, sampling_timesteps + 1)``, reversed; the last
        step returns the clamped x_start. One step a replay of its CUDA
        graph on the card, its coefficients per-step device tables.
        ``noise`` (sampling_timesteps + 1, *shape), if given, holds the
        start image, then each step's draw (which only
        ``ddim_sampling_eta`` > 0 lets in); else all are drawn from
        ``generator`` before the chain, in that order."""
        times = np.linspace(-1, self.num_timesteps - 1,
                            self.sampling_timesteps + 1).astype(int)[::-1]
        draws = self._draws(noise, self.sampling_timesteps + 1, shape,
                            generator)
        out = self._chain('ddim', draws[0], [int(t) for t in times[:-1]],
                          draws[1:], lambda: self._ddim_tables(times),
                          trail=return_all_timesteps)
        return self.unnormalize(out)

    def sample(self, batch_size: int = 16, generator=None, noise=None,
               return_all_timesteps: bool = False):
        """``batch_size`` images from pure noise: DDIM when
        ``sampling_timesteps`` < ``timesteps``, else the ancestral chain.
        ``noise`` as the chosen sampler takes it; without ``generator`` the
        next generator of the global sequence."""
        if generator is None and noise is None:
            generator = next_key(self.device)
        shape = (batch_size, self.channels, *self.image_size)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(shape, generator=generator, noise=noise,
                  return_all_timesteps=return_all_timesteps)

    @torch.no_grad()
    def interpolate(self, x1, x2, generator=None, t: Optional[int] = None,
                    lam: float = 0.5, noise=None):
        """Diffuse ``x1`` and ``x2`` to timestep ``t`` (default T - 1), mix
        them with weight ``lam`` and run the ancestral chain from t - 1 to
        0 (a replay of its step's CUDA graph a step on the card). ``noise``
        (t + 2, *x1.shape), if given, holds x1's and x2's forward draws,
        then each step's; else all are drawn from ``generator`` first, in
        that order."""
        t = self.num_timesteps - 1 if t is None else t
        draws = self._draws(noise, t + 2, x1.shape, generator)
        bt = self._batch_t(x1, t)
        xt1 = self.q_sample(x1, bt, draws[0])
        xt2 = self.q_sample(x2, bt, draws[1])
        img = (1 - lam) * xt1 + lam * xt2
        if t == 0:
            return img
        return self._chain('ancestral', img, list(range(t - 1, -1, -1)),
                           draws[2:])

    def p_losses(self, x_start, t, noise=None, offset=None, generator=None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """The weighted denoising loss of ``x_start`` (in the model's range)
        diffused to timesteps ``t`` (B,): the per-sample mean squared error
        of the model's output against the objective's target, times the
        schedule's ``loss_weight[t]``, averaged over the batch. ``noise``
        (shaped as ``x_start``) and, with offset noise, ``offset`` (B, C)
        are standard normal draws from ``generator`` unless given. The
        U-Net runs on ``params`` if given (:meth:`run_model`: bf16
        parameters run it in bf16, as the JAX trainer's ``amp`` does), else
        on its own fp32 weights; the loss is fp32 either way."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device, dtype=x_start.dtype)
        ons = self.offset_noise_strength
        if ons > 0.0:
            if offset is None:
                offset = torch.randn(x_start.shape[:2], generator=generator,
                                     device=x_start.device,
                                     dtype=x_start.dtype)
            noise = noise + ons * offset[:, :, None, None]
        x = self.q_sample(x_start, t, noise)
        model_out = self.run_model(x, t, params)
        if self.objective == 'pred_noise':
            target = noise
        elif self.objective == 'pred_x0':
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        loss = ((model_out - target) ** 2).mean(dim=(1, 2, 3))
        loss = loss * extract(self.schedule.loss_weight, t, 1)
        return loss.mean()

    def loss(self, img, t=None, noise=None, offset=None, generator=None,
             params: Optional[Dict[str, torch.Tensor]] = None):
        """The training loss of a batch of images in [0, 1] at timesteps
        ``t`` (B,), drawn uniformly from ``generator`` unless given
        (reference ``models/diffusion.py:549-554``); ``params`` as
        :meth:`p_losses` takes them."""
        b, _, h, w = img.shape
        if (h, w) != self.image_size:
            raise ValueError(f'image size must be {self.image_size}, got '
                             f'{(h, w)}')
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,),
                              generator=generator, device=img.device)
        return self.p_losses(self.normalize(img), t.long(), noise=noise,
                             offset=offset, generator=generator,
                             params=params)


def _chain_graphs() -> graphs.GraphCache:
    """A bundle's sampler graphs: one of each chain kind (ancestral, DDIM,
    deterministic), the last configuration run."""
    return graphs.GraphCache(kind=lambda key: key[0])


class _Chain:
    """One sampler chain's fixed buffers and its step on them: the image,
    the step count (int64 on the device), each step's timestep (and the
    ancestral chain's noise flag, t > 0), each step's draw, DDIM's
    coefficient tables (``tables()``), and with ``trail`` a (B, steps + 1,
    ...) buffer of the start and every step's image. ``kind`` is
    'ancestral' (:meth:`GaussianDiffusion.p_sample`), 'ddim' or
    'deterministic' (the posterior mean, between [0, 1] images: RED's
    post-process)."""

    def __init__(self, diffusion, kind, shape, times, has_draws, tables,
                 trail):
        dev = diffusion.device
        self.diffusion, self.kind, self.device = diffusion, kind, dev
        self.img = torch.zeros(shape, device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.times = torch.tensor(times, dtype=torch.int64, device=dev)
        self.nz = (self.times > 0).float()
        self.draws = (torch.zeros((len(times), *shape), device=dev)
                      if has_draws else None)
        self.tables = tables() if tables is not None else None
        self.trail = (torch.zeros((shape[0], len(times) + 1, *shape[1:]),
                                  device=dev) if trail else None)

    def load(self, start, draws) -> None:
        """A run's start image and draws; the count back to 0."""
        self.img.copy_(start)
        self.count.zero_()
        if draws is not None:
            self.draws.copy_(draws)
        if self.trail is not None:
            self.trail[:, 0].copy_(start)

    def body(self) -> None:
        """Step ``count`` of the chain, its image into ``img`` (and the
        trail)."""
        d, img = self.diffusion, self.img
        k = self.count.reshape(1)
        bt = self.times.index_select(0, k.expand(img.shape[0]))
        if self.kind == 'ancestral':
            new, _ = d._ancestral_step(img, bt, self.nz.index_select(0, k),
                                       self.draws.index_select(0, k)[0])
        elif self.kind == 'ddim':
            pred_noise, x_start = d.model_predictions(
                img, bt, clip_x_start=True, rederive_pred_noise=True)
            tb = {n: v.index_select(0, k) for n, v in self.tables.items()}
            new = (x_start * tb['sqrt_alpha_next'] + tb['c'] * pred_noise
                   + tb['sigma'] * self.draws.index_select(0, k)[0])
            new = torch.where(tb['last'], x_start, new)
        else:
            mean, _, _, _ = d.p_mean_variance(d.normalize(img), bt)
            new = d.unnormalize(mean)
        self.img.copy_(new)
        if self.trail is not None:
            self.trail.index_copy_(1, k + 1, new[:, None])
        self.count += 1
