"""The inversion engine: gradient descent on the velocity model.

Counterpart of ``red_diffeq_tpu/core/inversion.py:34-75, 266-``: each step
perturbs the model by ``sigma_x0`` noise (diffusion regularisation only),
crops the 1px pad before the solver, takes the per-sample L1 plus lambda
times the regulariser, updates with Adam under a cosine-decay learning
rate, clamps to [-1, 1], and records MAE, RMSE and SSIM of the cropped
result. The optimizer is the arithmetic of ``optax.adam`` with
``optax.cosine_decay_schedule(lr, ts)``, so the first update uses ``lr``.
Each step's draws (the ``sigma_x0`` noise, the RED timestep and the RED
noise) come from a ``torch.Generator`` unless given explicitly; without
one, ``optimize`` takes the next generator of the global sequence
(``utils/seed_utils.py``), as the JAX engine takes ``next_key()``.

With a ('data', 'shot') device mesh (``parallel/mesh.py``) each data
shard's samples step on the shard's first device, and each shot shard
propagates its slice of the shots on its own device
(``solvers/acoustic.py:forward_modeling``'s ``shot_devices``): the
seismogram is gathered on the data shard, and each chunk's per-shot
coefficient cotangents are summed there over all shots in shot order. The
draws are made for the whole batch in the unsharded order and sliced. On
the kernel backend a sharded run is the unsharded run bit for bit.
"""
import io
import math
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from red_diffeq_tpu_torch.core.graphs import (
    METRICS, GraphCache, StepBuffers, StepGraph, graphed as _graphed,
)
from red_diffeq_tpu_torch.core.losses import observation_loss, total_loss
from red_diffeq_tpu_torch.core.metrics import calculate_metrics
from red_diffeq_tpu_torch.io.checkpoints import atomic_write_bytes
from red_diffeq_tpu_torch.parallel.mesh import Mesh, batch_sharding
from red_diffeq_tpu_torch.regularization.base import make_reg_fn
from red_diffeq_tpu_torch.utils.data_trans import (
    add_noise_to_seismic, missing_trace, v_normalize,
)
from red_diffeq_tpu_torch.utils.device import resolve_device
from red_diffeq_tpu_torch.utils.profiling import StepTimer, trace
from red_diffeq_tpu_torch.utils.seed_utils import next_key

_VALID_REG = ('diffusion', 'l2', 'tv', 'hybrid', None)
_F32 = torch.float32


def constant_schedule(value: float):
    """A constant rate in float32, as ``optax.adam(value)`` takes it."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), value, dtype=_F32, device=count.device)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha=0)`` in
    float32 on the count's device: lr(k) = init * 0.5 * (1 + cos(pi *
    min(k, decay) / decay))."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.clamp(max=decay_steps).to(_F32)
        decayed = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * decayed

    return schedule


class Adam:
    """``optax.adam(schedule)`` (b1 0.9, b2 0.999, eps 1e-8 added after the
    square root) on one tensor, as a pure update. The step count is an
    int32 tensor on the parameters' device, as optax's, and the rate and
    the bias corrections are computed there from it, so that a CUDA graph
    of the update reads the count of the step it replays."""

    def __init__(self, schedule: Callable[[torch.Tensor], torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: torch.Tensor) -> Dict:
        return {'count': torch.zeros((), dtype=torch.int32,
                                     device=params.device),
                'mu': torch.zeros_like(params),
                'nu': torch.zeros_like(params)}

    def update(self, grads: torch.Tensor, state: Dict):
        """Returns (updates, new_state); apply with ``params + updates``."""
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grads + b1 * state['mu']
        nu = (1 - b2) * (grads * grads) + b2 * state['nu']
        count = state['count'] + 1
        k = count.to(_F32)
        mu_hat = mu / (1 - b1 ** k)
        nu_hat = nu / (1 - b2 ** k)
        updates = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        updates = updates * -self.schedule(state['count'])
        return updates, {'count': count, 'mu': mu, 'nu': nu}


def make_inversion_step(fwi_fn: Callable, reg_fn: Callable, optimizer: Adam,
                        reg_lambda: float, sigma_x0: float,
                        is_diffusion: bool):
    """Build one update step
    ``step(mu, opt_state, *, y, mask, mu_true_norm, x0_noise=None, t=None,
    reg_noise=None, generator=None) -> (mu, opt_state, metrics)``."""

    def step(mu, opt_state, *, y, mask, mu_true_norm, x0_noise=None, t=None,
             reg_noise=None, generator=None):
        mu_p = mu.detach().requires_grad_(True)
        if is_diffusion:
            if x0_noise is None:
                x0_noise = torch.randn(mu.shape, generator=generator,
                                       device=mu.device, dtype=mu.dtype)
            x0_pred = mu_p + sigma_x0 * x0_noise
        else:
            x0_pred = mu_p
        predicted = fwi_fn(x0_pred[:, :, 1:-1, 1:-1])
        obs = observation_loss(predicted, y, mask)
        reg, t = reg_fn(x0_pred, t=t, noise=reg_noise, generator=generator)
        tot = total_loss(obs, reg, reg_lambda)
        grads, = torch.autograd.grad(tot.sum(), mu_p)

        updates, opt_state = optimizer.update(grads, opt_state)
        mu = (mu + updates).clamp(-1.0, 1.0)

        mae, rmse, ssim_val = calculate_metrics(mu[:, :, 1:-1, 1:-1],
                                                mu_true_norm)
        metrics = {
            'total_losses': tot.detach(), 'obs_losses': obs.detach(),
            'reg_losses': reg.detach(), 'mae': mae, 'rmse': rmse,
            'ssim': ssim_val,
        }
        if t is not None:
            metrics['t'] = t
        return mu, opt_state, metrics

    return step


def _step_draws(reg_fn, is_diffusion: bool, shape, generator, device):
    """One step's draws in the order the step makes them: the ``sigma_x0``
    noise of ``shape`` (diffusion only), then RED's timesteps and noise
    (``reg_fn.draws``)."""
    out = {}
    if is_diffusion:
        out['x0_noise'] = torch.randn(shape, generator=generator,
                                      device=device, dtype=_F32)
    if hasattr(reg_fn, 'draws'):
        out['t'], out['reg_noise'] = reg_fn.draws(shape, generator, device,
                                                  _F32)
    return out


class _MeshSteps:
    """The inversion step over a ('data', 'shot') mesh. The model, Adam's
    moments, the observations, their mask and the targets of the metrics
    are held as one part per data shard on the shard's first device
    (:meth:`split`, :meth:`gather`); each data shard's operator splits its
    shots over the shard's devices (:meth:`FWIForward.sharded`)."""

    def __init__(self, mesh, fwi_forward, reg_fn, optimizer, reg_lambda,
                 sigma_x0, is_diffusion, y, mask, mu_true_norm):
        self.mesh = mesh
        self.data, shot = mesh.devices.shape
        if y.shape[1] % shot:
            raise ValueError(f'{y.shape[1]} shots do not divide over mesh '
                             f"axis 'shot' of size {shot}")
        if shot > 1 and not hasattr(fwi_forward, 'sharded'):
            raise ValueError('a mesh with shot > 1 needs an FWIForward (an '
                             'operator that can split its shots)')
        self.is_diffusion = is_diffusion
        self.reg_fn = reg_fn
        self.batch = batch_sharding(mesh)
        self.ys, self.masks, self.targets = (
            self.split(t) for t in (y, mask, mu_true_norm))
        self.steps = [make_inversion_step(
            fwi_forward.sharded(list(mesh.devices[d]))
            if hasattr(fwi_forward, 'sharded') else fwi_forward,
            reg_fn, optimizer, reg_lambda, sigma_x0, is_diffusion)
            for d in range(self.data)]

    def split(self, x):
        """One part of ``x`` (B, ...) per data shard, on its first device
        (a view of ``x`` where that is ``x``'s device)."""
        return [x[self.batch.index(x.shape, d, 0)].to(self.mesh.device(d, 0))
                for d in range(self.data)]

    def gather(self, parts):
        first = self.mesh.first_device
        return torch.cat([p.to(first) for p in parts])

    def split_state(self, state):
        mus, nus = self.split(state['mu']), self.split(state['nu'])
        return [{'count': state['count'].to(m.device), 'mu': m, 'nu': n}
                for m, n in zip(mus, nus)]

    def gather_state(self, states):
        return {'count': states[0]['count'].to(self.mesh.first_device),
                'mu': self.gather([s['mu'] for s in states]),
                'nu': self.gather([s['nu'] for s in states])}

    def __call__(self, mus, states, generator, draws=None):
        """One step of every data shard: the whole batch's draws from
        ``generator`` in the unsharded order (or ``draws``, a dict of the
        whole batch's ``x0_noise``, ``t`` and ``reg_noise``), each shard's
        slice of them. Returns (parts of mu, Adam states, metrics gathered
        on the mesh's first device)."""
        if draws is None:
            shape = (sum(m.shape[0] for m in mus), *mus[0].shape[1:])
            draws = _step_draws(self.reg_fn, self.is_diffusion, shape,
                                generator, generator.device)
        x0_noise, t, noise = (draws.get(k) for k in
                              ('x0_noise', 't', 'reg_noise'))
        out_mu, out_states, out_metrics = [], [], []
        lo = 0
        for d, (step, mu, state) in enumerate(zip(self.steps, mus, states)):
            dev = mu.device
            rows = slice(lo, lo + mu.shape[0])
            lo += mu.shape[0]

            def part(v):
                return None if v is None else v[rows].to(dev)

            mu, state, m = step(
                mu, state, y=self.ys[d], mask=self.masks[d],
                mu_true_norm=self.targets[d], x0_noise=part(x0_noise),
                t=part(t), reg_noise=part(noise), generator=generator)
            out_mu.append(mu)
            out_states.append(state)
            out_metrics.append(m)
        metrics = {k: self.gather([m[k] for m in out_metrics])
                   for k in out_metrics[0]}
        return out_mu, out_states, metrics


def _one_device(mesh) -> bool:
    return len({torch.device(d) for d in mesh.devices.flat}) == 1


def _operator_key(fwi_forward):
    """The operator's part of a step graph's key, as the JAX engine's
    ``_operator_key``: an :class:`FWIForward` by its geometry, backend,
    chunk, adjoint and the route that resolves to, its normalisation and
    its devices; any other callable by itself (held, so that a recycled
    id never aliases a stale graph)."""
    if not hasattr(fwi_forward, 'geom'):
        return fwi_forward
    from red_diffeq_tpu_torch.ops import stencil
    route = fwi_forward.backend
    if route == 'kernel':
        route, _ = stencil.resolve_run_config(
            fwi_forward.geom, fwi_forward.chunk, fwi_forward.adjoint)
    return (fwi_forward.geom, fwi_forward.backend, fwi_forward.chunk,
            fwi_forward.adjoint, route, fwi_forward.normalize,
            fwi_forward.v_denorm_func, fwi_forward.s_norm_func,
            fwi_forward.device, tuple(fwi_forward.shot_devices or ()))


def _sync(dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _print_step(i: int, ts: int, m) -> None:
    t_str = (f"  t {int(round(float(m['t'].float().mean())))}"
             if 't' in m else '')
    print(f"step {i:4d}/{ts}"
          f"  MAE {float(m['mae'].mean()):.4f}"
          f"  RMSE {float(m['rmse'].mean()):.4f}"
          f"  SSIM {float(m['ssim'].mean()):.4f}"
          + t_str, flush=True)


class InversionEngine:
    """Drives the velocity-model optimisation on ``device`` (default
    ``'cuda'``; without a card it raises unless ``device='cpu'``).
    ``diffusion_model`` is a GaussianDiffusion bundle, or None when no
    diffusion regularisation is used. ``ssim_loss`` is accepted for the JAX
    signature and unused, as there: the metrics take the batched
    functional SSIM.

    On the card :meth:`optimize` replays a CUDA graph of the step
    (``core/graphs.py``), which the engine keeps per configuration
    (:meth:`_cache_key`) until :meth:`release_graphs`."""

    def __init__(self, diffusion_model=None, ssim_loss=None,
                 regularization: Optional[str] = None,
                 use_time_weight: bool = False, sigma_x0: float = 0.0001,
                 fixed_timestep: Optional[int] = None, device=None):
        del ssim_loss
        if regularization not in _VALID_REG + ('none',):
            raise ValueError(f'Unknown regularization: {regularization}')
        self.device = resolve_device(device)
        self.diffusion_model = diffusion_model
        self.regularization = regularization
        self.use_time_weight = use_time_weight
        self.sigma_x0 = sigma_x0
        self.fixed_timestep = fixed_timestep
        self._graphs = GraphCache()

    def _cache_key(self, reg_name, ts, lr, reg_lambda, mu_shape, y_shape,
                   fwi_forward, mesh=None):
        """(configuration, weights stamp) of a step graph. The
        configuration is the JAX engine's ``_cache_key`` (regulariser, ts,
        lr, lambda, sigma_x0, the shapes, the operator) with the engine's
        other settings, its device, the mesh, and for 'diffusion' the
        bundle and its precision; the stamp is the U-Net weights' identity
        and version (:meth:`GaussianDiffusion.weights_stamp`), which a
        ``params`` assignment or a train step changes."""
        d = self.diffusion_model if reg_name == 'diffusion' else None
        config = (reg_name, int(ts), float(lr), float(reg_lambda),
                  float(self.sigma_x0), bool(self.use_time_weight),
                  self.fixed_timestep, tuple(mu_shape), tuple(y_shape),
                  _operator_key(fwi_forward), self.device, mesh, d,
                  None if d is None else bool(d.half_precision))
        return config, None if d is None else d.weights_stamp()

    def release_graphs(self) -> None:
        """Free the captured step graphs and their memory pools."""
        self._graphs.release()

    @property
    def graph_captures(self) -> int:
        """Step graphs this engine has captured."""
        return self._graphs.captures

    def graph_info(self):
        """What each kept step graph holds: the kernel ``launches`` of one
        replay, the capture's ``seconds``, the pool's ``pool_bytes``."""
        return self._graphs.info()

    def _scan_buffers(self, mesh, fwi_forward, reg_fn, optimizer, reg_lambda,
                      is_diffusion, mu_shape, ts, y, mask, mu_true_norm):
        """The step on fixed buffers (:class:`StepBuffers`) for ``ts``
        steps, its inputs ``y``, ``mask`` and ``mu_true_norm`` loaded;
        ``split`` and ``gather`` map a whole (B, ...) tensor to the model's
        parts and back."""
        history = dict.fromkeys(METRICS, _F32)
        if is_diffusion:
            history['t'] = torch.int64
        bufs = StepBuffers(tuple(y.shape), tuple(mu_true_norm.shape), ts,
                           history, self.device)
        bufs.load_inputs(y, mask, mu_true_norm)
        zeros = torch.zeros(mu_shape, dtype=_F32, device=self.device)
        if mesh is None:
            step = make_inversion_step(fwi_forward, reg_fn, optimizer,
                                       reg_lambda, self.sigma_x0,
                                       is_diffusion)

            def advance(mus, states, draws):
                mu, state, m = step(mus[0], states[0], y=bufs.y,
                                    mask=bufs.mask,
                                    mu_true_norm=bufs.target, **draws)
                return [mu], [state], m

            bufs.split, bufs.gather = (lambda x: [x]), (lambda p: p[0])
            bufs.bind(advance, [zeros])
            return bufs
        shards = _MeshSteps(mesh, fwi_forward, reg_fn, optimizer, reg_lambda,
                            self.sigma_x0, is_diffusion, bufs.y, bufs.mask,
                            bufs.target)

        def advance(mus, states, draws):
            return shards(mus, states, None, draws=draws)

        bufs.split, bufs.gather = shards.split, shards.gather
        bufs.bind(advance, shards.split(zeros))
        return bufs

    def warm_compile(self, mu_shape, y_shape, fwi_forward, ts: int = 300,
                     lr: float = 0.03, reg_lambda: float = 0.01,
                     regularization: Optional[str] = None,
                     use_scan: bool = True, params_template=None):
        """Pay in advance what the first :meth:`optimize` of one
        configuration would pay; counterpart of the JAX engine's
        ahead-of-time compile (``red_diffeq_tpu/core/inversion.py:218``).

        One inversion step runs on zero inputs of ``mu_shape`` (padded)
        and ``y_shape``: the kernel library's nvcc build and ``ctypes``
        load, the adjoint route the operator resolves for these shapes,
        the first launch of each kernel on it, and the first U-Net call at
        the configuration's batch and precision (where cuDNN picks its
        algorithms). On the card with ``use_scan`` that step is the
        warm-up of the step's CUDA graph for this configuration
        (``ts``, ``lr`` and ``reg_lambda`` included), which is then
        captured and kept, so that :meth:`optimize` with the same
        configuration replays it with no capture of its own. The step's
        draws come from a generator of its own, so it changes nothing that
        ``optimize`` reads: no draw from the caller's or the global
        generators, no Adam state, no curve. On the CPU, or without
        ``use_scan``, the step runs and nothing is captured.
        ``params_template`` (a flax parameter tree, the JAX signature's)
        is checked against the U-Net's parameters and is not loaded. The
        JAX method's checks raise as there (e.g. 'diffusion' without a
        model).

        Returns what it warmed: the operator's ``backend``, the adjoint
        ``route`` ('reverse' or 'tape' on the kernel backend, else the
        backend's name), the steps per launch of each blocked kernel it
        launched (``unroll``), each kernel's ``launches`` in the step, the
        ``seconds`` it took, and ``graph``: None, or what the capture
        made (the kernel ``launches`` of one replay, the capture's
        ``seconds`` and the memory pool's ``pool_bytes``)."""
        from red_diffeq_tpu_torch.ops import stencil

        mu_shape, y_shape = tuple(mu_shape), tuple(y_shape)
        if len(mu_shape) != 4 or len(y_shape) != 4:
            raise ValueError('mu_shape and y_shape must be 4-D, got '
                             f'{mu_shape} and {y_shape}')
        if mu_shape[0] != y_shape[0]:
            raise ValueError(
                'Batch size mismatch between velocity and seismic data')
        if regularization not in _VALID_REG:
            raise ValueError(f'Unknown regularization: {regularization}')
        if fwi_forward is None or not callable(fwi_forward):
            raise ValueError(
                'fwi_forward must be a callable forward modeling function')
        if int(ts) < 1:
            raise ValueError(f'ts must be at least 1, got {ts}')
        reg_name = (regularization if regularization is not None
                    else self.regularization)
        is_diffusion = reg_name == 'diffusion'
        reg_fn = make_reg_fn(reg_name, self.diffusion_model,
                             use_time_weight=self.use_time_weight,
                             fixed_timestep=self.fixed_timestep)
        if is_diffusion and params_template is not None:
            from red_diffeq_tpu_torch.io.checkpoints import (
                flax_to_state_dict,
            )
            flax_to_state_dict(params_template, self.diffusion_model.model)

        dev = self.device
        optimizer = Adam(cosine_decay_schedule(lr, ts))
        mu = torch.zeros(mu_shape, dtype=_F32, device=dev)
        y = torch.zeros(y_shape, dtype=_F32, device=dev)
        b, c, hp, wp = mu_shape
        mu_true_norm = torch.zeros((b, c, hp - 2, wp - 2), dtype=_F32,
                                   device=dev)
        own = torch.Generator(device=dev)
        own.manual_seed(0)
        before = dict(stencil.launches)
        t0 = time.perf_counter()
        captured = None
        if dev.type == 'cuda' and use_scan:
            bufs = self._scan_buffers(None, fwi_forward, reg_fn, optimizer,
                                      reg_lambda, is_diffusion, mu_shape,
                                      int(ts), y, torch.ones_like(y),
                                      mu_true_norm)
            bufs.fill_draws(lambda: _step_draws(reg_fn, is_diffusion,
                                                mu_shape, own, dev),
                            range(1), own)
            graph = StepGraph(bufs)
            self._graphs.put(*self._cache_key(
                reg_name, ts, lr, reg_lambda, mu_shape, y_shape,
                fwi_forward), graph)
            captured = graph.info()
        else:
            step = make_inversion_step(fwi_forward, reg_fn, optimizer,
                                       reg_lambda, self.sigma_x0,
                                       is_diffusion)
            step(mu, optimizer.init(mu), y=y, mask=torch.ones_like(y),
                 mu_true_norm=mu_true_norm, generator=own)
        _sync(dev)
        seconds = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in stencil.launches.items()
                    if n > before[k]}
        backend = getattr(fwi_forward, 'backend', None)
        route = backend
        if backend == 'kernel':
            route, _ = stencil.resolve_run_config(
                fwi_forward.geom, fwi_forward.chunk, fwi_forward.adjoint)
        return {'backend': backend, 'route': route,
                'unroll': {k: stencil.last_unroll[k] for k in launched
                           if k in stencil.BLOCKED},
                'launches': launched, 'seconds': seconds, 'graph': captured}

    def optimize(self, mu, mu_true, y, fwi_forward, ts: int = 300,
                 lr: float = 0.03, reg_lambda: float = 0.01,
                 noise_std: float = 0.0, noise_type: str = 'gaussian',
                 missing_number: int = 0,
                 regularization: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 noise_draw: Optional[torch.Tensor] = None,
                 trace_mask: Optional[torch.Tensor] = None,
                 use_scan: bool = True, progress: bool = True,
                 log_interval: int = 50,
                 profile_dir: Optional[str] = None,
                 mesh=None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 50,
                 resume: bool = False,
                 segment_steps: Optional[int] = None):
        """Run ``ts`` steps; returns (mu_cropped, per-sample metric curves).

        ``mu``: initial model, padded (B, 1, H+2, W+2), in [-1, 1].
        ``mu_true``: ground truth in m/s, (B, 1, H, W).
        ``y``: observed seismograms (B, ns, nt, ng), corrupted once before
        the loop by :func:`add_noise_to_seismic` (``noise_std``,
        ``noise_type``; its draw ``noise_draw`` if given) and
        :func:`missing_trace` (``missing_number``; the (B, ng) receiver
        mask ``trace_mask`` if given).
        ``generator``: source of the corruption's draws, then of every
        step's (the JAX engine's ``key``); when None, the next generator of
        the global sequence (:func:`next_key`) on the engine's device, so
        two calls draw differently and ``set_seed`` repeats them.
        ``progress``: print MAE, RMSE and SSIM every ``log_interval`` steps
        and at the last, then the host's time per step.
        ``profile_dir``: trace the step loop with ``torch.profiler`` into a
        Chrome trace in that directory (:func:`trace`); each step is the
        range ``inversion_step``.

        ``use_scan=True`` (the default), the JAX engine's whole-loop scan:
        on the card the step is a CUDA graph (``core/graphs.py``), captured
        at the first step of a configuration (or by :meth:`warm_compile`)
        and replayed for every step. Every step's draws are made before the
        loop from ``generator``, in the order and shapes the eager loop
        draws them, so the values are the same; the metrics stay on the
        card in a (ts, B) history until the end. The host waits for the
        card only at a ``progress`` line, a segment's end, a snapshot and
        the end. A capture or launch error raises. The timing line is the
        host's clock over the replays after the first, to the card's
        finish. On the CPU, which has no CUDA graph, the same loop calls
        the step on its buffers directly, so both settings run eagerly
        there, with the same results. ``use_scan=False``: the eager loop,
        one step at a time, its draws made in the step. ``segment_steps``
        (needs ``use_scan``) waits for the card every that many steps.

        Checkpoint/resume (needs ``use_scan``, excludes
        ``segment_steps``, as in the JAX engine): with ``checkpoint_path``,
        after every ``checkpoint_every`` steps and at the last, a snapshot
        (the step, ``mu``, Adam's count and moments, the metrics so far and
        the generator's state after that step's draws) is written there
        with ``torch.save``; ``resume=True`` continues from the file's step
        if the file exists. The resumed steps draw from the saved generator
        state, after the corruption has drawn from ``generator`` as in the
        first run, so a resume repeats the uninterrupted run exactly when
        ``generator`` starts in the same state.

        ``mesh``: a ('data', 'shot') mesh (:func:`make_mesh`): the batch is
        split over 'data' and the shots over 'shot' (each must divide; a
        shot split needs an :class:`FWIForward`). The corruption runs on the
        engine's device before the split, each step draws for the whole
        batch and hands each data shard its slice, and the result and the
        curves are gathered on the mesh's first device. Snapshots hold the
        gathered state, so a run resumes on any mesh or none. A mesh whose
        devices are all one card is one CUDA graph of all the shards'
        steps; a mesh over distinct cards runs the steps eagerly (says
        so)."""
        if mu.shape[0] != y.shape[0]:
            raise ValueError(
                'Batch size mismatch between velocity and seismic data')
        if regularization not in _VALID_REG:
            raise ValueError(f'Unknown regularization: {regularization}')
        if fwi_forward is None or not callable(fwi_forward):
            raise ValueError(
                'fwi_forward must be a callable forward modeling function')
        reg_name = (regularization if regularization is not None
                    else self.regularization)
        is_diffusion = reg_name == 'diffusion'
        if is_diffusion and self.diffusion_model is None:
            raise ValueError(
                "Diffusion model required for 'diffusion' regularization")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f'mesh must be a Mesh of make_mesh, got '
                            f'{type(mesh).__name__}')
        if mesh is not None and mesh.first_device.type != self.device.type:
            raise ValueError(f'the mesh lies on {mesh.first_device}, the '
                             f'engine on {self.device}')
        if checkpoint_path is not None and not use_scan:
            raise ValueError(
                'checkpoint_path requires use_scan=True (snapshots are '
                'written between scan segments)')
        if segment_steps is not None and not use_scan:
            raise ValueError(
                'segment_steps segments the scanned loop; with '
                'use_scan=False every step is already its own dispatch')
        if segment_steps is not None and checkpoint_path is not None:
            raise ValueError(
                'segment_steps and checkpoint_path both segment the '
                'scan; use checkpoint_path with checkpoint_every='
                f'{segment_steps} to get snapshots at that granularity')

        dev = self.device
        mu = torch.as_tensor(mu, dtype=_F32, device=dev)
        mu_true_norm = v_normalize(torch.as_tensor(mu_true, dtype=_F32,
                                                   device=dev))
        y = torch.as_tensor(y, dtype=_F32, device=dev)
        if generator is None:
            generator = next_key(dev)
        y = add_noise_to_seismic(y, noise_std, noise_type=noise_type,
                                 generator=generator, draw=noise_draw)
        y, mask = missing_trace(y, missing_number, generator=generator,
                                trace_mask=trace_mask)

        reg_fn = make_reg_fn(reg_name, self.diffusion_model,
                             use_time_weight=self.use_time_weight,
                             fixed_timestep=self.fixed_timestep)
        optimizer = Adam(cosine_decay_schedule(lr, ts))
        args = (mu, y, mask, mu_true_norm, generator, fwi_forward, reg_fn,
                optimizer, reg_lambda, is_diffusion, ts, mesh, progress,
                log_interval, profile_dir)
        if use_scan:
            mu, metrics = self._scan_loop(
                *args, reg_name=reg_name, lr=lr,
                path=None if checkpoint_path is None else Path(
                    checkpoint_path),
                every=max(1, int(checkpoint_every)), resume=resume,
                seg=None if segment_steps is None
                else max(1, int(segment_steps)))
        else:
            mu, metrics = self._eager_loop(*args)
        per_model = [{k: list(metrics[k][:, i]) for k in METRICS}
                     for i in range(mu.shape[0])]
        return mu[:, :, 1:-1, 1:-1], per_model

    def _eager_loop(self, mu, y, mask, mu_true_norm, generator, fwi_forward,
                    reg_fn, optimizer, reg_lambda, is_diffusion, ts, mesh,
                    progress, log_interval, profile_dir):
        """``use_scan=False``: one step at a time, each drawing for
        itself. Returns (mu, {metric: (ts, B) array})."""
        dev = self.device
        opt_state = optimizer.init(mu)
        if mesh is None:
            step = make_inversion_step(fwi_forward, reg_fn, optimizer,
                                       reg_lambda, self.sigma_x0,
                                       is_diffusion)

            def advance(mu, opt_state):
                return step(mu, opt_state, y=y, mask=mask,
                            mu_true_norm=mu_true_norm, generator=generator)

            def gather(mu):
                return mu
        else:
            shards = _MeshSteps(mesh, fwi_forward, reg_fn, optimizer,
                                reg_lambda, self.sigma_x0, is_diffusion, y,
                                mask, mu_true_norm)
            mu, opt_state = shards.split(mu), shards.split_state(opt_state)

            def advance(mu, opt_state):
                return shards(mu, opt_state, generator)

            gather = shards.gather
        history = []
        timer = StepTimer()
        with trace(profile_dir, dev):
            for i in range(ts):
                with timer, record_function('inversion_step'):
                    mu, opt_state, m = advance(mu, opt_state)
                history.append(m)
                if progress and (i % log_interval == 0 or i == ts - 1):
                    _print_step(i, ts, m)
        if progress and timer.times:
            print(f'timing: {timer.summary()}', flush=True)
        metrics = {k: torch.stack([h[k] for h in history]).cpu().numpy()
                   for k in METRICS}
        return gather(mu), metrics

    def _scan_loop(self, mu, y, mask, mu_true_norm, generator, fwi_forward,
                   reg_fn, optimizer, reg_lambda, is_diffusion, ts, mesh,
                   progress, log_interval, profile_dir, *, reg_name, lr,
                   path, every, resume, seg):
        """``use_scan=True``: the step on fixed buffers, replayed as a
        CUDA graph on the card. Returns (mu, {metric: (ts, B) array})."""
        dev = self.device
        one_card = mesh is None or _one_device(mesh)
        graphed = _graphed(dev) and one_card
        if dev.type == 'cuda' and not one_card:
            print(f'mesh over {len(set(mesh.devices.flat))} distinct cards: '
                  'the steps run eagerly (no CUDA graph across cards)',
                  flush=True)
        start, opt_state, done = 0, optimizer.init(mu), None
        if resume and path is not None and path.exists():
            start, mu, opt_state, done = _load_snapshot(path, dev, generator)
            print(f'Resumed inversion from step {start} ({path})')
        graph = key = None
        if graphed:
            key, stamp = self._cache_key(reg_name, ts, lr, reg_lambda,
                                         mu.shape, y.shape, fwi_forward, mesh)
            graph = self._graphs.get(key, stamp)
        if graph is not None:
            bufs = graph.buffers
            bufs.load_inputs(y, mask, mu_true_norm)
        else:
            bufs = self._scan_buffers(mesh, fwi_forward, reg_fn, optimizer,
                                      reg_lambda, is_diffusion, mu.shape, ts,
                                      y, mask, mu_true_norm)
        bufs.load_state(bufs.split(mu), bufs.split(opt_state['mu']),
                        bufs.split(opt_state['nu']), start)
        if done is not None:
            bufs.load_history(done)
        saves = (set(range(start + every, ts + 1, every)) | {ts}
                 if path is not None else set())
        gen_states = bufs.fill_draws(
            lambda: _step_draws(reg_fn, is_diffusion, mu.shape, generator,
                                dev), range(start, ts), generator, saves)

        timer = StepTimer()
        t0 = None
        with trace(profile_dir, dev):
            for i in range(start, ts):
                with record_function('inversion_step'):
                    if graph is not None:
                        graph.replay()
                    elif graphed and i + 1 < ts:
                        # Step i eagerly (the warm-up), then the capture.
                        graph = StepGraph(bufs)
                        self._graphs.put(key, stamp, graph)
                    else:
                        bufs.body()
                if i == start:
                    _sync(dev)
                    t0 = time.perf_counter()
                if progress and (i % log_interval == 0 or i == ts - 1):
                    _print_step(i, ts, {k: h[i] for k, h in
                                        bufs.history.items()})
                if seg is not None and (i + 1) % seg == 0:
                    _sync(dev)
                if i + 1 in saves:
                    _save_snapshot(
                        path, i + 1, bufs.gather(bufs.mus),
                        {'count': bufs.count, 'mu': bufs.gather(bufs.ms),
                         'nu': bufs.gather(bufs.vs)},
                        {k: h[:i + 1] for k, h in bufs.history.items()},
                        gen_states[i + 1])
            _sync(dev)
        if ts - start > 1:
            timer.add_span(time.perf_counter() - t0, ts - start - 1)
        if progress and timer.times:
            print(f'timing: {timer.summary()}', flush=True)
        metrics = {k: bufs.history[k].cpu().numpy() for k in METRICS}
        return bufs.gather(bufs.mus).clone(), metrics


def _save_snapshot(path: Path, step: int, mu, opt_state, metrics,
                   generator_state) -> None:
    """The loop's state after ``step`` steps, written with ``torch.save``
    through :func:`atomic_write_bytes`: ``metrics`` the (step, B) history
    of each metric, ``generator_state`` the generator's after that step's
    draws."""
    snapshot = {'step': step, 'mu': mu.cpu(),
                'opt_state': {'count': int(opt_state['count']),
                              'mu': opt_state['mu'].cpu(),
                              'nu': opt_state['nu'].cpu()},
                'metrics': {k: v.cpu() for k, v in metrics.items()},
                'generator': generator_state}
    buf = io.BytesIO()
    torch.save(snapshot, buf)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_bytes(path, buf.getvalue())


def _load_snapshot(path: Path, dev, generator):
    """(step, mu, opt_state, the (step, B) metrics) from a snapshot on
    ``dev``; restores ``generator`` to the state it had after that step's
    draws."""
    snap = torch.load(io.BytesIO(path.read_bytes()), map_location=dev,
                      weights_only=True)
    generator.set_state(snap['generator'].cpu())
    opt = snap['opt_state']
    count = torch.tensor(int(opt['count']), dtype=torch.int32, device=dev)
    return (snap['step'], snap['mu'],
            {'count': count, 'mu': opt['mu'], 'nu': opt['nu']},
            snap['metrics'])
