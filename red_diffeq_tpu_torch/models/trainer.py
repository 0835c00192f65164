"""Diffusion pretraining: the trainer of the denoising U-Net.

Counterpart of ``red_diffeq_tpu/models/trainer.py`` (the reference Trainer,
``red_diffeq/models/diffusion.py:574-694``): Adam with betas (0.9, 0.99)
after global-norm gradient clipping, gradient accumulation, EMA weights
with update periodicity and warm-up, milestone checkpoints with a losses
JSON and an RNG sidecar, EMA sample grids, and the inception-free FID
proxy (Frechet distance in a frozen random-conv feature space).

One optimiser step is one host call (:meth:`Trainer.train_step`): the JAX
package scans K steps per dispatch (``_make_train_multi*``), a device for a
remote TPU that the card does not need. The arithmetic is optax's:
``clip_by_global_norm`` scales by ``max_norm / norm`` only when the norm
reaches ``max_norm`` (no epsilon), and ``adam`` adds eps 1e-8 after the
square root of the bias-corrected second moment (eps_root 0); both run as
multi-tensor (``torch._foreach_*``) operations with the clip's choice made
on the card, so a step never waits for the host. Losses stay on the card
until a log line or a milestone reads them. Batches come from
``np.random.RandomState(seed)`` in the JAX trainer's order of draws, so
both packages train on the same batches; the noise and timesteps come from
a ``torch.Generator`` on the card. A :class:`TensorDataset` that fits under
``device_data_max_bytes`` is uploaded once and its batches gathered on the
card by index; the choice is by size, made once.

With ``data_parallel`` and more than one card (or an explicit ``devices``
list, which may repeat a device) each micro-batch is split over the
devices: each runs a replica of the U-Net on its rows with the master
weights, and the gradients are added onto the first device in device
order before the clip, Adam and the EMA, as the JAX trainer's all-reduce
implies. The draws are made for the whole micro-batch and sliced, so a
split step sees the draws of an unsplit one.

Checkpoints are the shipped prior's format (``io/checkpoints.py``):
``model-<k>.ckpt`` holds ``{'step', 'params', 'ema_params', 'opt_state',
'version'}`` with the U-Net weights, the EMA weights and Adam's moments as
flax trees, so either package's ``load_diffusion_params`` reads its
``ema_params``; ``opt_state`` (``{'count', 'mu', 'nu'}``) is the port's
own, and resuming a JAX milestone in the port, or the reverse, is not
supported.
"""
import copy
import json
import time
from dataclasses import dataclass, fields
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from red_diffeq_tpu_torch.io.checkpoints import (
    atomic_write_bytes, flax_to_state_dict, load_params, packb,
    state_dict_to_flax,
)
from red_diffeq_tpu_torch.utils.precision import fp32_convolutions


@dataclass
class EMAConfig:
    """ema-pytorch's behaviour as the reference uses it
    (``models/diffusion.py:596``): step-gated, periodic, warmed-up decay."""
    decay: float = 0.995
    update_every: int = 10
    update_after_step: int = 100
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def _ema_decay_at(step: int, cfg: EMAConfig) -> float:
    """The warm-up schedule 1 - (1 + t/inv_gamma)^-power with t = step -
    update_after_step - 1, clamped to [0, decay], and 0 while t <= 0, in
    float32 as the JAX trainer computes it (``trainer.py:111-116``)."""
    f32 = np.float32
    t = f32(max(step - cfg.update_after_step - 1, 0))
    value = f32(1.0) - (f32(1.0) + t / f32(cfg.inv_gamma)) ** f32(-cfg.power)
    if t <= 0:
        return 0.0
    return float(np.clip(value, f32(0.0), f32(cfg.decay)))


# The frozen FID feature extractor: four 3x3 stride-2 convs with
# leaky-relu 0.2 and a global mean pool. Its weights are the JAX trainer's
# (``jax.random`` with seed 0x5EED, ``trainer.py:51-74``), shipped as data
# by ``tools/write_fid_weights.py``: the HWIO kernels raveled and
# concatenated in layer order.
_FID_CHANNELS = (16, 32, 64, 128)
_FID_WEIGHTS = Path(__file__).resolve().parent / 'fid_weights.npy'


def frozen_feature_weights() -> List[np.ndarray]:
    """The four HWIO conv kernels of the frozen FID feature extractor."""
    flat = np.load(_FID_WEIGHTS)
    ws, at, c_in = [], 0, 1
    for c_out in _FID_CHANNELS:
        n = 9 * c_in * c_out
        ws.append(flat[at:at + n].reshape(3, 3, c_in, c_out))
        at, c_in = at + n, c_out
    if at != flat.size:
        raise ValueError(f'{_FID_WEIGHTS} holds {flat.size} values, '
                         f'expected {at}')
    return ws


def _same_pad(n: int, k: int = 3, stride: int = 2):
    """XLA's 'SAME' padding of one axis: (before, after), the odd cell
    after (72 -> 36 pads (0, 1), 9 -> 5 pads (1, 1))."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def frozen_feature_apply(weights: List[torch.Tensor], x: torch.Tensor
                         ) -> torch.Tensor:
    """(N, 1, H, W) in [-1, 1] -> (N, 128) features: each conv with XLA's
    'SAME' padding at stride 2, written out (``nn.Conv2d(padding=1)`` would
    pad 72 by (1, 1) and shift every feature), then leaky-relu 0.2; the
    mean over the last map. ``weights`` are OIHW tensors."""
    with fp32_convolutions():
        for w in weights:
            (top, bottom), (left, right) = (_same_pad(n) for n in
                                            x.shape[-2:])
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2)
            x = F.leaky_relu(x, 0.2)
    return x.mean(dim=(2, 3))


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Frechet distance between Gaussian fits of two feature sets (N, D):
    |mu_a - mu_b|^2 + tr(S_a + S_b - 2 (S_a S_b)^(1/2)), each covariance
    regularised by eps*I (with N < D samples it is singular)."""
    import scipy.linalg

    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    offset = eps * np.eye(feats_a.shape[1])
    s_a = np.cov(feats_a, rowvar=False) + offset
    s_b = np.cov(feats_b, rowvar=False) + offset
    covmean = scipy.linalg.sqrtm(s_a @ s_b)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(s_a) + np.trace(s_b)
                 - 2.0 * np.trace(covmean))


class TensorDataset:
    """In-memory images (N, C, H, W), float32 on the host (the training
    CLI's velocity maps, reference ``scripts/diffusion_train.py:22-61``)."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)

    def __len__(self):
        return len(self.data)

    def sample_batch(self, rng: np.random.RandomState, batch_size: int):
        idx = rng.randint(0, len(self.data), size=batch_size)
        return self.data[idx]


class ImageFolderDataset:
    """Images under a folder (the reference ``Dataset``,
    ``models/diffusion.py:556-573``): a recursive glob over the extensions,
    resized so the short side is ``image_size``, centre-cropped, optionally
    flipped left-right, values in [0, 1] as (C, H, W). Decoded per sampled
    batch with Pillow, imported only then."""

    def __init__(self, folder, image_size: int,
                 exts=('jpg', 'jpeg', 'png', 'tiff'),
                 augment_horizontal_flip: bool = False,
                 convert_image_to: Optional[str] = None):
        self.folder = Path(folder)
        self.image_size = int(image_size)
        self.augment_horizontal_flip = augment_horizontal_flip
        self.convert_image_to = convert_image_to
        self.paths = sorted(p for ext in exts
                            for p in self.folder.glob(f'**/*.{ext}'))
        if not self.paths:
            raise FileNotFoundError(
                f'no images with extensions {exts} under {self.folder}')

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError('ImageFolderDataset decodes images with '
                              'Pillow (the PIL package), which is not '
                              'installed') from e
        img = Image.open(path)
        if self.convert_image_to:
            img = img.convert(self.convert_image_to)
        s = self.image_size
        w, h = img.size
        scale = s / min(w, h)
        img = img.resize((max(s, round(w * scale)),
                          max(s, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        left, top = (w - s) // 2, (h - s) // 2
        img = img.crop((left, top, left + s, top + s))
        arr = np.asarray(img, np.float32) / 255.0
        return arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)

    def sample_batch(self, rng: np.random.RandomState, batch_size: int):
        idx = rng.randint(0, len(self.paths), size=batch_size)
        batch = np.stack([self._load(self.paths[i]) for i in idx])
        if self.augment_horizontal_flip:
            flip = rng.rand(batch_size) < 0.5
            batch[flip] = batch[flip, :, :, ::-1]
        return batch


def _canonical(dev) -> torch.device:
    """``dev`` with the current CUDA device's index where it has none."""
    dev = torch.device(dev)
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: g / norm * max_norm for
    every tensor when the global norm reaches ``max_norm``, else g as it
    is (g / 1 * 1). The choice is made on the card. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


class Adam:
    """optax's ``adam(lr, b1, b2)`` (eps 1e-8 after the square root, eps_root
    0) over a list of tensors. :meth:`update` returns the updates without
    applying them; the moments are kept in ``mu`` and ``nu``, the step count
    in ``count``."""

    EPS = 1e-8

    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def update(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g^2 + b2 * nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.EPS)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(updates, -self.lr)
        return updates


class Trainer:
    """Train a :class:`GaussianDiffusion` denoiser (reference
    ``models/diffusion.py:574``) on the diffusion model's device, with the
    JAX trainer's constructor arguments and asserts."""

    def __init__(self, diffusion_model, dataset, *, train_batch_size: int = 16,
                 gradient_accumulate_every: int = 1,
                 train_lr: float = 1e-4, train_num_steps: int = 100000,
                 ema_update_every: int = 10, ema_decay: float = 0.995,
                 adam_betas=(0.9, 0.99), save_and_sample_every: int = 10000,
                 num_samples: int = 25, results_folder: str = './results',
                 amp: bool = False, max_grad_norm: float = 1.0,
                 seed: int = 0, data_parallel: bool = True,
                 keep_last_checkpoints: int = 0,
                 calculate_fid: bool = False, num_fid_samples: int = 64,
                 device_data: bool = True,
                 device_data_max_bytes: int = 4 * 1024 ** 3, devices=None):
        assert train_batch_size * gradient_accumulate_every >= 16, \
            'effective batch size should be at least 16'
        assert int(num_samples ** 0.5) ** 2 == num_samples, \
            'number of samples must have an integer square root'
        self.diffusion = diffusion_model
        self.device = diffusion_model.device
        # The data-parallel devices: every card when there is more than one
        # (one card is the whole device set, as for the JAX trainer on one
        # device), or the list given.
        if devices is None and data_parallel and self.device.type == 'cuda' \
                and torch.cuda.device_count() > 1:
            devices = [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
        self.devices = (None if devices is None or len(devices) < 2
                        else [torch.device(d) for d in devices])
        self._replicas = {}
        self.dataset = dataset
        self.batch_size = train_batch_size
        self.grad_accum = gradient_accumulate_every
        self.train_num_steps = train_num_steps
        self.amp = amp
        self.save_and_sample_every = save_and_sample_every
        self.num_samples = num_samples
        self.max_grad_norm = max_grad_norm
        self.keep_last_checkpoints = keep_last_checkpoints
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.ema_cfg = EMAConfig(decay=ema_decay,
                                 update_every=ema_update_every)
        self.calculate_fid = calculate_fid
        self.num_fid_samples = num_fid_samples
        self.fid_scores = []
        self.step = 0
        self.training_losses = []
        # (step, loss on the card) of steps whose loss no one has read yet.
        self._pending = []
        self._np_rng = np.random.RandomState(seed)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        model = diffusion_model.model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        # The EMA denoiser: a copy of the U-Net behind a copy of the
        # diffusion model, which samples and exports from the EMA weights.
        self.ema_diffusion = copy.copy(diffusion_model)
        self.ema_diffusion.model = copy.deepcopy(model).requires_grad_(False)
        self.ema_params = list(self.ema_diffusion.model.parameters())
        self.optimizer = Adam(self.params, train_lr, b1=adam_betas[0],
                              b2=adam_betas[1])
        self._fid_weights = None

        # Device-resident data: a TensorDataset under the byte budget is
        # uploaded once (at the first train()) and gathered by index.
        self._data_dev = None
        # Only without a split, as in the JAX trainer: a copy per device would
        # multiply the dataset's claim on device memory.
        self._device_data = (device_data and isinstance(dataset, TensorDataset)
                             and self.devices is None
                             and dataset.data.nbytes <= device_data_max_bytes)

    # -- one step ---------------------------------------------------------

    def train_step(self, batches: List[torch.Tensor],
                   draws: Optional[List[dict]] = None) -> torch.Tensor:
        """One optimiser step on ``grad_accum`` micro-batches (on the
        diffusion model's device): the gradients summed over the
        micro-batches and divided by their number, clipped (left in each
        parameter's ``.grad``), Adam, then the EMA when (step + 1) is a
        multiple of ``update_every``. With ``amp`` the loss runs the U-Net
        on a differentiable bf16 cast of the fp32 master weights, so the
        gradients, Adam and the EMA stay fp32 (the JAX trainer's
        ``amp``). ``draws``, one dict per micro-batch with any of ``t``,
        ``noise`` and ``offset``, feeds the loss's draws (the rest come
        from the trainer's generator). With ``devices`` (:meth:`split_loss`)
        each micro-batch is split over them. Returns the mean micro-batch
        loss, on the card."""
        for p in self.params:
            p.grad = None
        loss_sum = None
        with fp32_convolutions():
            for i, mb in enumerate(batches):
                if self.devices is not None:
                    loss = self.split_loss(mb, self.devices,
                                           **(draws[i] if draws else {}))
                else:
                    params = ({n: p.to(torch.bfloat16)
                               for n, p in zip(self.names, self.params)}
                              if self.amp else None)
                    loss = self.diffusion.loss(mb, generator=self._gen,
                                               params=params,
                                               **(draws[i] if draws else {}))
                    loss.backward()
                    loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        # A parameter the loss does not reach (the frozen random Fourier
        # weights) gets a zero gradient, as under the JAX stop_gradient.
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.grad_accum > 1:
            torch._foreach_div_(grads, self.grad_accum)
        clip_by_global_norm(grads, self.max_grad_norm)
        with torch.no_grad():
            torch._foreach_add_(self.params, self.optimizer.update(grads))
            self.step += 1
            if self.step % self.ema_cfg.update_every == 0:
                self._update_ema(_ema_decay_at(self.step, self.ema_cfg))
        return loss_sum / self.grad_accum

    def _replica(self, dev):
        """The diffusion model with a copy of the U-Net and the schedule on
        ``dev`` (the diffusion model itself on its own device)."""
        if _canonical(dev) == _canonical(self.device):
            return self.diffusion
        if dev not in self._replicas:
            rep = copy.copy(self.diffusion)
            rep.device = dev
            rep.model = copy.deepcopy(self.diffusion.model).to(dev)
            s = self.diffusion.schedule
            rep.schedule = type(s)(**{f.name: getattr(s, f.name).to(dev)
                                      for f in fields(s)})
            self._replicas[dev] = rep
        return self._replicas[dev]

    def split_loss(self, mb, devices, t=None, noise=None, offset=None):
        """The loss of micro-batch ``mb`` split into equal parts over
        ``devices``; adds its gradient to each parameter's ``.grad``. The
        timesteps, noise and offset are drawn for the whole micro-batch as
        :meth:`GaussianDiffusion.loss` draws them (unless given) and
        sliced; each part's weighted loss (its mean times its share of
        the rows) is differentiated on its device with the master weights
        copied there, and the gradients are added on the diffusion model's
        device in device order. Returns the loss on that device."""
        b = mb.shape[0]
        n = len(devices)
        if b % n:
            raise ValueError(f'a batch of {b} does not split over {n} '
                             'devices')
        d, gen = self.diffusion, self._gen
        if t is None:
            t = torch.randint(0, d.num_timesteps, (b,), generator=gen,
                              device=self.device)
        if noise is None:
            noise = torch.randn(mb.shape, generator=gen, device=self.device,
                                dtype=mb.dtype)
        if offset is None and d.offset_noise_strength > 0.0:
            offset = torch.randn(mb.shape[:2], generator=gen,
                                 device=self.device, dtype=mb.dtype)
        k = b // n
        total, grads = None, None
        for i, dev in enumerate(devices):
            rows = slice(i * k, (i + 1) * k)
            leaves = [p.detach().to(dev).requires_grad_(True)
                      for p in self.params]
            params = {name: (v.to(torch.bfloat16) if self.amp else v)
                      for name, v in zip(self.names, leaves)}
            part = self._replica(dev).loss(
                mb[rows].to(dev), t=t[rows].to(dev),
                noise=noise[rows].to(dev),
                offset=None if offset is None else offset[rows].to(dev),
                params=params) * (k / b)
            g = torch.autograd.grad(part, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x.to(self.device)
                 for p, x in zip(self.params, g)]
            grads = g if grads is None else torch._foreach_add(grads, g)
            part = part.detach().to(self.device)
            total = part if total is None else total + part
        for p, g in zip(self.params, grads):
            p.grad = g if p.grad is None else p.grad + g
        return total

    def _update_ema(self, decay: float):
        """ema = ema * decay + params * (1 - decay); a copy while the decay
        is 0 (through update_after_step + 1)."""
        if decay == 0.0:
            torch._foreach_copy_(self.ema_params, self.params)
            return
        torch._foreach_mul_(self.ema_params, decay)
        torch._foreach_add_(self.ema_params,
                            torch._foreach_mul(self.params, 1.0 - decay))

    # -- data -------------------------------------------------------------

    def _next_batches(self) -> List[torch.Tensor]:
        """``grad_accum`` micro-batches on the device: gathered on the card
        from the resident dataset by indices drawn as
        :meth:`TensorDataset.sample_batch` draws them, or sampled on the
        host and copied."""
        if not self._device_data:
            return [torch.from_numpy(self.dataset.sample_batch(
                self._np_rng, self.batch_size)).to(self.device)
                for _ in range(self.grad_accum)]
        n = len(self.dataset)
        idx = np.stack([self._np_rng.randint(0, n, size=self.batch_size)
                        for _ in range(self.grad_accum)])
        idx = torch.from_numpy(idx)
        if self.device.type == 'cuda':
            # A pinned copy does not make the host wait for the card.
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return list(self._data_dev[idx])

    # -- checkpointing (reference models/diffusion.py:617-649) ------------

    def _tree(self, tensors) -> dict:
        return state_dict_to_flax(dict(zip(self.names, tensors)))

    def _untree(self, tree) -> List[torch.Tensor]:
        sd = flax_to_state_dict(tree, self.diffusion.model)
        return [sd[n].to(self.device) for n in self.names]

    def _flush_losses(self):
        """Read the pending losses from the card into training_losses."""
        if self._pending:
            values = torch.stack([v for _, v in self._pending]).tolist()
            self.training_losses.extend(
                {'step': s, 'loss': v}
                for (s, _), v in zip(self._pending, values))
            self._pending = []

    def save(self, milestone):
        self._flush_losses()
        opt = self.optimizer
        state = {
            'step': self.step,
            'params': self._tree(self.params),
            'ema_params': self._tree(self.ema_params),
            'opt_state': {'count': opt.count, 'mu': self._tree(opt.mu),
                          'nu': self._tree(opt.nu)},
            'version': '0.1.0',
        }
        atomic_write_bytes(self.results_folder / f'model-{milestone}.ckpt',
                           packb(state))
        # RNG sidecar: the batch-index stream and the noise generator must
        # survive a resume, or the run replays the constructor seed's
        # sequence.
        mt = self._np_rng.get_state()
        np.savez(self.results_folder / f'rng-{milestone}.npz',
                 mt_keys=mt[1], mt_pos=mt[2], mt_has_gauss=mt[3],
                 mt_cached=mt[4],
                 torch_gen=self._gen.get_state().numpy())
        with open(self.results_folder
                  / f'training_losses-{milestone}.json', 'w') as f:
            json.dump({'step': self.step, 'milestone': milestone,
                       'losses': self.training_losses,
                       'num_losses': len(self.training_losses)}, f, indent=2)
        if self.keep_last_checkpoints > 0:
            ckpts = sorted(self.results_folder.glob('model-*.ckpt'),
                           key=lambda p: int(p.stem.split('-')[1]))
            for old in ckpts[:-self.keep_last_checkpoints]:
                old.unlink()

    def load(self, milestone):
        state = load_params(self.results_folder / f'model-{milestone}.ckpt')
        self.step = int(state['step'])
        with torch.no_grad():
            for dst, key in ((self.params, 'params'),
                             (self.ema_params, 'ema_params')):
                torch._foreach_copy_(dst, self._untree(state[key]))
        opt = state['opt_state']
        self.optimizer.count = int(opt['count'])
        self.optimizer.mu = self._untree(opt['mu'])
        self.optimizer.nu = self._untree(opt['nu'])
        self._pending = []
        losses_file = self.results_folder / f'training_losses-{milestone}.json'
        if losses_file.exists():
            self.training_losses = json.loads(
                losses_file.read_text()).get('losses', [])
        # The FID history survives the resume, truncated to the entries at
        # or before the resumed step (a resumed earlier milestone must not
        # keep later entries that the run will append again).
        fid_file = self.results_folder / 'fid_scores.json'
        if fid_file.exists():
            try:
                scores = json.loads(fid_file.read_text())
                self.fid_scores = [e for e in scores
                                   if e.get('step', 0) <= self.step]
            except ValueError:
                pass
        rng_file = self.results_folder / f'rng-{milestone}.npz'
        if rng_file.exists():
            d = np.load(rng_file)
            self._np_rng.set_state(('MT19937', d['mt_keys'],
                                    int(d['mt_pos']), int(d['mt_has_gauss']),
                                    float(d['mt_cached'])))
            self._gen.set_state(torch.from_numpy(d['torch_gen']))
            print('restored RNG state (batch-index stream + noise generator)',
                  flush=True)
        else:
            print('warning: no RNG sidecar for this milestone; the resumed '
                  'run replays the constructor seed\'s batch and noise '
                  'sequence', flush=True)
        print(f"loading from version {state['version']}", flush=True)

    # -- loop -------------------------------------------------------------

    def train(self, log_every: int = 100, steps_per_call: int = 20):
        """Train to ``train_num_steps`` in calls of up to
        ``steps_per_call`` steps, as the JAX trainer dispatches them: no
        call crosses a milestone, a milestone is saved after the call that
        reaches it, and the loss line is printed after a call that crosses
        a multiple of ``log_every`` (``step % log_every < k`` for a call
        of k steps). Here a call is k train steps from the host; the
        losses stay on the card until a line or a milestone reads them."""
        t0 = time.time()
        step0 = self.step
        if self._device_data and self._data_dev is None:
            self._data_dev = torch.from_numpy(self.dataset.data).to(
                self.device)
            print(f'dataset resident on the device '
                  f'({self.dataset.data.nbytes / 1e9:.2f} GB)', flush=True)
        while self.step < self.train_num_steps:
            to_milestone = self.save_and_sample_every - (
                self.step % self.save_and_sample_every)
            k = min(max(1, int(steps_per_call)),
                    self.train_num_steps - self.step, to_milestone)
            for _ in range(k):
                step = self.step
                loss = self.train_step(self._next_batches())
                self._pending.append((step, loss))
            if self.step % log_every < k:
                self._flush_losses()
                rate = (self.step - step0) / (time.time() - t0)
                print(f'step {self.step}/{self.train_num_steps} loss '
                      f'{self.training_losses[-1]["loss"]:.4f} '
                      f'({rate:.1f} steps/s)', flush=True)
            if self.step % self.save_and_sample_every == 0:
                self._sample_and_save(self.step // self.save_and_sample_every)
        self._flush_losses()
        print('training complete')

    def _fid_features(self, images) -> np.ndarray:
        """(N, C, H, W) in [0, 1] -> (N, 128) frozen features."""
        if self._fid_weights is None:
            self._fid_weights = [
                torch.from_numpy(np.ascontiguousarray(
                    w.transpose(3, 2, 0, 1))).to(self.device)
                for w in frozen_feature_weights()]
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            feats = frozen_feature_apply(self._fid_weights, x * 2.0 - 1.0)
        return feats.cpu().numpy()

    def _fid_score(self, milestone) -> float:
        """Frechet distance between ``num_fid_samples`` EMA samples and as
        many training images in the frozen feature space; appended to
        ``fid_scores.json``."""
        n, gen, done = self.num_fid_samples, [], 0
        while done < n:
            k = min(self.batch_size, n - done)
            gen.append(self.ema_diffusion.sample(batch_size=k,
                                                 generator=self._gen))
            done += k
        f_gen = self._fid_features(torch.cat(gen))
        f_real = self._fid_features(
            self.dataset.sample_batch(self._np_rng, n))
        score = frechet_distance(f_gen, f_real)
        self.fid_scores.append({'step': self.step, 'milestone': milestone,
                                'fid_frozen': score})
        with open(self.results_folder / 'fid_scores.json', 'w') as f:
            json.dump(self.fid_scores, f, indent=2)
        return score

    def _sample_and_save(self, milestone):
        samples = self.ema_diffusion.sample(batch_size=self.num_samples,
                                            generator=self._gen)
        np.save(self.results_folder / f'sample-{milestone}.npy',
                samples.cpu().numpy())
        if self.calculate_fid:
            score = self._fid_score(milestone)
            print(f'milestone {milestone}: fid_frozen {score:.4f}',
                  flush=True)
        self.save(milestone)
