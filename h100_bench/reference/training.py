"""Plain reference of the prior's train step: the denoising loss of a
batch, its gradient, ``optax.clip_by_global_norm`` (scale by max_norm /
norm once the norm reaches max_norm), then ``optax.adam`` (lr, b1, b2, eps
1e-8 after the root, bias corrections in float32), then the EMA of
``ema-pytorch`` as the trainer configures it: every ``update_every``-th
step, the EMA becomes decay * EMA + (1 - decay) * params with the warm-up
decay 1 - (1 + t)^(-2/3), t = step - ``update_after_step`` - 1, clamped to
[0, ``decay``], and a copy of the params while that decay is 0 (t <= 0).
"""
import numpy as np
import torch

from h100_bench.reference import diffusion

UPDATE_EVERY, UPDATE_AFTER_STEP = 10, 100


class TrainState:
    def __init__(self, unet, lr, b1=0.9, b2=0.99, max_norm=1.0,
                 ema_decay=0.995, update_every=UPDATE_EVERY,
                 update_after_step=UPDATE_AFTER_STEP):
        self.unet, self.lr, self.b1, self.b2 = unet, lr, b1, b2
        self.max_norm = max_norm
        self.names = [n for n, _ in unet.named_parameters()]
        self.params = [p for _, p in unet.named_parameters()]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.ema_decay, self.update_every = ema_decay, update_every
        self.update_after_step = update_after_step
        self.count = 0


def warmup_decay(step: int, decay: float,
                 update_after_step: int = UPDATE_AFTER_STEP) -> float:
    """The EMA's decay at ``step`` (float32, as the trainer's reference)."""
    f32 = np.float32
    t = step - update_after_step - 1
    if t <= 0:
        return 0.0
    value = f32(1) - (f32(1) + f32(t)) ** f32(-2.0 / 3.0)
    return float(min(max(value, f32(0)), f32(decay)))


def ema_decay(st: TrainState, step: int) -> float:
    return warmup_decay(step, st.ema_decay, st.update_after_step)


def step(st: TrainState, sched, img01, t, noise):
    """One train step; returns the loss."""
    for p in st.params:
        p.grad = None
    loss = diffusion.denoising_loss(st.unet, sched, img01, t, noise)
    grads = torch.autograd.grad(loss, st.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(st.params, grads)]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if norm >= st.max_norm:
        grads = [g / norm * st.max_norm for g in grads]
    st.count += 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(st.b1) ** f32(st.count))
    bc2 = float(f32(1) - f32(st.b2) ** f32(st.count))
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(st.params, grads)):
            st.m[i] = st.b1 * st.m[i] + (1 - st.b1) * g
            st.v[i] = st.b2 * st.v[i] + (1 - st.b2) * (g * g)
            p += (st.m[i] / bc1) / (torch.sqrt(st.v[i] / bc2) + 1e-8) * -st.lr
        if st.count % st.update_every == 0:
            d = ema_decay(st, st.count)
            st.ema = [p.detach().clone() if d == 0.0 else d * e + (1 - d) * p
                      for e, p in zip(st.ema, st.params)]
    return loss.detach()
