"""What the benchmark makes from ``--seed``: sub-seeds, synthetic velocity
models, the U-Net's weights and the invert cells' jobs.

The velocity models copy the program's ``io/synthetic.py`` (the OpenFWI
'b' families' morphology: flat or curved layers increasing with depth,
with or without a dipping fault, 1500-4500 m/s), so a later change to the
program cannot move the benchmark's inputs.
"""
import numpy as np
import torch

from h100_bench.reference import solver

V_MIN, V_MAX = 1500.0, 4500.0
FAMILIES = ('FlatVel', 'CurveVel', 'FlatFault', 'CurveFault')


def subseed(seed: int, *tags) -> int:
    """A seed in [0, 2**31) drawn from ``seed`` (any size) and ``tags``."""
    words = [int(seed) % (1 << 64)] + [sum(ord(c) << (8 * (i % 4))
                                          for i, c in enumerate(str(t)))
                                      for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


def velocity_models(n: int, h: int, w: int, family: str,
                    seed: int) -> np.ndarray:
    """(n, 1, h, w) float32 models in m/s of one family."""
    curved, faulted = family.startswith('Curve'), family.endswith('Fault')
    rng = np.random.RandomState(seed)
    out = np.empty((n, 1, h, w), np.float32)
    rows, cols = np.arange(h)[:, None], np.arange(w)
    for i in range(n):
        n_layers = rng.randint(3, 7)
        frac = np.sort(rng.uniform(0.05, 0.95, size=n_layers))
        jitter = rng.uniform(-0.05, 0.05, size=n_layers)
        vels = np.sort(V_MIN + (V_MAX - V_MIN)
                       * np.clip(frac + jitter, 0.02, 1.0))
        depths = []
        for b in np.sort(rng.uniform(0.1, 0.9, size=n_layers - 1)) * h:
            curve = np.zeros(w)
            if curved:
                amp = rng.uniform(0.02, 0.12) * h
                period = rng.uniform(0.5, 2.0)
                phase = rng.uniform(0, 2 * np.pi)
                curve = amp * np.sin(2 * np.pi * period * cols / w + phase)
            depths.append(np.clip(b + curve, 1, h - 1))
        depths = np.asarray(depths)
        if faulted:
            x0 = rng.uniform(0.25, 0.75) * w
            dip = np.tan(np.deg2rad(rng.uniform(30, 75)))
            sign = rng.choice([-1.0, 1.0])
            throw = rng.uniform(0.05, 0.18) * h
            for j in range(len(depths)):
                shift = np.where(cols > x0 + sign * depths[j] / dip, throw, 0)
                depths[j] = np.clip(depths[j] + shift, 1, h - 1)
        model = np.full((h, w), vels[0], np.float32)
        for j in range(n_layers - 1):
            model = np.where(rows >= depths[j][None, :], vels[j + 1], model)
        out[i, 0] = model
    return out


def mixed_models(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """``n`` models, the four families in turn, in a shuffled order."""
    per = -(-n // len(FAMILIES))
    parts = [velocity_models(per, h, w, f, subseed(seed, f))
             for f in FAMILIES]
    data = np.concatenate(parts)[:n]
    return data[np.random.RandomState(subseed(seed, 'order'))
                .permutation(n)]


def unet_weights(model: dict, seed: int, device) -> dict:
    """A state dict for the U-Net of the configuration's ``model`` section
    drawn on ``device`` in one call: weights of two or more axes normal
    with variance 1 / fan-in, attention memory slots standard normal,
    biases 0, norm gains 1. The names and shapes are the reference
    U-Net's, which are the program's."""
    from h100_bench.reference.unet import Unet
    with torch.device('meta'):
        net = Unet(dim=model['dim'], dim_mults=tuple(model['dim_mults']))
    shapes = {n: tuple(p.shape) for n, p in net.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 'unet'))
    drawn = [n for n, s in shapes.items() if len(s) >= 2]
    sizes = [int(np.prod(shapes[n])) for n in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for n, k in zip(drawn, sizes):
        s = shapes[n]
        scale = 1.0 if n.endswith('mem_kv') else (k // s[0]) ** -0.5
        out[n] = flat[at:at + k].reshape(s) * scale
        at += k
    for n, s in shapes.items():
        if n not in out:
            fill = 0.0 if n.endswith('bias') else 1.0
            out[n] = torch.full(s, fill, device=device)
    return out


def invert_jobs(ctx: dict, batch: int, pool: int, rows: int, seed: int,
                device):
    """``pool`` batches of ``batch`` models of ``rows`` x ``ctx['n_grid']``
    and their observations from the refined grid (one propagation of all
    of them): [(vel (B, 1, H, W) m/s, seis (B, ns, nt, ng))], float32."""
    vel = mixed_models(pool * batch, rows, int(ctx['n_grid']),
                       subseed(seed, 'vel'))
    seis = solver.refined_observations(vel, ctx, device)
    return [(vel[j * batch:(j + 1) * batch],
             np.ascontiguousarray(seis[j * batch:(j + 1) * batch]))
            for j in range(pool)]
