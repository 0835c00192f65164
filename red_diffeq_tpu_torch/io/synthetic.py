"""Synthetic OpenFWI-style velocity model generator.

The reference trains its diffusion prior on the OpenFWI 'b' velocity
families (CurveVel_b, FlatVel_b, CurveFault_b, FlatFault_b — reference
scripts/diffusion_train.py:22-56), which do not ship with the repo. This
module synthesizes models with the same morphology so the full
pretrain -> invert pipeline runs self-contained:

* FlatVel   — horizontal layers, velocity increasing with depth;
* CurveVel  — layers with smooth sinusoidal interface undulation;
* FlatFault / CurveFault — the same plus a dipping fault with vertical
  displacement across the fault plane.

Velocities span [1500, 4500] m/s like OpenFWI; output shape (N, 1, H, W).
A copy of ``red_diffeq_tpu/io/synthetic.py``: the same seed gives the
same models in both packages.
"""
import numpy as np

V_MIN, V_MAX = 1500.0, 4500.0


def _layer_velocities(rng, n_layers):
    """Increasing-with-depth velocities with random spacing."""
    fractions = np.sort(rng.uniform(0.05, 0.95, size=n_layers))
    jitter = rng.uniform(-0.05, 0.05, size=n_layers)
    v = V_MIN + (V_MAX - V_MIN) * np.clip(fractions + jitter, 0.02, 1.0)
    return np.sort(v)


def _interfaces(rng, n_layers, h, w, curved):
    """Depth of each interface per column, shape (n_layers-1, W)."""
    base = np.sort(rng.uniform(0.1, 0.9, size=n_layers - 1)) * h
    cols = np.arange(w)
    rows = []
    for b in base:
        if curved:
            amp = rng.uniform(0.02, 0.12) * h
            period = rng.uniform(0.5, 2.0)
            phase = rng.uniform(0, 2 * np.pi)
            curve = amp * np.sin(2 * np.pi * period * cols / w + phase)
        else:
            curve = np.zeros(w)
        rows.append(np.clip(b + curve, 1, h - 1))
    return np.asarray(rows)


def _apply_fault(rng, depth_map, h, w):
    """Shift interface depths across a random dipping fault plane."""
    x0 = rng.uniform(0.25, 0.75) * w
    dip = np.tan(np.deg2rad(rng.uniform(30, 75)))
    sign = rng.choice([-1.0, 1.0])
    throw = rng.uniform(0.05, 0.18) * h
    cols = np.arange(w)
    for i in range(depth_map.shape[0]):
        fault_x = x0 + sign * depth_map[i] / dip      # (W,)
        shift = np.where(cols > fault_x, throw, 0.0)
        depth_map[i] = np.clip(depth_map[i] + shift, 1, h - 1)
    return depth_map


def generate_velocity_models(n: int, h: int = 70, w: int = 70,
                             family: str = 'CurveVel',
                             seed: int = 0) -> np.ndarray:
    """Generate (n, 1, h, w) float32 velocity models in m/s."""
    if family not in ('FlatVel', 'CurveVel', 'FlatFault', 'CurveFault'):
        raise ValueError(f'unknown family {family!r}')
    curved = family.startswith('Curve')
    faulted = family.endswith('Fault')
    rng = np.random.RandomState(seed)
    out = np.empty((n, 1, h, w), np.float32)
    rows_idx = np.arange(h)[:, None]
    for i in range(n):
        n_layers = rng.randint(3, 7)
        vels = _layer_velocities(rng, n_layers)
        depths = _interfaces(rng, n_layers, h, w, curved)
        if faulted:
            depths = _apply_fault(rng, depths, h, w)
        model = np.full((h, w), vels[0], np.float32)
        for li in range(n_layers - 1):
            model = np.where(rows_idx >= depths[li][None, :],
                             vels[li + 1], model)
        out[i, 0] = model
    return out


def generate_mixed_dataset(n: int, h: int = 70, w: int = 70,
                           seed: int = 0) -> np.ndarray:
    """Even mix of the four families (the reference's pretraining mix)."""
    fams = ('FlatVel', 'CurveVel', 'FlatFault', 'CurveFault')
    per = n // len(fams)
    parts = [generate_velocity_models(per, h, w, f, seed + i)
             for i, f in enumerate(fams)]
    rest = n - per * len(fams)
    if rest:
        parts.append(generate_velocity_models(rest, h, w, fams[0],
                                              seed + 100))
    data = np.concatenate(parts)
    rng = np.random.RandomState(seed + 999)
    return data[rng.permutation(len(data))]
