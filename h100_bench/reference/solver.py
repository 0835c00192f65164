"""Plain reference of the acoustic solver, its adjoint by autograd.

A frozen copy of the FD scheme that the measured program implements: 4th
order in space with circular rolls, 2nd order in time, a quadratic sponge
of ``nbc`` cells, a Ricker source added on the source row after each
step, receivers read after the injection. The velocity model enters in
[-1, 1] and is mapped to m/s, edge-padded by ``nbc`` and propagated; the
seismogram is (B, ns, ceil(nt / sample_temporal), ng). Each chunk of steps
is recomputed in the backward (``torch.utils.checkpoint``), so a gradient
at 310x430 holds a chunk's fields at a time. Every product goes through
an :class:`~h100_bench.reference.arith.Arith`.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.arith import Arith

C1, C2, C3 = -2.5, 4.0 / 3.0, -1.0 / 12.0
V_MIN, V_RANGE = 1500.0, 3000.0
CHUNK = 20


def v_denormalize(v):
    return (v + 1.0) / 2.0 * V_RANGE + V_MIN


def v_normalize(v):
    return (v - V_MIN) / V_RANGE * 2.0 - 1.0


def geometry(ctx: dict, sample_temporal: int = 1) -> dict:
    """Grid indices of sources and receivers on the padded grid."""
    n, dx, nbc = int(ctx['n_grid']), float(ctx['dx']), int(ctx['nbc'])
    sx = (np.asarray(ctx['sx'], np.float64) * dx if ctx.get('sx') is not None
          else np.linspace(0, n - 1, num=int(ctx['ns'])) * dx)
    gx = (np.asarray(ctx['gx'], np.float64) * dx if ctx.get('gx') is not None
          else np.linspace(0, n - 1, num=int(ctx['ng'])) * dx)
    return dict(
        nbc=nbc, dx=dx, nt=int(ctx['nt']), dt=float(ctx['dt']),
        f=float(ctx['f']), isx=[int(i) + nbc for i in np.around(sx / dx)],
        igx=[int(i) + nbc for i in np.around(gx / dx)],
        isz=int(np.around(float(ctx['sz']) / dx)) + nbc,
        igz=int(np.around(float(ctx['gz']) / dx)) + nbc,
        st=sample_temporal, src_scale=float(ctx.get('src_scale', 1.0)))


def refined_ctx(ctx: dict, factor: int = 2) -> dict:
    """The same acquisition on a grid ``factor`` times finer in space and
    time, the source scaled by factor^2 (no 1/dx^2 in the injection)."""
    n = int(ctx['n_grid'])
    fine = dict(ctx, n_grid=n * factor, dx=float(ctx['dx']) / factor,
                dt=float(ctx['dt']) / factor, nt=int(ctx['nt']) * factor,
                nbc=int(ctx['nbc']) * factor)
    fine['sx'] = (np.linspace(0, n - 1, num=int(ctx['ns']))
                  * float(ctx['dx']) / fine['dx'])
    fine['gx'] = (np.linspace(0, n - 1, num=int(ctx['ng']))
                  * float(ctx['dx']) / fine['dx'])
    fine['src_scale'] = float(ctx.get('src_scale', 1.0)) * factor ** 2
    return fine


def ricker(f: float, dt: float, nt: int) -> np.ndarray:
    nw = 2 * math.floor(2.2 / f / dt / 2) + 1
    k = np.arange(nw)
    beta = ((math.floor(nw / 2) - k) * f * dt * np.pi) ** 2
    w = np.zeros(nt)
    m = min(nw, nt)
    w[:m] = ((1 - 2 * beta) * np.exp(-beta))[:m]
    return w.astype(np.float32)


def sponge(v_pad, nbc: int, dx: float):
    """(B, 1, Hp, Wp) damping: the column profile over the row profile."""
    b, _, hp, wp = v_pad.shape
    a = (nbc - 1) * dx
    kappa = 3.0 * v_pad.reshape(b, -1).amin(dim=1) * math.log(1.0e7) / (2 * a)
    ramp = (torch.arange(nbc, dtype=v_pad.dtype, device=v_pad.device)
            * dx / a) ** 2
    d1 = kappa[:, None] * ramp[None, :]

    def edges(n):
        return torch.cat([d1.flip(-1), d1.new_zeros(b, n - 2 * nbc), d1], -1)

    col = torch.arange(wp, device=v_pad.device)
    side = (col < nbc) | (col >= wp - nbc)
    damp = torch.where(side[None, None, :], edges(wp)[:, None, :],
                       edges(hp)[:, :, None])
    return damp[:, None]


def laplacian(p, ar: Arith):
    return (ar.mul(C2, torch.roll(p, 1, -2) + torch.roll(p, -1, -2)
                   + torch.roll(p, 1, -1) + torch.roll(p, -1, -1))
            + ar.mul(C3, torch.roll(p, 2, -2) + torch.roll(p, -2, -2)
                     + torch.roll(p, 2, -1) + torch.roll(p, -2, -1)))


def _chunk(p0, p1, src, alpha, t1, t2, beta, g, ar):
    recs = []
    for k in range(src.shape[0]):
        p = ar.mul(t1, p1) - ar.mul(t2, p0) + ar.mul(alpha, laplacian(p1, ar))
        p = p.index_put(g['src_idx'],
                        p[g['src_idx']] + ar.mul(beta, src[k]))
        recs.append(p[:, :, g['igz'], :][:, :, g['igx']])
        p0, p1 = p1, p
    return p0, p1, torch.stack(recs, dim=2)


def forward(v_norm: torch.Tensor, ctx: dict, ar: Arith,
            sample_temporal: int = 1) -> torch.Tensor:
    """Seismogram of the normalised model ``v_norm`` (B, 1, H, W)."""
    g = geometry(ctx, sample_temporal)
    nbc, dt, dx, nt = g['nbc'], g['dt'], g['dx'], g['nt']
    v_pad = F.pad(v_denormalize(v_norm), (nbc,) * 4, mode='replicate')
    alpha = (v_pad * (dt / dx)) ** 2
    kappa = sponge(v_pad, nbc, dx) * dt
    t1 = 2.0 + 2.0 * C1 * alpha - kappa
    t2 = 1.0 - kappa
    beta = ((v_pad * dt) ** 2)[:, 0, g['isz'], :][:, g['isx']]
    n_chunks = -(-nt // CHUNK)
    src = np.pad(ricker(g['f'], dt, nt) * g['src_scale'],
                 (0, n_chunks * CHUNK - nt))
    src = torch.from_numpy(src.astype(np.float32)).to(v_norm.device)
    b, _, hp, wp = v_pad.shape
    dev = v_norm.device
    g['src_idx'] = (torch.arange(b, device=dev)[:, None],
                    torch.arange(len(g['isx']), device=dev)[None, :],
                    torch.full((1, 1), g['isz'], device=dev),
                    torch.tensor(g['isx'], device=dev)[None, :])
    g['igx'] = torch.tensor(g['igx'], device=dev)
    p0 = v_pad.new_zeros(b, len(g['isx']), hp, wp)
    p1 = torch.zeros_like(p0)
    recs = []
    for c in range(n_chunks):
        args = (p0, p1, src[c * CHUNK:(c + 1) * CHUNK], alpha, t1, t2, beta,
                g, ar)
        if torch.is_grad_enabled() and v_norm.requires_grad:
            p0, p1, r = checkpoint(_chunk, *args, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            p0, p1, r = _chunk(*args)
        recs.append(r)
    return torch.cat(recs, dim=2)[:, :, :nt:sample_temporal]


def refined_observations(v_true_ms: np.ndarray, ctx: dict,
                         device) -> np.ndarray:
    """Observations of models in m/s from the grid refined twice in space
    and time, sampled every second step: data that the inversion's own
    grid cannot reproduce exactly."""
    v = np.repeat(np.repeat(v_true_ms, 2, axis=-2), 2, axis=-1)
    with torch.no_grad():
        y = forward(v_normalize(torch.from_numpy(v).to(device)),
                    refined_ctx(ctx), Arith(), sample_temporal=2)
    return y.cpu().numpy()
