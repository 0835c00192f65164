"""Differentiable 2D acoustic wave forward modelling in PyTorch.

Counterpart of ``red_diffeq_tpu/solvers/acoustic.py:35-331``:
4th-order-space / 2nd-order-time finite differences with a quadratic sponge
absorbing boundary, Ricker source, all shots of a sample stepped together,
receivers sampled every step. The time loop runs over fixed-size chunks:

* ``backend='kernel'``: one ``ops.stencil.StencilChunk`` per chunk, whose
  forward and adjoint are the CUDA kernels (their plain versions for CPU
  tensors). The adjoint is the tape-free 'reverse' one unless the t2 guard
  routes to 'tape' (a narrow or strong sponge) or ``adjoint`` asks for one;
  the plain backend ignores ``adjoint``;
* ``backend='plain'``: plain PyTorch steps, the counterpart of
  ``_xla_chunk``, under ``torch.utils.checkpoint`` per chunk as the JAX
  path uses ``jax.checkpoint``;
* ``backend='auto'``: the kernels for a CUDA device, the plain path for
  the CPU.

Wavefield layout: (batch, ns, Hp, Wp).
"""
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from red_diffeq_tpu_torch.ops.stencil import laplacian4, stencil_chunk_fn
from red_diffeq_tpu_torch.utils.device import check_on, resolve_device

# 4th-order spatial stencil coefficients.
C1, C2, C3 = -2.5, 4.0 / 3.0, -1.0 / 12.0

# Chunks stepped by the plain path (the counterpart of ``_xla_chunk``).
plain_chunk_calls = {'chunk': 0}


def ricker(f: float, dt: float, nt: int) -> np.ndarray:
    """Ricker wavelet on the FD time grid: the first
    ``nw = 2*floor(1.1/(f*dt))+1`` samples, zero after."""
    nw = 2.2 / f / dt
    nw = 2 * math.floor(nw / 2) + 1
    nc = math.floor(nw / 2)
    k = np.arange(nw)
    beta = ((nc - k) * f * dt * np.pi) ** 2
    w0 = (1 - 2 * beta) * np.exp(-beta)
    w = np.zeros(nt, dtype=np.float64)
    n = min(len(w0), nt)
    w[:n] = w0[:n]
    return w.astype(np.float32)


def sponge_profile(v_pad: torch.Tensor, nbc: int, dx: float) -> torch.Tensor:
    """Quadratic sponge damping field (B, 1, Hp, Wp) for ``v_pad`` in m/s:
    zero in the interior; the left/right column profile overwrites the
    top/bottom row profile in the corners. ``amin`` splits the gradient
    evenly over tied minima, as JAX's ``min`` does."""
    b, _, hp, wp = v_pad.shape
    vmin = v_pad.reshape(b, -1).amin(dim=-1)                     # (B,)
    a = (nbc - 1) * dx
    kappa = 3.0 * vmin * math.log(1.0e7) / (2.0 * a)             # (B,)
    ramp = (torch.arange(nbc, dtype=v_pad.dtype, device=v_pad.device)
            * dx / a) ** 2                                       # (nbc,)
    d1 = kappa[:, None] * ramp[None, :]                          # (B, nbc)

    def edges(n):
        mid = d1.new_zeros(b, n - 2 * nbc)
        return torch.cat([d1.flip(-1), mid, d1], dim=-1)

    vert, horiz = edges(hp), edges(wp)
    col = torch.arange(wp, device=v_pad.device)
    in_side = (col < nbc) | (col >= wp - nbc)                    # (Wp,)
    damp = torch.where(in_side[None, None, :], horiz[:, None, :],
                       vert[:, :, None])
    return damp[:, None, :, :]


@dataclass(frozen=True)
class Geometry:
    """Static acquisition geometry; indices into the padded grid."""
    nbc: int
    dx: float
    nt: int
    dt: float
    f: float
    isx: Tuple[int, ...]   # per-shot source column
    isz: int               # source row
    igx: Tuple[int, ...]   # receiver columns
    igz: int               # receiver row
    sample_temporal: int = 1
    # Wavelet multiplier: a refined grid scales the source by factor^2 to
    # represent the same physical point source (see refined_ctx).
    src_scale: float = 1.0

    @property
    def ns(self) -> int:
        return len(self.isx)

    @property
    def ng(self) -> int:
        return len(self.igx)

    @property
    def receivers_contiguous(self) -> bool:
        return bool(np.all(np.diff(np.asarray(self.igx)) == 1))

    @staticmethod
    def from_ctx(ctx: dict, sample_temporal: int = 1) -> 'Geometry':
        """Build from a pde config dict (optional sx/gx overrides in grid
        units)."""
        n_grid, dx, nbc = ctx['n_grid'], float(ctx['dx']), int(ctx['nbc'])
        if ctx.get('sx') is not None:
            sx = np.asarray(ctx['sx'], dtype=np.float64) * dx
        else:
            sx = np.linspace(0, n_grid - 1, num=int(ctx['ns'])) * dx
        if ctx.get('gx') is not None:
            gx = np.asarray(ctx['gx'], dtype=np.float64) * dx
        else:
            gx = np.linspace(0, n_grid - 1, num=int(ctx['ng'])) * dx
        isx = np.around(sx / dx).astype(int) + nbc
        igx = np.around(gx / dx).astype(int) + nbc
        isz = int(np.around(float(ctx['sz']) / dx)) + nbc
        igz = int(np.around(float(ctx['gz']) / dx)) + nbc
        return Geometry(
            nbc=nbc, dx=dx, nt=int(ctx['nt']), dt=float(ctx['dt']),
            f=float(ctx['f']), isx=tuple(int(i) for i in isx), isz=isz,
            igx=tuple(int(i) for i in igx), igz=igz,
            sample_temporal=sample_temporal,
            src_scale=float(ctx.get('src_scale', 1.0)),
        )


def upsample_velocity(v, factor: int = 2) -> np.ndarray:
    """Nearest-neighbour refinement of a velocity model (numpy)."""
    return np.repeat(np.repeat(np.asarray(v), factor, axis=-2),
                     factor, axis=-1)


def refined_ctx(ctx: dict, factor: int = 2) -> dict:
    """Observation-generation config on a ``factor``-refined space/time
    grid (dx/factor, dt/factor, nt*factor, nbc*factor) with sources and
    receivers at the same physical coordinates as the coarse grid. Pair
    with ``FWIForward(refined_ctx(ctx), sample_temporal=factor)`` and
    :func:`upsample_velocity`."""
    n = int(ctx['n_grid'])
    fine = dict(ctx)
    fine['n_grid'] = n * factor
    fine['dx'] = float(ctx['dx']) / factor
    fine['dt'] = float(ctx['dt']) / factor
    fine['nt'] = int(ctx['nt']) * factor
    fine['nbc'] = int(ctx['nbc']) * factor
    sx_m = np.linspace(0, n - 1, num=int(ctx['ns'])) * float(ctx['dx'])
    gx_m = np.linspace(0, n - 1, num=int(ctx['ng'])) * float(ctx['dx'])
    fine['sx'] = sx_m / fine['dx']
    fine['gx'] = gx_m / fine['dx']
    # Injection has no 1/dx^2 delta-density factor, so the finer cell
    # needs factor^2 compensation to keep the physical source strength.
    fine['src_scale'] = float(ctx.get('src_scale', 1.0)) * factor ** 2
    return fine


def coefficients(v_pad: torch.Tensor, geom: Geometry):
    """FD coefficient fields for ``v_pad`` (B, 1, Hp, Wp) in m/s:
    (alpha, temp1, temp2, beta_pts (B, ns))."""
    dt, dx = geom.dt, geom.dx
    alpha = (v_pad * (dt / dx)) ** 2
    kappa = sponge_profile(v_pad, geom.nbc, dx) * dt
    temp1 = 2.0 + 2.0 * C1 * alpha - kappa
    temp2 = 1.0 - kappa
    beta = (v_pad * dt) ** 2
    beta_pts = beta[:, 0, geom.isz, :][:, list(geom.isx)]
    return alpha, temp1, temp2, beta_pts


def source_chunks(geom: Geometry, chunk: int, device) -> torch.Tensor:
    """The scaled wavelet, zero-padded to whole chunks: (n_chunks, chunk)."""
    src = ricker(geom.f, geom.dt, geom.nt) * geom.src_scale
    n_chunks = -(-geom.nt // chunk)
    src = np.pad(src, (0, n_chunks * chunk - geom.nt))
    return torch.from_numpy(src.astype(np.float32)).to(device).reshape(
        n_chunks, chunk)


def _plain_chunk(p0, p1, src_chunk, alpha, temp1, temp2, beta_pts, *,
                 src_idx, igz, igx):
    """``chunk`` plain FD steps recording every step; counterpart of
    ``_xla_chunk`` (``red_diffeq_tpu/solvers/acoustic.py:194-224``).
    ``src_idx`` indexes each (sample, shot)'s source cell. Returns
    (p0', p1', recs (B, ns, chunk, ng))."""
    plain_chunk_calls['chunk'] += 1
    recs = []
    for k in range(src_chunk.shape[0]):
        p = temp1 * p1 - temp2 * p0 + alpha * laplacian4(p1)
        p = p.index_put(src_idx, p[src_idx] + beta_pts * src_chunk[k])
        recs.append(p[:, :, igz, :][:, :, igx])
        p0, p1 = p1, p
    return p0, p1, torch.stack(recs, dim=2)


def forward_modeling(v_pad: torch.Tensor, geom: Geometry, *, chunk: int = 20,
                     backend: str = 'plain',
                     adjoint: Optional[str] = None) -> torch.Tensor:
    """Propagate all shots through ``v_pad`` (B, 1, Hp, Wp) in m/s.

    Returns the seismogram (B, ns, ceil(nt / sample_temporal), ng).
    ``backend`` is ``'kernel'`` or ``'plain'``; ``adjoint`` picks the
    kernel backend's adjoint, ``'reverse'`` or ``'tape'`` (``None``:
    'reverse' unless the t2 guard routes to 'tape'); the plain backend
    ignores it."""
    b, _, hp, wp = v_pad.shape
    alpha, temp1, temp2, beta_pts = coefficients(v_pad, geom)
    src_chunks = source_chunks(geom, chunk, v_pad.device)

    if backend == 'kernel':
        chunk_fn = stencil_chunk_fn(alpha=alpha, temp1=temp1, temp2=temp2,
                                    beta_pts=beta_pts, geom=geom,
                                    chunk=chunk, mode=adjoint)
    elif backend == 'plain':
        dev = v_pad.device
        src_idx = (torch.arange(b, device=dev)[:, None],
                   torch.arange(geom.ns, device=dev)[None, :],
                   torch.full((1, 1), geom.isz, device=dev),
                   torch.tensor(geom.isx, device=dev)[None, :])
        igx = torch.tensor(geom.igx, device=dev)

        def chunk_fn(carry, src_chunk):
            args = (*carry, src_chunk, alpha, temp1, temp2, beta_pts)
            kw = dict(src_idx=src_idx, igz=geom.igz, igx=igx)
            if torch.is_grad_enabled() and v_pad.requires_grad:
                p0o, p1o, recs = checkpoint(_plain_chunk, *args,
                                            use_reentrant=False, **kw)
            else:
                p0o, p1o, recs = _plain_chunk(*args, **kw)
            return (p0o, p1o), recs
    else:
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected 'kernel' or 'plain')")

    shape = (b, geom.ns, hp, wp)
    carry = (v_pad.new_zeros(shape), v_pad.new_zeros(shape))
    recs = []
    for src_chunk in src_chunks:
        carry, r = chunk_fn(carry, src_chunk)
        recs.append(r)
    seis = torch.cat(recs, dim=2)                       # (B, ns, steps, ng)
    return seis[:, :, :geom.nt:geom.sample_temporal]


class FWIForward:
    """Forward operator: normalised velocity -> seismogram.

    ``__call__(v_norm)`` maps the input to m/s with ``v_denorm_func`` (none:
    the input is in m/s), edge-pads by nbc, propagates, and applies
    ``s_norm_func`` to the seismogram. Runs on ``device`` (default
    ``'cuda'``; without a card it raises unless ``device='cpu'``)."""

    def __init__(self, ctx: dict, sample_temporal: int = 1,
                 v_denorm_func: Optional[Callable] = None,
                 s_norm_func: Optional[Callable] = None,
                 backend: str = 'auto', chunk: int = 20,
                 adjoint: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.geom = Geometry.from_ctx(dict(ctx), sample_temporal)
        self.v_denorm_func = v_denorm_func
        self.s_norm_func = s_norm_func
        if backend == 'auto':
            backend = 'kernel' if self.device.type == 'cuda' else 'plain'
        self.backend = backend
        self.chunk = chunk
        self.adjoint = adjoint

    def __call__(self, v_norm: torch.Tensor) -> torch.Tensor:
        check_on(v_norm, self.device, 'v_norm')
        v = self.v_denorm_func(v_norm) if self.v_denorm_func else v_norm
        nbc = self.geom.nbc
        v_pad = F.pad(v, (nbc, nbc, nbc, nbc), mode='replicate')
        s = forward_modeling(v_pad, self.geom, chunk=self.chunk,
                             backend=self.backend, adjoint=self.adjoint)
        if self.s_norm_func is not None:
            s = self.s_norm_func(s)
        return s
