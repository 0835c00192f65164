"""Hand-written CUDA kernels for the acoustic FD time stepper.

Counterpart of ``red_diffeq_tpu/ops/stencil.py``. All four kernels of the
JAX package are ported, in ``csrc/stencil.cu``:

* ``_fwd_kernel`` (launcher ``_run_fwd``, ``stencil.py:150-231, 510``)
  becomes ``fwd_step``: one FD step of every (sample, shot) wavefield,
  with the source injection and the receiver row recorded.
* ``_bwd_reverse_kernel`` (launcher ``_run_bwd_reverse``,
  ``stencil.py:352-443, 632``) becomes ``bwd_reverse_step``: one step of
  the tape-free adjoint, rebuilding s_{m-2} from s_m and s_{m-1} while the
  cotangent sweeps backward.
* ``_tape_kernel`` (launcher ``_run_tape``, ``stencil.py:233-268, 550``)
  becomes ``tape_step``: one step of the chunk's replay, writing s_m to its
  slot of a flat tape of ``chunk + 2`` states (slot i = s_{i-1}; slots 0
  and 1 are the chunk-start carry), with no receiver rows.
* ``_bwd_kernel`` (launcher ``_run_bwd``, ``stencil.py:271-349, 582``)
  becomes ``bwd_tape_step``: one step of the taped adjoint, reading s_{m-1}
  and s_{m-2} from the tape instead of rebuilding them.

The taped pair is the JAX package's route when the t2 guard trips (a
narrow or strong sponge: at dx=10, dt=1e-3 any nbc <= 55), or when the
caller asks for ``adjoint='tape'``. As in the JAX custom VJP, the tape
lives only during one chunk's backward.

Each kernel is one launch per time step; a chunk of ``chunk`` steps is
``chunk`` launches, issued by one call into the shared library. The TPU
kernels keep a whole (sample, shot) field in VMEM and fuse U steps per
grid iteration; one 310x310 fp32 field is 384 KB, above the 227 KB of
shared memory one Hopper block may have, so these kernels choose their own
tiling: one thread per cell, the state in device memory (and mostly in the
50 MB L2). The TPU-only x-stencil layouts (``'roll'``, ``'mxu'``,
``'mxu_xy'``, ``'halo'``, env ``RDT_X_STENCIL``) are lowerings of the same
Laplacian and have no meaning here.

Beside each kernel is its plain PyTorch version (``fwd_chunk_plain``,
``bwd_reverse_chunk_plain``, ``tape_chunk_plain``, ``bwd_tape_chunk_plain``)
with the same fp32 arithmetic, step for step. The wrappers (``fwd_chunk``,
``bwd_reverse_chunk``, ``tape_chunk``, ``bwd_tape_chunk``) take the plain
version only for tensors on the CPU; on a CUDA tensor they launch the
kernel or raise.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

C1, C2, C3 = -2.5, 4.0 / 3.0, -1.0 / 12.0

# Kernel launches made by the wrappers, by kernel. Each wrapper adds one for
# every kernel launch it makes, and nowhere else.
launches = {'fwd_step': 0, 'bwd_reverse_step': 0, 'tape_step': 0,
            'bwd_tape_step': 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pick_unroll(chunk: int) -> int:
    """Largest unroll factor of the TPU kernels dividing the chunk
    (``red_diffeq_tpu/ops/stencil.py:48-53``). The CUDA kernels step one
    time step per launch; the value stays part of the resolved run
    configuration that logs report."""
    for u in (10, 8, 5, 4, 2, 1):
        if chunk % u == 0:
            return u
    return 1


# Default adjoint: 'reverse' rebuilds past states by inverting the damped
# recursion; 'tape' replays the chunk into a tape of its states, the route
# when the rebuild would be unstable.
ADJOINT_MODE = 'reverse'
# Framework-wide velocity ceiling, v in [1500, 4500] m/s; kappa grows with
# the sample's vmin, so this bounds the sponge damping and so min(t2).
_V_CEILING = 4500.0
# Below this bound on t2, the rebuild's divide amplifies fp32 error by
# more than (1/0.8)^U per U steps: route to the tape adjoint.
_T2_GUARD = 0.8


def _t2_lower_bound(geom) -> float:
    """Lower bound on min(t2) = 1 - max(kappa)*dt for any velocity model in
    [1500, 4500] m/s (kappa = 3*vmin*ln(1e7)/(2a), ramp <= 1)."""
    a = (geom.nbc - 1) * geom.dx
    kappa_max = 3.0 * _V_CEILING * np.log(1.0e7) / (2.0 * a)
    return float(1.0 - kappa_max * geom.dt)


def resolve_run_config(geom, chunk: int, mode: Optional[str] = None):
    """Effective (mode, unroll): ``mode=None`` selects ADJOINT_MODE,
    downgraded to 'tape' when the bound on min(t2) falls below the guard."""
    if mode is None:
        mode = ADJOINT_MODE
        if mode == 'reverse' and _t2_lower_bound(geom) < _T2_GUARD:
            mode = 'tape'
    return mode, pick_unroll(chunk)


def build_injection_field(beta_pts: torch.Tensor, isx, wp: int
                          ) -> torch.Tensor:
    """(B, ns) source amplitudes -> (B, ns, 1, Wp) injection row field with
    beta at each shot's source column. Differentiable w.r.t. beta_pts."""
    b, ns = beta_pts.shape
    inj = beta_pts.new_zeros(b, ns, wp)
    inj[:, torch.arange(ns), torch.as_tensor(isx)] = beta_pts
    return inj[:, :, None, :]


def laplacian4(p: torch.Tensor) -> torch.Tensor:
    """4th-order 2D Laplacian (without alpha), circular boundaries, in the
    exact fp32 grouping of ``red_diffeq_tpu/solvers/acoustic.py:188-191``.
    ``roll(p, 1)[i] == p[i - 1]``."""
    return (C2 * (torch.roll(p, 1, -2) + torch.roll(p, -1, -2)
                  + torch.roll(p, 1, -1) + torch.roll(p, -1, -1))
            + C3 * (torch.roll(p, 2, -2) + torch.roll(p, -2, -2)
                    + torch.roll(p, 2, -1) + torch.roll(p, -2, -1)))


# ----------------------------------------------------------------------
# Plain versions, step for step the kernels' arithmetic.
# ----------------------------------------------------------------------

def _step_plain(p0, p1, alpha, t1, t2, inj, src_k, isz):
    """s_m = t1*s_{m-1} - t2*s_{m-2} + alpha*L(s_{m-1}), then the source row
    ``isz`` adds inj*src[k]."""
    p = t1 * p1 - t2 * p0 + alpha * laplacian4(p1)
    p[:, :, isz, :] = p[:, :, isz, :] + inj[:, :, 0, :] * src_k
    return p


def fwd_chunk_plain(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz, igz, g0,
                    ng):
    """``chunk`` FD steps; returns (p0', p1', recs (B, ns, chunk, ng)).
    Row ``igz``, columns g0:g0+ng, is recorded after the injection."""
    recs = []
    for k in range(src_chunk.shape[0]):
        p = _step_plain(p0, p1, alpha, t1, t2, inj, src_chunk[k], isz)
        recs.append(p[:, :, igz, g0:g0 + ng])
        p0, p1 = p1, p
    return p0, p1, torch.stack(recs, dim=2)


def tape_chunk_plain(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz):
    """The chunk's replay from its start carry (p0 = s_{-1}, p1 = s_0):
    the tape (chunk + 2, B, ns, Hp, Wp) with slot i = s_{i-1}."""
    tape = [p0, p1]
    for k in range(src_chunk.shape[0]):
        tape.append(_step_plain(tape[-2], tape[-1], alpha, t1, t2, inj,
                                src_chunk[k], isz))
    return torch.stack(tape)


def bwd_reverse_chunk_plain(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                            src_chunk, *, isz, igz, g0, ng):
    """Tape-free adjoint of :func:`fwd_chunk_plain`, from the chunk's final
    states (p0o = s_{K-1}, p1o = s_K), their cotangents and the receiver
    cotangent ``grec`` (B, ns, chunk, ng). The rebuild does not read the
    cotangent, so the past states are rebuilt backwards first,

      s_{m-2} = (t1*s_{m-1} + alpha*L(s_{m-1}) + inj_m - s_m) / t2,

    into the tape layout, and :func:`bwd_tape_chunk_plain` sweeps them; each
    step's arithmetic is ``bwd_reverse_step``'s. Returns (gp0, gp1, galpha,
    gt1, gt2, ginj)."""
    inv_t2 = 1.0 / t2
    states = [p1o, p0o]                         # s_K, s_{K-1}, ..., s_{-1}
    for k in range(src_chunk.shape[0] - 1, -1, -1):
        s_m, s_m1 = states[-2], states[-1]
        inj_field = torch.zeros_like(s_m1)
        inj_field[:, :, isz, :] = inj[:, :, 0, :] * src_chunk[k]
        states.append((t1 * s_m1 + alpha * laplacian4(s_m1) + inj_field
                       - s_m) * inv_t2)
    return bwd_tape_chunk_plain(torch.stack(states[::-1]), gp0o, gp1o, grec,
                                alpha, t1, t2, src_chunk, isz=isz, igz=igz,
                                g0=g0, ng=ng)


def bwd_tape_chunk_plain(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                         *, isz, igz, g0, ng):
    """Taped adjoint of :func:`fwd_chunk_plain`, reading s_{m-1} and s_{m-2}
    from slots m and m-1 of the tape of :func:`tape_chunk_plain`. Per
    reversed step m (k = m - 1):

      v += G^T grec[k]
      galpha += v*L(s_{m-1}); gt1 += v*s_{m-1}; gt2 -= v*s_{m-2}
      ginj += v[isz]*src[k]
      (u, v) <- (-t2*v, u + t1*v + L(alpha*v))

    The coefficient cotangents are summed over shots in shot order, as the
    kernels do. Returns (gp0, gp1, galpha, gt1, gt2, ginj)."""
    ns, wp = gp0o.shape[1], gp0o.shape[-1]
    u, v = gp0o, gp1o
    galpha = torch.zeros_like(alpha)
    gt1 = torch.zeros_like(alpha)
    gt2 = torch.zeros_like(alpha)
    ginj = gp0o.new_zeros(gp0o.shape[0], ns, 1, wp)
    for k in range(src_chunk.shape[0] - 1, -1, -1):
        v = v.clone()
        v[:, :, igz, g0:g0 + ng] = v[:, :, igz, g0:g0 + ng] + grec[:, :, k]
        s_m1, s_m2 = tape[k + 1], tape[k]
        lap_s = laplacian4(s_m1)
        ginj = ginj + v[:, :, isz:isz + 1, :] * src_chunk[k]
        for s in range(ns):
            vs = v[:, s:s + 1]
            galpha = galpha + vs * lap_s[:, s:s + 1]
            gt1 = gt1 + vs * s_m1[:, s:s + 1]
            gt2 = gt2 - vs * s_m2[:, s:s + 1]
        u, v = -t2 * v, u + t1 * v + laplacian4(alpha * v)
    return u, v, galpha, gt1, gt2, ginj


# ----------------------------------------------------------------------
# The CUDA library: built with nvcc at first use, loaded with ctypes.
# ----------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / 'csrc' / 'stencil.cu'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC',
              # No fused multiply-add: each fp32 multiply and add rounds as
              # in the plain PyTorch version, so the two agree step for step.
              '-fmad=false']
_lib = None


_DEFAULT_NVCC = '/usr/local/cuda/bin/nvcc'


def _nvcc() -> str:
    path = shutil.which('nvcc') or _DEFAULT_NVCC
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return path


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/stencil.cu`` into a shared library named by the hash
    of its source and flags, unless that library exists. Returns its path;
    raises if the build fails."""
    src = _CSRC.read_bytes()
    tag = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f'libstencil-{tag}.so'
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp, str(_CSRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{res.stderr}')
    if verbose:
        print(res.stderr, end='', flush=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdt_fwd_chunk.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.rdt_fwd_chunk.restype = i
        lib.rdt_bwd_reverse_chunk.argtypes = [p] * 16 + [i] * 9 + [p]
        lib.rdt_bwd_reverse_chunk.restype = i
        lib.rdt_tape_chunk.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.rdt_tape_chunk.restype = i
        lib.rdt_bwd_tape_chunk.argtypes = [p] * 14 + [i] * 9 + [p]
        lib.rdt_bwd_tape_chunk.restype = i
        _lib = lib
    return _lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name} must be float32, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _check_geometry(hp, wp, isz, igz=0, g0=0, ng=0):
    if hp < 5 or wp < 5:
        raise ValueError('the 4th-order stencil needs a field of at least '
                         '5x5')
    if not (0 <= isz < hp and 0 <= igz < hp and 0 <= g0 and g0 + ng <= wp):
        raise ValueError('source row, receiver row or receiver columns lie '
                         'outside the field')


def _check_args(fields, alpha, t1, t2, src_chunk, *, isz, igz=0, g0=0,
                ng=0, inj=None):
    """Check the (B, ns, Hp, Wp) wavefields (a dict name -> tensor, shaped
    as the first), the (B, 1, Hp, Wp) coefficients, the injection row, the
    source chunk and the geometry. Returns (B, ns, Hp, Wp)."""
    first = next(iter(fields.values()))
    if first.dim() != 4:
        raise ValueError(f'wavefields must be (B, ns, Hp, Wp), got shape '
                         f'{tuple(first.shape)}')
    b, ns, hp, wp = first.shape
    dev = first.device
    for name, t in fields.items():
        _check(name, t, (b, ns, hp, wp), dev)
    for name, t in (('alpha', alpha), ('t1', t1), ('t2', t2)):
        _check(name, t, (b, 1, hp, wp), dev)
    if inj is not None:
        _check('inj', inj, (b, ns, 1, wp), dev)
    _check('src_chunk', src_chunk, (src_chunk.shape[0],), dev)
    _check_geometry(hp, wp, isz, igz, g0, ng)
    if first.numel() >= 2 ** 31:
        raise ValueError('fields of 2**31 elements or more are not supported')
    return b, ns, hp, wp


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def fwd_chunk(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz, igz, g0, ng):
    """One chunk of the forward stepper: the CUDA kernel ``fwd_step`` for
    CUDA tensors, :func:`fwd_chunk_plain` for CPU tensors. Returns
    (p0', p1', recs (B, ns, chunk, ng))."""
    if p0.device.type == 'cpu':
        return fwd_chunk_plain(p0, p1, alpha, t1, t2, inj, src_chunk,
                               isz=isz, igz=igz, g0=g0, ng=ng)
    if p0.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0.device}')
    b, ns, hp, wp = _check_args({'p0': p0, 'p1': p1}, alpha, t1, t2,
                                src_chunk, isz=isz, igz=igz, g0=g0, ng=ng,
                                inj=inj)
    chunk = src_chunk.shape[0]
    lib = _load()
    x, y = p0.clone(), p1.clone()  # stepped in place, ping-pong
    recs = torch.empty((b, ns, chunk, ng), device=p0.device,
                       dtype=torch.float32)
    err = lib.rdt_fwd_chunk(
        _ptr(x), _ptr(y), _ptr(alpha), _ptr(t1), _ptr(t2), _ptr(inj),
        _ptr(src_chunk), _ptr(recs), b, ns, hp, wp, isz, igz, g0, ng, chunk,
        _stream(p0.device))
    if err != 0:
        raise RuntimeError(f'fwd_step launch failed: CUDA error {err}')
    launches['fwd_step'] += chunk
    # After an even number of steps s_K sits in y, else in x.
    return (x, y, recs) if chunk % 2 == 0 else (y, x, recs)


def bwd_reverse_chunk(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                      src_chunk, *, isz, igz, g0, ng):
    """The tape-free adjoint of one chunk: the CUDA kernel
    ``bwd_reverse_step`` for CUDA tensors, :func:`bwd_reverse_chunk_plain`
    for CPU tensors. Returns (gp0, gp1, galpha, gt1, gt2, ginj)."""
    if p0o.device.type == 'cpu':
        return bwd_reverse_chunk_plain(
            p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj, src_chunk,
            isz=isz, igz=igz, g0=g0, ng=ng)
    if p0o.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0o.device}')
    b, ns, hp, wp = _check_args(
        {'p0o': p0o, 'p1o': p1o, 'gp0o': gp0o, 'gp1o': gp1o}, alpha, t1, t2,
        src_chunk, isz=isz, igz=igz, g0=g0, ng=ng, inj=inj)
    chunk = src_chunk.shape[0]
    dev = p0o.device
    _check('grec', grec, (b, ns, chunk, ng), dev)
    lib = _load()
    # u, v: cotangents of s_{m-1}, s_m (ping-pong with u2, v2); s_m is
    # overwritten in place by the rebuilt s_{m-2}.
    u, v = gp0o.clone(), gp1o.clone()
    u2, v2 = torch.empty_like(u), torch.empty_like(v)
    s_m, s_m1 = p1o.clone(), p0o.clone()
    galpha = torch.zeros_like(alpha)
    gt1 = torch.zeros_like(alpha)
    gt2 = torch.zeros_like(alpha)
    ginj = torch.zeros_like(inj)
    err = lib.rdt_bwd_reverse_chunk(
        _ptr(u), _ptr(v), _ptr(u2), _ptr(v2), _ptr(s_m), _ptr(s_m1),
        _ptr(grec), _ptr(alpha), _ptr(t1), _ptr(t2), _ptr(inj),
        _ptr(src_chunk), _ptr(galpha), _ptr(gt1), _ptr(gt2), _ptr(ginj),
        b, ns, hp, wp, isz, igz, g0, ng, chunk, _stream(dev))
    if err != 0:
        raise RuntimeError(f'bwd_reverse_step launch failed: CUDA error '
                           f'{err}')
    launches['bwd_reverse_step'] += chunk
    gp0, gp1 = (u, v) if chunk % 2 == 0 else (u2, v2)
    return gp0, gp1, galpha, gt1, gt2, ginj


def tape_chunk(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz):
    """The replay of one chunk into its tape: the CUDA kernel ``tape_step``
    for CUDA tensors, :func:`tape_chunk_plain` for CPU tensors. Returns the
    tape (chunk + 2, B, ns, Hp, Wp), slot i = s_{i-1}."""
    if p0.device.type == 'cpu':
        return tape_chunk_plain(p0, p1, alpha, t1, t2, inj, src_chunk,
                                isz=isz)
    if p0.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0.device}')
    b, ns, hp, wp = _check_args({'p0': p0, 'p1': p1}, alpha, t1, t2,
                                src_chunk, isz=isz, inj=inj)
    chunk = src_chunk.shape[0]
    lib = _load()
    tape = torch.empty((chunk + 2, b, ns, hp, wp), device=p0.device,
                       dtype=torch.float32)
    tape[0].copy_(p0)
    tape[1].copy_(p1)
    err = lib.rdt_tape_chunk(
        _ptr(tape), _ptr(alpha), _ptr(t1), _ptr(t2), _ptr(inj),
        _ptr(src_chunk), b, ns, hp, wp, isz, chunk, _stream(p0.device))
    if err != 0:
        raise RuntimeError(f'tape_step launch failed: CUDA error {err}')
    launches['tape_step'] += chunk
    return tape


def bwd_tape_chunk(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk, *, isz,
                   igz, g0, ng):
    """The taped adjoint of one chunk: the CUDA kernel ``bwd_tape_step``
    for CUDA tensors, :func:`bwd_tape_chunk_plain` for CPU tensors. Returns
    (gp0, gp1, galpha, gt1, gt2, ginj)."""
    if gp0o.device.type == 'cpu':
        return bwd_tape_chunk_plain(tape, gp0o, gp1o, grec, alpha, t1, t2,
                                    src_chunk, isz=isz, igz=igz, g0=g0,
                                    ng=ng)
    if gp0o.device.type != 'cuda':
        raise ValueError(f'unsupported device {gp0o.device}')
    b, ns, hp, wp = _check_args({'gp0o': gp0o, 'gp1o': gp1o}, alpha, t1, t2,
                                src_chunk, isz=isz, igz=igz, g0=g0, ng=ng)
    chunk = src_chunk.shape[0]
    dev = gp0o.device
    _check('tape', tape, (chunk + 2, b, ns, hp, wp), dev)
    _check('grec', grec, (b, ns, chunk, ng), dev)
    lib = _load()
    u, v = gp0o.clone(), gp1o.clone()   # ping-pong with u2, v2
    u2, v2 = torch.empty_like(u), torch.empty_like(v)
    galpha = torch.zeros_like(alpha)
    gt1 = torch.zeros_like(alpha)
    gt2 = torch.zeros_like(alpha)
    ginj = torch.zeros((b, ns, 1, wp), device=dev, dtype=torch.float32)
    err = lib.rdt_bwd_tape_chunk(
        _ptr(u), _ptr(v), _ptr(u2), _ptr(v2), _ptr(tape), _ptr(grec),
        _ptr(alpha), _ptr(t1), _ptr(t2), _ptr(src_chunk), _ptr(galpha),
        _ptr(gt1), _ptr(gt2), _ptr(ginj), b, ns, hp, wp, isz, igz, g0, ng,
        chunk, _stream(dev))
    if err != 0:
        raise RuntimeError(f'bwd_tape_step launch failed: CUDA error {err}')
    launches['bwd_tape_step'] += chunk
    gp0, gp1 = (u, v) if chunk % 2 == 0 else (u2, v2)
    return gp0, gp1, galpha, gt1, gt2, ginj


class StencilChunk(torch.autograd.Function):
    """One chunk of FD steps with a kernel adjoint as its backward;
    counterpart of ``pallas_chunk`` and its ``jax.custom_vjp``
    (``red_diffeq_tpu/ops/stencil.py:680-765``). ``mode`` 'reverse' saves
    the chunk's final carry and runs the tape-free adjoint; 'tape' saves
    the chunk-start carry, and its backward replays the chunk into a tape
    and sweeps it (``_pallas_chunk_bwd``, ``:739-763``)."""

    @staticmethod
    def forward(ctx, p0, p1, alpha, t1, t2, inj, src_chunk, geo,
                mode='reverse'):
        if mode not in ('reverse', 'tape'):
            raise ValueError(f"unknown adjoint mode {mode!r} (expected "
                             "'reverse' or 'tape')")
        isz, igz, g0, ng = geo
        p0o, p1o, recs = fwd_chunk(p0, p1, alpha, t1, t2, inj, src_chunk,
                                   isz=isz, igz=igz, g0=g0, ng=ng)
        carry = (p0o, p1o) if mode == 'reverse' else (p0, p1)
        ctx.save_for_backward(*carry, alpha, t1, t2, inj, src_chunk)
        ctx.geo, ctx.mode = geo, mode
        return p0o, p1o, recs

    @staticmethod
    def backward(ctx, gp0o, gp1o, grec):
        c0, c1, alpha, t1, t2, inj, src_chunk = ctx.saved_tensors
        isz, igz, g0, ng = ctx.geo
        gp0o, gp1o, grec = (g.contiguous() for g in (gp0o, gp1o, grec))
        if ctx.mode == 'reverse':
            grads = bwd_reverse_chunk(c0, c1, gp0o, gp1o, grec, alpha, t1,
                                      t2, inj, src_chunk, isz=isz, igz=igz,
                                      g0=g0, ng=ng)
        else:
            tape = tape_chunk(c0, c1, alpha, t1, t2, inj, src_chunk, isz=isz)
            grads = bwd_tape_chunk(tape, gp0o, gp1o, grec, alpha, t1, t2,
                                   src_chunk, isz=isz, igz=igz, g0=g0, ng=ng)
        # The source wavelet is a configuration constant: no cotangent.
        return (*grads, None, None, None)


def stencil_chunk_fn(*, alpha, temp1, temp2, beta_pts, geom, chunk,
                     mode=None):
    """Adapter with the (carry, src_chunk) -> (carry, recs) signature of
    the solver's chunk loop, ``recs`` as (B, ns, chunk, ng); counterpart
    of ``pallas_chunk_fn`` (``red_diffeq_tpu/ops/stencil.py:801-827``).
    ``mode=None`` takes the adjoint the t2 guard picks
    (:func:`resolve_run_config`)."""
    if not geom.receivers_contiguous:
        raise NotImplementedError(
            'the kernel backend requires a contiguous receiver line; '
            "use backend='plain' for scattered receivers")
    mode, _ = resolve_run_config(geom, chunk, mode)
    wp = alpha.shape[-1]
    inj = build_injection_field(beta_pts, geom.isx, wp).contiguous()
    geo = (geom.isz, geom.igz, geom.igx[0], geom.ng)
    alpha, temp1, temp2 = (c.contiguous() for c in (alpha, temp1, temp2))

    def chunk_fn(carry, src_chunk):
        p0o, p1o, recs = StencilChunk.apply(*carry, alpha, temp1, temp2,
                                            inj, src_chunk, geo, mode)
        return (p0o, p1o), recs

    return chunk_fn
