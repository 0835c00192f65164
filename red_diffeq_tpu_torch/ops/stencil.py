"""Hand-written CUDA kernels for the acoustic FD time stepper.

Counterpart of ``red_diffeq_tpu/ops/stencil.py``. All four kernels of that
module are ported, in ``csrc/stencil.cu``:

* ``_fwd_kernel`` (launcher ``_run_fwd``, ``stencil.py:150-231, 510``)
  becomes ``fwd_step``: U FD steps of one tile of a (sample, shot)
  wavefield, with the source injection and the receiver row recorded.
* ``_bwd_reverse_kernel`` (launcher ``_run_bwd_reverse``,
  ``stencil.py:352-443, 632``) becomes ``bwd_reverse_step``: U steps of
  the tape-free adjoint on one tile, rebuilding s_{m-2} from s_m and
  s_{m-1} while the cotangent sweeps backward, and ``sum_shots``, which
  sums its per-shot coefficient cotangents over shots once per chunk (the
  JAX kernel adds every shot into one shot-shared block, ``:435-437``).
* ``_tape_kernel`` (launcher ``_run_tape``, ``stencil.py:233-268, 550``)
  becomes ``tape_step``: the chunk's whole replay in one launch, into a
  flat tape of ``chunk + 1`` states (slot i = s_{i-1}; slots 0 and 1 are
  the chunk-start carry; the chunk-end state, which the taped adjoint never
  reads, is not replayed), with no receiver rows.
* ``_bwd_kernel`` (launcher ``_run_bwd``, ``stencil.py:271-349, 582``)
  becomes ``bwd_tape_step``: U steps of the taped adjoint on one tile,
  reading s_{m-1} and s_{m-2} from the tape instead of rebuilding them,
  and ``sum_shots`` over its per-shot coefficient cotangents, as for the
  tape-free adjoint.

The taped pair is the JAX package's route when the t2 guard trips (a
narrow or strong sponge: at dx=10, dt=1e-3 any nbc <= 55), or when the
caller asks for ``adjoint='tape'``. As in the JAX custom VJP, the tape
lives only during one chunk's backward.

``fwd_step``, ``bwd_reverse_step`` and ``bwd_tape_step`` are temporally
blocked: one launch takes U steps (the last group of a chunk may be
shorter) of one tile of one (sample, shot) field, loaded into shared memory
with a halo of 2U cells a side; :func:`pick_blocking` picks U from the
field size, and the tile is the kernel's compiled window less the halos. A
chunk is ceil(chunk/U) launches of each, and each adjoint's chunk launcher
adds one ``sum_shots`` launch after its last group. The TPU kernels keep a
whole field in VMEM; one 310x310 fp32 field is 384 KB, above the 227 KB of
shared memory one Hopper block may have, hence tiles.

``tape_step`` keeps the TPU kernel's whole-field residency across a
thread-block cluster instead: one launch per chunk, one (sample, shot)
field per cluster of up to 16 blocks (:func:`pick_ranks`), each block a
strip of the field's rows in shared memory with its coefficients, the
strips' 2 boundary rows written into the neighbours' halo rows through
distributed shared memory, one cluster barrier a step. It writes only the
tape, and only the ``chunk + 1`` slots the taped adjoint reads; its bound
is those bytes. A field whose strip does not fit a block's 227 KB,
(5*ceil(Hp/16) + 9) * Wp floats (416x416 and 310x430 fit, 420x420 does
not, :func:`pick_ranks`), takes ``tape_step_stream`` instead: the same
scheme, one launch per chunk, with as many of the three coefficient
planes in shared memory as fit beside the states (:func:`pick_stream`:
two at 420x420) and the others read a few rows ahead from device memory.
Past that one's limit, where the strip's two states alone do not fit
(about 640x640 and larger), ``tape_step_global`` takes the field: the
same tape, bit for bit, from one launch per FD step that reads the two
slots before from device memory; the JAX kernel keeps whole fields in up
to 100 MB of VMEM and has no size limit, so neither has the port.

No kernel adds with floating-point atomics, so every result repeats bit
for bit.
The TPU-only x-stencil layouts of these kernels (``'roll'``, ``'mxu'``,
``'mxu_xy'``, ``'halo'``, env ``RDT_X_STENCIL``) are lowerings of the same
Laplacian and are not ported; the microbenchmark that compares such
layouts on the card is ``layout_probe.py``.

Beside each kernel is its plain PyTorch version (``fwd_chunk_plain``,
``bwd_reverse_steps_plain``, ``sum_shots_plain``, ``tape_chunk_plain``,
``bwd_tape_steps_plain``) with the same fp32 arithmetic, step for step and
in the same order of summation; ``bwd_reverse_chunk_plain`` and
``bwd_tape_chunk_plain`` are the adjoint's steps followed by
``sum_shots_plain``. The wrappers (``fwd_chunk``, ``bwd_reverse_steps``,
``bwd_reverse_chunk`` (the steps, then ``sum_shots``, in one library
call), ``sum_shots``, ``tape_chunk``, ``bwd_tape_steps``,
``bwd_tape_chunk``) take the plain version only for tensors on the CPU; on
a CUDA tensor they launch the kernel or raise.
"""
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from red_diffeq_tpu_torch.utils.device import device_index

C1, C2, C3 = -2.5, 4.0 / 3.0, -1.0 / 12.0

# Kernel launches made by the wrappers, by kernel. Each wrapper adds one for
# every kernel launch it makes, and nowhere else; a replay of a CUDA graph
# of the inversion step adds the launches its capture counted
# (core/graphs.py), so the counts stay the kernels enqueued on the card.
launches = {'fwd_step': 0, 'bwd_reverse_step': 0, 'sum_shots': 0,
            'tape_step': 0, 'bwd_tape_step': 0, 'tape_step_global': 0,
            'tape_step_stream': 0}
# FD steps per launch that each blocked kernel's wrapper last handed its
# launcher (None until it launches; ``sum_shots`` takes no steps,
# ``tape_step`` and ``tape_step_stream`` a whole chunk and
# ``tape_step_global`` one step a launch, so these four stay None).
last_unroll = dict.fromkeys(launches)
# Blocks per cluster (one field a cluster) that the ``tape_step`` and
# ``tape_step_stream`` wrappers last handed their launchers.
last_ranks = {'tape_step': None, 'tape_step_stream': None}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        last_unroll[k] = None
    for k in last_ranks:
        last_ranks[k] = None


def pick_unroll(chunk: int) -> int:
    """Largest unroll factor of the TPU kernels dividing the chunk
    (``red_diffeq_tpu/ops/stencil.py:48-53``), part of the resolved run
    configuration that logs report. The CUDA kernels pick their own steps
    per launch from the field size (:func:`pick_blocking`)."""
    for u in (10, 8, 5, 4, 2, 1):
        if chunk % u == 0:
            return u
    return 1


# The temporally blocked kernels; their windows and most steps per launch
# are compiled into csrc/stencil.cu and read through pick_blocking.
BLOCKED = ('fwd_step', 'bwd_reverse_step', 'bwd_tape_step')


def pick_blocking(kernel: str, hp: int, wp: int):
    """(U, tile rows, tile columns) of blocked ``kernel`` for an Hp x Wp
    field, as the CUDA library computes them (``rdt_blocking``): the most
    steps per launch compiled in, cut so that the two halos of 2U cells fit
    in the field's shorter side (4U <= min(Hp, Wp)); the tile is the
    kernel's window less the halos. Raises for a field too small for
    U = 1."""
    if kernel not in BLOCKED:
        raise ValueError(f'{kernel} is not a blocked kernel')
    vals = [ctypes.c_int() for _ in range(3)]
    if _load().rdt_blocking(_KERNEL_IDS[kernel], hp, wp,
                            *map(ctypes.byref, vals)) != 0:
        raise ValueError(f'a {hp}x{wp} field is too small for the halo of '
                         f'{kernel}')
    return tuple(v.value for v in vals)


def pick_ranks(hp: int, wp: int) -> Optional[int]:
    """Blocks per cluster of ``tape_step`` for an Hp x Wp field, as the CUDA
    library picks them (``rdt_tape_ranks``): the most of 16, 8, 4, 2, 1
    that leave each block's strip of rows 2 rows or more. None for a field
    beyond the cluster's size limit, whose strip of ceil(Hp/16) rows (two
    states with 2 halo rows a side, alpha, t1, t2, the injection row) does
    not fit a block's 227 KB: (5*ceil(Hp/16) + 9) * Wp floats over 232448
    bytes (310x430 and 416x416 fit, 420x420 does not). The tape replay
    takes ``tape_step_stream`` there (:func:`pick_stream`)."""
    ranks = ctypes.c_int()
    if _load().rdt_tape_ranks(hp, wp, ctypes.byref(ranks)) != 0:
        return None
    return ranks.value


def pick_stream(hp: int, wp: int):
    """(blocks per cluster, resident coefficient planes) of
    ``tape_step_stream`` for an Hp x Wp field, as the CUDA library picks
    them (``rdt_tape_stream_plan``): the blocks as :func:`pick_ranks`'s, and
    the most of 2, 1, 0 of the planes alpha, t1, t2 that fit a block's
    227 KB beside the two states with their halo rows and the injection
    row, (2*(rows + 4) + planes*rows + 1) * Wp floats for a strip of rows
    = ceil(Hp/16); the others are read from device memory. None for a
    field whose states alone do not fit (641x641 and larger for a square
    field), which ``tape_step_global`` takes. The tape replay asks this
    only for a field past ``tape_step``'s limit (420x420: 16 blocks, 2
    planes)."""
    ranks, planes = ctypes.c_int(), ctypes.c_int()
    if _load().rdt_tape_stream_plan(hp, wp, ctypes.byref(ranks),
                                    ctypes.byref(planes)) != 0:
        return None
    return ranks.value, planes.value


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
    dev = beta_pts.device
    inj[:, torch.arange(ns, device=dev),
        device_index(tuple(int(i) for i in isx), dev)] = beta_pts
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
    the tape (chunk + 1, B, ns, Hp, Wp) with slot i = s_{i-1}, the slots
    the taped adjoint reads. The chunk's last step, whose state s_chunk no
    slot holds, is not taken."""
    tape = [p0, p1]
    for k in range(src_chunk.shape[0] - 1):
        tape.append(_step_plain(tape[-2], tape[-1], alpha, t1, t2, inj,
                                src_chunk[k], isz))
    return torch.stack(tape)


def bwd_reverse_chunk_plain(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                            src_chunk, *, isz, igz, g0, ng):
    """Tape-free adjoint of :func:`fwd_chunk_plain`, from the chunk's final
    states (p0o = s_{K-1}, p1o = s_K), their cotangents and the receiver
    cotangent ``grec`` (B, ns, chunk, ng): :func:`bwd_reverse_steps_plain`,
    then the per-shot coefficient cotangents summed over the shots
    (:func:`sum_shots_plain`), as ``bwd_reverse_step`` and ``sum_shots``
    do. Returns (gp0, gp1, galpha, gt1, gt2, ginj)."""
    gp0, gp1, pa, p1, p2, ginj = bwd_reverse_steps_plain(
        p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj, src_chunk, isz=isz,
        igz=igz, g0=g0, ng=ng)
    return (gp0, gp1, *(sum_shots_plain(t) for t in (pa, p1, p2)), ginj)


def bwd_reverse_steps_plain(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                            src_chunk, *, isz, igz, g0, ng):
    """The steps of :func:`bwd_reverse_chunk_plain`, the coefficient
    cotangents left as per-shot sums. The rebuild does not read the
    cotangent, so the past states are rebuilt backwards first,

      s_{m-2} = (t1*s_{m-1} + alpha*L(s_{m-1}) + inj_m - s_m) / t2,

    into the tape layout, and :func:`bwd_tape_steps_plain` sweeps them;
    each step's arithmetic is ``bwd_reverse_step``'s, and as in that kernel
    the coefficient cotangents are summed per shot over the steps. Returns
    (gp0, gp1, pa, p1, p2, ginj), the sums of the alpha, t1 and t2
    cotangents (B, ns, Hp, Wp)."""
    inv_t2 = 1.0 / t2
    states = [p1o, p0o]                         # s_K, s_{K-1}, ..., s_{-1}
    for k in range(src_chunk.shape[0] - 1, -1, -1):
        s_m, s_m1 = states[-2], states[-1]
        inj_field = torch.zeros_like(s_m1)
        inj_field[:, :, isz, :] = inj[:, :, 0, :] * src_chunk[k]
        states.append((t1 * s_m1 + alpha * laplacian4(s_m1) + inj_field
                       - s_m) * inv_t2)
    # s_{-1} .. s_{K-1}: the tape layout, without the chunk-end state.
    return bwd_tape_steps_plain(torch.stack(states[:0:-1]), gp0o, gp1o, grec,
                                alpha, t1, t2, src_chunk, isz=isz, igz=igz,
                                g0=g0, ng=ng)


def sum_shots_plain(partial):
    """(B, ns, Hp, Wp) per-shot sums -> (B, 1, Hp, Wp), added in shot
    order: ((p[:, 0] + p[:, 1]) + ...) + p[:, ns-1]."""
    out = partial[:, 0:1].contiguous()
    for s in range(1, partial.shape[1]):
        out = out + partial[:, s:s + 1]
    return out


def bwd_tape_chunk_plain(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                         *, isz, igz, g0, ng):
    """Taped adjoint of :func:`fwd_chunk_plain`:
    :func:`bwd_tape_steps_plain`, then the per-shot coefficient cotangents
    summed over the shots (:func:`sum_shots_plain`), as ``bwd_tape_step``
    and ``sum_shots`` do. Returns (gp0, gp1, galpha, gt1, gt2, ginj)."""
    gp0, gp1, pa, p1, p2, ginj = bwd_tape_steps_plain(
        tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk, isz=isz, igz=igz,
        g0=g0, ng=ng)
    return (gp0, gp1, *(sum_shots_plain(t) for t in (pa, p1, p2)), ginj)


def bwd_tape_steps_plain(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                         *, isz, igz, g0, ng):
    """The steps of :func:`bwd_tape_chunk_plain`, reading s_{m-1} and
    s_{m-2} from slots m and m-1 of the tape of :func:`tape_chunk_plain`,
    the coefficient cotangents left as per-shot sums. Per reversed step m
    (k = m - 1):

      v += G^T grec[k]
      galpha += v*L(s_{m-1}); gt1 += v*s_{m-1}; gt2 -= v*s_{m-2}
      ginj += v[isz]*src[k]
      (u, v) <- (-t2*v, u + t1*v + L(alpha*v))

    As in ``bwd_tape_step`` (and in ``bwd_reverse_step``, whose plain
    version sweeps its rebuilt states with this function), the coefficient
    cotangents are summed per shot over the steps. Returns (gp0, gp1, pa,
    p1, p2, ginj), the sums of the alpha, t1 and t2 cotangents (B, ns, Hp,
    Wp)."""
    u, v = gp0o, gp1o
    galpha, gt1, gt2 = (torch.zeros_like(gp0o) for _ in range(3))
    ginj = gp0o.new_zeros(gp0o.shape[0], gp0o.shape[1], 1, gp0o.shape[-1])
    for k in range(src_chunk.shape[0] - 1, -1, -1):
        v = v.clone()
        v[:, :, igz, g0:g0 + ng] = v[:, :, igz, g0:g0 + ng] + grec[:, :, k]
        s_m1, s_m2 = tape[k + 1], tape[k]
        ginj = ginj + v[:, :, isz:isz + 1, :] * src_chunk[k]
        galpha = galpha + v * laplacian4(s_m1)
        gt1 = gt1 + v * s_m1
        gt2 = gt2 - v * s_m2
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


def build(verbose: bool = False, source: Optional[Path] = None) -> Path:
    """Compile the CUDA source ``source`` (by default the module's
    ``_CSRC`` as it is at the call, ``csrc/stencil.cu`` unless a tool has
    pointed it at a variant) into a shared library in BUILD_DIR named by
    the source's stem and the hash of its text and flags, unless that
    library exists. Returns its path; raises if the build fails."""
    source = Path(_CSRC if source is None else source)
    src = source.read_bytes()
    tag = hashlib.sha1(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f'lib{source.stem}-{tag}.so'
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp, str(source)]
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
        lib.rdt_fwd_chunk.argtypes = [p] * 12 + [i] * 10 + [p]
        lib.rdt_fwd_chunk.restype = i
        lib.rdt_bwd_reverse_chunk.argtypes = [p] * 19 + [i] * 10 + [p]
        lib.rdt_bwd_reverse_chunk.restype = i
        lib.rdt_sum_shots.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.rdt_sum_shots.restype = i
        lib.rdt_tape_chunk.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.rdt_tape_chunk.restype = i
        lib.rdt_tape_chunk_global.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.rdt_tape_chunk_global.restype = i
        lib.rdt_tape_chunk_stream.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.rdt_tape_chunk_stream.restype = i
        lib.rdt_bwd_tape_chunk.argtypes = [p] * 19 + [i] * 10 + [p]
        lib.rdt_bwd_tape_chunk.restype = i
        ip = ctypes.POINTER(i)
        lib.rdt_kernel_info.argtypes = [i] * 3 + [ip] * 5
        lib.rdt_kernel_info.restype = i
        lib.rdt_blocking.argtypes = [i] * 3 + [ip] * 3
        lib.rdt_blocking.restype = i
        lib.rdt_tape_ranks.argtypes = [i, i, ip]
        lib.rdt_tape_ranks.restype = i
        lib.rdt_tape_stream_plan.argtypes = [i, i, ip, ip]
        lib.rdt_tape_stream_plan.restype = i
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
    if b * ns > 65535:
        raise ValueError('more than 65535 (sample, shot) fields are not '
                         'supported')
    return b, ns, hp, wp


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def on_device(device):
    """Make the CUDA device ``device`` current for a library call (no-op
    for another device type): the library sets each kernel's attributes and
    asks for its occupancy on the current device, which the stream handed
    to it does not choose."""
    if device.type != 'cuda':
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def on_device_of(index: int = 0):
    """Decorate a launcher so that it runs under :func:`on_device` of its
    positional argument ``index``'s device."""

    def wrap(fn):
        @functools.wraps(fn)
        def launch(*args, **kwargs):
            with on_device(args[index].device):
                return fn(*args, **kwargs)
        return launch

    return wrap


def fwd_chunk(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz, igz, g0, ng):
    """One chunk of the forward stepper: the CUDA kernel ``fwd_step`` for
    CUDA tensors, :func:`fwd_chunk_plain` for CPU tensors. Returns
    (p0', p1', recs (B, ns, chunk, ng))."""
    if p0.device.type == 'cpu':
        return fwd_chunk_plain(p0, p1, alpha, t1, t2, inj, src_chunk,
                               isz=isz, igz=igz, g0=g0, ng=ng)
    if p0.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0.device}')
    return _fwd_chunk_kernel(p0, p1, alpha, t1, t2, inj, src_chunk, isz=isz,
                             igz=igz, g0=g0, ng=ng)


@on_device_of(0)
def _fwd_chunk_kernel(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz, igz, g0,
                      ng):
    b, ns, hp, wp = _check_args({'p0': p0, 'p1': p1}, alpha, t1, t2,
                                src_chunk, isz=isz, igz=igz, g0=g0, ng=ng,
                                inj=inj)
    chunk = src_chunk.shape[0]
    unroll = pick_blocking('fwd_step', hp, wp)[0]
    lib = _load()
    x0, x1, y0, y1 = (torch.empty_like(p0) for _ in range(4))
    recs = torch.empty((b, ns, chunk, ng), device=p0.device,
                       dtype=torch.float32)
    err = lib.rdt_fwd_chunk(
        _ptr(p0), _ptr(p1), _ptr(x0), _ptr(x1), _ptr(y0), _ptr(y1),
        _ptr(alpha), _ptr(t1), _ptr(t2), _ptr(inj), _ptr(src_chunk),
        _ptr(recs), b, ns, hp, wp, isz, igz, g0, ng, chunk, unroll,
        _stream(p0.device))
    if err != 0:
        raise RuntimeError(f'fwd_step launch failed: CUDA error {err}')
    groups = -(-chunk // unroll)
    launches['fwd_step'] += groups
    last_unroll['fwd_step'] = unroll
    # The groups write (x0, x1) and (y0, y1) in turn, starting with x.
    return (x0, x1, recs) if groups % 2 else (y0, y1, recs)


def bwd_reverse_chunk(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                      src_chunk, *, isz, igz, g0, ng):
    """The tape-free adjoint of one chunk: the CUDA kernels
    ``bwd_reverse_step`` and ``sum_shots`` for CUDA tensors,
    :func:`bwd_reverse_chunk_plain` for CPU tensors. Returns (gp0, gp1,
    galpha, gt1, gt2, ginj)."""
    if p0o.device.type == 'cpu':
        return bwd_reverse_chunk_plain(
            p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj, src_chunk,
            isz=isz, igz=igz, g0=g0, ng=ng)
    if p0o.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0o.device}')
    return _bwd_reverse_chunk_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1,
                                     t2, inj, src_chunk, isz=isz, igz=igz,
                                     g0=g0, ng=ng)


def bwd_reverse_steps(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                      src_chunk, *, isz, igz, g0, ng):
    """The steps of the tape-free adjoint of one chunk, without the shot
    sums: the CUDA kernel ``bwd_reverse_step`` for CUDA tensors,
    :func:`bwd_reverse_steps_plain` for CPU tensors. Returns (gp0, gp1, pa,
    p1, p2, ginj), the alpha, t1 and t2 cotangents per shot."""
    if p0o.device.type == 'cpu':
        return bwd_reverse_steps_plain(
            p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj, src_chunk,
            isz=isz, igz=igz, g0=g0, ng=ng)
    if p0o.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0o.device}')
    return _bwd_reverse_steps_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1,
                                     t2, inj, src_chunk, isz=isz, igz=igz,
                                     g0=g0, ng=ng)


def _ptrs(ts):
    return ctypes.cast((ctypes.c_void_p * len(ts))(*(t.data_ptr()
                                                     for t in ts)),
                       ctypes.c_void_p)


def _bwd_reverse_chunk_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                              src_chunk, *, isz, igz, g0, ng):
    return _bwd_reverse_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2,
                               inj, src_chunk, isz=isz, igz=igz, g0=g0, ng=ng,
                               shot_sums=True)


def _bwd_reverse_steps_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2,
                              inj, src_chunk, *, isz, igz, g0, ng):
    return _bwd_reverse_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2,
                               inj, src_chunk, isz=isz, igz=igz, g0=g0, ng=ng,
                               shot_sums=False)


def _adjoint_sums(gp0o, shot_sums):
    """The per-shot sums of the alpha, t1, t2 cotangents (zeroed, as the
    launchers add to them), and, with ``shot_sums``, the three (B, 1, Hp,
    Wp) outputs of the chunk launcher's ``sum_shots`` launch with their
    pointers (null pointers without)."""
    parts = [torch.zeros_like(gp0o) for _ in range(3)]
    if not shot_sums:
        return parts, [], [ctypes.c_void_p(None)] * 3
    b, _, hp, wp = gp0o.shape
    sums = [gp0o.new_empty((b, 1, hp, wp)) for _ in range(3)]
    return parts, sums, [_ptr(t) for t in sums]


@on_device_of(0)
def _bwd_reverse_kernel(p0o, p1o, gp0o, gp1o, grec, alpha, t1, t2, inj,
                        src_chunk, *, isz, igz, g0, ng, shot_sums):
    """One library call: the blocked steps and, with ``shot_sums``, the
    chunk's ``sum_shots`` launch. Returns (gp0, gp1, galpha, gt1, gt2,
    ginj), or with per-shot sums (B, ns, Hp, Wp) in place of the shot
    sums."""
    b, ns, hp, wp = _check_args(
        {'p0o': p0o, 'p1o': p1o, 'gp0o': gp0o, 'gp1o': gp1o}, alpha, t1, t2,
        src_chunk, isz=isz, igz=igz, g0=g0, ng=ng, inj=inj)
    chunk = src_chunk.shape[0]
    dev = p0o.device
    _check('grec', grec, (b, ns, chunk, ng), dev)
    unroll = pick_blocking('bwd_reverse_step', hp, wp)[0]
    lib = _load()
    # Two sets of (u, v, s_m, s_{m-1}) written by the groups in turn; the
    # per-shot sums of the alpha, t1, t2 cotangents; the injection row's.
    x = [torch.empty_like(gp0o) for _ in range(4)]
    y = [torch.empty_like(gp0o) for _ in range(4)]
    parts, sums, sum_ptrs = _adjoint_sums(gp0o, shot_sums)
    ginj = torch.zeros_like(inj)
    err = lib.rdt_bwd_reverse_chunk(
        _ptr(gp0o), _ptr(gp1o), _ptr(p1o), _ptr(p0o), _ptrs(x), _ptrs(y),
        *map(_ptr, parts), _ptr(ginj), *sum_ptrs, _ptr(grec), _ptr(alpha),
        _ptr(t1), _ptr(t2), _ptr(inj), _ptr(src_chunk), b, ns, hp, wp, isz,
        igz, g0, ng, chunk, unroll, _stream(dev))
    if err != 0:
        raise RuntimeError(f'bwd_reverse_step launch failed: CUDA error '
                           f'{err}')
    groups = -(-chunk // unroll)
    launches['bwd_reverse_step'] += groups
    last_unroll['bwd_reverse_step'] = unroll
    if shot_sums:
        launches['sum_shots'] += 1
    out = x if groups % 2 else y
    return (out[0], out[1], *(sums or parts), ginj)


def sum_shots(pa, p1, p2):
    """The adjoint's per-shot coefficient cotangents (B, ns, Hp, Wp) summed
    over shots in shot order: the CUDA kernel ``sum_shots`` for CUDA
    tensors, :func:`sum_shots_plain` for CPU tensors. Returns (galpha, gt1,
    gt2), each (B, 1, Hp, Wp)."""
    if pa.device.type == 'cpu':
        return tuple(sum_shots_plain(p) for p in (pa, p1, p2))
    if pa.device.type != 'cuda':
        raise ValueError(f'unsupported device {pa.device}')
    return _sum_shots_kernel(pa, p1, p2)


@on_device_of(0)
def _sum_shots_kernel(pa, p1, p2):
    if pa.dim() != 4:
        raise ValueError(f'partial sums must be (B, ns, Hp, Wp), got shape '
                         f'{tuple(pa.shape)}')
    b, ns, hp, wp = pa.shape
    for name, t in (('pa', pa), ('p1', p1), ('p2', p2)):
        _check(name, t, (b, ns, hp, wp), pa.device)
    lib = _load()
    out = [pa.new_empty((b, 1, hp, wp)) for _ in range(3)]
    err = lib.rdt_sum_shots(_ptr(pa), _ptr(p1), _ptr(p2), *map(_ptr, out),
                            b, ns, hp * wp, _stream(pa.device))
    if err != 0:
        raise RuntimeError(f'sum_shots launch failed: CUDA error {err}')
    launches['sum_shots'] += 1
    return tuple(out)


def tape_chunk(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz):
    """The replay of one chunk into its tape: for CUDA tensors the CUDA
    kernel ``tape_step``, or for a field past its size limit
    (:func:`pick_ranks`) ``tape_step_stream``, or for a field past that
    one's (:func:`pick_stream`) ``tape_step_global``; for CPU tensors
    :func:`tape_chunk_plain`. Returns the tape (chunk + 1, B, ns, Hp, Wp),
    slot i = s_{i-1}."""
    if p0.device.type == 'cpu':
        return tape_chunk_plain(p0, p1, alpha, t1, t2, inj, src_chunk,
                                isz=isz)
    if p0.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0.device}')
    return _tape_chunk_kernel(p0, p1, alpha, t1, t2, inj, src_chunk, isz=isz)


@on_device_of(0)
def _tape_chunk_kernel(p0, p1, alpha, t1, t2, inj, src_chunk, *, isz):
    b, ns, hp, wp = _check_args({'p0': p0, 'p1': p1}, alpha, t1, t2,
                                src_chunk, isz=isz, inj=inj)
    chunk = src_chunk.shape[0]
    if chunk < 1:
        raise ValueError('a chunk takes at least one step')
    lib = _load()
    tape = torch.empty((chunk + 1, b, ns, hp, wp), device=p0.device,
                       dtype=torch.float32)
    ranks = pick_ranks(hp, wp)
    plan = pick_stream(hp, wp) if ranks is None else None
    if plan is not None:
        err = lib.rdt_tape_chunk_stream(
            _ptr(tape), _ptr(p0), _ptr(p1), _ptr(alpha), _ptr(t1), _ptr(t2),
            _ptr(inj), _ptr(src_chunk), b, ns, hp, wp, isz, chunk, *plan,
            _stream(p0.device))
        if err != 0:
            raise RuntimeError(f'tape_step_stream launch failed: CUDA error '
                               f'{err}')
        launches['tape_step_stream'] += 1
        last_ranks['tape_step_stream'] = plan[0]
        return tape
    if ranks is None:
        err = lib.rdt_tape_chunk_global(
            _ptr(tape), _ptr(p0), _ptr(p1), _ptr(alpha), _ptr(t1), _ptr(t2),
            _ptr(inj), _ptr(src_chunk), b, ns, hp, wp, isz, chunk,
            _stream(p0.device))
        if err != 0:
            raise RuntimeError(f'tape_step_global launch failed: CUDA error '
                               f'{err}')
        launches['tape_step_global'] += max(chunk - 1, 1)
        return tape
    err = lib.rdt_tape_chunk(
        _ptr(tape), _ptr(p0), _ptr(p1), _ptr(alpha), _ptr(t1), _ptr(t2),
        _ptr(inj), _ptr(src_chunk), b, ns, hp, wp, isz, chunk, ranks,
        _stream(p0.device))
    if err != 0:
        raise RuntimeError(f'tape_step launch failed: CUDA error {err}')
    launches['tape_step'] += 1
    last_ranks['tape_step'] = ranks
    return tape


def bwd_tape_chunk(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk, *, isz,
                   igz, g0, ng):
    """The taped adjoint of one chunk: the CUDA kernels ``bwd_tape_step``
    and ``sum_shots`` for CUDA tensors, :func:`bwd_tape_chunk_plain` for
    CPU tensors. Returns (gp0, gp1, galpha, gt1, gt2, ginj)."""
    if gp0o.device.type == 'cpu':
        return bwd_tape_chunk_plain(tape, gp0o, gp1o, grec, alpha, t1, t2,
                                    src_chunk, isz=isz, igz=igz, g0=g0,
                                    ng=ng)
    if gp0o.device.type != 'cuda':
        raise ValueError(f'unsupported device {gp0o.device}')
    return _bwd_tape_chunk_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2,
                                  src_chunk, isz=isz, igz=igz, g0=g0, ng=ng)


def bwd_tape_steps(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk, *, isz,
                   igz, g0, ng):
    """The steps of the taped adjoint of one chunk, without the shot sums:
    the CUDA kernel ``bwd_tape_step`` for CUDA tensors,
    :func:`bwd_tape_steps_plain` for CPU tensors. Returns (gp0, gp1, pa,
    p1, p2, ginj), the alpha, t1 and t2 cotangents per shot."""
    if gp0o.device.type == 'cpu':
        return bwd_tape_steps_plain(tape, gp0o, gp1o, grec, alpha, t1, t2,
                                    src_chunk, isz=isz, igz=igz, g0=g0,
                                    ng=ng)
    if gp0o.device.type != 'cuda':
        raise ValueError(f'unsupported device {gp0o.device}')
    return _bwd_tape_steps_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2,
                                  src_chunk, isz=isz, igz=igz, g0=g0, ng=ng)


def _bwd_tape_chunk_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                           *, isz, igz, g0, ng):
    return _bwd_tape_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                            isz=isz, igz=igz, g0=g0, ng=ng, shot_sums=True)


def _bwd_tape_steps_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                           *, isz, igz, g0, ng):
    return _bwd_tape_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk,
                            isz=isz, igz=igz, g0=g0, ng=ng, shot_sums=False)


@on_device_of(0)
def _bwd_tape_kernel(tape, gp0o, gp1o, grec, alpha, t1, t2, src_chunk, *,
                     isz, igz, g0, ng, shot_sums):
    """One library call: the blocked steps and, with ``shot_sums``, the
    chunk's ``sum_shots`` launch; returns as :func:`_bwd_reverse_kernel`."""
    b, ns, hp, wp = _check_args({'gp0o': gp0o, 'gp1o': gp1o}, alpha, t1, t2,
                                src_chunk, isz=isz, igz=igz, g0=g0, ng=ng)
    chunk = src_chunk.shape[0]
    dev = gp0o.device
    _check('tape', tape, (chunk + 1, b, ns, hp, wp), dev)
    _check('grec', grec, (b, ns, chunk, ng), dev)
    unroll = pick_blocking('bwd_tape_step', hp, wp)[0]
    lib = _load()
    # (u, v) written by the groups in turn to x and y; the per-shot sums of
    # the alpha, t1, t2 cotangents; the injection row's.
    x = [torch.empty_like(gp0o) for _ in range(2)]
    y = [torch.empty_like(gp0o) for _ in range(2)]
    parts, sums, sum_ptrs = _adjoint_sums(gp0o, shot_sums)
    ginj = gp0o.new_zeros((b, ns, 1, wp))
    err = lib.rdt_bwd_tape_chunk(
        _ptr(gp0o), _ptr(gp1o), _ptr(tape), *map(_ptr, x + y),
        *map(_ptr, parts), _ptr(ginj), *sum_ptrs, _ptr(grec), _ptr(alpha),
        _ptr(t1), _ptr(t2), _ptr(src_chunk), b, ns, hp, wp, isz, igz, g0, ng,
        chunk, unroll, _stream(dev))
    if err != 0:
        raise RuntimeError(f'bwd_tape_step launch failed: CUDA error {err}')
    groups = -(-chunk // unroll)
    launches['bwd_tape_step'] += groups
    last_unroll['bwd_tape_step'] = unroll
    if shot_sums:
        launches['sum_shots'] += 1
    out = x if groups % 2 else y
    return (out[0], out[1], *(sums or parts), ginj)


_KERNEL_IDS = {'fwd_step': 0, 'bwd_reverse_step': 1, 'tape_step': 2,
               'bwd_tape_step': 3, 'sum_shots': 4, 'tape_step_global': 5,
               'tape_step_stream': 6}


def kernel_info(name: str, hp: int = 0, wp: int = 0):
    """Registers per thread, local (spill) bytes per thread and resident
    blocks per SM of kernel ``name`` on the current card, at its launch
    configuration (CUDA's function attributes and occupancy calculator);
    for ``tape_step`` and ``tape_step_stream`` (the instantiation
    :func:`pick_stream` picks) as launched for an ``hp`` x ``wp`` field,
    with its blocks per cluster (``ranks``) and the clusters that can be
    resident at once (``clusters``; 0 for the other kernels), and for
    ``tape_step_stream`` the coefficient planes it keeps in shared memory
    (``planes``)."""
    vals = [ctypes.c_int() for _ in range(5)]
    err = _load().rdt_kernel_info(_KERNEL_IDS[name], hp, wp,
                                  *map(ctypes.byref, vals))
    if err != 0:
        raise RuntimeError(f'kernel_info({name!r}) failed: CUDA error {err}')
    info = dict(zip(('regs', 'local_bytes', 'blocks_per_sm', 'ranks',
                     'clusters'), (v.value for v in vals)))
    if name == 'tape_step_stream':
        info['planes'] = pick_stream(hp, wp)[1]
    return info


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


class ShotShardedChunk(torch.autograd.Function):
    """One chunk of :class:`StencilChunk` with the shots split over shot
    shards: ``shards`` is a list of ``(device, lo, hi, alpha, t1, t2, inj)``,
    each shard's shots [lo, hi) with detached copies of the coefficients
    and its rows of the injection field on its device, and ``carries`` the
    shards' (p0, p1) in turn. Each shard steps its own fields with the
    kernels on its device; the receiver rows are gathered on the
    coefficients' device. The backward runs each shard's adjoint steps
    (``bwd_reverse_steps``, or ``tape_chunk`` and ``bwd_tape_steps``) into
    per-shot coefficient cotangents, gathers those on the coefficients'
    device and sums all the shots there with one ``sum_shots``, in shot
    order: every output is the unsharded chunk's bit for bit."""

    @staticmethod
    def forward(ctx, alpha, t1, t2, inj, src_chunk, shards, geo, mode,
                *carries):
        isz, igz, g0, ng = geo
        outs, recs, saved = [], [], []
        for k, (dev, lo, hi, a, c1, c2, inj_s) in enumerate(shards):
            p0, p1 = carries[2 * k], carries[2 * k + 1]
            p0o, p1o, r = fwd_chunk(p0, p1, a, c1, c2, inj_s,
                                    src_chunk.to(dev), isz=isz, igz=igz,
                                    g0=g0, ng=ng)
            saved += [p0o, p1o] if mode == 'reverse' else [p0, p1]
            outs += [p0o, p1o]
            recs.append(r.to(alpha.device))
        ctx.save_for_backward(src_chunk, *saved)
        ctx.shards, ctx.geo, ctx.mode = shards, geo, mode
        return (torch.cat(recs, dim=1), *outs)

    @staticmethod
    def backward(ctx, grec, *gcarries):
        src_chunk, *saved = ctx.saved_tensors
        isz, igz, g0, ng = ctx.geo
        geo = dict(isz=isz, igz=igz, g0=g0, ng=ng)
        home = grec.device
        parts, ginj, gout = ([], [], []), [], []
        for k, (dev, lo, hi, a, c1, c2, inj_s) in enumerate(ctx.shards):
            s0, s1 = saved[2 * k], saved[2 * k + 1]
            gp0o, gp1o = (g.contiguous() for g in gcarries[2 * k:2 * k + 2])
            grec_s = grec[:, lo:hi].to(dev).contiguous()
            src = src_chunk.to(dev)
            if ctx.mode == 'reverse':
                out = bwd_reverse_steps(s0, s1, gp0o, gp1o, grec_s, a, c1, c2,
                                        inj_s, src, **geo)
            else:
                tape = tape_chunk(s0, s1, a, c1, c2, inj_s, src, isz=isz)
                out = bwd_tape_steps(tape, gp0o, gp1o, grec_s, a, c1, c2,
                                     src, **geo)
            gout += out[:2]
            for part, t in zip(parts, out[2:5]):
                part.append(t.to(home))
            ginj.append(out[5].to(home))
        sums = sum_shots(*(torch.cat(p, dim=1).contiguous() for p in parts))
        return (*sums, torch.cat(ginj, dim=1), None, None, None, None, *gout)


def stencil_chunk_fn(*, alpha, temp1, temp2, beta_pts, geom, chunk,
                     mode=None, shot_shards=None):
    """Adapter with the (carry, src_chunk) -> (carry, recs) signature of
    the solver's chunk loop, ``recs`` as (B, ns, chunk, ng); counterpart
    of ``pallas_chunk_fn`` (``red_diffeq_tpu/ops/stencil.py:801-827``).
    ``mode=None`` takes the adjoint the t2 guard picks
    (:func:`resolve_run_config`). ``shot_shards``, a list of (device, lo,
    hi), splits the shots over those devices (:class:`ShotShardedChunk`);
    the carry is then each shard's (p0, p1) in turn."""
    if not geom.receivers_contiguous:
        raise NotImplementedError(
            'the kernel backend requires a contiguous receiver line; '
            "use backend='plain' for scattered receivers")
    mode, _ = resolve_run_config(geom, chunk, mode)
    wp = alpha.shape[-1]
    inj = build_injection_field(beta_pts, geom.isx, wp).contiguous()
    geo = (geom.isz, geom.igz, geom.igx[0], geom.ng)
    alpha, temp1, temp2 = (c.contiguous() for c in (alpha, temp1, temp2))

    if shot_shards is not None:
        shards = [(dev, lo, hi, *(c.detach().to(dev) for c in (
            alpha, temp1, temp2)), inj[:, lo:hi].detach().to(dev).contiguous())
            for dev, lo, hi in shot_shards]

        def chunk_fn(carry, src_chunk):
            recs, *carry = ShotShardedChunk.apply(
                alpha, temp1, temp2, inj, src_chunk, shards, geo, mode,
                *carry)
            return tuple(carry), recs

        return chunk_fn

    def chunk_fn(carry, src_chunk):
        p0o, p1o, recs = StencilChunk.apply(*carry, alpha, temp1, temp2,
                                            inj, src_chunk, geo, mode)
        return (p0o, p1o), recs

    return chunk_fn
