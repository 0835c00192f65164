"""The stencil-layout probe: one damped-wave recursion, four x-stencil layouts.

Counterpart of ``tools/kernel_layout_probe.py``, whose four Pallas kernels
are ported to hand-written CUDA kernels in ``csrc/layout_probe.cu``:

* ``_roll_kernel`` (``:89``, ``pallas_call`` at ``:219``) becomes
  ``probe_roll``: both stencils as wrapped neighbour reads;
* ``_mxu_x_kernel`` (``:106``, at ``:226``) becomes ``probe_mxu_x``: the y
  stencil as neighbour reads, the x stencil as the dense product ``p @ D``
  with the banded circulant ``D = band_circulant(Wp)``;
* ``_mxu_xy_kernel`` (``:129``, at ``:234``) becomes ``probe_mxu_xy``:
  ``E @ p + p @ D`` with ``E = band_circulant(Hp)``, no neighbour reads.
  Both products run on the tensor cores (``mma.sync`` TF32), each
  operand split in the kernel into three TF32 parts, exactly
  (:func:`split_parts`);
* ``_halo_kernel`` (``:158``, at ``:240``) becomes ``probe_halo``: the state
  kept as (Hp, Wp + 4) with the wrap copied into 2 halo columns a side
  after every step, so x neighbours are plain offsets.

Each runs ``nt`` steps of

    p = t1*p1 - t2*p0 + alpha * L4(p1)

on ``nprog`` independent (Hp, Wp) fields, with L4 the circular 4th-order
Laplacian without its centre term and ``alpha``, ``t1``, ``t2`` one (Hp,
Wp) plane shared by every field, and returns the newest state. The TPU
kernels keep each field in VMEM for all ``nt`` steps. So do ``probe_roll``
and ``probe_halo``: one launch a call, each field in the shared memory of
a thread-block cluster, a strip of rows a block (:func:`route` picks the
cluster). Fields past that design's size limit take ``probe_roll_global``
and ``probe_halo_global``, one launch a step with the states in device
memory, chosen by size alone. The products take one launch a step.

Beside the kernels are their plain PyTorch versions (``roll_plain``,
``mxu_x_plain``, ``mxu_xy_plain``, ``halo_plain``), each in its JAX
kernel's fp32 grouping; the products are ``torch.matmul`` (full fp32, as
``Precision.HIGHEST``: leave ``torch.backends.cuda.matmul.allow_tf32``
False), which the kernels' split-TF32 sums match to about 2^-24 a
term. The wrapper :func:`run_variant` takes the plain version only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""
import ctypes
from pathlib import Path

import numpy as np
import torch

from . import stencil
from .stencil import C1, C2, C3, laplacian4

VARIANTS = ('roll', 'mxu_x', 'mxu_xy', 'halo')
KERNELS = {v: f'probe_{v}' for v in VARIANTS}
# The one-launch-a-step kernels of roll and halo, for fields past the
# resident kernels' size limit.
GLOBAL_KERNELS = {v: f'probe_{v}_global' for v in ('roll', 'halo')}
ROUTES = ('resident', 'global')

# Kernel launches made by run_variant, by kernel: one a call for probe_roll
# and probe_halo, one a step for the others.
launches = dict.fromkeys([*KERNELS.values(), *GLOBAL_KERNELS.values()], 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def band_circulant(n: int) -> np.ndarray:
    """(n, n) symmetric circulant D with D[i, i±1 mod n] = C2 and
    D[i, i±2 mod n] = C3: (p @ D)[., j] = x-direction 4th-order
    second-difference (without the C1 center, which the time recursion
    folds into t1)."""
    d = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for off, c in ((1, C2), (-1, C2), (2, C3), (-2, C3)):
        d[idx, (idx + off) % n] += c
    return d


def make_problem(nprog, hp, wp, seed=0):
    """The probe's workload as numpy float32 arrays (p0, p1 of (nprog, hp,
    wp); alpha, t1, t2 of (hp, wp)): velocities in [1500, 4000] m/s at
    dx=10, dt=1e-3 (CFL-safe) and a sponge-style damping ring, with random
    start states."""
    rng = np.random.RandomState(seed)
    v = 1500.0 + 2500.0 * rng.rand(hp, wp).astype(np.float32)
    alpha = (v * 1e-3 / 10.0) ** 2
    edge = 120
    ramp = (np.maximum(0, edge - np.minimum.outer(
        np.minimum(np.arange(hp), hp - 1 - np.arange(hp)),
        np.minimum(np.arange(wp), wp - 1 - np.arange(wp)))) / edge) ** 2
    kappa = 3.0 * 1500.0 * np.log(1e7) / (2 * (edge - 1) * 10.0) * ramp
    t1 = 2.0 + 2.0 * C1 * alpha - kappa * 1e-3
    t2 = 1.0 - kappa * 1e-3
    p0 = 1e-3 * rng.randn(nprog, hp, wp).astype(np.float32)
    p1 = 1e-3 * rng.randn(nprog, hp, wp).astype(np.float32)
    return (p0, p1, alpha, t1.astype(np.float32), t2.astype(np.float32))


# ----------------------------------------------------------------------
# Plain versions, step for step the JAX kernels' arithmetic.
# ----------------------------------------------------------------------

def _lap_y(p):
    return (C2 * (torch.roll(p, 1, -2) + torch.roll(p, -1, -2))
            + C3 * (torch.roll(p, 2, -2) + torch.roll(p, -2, -2)))


_CIRCULANTS = {}


def circulant(n, device, rows=False):
    """:func:`band_circulant` (n, n) as a tensor on ``device``, made once a
    size and device (no host copy inside a captured CUDA graph); with
    ``rows`` as the product kernels read it, (n, round4(n)) with zero
    columns past n."""
    key = (n, str(device), rows)
    if key not in _CIRCULANTS:
        d = np.zeros((n, round4(n) if rows else n), np.float32)
        d[:, :n] = band_circulant(n)
        _CIRCULANTS[key] = torch.from_numpy(d).to(device)
    return _CIRCULANTS[key]


def split_parts(x: torch.Tensor):
    """The finite float32 tensor ``x`` as a sum of three TF32 values,
    largest first, as the product kernels split their operands: the first
    ``x`` rounded to 8 significant bits (to nearest, ties away from zero,
    on the magnitude's 16 dropped bits), the second what it leaves out
    (exact in fp32) cut to 8 bits, the third the rest. They sum to ``x``
    exactly."""
    def bits(t):
        return t.contiguous().view(torch.int32)

    hi = ((bits(x) + 0x8000) & ~0xffff).view(torch.float32)
    rest = x - hi
    mid = (bits(rest) & ~0xffff).view(torch.float32)
    return hi, mid, rest - mid


def round4(n: int) -> int:
    """Row length, in floats, of a matrix the product kernels read: ``n``
    rounded up to 16 bytes."""
    return (n + 3) // 4 * 4


# The part products the product kernels add each 8-deep step of the depth
# (``csrc/layout_probe.cu``), i of the state's :func:`split_parts` and j of
# the constant's: every pair with i + j <= 2, smallest first, the main one
# (0, 0) last and into a sum of its own.
PART_PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _steps(p0, p1, alpha, t1, t2, nt, lap):
    for _ in range(nt):
        p0, p1 = p1, t1 * p1 - t2 * p0 + alpha * lap(p1)
    return p1


def roll_plain(p0, p1, alpha, t1, t2, *, nt):
    return _steps(p0, p1, alpha, t1, t2, nt, laplacian4)


def mxu_x_plain(p0, p1, alpha, t1, t2, *, nt):
    d = circulant(p1.shape[-1], p1.device)
    return _steps(p0, p1, alpha, t1, t2, nt,
                  lambda p: _lap_y(p) + torch.matmul(p, d))


def mxu_xy_plain(p0, p1, alpha, t1, t2, *, nt):
    d = circulant(p1.shape[-1], p1.device)
    e = circulant(p1.shape[-2], p1.device)
    return _steps(p0, p1, alpha, t1, t2, nt,
                  lambda p: torch.matmul(e, p) + torch.matmul(p, d))


def halo_pad(p):
    """(..., Wp) -> (..., Wp + 4): the wrap copied into 2 columns a side."""
    return torch.cat([p[..., -2:], p, p[..., :2]], dim=-1)


def halo_plain(p0, p1, alpha, t1, t2, *, nt):
    """Two (nprog, Hp, Wp + 4) states in turn, as the JAX kernel keeps
    them: step u reads p1 from state (u + 1) % 2 and p0 from state u % 2,
    and writes the new state, halo columns included, over p0's."""
    wp = p1.shape[-1]
    state = [halo_pad(p0), halo_pad(p1)]
    for u in range(nt):
        src, dst = state[(u + 1) % 2], state[u % 2]
        c = src[..., 2:wp + 2]
        xsum = (C2 * (src[..., 1:wp + 1] + src[..., 3:wp + 3])
                + C3 * (src[..., 0:wp] + src[..., 4:wp + 4]))
        p = t1 * c - t2 * dst[..., 2:wp + 2] + alpha * (_lap_y(c) + xsum)
        state[u % 2] = halo_pad(p)
    return state[(nt - 1) % 2][..., 2:wp + 2].contiguous()


PLAIN = {'roll': roll_plain, 'mxu_x': mxu_x_plain, 'mxu_xy': mxu_xy_plain,
         'halo': halo_plain}


def plain_variant(variant, p0, p1, alpha, t1, t2, *, nt):
    """``nt`` steps of ``variant`` by its plain PyTorch version."""
    if variant not in PLAIN:
        raise ValueError(f'unknown variant {variant!r}; expected one of '
                         f'{VARIANTS}')
    return PLAIN[variant](p0, p1, alpha, t1, t2, nt=nt)


# ----------------------------------------------------------------------
# The CUDA library, built by stencil.build from csrc/layout_probe.cu.
# ----------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / 'csrc' / 'layout_probe.cu'
_lib = None
# route()'s answers for the loaded library, made once a shape (no
# occupancy query while a CUDA graph captures a call).
_ROUTES = {}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(stencil.build(source=_CSRC)))
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.rdt_probe_resident.argtypes = [i] + [p] * 6 + [i] * 6 + [p]
        lib.rdt_probe_plan.argtypes = [i] * 4 + [ip] * 2
        lib.rdt_probe_roll_global.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.rdt_probe_halo_global.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.rdt_probe_mxu.argtypes = [i] + [p] * 9 + [i] * 4 + [p]
        lib.rdt_probe_info.argtypes = [i] + [ip] * 3
        lib.rdt_probe_resident_info.argtypes = [i] * 4 + [ip] * 6
        for name in ('rdt_probe_resident', 'rdt_probe_plan',
                     'rdt_probe_roll_global', 'rdt_probe_halo_global',
                     'rdt_probe_mxu', 'rdt_probe_info',
                     'rdt_probe_resident_info'):
            getattr(lib, name).restype = i
        _ROUTES.clear()
        _lib = lib
    return _lib


def route(variant, nprog, hp, wp):
    """How :func:`run_variant` runs ``variant`` on ``nprog`` fields of
    (hp, wp) on the card: a dict with the ``kernel``, its ``route``
    ('resident': one launch a call, the fields in the shared memory of
    thread-block clusters; 'global': one launch a step), and for the
    resident route the blocks a cluster (``ranks``), ``fields_per_cluster``
    and ``clusters`` (None otherwise). The resident kernels' picker
    (``rdt_probe_plan``) decides by the field's size alone: a cluster of up
    to 16 blocks, one strip of rows a block, the fewest fields a cluster
    that fill one wave of the clusters the card holds at once."""
    rec = dict(kernel=KERNELS[variant], route='global', ranks=None,
               fields_per_cluster=None, clusters=None)
    if variant not in GLOBAL_KERNELS:
        return rec
    lib, key = _load(), (variant, nprog, hp, wp)
    if key not in _ROUTES:
        ranks, per = ctypes.c_int(), ctypes.c_int()
        err = lib.rdt_probe_plan(int(variant == 'halo'), nprog, hp, wp,
                                 ctypes.byref(ranks), ctypes.byref(per))
        if err != 0:
            raise RuntimeError(f'rdt_probe_plan failed: CUDA error {err}')
        if ranks.value == 0:
            rec['kernel'] = GLOBAL_KERNELS[variant]
        else:
            rec.update(route='resident', ranks=ranks.value,
                       fields_per_cluster=per.value,
                       clusters=-(-nprog // per.value))
        _ROUTES[key] = rec
    return dict(_ROUTES[key])


def kernel_info(kernel, nprog=0, hp=0, wp=0):
    """Registers per thread, local (spill) bytes per thread and resident
    blocks per SM of the probe kernel named ``kernel`` on the current card,
    at its launch configuration (CUDA's function attributes and occupancy
    calculator). ``probe_roll`` and ``probe_halo`` as launched for
    ``nprog`` fields of (hp, wp), with their ``ranks``,
    ``fields_per_cluster`` and the ``clusters`` resident at once."""
    lib = _load()
    if kernel in (KERNELS['roll'], KERNELS['halo']):
        vals = [ctypes.c_int() for _ in range(6)]
        err = lib.rdt_probe_resident_info(int(kernel == KERNELS['halo']),
                                          nprog, hp, wp,
                                          *map(ctypes.byref, vals))
        keys = ('regs', 'local_bytes', 'blocks_per_sm', 'ranks',
                'fields_per_cluster', 'clusters')
    else:
        ids = (GLOBAL_KERNELS['roll'], KERNELS['mxu_x'], KERNELS['mxu_xy'],
               GLOBAL_KERNELS['halo'])
        if kernel not in ids:
            raise ValueError(f'unknown probe kernel {kernel!r}')
        vals = [ctypes.c_int() for _ in range(3)]
        err = lib.rdt_probe_info(ids.index(kernel), *map(ctypes.byref, vals))
        keys = ('regs', 'local_bytes', 'blocks_per_sm')
    if err != 0:
        raise RuntimeError(f'kernel_info({kernel!r}) failed: CUDA error '
                           f'{err}')
    return dict(zip(keys, (v.value for v in vals)))


def _rows_of(p, ld):
    """(..., Wp) -> (..., ld): ``p`` with its rows padded to ``ld`` floats
    (zeros past Wp)."""
    out = p.new_zeros(*p.shape[:-1], ld)
    out[..., :p.shape[-1]] = p
    return out


def run_variant(variant, p0, p1, alpha, t1, t2, *, nt, route_to=None):
    """``nt`` steps of ``variant`` from the states p0, p1 (nprog, Hp, Wp)
    with the planes alpha, t1, t2 (Hp, Wp); returns the newest state. The
    CUDA kernel of :func:`route` for CUDA tensors, :func:`plain_variant`
    for CPU tensors. ``route_to`` ('resident' or 'global') overrides the
    route of roll and halo, to time one against the other; a field the
    resident kernels cannot take raises there."""
    if p0.device.type == 'cpu':
        return plain_variant(variant, p0, p1, alpha, t1, t2, nt=nt)
    if p0.device.type != 'cuda':
        raise ValueError(f'unsupported device {p0.device}')
    return _run_variant_kernel(variant, p0, p1, alpha, t1, t2, nt=nt,
                               route_to=route_to)


@stencil.on_device_of(1)
def _run_variant_kernel(variant, p0, p1, alpha, t1, t2, *, nt,
                        route_to=None):
    if variant not in KERNELS:
        raise ValueError(f'unknown variant {variant!r}; expected one of '
                         f'{VARIANTS}')
    if route_to is not None and (route_to not in ROUTES
                                 or variant not in GLOBAL_KERNELS):
        raise ValueError(f'{variant!r} has no route {route_to!r}')
    if p0.dim() != 3:
        raise ValueError(f'states must be (nprog, Hp, Wp), got shape '
                         f'{tuple(p0.shape)}')
    nprog, hp, wp = p0.shape
    dev = p0.device
    stencil._check('p0', p0, p0.shape, dev)
    stencil._check('p1', p1, p0.shape, dev)
    for name, t in (('alpha', alpha), ('t1', t1), ('t2', t2)):
        stencil._check(name, t, (hp, wp), dev)
    if hp < 5 or wp < 5:
        raise ValueError('the 4th-order stencil needs a field of at least '
                         '5x5')
    if nt < 1:
        raise ValueError('the probe takes at least one step')
    if nprog > 65535:
        raise ValueError('more than 65535 fields are not supported')
    lib = _load()
    ptr, st = stencil._ptr, stencil._stream(dev)
    plan = route(variant, nprog, hp, wp)
    if route_to == 'resident' and plan['route'] != 'resident':
        raise ValueError(f'{hp}x{wp} fields are past the size limit of '
                         f'{KERNELS[variant]}')
    if route_to == 'global':
        plan = dict(plan, kernel=GLOBAL_KERNELS[variant], route='global')
    kernel, n = plan['kernel'], nt
    if plan['route'] == 'resident':
        out = torch.empty_like(p0)
        err = lib.rdt_probe_resident(int(variant == 'halo'), ptr(p0),
                                     ptr(p1), ptr(out), ptr(alpha), ptr(t1),
                                     ptr(t2), nprog, hp, wp, nt,
                                     plan['ranks'],
                                     plan['fields_per_cluster'], st)
        n = 1
    elif variant == 'halo':
        # The two states, (nprog, Hp, Wp + 4) each; step u writes state
        # u % 2, so the newest is state 0 after an odd count.
        s = [halo_pad(p0), halo_pad(p1)]
        err = lib.rdt_probe_halo_global(ptr(s[0]), ptr(s[1]), ptr(alpha),
                                        ptr(t1), ptr(t2), nprog, hp, wp, nt,
                                        st)
        out = s[(nt - 1) % 2][..., 2:wp + 2].contiguous()
    else:
        # Step n writes x when n is even and y when it is odd, from step 2
        # on over the older of the two states it reads.
        if variant == 'roll':
            x, y = torch.empty_like(p0), torch.empty_like(p0)
            err = lib.rdt_probe_roll_global(ptr(p0), ptr(p1), ptr(x), ptr(y),
                                            ptr(alpha), ptr(t1), ptr(t2),
                                            nprog, hp, wp, nt, st)
        else:
            # The products read whole 16-byte rows: states with rows of
            # round4(Wp) floats.
            xy = variant == 'mxu_xy'
            d = circulant(wp, dev, rows=True)
            e = circulant(hp, dev, rows=True) if xy else d
            s0, s1 = _rows_of(p0, round4(wp)), _rows_of(p1, round4(wp))
            x, y = torch.empty_like(s0), torch.empty_like(s0)
            err = lib.rdt_probe_mxu(int(xy), ptr(s0), ptr(s1), ptr(x),
                                    ptr(y), ptr(alpha), ptr(t1), ptr(t2),
                                    ptr(d), ptr(e), nprog, hp, wp, nt, st)
        out = x if nt % 2 else y
        if variant != 'roll':
            out = out[..., :wp].contiguous()
    if err != 0:
        raise RuntimeError(f'{kernel} launch failed: CUDA error {err}')
    launches[kernel] += n
    return out
