"""The blocked CUDA kernels' own source, built for the host, against their
plain PyTorch versions bit for bit.

``red_diffeq_tpu_torch/ops/csrc/stencil.cu`` cannot run here (no card, no
nvcc). g++ builds it against ``tests/cuda_host/cuda_host.h``, which runs
every thread of a block as a fiber between its barriers, and the kernel
launchers (``stencil._fwd_chunk_kernel``, ``_bwd_reverse_chunk_kernel``,
``_bwd_tape_steps_kernel``, ``_bwd_tape_chunk_kernel``,
``_sum_shots_kernel``) drive that library on CPU tensors. This holds the
temporal blocking itself (windows, wrapped halos, shrinking regions, short
last groups, own-cell sums, ping-pong buffers) to the plain versions, which
the parity tests hold to the JAX package. Both sides round every fp32
operation alone (g++ -ffp-contract=off, nvcc -fmad=false), so the
comparison is exact. The card's compiler, occupancy and speed are
``chip_smoke.py``'s to check.
"""
import shutil

import numpy as np
import pytest
import torch

from cuda_host.host_build import build_host_library, use_host_library
from red_diffeq_tpu_torch.ops import stencil


@pytest.fixture(scope='module')
def host_library(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('g++ is not available to build the kernels for the host')
    return build_host_library(stencil._CSRC,
                              tmp_path_factory.mktemp('cuda_host'), gxx)


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    """The stencil module with its library swapped for the host build."""
    return use_host_library(monkeypatch, stencil, host_library)


def _inputs(seed, b, ns, hp, wp, chunk, isz, igz, g0, ng):
    rng = np.random.RandomState(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    alpha = torch.from_numpy(
        rng.uniform(0.04, 0.09, (b, 1, hp, wp)).astype(np.float32))
    t2 = torch.from_numpy(
        rng.uniform(0.9, 1.0, (b, 1, hp, wp)).astype(np.float32))
    t1 = 2.0 - 5.0 * alpha - (1.0 - t2)
    inj = torch.zeros(b, ns, 1, wp)
    for s in range(ns):
        inj[:, s, 0, (3 * s + 1) % wp] = torch.from_numpy(
            rng.uniform(0.1, 0.5, b).astype(np.float32))
    return dict(p0=f(b, ns, hp, wp), p1=f(b, ns, hp, wp),
                gp0=f(b, ns, hp, wp), gp1=f(b, ns, hp, wp), alpha=alpha,
                t1=t1, t2=t2, inj=inj, src=f(chunk),
                grec=f(b, ns, chunk, ng))


# (B, ns, Hp, Wp, chunk, isz, igz, g0, ng): one tile smaller than the
# window (halos wrap over the field), several tiles with ragged edges and
# a short last group (chunk 7 at U=4), fields small enough for U=3, U=2
# and U=1 (each its own instantiation of bwd_tape_step).
CASES = [(2, 2, 24, 28, 20, 9, 10, 8, 12),
         (1, 3, 70, 90, 7, 61, 62, 60, 12),
         (1, 2, 14, 15, 9, 3, 12, 1, 13),
         (1, 2, 9, 12, 3, 0, 8, 0, 12),
         (2, 1, 6, 9, 5, 2, 4, 0, 9)]


@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[2]}x{c[3]}c{c[4]}')
def test_blocked_kernels_match_plain_versions(host_kernels, case):
    b, ns, hp, wp, chunk, isz, igz, g0, ng = case
    d = _inputs(hp * wp + chunk, *case)
    geo = dict(isz=isz, igz=igz, g0=g0, ng=ng)
    coef = (d['alpha'], d['t1'], d['t2'], d['inj'], d['src'])
    want = stencil.fwd_chunk_plain(d['p0'], d['p1'], *coef, **geo)
    got = stencil._fwd_chunk_kernel(d['p0'], d['p1'], *coef, **geo)
    for name, g, w in zip(('p0', 'p1', 'recs'), got, want):
        assert torch.equal(g, w), name
    args = (want[0], want[1], d['gp0'], d['gp1'], d['grec'], *coef)
    want = stencil.bwd_reverse_chunk_plain(*args, **geo)
    got = stencil._bwd_reverse_chunk_kernel(*args, **geo)
    for name, g, w in zip(('gp0', 'gp1', 'galpha', 'gt1', 'gt2', 'ginj'),
                          got, want):
        assert torch.equal(g, w), name
    u = stencil.pick_blocking('fwd_step', hp, wp)[0]
    assert stencil.launches['fwd_step'] == -(-chunk // u)
    assert stencil.launches['bwd_reverse_step'] == -(-chunk // u)
    assert stencil.launches['sum_shots'] == 1
    assert stencil.last_unroll['fwd_step'] == u
    assert stencil.last_unroll['bwd_reverse_step'] == u


@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[2]}x{c[3]}c{c[4]}')
def test_blocked_tape_adjoint_matches_plain_version(host_kernels, case):
    """``bwd_tape_step`` (blocked) and the chunk's ``sum_shots`` against
    the plain versions on a tape from ``tape_chunk_plain``: every output
    bit for bit, the per-shot sums and their shot sums alike, with
    ceil(chunk/U) launches and one shot sum per chunk."""
    b, ns, hp, wp, chunk, isz, igz, g0, ng = case
    d = _inputs(hp * wp + chunk + 1, *case)
    geo = dict(isz=isz, igz=igz, g0=g0, ng=ng)
    tape = stencil.tape_chunk_plain(d['p0'], d['p1'], d['alpha'], d['t1'],
                                    d['t2'], d['inj'], d['src'], isz=isz)
    args = (tape, d['gp0'], d['gp1'], d['grec'], d['alpha'], d['t1'],
            d['t2'], d['src'])
    names = ('gp0', 'gp1', 'pa', 'pt1', 'pt2', 'ginj')
    want = stencil.bwd_tape_steps_plain(*args, **geo)
    got = stencil._bwd_tape_steps_kernel(*args, **geo)
    for name, g, w in zip(names, got, want):
        assert torch.equal(g, w), name
    u = stencil.pick_blocking('bwd_tape_step', hp, wp)[0]
    assert stencil.launches['bwd_tape_step'] == -(-chunk // u)
    assert stencil.launches['sum_shots'] == 0
    want = stencil.bwd_tape_chunk_plain(*args, **geo)
    got = stencil._bwd_tape_chunk_kernel(*args, **geo)
    for name, g, w in zip(('gp0', 'gp1', 'galpha', 'gt1', 'gt2', 'ginj'),
                          got, want):
        assert torch.equal(g, w), name
    assert stencil.launches['bwd_tape_step'] == 2 * -(-chunk // u)
    assert stencil.launches['sum_shots'] == 1
    assert stencil.last_unroll['bwd_tape_step'] == u


@pytest.mark.parametrize('ns', [1, 5, 9])
@pytest.mark.parametrize('hw', [(16, 19), (17, 19)], ids=lambda s: f'{s[0]}x{s[1]}')
def test_sum_shots_kernel_matches_plain(host_kernels, hw, ns):
    """``sum_shots`` bit for bit, on planes of a multiple of 4 cells (16-byte
    loads across row ends) and of 17x19 cells (one cell at a time), with
    one shot, the headline's 5 and 9 (two batches of loads)."""
    g = torch.Generator().manual_seed(ns)
    parts = [torch.randn(3, ns, *hw, generator=g) for _ in range(3)]
    got = stencil._sum_shots_kernel(*parts)
    for o, p in zip(got, parts):
        assert torch.equal(o, stencil.sum_shots_plain(p))
    assert stencil.launches['sum_shots'] == 1
