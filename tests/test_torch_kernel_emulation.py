"""The blocked CUDA kernels' own source, built for the host, against their
plain PyTorch versions bit for bit.

``red_diffeq_tpu_torch/ops/csrc/stencil.cu`` cannot run here (no card, no
nvcc). g++ builds it against ``tests/cuda_host/cuda_host.h``, which runs
every thread of a block as a fiber between its barriers, and the kernel
launchers (``stencil._fwd_chunk_kernel``, ``_bwd_reverse_chunk_kernel``,
``_bwd_tape_steps_kernel``, ``_bwd_tape_chunk_kernel``,
``_sum_shots_kernel``, ``_tape_chunk_kernel`` with each of its three
routes) drive that library on CPU tensors. This holds the temporal
blocking itself (windows, wrapped halos, shrinking regions, short last
groups, own-cell sums, ping-pong buffers) and
the tape replay's thread-block clusters (strips, halo rows written into
the neighbours' shared memory, cluster barriers) to the plain versions,
which the parity tests hold to the JAX package. The harness runs a
cluster's blocks as one group of fibers, each block with its own shared
memory, and lets block 0 run as far ahead as its barriers allow, so a
missing block or cluster barrier shows as a wrong cell. Both sides round every fp32
operation alone (g++ -ffp-contract=off, nvcc -fmad=false), so the
comparison is exact. The card's compiler, occupancy and speed are
``chip_smoke.py``'s to check.
"""
import contextlib
import hashlib
import importlib.util
import shutil
from pathlib import Path

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
# and U=1 (each its own instantiation of bwd_tape_step); a wide field
# (Hp < Wp, three column tiles of fwd_step with a partial last one), the
# aspect of the Marmousi and Overthrust presets' 310x430.
CASES = [(2, 2, 24, 28, 20, 9, 10, 8, 12),
         (1, 2, 24, 106, 20, 9, 10, 8, 60),
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


# (B, ns, Hp, Wp, chunk, isz, ranks): the library's pick of blocks per
# cluster for each field (16 from 32 rows, 8, 4, 2), strips whose rows do
# not divide evenly (37 rows in 16), several bands of rows a block (128
# rows: 8 a strip), a field wider than a block's 1024 threads, non-square
# fields (one at the 310x430 presets' aspect), the source on a strip's
# first and last row, chunks of 20, 7 and 1 step; then clusters of 1 and 2
# blocks forced on fields that would take more (a block its own neighbour,
# or both neighbours the same block).
TAPE_CASES = [(1, 2, 37, 10, 20, 20, None), (1, 1, 128, 20, 7, 70, None),
              (2, 1, 17, 13, 20, 3, None), (1, 1, 9, 8, 7, 8, None),
              (1, 2, 6, 9, 5, 2, None), (1, 1, 6, 1030, 3, 3, None),
              (1, 1, 8, 7, 1, 2, None), (1, 1, 12, 11, 7, 4, 1),
              (1, 2, 9, 6, 20, 5, 2), (1, 2, 24, 106, 20, 9, None)]


@pytest.mark.parametrize('case', TAPE_CASES,
                         ids=lambda c: f'{c[2]}x{c[3]}c{c[4]}r{c[6] or "lib"}')
def test_tape_replay_matches_plain_version(host_kernels, monkeypatch, case):
    """``tape_step`` (one launch per chunk, one field per cluster) against
    ``tape_chunk_plain``: every slot of the chunk + 1 slot tape bit for
    bit, one launch, and the blocks per cluster the wrapper handed its
    launcher."""
    b, ns, hp, wp, chunk, isz, ranks = case
    if ranks is not None:
        monkeypatch.setattr(stencil, 'pick_ranks', lambda h, w: ranks)
    d = _inputs(hp * wp + chunk + 2, b, ns, hp, wp, chunk, isz, 0, 0, 1)
    args = (d['p0'], d['p1'], d['alpha'], d['t1'], d['t2'], d['inj'],
            d['src'])
    want = stencil.tape_chunk_plain(*args, isz=isz)
    got = stencil._tape_chunk_kernel(*args, isz=isz)
    assert tuple(got.shape) == (chunk + 1, b, ns, hp, wp)
    for i in range(chunk + 1):
        np.testing.assert_array_equal(got[i].numpy(), want[i].numpy(),
                                      err_msg=f'slot {i}')
    assert stencil.launches['tape_step'] == 1
    assert stencil.last_ranks['tape_step'] == (ranks or
                                               stencil.pick_ranks(hp, wp))


# (B, ns, Hp, Wp, chunk, isz, planes): fields that tape_step would take,
# sent to tape_step_stream by forcing the route, each at a count of
# resident coefficient planes (the others streamed from device memory):
# strips whose rows do not divide evenly (37 rows in 16) with the source
# on a strip's first row, on the wrap (the field's last row, and row 0),
# two samples (each its own planes), bands of rows with a group of 4 and a
# shorter first one (100x600: one band of 6-7 rows), bands of one row
# (W=20: 32 bands), a field wider than a block's 1024 threads (two columns
# for some threads, three at 2100), chunks of 20, 7, 2 and 1 step (one
# launch that only copies the carry).
STREAM_CASES = [(1, 2, 37, 10, 20, 20, 2), (1, 1, 37, 10, 7, 36, 1),
                (2, 1, 17, 13, 20, 0, 0), (1, 1, 100, 600, 2, 50, 2),
                (1, 1, 128, 20, 7, 70, 1), (1, 1, 6, 1030, 3, 3, 2),
                (1, 1, 40, 2100, 2, 33, 0), (1, 2, 9, 6, 1, 5, 2),
                (1, 3, 9, 8, 7, 8, 0)]


@pytest.mark.parametrize('case', STREAM_CASES,
                         ids=lambda c: f'{c[2]}x{c[3]}c{c[4]}p{c[6]}')
def test_tape_replay_streamed_matches_plain_version(host_kernels,
                                                    monkeypatch, case):
    """``tape_step_stream`` (one launch per chunk, one field per cluster,
    ``planes`` of the coefficient planes in shared memory and the others
    read ahead from device memory) against ``tape_chunk_plain``: every slot
    bit for bit, one launch, ``tape_step`` and ``tape_step_global`` never,
    with the route forced through ``pick_ranks`` (None, ``tape_step``'s
    refusal) and ``pick_stream`` (the library's blocks, the case's
    planes)."""
    b, ns, hp, wp, chunk, isz, planes = case
    ranks = stencil.pick_stream(hp, wp)[0]
    monkeypatch.setattr(stencil, 'pick_ranks', lambda h, w: None)
    monkeypatch.setattr(stencil, 'pick_stream', lambda h, w: (ranks, planes))
    d = _inputs(hp * wp + chunk + 4, b, ns, hp, wp, chunk, isz, 0, 0, 1)
    args = (d['p0'], d['p1'], d['alpha'], d['t1'], d['t2'], d['inj'],
            d['src'])
    want = stencil.tape_chunk_plain(*args, isz=isz)
    got = stencil._tape_chunk_kernel(*args, isz=isz)
    assert tuple(got.shape) == (chunk + 1, b, ns, hp, wp)
    for i in range(chunk + 1):
        np.testing.assert_array_equal(got[i].numpy(), want[i].numpy(),
                                      err_msg=f'slot {i}')
    assert stencil.launches['tape_step_stream'] == 1
    assert stencil.launches['tape_step'] == 0
    assert stencil.launches['tape_step_global'] == 0
    assert stencil.last_ranks['tape_step_stream'] == ranks


# (B, ns, Hp, Wp, chunk, isz): fields the cluster instantiations would
# take, sent to tape_step_global by forcing the route: several blocks of
# 256 cells with a ragged last one, rows that wrap at the source's edge, a
# field wider than a block, chunks of 20, 7, 2 and 1 step (one launch that
# only copies the carry).
GLOBAL_TAPE_CASES = [(2, 2, 17, 13, 20, 3), (1, 3, 9, 8, 7, 8),
                     (1, 1, 6, 300, 2, 0), (1, 2, 12, 11, 1, 4)]


@pytest.mark.parametrize('case', GLOBAL_TAPE_CASES,
                         ids=lambda c: f'{c[2]}x{c[3]}c{c[4]}')
def test_tape_replay_past_the_cluster_limit_matches_plain_version(
        host_kernels, monkeypatch, case):
    """``tape_step_global`` (one launch a step over device memory, the
    route of fields past ``tape_step_stream``'s limit) against
    ``tape_chunk_plain``: every slot bit for bit, max(chunk - 1, 1)
    launches, ``tape_step`` and ``tape_step_stream`` never, with the route
    forced through both cluster pickers, ``pick_ranks`` and
    ``pick_stream``: None, their refusals."""
    b, ns, hp, wp, chunk, isz = case
    monkeypatch.setattr(stencil, 'pick_ranks', lambda h, w: None)
    monkeypatch.setattr(stencil, 'pick_stream', lambda h, w: None)
    d = _inputs(hp * wp + chunk + 3, b, ns, hp, wp, chunk, isz, 0, 0, 1)
    args = (d['p0'], d['p1'], d['alpha'], d['t1'], d['t2'], d['inj'],
            d['src'])
    want = stencil.tape_chunk_plain(*args, isz=isz)
    got = stencil._tape_chunk_kernel(*args, isz=isz)
    assert tuple(got.shape) == (chunk + 1, b, ns, hp, wp)
    for i in range(chunk + 1):
        np.testing.assert_array_equal(got[i].numpy(), want[i].numpy(),
                                      err_msg=f'slot {i}')
    assert stencil.launches['tape_step_global'] == max(chunk - 1, 1)
    assert stencil.launches['tape_step'] == 0
    assert stencil.launches['tape_step_stream'] == 0


def _route_of(hp, wp, chunk, isz):
    """The launches of one chunk's replay of an Hp x Wp field (B=1, ns=1)
    through the wrapper's own route, its tape held to the plain version bit
    for bit."""
    d = _inputs(hp + wp, 1, 1, hp, wp, chunk, isz, 0, 0, 1)
    args = (d['p0'], d['p1'], d['alpha'], d['t1'], d['t2'], d['inj'],
            d['src'])
    stencil.reset_launches()
    got = stencil._tape_chunk_kernel(*args, isz=isz)
    assert torch.equal(got, stencil.tape_chunk_plain(*args, isz=isz))
    return {k: v for k, v in stencil.launches.items() if v}


def test_tape_replay_size_limit(host_kernels):
    """Blocks per cluster as the library picks them, and the size limits:
    tape_step's strip of ceil(Hp/16) rows with its three planes must fit a
    block's shared memory, so 310x430 (Marmousi and Overthrust at nbc=120)
    and 416x416 take 16 blocks a field, while the cluster picker refuses
    420x420 (None); ``tape_step_stream`` takes it (16 blocks, alpha and t1
    in shared memory), with one plane to about 500x500 and none to
    640x640; past that (650x650) the wrapper takes ``tape_step_global``
    (one launch a step). Each route's tape is bit for bit the plain
    version's. The cluster launchers refuse a cluster size they are not
    built for, one that leaves a strip under 2 rows, a plane count past 2
    or one whose strip does not fit."""
    assert stencil.pick_ranks(310, 310) == 16
    assert stencil.pick_ranks(150, 150) == 16
    assert stencil.pick_ranks(310, 430) == 16
    assert stencil.pick_ranks(416, 416) == 16
    assert [stencil.pick_ranks(h, 9) for h in (31, 16, 15, 8, 7, 5)] == \
        [8, 8, 4, 4, 2, 2]
    assert stencil.pick_ranks(420, 420) is None
    assert stencil.pick_stream(420, 420) == (16, 2)
    assert [stencil.pick_stream(n, n) for n in (500, 600, 640, 641, 650)] == \
        [(16, 1), (16, 0), (16, 0), None, None]
    assert stencil.pick_stream(20, 4000) is None
    assert _route_of(416, 416, 2, 7) == {'tape_step': 1}
    assert _route_of(420, 420, 3, 7) == {'tape_step_stream': 1}
    assert stencil.last_ranks['tape_step_stream'] == 16
    assert _route_of(650, 650, 2, 649) == {'tape_step_global': 1}
    lib = stencil._load()
    for ranks, h in ((3, 64), (32, 64), (16, 31)):
        assert lib.rdt_tape_chunk(*[None] * 8, 1, 1, h, 9, 0, 4, ranks,
                                  None) != 0, (ranks, h)
    for ranks, planes, h, w in ((3, 2, 64, 9), (32, 2, 64, 9),
                                (16, 2, 31, 9), (16, 3, 64, 9),
                                (16, 2, 500, 500), (16, 0, 650, 650)):
        assert lib.rdt_tape_chunk_stream(*[None] * 8, 1, 1, h, w, 0, 4,
                                         ranks, planes, None) != 0, \
            (ranks, planes, h, w)


class _Guarded(Exception):
    pass


def test_every_library_call_runs_on_its_tensors_device(host_kernels,
                                                       monkeypatch):
    """The library sets kernel attributes and asks for occupancy on the
    current CUDA device, which the stream it is handed does not choose; so
    each launcher makes its tensors' device current (``stencil.on_device``,
    ``torch.cuda.device`` for a card) around every library call, the
    launch and the blocking, cluster and plane queries alike. A stand-in
    records the device made current at each call of the host build; the
    layout probe's launcher enters the same guard first. (A card other
    than the first is not there to show the fault itself.)"""
    real = stencil.on_device
    guard = real(torch.device('cuda', 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
    assert isinstance(real(torch.device('cpu')), contextlib.nullcontext)
    current, calls = [], []

    @contextlib.contextmanager
    def on_device(device):
        current.append(device)
        try:
            yield
        finally:
            current.pop()

    lib = stencil._load()

    class Spy:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, list(current)))
                return getattr(lib, name)(*args)
            return call

    monkeypatch.setattr(stencil, 'on_device', on_device)
    monkeypatch.setattr(stencil, '_lib', Spy())
    b, ns, hp, wp, chunk, isz, igz, g0, ng = CASES[0]
    d = _inputs(1, *CASES[0])
    geo = dict(isz=isz, igz=igz, g0=g0, ng=ng)
    coef = (d['alpha'], d['t1'], d['t2'], d['inj'], d['src'])
    p0, p1, _ = stencil._fwd_chunk_kernel(d['p0'], d['p1'], *coef, **geo)
    stencil._bwd_reverse_chunk_kernel(p0, p1, d['gp0'], d['gp1'], d['grec'],
                                      *coef, **geo)
    stencil._sum_shots_kernel(d['gp0'], d['gp1'], d['p0'])
    tape = stencil._tape_chunk_kernel(d['p0'], d['p1'], *coef, isz=isz)
    stencil._bwd_tape_chunk_kernel(tape, d['gp0'], d['gp1'], d['grec'],
                                   d['alpha'], d['t1'], d['t2'], d['src'],
                                   **geo)
    names = {name for name, _ in calls}
    assert {'rdt_fwd_chunk', 'rdt_bwd_reverse_chunk', 'rdt_sum_shots',
            'rdt_tape_chunk', 'rdt_bwd_tape_chunk', 'rdt_blocking',
            'rdt_tape_ranks'} <= names
    assert all(devs == [torch.device('cpu')] for _, devs in calls), calls

    from red_diffeq_tpu_torch.ops import layout_probe

    def refuse(device):
        raise _Guarded(device)

    monkeypatch.setattr(stencil, 'on_device', refuse)
    with pytest.raises(_Guarded):
        layout_probe._run_variant_kernel('roll', torch.zeros(1, 8, 8), None,
                                         None, None, None, nt=1)


def test_tape_kernel_info_on_the_host_build(host_kernels):
    """``kernel_info`` reads ``tape_step`` and ``tape_step_stream`` as
    launched for an Hp x Wp field (the host stand-in reports no registers
    and no resident clusters): their blocks per cluster, and the planes
    that ``tape_step_stream``'s instantiation keeps in shared memory; a
    field past a kernel's size limit raises."""
    zeros = dict(regs=0, local_bytes=0, blocks_per_sm=0, clusters=0)
    assert stencil.kernel_info('tape_step', 310, 310) == dict(zeros,
                                                              ranks=16)
    assert stencil.kernel_info('tape_step_stream', 420, 420) == dict(
        zeros, ranks=16, planes=2)
    assert [stencil.kernel_info('tape_step_stream', n, n)['planes']
            for n in (500, 600)] == [1, 0]
    for name, n in (('tape_step', 420), ('tape_step_stream', 680)):
        with pytest.raises(RuntimeError, match='kernel_info'):
            stencil.kernel_info(name, n, n)


def test_stencil_breakdown_variants_apply_to_the_source():
    """Every cut of tools/torch_stencil_breakdown.py (the blocked kernels',
    ``tape_step``'s, its timeline and ``tape_step_stream``'s) finds what it
    replaces in csrc/stencil.cu exactly once and changes the source; each
    stream cut changes ``tape_step_stream`` alone, not ``tape_step``."""
    path = Path(__file__).resolve().parents[1] / 'tools' / \
        'torch_stencil_breakdown.py'
    spec = importlib.util.spec_from_file_location('stencil_breakdown', path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = stencil._CSRC.read_text()
    for cut in tool.CUTS:
        assert tool.variant_source(src, cut) != src, cut
    tape = src[src.index('tape_step(\n'):src.index('// tape_step_stream<NP>')]
    for name, edits in {**tool.TAPE_CUTS, 'timeline': tool._TIMELINE}.items():
        assert tool._edit(src, edits, name) != src, name
    for name, edits in tool.STREAM_CUTS.items():
        out = tool._edit(src, edits, name)
        assert out != src and tape in out, name


def test_build_follows_the_source_the_module_points_at(tmp_path,
                                                       monkeypatch):
    """``stencil.build()`` builds the source that ``stencil._CSRC`` names
    at the call, so that a tool that points it at a variant of the source
    (tools/torch_stencil_breakdown.py) times that variant: a library
    already built for the variant's text is returned as it is."""
    variant = tmp_path / 'variant.cu'
    variant.write_text('// a variant of the source\n')
    monkeypatch.setattr(stencil, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(stencil, '_CSRC', variant)
    tag = hashlib.sha1(variant.read_bytes()
                       + ' '.join(stencil.NVCC_FLAGS).encode()).hexdigest()
    built = tmp_path / 'build' / f'libvariant-{tag[:12]}.so'
    built.parent.mkdir()
    built.touch()
    assert stencil.build() == built
