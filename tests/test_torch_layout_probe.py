"""The stencil-layout probe's port against the JAX tool, and its CUDA source
built for the host against its plain versions.

``tools/kernel_layout_probe.py`` (loaded by path; it is a script, not a
module of the package) runs its four Pallas kernels in interpret mode, as
its own ``--validate-only`` does; the port's plain versions
(``red_diffeq_tpu_torch/ops/layout_probe.py``) must give the same state
within max-rel 1e-5 of max|ref| (the JAX variants agree with each other to
8.1e-7 there: fp32 reassociation). ``csrc/layout_probe.cu`` is built with
g++ against ``tests/cuda_host/cuda_host.h`` (each CUDA thread a fiber,
each block's shared memory its own, NaN-filled, a thread-block cluster a
group of fibers with its barrier) and its launchers are held to the plain
versions: ``roll`` and ``halo`` bit for bit on both routes, the resident
kernels (one launch a call, each field in a cluster's shared memory) at
every cluster size their picker returns, and the one-launch-a-step
``*_global`` kernels (both sides round every fp32 operation alone, in the
JAX kernels' grouping), the two
products bit for bit against a plain split-TF32 product in the kernels'
order (the state and the constant each in three TF32 parts; each 8-deep
step adds six products of parts, each pass's 8 terms in order, as
``cuda_host.h`` emulates ``mma.sync``, the main one into a sum of its
own), and within max-rel 1e-5 of the plain version's ``torch.matmul``.
The emulation's own pieces are held to plain arithmetic: the port's
split against bit arithmetic in numpy, the emulated m16n8k8 fragment
product
(``cuda_host/mma_fragment.cu``) against an exact product of small
integers; a fragment row swapped, in that source or in the probe's, must
fail.
"""
import ctypes
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_host.host_build import build_host_library, use_host_probe_library
from red_diffeq_tpu_torch.ops import layout_probe as lp
from red_diffeq_tpu_torch.ops import stencil

REPO = Path(__file__).resolve().parents[1]
GATE = 1e-5


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name.replace('/', '_'), REPO / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jax_tool():
    return _load_tool('kernel_layout_probe')


@pytest.fixture(scope='module')
def torch_tool():
    return _load_tool('torch_layout_probe')


@pytest.fixture(scope='module')
def breakdown_tool():
    return _load_tool('torch_probe_breakdown')


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('n', [5, 46, 48, 310])
def test_band_circulant_equals_jax_tool(jax_tool, n):
    want = jax_tool.band_circulant(n)
    got = lp.band_circulant(n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape,seed', [((2, 40, 48), 0), ((3, 37, 46), 5),
                                        ((1, 310, 310), 0)])
def test_make_problem_equals_jax_tool(jax_tool, shape, seed):
    want = jax_tool.make_problem(*shape, seed=seed)
    got = lp.make_problem(*shape, seed=seed)
    for name, g, w in zip(('p0', 'p1', 'alpha', 't1', 't2'), got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('variant', lp.VARIANTS)
def test_plain_version_matches_jax_kernel(jax_tool, variant):
    """The JAX tool's ``run_variant`` in interpret mode, as its
    ``--validate-only`` runs it (2 fields of 40x48, 20 steps, unroll 2),
    against the port's plain version on the CPU."""
    prob = jax_tool.make_problem(2, 40, 48)
    want = np.asarray(jax_tool.run_variant(variant, *prob, nt=20, unroll=2,
                                           interpret=True))
    got = lp.run_variant(variant, *(torch.from_numpy(np.array(a))
                                    for a in prob), nt=20)
    assert got.shape == want.shape
    assert _max_rel(got, want) <= GATE


def test_tool_validate_only_on_cpu(torch_tool, capsys):
    records = torch_tool.main(['--validate-only', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'VALIDATION OK' in out.splitlines()
    assert [r['variant'] for r in records] == list(lp.VARIANTS)
    assert all(r['ok'] and r['rel_err_vs_roll'] < 1e-4 for r in records)


def test_tool_timing_lines_on_cpu(torch_tool):
    """Off the card the timing lines carry the JAX tool's keys and the
    device, and nothing measured only on the card."""
    records = torch_tool.main(['--device', 'cpu', '--programs', '1',
                               '--size', '9', '--nt', '3', '--reps', '1',
                               '--variants', 'halo', 'mxu_xy'])
    timing = records[2:]
    assert [r['variant'] for r in timing] == ['halo', 'mxu_xy']
    for r in timing:
        assert r['device'] == 'cpu' and r['size'] == [9, 9] and r['nt'] == 3
        assert r['ms_per_call'] > 0 and r['us_per_step_per_field'] > 0
        assert 'graph_ms_per_call' not in r and 'launches_per_call' not in r


def test_breakdown_variants_apply_to_the_source(breakdown_tool):
    """Every cut and design of tools/torch_probe_breakdown.py, of the
    products and of the resident kernels, finds what it replaces in
    csrc/layout_probe.cu, and changes it; a failure names each variant
    whose pattern no longer matches."""
    src = lp._CSRC.read_text()
    failed = []
    for name, subs in [*breakdown_tool.VARIANTS.items(),
                       *breakdown_tool.RESIDENT_VARIANTS.items()]:
        try:
            out = breakdown_tool.variant_source(src, subs)
        except RuntimeError as err:
            failed.append(f'{name}: {err}')
            continue
        if (out == src) != (not subs):
            failed.append(f'{name}: the source is unchanged')
    assert not failed, '\n'.join(failed)


def test_breakdown_needs_a_card(breakdown_tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert breakdown_tool.main([]) == 1
    assert 'no CUDA device' in capsys.readouterr().err


def test_probe_raises_without_a_card(torch_tool, monkeypatch, tmp_path):
    """Nothing falls back to the CPU: the tool raises for its default
    device without a card, the wrapper for a tensor that is neither on the
    CPU nor on a card, and the kernel route without the CUDA library."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for argv in ([], ['--device', 'cuda']):
        with pytest.raises(RuntimeError, match='CUDA'):
            torch_tool.main(['--validate-only', *argv])
    z, c = torch.zeros(1, 8, 8, device='meta'), torch.zeros(8, 8,
                                                            device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        lp.run_variant('roll', z, z, c, c, c, nt=1)
    monkeypatch.setattr(stencil.shutil, 'which', lambda name: None)
    monkeypatch.setattr(stencil, '_DEFAULT_NVCC', str(tmp_path / 'nvcc'))
    monkeypatch.setattr(stencil, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(lp, '_lib', None)
    z, c = torch.zeros(1, 8, 8), torch.zeros(8, 8)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        lp._run_variant_kernel('halo', z, z, c, c, c, nt=1)


# ----------------------------------------------------------------------
# The CUDA source, built for the host.
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def host_library(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('g++ is not available to build the kernels for the host')
    return build_host_library(lp._CSRC, tmp_path_factory.mktemp('probe_host'),
                              gxx)


@pytest.fixture
def host_probe(host_library, monkeypatch):
    """The probe module with its library swapped for the host build."""
    return use_host_probe_library(monkeypatch, stencil, lp, host_library)


def _split_product(a, b, const_a):
    """a @ b in the product kernels' order: the constant (a if const_a,
    else b) and the state each split into three TF32 parts
    (lp.split_parts); each 8-deep step of the depth adds the passes but the
    last into one sum and the last into another, the terms of each k in
    order, one fp32 rounding an add (a product of the parts is exact); the
    result is the second sum plus the first."""
    c = lp.split_parts(a if const_a else b)
    st = lp.split_parts(b if const_a else a)
    depth = a.shape[-1]
    passes = lp.PART_PRODUCTS
    main, corr = 0.0, 0.0
    for k8 in range(0, depth, 8):
        for n, (sp, cp) in enumerate(passes):
            x, y = (c[cp], st[sp]) if const_a else (st[sp], c[cp])
            acc = corr if n < len(passes) - 1 else main
            for k in range(k8, min(k8 + 8, depth)):
                acc = acc + x[..., :, k:k + 1] * y[..., k:k + 1, :]
            if n < len(passes) - 1:
                corr = acc
            else:
                main = acc
    return main + corr


def _split_reference(variant, p0, p1, alpha, t1, t2, *, nt):
    d = torch.from_numpy(lp.band_circulant(p1.shape[-1]))
    e = torch.from_numpy(lp.band_circulant(p1.shape[-2]))
    if variant == 'mxu_x':
        def lap(p):
            return lp._lap_y(p) + _split_product(p, d, False)
    else:
        def lap(p):
            return _split_product(e, p, True) + _split_product(p, d, False)
    return lp._steps(p0, p1, alpha, t1, t2, nt, lap)


# (nprog, Hp, Wp, nt): the JAX tool's validation shape; a width that is no
# multiple of 4 (46: the products' padded rows) and rows that fill no
# tile (37); several tiles of each kernel in both axes with ragged edges
# (the products' 64x64 tiles, 32-deep slabs and 16x8 fragments, the roll
# kernel's 32x32 tiles); a field smaller than a tile, whose halo wraps
# over it; odd widths; one step and two (the halo columns read back the
# step after they are written).
CASES = [(2, 40, 48, 20), (1, 37, 46, 7), (2, 70, 90, 5), (1, 6, 9, 6),
         (1, 12, 11, 1), (2, 9, 5, 2)]


@pytest.mark.parametrize('variant', lp.VARIANTS)
@pytest.mark.parametrize('case', CASES,
                         ids=lambda c: f'{c[0]}x{c[1]}x{c[2]}n{c[3]}')
def test_probe_kernel_matches_plain_version(host_probe, case, variant):
    nprog, hp, wp, nt = case
    prob = [torch.from_numpy(a) for a in lp.make_problem(nprog, hp, wp,
                                                         seed=hp + wp + nt)]
    kept = [t.clone() for t in prob]
    got = lp._run_variant_kernel(variant, *prob, nt=nt)
    want = lp.plain_variant(variant, *prob, nt=nt)
    assert got.shape == (nprog, hp, wp) and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    if variant in ('roll', 'halo'):
        assert torch.equal(got, want)
    else:
        assert torch.equal(got, _split_reference(variant, *prob, nt=nt))
        assert _max_rel(got, want) <= GATE
    for t, k in zip(prob, kept):
        assert torch.equal(t, k), 'the caller\'s states were written'
    # roll and halo take every CASES field on the resident route: one
    # launch a call; the products one a step.
    if variant in lp.GLOBAL_KERNELS:
        assert lp.route(variant, nprog, hp, wp)['route'] == 'resident'
    want_launches = 1 if variant in lp.GLOBAL_KERNELS else nt
    assert host_probe.launches == {
        k: want_launches if k == lp.KERNELS[variant] else 0
        for k in lp.launches}


def _held_to_plain(variant, case, route_to=None):
    """``case`` through the kernel of ``variant`` (its route by size, or
    ``route_to``), bit for bit against the plain version, the caller's
    states unwritten; returns the route :func:`lp.route` picks."""
    nprog, hp, wp, nt = case
    prob = [torch.from_numpy(a) for a in lp.make_problem(nprog, hp, wp,
                                                         seed=hp + wp + nt)]
    kept = [t.clone() for t in prob]
    got = lp._run_variant_kernel(variant, *prob, nt=nt, route_to=route_to)
    assert got.shape == (nprog, hp, wp) and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, lp.plain_variant(variant, *prob, nt=nt))
    for t, k in zip(prob, kept):
        assert torch.equal(t, k), 'the caller\'s states were written'
    return lp.route(variant, nprog, hp, wp)


# (nprog, Hp, Wp, nt, ranks, fields a cluster) of the resident kernels
# beyond CASES: each cluster size the picker returns (2 for 5-7 rows, 4 for
# 8-15, 8 for 16-31, 16 from 32), each with strips of exactly 2 rows (5
# rows: 2 and 3; 8, 16 and 32 rows: 2 each), where a block's halo rows come
# from the same neighbour on both sides at 2 ranks; 3 fields in one
# cluster; a ragged last cluster (5 fields at the 3 a cluster that rows of
# 1000 floats leave room for, one band a block) for both layouts; strips
# of 5 rows in 3 bands of 1, 2 and 2 rows (a band that starts at row 1).
RESIDENT_CASES = [(1, 5, 6, 3, 2, 1), (2, 8, 9, 3, 4, 2),
                  (1, 16, 7, 3, 8, 1), (3, 32, 9, 4, 16, 3),
                  (5, 7, 1000, 2, 2, 3), (1, 80, 300, 2, 16, 1)]


@pytest.mark.parametrize('variant', ['roll', 'halo'])
@pytest.mark.parametrize('case', RESIDENT_CASES,
                         ids=lambda c: f'{c[0]}x{c[1]}x{c[2]}n{c[3]}')
def test_resident_kernel_at_every_cluster_size(host_probe, case, variant):
    nprog, hp, wp, nt, ranks, per = case
    plan = _held_to_plain(variant, case[:4])
    assert plan == dict(kernel=lp.KERNELS[variant], route='resident',
                        ranks=ranks, fields_per_cluster=per,
                        clusters=-(-nprog // per))
    assert host_probe.launches == {
        k: int(k == lp.KERNELS[variant]) for k in lp.launches}


def test_resident_picker_returns_every_cluster_size(host_probe):
    """The picker's cluster sizes over 5 to 64 rows are 2, 4, 8 and 16,
    the most that leave every strip 2 rows (one never: 5 rows split in
    two): RESIDENT_CASES reaches each."""
    sizes = {lp.route('roll', 1, h, 9)['ranks'] for h in range(5, 65)}
    assert sizes == {2, 4, 8, 16} == {c[4] for c in RESIDENT_CASES}


# (nprog, Hp, Wp, nt) past the resident kernels' size limit: rows of more
# than 1024 floats (one column a thread), and 9-row bands (129 rows at 16
# blocks, one band of 520 columns a block).
GLOBAL_CASES = [(1, 5, 1030, 3), (1, 129, 520, 2)]


@pytest.mark.parametrize('variant', ['roll', 'halo'])
@pytest.mark.parametrize('case', GLOBAL_CASES,
                         ids=lambda c: f'{c[0]}x{c[1]}x{c[2]}n{c[3]}')
def test_field_past_the_limit_takes_the_global_kernel(host_probe, case,
                                                      variant):
    plan = _held_to_plain(variant, case)
    assert plan == dict(kernel=lp.GLOBAL_KERNELS[variant], route='global',
                        ranks=None, fields_per_cluster=None, clusters=None)
    assert host_probe.launches == {
        k: case[3] if k == lp.GLOBAL_KERNELS[variant] else 0
        for k in lp.launches}
    prob = [torch.from_numpy(a) for a in lp.make_problem(*case[:3])]
    with pytest.raises(ValueError, match='past the size limit'):
        lp._run_variant_kernel(variant, *prob, nt=1, route_to='resident')


@pytest.mark.parametrize('variant', ['roll', 'halo'])
@pytest.mark.parametrize('case', CASES,
                         ids=lambda c: f'{c[0]}x{c[1]}x{c[2]}n{c[3]}')
def test_global_kernel_matches_plain_version(host_probe, case, variant):
    """The one-launch-a-step kernels on every CASES field, their route
    forced: bit for bit, one launch a step."""
    _held_to_plain(variant, case, route_to='global')
    assert host_probe.launches == {
        k: case[3] if k == lp.GLOBAL_KERNELS[variant] else 0
        for k in lp.launches}


def test_probe_routes_refuse_what_they_do_not_have(host_probe):
    prob = [torch.from_numpy(a) for a in lp.make_problem(1, 9, 9)]
    for variant, to in (('mxu_x', 'global'), ('roll', 'tape')):
        with pytest.raises(ValueError, match='has no route'):
            lp._run_variant_kernel(variant, *prob, nt=1, route_to=to)
    assert host_probe.launches == dict.fromkeys(lp.launches, 0)


def test_probe_launchers_refuse_what_they_cannot_run(host_probe):
    lib = lp._load()
    null = [None] * 7
    for nprog, h, w, nt in ((1, 4, 9, 1), (1, 9, 4, 1), (0, 9, 9, 1),
                            (1, 9, 9, 0), (65536, 9, 9, 1)):
        assert lib.rdt_probe_roll_global(*null, nprog, h, w, nt, None) != 0
        assert lib.rdt_probe_halo_global(*null[:5], nprog, h, w, nt,
                                         None) != 0
        assert lib.rdt_probe_mxu(1, *null, None, None, nprog, h, w, nt,
                                 None) != 0
        for halo in (0, 1):
            assert lib.rdt_probe_resident(halo, *null[:6], nprog, h, w, nt,
                                          2, 1, None) != 0
    # The resident launcher refuses a cluster that does not hold the field:
    # a size it is not built for, strips under 2 rows, no field a cluster,
    # shared memory past 227 KB, rows of more than 1024 floats, bands of
    # more than 8 rows.
    for nprog, h, w, ranks, per in ((1, 9, 9, 3, 1), (1, 9, 9, 32, 1),
                                    (1, 9, 9, 8, 1), (1, 9, 9, 4, 0),
                                    (4, 7, 1000, 2, 4), (1, 5, 1030, 2, 1),
                                    (1, 129, 520, 16, 1)):
        for halo in (0, 1):
            assert lib.rdt_probe_resident(halo, *null[:6], nprog, h, w, 1,
                                          ranks, per, None) != 0
    # The picker refuses what no route takes, and gives no cluster for a
    # field past the limit.
    r, q = ctypes.c_int(-1), ctypes.c_int(-1)
    for nprog, h, w in ((0, 9, 9), (1, 4, 9), (1, 9, 4)):
        assert lib.rdt_probe_plan(0, nprog, h, w, ctypes.byref(r),
                                  ctypes.byref(q)) != 0
    assert lib.rdt_probe_plan(1, 1, 5, 1030, ctypes.byref(r),
                              ctypes.byref(q)) == 0
    assert (r.value, q.value) == (0, 0)
    # The products copy 16 bytes at a time: a state that does not start on
    # 16 bytes is refused.
    buf = torch.zeros(4 * 9 * 12 + 1)
    odd = ctypes.c_void_p(buf.data_ptr() + 4)
    even = [ctypes.c_void_p(buf.data_ptr())] * 9
    assert lib.rdt_probe_mxu(0, odd, *even[1:], 1, 9, 9, 1, None) != 0
    assert host_probe.launches == dict.fromkeys(lp.launches, 0)


def test_probe_kernel_info_on_the_host_build(host_probe):
    """``kernel_info`` reads every probe kernel through ``rdt_probe_info``
    and, for the resident kernels with their cluster, through
    ``rdt_probe_resident_info`` (the host stand-in reports zero registers,
    blocks and clusters), and refuses an unknown kernel or a field past the
    resident kernels' limit."""
    zeros = dict(regs=0, local_bytes=0, blocks_per_sm=0)
    for k in (lp.KERNELS['mxu_x'], lp.KERNELS['mxu_xy'],
              *lp.GLOBAL_KERNELS.values()):
        assert lp.kernel_info(k) == zeros
    for k in (lp.KERNELS['roll'], lp.KERNELS['halo']):
        assert lp.kernel_info(k, 20, 310, 310) == dict(
            zeros, ranks=16, fields_per_cluster=3, clusters=0)
        with pytest.raises(RuntimeError, match='CUDA error'):
            lp.kernel_info(k, 1, 5, 1030)
    with pytest.raises(ValueError, match='unknown probe kernel'):
        lp.kernel_info('probe_tape')
    z = ctypes.c_int()
    assert lp._load().rdt_probe_info(4, *[ctypes.byref(z)] * 3) != 0


# ----------------------------------------------------------------------
# The split and the emulated tensor-core pieces.
# ----------------------------------------------------------------------

def _bits_np(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _round8_np(x):
    """x rounded to 8 significant bits in numpy bit arithmetic: the
    magnitude rounded at bit 16, half away from zero."""
    u = _bits_np(x)
    sign, mag = u & np.uint32(0x80000000), u & np.uint32(0x7fffffff)
    return (sign | ((mag + np.uint32(0x8000)) & np.uint32(0xffff0000))
            ).view(np.float32)


def _split_cases(kind):
    rng = np.random.RandomState(7)
    one = np.float32(1.0).view(np.uint32)
    if kind == 'ties':
        # Dropped bits exactly half (rounds away), just below and above it.
        bits = [one | 0x8000, one | 0x18000, one | 0x7fff, one | 0x8001,
                0x3faaaaab, 0x7f7e8000]
    elif kind == 'negatives':
        bits = [0x80000000 | b for b in (one | 0x8000, one | 0x7fff,
                                          0x3faaaaab, 0x3d2aaaab)]
        bits += list(rng.randint(0x80800000, 0xfe800000, 64,
                                 dtype=np.int64))
    elif kind == 'subnormals':
        bits = [0x00000001, 0x00007fff, 0x00008000, 0x0000ffff, 0x00010000,
                0x007f8000, 0x007fffff, 0x80008000, 0x80007fff, 0]
    else:
        bits = list(rng.randint(0x00800000, 0x7e800000, 256, dtype=np.int64))
    return np.asarray(bits, np.uint32).view(np.float32)


@pytest.mark.parametrize('kind', ['ties', 'negatives', 'subnormals',
                                  'random'])
def test_split_parts_match_bit_arithmetic(kind):
    """The port's split, part by part, against numpy bit arithmetic: the
    first part x rounded to 8 bits, the second the remainder cut to 8 bits
    (its low 16 bits cleared), the third what is left."""
    x = _split_cases(kind)
    hi, mid, lo = (t.numpy() for t in lp.split_parts(torch.from_numpy(x)))
    want_hi = _round8_np(x)
    rest = x - want_hi
    want_mid = (_bits_np(rest) & np.uint32(0xffff0000)).view(np.float32)
    np.testing.assert_array_equal(_bits_np(hi), _bits_np(want_hi))
    np.testing.assert_array_equal(_bits_np(mid), _bits_np(want_mid))
    np.testing.assert_array_equal(_bits_np(lo), _bits_np(rest - want_mid))


@pytest.mark.parametrize('kind', ['ties', 'negatives', 'random'])
def test_three_parts_are_exact(kind):
    """For normal x (the last part above the subnormals) the three parts
    are TF32 values, the first two of 8 significant bits, and sum to x."""
    x = _split_cases(kind)
    x = x[np.abs(x) > 2.0 ** -100]
    parts = [t.numpy() for t in lp.split_parts(torch.from_numpy(x))]
    assert all(not np.any(_bits_np(q) & 0x1fff) for q in parts)
    for q in parts[:-1]:
        assert not np.any(_bits_np(q) & 0xffff)
    np.testing.assert_array_equal(
        sum(q.astype(np.float64) for q in parts), x.astype(np.float64))


@pytest.mark.parametrize('n', [5, 9, 46, 310])
def test_kernel_circulant_is_the_padded_circulant(n):
    d = lp.circulant(n, 'cpu', rows=True)
    assert d.shape == (n, lp.round4(n))
    assert lp.circulant(n, 'cpu', rows=True) is d
    assert not torch.any(d[:, n:])
    np.testing.assert_array_equal(d[:, :n].numpy(), lp.band_circulant(n))


@pytest.fixture(scope='module')
def fragment_library(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('g++ is not available to build the kernels for the host')
    lib = ctypes.CDLL(str(build_host_library(
        REPO / 'tests' / 'cuda_host' / 'mma_fragment.cu',
        tmp_path_factory.mktemp('mma_fragment'), gxx)))
    lib.rdt_fragment_product.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return lib


def _fragment_operands(seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-4, 5, (16, 8)).astype(np.float32)
    b = rng.randint(-4, 5, (8, 8)).astype(np.float32)
    c = rng.randint(-50, 51, (16, 8)).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_emulated_fragment_product_is_exact_on_small_integers(
        fragment_library, seed):
    """Small integers make every product and sum exact, so the emulated
    m16n8k8 must give C + A @ B to the bit, whatever its order."""
    a, b, c = _fragment_operands(seed)
    want = c.astype(np.int64) + a.astype(np.int64) @ b.astype(np.int64)
    d = c.copy()
    assert fragment_library.rdt_fragment_product(
        a.ctypes.data, b.ctypes.data, d.ctypes.data, 0) == 0
    np.testing.assert_array_equal(d, want.astype(np.float32))


@pytest.mark.parametrize('mutate', [1, 2, 3],
                         ids=['A rows g, g+8', 'B rows t, t+4',
                              'C rows g, g+8'])
def test_swapped_fragment_rows_fail(fragment_library, mutate):
    a, b, c = _fragment_operands(0)
    want = c + a @ b
    d = c.copy()
    assert fragment_library.rdt_fragment_product(
        a.ctypes.data, b.ctypes.data, d.ctypes.data, mutate) == 0
    assert not np.array_equal(d, want)


# The probe source's A fragment rows (g and g + 8), and the same swapped.
FRAGMENT_ROWS = 'const int r0 = 32 * wm + 16 * i + g, r1 = r0 + 8;'
SWAPPED_ROWS = 'const int r1 = 32 * wm + 16 * i + g, r0 = r1 + 8;'


@pytest.fixture(scope='module')
def swapped_library(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('g++ is not available to build the kernels for the host')
    src = lp._CSRC.read_text()
    assert src.count(FRAGMENT_ROWS) == 1
    out = tmp_path_factory.mktemp('probe_swapped')
    cu = out / 'layout_probe.cu'
    cu.write_text(src.replace(FRAGMENT_ROWS, SWAPPED_ROWS))
    return build_host_library(cu, out, gxx)


@pytest.mark.parametrize('variant', ['mxu_x', 'mxu_xy'])
def test_probe_with_swapped_fragment_rows_fails(swapped_library, monkeypatch,
                                                variant):
    """The probe's products with rows g and g + 8 of their A fragments
    swapped: the test above that holds them to the 3xTF32 reference, and
    the gate against ``torch.matmul``, must both fail."""
    use_host_probe_library(monkeypatch, stencil, lp, swapped_library)
    prob = [torch.from_numpy(a) for a in lp.make_problem(1, 37, 46, seed=1)]
    got = lp._run_variant_kernel(variant, *prob, nt=2)
    assert not torch.equal(got, _split_reference(variant, *prob, nt=2))
    assert _max_rel(got, lp.plain_variant(variant, *prob, nt=2)) > GATE
