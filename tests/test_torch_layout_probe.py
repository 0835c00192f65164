"""The stencil-layout probe's port against the JAX tool, and its CUDA source
built for the host against its plain versions.

``tools/kernel_layout_probe.py`` (loaded by path; it is a script, not a
module of the package) runs its four Pallas kernels in interpret mode, as
its own ``--validate-only`` does; the port's plain versions
(``red_diffeq_tpu_torch/ops/layout_probe.py``) must give the same state
within max-rel 1e-5 of max|ref| (the JAX variants agree with each other to
8.1e-7 there: fp32 reassociation). ``csrc/layout_probe.cu`` is built with
g++ against ``tests/cuda_host/cuda_host.h`` (each CUDA thread a fiber,
each block's shared memory its own, NaN-filled) and its launchers are held
to the plain versions: ``roll`` and ``halo`` bit for bit (both sides round
every fp32 operation alone, in the JAX kernels' grouping), the two
products bit for bit against the plain step with its product summed over k
in order, as the kernel sums it, and within max-rel 1e-5 of the plain
version's ``torch.matmul``.
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


def _ordered(a, b):
    """a @ b with the terms added k = 0, 1, ... in order, one rounding a
    multiply and one an add, as the kernels' products sum them."""
    acc = None
    for k in range(a.shape[-1]):
        term = a[..., :, k:k + 1] * b[..., k:k + 1, :]
        acc = torch.zeros_like(term) + term if acc is None else acc + term
    return acc


def _ordered_reference(variant, p0, p1, alpha, t1, t2, *, nt):
    d = torch.from_numpy(lp.band_circulant(p1.shape[-1]))
    e = torch.from_numpy(lp.band_circulant(p1.shape[-2]))
    if variant == 'mxu_x':
        def lap(p):
            return lp._lap_y(p) + _ordered(p, d)
    else:
        def lap(p):
            return _ordered(e, p) + _ordered(p, d)
    return lp._steps(p0, p1, alpha, t1, t2, nt, lap)


# (nprog, Hp, Wp, nt): the JAX tool's validation shape; an odd width (46)
# and rows that fill no tile (37); several tiles of each kernel in both
# axes with ragged edges (the products' 64x64 tiles and 16-deep stages, the
# roll kernel's 32x32 tiles); a field smaller than a tile, whose halo wraps
# over it; one step and two (the halo columns read back the step after
# they are written).
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
        assert torch.equal(got, _ordered_reference(variant, *prob, nt=nt))
        assert _max_rel(got, want) <= GATE
    for t, k in zip(prob, kept):
        assert torch.equal(t, k), 'the caller\'s states were written'
    assert host_probe.launches == {
        k: nt if k == lp.KERNELS[variant] else 0 for k in lp.launches}


def test_probe_launchers_refuse_what_they_cannot_run(host_probe):
    lib = lp._load()
    null = [None] * 7
    for nprog, h, w, nt in ((1, 4, 9, 1), (1, 9, 4, 1), (0, 9, 9, 1),
                            (1, 9, 9, 0), (65536, 9, 9, 1)):
        assert lib.rdt_probe_roll(*null, nprog, h, w, nt, None) != 0
        assert lib.rdt_probe_halo(*null[:5], nprog, h, w, nt, None) != 0
        assert lib.rdt_probe_mxu(1, *null, None, None, nprog, h, w, nt,
                                 None) != 0
    assert host_probe.launches == dict.fromkeys(lp.launches, 0)
