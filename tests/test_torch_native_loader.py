"""The port's native .npy batch loader: the counterpart of
``tests/test_native_loader.py``, rows against ``np.load``'s bit for bit."""
import numpy as np
import pytest

from red_diffeq_tpu_torch.io import native_loader as nl
from red_diffeq_tpu_torch.io.native_loader import (
    NpyBatchLoader, _build_library, read_batches,
)


@pytest.fixture(scope='module', params=[np.float32, np.float64],
                ids=['float32', 'float64'])
def npy_file(request, tmp_path_factory):
    root = tmp_path_factory.mktemp('npy')
    data = np.random.RandomState(0).rand(37, 2, 5, 7).astype(request.param)
    path = root / 'data.npy'
    np.save(path, data)
    return path, data


def test_native_library_builds_into_its_build_directory():
    lib = _build_library()
    assert lib is not None, \
        'g++ toolchain present but native loader failed to build'
    built = list(nl.BUILD_DIR.glob('libnpy_loader-*.so'))
    assert nl.build() in built
    assert nl.BUILD_DIR.name == '_build'


def test_loader_matches_numpy(npy_file):
    path, data = npy_file
    loader = NpyBatchLoader(path)
    assert loader.native
    assert len(loader) == 37
    assert loader.shape == data.shape and loader.dtype == data.dtype
    for got, want in ((loader[0:4], data[0:4]), (loader[30:37], data[30:37]),
                      (loader[5], data[5:6]), (loader[:], data)):
        assert got.dtype == data.dtype and got.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(got, want)
    assert loader[4:4].shape == (0, 2, 5, 7)
    loader.close()


def test_loader_prefetch_and_bounds(npy_file):
    path, data = npy_file
    loader = NpyBatchLoader(path)
    loader.prefetch(8, 8)            # async; the rows must still be exact
    np.testing.assert_array_equal(loader[8:16], data[8:16])
    loader.prefetch(30, 100)         # an over-long prefetch clamps
    np.testing.assert_array_equal(loader[30:40], data[30:37])  # as numpy
    with pytest.raises(IndexError):
        loader[50]                   # an out-of-range row raises
    with pytest.raises(ValueError, match='contiguous'):
        loader[0:8:2]
    loader.close()
    loader.close()                   # a second close is a no-op


def test_loader_fallback(monkeypatch, npy_file):
    path, data = npy_file
    monkeypatch.setattr(nl, '_build_library', lambda: None)
    loader = nl.NpyBatchLoader(path)
    assert not loader.native
    np.testing.assert_array_equal(loader[3:9], data[3:9])
    loader.prefetch(0, 4)            # no-op without the library
    with pytest.raises(IndexError):
        loader[50]


def test_loader_without_a_toolchain_prints_and_falls_back(monkeypatch,
                                                          capsys, npy_file):
    path, data = npy_file
    monkeypatch.setattr(nl, '_lib', None)
    monkeypatch.setattr(nl, '_lib_failed', False)
    monkeypatch.setattr(nl, 'GXX_FLAGS', nl.GXX_FLAGS + ['-DNO_TOOLCHAIN'])
    monkeypatch.setenv('PATH', '/nonexistent')
    loader = nl.NpyBatchLoader(path)
    assert not loader.native
    assert 'falling back to numpy mmap' in capsys.readouterr().out
    np.testing.assert_array_equal(loader[0:2], data[0:2])


def test_read_batches_prefetches_the_next_batch(monkeypatch, npy_file):
    path, data = npy_file
    seen = []

    class Spy(NpyBatchLoader):
        def prefetch(self, start, count):
            seen.append((start, count))
            super().prefetch(start, count)

    seis, vel = Spy(path), Spy(path)
    batches = [(0, 16), (16, 32), (32, 37)]
    out = list(read_batches(seis, vel, batches))
    assert seen == [(16, 16), (16, 16), (32, 5), (32, 5)]
    for (start, end, s, v), (b0, b1) in zip(out, batches):
        assert (start, end) == (b0, b1)
        assert s.dtype == v.dtype == np.float32
        np.testing.assert_array_equal(s, data[b0:b1].astype(np.float32))
    assert not seis.native and not vel.native      # closed at the end
