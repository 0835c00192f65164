"""ctypes bindings for the native .npy batch reader.

Counterpart of ``red_diffeq_tpu/io/native_loader.py``. ``NpyBatchLoader``
mmaps a .npy file through the C++ loader (``io/native/npy_loader.cpp``,
the port's own copy) and serves contiguous leading-axis batches;
:meth:`NpyBatchLoader.prefetch` faults in the *next* batch on a background
thread so host IO overlaps the card's compute. The library is built with
``g++`` at first use into ``io/_build/``, named by a hash of the source
and the flags, and loaded with ``ctypes``. Without a toolchain the loader
prints one line and reads through ``np.load(mmap_mode='r')``.

Header parsing uses numpy's own ``np.lib.format``: the C side deals only
in byte ranges.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'native' / 'npy_loader.cpp'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
_lib = None
_lib_failed = False


def build() -> Path:
    """Compile :data:`SOURCE` with g++ into BUILD_DIR, named by the hash of
    its text and flags, unless that library exists. Returns its path;
    raises if the build fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + ' '.join(GXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f'libnpy_loader-{tag}.so'
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(['g++', *GXX_FLAGS, '-o', tmp, str(SOURCE),
                              '-lpthread'], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'g++ failed ({res.returncode}):\n'
                               f'{res.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _build_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None (with one printed
    line) where it cannot be built."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    try:
        lib = ctypes.CDLL(str(build()))
        lib.npy_open.restype = ctypes.c_void_p
        lib.npy_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_uint64, ctypes.c_int64]
        lib.npy_close.argtypes = [ctypes.c_void_p]
        lib.npy_read_rows.restype = ctypes.c_int
        lib.npy_read_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_void_p]
        lib.npy_prefetch_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int64]
        lib.npy_nrows.restype = ctypes.c_int64
        lib.npy_nrows.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib
    except (OSError, RuntimeError) as e:   # no g++, or the build failed
        print(f'native npy loader unavailable ({e}); '
              'falling back to numpy mmap')
        _lib_failed = True
        return None


def _parse_header(path: Path) -> Tuple[tuple, np.dtype, int]:
    """(shape, dtype, data_offset) via numpy's own format parser."""
    with open(path, 'rb') as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise ValueError('fortran-ordered .npy not supported')
        return shape, dtype, f.tell()


class NpyBatchLoader:
    """Batched reader over the leading axis of a .npy file.

    ``loader[start:end]`` returns a fresh C-contiguous array (an integer
    index, one row with its leading axis); call :meth:`prefetch` with the
    next window to overlap its page-in with compute on the current one.
    ``native`` says whether the C++ library serves the reads.
    """

    def __init__(self, path):
        self.path = Path(path)
        self.shape, self.dtype, self._offset = _parse_header(self.path)
        self._row_bytes = int(np.prod(self.shape[1:])) * self.dtype.itemsize
        self._lib = _build_library()
        self._handle = None
        self._mmap = None
        if self._lib is not None:
            self._handle = self._lib.npy_open(
                str(self.path).encode(), self._offset, self._row_bytes,
                self.shape[0])
            if not self._handle:
                self._lib = None
        if self._lib is None:
            self._mmap = np.load(self.path, mmap_mode='r')

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.shape[0])
            if step != 1:
                raise ValueError('only contiguous slices are supported')
        else:
            start, stop = int(idx), int(idx) + 1
        count = stop - start
        if self._handle is not None:
            out = np.empty((max(count, 0), *self.shape[1:]), self.dtype)
            if count <= 0 and 0 <= start <= self.shape[0]:
                return out
            rc = self._lib.npy_read_rows(
                self._handle, start, count,
                out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IndexError(f'rows [{start}, {stop}) out of range')
            return out
        if not 0 <= start <= stop <= self.shape[0]:
            raise IndexError(f'rows [{start}, {stop}) out of range')
        return np.array(self._mmap[start:stop])

    def prefetch(self, start: int, count: int) -> None:
        """Fault in rows [start, start+count) on a background thread (a
        no-op without the library)."""
        if self._handle is not None and count > 0:
            self._lib.npy_prefetch_rows(self._handle, start, count)

    def close(self):
        if self._handle is not None:
            self._lib.npy_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_batches(seis: NpyBatchLoader, vel: NpyBatchLoader,
                 batches: List[Tuple[int, int]]
                 ) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """(start, end, seismograms, velocities) as float32 for each (start,
    end) of ``batches``, read from the loaders ``seis`` and ``vel`` with the
    next batch prefetched while the caller works on the current one, as
    the JAX CLIs read (``red_diffeq_tpu/cli/run_inversion.py:243-262``).
    Both loaders are closed when the iteration ends."""
    try:
        for i, (start, end) in enumerate(batches):
            if i + 1 < len(batches):
                nxt, nxt_end = batches[i + 1]
                seis.prefetch(nxt, nxt_end - nxt)
                vel.prefetch(nxt, nxt_end - nxt)
            yield (start, end, seis[start:end].astype(np.float32),
                   vel[start:end].astype(np.float32))
    finally:
        seis.close()
        vel.close()
