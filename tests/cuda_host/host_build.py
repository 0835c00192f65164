"""Build the CUDA sources of ``red_diffeq_tpu_torch/ops/csrc/``
(``stencil.cu``, ``layout_probe.cu``) for the host with g++, against
``cuda_host.h`` in this directory (each CUDA thread a fiber).

Used by ``tests/test_torch_kernel_emulation.py``,
``tests/test_torch_layout_probe.py`` and ``tools/rehearse_chip_smoke.py``.
Every fp32 operation rounds alone (-ffp-contract=off), as nvcc's
-fmad=false makes it on the card.
"""
import ctypes
import re
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent


def host_source(src: str) -> str:
    """The CUDA source with its CUDA-only spellings rewritten for
    cuda_host.h: the headers (cuda_host.h stands in for
    cooperative_groups), each block's dynamic shared memory, the
    ``<<<...>>>`` launches. ``cudaLaunchKernelEx`` launches, which carry
    the cluster dimension, need no rewrite."""
    src = src.replace('#include <cuda_runtime.h>', '#include "cuda_host.h"')
    src = src.replace('#include <cooperative_groups.h>', '')
    src = src.replace('extern __shared__ float smem[];',
                      'float* smem = host::shared_mem();')
    return re.sub(r'(\w+(?:<\w+>)?)<<<(.*?)>>>\(',
                  lambda m: f'host::launch({m.group(1)}, {m.group(2)})(',
                  src, flags=re.S)


def build_host_library(cu: Path, out_dir: Path, gxx: str) -> Path:
    """Compile ``cu`` for the host into ``out_dir`` (the library named by
    the source's stem); returns the shared library's path. Raises with the
    compiler's message on failure."""
    cpp = out_dir / f'{cu.stem}_host.cpp'
    lib = out_dir / f'lib{cu.stem}_host.so'
    cpp.write_text(host_source(cu.read_text()))
    res = subprocess.run(
        [gxx, '-std=c++17', '-O1', '-ffp-contract=off', '-shared', '-fPIC',
         '-w', f'-I{HERE}', '-o', str(lib), str(cpp)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'g++ failed ({res.returncode}):\n'
                           f'{res.stderr[-4000:]}')
    return lib


def use_host_library(monkeypatch, stencil, lib: Path):
    """Point the ``stencil`` module at the host build ``lib`` for one test:
    its loader, a null stream and fresh launch counters. Returns the
    module."""
    monkeypatch.setattr(stencil, 'build',
                        lambda verbose=False, source=None: lib)
    monkeypatch.setattr(stencil, '_lib', None)
    monkeypatch.setattr(stencil, '_stream',
                        lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(stencil, 'launches',
                        dict.fromkeys(stencil.launches, 0))
    monkeypatch.setattr(stencil, 'last_unroll',
                        dict.fromkeys(stencil.launches))
    monkeypatch.setattr(stencil, 'last_ranks',
                        dict.fromkeys(stencil.last_ranks))
    return stencil


def use_host_probe_library(monkeypatch, stencil, probe, lib: Path):
    """Point the layout probe module ``probe`` at the host build ``lib`` of
    its source for one test: the build function it calls
    (``stencil.build``), a null stream and fresh launch counters. Returns
    the module."""
    monkeypatch.setattr(stencil, 'build',
                        lambda verbose=False, source=None: lib)
    monkeypatch.setattr(stencil, '_stream',
                        lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(probe, '_lib', None)
    monkeypatch.setattr(probe, 'launches', dict.fromkeys(probe.launches, 0))
    return probe
