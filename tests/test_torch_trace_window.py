"""The tracer's window on the CPU and the trace reader of
``tools/torch_trace_window.py`` (the card's side runs only there)."""
import ast
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / 'tools'))

import torch_trace_window as tw  # noqa: E402
from red_diffeq_tpu_torch.utils import profiling  # noqa: E402


def _kernel(name, ts, dur=1.0):
    return dict(ph='X', cat='kernel', name=name, ts=ts, dur=dur)


def test_tool_imports_nothing_of_jax():
    tree = ast.parse((REPO / 'tools' / 'torch_trace_window.py').read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [n for n in names if n.split('.')[0] in (
        'jax', 'flax', 'optax', 'red_diffeq_tpu')]


@pytest.mark.parametrize('tail', [0, 3])
def test_trace_counts_reads_kernels_and_the_tail(tail):
    events = [dict(ph='X', cat='cpu_op', name='aten::copy_', ts=0.0,
                   dur=100.0 + tail),
              _kernel('void fwd_step<4>(Args)', 1.0),
              _kernel('bwd_reverse_step', 3.0),
              _kernel('sum_shots', 5.0),
              _kernel('bwd_reverse_step', 7.0),
              dict(ph='X', cat='gpu_memcpy', name='Memcpy DtoH', ts=50.0,
                   dur=2.0),
              dict(ph='i', cat='kernel', name='fwd_step', ts=60.0)]
    events += [_kernel('fwd_step', 10.0 + k) for k in range(tail)]
    events += [_kernel('elementwise', 90.0, 20.0)]
    counts, after, end = tw.trace_counts(events)
    assert counts == {'fwd_step': 1 + tail, 'bwd_reverse_step': 2,
                      'sum_shots': 1}
    assert after == tail
    assert end == pytest.approx(110.0 - (100.0 + tail))


def test_trace_counts_without_an_adjoint_kernel():
    counts, after, end = tw.trace_counts([_kernel('fwd_step', 0.0)])
    assert counts['fwd_step'] == 1 and after is None and end is None


def test_trace_on_the_cpu_keeps_no_margin(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, 'WINDOW_MARGIN_S', 30.0)
    t0 = time.perf_counter()
    with profiling.trace(tmp_path, 'cpu'):
        torch.ones(4).sum()
    assert time.perf_counter() - t0 < 30.0
    assert len(list(tmp_path.glob('*.pt.trace.json'))) == 1
