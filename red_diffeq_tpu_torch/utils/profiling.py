"""Tracing and per-step host timing.

Counterpart of ``red_diffeq_tpu/utils/profiling.py``:

* :func:`trace` records the enclosed block with ``torch.profiler`` (host
  operations, and the card's kernels when the device is a card) and writes
  a Chrome trace, as the JAX package's wraps ``jax.profiler.trace``;
* :class:`StepTimer` keeps the host's wall-clock time per step with the
  first ``skip_first`` (warm-up) steps left out. The device runs behind
  the host, so a step's host time is the time to queue it until the queue
  is full; it is a progress figure, not a device time. A run of CUDA graph
  replays is timed as one span that ends when the card has finished
  (:meth:`StepTimer.add_span`).

The engine wraps each step in the range ``inversion_step``, a replay of
the step's CUDA graph too; the U-Net's range ``unet`` is recorded where
its Python code runs, so on the card's graphed path only at the capture.
"""
import contextlib
import time
from pathlib import Path
from typing import Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[Union[str, Path]], device=None):
    """Profile the enclosed block into ``log_dir`` (nothing when None): a
    Chrome trace ``<host>_<pid>.<time>.pt.trace.json``, readable by
    TensorBoard's profiler plugin and by ``chrome://tracing``. The host's
    operations are always recorded; the card's kernels (those of the
    port's CUDA library among them, under their own names) when
    ``device`` is a CUDA device."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StepTimer:
    """Wall-clock step timing with warm-up exclusion: the first
    ``skip_first`` steps timed as a block are left out (the first builds
    the kernels and warms up)."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.times = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self.times.append(dt)
        return False

    def add_span(self, seconds: float, steps: int) -> None:
        """Record ``steps`` steps that took ``seconds`` together, each as
        an equal share (replays whose end only a synchronisation shows);
        the caller leaves the warm-up steps out of the span."""
        self.times.extend([seconds / steps] * steps)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def rate(self) -> float:
        return 1.0 / self.mean if self.mean else 0.0

    def summary(self) -> str:
        return (f'{len(self.times)} steps, {self.mean * 1e3:.2f} ms/step '
                f'({self.rate:.2f} steps/s)')
