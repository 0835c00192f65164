"""Per-step host timing.

Counterpart of ``red_diffeq_tpu/utils/profiling.py:StepTimer``: host
wall-clock time per step with the first (warm-up) step left out. The
device runs behind the host, so a step's host time is the time to queue
it until the queue is full; it is a progress figure, not a device time.
"""
import time


class StepTimer:
    """Wall-clock step timing with warm-up exclusion."""

    # Steps left out at the start: the first compiles and warms up.
    SKIP_FIRST = 1

    def __init__(self):
        self.times = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.SKIP_FIRST:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def rate(self) -> float:
        return 1.0 / self.mean if self.mean else 0.0

    def summary(self) -> str:
        return (f'{len(self.times)} steps, {self.mean * 1e3:.2f} ms/step '
                f'({self.rate:.2f} steps/s)')
