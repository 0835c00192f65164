"""The harness's spans and the reading of a traced window.

A traced run wraps the measured window in ``torch.profiler`` (host
operations and every device kernel, memcpy and memset, those replayed
from CUDA graphs included) and marks it, and each job or train call in
it, with ranges named ``h100_bench.<span>``. The window opens 0.25 s
before the first span and closes 0.25 s after the card has finished,
because the profiler keeps only device events inside its window by the
host's clock. The Chrome trace is written under ``TMPDIR``, read and
deleted.

From the trace: the device events inside the harness's window, the
seconds in which some device activity runs (busy) against the window's
length (the idle share is over the timed window, not from the first
device event to the last), the device operations that took most time by
their own names, and the idle gaps named by the harness span and the
innermost host operation running at their middle.
"""
import bisect
import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

PREFIX = 'h100_bench.'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
MARGIN_S = 0.25


class Trace:
    """The window (start, end; µs), the device events [(name, ts, dur,
    category)] clipped to it, the harness's spans and the host's
    operations on the window's thread."""

    def __init__(self, events):
        spans = [e for e in events if e.get('ph') == 'X'
                 and e.get('cat') == 'user_annotation'
                 and str(e.get('name', '')).startswith(PREFIX)]
        win = [e for e in spans if e['name'] == PREFIX + 'window']
        if len(win) != 1:
            raise RuntimeError(f'the trace holds {len(win)} window spans')
        w = win[0]
        self.start, self.end = w['ts'], w['ts'] + w['dur']
        self.spans = [(e['name'][len(PREFIX):], e['ts'], e['ts'] + e['dur'])
                      for e in spans if e is not w]
        self.device = sorted(
            ((e['name'], max(e['ts'], self.start),
              min(e['ts'] + e['dur'], self.end) - max(e['ts'], self.start),
              e['cat'])
             for e in events if e.get('ph') == 'X'
             and e.get('cat') in DEVICE_CATS
             and e['ts'] < self.end and e['ts'] + e['dur'] > self.start),
            key=lambda e: e[1])
        self.host = sorted(
            ((e['name'], e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('ph') == 'X' and e.get('tid') == w.get('tid')
             and e.get('pid') == w.get('pid')
             and e.get('cat') in ('cpu_op', 'user_annotation')
             and not str(e.get('name', '')).startswith(PREFIX)),
            key=lambda e: e[1])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_gaps(self):
        """(busy µs, [(gap start, gap end)]) inside the window."""
        busy, at, gaps = 0.0, self.start, []
        for _, ts, dur, _ in self.device:
            if ts > at:
                gaps.append((at, ts))
            if ts + dur > at:
                busy += ts + dur - max(ts, at)
                at = ts + dur
        if at < self.end:
            gaps.append((at, self.end))
        return busy, gaps

    @property
    def busy_s(self) -> float:
        return self.busy_gaps()[0] / 1e6

    def kernel_time(self, match=None) -> float:
        """Device µs of the kernels whose name ``match`` accepts."""
        return sum(d for n, _, d, c in self.device
                   if c == 'kernel' and (match is None or match(n)))

    def _at(self, t, starts):
        span = min((s for s in self.spans if s[1] <= t <= s[2]),
                   key=lambda s: s[2] - s[1], default=('window',))[0]
        inner = None
        for h in self.host[:bisect.bisect_right(starts, t)]:
            if h[2] >= t and (inner is None
                              or h[2] - h[1] < inner[2] - inner[1]):
                inner = h
        return f'{span}: {inner[0] if inner else "no host op"}'

    def breakdown(self, top: int = 10, named_us: float = 20.0) -> dict:
        """The ``top`` device operations by seconds, and the ``top`` idle
        gaps by what the host was doing, summed by that name; gaps shorter
        than ``named_us`` (between the kernels of a graph) are summed as
        one entry."""
        ops = defaultdict(float)
        for n, _, d, _ in self.device:
            ops[n] += d / 1e6
        idle = defaultdict(float)
        starts = [h[1] for h in self.host]
        for a, b in self.busy_gaps()[1]:
            name = (self._at((a + b) / 2, starts) if b - a >= named_us
                    else f'gaps under {named_us:g} us')
            idle[name] += (b - a) / 1e6
        return {k: [[n, s] for n, s in sorted(v.items(), key=lambda x: -x[1])
                    [:top]] for k, v in (('device_ops', ops),
                                          ('idle_gaps', idle))}


def kernels_of(keys):
    """A test of a kernel's name: whether it names one of ``keys`` (the
    program's launch counters) as a whole word."""
    pats = [re.compile(rf'\b{re.escape(k)}\b') for k in keys]
    return lambda name: any(p.search(name) for p in pats)


class Spans:
    """The harness's spans; with ``profile`` the window is traced."""

    def __init__(self, profile: bool, device):
        self.profile = profile and torch.device(device).type == 'cuda'
        self.device = device
        self.trace = None

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function(PREFIX + name):
            yield

    @contextlib.contextmanager
    def window(self):
        if not self.profile:
            with self.span('window'):
                yield
            return
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            time.sleep(MARGIN_S)
            with self.span('window'):
                yield
                torch.cuda.synchronize(self.device)
            time.sleep(MARGIN_S)
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)['traceEvents'])
        finally:
            os.unlink(path)
