"""The inversion step as one CUDA graph: the port's whole-loop dispatch.

Counterpart of the JAX engine's ``lax.scan`` over the steps
(``red_diffeq_tpu/core/inversion.py:9-13, 203-207, 429-434``). The JAX
engine compiles all ``ts`` steps into one program, keeps the metrics on the
device and stacks them at the end. Here one step is captured once as a
``torch.cuda.CUDAGraph`` and replayed ``ts`` times:

* :class:`StepBuffers` holds every tensor the step reads or writes at a
  fixed address: the model (one part per data shard of a mesh), Adam's
  moments and step count, the observations, their mask and the metrics'
  targets, every step's draws (drawn before the loop, in the eager loop's
  order, and picked by the step count), and a (ts, B) history of each
  metric. :meth:`StepBuffers.body` is one step on them; the graph
  captures exactly that function, and on the CPU it runs eagerly;
* :class:`StepGraph` runs the body once eagerly on a side stream (a real
  step, and the warm-up the capture needs: the kernel library's load, the
  U-Net's cuDNN plans, the index constants), then captures it into a
  private memory pool. A capture or launch error raises. The kernel
  wrappers count their launches in Python, which runs only at the capture,
  so the capture's counts are taken as one replay's and added to the
  counters after every replay (:meth:`StepGraph.replay`);
* :class:`GraphCache` keeps an engine's graphs by configuration. A graph
  made for other U-Net weights (their identity or version, which a
  ``GaussianDiffusion.params`` assignment or a renewed bf16 copy changes)
  is dropped, never replayed.
"""
import time
from typing import Callable, Dict, Optional

import torch

from red_diffeq_tpu_torch.ops import stencil
from red_diffeq_tpu_torch.solvers import acoustic

METRICS = ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse', 'ssim')


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters and the plain path's chunks."""
    return {**stencil.launches,
            'plain_chunk': acoustic.plain_chunk_calls['chunk']}


def _set_counts(counts: Dict[str, int]) -> None:
    for k, n in counts.items():
        if k == 'plain_chunk':
            acoustic.plain_chunk_calls['chunk'] = n
        else:
            stencil.launches[k] = n


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (as :func:`launch_counts` keys them) to the counters."""
    now = launch_counts()
    _set_counts({k: now[k] + n for k, n in counts.items()})


class StepBuffers:
    """The fixed tensors of one configuration's step and the step on them.

    ``y_shape`` and ``target_shape`` are the observations' and the
    targets' shapes, ``history`` the metric names with their dtypes, ``ts``
    the steps a run takes. :meth:`bind` sets the step, ``advance(mus,
    states, draws) -> (mus, states, metrics)`` over the model's parts, and
    the parts' shapes and devices; ``split`` and ``gather`` map a whole
    (B, ...) tensor to such parts and back."""

    def __init__(self, y_shape, target_shape, ts: int, history: Dict,
                 device):
        dev = torch.device(device)
        f32 = torch.float32
        self.ts = ts
        self.y = torch.zeros(y_shape, dtype=f32, device=dev)
        self.mask = torch.ones(y_shape, dtype=f32, device=dev)
        self.target = torch.zeros(target_shape, dtype=f32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        b = y_shape[0]
        self.history = {k: torch.zeros((ts, b), dtype=dtype, device=dev)
                        for k, dtype in history.items()}
        self.draws: Dict[str, torch.Tensor] = {}
        self.advance: Optional[Callable] = None
        self.split: Optional[Callable] = None
        self.gather: Optional[Callable] = None
        self.mus = self.ms = self.vs = None

    def bind(self, advance: Callable, mu_parts) -> None:
        self.advance = advance
        self.mus, self.ms, self.vs = (
            [torch.zeros_like(p) for p in mu_parts] for _ in range(3))

    def fill_draws(self, draw_fn: Callable, rows, generator,
                   keep_state_at=()) -> Dict[int, torch.Tensor]:
        """Draw each step of ``rows`` with ``draw_fn()`` (a dict of
        tensors), in order, into its row of the draw buffers. Returns the
        generator's state after each step ``i`` with ``i + 1`` in
        ``keep_state_at``, keyed by ``i + 1`` (a snapshot's)."""
        states = {}
        for i in rows:
            for name, v in draw_fn().items():
                if name not in self.draws:
                    self.draws[name] = v.new_zeros((self.ts, *v.shape))
                self.draws[name][i].copy_(v)
            if i + 1 in keep_state_at:
                states[i + 1] = generator.get_state()
        return states

    def load_inputs(self, y, mask, target) -> None:
        """Copy a run's observations, their mask and the targets in."""
        self.y.copy_(y)
        self.mask.copy_(mask)
        self.target.copy_(target)

    def load_state(self, mu_parts, m_parts, v_parts, count: int) -> None:
        """Copy the model's parts, Adam's moments and the step count in."""
        for dsts, srcs in ((self.mus, mu_parts), (self.ms, m_parts),
                           (self.vs, v_parts)):
            for dst, src in zip(dsts, srcs):
                dst.copy_(src)
        self.count.fill_(count)

    def load_history(self, rows: Dict[str, torch.Tensor]) -> None:
        for k, v in rows.items():
            self.history[k][:v.shape[0]].copy_(v)

    def body(self) -> None:
        """One step: the draws of step ``count``, the step, its results
        copied back, its metrics into row ``count`` of the history."""
        k = self.count.long().reshape(1)
        draws = {n: b.index_select(0, k)[0] for n, b in self.draws.items()}
        states = [{'count': self.count.to(m.device), 'mu': m, 'nu': v}
                  for m, v in zip(self.ms, self.vs)]
        mus, states, metrics = self.advance(self.mus, states, draws)
        for dst, src in zip(self.mus, mus):
            dst.copy_(src)
        for dst_m, dst_v, state in zip(self.ms, self.vs, states):
            dst_m.copy_(state['mu'])
            dst_v.copy_(state['nu'])
        self.count.copy_(states[0]['count'])
        for name, h in self.history.items():
            h.index_copy_(0, k, metrics[name][None].to(h.device))


class StepGraph:
    """``buffers.body`` captured as a CUDA graph. Construction runs one
    real step eagerly on a side stream (the warm-up), then captures the
    body into a private memory pool: ``seconds`` the capture took,
    ``pool_bytes`` the device memory it reserved, ``launches`` the kernel
    launches of one replay (by :func:`launch_counts` key)."""

    def __init__(self, buffers: StepBuffers):
        dev = buffers.count.device
        self.buffers = buffers
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                buffers.body()
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(self.graph, stream=stream):
                    buffers.body()
            finally:
                after = launch_counts()
                _set_counts(before)
            torch.cuda.synchronize(dev)
            self.seconds = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n > before[k]}

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)

    def info(self) -> Dict:
        return {'launches': dict(self.launches), 'seconds': self.seconds,
                'pool_bytes': self.pool_bytes}

    def release(self) -> None:
        self.graph.reset()


class GraphCache:
    """An engine's step graphs, one per configuration key; ``stamp`` is
    the identity and version of the U-Net weights the graph reads, and a
    graph whose stamp differs from the caller's is dropped. ``captures``
    counts the graphs made."""

    def __init__(self):
        self._entries: Dict = {}
        self.captures = 0

    def get(self, key, stamp) -> Optional[StepGraph]:
        entry = self._entries.get(key)
        if entry is None:
            return None
        if entry[0] != stamp:
            self._entries.pop(key)[1].release()
            return None
        return entry[1]

    def put(self, key, stamp, graph: StepGraph) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            old[1].release()
        self._entries[key] = (stamp, graph)
        self.captures += 1

    def __len__(self) -> int:
        return len(self._entries)

    def info(self):
        """:meth:`StepGraph.info` of each kept graph."""
        return [graph.info() for _, graph in self._entries.values()]

    def release(self) -> None:
        """Drop every graph and return their pools' memory to the card."""
        entries, self._entries = self._entries, {}
        for _, graph in entries.values():
            graph.release()
        del entries
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
