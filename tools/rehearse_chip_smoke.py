#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU, at a tiny size, before a card run.

Run from the repository root (the shipped prior's path is relative):

    python3 tools/rehearse_chip_smoke.py [BUILD_DIR]

The CUDA sources are built with g++ against ``tests/cuda_host/cuda_host.h``
(each CUDA thread a fiber, a thread-block cluster a group of them) into
BUILD_DIR (default: a temporary directory), and the kernel wrappers are
pointed at their launchers, so the kernels' own code runs, launch counters
included. The card's name, timings and CUDA events, occupancy query (7 resident
clusters) and ``nvidia-smi`` are stubbed; every check of ``chip_smoke.py``
runs for real (times read 1 ms an interval), at a 14x14 model with nbc=60 (tape-free route) and nbc=8
(taped route), batch 2, 3 inversion steps, and the wide phases at the
presets' width with nt=60 and nbc=60, 3 steps a CLI run, and the bench
slice's CLI runs at the ablation presets' width with nt=60 and nbc=60, 2
outer x 2 inner steps each (graphed against them in the loop graphs), and
a 3-step DDIM sample; the tape past the
cluster limit on a 34x34 field (16x16 at nbc=9) whose tape route is forced
to 'stream' (its 'global' twin forced at the same pass), and on a 36x36
field forced to 'global'; the training slice with 8 models a family, a
dim-8 U-Net at batch 16 and lr 3e-3 for 40 steps, a milestone every 20, a
2-step resume, 8 FID samples and 2 models a seismogram run; the layout
probe on 2 fields of 13x13, 8 steps (its gates at 3 and 8, chunks of 4
steps) and past the resident kernels' limit on one field of 342x342, 3 steps, its six kernels
built from ``layout_probe.cu`` for the host; the api slice with a dim-8
U-Net (random weights) in place of the prior, 3 steps resumed at step 2,
2 traced steps (the CPU trace holds no device activity, so its host
operations stand in for it and the launch counters for its kernel counts),
3 steps of the bf16 CLI run and 3 amp train steps; the quality slice on
the headline's 14x14 problem, 2 samples, 3 steps, with a dim-8 U-Net of
random weights as the prior (its SSIM gates opened: they hold only at the
full protocol), the other tools at 2 steps, 2 competitor outer steps, and
the OpenFWI example at the preset's width with nt=60; the mesh slice on
the headline's 14x14 problem (a dim-8 U-Net of random weights, 3 steps
over 2 x 5, the taped route over 2 x 1 for 2 steps), the CLI over its mesh
at the OpenFWI preset's width with nt=60 for 2 steps, the trainer's split
step at dim 8 and batch 16 for 2 steps, the U-Net fields at dim 8, and the
converter on the shipped prior; the configurations phase's headline at
batch 3 for 2 steps (a dim-8 U-Net of random weights), its bench CLI runs
at 3 outer x 1 inner steps, 2 + 2 train steps a keyword set and its
quality rows on a 14x20 problem for 2 steps (gates opened); red parity on
a 3-step JAX reference of the headline's 14x14 problem (the shipped prior
at 16x16), which the tool makes first with the JAX package. Times printed are
meaningless; device memory reads 0. Exits with ``chip_smoke.main()``'s code. About fifty
minutes (the quality slice about twenty of them).
"""
import ctypes
import shutil
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))


def main():
    import torch
    from cuda_host.host_build import build_host_library
    import red_diffeq_tpu_torch.config as C
    from red_diffeq_tpu_torch.ops import layout_probe as LP
    from red_diffeq_tpu_torch.ops import stencil as S
    from red_diffeq_tpu_torch.solvers import acoustic as A

    out = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    libs = {src: build_host_library(src, out, shutil.which('g++') or 'g++')
            for src in (S._CSRC, LP._CSRC)}
    S.build = lambda verbose=False, source=S._CSRC: libs[source]
    S._lib = None
    LP.run_variant = LP._run_variant_kernel
    S._stream = lambda device: ctypes.c_void_p(0)
    def kernel_info(name, hp=0, wp=0):
        info = dict(regs=0, local_bytes=0, blocks_per_sm=2, ranks=0,
                    clusters=7)
        if name == 'tape_step_stream':
            info['ranks'], info['planes'] = S.pick_stream(hp, wp)
        elif hp:
            info['ranks'] = S.pick_ranks(hp, wp)
        return info

    S.kernel_info = kernel_info
    for name in ('fwd_chunk', 'bwd_reverse_steps', 'bwd_reverse_chunk',
                 'sum_shots', 'tape_chunk', 'bwd_tape_steps',
                 'bwd_tape_chunk'):
        setattr(S, name, getattr(S, f'_{name}_kernel'))
    init = A.FWIForward.__init__

    def kernel_backend(self, *a, **kw):
        init(self, *a, **kw)
        if kw.get('backend', 'auto') == 'auto':
            self.backend = 'kernel'

    A.FWIForward.__init__ = kernel_backend
    # The JAX-style calls give no device, which means the card: here the CPU.
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    for cls in (A.FWIForward, InversionEngine, GaussianDiffusion):
        def on_cpu(self, *a, __init=cls.__init__, **kw):
            kw.setdefault('device', 'cpu')
            __init(self, *a, **kw)

        cls.__init__ = on_cpu
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.get_device_name = lambda *a: 'CPU rehearsal'
    torch.cuda.device_count = lambda: 1
    torch.cuda.memory_allocated = lambda *a: 0
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.reset_peak_memory_stats = lambda *a: None

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1.0

    torch.cuda.Event = Event
    load_config = C.load_config

    def small_preset(path):
        cfg = load_config(path)
        cfg.pde.nt, cfg.pde.nbc = 60, 60
        return cfg

    C.load_config = small_preset

    src = (ROOT / 'chip_smoke.py').read_text()
    src = src.replace("dev = torch.device('cuda')", "dev = torch.device('cpu')")
    ns = {'__name__': 'chip_smoke_rehearsal'}
    exec(compile(src, 'chip_smoke.py', 'exec'), ns)
    ns['HEADLINE'] = dict(n_grid=14, nt=60, dx=10.0, dt=0.001, nbc=60,
                          f=15.0, sz=10, gz=10, ng=14, ns=5)
    ns['NARROW'] = dict(ns['HEADLINE'], nbc=8)
    ns['BATCH'], ns['TS'] = 2, 3
    ns['WIDE_TS'], ns['BASELINE_TS'] = 3, 3
    ns['BENCH_DEPTH'], ns['BENCH_WIDE_DIFFUSION_TS'] = (2, 2), 2
    ns['SAMPLER_STEPS'] = 3
    ns['BEYOND'] = dict(ns['HEADLINE'], n_grid=16, ng=16, nbc=9)
    ns['BEYOND_STREAM'] = dict(ns['HEADLINE'], n_grid=18, ng=18, nbc=9,
                               nt=ns['CHUNK'])
    pick_ranks, pick_stream = S.pick_ranks, S.pick_stream
    S.pick_ranks = lambda h, w: (None if (h, w) in ((34, 34), (36, 36))
                                 else pick_ranks(h, w))
    S.pick_stream = lambda h, w: (None if (h, w) == (36, 36)
                                  else pick_stream(h, w))
    ns['TRAIN_FAMILY_N'], ns['SIM_N'] = 8, 2
    ns['TRAIN_STEPS'], ns['TRAIN_SAVE_EVERY'], ns['RESUME_STEPS'] = 40, 20, 2
    ns['TRAIN_ARGS'] = ['--dim', '8', '--batch_size', '16', '--lr', '3e-3',
                        '--num_fid_samples', '8']
    ns['PROBE'] = dict(programs=2, size=13, nt=8, reps=1)
    ns['PROBE_BEYOND'] = dict(programs=1, size=342, nt=3, reps=1)
    ns['PROBE_GATE_STEPS'], ns['PROBE_CHUNK'] = 3, 4
    ns['API_TS'], ns['API_RESUME_AT'], ns['API_TRACE_TS'] = 3, 2, 2
    ns['API_CLI_TS'], ns['API_TRAIN_STEPS'] = 3, 3
    from red_diffeq_tpu_torch.models.unet import Unet
    phase_api, trace_split = ns['phase_api'], ns['trace_split']

    def small_api(dev, root, training):
        prior = ns['load_prior']
        ns['load_prior'] = lambda dev: GaussianDiffusion(
            Unet(dim=8, dim_mults=(1, 2, 4, 8)), image_size=16,
            timesteps=1000, device=dev)
        try:
            return phase_api(dev, root, training)
        finally:
            ns['load_prior'] = prior

    def cpu_trace_split(path, steps):
        ns['DEVICE_CATS'] = ('cpu_op',)
        _, *rest = trace_split(path, steps)
        return (dict(S.launches), *rest)

    ns['phase_api'], ns['trace_split'] = small_api, cpu_trace_split
    # The quality slice on the headline's small problem with a dim-8 U-Net
    # (random weights, the training slice's width) in place of the prior;
    # the SSIM gates hold only at the full protocol, so they are opened.
    ns['QUALITY_N'], ns['QUALITY_TS'] = 2, 3
    ns['PLUMBING_TS'], ns['PLUMBING_DTS'] = 2, 2
    ns['QUALITY_SSIM'] = dict.fromkeys(ns['QUALITY_SSIM'], 0.5)
    ns['QUALITY_GAP'], ns['QUALITY_ORDER'] = 1.0, ()
    from red_diffeq_tpu_torch.io.checkpoints import save_params
    unet = dict(dim=8, dim_mults=(1, 2, 4, 8), channels=1)
    size = ns['HEADLINE']['n_grid'] + 2
    torch.manual_seed(0)
    ns['QUALITY_CKPT'] = out / 'quality_prior.ckpt'
    save_params(GaussianDiffusion(Unet(**unet), image_size=size,
                                  device='cpu').params, ns['QUALITY_CKPT'])
    quality_tools = ns['quality_tools']

    def small_quality_tools():
        tools = quality_tools()
        q = tools['quality']
        q.CTX, q.HEIGHT = dict(ns['HEADLINE']), ns['HEADLINE']['n_grid']
        q.UNET, q.IMAGE_SIZE = unet, size
        return tools

    ns['quality_tools'] = small_quality_tools
    ns['MESH_NARROW'] = dict(data=2, shot=1)
    ns['MESH_NARROW_TS'], ns['MESH_CLI_TS'] = 2, 2
    ns['MESH_TRAIN_STEPS'], ns['MESH_TRAIN_BATCH'] = 2, 16
    ns['MESH_TRAIN_SIZE'] = 16
    ns['MESH_TRAIN_UNET'] = dict(dim=8, dim_mults=(1, 2))
    ns['MESH_UNET'] = dict(ns['MESH_UNET'], dim=8)
    phase_mesh = ns['phase_mesh']

    def small_mesh(dev, root):
        prior = ns['load_prior']
        ns['load_prior'] = lambda dev: GaussianDiffusion(
            Unet(dim=8, dim_mults=(1, 2, 4, 8)), image_size=16,
            timesteps=1000, device=dev)
        try:
            return phase_mesh(dev, root)
        finally:
            ns['load_prior'] = prior

    ns['phase_mesh'] = small_mesh
    # The loop graphs: the traced run at 2 x 1 steps, 3-step chains, 2 + 2
    # train steps (the bench CLI runs at the bench slice's depth).
    ns['LOOP_TRACE'] = (2, 1)
    ns['LOOP_ANCESTRAL_T'], ns['LOOP_INTERP_T'], ns['LOOP_POST_TS'] = 3, 2, 2
    ns['LOOP_TRAIN_STEPS'] = 2
    # The configurations: the headline at batch 3 for 2 steps on a dim-8
    # U-Net of random weights, the bench CLI runs at 3 outer x 1 inner
    # steps, 2 + 2 train steps, and the quality rows on a 14x20 problem for
    # 2 steps (their gates opened).
    ns['CONFIG_BATCHES'], ns['CONFIG_TS'] = (3,), 2
    ns['CONFIG_BENCH'] = tuple((f, fl, m, min(d, 3), (*e, '--ts', '1'))
                               for f, fl, m, d, e in ns['CONFIG_BENCH'])
    ns['CONFIG_TRAIN_STEPS'] = 2
    ns['CONFIG_QUALITY'] = dict(n=2, width=20, sigma=20.0, ts=2)
    ns['CONFIG_QUALITY_SSIM'] = dict.fromkeys(ns['CONFIG_QUALITY_SSIM'], 0.5)
    phase_configs = ns['phase_configs']

    def small_configs(dev, root, paths, train_data):
        prior = ns['load_prior']
        ns['load_prior'] = lambda dev: GaussianDiffusion(
            Unet(dim=8, dim_mults=(1, 2, 4, 8)), image_size=16,
            timesteps=1000, device=dev)
        try:
            return phase_configs(dev, root, paths, train_data)
        finally:
            ns['load_prior'] = prior

    ns['phase_configs'] = small_configs
    loop_bench_trace = ns['loop_bench_trace']

    def cpu_loop_trace(dev, path, root):
        # The CPU trace has no device activity and no kernel by name: its
        # host operations stand in for the window, and no kernel is read.
        ns['DEVICE_CATS'], kernels = ('cpu_op',), ns['API_KERNELS']
        ns['API_KERNELS'] = ()
        try:
            return loop_bench_trace(dev, path, root)
        finally:
            ns['API_KERNELS'] = kernels

    ns['loop_bench_trace'] = cpu_loop_trace
    # Red parity on a 3-step JAX reference of the headline's 14x14 problem
    # (the shipped prior at 16x16), made here by the JAX package.
    ns['RED_PARITY_REFERENCE'] = str(small_red_reference(
        out / 'red_parity.npz', ns['HEADLINE']))
    ns['cuda_ms'] = lambda fn, reps, warm=True: (fn(), 0.0)[1]
    ns['graph_ms'] = ns['cuda_ms']
    smi = types.SimpleNamespace(stdout='CPU rehearsal, 0 W\n')
    ns['subprocess'] = types.SimpleNamespace(run=lambda *a, **k: smi)
    return ns['main']()


def small_red_reference(path, ctx, steps=3):
    """A ``steps``-step reference of ``tools/make_red_parity_reference.py``
    on a ``ctx``-sized held-out problem (sample 0 of 4, clean
    observations, sigma 3), the shipped prior at the padded width; imports
    the JAX package."""
    import importlib.util
    import jax.numpy as jnp
    import numpy as np
    from red_diffeq_tpu.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu.solvers.acoustic import FWIForward
    from red_diffeq_tpu.utils import data_trans as jdt
    spec = importlib.util.spec_from_file_location(
        'make_red_parity_reference',
        ROOT / 'tools' / 'make_red_parity_reference.py')
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    n = ctx['n_grid']
    v_true = generate_mixed_dataset(4, h=n, w=n, seed=maker.SEED_TRUTHS)[:1]
    op = FWIForward(ctx, normalize=True, v_denorm_func=jdt.v_denormalize,
                    s_norm_func=jdt.s_normalize_none, backend='xla',
                    chunk=20)
    y = np.asarray(op(jdt.v_normalize(jnp.asarray(v_true))))
    mu0 = np.pad(jdt.prepare_initial_model(v_true, 'smoothed', sigma=3.0),
                 ((0, 0), (0, 0), (1, 1), (1, 1))).astype(np.float32)
    ref = maker.make_reference(
        maker.prior_bundle(ROOT / 'pretrained_models'
                           / 'model-synthetic-ema.ckpt', image_size=n + 2),
        ctx, op, v_true, y, mu0, steps, confirm=False, log=lambda m: None,
        n_truths=4, samples=[0], obs='clean')
    maker.save(Path(path), ref)
    return path


if __name__ == '__main__':
    sys.exit(main())
