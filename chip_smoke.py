#!/usr/bin/env python3
"""Drive the PyTorch port of RED-DiffEq on one NVIDIA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its wall time:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``red_diffeq_tpu_torch/ops/csrc`` with nvcc
   (``stencil.cu`` and ``layout_probe.cu``, the two builds at once), and
   read each kernel's registers, spills and resident blocks per SM
   (the blocked kernels must not spill and must fit two blocks on an SM);
   ``tape_step`` at both shapes with its blocks per cluster and the
   clusters resident at once (no spills, at least TAPE_MIN_CLUSTERS);
   ``tape_step_stream`` at 420x420 (two coefficient planes in shared
   memory), 500x500 (one) and 600x600 (none), likewise (no spills, at
   least STREAM_MIN_CLUSTERS at 420x420);
3. the forward kernel ``fwd_step`` (temporally blocked, U steps a launch)
   against its plain PyTorch version at the headline shape (B=4, ns=5,
   310x310, chunk 20, nt=1000), full seismogram and every chunk carry:
   rtol 2e-5 / atol 1e-7, max abs err printed per output; then the same
   at the nbc=40 shape (150x150), where the taped route launches it, with
   its time there;
4. the adjoint kernels ``bwd_reverse_step`` (blocked) and ``sum_shots``
   against their plain versions chunk by chunk over a whole reverse pass
   (max-rel 2e-5 per output, the per-shot sums and their shot sums alike,
   the cotangents gp0/gp1 bit for bit), the steps and the shot sums each
   timed on their own (``sum_shots`` and PyTorch's ``torch.sum`` over the
   shot axis both as device time, the pass's 50 calls captured once in a
   CUDA graph and replayed, and per call with the host's launch between
   CUDA events), one chunk of 7 steps (a short last group for each
   blocked kernel) of the forward, of ``tape_step`` (bit for bit) and of
   both adjoint chunk launchers against their plain versions, and the
   velocity gradient of a masked-L1
   observation loss through the kernels against plain eager autograd
   (max-rel 1e-4);
5. determinism: the velocity gradient at the headline (tape-free
   adjoint) and at nbc=40 (taped adjoint), each computed twice from the
   same inputs, must agree bit for bit; a third run under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` prints
   any operation PyTorch calls nondeterministic;
6. the tape kernels at the headline shape, with the taped route forced:
   ``tape_step`` (one launch per chunk, one field per thread-block cluster)
   against its plain version bit for bit on every slot of every chunk's
   tape of one pass, its slot chunk against the forward kernel's s_{K-1},
   and its time per pass; the same at the nbc=40 shape, its own route;
   ``bwd_tape_step`` (blocked) and ``sum_shots`` against
   their plain versions chunk by chunk over a whole reverse pass (max-rel
   2e-5 per output, gp0/gp1 bit for bit), the steps timed alone, and the
   velocity gradient under ``adjoint='tape'`` against ``'reverse'``
   (max-rel 1e-4; at nbc=120 both adjoints are valid);
7. a small inversion (16x16 model, dim-8 U-Net) run on the card through
   the kernels and on the CPU through the plain path with the same draws:
   mu atol 1e-4 (Adam divides each gradient by its own RMS, so a relative
   gradient error shows up scaled by the 0.03 step), losses and metrics
   rtol 1e-4;
8. the slice: the shipped prior read by the port's own reader, observations
   from the refined operator as ``bench.py`` makes them, and a few
   RED-DiffEq steps of ``InversionEngine.optimize`` in its eager loop
   (``use_scan=False``, where a hook sees every step) at the headline
   settings, where the t2 guard takes the tape-free adjoint, with the
   launch counts of that route's kernels (ceil(chunk/U) launches per chunk
   of each blocked kernel, one ``sum_shots`` per chunk), the tape kernels
   never and the plain path unused, one U-Net call a step; then the same
   steps with the taped adjoint forced. Each prints s/step by the host
   clock and by the CUDA events a forward hook on the U-Net instance
   records at its calls;
9. the narrow-sponge slice: the headline settings with nbc=40, where the
   guard itself takes the taped adjoint. The velocity gradient through the
   tape kernels against plain eager autograd (max-rel 1e-4), then a few
   RED-DiffEq steps with the forward kernel's and the taped adjoint's
   blocked launches, one ``sum_shots`` and one ``tape_step`` per chunk, the
   tape-free adjoint never and the plain path unused;
10. the wide slice, the Marmousi preset's width (70x190 model, 310x430
   field, nbc=120). A synthetic 2-sample dataset at that width with
   observations from the refined operator (plain path), the presets
   ``configs/marmousi/red-diffeq.yaml``, ``configs/marmousi/tv.yaml`` and
   ``configs/overthrust/tikhonov.yaml`` read and written back with the
   port's own config reader and writer, pointed at it and at the shipped
   prior. The RED-DiffEq preset through the inversion CLI
   (``red_diffeq_tpu_torch.cli.run_inversion.main``) with
   ``tpu.use_scan: false`` (the eager loop) for 20 steps of sample 0: ceil(chunk/U) launches of ``fwd_step`` and
   ``bwd_reverse_step`` and one ``sum_shots`` per chunk, the tape kernels
   never, the plain path unused, one U-Net call a step with the patched
   RED's 3 windows, the observation loss falling, the run directory's
   ``config.yaml`` and ``0_results.npz`` with its nine keys, finite, the
   model 70x190; its time per step by the events a forward hook on the
   CLI's U-Net instance records. Then the TV and Tikhonov presets for 5
   steps each with noise (laplace, then gaussian) and 19 receivers
   missing: the mask that reaches the observation loss zeroes exactly 19
   receivers per sample on every shot, no U-Net call, losses finite, the
   observation loss falling;
11. the wide kernels: every kernel at the 310x430 field against its plain
   version over a pass (as in phases 3, 4 and 6) with its time (the plain
   version's over one pass) and bound, the velocity gradient through the
   kernels against plain eager autograd and with the tape forced against
   'reverse' (max-rel 1e-4).
12. the bench slice: the competitor methods DiffusionFWI and ILVR-FWI
   through their CLI (``red_diffeq_tpu_torch.cli.run_bench.main``) on a
   synthetic 2-sample set per preset (70 rows, refined observations,
   sample 0), the shipped prior in place of the presets' absent
   ``model-4.ckpt``: the OpenFWI ablation preset
   ``ablation_all_tricks_dt30_ts10`` at its full depth (30 outer x 10 inner
   steps, 290 gradients and 30 evaluating forwards) and width (70x70,
   310x310 field, dim-64 U-Net at 72x72), then the Marmousi one (70x190,
   310x430, 3 windows in one U-Net call) with its outer steps cut to
   BENCH_WIDE_DIFFUSION_TS; each with the exact launch counts of the
   tape-free route, the plain path unused, one U-Net call an outer step,
   the eight ``.npz`` keys, the model finite in [-1, 1] and device memory
   flat over the outer steps; SSIM at the initial model and at the end, s
   per outer step and the U-Net's share printed. Then a DDIM sample (batch
   4, 250 steps) in [0, 1], a short DiffusionFWI run on the kernels against
   the plain backend on the card (curves rtol 1e-4, the model atol 1e-4 on
   all but 1% of its cells and 0.1 lr on all), the kernels' device time
   per outer step. The observation loss of every outer step is printed,
   with how often the inner FWI loops lowered it, but not gated: on the
   card it rises and falls between outer steps (each starts with a
   denoise), and the loops lower it in about half of them.
13. the tape past the cluster limit: a 320x320 model at nbc=50 (a 420x420
   field, B=1, ns=5, nt=200), where the t2 guard takes the taped route and
   the field is too large for ``tape_step``'s cluster: ``tape_step_stream``
   (one cluster launch a chunk, two coefficient planes in shared memory,
   the third read ahead from device memory) against its plain version bit
   for bit on every slot of one pass, its time per pass with the host's
   launches and as a CUDA graph, ``tape_step_global`` (one launch a step
   over device memory) forced at the same pass, bit for bit and timed the
   same way, and the velocity gradient through the kernels against plain
   eager autograd (max-rel 1e-4) with its exact launches (one
   ``tape_step_stream`` a chunk); then a 580x580 model at nbc=50 (680x680,
   one chunk), past ``tape_step_stream``'s limit, where
   ``tape_step_global`` takes the field by size: bit for bit, timed, and
   the gradient with its exact launches;
14. the training slice at the shipped prior's width, through the entry
   points: ``red-diffeq-torch-datagen --velocity_only`` (4 families x 64
   models at 70x70), then seismograms of 8 models in one batch on the
   forward kernel (exact launches, held against the plain path at rtol
   2e-5) and 2 at 310x430; ``red-diffeq-torch-train`` at its defaults
   (dim-64 U-Net, 72x72, batch 32, lr 2e-4) for 200 steps with a milestone
   every 100 and ``--calculate_fid``: the mean loss of the last 20 steps
   below half that of the first 20, each milestone's checkpoint, 25-sample
   grid in [0, 1], losses JSON and a finite FID, device memory flat over
   the steps, s per train step by CUDA events, images/s, peak memory and
   each milestone's seconds, all under the CLI's own cuDNN settings; then,
   under deterministic cuDNN, 20 + 20 steps, a milestone (no FID) and 20
   steps more, graphed against eager (losses, weights and samples bit for
   bit; the train step's graph captured again after the milestone; s per
   train step of both), and a resume of the eager run's milestone 1 for
   10 steps that repeats its losses (rtol 1e-5);
   the EMA exported by ``tools/export_ema_torch.py``, loaded by
   ``load_diffusion_params``, and 5 RED-DiffEq steps on it whose
   observation loss falls;
15. the stencil-layout probe (``tools/torch_layout_probe.py``, the port of
   ``tools/kernel_layout_probe.py``) at the JAX tool's default workload
   (20 fields of 310x310, nt=1000): the six kernels' registers, spills
   and blocks per SM (the tensor-core products and the resident kernels
   must not spill, and the built library's SASS must hold TF32 ``HMMA``
   in both products; ``probe_roll`` and ``probe_halo`` with their blocks
   and fields a cluster and the clusters resident at once), the tool
   itself (its check of every variant against ``roll``, its timing lines,
   one launch a call for ``probe_roll`` and ``probe_halo``, one a step for
   the products), then each of its four kernels (``probe_roll``,
   ``probe_mxu_x``, ``probe_mxu_xy``, ``probe_halo``, built from
   ``layout_probe.cu``) against its plain version over 20 steps and over
   all 1000 (``roll`` and ``halo`` bit for bit, the split-TF32 products
   within max-rel 1e-5 and 1e-4 of ``torch.matmul`` in full fp32), against
   ``roll`` within max-rel 1e-4, exactly its launches, and its time a
   1000-step call with the host's launches and as a CUDA graph, beside the
   plain version's and, for the products, beside the library's: the
   step's ``torch.matmul`` calls times nt, as a CUDA graph. ``probe_roll``
   and ``probe_halo`` (one cluster launch a call, each field in shared
   memory for all its steps) are also timed as 50 calls of 20 steps, and
   their one-launch-a-step ``probe_roll_global`` and ``probe_halo_global``
   forced at the same call, bit for bit. Then the tool at 20 fields of
   420x420, nt=200, past the resident kernels' size limit, where roll and
   halo take the ``*_global`` kernels: each bit for bit, one launch a
   step, timed.
16. the api slice: the headline (B=4, 70x70, nt=1000, 5 shots, the
   shipped prior, the tape-free adjoint) built through the JAX package's
   public calls (``FWIForward(ctx, normalize=True, v_denorm_func=...,
   s_norm_func=...)``, ``InversionEngine(diffusion, None, 'diffusion')``,
   no device: the card). 20 steps with a snapshot every 10
   (``checkpoint_path``), a run cut just after its snapshot at step 10
   (:func:`cut_after_snapshot`), and a fresh engine that resumes it: its final model and all 20 steps' metrics equal
   the uninterrupted run's bit for bit, under deterministic cuDNN. 5 steps
   of the eager loop traced with ``profile_dir``: the Chrome trace names ``fwd_step``,
   ``bwd_reverse_step`` and ``sum_shots`` exactly as often as the launch
   counters count them (250, 250, 50 a step), no tape kernel; each
   kernel's, the U-Net's and the rest's device ms a step and the device
   window's idle share are printed, and the idle share of an untraced
   step. The bf16 U-Net (``half_precision=True``): its output within
   BF16_GAP of fp32's largest value, its ms a call beside fp32's, 20
   RED-DiffEq steps on it and on fp32 (s a step, finite losses, one U-Net
   call a step, the plain path unused); the inversion CLI with
   ``tpu.bf16_unet: true`` for 5 steps on the wide slice's dataset (a bf16
   U-Net input at every call, the run directory and npz as the wide
   slice's); ``red-diffeq-torch-train --amp`` for 50 steps at its defaults
   (s a train step, images/s and peak memory beside the training slice's;
   fp32 master weights; its first loss within AMP_LOSS_RTOL of a fp32
   run's on the same draws).
17. the quality slice, through the port's quality tools: first
   ``tools/torch_eval_quality.py`` at ``QUALITY.md``'s protocol (n=4
   held-out samples of 70x70, nt=1000, 5 shots, 300 steps, refined
   observations from the dt/2 + dx/2 grid on the plain path, the shipped
   prior on the dim-64 U-Net) for TV and RED-DiffEq on the kernels: each
   row's final SSIM within QUALITY_GAP (0.03) of ``QUALITY.md``'s refined
   row (0.8888, 0.9274) and RED-DiffEq above TV, MAE, RMSE, SSIM and
   s/sample printed; each configuration's ``InversionEngine.warm_compile``
   launches every kernel of the tape-free route (one step's launches,
   exactly) and holds the kernel library's only load (made to happen
   again for this check), the timed rows none; exact launches over the
   tool's run and the plain path only for the refined observations (their
   time printed). Then, for their plumbing at full width with their depth
   cut (PLUMBING_TS RED-DiffEq steps, PLUMBING_DTS competitor outer
   steps): ``torch_compare_methods.py`` on the refined protocol (three
   finite rows, the route's kernels launched); ``torch_milestone_eval.py``
   over the training slice's milestones and the shipped prior (rows by
   train step, the JSON sidecar, the loss summary, a different refined
   SSIM for every checkpoint, exact launches) and the bf16 copy of a
   ``GaussianDiffusion`` renewed by each ``params`` assignment;
   ``torch_pick_best_milestone.py`` on that table (the pick by refined
   SSIM, its export loaded back to the same weights); and
   ``examples/torch_example_openfwi.py`` through the inversion CLI on its
   synthetic dataset (exact launches, finite metrics).
18. the mesh slice, the headline over a ('data', 'shot') device mesh
   (``red_diffeq_tpu_torch/parallel/mesh.py``) of the cards round-robin,
   which on a one-card machine is the card 10 times: 20 RED-DiffEq steps
   at full width (B=4, 310x310, nt=1000, 5 shots, the shipped prior,
   lambda 0.75, lr 0.03) unsharded and twice over a (2 x 5) mesh, each of
   the 10 shards stepping 2 samples and 1 shot; the repeat bit for bit,
   the sharded run held to the unsharded one at PR 10's gate (mu 1e-4 on
   all but 1% of its cells and 0.1 lr on every cell, the curves rtol
   1e-4) and its first step's losses to 1e-6 relative (the shot split is
   exact: each shot shard steps its shots, the data shard sums all shots'
   coefficient cotangents each chunk; the data shards' U-Net calls may
   round apart from the whole batch's), the launches
   of ``fwd_step`` and ``bwd_reverse_step`` exactly 10 times the
   unsharded run's and of ``sum_shots`` twice (one a chunk a data shard),
   the plain path unused, s/step of both; the same
   at nbc=40 (the taped route: ``tape_step`` and ``bwd_tape_step``) over
   (4 x 1) for 3 steps; the inversion CLI with ``tpu.mesh_data: 2`` and
   ``tpu.mesh_shot: 5`` on a 2-sample synthetic dataset of the OpenFWI
   preset, 5 steps, against the unsharded CLI at the same gate, its
   datasets read by the native loader (``native``; a batch read's and its
   prefetch call's ms); the trainer's data-parallel step over the card
   twice, 6 steps at batch 32 and dim 64, its losses within rtol 2e-5 of
   one device's; a dim-64 U-Net with self-conditioning, learned variance,
   random Fourier features, per-stage full attention and heads on the
   card against the CPU (max-rel 1e-4, TF32 off); the shipped prior
   written in the upstream layout and converted back by
   ``tools/torch_convert_checkpoint.py``, bit for bit.
19. the scan slice, the JAX engine's whole-loop dispatch: at the headline
   (B=4, 70x70, nt=1000, 5 shots, the shipped prior, chunk 20), 20 steps
   of ``optimize(use_scan=True)`` (a CUDA graph of the step, captured at
   the first step and replayed; ``core/graphs.py``) against
   ``use_scan=False`` (the eager loop), each graphed run (the capture, then
   the kept graph's replays) the eager one bit for bit (the model and
   every curve) with the same launches, on the tape-free route, the taped
   route forced, nbc=40 (taped by the guard) and the bf16 U-Net; a replay's
   launches 250 / 250 / 50 at the headline by the counters; s/step of both
   modes by the host clock, the capture's seconds, the pool's bytes and
   the peak allocated memory of both; ``segment_steps=7`` and a resume
   from the snapshot at step 14 (snapshots every 7) equal the unsegmented
   graph bit for bit; one ``warm_compile`` capture serves three runs; a
   ``profile_dir`` trace of 3 replays names each kernel as often as the
   counters count it, and its device window's idle share is printed; a
   traced run that captures under the profiler, likewise; the (2 x 5)
   mesh of the card repeated for 5 steps; the wide CLI (Marmousi preset,
   310x430, 5 steps) with ``tpu.use_scan`` true and false writing the same
   ``0_results.npz``; the plain backend at phase 7's 16x16 for 3 steps.
20. the loop graphs, the JAX package's other one-program loops as CUDA
   graphs (``core/graphs.py``), each graphed against its body run eagerly
   in the same call (``graphs.eager_loops()``), bit for bit:
   ``red-diffeq-torch-bench`` with DiffusionFWI and ILVR-FWI at the OpenFWI
   ablation preset (30 x 10 steps; the eight ``.npz`` arrays; exact
   launches; the denoise, the inner step, the metrics and each ILVR blend
   factor captured once, a replay of the inner step one gradient's
   launches, of the metrics one evaluation's), and at the Marmousi preset
   cut to 4 outer steps, each against the bench slice's eager run of the
   same flags; a traced graphed run of 3 x 10 steps (its kernels by name
   equal the counters; the device window's idle share); DDIM (250 steps,
   batch 4; and with ``return_all_timesteps``), the ancestral chain (a
   100-step schedule of the prior's U-Net), ``interpolate`` from t=50 and
   RED's post-process chain from t=50, each captured once and replayed;
   20 + 20 train steps at the train CLI's defaults with ``--amp`` and
   ``--calculate_fid`` under deterministic cuDNN, a milestone and 20 steps
   after it (losses, weights, samples and FID; fp32 in the training
   slice). s an outer step, s/sample, s and ms a step, s per train step,
   images/s and s per milestone of both modes, each graph's capture
   seconds, pool MiB and launches a replay, the peak allocated memory of
   both.
21. the configurations, graphed against eager in one call, bit for bit,
   with exact launches and captures: the headline's RED-DiffEq at B=8 and
   B=16 for 10 steps (``scan_pair``: a replay launches 250 / 250 / 50 at
   any batch; s/step, s/sample of 300 steps, capture, pool, peak); the
   bench CLI on the OpenFWI ablation presets ``no_tricks``,
   ``grad_norm``, ``grad_smooth`` and ``model_blur`` (4 outer steps) and
   ``all_tricks_dt300_ts1`` (6 outer steps of one inner step), ILVR-FWI
   with ``--ilvr_down_schedule stepwise`` (12 outer steps: each factor's
   blend graph captured and replayed) and the Marmousi ``grad_norm``
   preset (patched denoise, 4 outer steps); the train CLI with
   ``Trainer(gradient_accumulate_every=2)`` and with
   ``device_data=False`` (host batches), 10 + 10 steps under deterministic
   cuDNN; the refined TV and RED-DiffEq rows of the Marmousi-width quality
   table (n=2, 70x190, sigma 20, 300 steps), each within 0.03 SSIM of
   ``QUALITY_marmousi.md``'s, RED above TV;
22. red parity: the port's graphed ``optimize`` on the kernels, on the
   committed JAX reference (``tests/data/red_parity_reference.npz``, made
   by ``tools/make_red_parity_reference.py``: the quality tools' held-out
   problem at the full width, sample 0, refined observations, 16 steps
   on JAX's own draws) through ``tools/torch_red_parity.py``: ``mu`` at
   every step and the losses and metrics within the tool's allowance (PR
   10's rule for two runs of Adam, 1e-4 on all but 1% of the cells and
   0.1 lr on every cell, widened to twice the JAX package's own spread
   under a one-ulp nudge of the initial model where that is wider), exact
   launches of the route's kernels and no plain chunk.

The bench slice's CLI runs, the training slice's 200-step run, the train
CLI's eager twins and the api slice's ``--amp`` run hook every call or run
the eager twin of a graphed run, so they run their loops in
``graphs.eager_loops()``; the resume runs graphed against the training
slice's eager twin.

With ``--write-wide-dataset DIR`` (``--write-bench-dataset DIR``) the
script only writes the wide (bench) slice's datasets and configs under DIR
(for a longer run of a CLI) and stops.

Then one JSON line with each kernel's launches and the steps per launch
its wrapper handed its launcher (``tape_step``: the blocks per cluster;
both read in the slice that takes its route), launches per 1000-step pass
(those launches over the slice's inversion steps), error, times and bound,
and under ``wide`` the same at the 310x430 field with the launches of the
wide slice's CLI run and under ``bench`` the launches of the bench slice's
DiffusionFWI run and under ``training`` those of the training slice's
seismogram run and under ``quality`` those of the quality slice's eval
tool run and under ``mesh`` those of the mesh slice's sharded headline
(``launches``, over ``shards``) and taped (``launches_taped``) runs and
under ``scan`` those of the scan slice's replayed headline run and nbc=40
run and one replay's and under ``loops`` those of the loop-graphs slice's
graphed DiffusionFWI run and a replay of its inner step and metrics;
and under ``red_parity`` those of the red parity phase's run;
then ``tape_step_stream`` with the launches of the gradient past the
cluster limit (420x420) and ``tape_step_global`` with those of the
gradient past ``tape_step_stream``'s (680x680) and its times
forced at 420x420, the four probe kernels with the
launches of the probe tool's run and their times, and the probe's two
``*_global`` kernels with the launches of the tool's run past the
resident limit; before it, a line with the quality slice's SSIMs and
s/sample; the card's line from nvidia-smi, and last ``{"ok": true,
"device": ...}``.
Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(n_grid=70, nt=1000, dx=10.0, dt=0.001, nbc=120, f=15.0,
                sz=10, gz=10, ng=70, ns=5)
# A narrow sponge: the bound on min(t2) falls below the guard (any nbc <= 55
# at dx=10, dt=1e-3), so the solver takes the taped adjoint by itself.
NARROW = dict(HEADLINE, nbc=40)
BATCH, CHUNK, TS = 4, 20, 20
CKPT = 'pretrained_models/model-synthetic-ema.ckpt'
SOURCE = 'red_diffeq_tpu_torch/ops/csrc/stencil.cu'
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor
# cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# ms per 1000-step pass of each kernel in the previous design (one launch
# per FD step, one thread per cell) and seconds per headline inversion
# step, printed beside this run's: chip runs on an NVIDIA H100 80GB HBM3 at
# 700 W recorded in PERF.md.
EARLIER_MS = {'fwd_step': 20.680, 'bwd_reverse_step': 86.645,
              'bwd_tape_step': 72.499, 'tape_step': 21.320}
EARLIER_S_PER_STEP = 0.1240
# Clusters of tape_step (16 blocks, one per SM) resident at once that its
# design counts on: the headline's 20 fields in 3 waves (7 on an H100 SXM
# at 700 W, PERF.md).
TAPE_MIN_CLUSTERS = 7
# Clusters of tape_step_stream resident at once that the field past
# tape_step's limit (B=1, 5 shots) needs for one wave.
STREAM_MIN_CLUSTERS = 5
# Fields whose tape replay takes tape_step_stream with one and with no
# coefficient plane in shared memory (420x420, BEYOND's, takes two): their
# registers, spills and resident clusters are read in the build phase.
STREAM_INFO_SHAPES = ((500, 500), (600, 600))


class Phase:
    """Print a phase's wall time when it ends; an exception ends the run."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f'== {self.name}', flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            import torch
            torch.cuda.synchronize()
            print(f'phase {self.name}: {time.perf_counter() - self.t0:.2f} s',
                  flush=True)
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of ``fn()`` over ``reps`` runs between CUDA events,
    after one warm-up run unless ``warm`` is False."""
    import torch
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of ``fn()``: its launches captured once in a
    CUDA graph, replayed ``reps`` times between CUDA events after one
    warm-up call and one warm-up replay, so the host's launch rate is not
    in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def step_events(model):
    """Record a CUDA event behind each forward of ``model`` (the U-Net
    instance, called once per RED step) and its batch; returns the lists
    and the hook's handle. The events' spacing is the period of a step as
    the card's stream sees it."""
    import torch
    seen = dict(events=[], batches=[])

    def hook(module, args, out):
        seen['batches'].append(args[0].shape[0])
        seen['events'].append(torch.cuda.Event(enable_timing=True))
        seen['events'][-1].record()

    return seen, model.register_forward_hook(hook)


def step_period(events):
    """Seconds per step between the events of the second and the last
    U-Net call (the first step warms up)."""
    return events[1].elapsed_time(events[-1]) / (len(events) - 2) / 1e3


def headline_problem(dev, ctx=None, batch=BATCH, rows=None):
    """Kernel inputs for ``batch`` synthetic models of ``rows`` (default:
    square) by ``ctx['n_grid']`` cells under ``ctx`` (the headline's by
    default)."""
    import torch
    import torch.nn.functional as F
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    ctx = ctx or HEADLINE
    geom = acoustic.Geometry.from_ctx(ctx)
    n = ctx['n_grid']
    v_true = generate_mixed_dataset(batch, h=rows or n, w=n, seed=8888)
    v_pad = F.pad(torch.from_numpy(v_true).to(dev), (geom.nbc,) * 4,
                  mode='replicate')
    alpha, t1, t2, beta_pts = acoustic.coefficients(v_pad, geom)
    inj = stencil.build_injection_field(beta_pts, geom.isx,
                                        v_pad.shape[-1]).contiguous()
    src = acoustic.source_chunks(geom, CHUNK, dev)
    geo = dict(isz=geom.isz, igz=geom.igz, g0=geom.igx[0], ng=geom.ng)
    return dict(v_true=v_true, alpha=alpha, t1=t1, t2=t2,
                inj=inj, src=src, geo=geo,
                shape=(batch, geom.ns, *v_pad.shape[-2:]))


def forward_pass(fn, p, keep=False):
    """Every chunk of one forward through ``fn``; returns the seismogram
    (B, ns, steps, ng) and, with ``keep``, every chunk-boundary carry."""
    import torch
    p0 = torch.zeros(p['shape'], device=p['alpha'].device)
    p1 = torch.zeros_like(p0)
    carries, recs = [(p0, p1)], []
    for src_chunk in p['src']:
        p0, p1, r = fn(p0, p1, p['alpha'], p['t1'], p['t2'], p['inj'],
                       src_chunk, **p['geo'])
        recs.append(r)
        if keep:
            carries.append((p0, p1))
    return torch.cat(recs, dim=2), carries


def bounds(p, steps, n_calls):
    """Least time (ms) for each kernel's work over one full pass, by bytes
    (each input read once and each output written once per chunk call) and
    by fp32 operations, counted from the kernels' arithmetic."""
    b, ns, h, w = p['shape']
    ng, chunk = p['geo']['ng'], CHUNK
    field, coef, row, recs = b * ns * h * w, b * h * w, b * ns * w, \
        b * ns * chunk * ng
    fwd_ops = steps * (14 * field + 2 * row)
    work = {
        'fwd_step': (4 * n_calls * (4 * field + 3 * coef + row + chunk
                                    + recs), fwd_ops),
        # The adjoint's steps without the shot sums: the two carries and
        # their cotangents in, the cotangents and the per-shot alpha, t1,
        # t2 cotangents (three fields, not three coefficient maps) out.
        'bwd_reverse_step': (
            4 * n_calls * (9 * field + recs + 3 * coef + 2 * row + chunk),
            steps * (35 * field + coef + b * ns * ng + 2 * row)),
        # The shot sums alone: the blocked adjoint's per-shot coefficient
        # cotangents in (three fields), their sums out, once per chunk.
        'sum_shots': (4 * n_calls * (3 * field + 3 * coef),
                      n_calls * 3 * (ns - 1) * coef),
        # The replay reads the start carry and writes the chunk + 1 slots
        # the taped adjoint reads; it takes chunk - 1 steps a chunk.
        'tape_step': (4 * n_calls * ((chunk + 3) * field + 3 * coef + row
                                     + chunk),
                      n_calls * (chunk - 1) * (14 * field + 2 * row)),
        # The taped adjoint's steps without the shot sums: tape slots
        # 0 .. chunk (not the chunk-end state), the two cotangents in, the
        # two out and the per-shot alpha, t1, t2 cotangents (three fields,
        # not three coefficient maps) out.
        'bwd_tape_step': (
            4 * n_calls * ((chunk + 8) * field + recs + 3 * coef + row
                           + chunk),
            steps * (30 * field + b * ns * ng + 2 * row)),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_FP32_PER_S * 1e3
        out[name] = dict(bound_ms=max(by_bytes, by_ops),
                         bound_by='bytes' if by_bytes >= by_ops
                         else 'operations', bytes=nbytes, ops=ops)
    return out


def phase_kernel_info(shapes, stream_shapes):
    """Registers, spill bytes and resident blocks per SM of every kernel,
    and the blocked kernels' U and tile at each field shape of
    ``shapes``. The blocked kernels must not spill and must fit two blocks
    on an SM. ``tape_step`` at each shape: its blocks per cluster and the
    clusters resident at once; it must not spill and must keep at least
    TAPE_MIN_CLUSTERS resident. ``tape_step_stream`` at each shape of
    ``stream_shapes`` (each the instantiation its resident planes pick):
    its blocks per cluster, planes and resident clusters; no instantiation
    may spill, and the first shape's must keep STREAM_MIN_CLUSTERS
    resident. Returns the infos of tape_step at the first shape and of
    tape_step_stream at the first stream shape."""
    from red_diffeq_tpu_torch.ops import stencil
    tape = stream = None
    for hp, wp in stream_shapes:
        k = stencil.kernel_info('tape_step_stream', hp, wp)
        print(f'tape_step_stream at {hp}x{wp}: {k["regs"]} registers, '
              f'{k["local_bytes"]} local bytes, {k["blocks_per_sm"]} block(s) '
              f'per SM, clusters of {k["ranks"]} blocks, {k["planes"]} '
              f'coefficient plane(s) in shared memory, {k["clusters"]} '
              f'clusters resident at once', flush=True)
        check(k['local_bytes'] == 0, f'tape_step_stream spills to local '
              f'memory at {hp}x{wp}')
        check(k['blocks_per_sm'] >= 1, 'a tape_step_stream block does not '
              'fit an SM')
        stream = stream or k
    check(stream['clusters'] >= STREAM_MIN_CLUSTERS, f'tape_step_stream: '
          f'only {stream["clusters"]} clusters resident, one wave needs '
          f'{STREAM_MIN_CLUSTERS}')
    for hp, wp in shapes:
        k = stencil.kernel_info('tape_step', hp, wp)
        print(f'tape_step at {hp}x{wp}: {k["regs"]} registers, '
              f'{k["local_bytes"]} local bytes, {k["blocks_per_sm"]} block(s) '
              f'per SM, clusters of {k["ranks"]} blocks, {k["clusters"]} '
              f'clusters resident at once', flush=True)
        check(k['local_bytes'] == 0, 'tape_step spills to local memory')
        check(k['blocks_per_sm'] >= 1, 'a tape_step block does not fit an SM')
        check(k['clusters'] >= TAPE_MIN_CLUSTERS, f'tape_step: only '
              f'{k["clusters"]} clusters resident, the design counts on '
              f'{TAPE_MIN_CLUSTERS}')
        tape = tape or k
    for name in stencil.launches:
        if name in ('tape_step', 'tape_step_stream'):
            continue
        k = stencil.kernel_info(name)
        blocked = name in stencil.BLOCKED
        tiles = '; '.join(
            f'{hp}x{wp}: U={u}, tile {ty}x{tx}' for hp, wp in shapes
            for u, ty, tx in [stencil.pick_blocking(name, hp, wp)]
        ) if blocked else {
            'sum_shots': 'four cells a thread, once per chunk',
            'tape_step_global': 'one cell a thread, one launch a step, for '
                                'fields past the cluster limit'}[name]
        print(f'{name}: {k["regs"]} registers, {k["local_bytes"]} local '
              f'bytes, {k["blocks_per_sm"]} blocks per SM ({tiles})',
              flush=True)
        if blocked or name == 'tape_step_global':
            check(k['local_bytes'] == 0, f'{name} spills to local memory')
            check(k['blocks_per_sm'] >= 2, f'{name}: only '
                  f'{k["blocks_per_sm"]} block(s) fit on an SM')
    return tape, stream


def phase_forward(p, label='headline', full=True, plain_reps=2):
    """``fwd_step`` against its plain version over one pass (seismogram and
    every chunk carry), with max abs err per output; its time per pass,
    and with ``full`` the plain version's over ``plain_reps`` passes (1:
    one pass, no warm-up beyond the comparison's)."""
    import torch
    from red_diffeq_tpu_torch.ops import stencil

    stencil.reset_launches()
    seis_k, carries_k = forward_pass(stencil.fwd_chunk, p, keep=True)
    u, per_chunk = (stencil.last_unroll['fwd_step'],
                    stencil.launches['fwd_step'] / len(p['src']))
    seis_p, carries_p = forward_pass(stencil.fwd_chunk_plain, p, keep=True)
    torch.testing.assert_close(seis_k, seis_p, rtol=2e-5, atol=1e-7)
    errs = {'seismogram': float((seis_k - seis_p).abs().max()),
            'p0 carries': 0.0, 'p1 carries': 0.0}
    for (a0, a1), (b0, b1) in zip(carries_k, carries_p):
        torch.testing.assert_close(a0, b0, rtol=2e-5, atol=1e-7)
        torch.testing.assert_close(a1, b1, rtol=2e-5, atol=1e-7)
        errs['p0 carries'] = max(errs['p0 carries'],
                                 float((a0 - b0).abs().max()))
        errs['p1 carries'] = max(errs['p1 carries'],
                                 float((a1 - b1).abs().max()))
    check(torch.isfinite(seis_k).all() and float(seis_k.abs().max()) > 0,
          'forward seismogram is not finite or is all zero')
    print(f'fwd_step vs plain at the {label} shape {p["shape"]}: seismogram '
          f'{tuple(seis_k.shape)}, max abs err '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (max |seis| {float(seis_p.abs().max()):.3e}); U={u}, '
          f'{per_chunk:g} launches per chunk', flush=True)
    ms = cuda_ms(lambda: forward_pass(stencil.fwd_chunk, p), 5)
    plain_ms = (cuda_ms(lambda: forward_pass(stencil.fwd_chunk_plain, p),
                        plain_reps, warm=plain_reps > 1)
                if full else None)
    print(f'fwd pass at the {label} shape ({seis_k.shape[2]} steps): kernel '
          f'{ms:.3f} ms'
          + (f' (one launch per step: {EARLIER_MS["fwd_step"]:.3f} ms)'
             if label == 'headline' else '')
          + (f', plain {plain_ms:.3f} ms' if full else ''), flush=True)
    return (dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms),
            carries_k, seis_k)


def random_grecs(p):
    """One random receiver cotangent (B, ns, chunk, ng) per chunk."""
    import torch
    dev = p['alpha'].device
    gen = torch.Generator(device=dev).manual_seed(4)
    return [torch.randn((*p['shape'][:2], CHUNK, p['geo']['ng']),
                        generator=gen, device=dev)
            for _ in range(len(p['src']))]


def check_outputs(kernel, names, got, want, where, errs=None):
    """Gate each output at max-rel 2e-5; return the largest abs error, and
    keep each output's largest in ``errs``."""
    err = 0.0
    for name, o, w in zip(names, got, want):
        r = max_rel(o, w)
        check(r <= 2e-5, f'{kernel} {where} {name}: max-rel {r:.3e} > 2e-5')
        e = float((o - w).abs().max())
        err = max(err, e)
        if errs is not None:
            errs[name] = max(errs.get(name, 0.0), e)
    return err


GRADS = ('gp0', 'gp1', 'galpha', 'gt1', 'gt2', 'ginj')


def velocity_grad(ctx, backend, mu, y, mask, **kw):
    """Gradient of a masked-L1 observation loss w.r.t. the normalised
    velocity ``mu``, through ``FWIForward(ctx, backend=backend, **kw)``."""
    from red_diffeq_tpu_torch.core.losses import observation_loss
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize,
    )
    op = FWIForward(ctx, v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, backend=backend,
                    chunk=CHUNK, device=mu.device, **kw)
    x = mu.clone().requires_grad_(True)
    observation_loss(op(x), y, mask).sum().backward()
    return x.grad


def gradient_problem(v_true, y):
    """A model near the truth ``v_true`` (m/s), and the observations ``y``
    with a few receivers masked out."""
    import torch
    from red_diffeq_tpu_torch.utils.data_trans import v_normalize
    mask = torch.ones_like(y)
    mask[:, :, :, 10:13] = 0.0
    v = torch.from_numpy(v_true).to(y.device)
    return v_normalize(v) * 0.97, y, mask


def reverse_pass(p, fn, chunk_args, compare=None, kernel=None, errs=None,
                 names=GRADS):
    """Sweep the carry's cotangent through every chunk from the last, with
    ``fn(*chunk_args(i, gp0, gp1), **geo)``; with ``compare``, gate each
    chunk's outputs (``names``) against it and return the largest abs
    error (each output's largest in ``errs``)."""
    import torch
    gp0 = torch.zeros(p['shape'], device=p['alpha'].device)
    gp1 = torch.zeros_like(gp0)
    err = 0.0
    for i in range(len(p['src']) - 1, -1, -1):
        args = chunk_args(i, gp0, gp1)
        out = fn(*args, **p['geo'])
        if compare is not None:
            err = max(err, check_outputs(kernel, names, out,
                                         compare(*args, **p['geo']),
                                         f'chunk {i}', errs))
        gp0, gp1 = out[0], out[1]
    return err


# An adjoint's outputs: its steps' (the alpha, t1, t2 cotangents per
# shot), then their shot sums.
REVERSE_OUT = ('gp0', 'gp1', 'pa', 'pt1', 'pt2', 'ginj', 'galpha', 'gt1',
               'gt2')


def reverse_chunk(steps_fn, sum_fn):
    """An adjoint of one chunk as ``steps_fn`` and ``sum_fn`` over its
    per-shot sums, returning every output of both."""
    def fn(*args, **geo):
        gp0, gp1, pa, p1, p2, ginj = steps_fn(*args, **geo)
        return (gp0, gp1, pa, p1, p2, ginj, *sum_fn(pa, p1, p2))
    return fn


def adjoint_pass(p, name, steps_fn, steps_plain, chunk_args, earlier=True,
                 plain_reps=2):
    """Gate adjoint kernel ``name`` (steps wrapper ``steps_fn``) and
    ``sum_shots`` against their plain versions over a whole reverse pass:
    every output max-rel 2e-5, gp0 and gp1 bit for bit, each output's max
    abs err printed. Then time a pass of the steps alone and of their plain
    version over ``plain_reps`` passes (with ``earlier``, beside the
    headline's time in the previous design). Returns the times and the
    steps' largest abs error."""
    from red_diffeq_tpu_torch.ops import stencil
    errs = {}
    stencil.reset_launches()
    reverse_pass(
        p, reverse_chunk(steps_fn, stencil.sum_shots), chunk_args,
        compare=reverse_chunk(
            steps_plain, lambda *q: [stencil.sum_shots_plain(t) for t in q]),
        kernel=name, errs=errs, names=REVERSE_OUT)
    n_chunks = len(p['src'])
    print(f'{name} vs plain over {n_chunks} chunks: max abs err '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f"; U={stencil.last_unroll[name]}, "
          f"{stencil.launches[name] / n_chunks:g} launches per chunk",
          flush=True)
    for out in ('gp0', 'gp1'):
        check(errs[out] == 0.0, f'{name} {out} differs from its plain '
              f'version by {errs[out]:.3e}')
    ms = cuda_ms(lambda: reverse_pass(p, steps_fn, chunk_args), 5)
    plain_ms = cuda_ms(lambda: reverse_pass(p, steps_plain, chunk_args),
                       plain_reps, warm=plain_reps > 1)
    print(f'{name} pass ({n_chunks * CHUNK} steps), steps alone: kernel '
          f'{ms:.3f} ms'
          + (f' (one launch per step, shot sums in the kernel: '
             f'{EARLIER_MS[name]:.3f} ms)' if earlier else '')
          + f', plain {plain_ms:.3f} ms', flush=True)
    return dict(max_abs_err=max(errs[k] for k in REVERSE_OUT[:6]), ms=ms,
                plain_ms=plain_ms)


def phase_adjoint(p, carries, grad_problem):
    from red_diffeq_tpu_torch.ops import stencil

    grecs = random_grecs(p)
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    res = adjoint_pass(
        p, 'bwd_reverse_step', stencil.bwd_reverse_steps,
        stencil.bwd_reverse_steps_plain,
        lambda i, gp0, gp1: (*carries[i + 1], gp0, gp1, grecs[i], *coef,
                             p['src'][i]))
    res['sum_shots'] = sum_shots_pass(p)
    print(f"tape-free adjoint pass, bwd_reverse_step + sum_shots: "
          f"{res['ms'] + res['sum_shots']['ms']:.3f} ms (one launch per step, "
          f"shot sums in the kernel: {EARLIER_MS['bwd_reverse_step']:.3f} ms)",
          flush=True)
    phase_short_chunk(p, carries, grecs[0])
    # Velocity gradient of a masked-L1 observation loss: kernels vs plain
    # eager autograd through the checkpointed plain path.
    res['grad_max_rel'] = compare_grads(
        HEADLINE, *grad_problem, 'kernels vs plain autograd', ('plain', {}))
    return res


def sum_shots_pass(p, plain_reps=2):
    """``sum_shots`` alone against its plain version on a pass's per-shot
    partials of ``p``'s shape, and its time: device time (the pass's calls
    captured in a CUDA graph and replayed) and per call with the host's
    launch, each beside PyTorch's ``torch.sum`` over the shot axis."""
    import torch
    from red_diffeq_tpu_torch.ops import stencil

    gen = torch.Generator(device=p['alpha'].device).manual_seed(5)
    parts = [[torch.randn(p['shape'], generator=gen,
                          device=p['alpha'].device) for _ in range(3)]
             for _ in range(len(p['src']))]
    err = max(check_outputs('sum_shots', ('galpha', 'gt1', 'gt2'),
                            stencil.sum_shots(*q),
                            [stencil.sum_shots_plain(t) for t in q],
                            f'partials {i}')
              for i, q in enumerate(parts))
    # Device time: a pass's calls captured in a CUDA graph and replayed;
    # per call: each call launched from the host between CUDA events.
    # PyTorch's own reduction over the shot axis, one call per partial sum,
    # is the yardstick both ways.
    def kernel_pass():
        return [stencil.sum_shots(*q) for q in parts]

    def library_pass():
        return [[t.sum(dim=1, keepdim=True) for t in q] for q in parts]

    ms, library_ms = graph_ms(kernel_pass, 20), graph_ms(library_pass, 20)
    host_ms = cuda_ms(kernel_pass, 5)
    library_host_ms = cuda_ms(library_pass, 5)
    plain_ms = cuda_ms(lambda: [[stencil.sum_shots_plain(t) for t in q]
                                for q in parts], plain_reps,
                       warm=plain_reps > 1)
    print(f'sum_shots vs plain, {len(parts)} calls: max abs err {err:.3e}; '
          f'device time (CUDA graph) kernel {ms:.3f} ms, torch.sum '
          f'{library_ms:.3f} ms per pass; per call with the host\'s launch: '
          f'kernel {host_ms:.3f} ms, torch.sum {library_host_ms:.3f} ms, '
          f'plain {plain_ms:.3f} ms per pass', flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, ms_per_call_with_host=host_ms,
                library_ms_per_call_with_host=library_host_ms)


def phase_short_chunk(p, carries, grec, steps=7):
    """One chunk of ``steps`` FD steps (U does not divide it, so the last
    group of each blocked kernel is short) from a mid-pass carry: the
    forward, the tape replay (bit for bit), the tape-free adjoint and the
    taped adjoint (on the plain replay's tape), each adjoint through its
    chunk launcher with its ``sum_shots`` launch, against their plain
    versions."""
    import torch
    from red_diffeq_tpu_torch.ops import stencil

    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    i = len(p['src']) // 2
    src = p['src'][i][:steps].contiguous()
    fwd = [fn(*carries[i], *coef, src, **p['geo'])
           for fn in (stencil.fwd_chunk, stencil.fwd_chunk_plain)]
    e_f = check_outputs('fwd_step', ('p0', 'p1', 'recs'), *fwd,
                        f'{steps}-step chunk')
    args = (*fwd[1][:2], *carries[i + 1], grec[:, :, :steps].contiguous(),
            *coef, src)
    e_b = check_outputs('bwd_reverse_step', GRADS,
                        stencil.bwd_reverse_chunk(*args, **p['geo']),
                        stencil.bwd_reverse_chunk_plain(*args, **p['geo']),
                        f'{steps}-step chunk')
    tape = stencil.tape_chunk_plain(*carries[i], *coef, src,
                                    isz=p['geo']['isz'])
    check(torch.equal(stencil.tape_chunk(*carries[i], *coef, src,
                                         isz=p['geo']['isz']), tape),
          f'tape_step differs from its plain version on a {steps}-step chunk')
    args = (tape, *carries[i + 1], grec[:, :, :steps].contiguous(),
            *coef[:3], src)
    e_t = check_outputs('bwd_tape_step', GRADS,
                        stencil.bwd_tape_chunk(*args, **p['geo']),
                        stencil.bwd_tape_chunk_plain(*args, **p['geo']),
                        f'{steps}-step chunk')
    print(f'{steps}-step chunk (short last group) vs plain: fwd_step max abs '
          f'err {e_f:.3e}, tape_step bit for bit, bwd_reverse_step {e_b:.3e}, '
          f'bwd_tape_step {e_t:.3e}', flush=True)


def phase_determinism(problems):
    """The velocity gradient, computed twice from the same inputs, must
    agree bit for bit, for each (ctx, mu, y, mask) of ``problems``; a third
    run under PyTorch's deterministic mode prints the operations it calls
    nondeterministic."""
    import warnings
    import torch

    for ctx, mu, y, mask in problems:
        where = f"nbc={ctx['nbc']}"
        g1 = velocity_grad(ctx, 'kernel', mu, y, mask)
        g2 = velocity_grad(ctx, 'kernel', mu, y, mask)
        d = float((g1 - g2).abs().max())
        check(torch.equal(g1, g2), f'velocity gradient at {where} differs '
              f'between two identical runs by {d:.3e}')
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                g3 = velocity_grad(ctx, 'kernel', mu, y, mask)
        finally:
            torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).splitlines()[0] for w in caught})
        print(f'determinism at {where}: two runs equal bit for bit; under '
              f'deterministic mode equal: {torch.equal(g1, g3)}, flagged: '
              f'{flagged or "nothing"}', flush=True)


def compare_grads(ctx, mu, y, mask, label, ref, **kw):
    """Velocity gradient through the kernel backend (``kw`` for its
    ``FWIForward``) against ``ref`` = (backend, kwargs): max-rel 1e-4."""
    import torch
    got = velocity_grad(ctx, 'kernel', mu, y, mask, **kw)
    want = velocity_grad(ctx, ref[0], mu, y, mask, **ref[1])
    r = max_rel(got, want)
    check(bool(torch.isfinite(got).all())
          and float(want.abs().max()) > 0, 'gradient is degenerate')
    check(r <= 1e-4, f'velocity gradient ({label}) max-rel {r:.3e} > 1e-4')
    print(f'velocity gradient, {label}: max-rel {r:.3e}', flush=True)
    return r


TAPE_KERNELS = ('tape_step', 'tape_step_stream', 'tape_step_global')


def tape_replays(p, carries, label, plain_reps=2, kernel='tape_step'):
    """The tape replay ``kernel`` (``tape_step``, one launch a chunk; past
    its cluster limit ``tape_step_stream``, one launch a chunk; past that
    one's ``tape_step_global``, one launch a step; as ``stencil.tape_chunk``
    picks it by the field's size) against ``tape_chunk_plain`` on every
    chunk of a pass from the forward kernel's carries, every slot bit for
    bit, and slot chunk (s_{K-1}) against the forward kernel's next carry;
    then both timed over a pass (the plain version over ``plain_reps``
    passes), device time between CUDA events, the kernel with the host's
    launches and as a CUDA graph. Returns the tapes, the times and the
    blocks per cluster."""
    import torch
    from red_diffeq_tpu_torch.ops import stencil

    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    isz = p['geo']['isz']

    def replay(fn, i):
        return fn(*carries[i], *coef, p['src'][i], isz=isz)

    tapes, err = [], 0.0
    stencil.reset_launches()
    for i in range(len(p['src'])):
        tape = replay(stencil.tape_chunk, i)
        want = replay(stencil.tape_chunk_plain, i)
        check(tuple(tape.shape) == tuple(want.shape) == (CHUNK + 1,
                                                         *p['shape']),
              f'tape_step at {label}: tape of shape {tuple(tape.shape)}')
        for j in range(len(tape)):
            d = float((tape[j] - want[j]).abs().max())
            err = max(err, d)
            check(torch.equal(tape[j], want[j]), f'tape_step at {label} '
                  f'chunk {i} slot {j} differs from plain by {d:.3e}')
        # Slot chunk is s_{K-1}, the forward kernel's next p0.
        check(torch.equal(tape[-1], carries[i + 1][0]), f'tape_step at '
              f'{label} chunk {i}: slot {CHUNK} is not fwd_step\'s s_{{K-1}}')
        tapes.append(tape)
    ranks, launched = stencil.last_ranks.get(kernel), stencil.launches[
        kernel]
    per_chunk = CHUNK - 1 if kernel == 'tape_step_global' else 1
    check(launched == per_chunk * len(tapes), f'{kernel} launched '
          f'{launched} times for {len(tapes)} chunks')
    for other in set(TAPE_KERNELS) - {kernel}:
        check(stencil.launches[other] == 0, f'{other} launched at {label}')
    print(f'{kernel} vs plain at {label} {p["shape"]}: {len(tapes)} tapes '
          f'of {len(tapes[0])} slots, every slot bit for bit, slot {CHUNK} = '
          f'fwd_step\'s s_{{K-1}}; '
          + (f'{per_chunk} launches a chunk, one a step'
             if kernel == 'tape_step_global' else
             f'clusters of {ranks} blocks, one launch a chunk'), flush=True)

    def tape_pass(fn):
        for i in range(len(tapes)):
            replay(fn, i)

    ms = cuda_ms(lambda: tape_pass(stencil.tape_chunk), 5)
    graph = graph_ms(lambda: tape_pass(stencil.tape_chunk), 5)
    plain_ms = cuda_ms(lambda: tape_pass(stencil.tape_chunk_plain),
                       plain_reps, warm=plain_reps > 1)
    print(f'tape pass at {label} ({len(tapes) * CHUNK} steps): {kernel} '
          f'{ms:.3f} ms with the host\'s launches, {graph:.3f} ms as a CUDA '
          'graph'
          + (f' (one launch per step, headline: '
             f'{EARLIER_MS["tape_step"]:.3f} ms)' if kernel == 'tape_step'
             else '') + f', plain {plain_ms:.3f} ms', flush=True)
    return tapes, dict(max_abs_err=err, ms=ms, graph_ms=graph,
                       plain_ms=plain_ms, ranks=ranks)


def phase_tape(p, carries, grad_problem, pn, carries_n):
    """The tape kernels at the headline shape with the taped route forced:
    ``tape_step`` against its plain version over a whole pass, at the
    headline and at nbc=40 (``pn``, ``carries_n``), ``bwd_tape_step``
    against its plain version, their pass times, and the taped gradient
    against the tape-free one."""
    from red_diffeq_tpu_torch.ops import stencil

    _, narrow = tape_replays(pn, carries_n, f'nbc={NARROW["nbc"]}')
    tapes, res = tape_replays(p, carries, f'nbc={HEADLINE["nbc"]}')
    res.update(ms_nbc40=narrow['ms'], plain_ms_nbc40=narrow['plain_ms'])
    coef = (p['alpha'], p['t1'], p['t2'])
    grecs = random_grecs(p)
    bwd = adjoint_pass(
        p, 'bwd_tape_step', stencil.bwd_tape_steps,
        stencil.bwd_tape_steps_plain,
        lambda i, gp0, gp1: (tapes[i], gp0, gp1, grecs[i], *coef,
                             p['src'][i]))
    del tapes
    r = compare_grads(HEADLINE, *grad_problem,
                      f"adjoint='tape' vs 'reverse' at nbc={HEADLINE['nbc']}",
                      ('kernel', {'adjoint': 'reverse'}), adjoint='tape')
    return dict(tape_step=res, bwd_tape_step=bwd, grad_max_rel=r)


def phase_small_reference(dev):
    """A few inversion steps through the kernels on the card against the
    plain path on the CPU, with the same weights and draws."""
    import torch
    from red_diffeq_tpu_torch.core import inversion
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    from red_diffeq_tpu_torch.regularization.base import make_reg_fn
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize, v_normalize,
    )

    ctx = dict(n_grid=16, nt=100, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
               gz=10, ng=16, ns=2)
    rng = np.random.RandomState(3)
    v_true = np.full((2, 1, 16, 16), 2000.0, np.float32)
    v_true[:, :, 9:] = 3200.0
    mu0 = np.pad(np.full((2, 1, 16, 16), -0.2, np.float32),
                 ((0, 0), (0, 0), (1, 1), (1, 1)))
    draws = [dict(x0_noise=rng.standard_normal(mu0.shape).astype(np.float32),
                  t=rng.randint(0, 20, 2),
                  reg_noise=rng.standard_normal(mu0.shape).astype(np.float32))
             for _ in range(3)]
    torch.manual_seed(0)
    state = Unet(dim=8, dim_mults=(1, 2), channels=1).state_dict()
    runs = {}
    for device, backend in (('cpu', 'plain'), (dev, 'kernel')):
        op = FWIForward(ctx, v_denorm_func=v_denormalize,
                        s_norm_func=s_normalize_none, backend=backend,
                        chunk=CHUNK, device=device)
        unet = Unet(dim=8, dim_mults=(1, 2), channels=1)
        unet.load_state_dict(state)
        diff = GaussianDiffusion(unet, image_size=18, timesteps=20,
                                 device=device)
        opt = inversion.Adam(inversion.cosine_decay_schedule(0.03, 3))
        step = inversion.make_inversion_step(
            op, make_reg_fn('diffusion', diff), opt, 0.75, 1e-4, True)
        vt = torch.from_numpy(v_true).to(device)
        with torch.no_grad():
            y = op(v_normalize(vt))
        mu = torch.from_numpy(mu0).to(device)
        st = opt.init(mu)
        out = []
        for d in draws:
            mu, st, m = step(mu, st, y=y, mask=torch.ones_like(y),
                             mu_true_norm=v_normalize(vt),
                             **{k: torch.from_numpy(np.asarray(a)).to(device)
                                for k, a in d.items()})
            out.append((mu.cpu(), {k: t.cpu() for k, t in m.items()}))
        runs[backend] = out
    for (mu_c, m_c), (mu_g, m_g) in zip(runs['plain'], runs['kernel']):
        torch.testing.assert_close(mu_g, mu_c, atol=1e-4, rtol=0)
        for k in ('total_losses', 'obs_losses', 'reg_losses', 'mae', 'rmse',
                  'ssim'):
            torch.testing.assert_close(m_g[k], m_c[k], rtol=1e-4, atol=1e-7)
    d = float((runs['kernel'][-1][0] - runs['plain'][-1][0]).abs().max())
    print(f'small inversion, card kernels vs CPU plain: 3 steps, max |d mu| '
          f'{d:.3e}', flush=True)


def load_prior(dev):
    """The dim-64 U-Net diffusion prior with the shipped weights, read by
    the port's own reader."""
    from red_diffeq_tpu_torch.io import checkpoints
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet

    t0 = time.perf_counter()
    diffusion = GaussianDiffusion(Unet(dim=64, dim_mults=(1, 2, 4, 8),
                                       channels=1),
                                  image_size=72, timesteps=1000,
                                  objective='pred_noise', device=dev)
    raw = checkpoints.load_params(CKPT)
    n_leaves = len(checkpoints.flax_to_state_dict(raw, diffusion.model))
    check(n_leaves == 283, f'prior has {n_leaves} leaves, expected 283')
    checkpoints.load_diffusion_params(diffusion, CKPT)
    print(f'prior: {n_leaves} leaves loaded in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    return diffusion


def slice_problem(dev, ctx, batch=BATCH):
    """The headline's ``batch`` velocity models at ``ctx``, their
    observations from the refined operator as ``bench.py`` makes them, and
    the smoothed initial models."""
    import torch
    import torch.nn.functional as F
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        prepare_initial_model, s_normalize_none, v_denormalize, v_normalize,
    )

    t0 = time.perf_counter()
    n, nt, ns, ng = (ctx[k] for k in ('n_grid', 'nt', 'ns', 'ng'))
    v_true = generate_mixed_dataset(batch, h=n, w=n, seed=8888)
    op_obs = acoustic.FWIForward(
        acoustic.refined_ctx(ctx, factor=2), sample_temporal=2,
        v_denorm_func=v_denormalize,
        s_norm_func=s_normalize_none, backend='plain', chunk=CHUNK,
        device=dev)
    with torch.no_grad():
        y = op_obs(v_normalize(torch.from_numpy(
            acoustic.upsample_velocity(v_true, 2)).to(dev)))
    torch.cuda.synchronize()
    check(tuple(y.shape) == (batch, ns, nt, ng)
          and bool(torch.isfinite(y).all()), 'observations are malformed')
    print(f'observations {tuple(y.shape)} at nbc={ctx["nbc"]} (refined x2, '
          f'plain path) in {time.perf_counter() - t0:.2f} s', flush=True)
    init = np.concatenate([prepare_initial_model(v_true[b:b + 1], 'smoothed',
                                                 sigma=10.0)
                           for b in range(batch)])
    mu0 = F.pad(torch.from_numpy(init), (1, 1, 1, 1))
    return dict(v_true=v_true, y=y, mu0=mu0)


def phase_slice(dev, diffusion, ctx, problem, route, adjoint=None):
    """``TS`` RED-DiffEq steps of ``InversionEngine.optimize`` at ``ctx``
    after a one-step warm-up, in the eager loop (``use_scan=False``: the
    U-Net hook fires at every step; the scan slice runs the graph). Checks that the solver took ``route``; that
    the blocked kernels of the route (the forward and the tape-free or the
    taped adjoint) launched ceil(chunk/U) times per chunk, ``sum_shots``
    once per chunk and, on the taped route, ``tape_step`` once per chunk;
    the other route's kernels never, the plain path never; and that every
    sample's observation loss fell; one U-Net call a step at the batch.
    Returns (launches, s/step by the host clock around the steps and by
    the CUDA events behind the U-Net calls, the U each wrapper last handed
    its launcher with tape_step's blocks per cluster)."""
    import torch
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize,
    )

    n = ctx['n_grid']
    op = acoustic.FWIForward(ctx,
                             v_denorm_func=v_denormalize,
                             s_norm_func=s_normalize_none, chunk=CHUNK,
                             adjoint=adjoint, device=dev)
    check(op.backend == 'kernel', f'auto picked {op.backend!r} on the card')
    mode = stencil.resolve_run_config(op.geom, CHUNK, adjoint)[0]
    check(mode == route, f'nbc={ctx["nbc"]}: the solver takes {mode!r}, '
          f'expected {route!r}')
    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)

    def run(ts):
        gen = torch.Generator(device=dev).manual_seed(8888)
        out = engine.optimize(problem['mu0'], problem['v_true'],
                              problem['y'], op, ts=ts, lr=0.03,
                              reg_lambda=0.75, generator=gen,
                              progress=False, use_scan=False)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run(1)                      # warm-up: cuDNN plans, allocator
    warm_s = time.perf_counter() - t0

    seen, handle = step_events(diffusion.model)
    stencil.reset_launches()
    acoustic.plain_chunk_calls['chunk'] = 0
    t0 = time.perf_counter()
    try:
        mu, per_model = run(TS)
    finally:
        handle.remove()
    run_s = time.perf_counter() - t0
    check(seen['batches'] == [BATCH] * TS, f'U-Net calls {seen["batches"]}, '
          f'expected {TS} of batch {BATCH}')
    times = dict(host=run_s / TS, events=step_period(seen['events']))
    counts = dict(stencil.launches)
    unrolls = dict(stencil.last_unroll, tape_step=stencil.last_ranks[
        'tape_step'])
    plain_calls = acoustic.plain_chunk_calls['chunk']

    chunks = TS * len(acoustic.source_chunks(op.geom, CHUNK, 'cpu'))
    hp = n + 2 * ctx['nbc']

    def per_chunk(name):
        return -(-CHUNK // stencil.pick_blocking(name, hp, hp)[0])

    want = dict.fromkeys(counts, 0)
    want['fwd_step'] = chunks * per_chunk('fwd_step')
    want['sum_shots'] = chunks
    if route == 'reverse':
        want['bwd_reverse_step'] = chunks * per_chunk('bwd_reverse_step')
    else:
        want['tape_step'] = chunks
        want['bwd_tape_step'] = chunks * per_chunk('bwd_tape_step')
    print(f'nbc={ctx["nbc"]}, adjoint {route!r}: launches {counts}, plain '
          f'chunks {plain_calls}', flush=True)
    for name in counts:
        check(counts[name] == want[name],
              f'{name} launched {counts[name]} times, expected {want[name]}')
    check(plain_calls == 0, f'the plain path ran {plain_calls} chunks')
    check(tuple(mu.shape) == (BATCH, 1, n, n)
          and bool(torch.isfinite(mu).all())
          and float(mu.abs().max()) <= 1.0, 'inverted model is malformed')
    for i, curves in enumerate(per_model):
        for k, c in curves.items():
            check(len(c) == TS and np.isfinite(c).all(),
                  f'sample {i} {k} is not finite')
        obs = curves['obs_losses']
        check(obs[-1] < obs[1], f'sample {i}: obs loss did not fall '
              f'({obs[1]:.5g} -> {obs[-1]:.5g})')
        print(f'sample {i}: obs {obs[0]:.5g} -> {obs[-1]:.5g}, '
              f'SSIM {curves["ssim"][0]:.4f} -> {curves["ssim"][-1]:.4f}, '
              f'MAE {curves["mae"][-1]:.4f}', flush=True)
    print(f'inversion at nbc={ctx["nbc"]}, adjoint {route!r}: {TS} steps in '
          f'{run_s:.3f} s, {times["host"]:.4f} s/step by the host clock, '
          f'{times["events"]:.4f} by the U-Net calls\' events (warm-up step '
          f'{warm_s:.2f} s)', flush=True)
    return counts, times, unrolls


def phase_narrow(dev, diffusion):
    """The narrow-sponge slice: the taped gradient against plain eager
    autograd at nbc=40, then the inversion with the guard's own route."""
    problem = slice_problem(dev, NARROW)
    r = compare_grads(NARROW,
                      *gradient_problem(problem['v_true'], problem['y']),
                      f'tape kernels vs plain autograd at nbc={NARROW["nbc"]}',
                      ('plain', {}))
    counts, times, unrolls = phase_slice(dev, diffusion, NARROW, problem,
                                         'tape')
    return counts, times, unrolls, r


WIDE_PRESET = 'configs/marmousi/red-diffeq.yaml'
# The TV and Tikhonov presets of the wide slice, each with its observation
# noise type.
BASELINES = (('configs/marmousi/tv.yaml', 'laplace'),
             ('configs/overthrust/tikhonov.yaml', 'gaussian'))
WIDE_ROWS, WIDE_SEED = 70, 1234
WIDE_TS, BASELINE_TS, WIDE_NOISE, WIDE_MISSING = 20, 5, 0.05, 19


def refined_observations(dev, ctx, v_true):
    """Observations of ``v_true`` (m/s) under ``ctx`` from the refined
    operator (dx/2, dt/2, ``sample_temporal=2``) on the plain path (its
    receiver line is strided, which the kernels do not take), as numpy."""
    import torch
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize, v_normalize,
    )
    op_obs = acoustic.FWIForward(
        acoustic.refined_ctx(ctx, factor=2), sample_temporal=2,
        v_denorm_func=v_denormalize, s_norm_func=s_normalize_none,
        backend='plain', chunk=CHUNK, device=dev)
    with torch.no_grad():
        y = op_obs(v_normalize(torch.from_numpy(
            acoustic.upsample_velocity(v_true, 2)).to(dev))).cpu().numpy()
    check(y.shape == (len(v_true), ctx['ns'], ctx['nt'], ctx['ng'])
          and bool(np.isfinite(y).all()), 'observations are malformed')
    return y


def write_wide_dataset(dev, root):
    """The synthetic dataset and configs of the wide slice under ``root``:
    2 models of WIDE_ROWS x the preset's width
    (``generate_mixed_dataset(2, seed=WIDE_SEED)``) with observations from
    :func:`refined_observations`, saved as ``<root>/<Dataset>/{Seismic,Velocity}_Data/synthetic.npy``
    for each preset's dataset; and each preset (WIDE_PRESET and the
    BASELINES) read with the port's ``load_config``, pointed at that data,
    at the shipped prior and at ``<root>/results``, and written back with
    ``save_config``. Returns {preset: config path}."""
    from pathlib import Path
    from red_diffeq_tpu_torch.config import load_config, save_config
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset

    t0 = time.perf_counter()
    root = Path(root)
    ctx = load_config(WIDE_PRESET).pde.to_dict()
    v_true = generate_mixed_dataset(2, h=WIDE_ROWS, w=ctx['n_grid'],
                                    seed=WIDE_SEED)
    y = refined_observations(dev, ctx, v_true)
    paths = {}
    for preset in (WIDE_PRESET, *(b[0] for b in BASELINES)):
        cfg = load_config(preset)
        check(cfg.pde.to_dict() == ctx, f'{preset}: another geometry')
        name = Path(cfg.data.seismic_data_dir).parts[-2]
        for key, sub, arr in (('seismic_data_dir', 'Seismic_Data', y),
                              ('velocity_data_dir', 'Velocity_Data',
                               v_true)):
            (root / name / sub).mkdir(parents=True, exist_ok=True)
            np.save(root / name / sub / 'synthetic.npy', arr)
            cfg.data[key] = str(root / name / sub)
        cfg.diffusion.model_path = str(Path(CKPT).resolve())
        cfg.experiment.results_dir = str(root / 'results')
        paths[preset] = root / f'{name.lower()}-{Path(preset).name}'
        save_config(cfg, paths[preset])
    print(f'wide dataset {v_true.shape}, observations {y.shape} (refined '
          f'x2, plain path) in {time.perf_counter() - t0:.2f} s', flush=True)
    return paths


def run_cli(dev, argv):
    """``red_diffeq_tpu_torch.cli.run_inversion.main(argv)`` on ``dev``,
    with the launch counters and the plain path's chunk count set to 0
    just before it and read just after; the batch of each call of the
    U-Net instance the CLI builds and a CUDA event recorded behind it
    (``step_events``); and the mask that reaches the observation loss."""
    import torch
    from red_diffeq_tpu_torch.cli import run_inversion
    from red_diffeq_tpu_torch.core import inversion
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    seen = dict(batches=[], events=[], masks=[])
    build = run_inversion.build_diffusion_model
    loss = inversion.observation_loss

    def build_and_hook(*args, **kw):
        diffusion = build(*args, **kw)
        hooked, _ = step_events(diffusion.model)
        seen.update(hooked)
        return diffusion

    def spy(predicted, y, mask):
        if not seen['masks']:
            seen['masks'].append(mask)
        return loss(predicted, y, mask)

    run_inversion.build_diffusion_model = build_and_hook
    inversion.observation_loss = spy
    try:
        stencil.reset_launches()
        acoustic.plain_chunk_calls['chunk'] = 0
        t0 = time.perf_counter()
        seen['out'] = run_inversion.main([*argv, '--device', str(dev)])
        torch.cuda.synchronize()
        seen['wall_s'] = time.perf_counter() - t0
        seen['launches'] = dict(stencil.launches)
        seen['unrolls'] = dict(stencil.last_unroll)
        seen['plain'] = acoustic.plain_chunk_calls['chunk']
    finally:
        run_inversion.build_diffusion_model = build
        inversion.observation_loss = loss
    return seen


NPZ_KEYS = ('result', 'initial_velocity', 'ground_truth', 'total_losses',
            'obs_losses', 'reg_losses', 'ssim', 'mae', 'rmse')


def check_run(seen, ts, label, rows, cols):
    """The run directory's ``config.yaml`` and sample 0's results: the nine
    keys, finite, the model ``rows`` x ``cols``, ``ts`` steps, the
    observation loss falling. Returns the curves."""
    out = seen['out']
    check((out / 'config.yaml').is_file(), f'{label}: no config.yaml')
    npz = sorted(out.glob('*/0_results.npz'))
    check(len(npz) == 1, f'{label}: {len(npz)} results for sample 0')
    d = np.load(npz[0])
    check(sorted(d.files) == sorted(NPZ_KEYS), f'{label}: keys {d.files}')
    check(all(np.isfinite(d[k]).all() for k in NPZ_KEYS),
          f'{label}: results are not finite')
    check(d['result'].shape == (rows, cols)
          and d['initial_velocity'].shape == (rows, cols),
          f'{label}: result of shape {d["result"].shape}')
    check(all(len(d[k]) == ts for k in NPZ_KEYS[3:]),
          f'{label}: curves are not {ts} steps long')
    obs = d['obs_losses']
    check(obs[-1] < obs[1], f'{label}: obs loss did not fall '
          f'({obs[1]:.5g} -> {obs[-1]:.5g})')
    print(f'{label}: {npz[0].relative_to(out.parents[2])}: obs {obs[0]:.5g} '
          f'-> {obs[-1]:.5g}, total {d["total_losses"][0]:.5g} -> '
          f'{d["total_losses"][-1]:.5g}, SSIM {d["ssim"][0]:.4f} -> '
          f'{d["ssim"][-1]:.4f}, MAE {d["mae"][-1]:.4f}', flush=True)
    return d


def phase_wide(dev, root):
    """The wide slice: the Marmousi preset through the CLI on the kernels
    (the tape-free route, the 3 windows of the patched RED in one U-Net
    call a step), then the TV and Tikhonov presets with corrupted
    observations. The RED-DiffEq run takes the eager loop
    (``tpu.use_scan: false``), where the U-Net hook sees every step.
    Returns (launches, s per step by the U-Net calls' events, U by kernel,
    the preset's pde settings)."""
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.config import load_config, save_config
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    paths = write_wide_dataset(dev, root)
    ctx = load_config(paths[WIDE_PRESET]).pde.to_dict()
    geom = acoustic.Geometry.from_ctx(ctx)
    hp, wp = WIDE_ROWS + 2 * ctx['nbc'], ctx['n_grid'] + 2 * ctx['nbc']
    route = stencil.resolve_run_config(geom, CHUNK, None)[0]
    check(route == 'reverse', f'the wide preset takes {route!r}')

    # The U-Net hook fires at every step only in the eager loop.
    cfg = load_config(paths[WIDE_PRESET])
    cfg.tpu.use_scan = False
    eager_cfg = Path(root) / 'marmousi-red-diffeq-eager.yaml'
    save_config(cfg, eager_cfg)
    seen = run_cli(dev, ['--config', str(eager_cfg), '--ts', str(WIDE_TS),
                         '--sample_index', '0'])
    counts, chunks = seen['launches'], WIDE_TS * -(-ctx['nt'] // CHUNK)
    want = dict.fromkeys(counts, 0)
    for name in ('fwd_step', 'bwd_reverse_step'):
        want[name] = chunks * -(-CHUNK // stencil.pick_blocking(name, hp,
                                                                wp)[0])
    want['sum_shots'] = chunks
    print(f'wide slice {hp}x{wp}, adjoint {route!r}: launches {counts}, '
          f'plain chunks {seen["plain"]}, U-Net batches {seen["batches"]}',
          flush=True)
    for name in counts:
        check(counts[name] == want[name],
              f'wide: {name} launched {counts[name]} times, expected '
              f'{want[name]}')
    check(seen['plain'] == 0, f'wide: the plain path ran {seen["plain"]} '
          'chunks')
    k = -(-ctx['n_grid'] // WIDE_ROWS)
    check(seen['batches'] == [k] * WIDE_TS, f'wide: U-Net calls '
          f'{seen["batches"]}, expected {WIDE_TS} of batch {k}')
    check_run(seen, WIDE_TS, 'wide slice', WIDE_ROWS, ctx['n_grid'])
    s_step = step_period(seen['events'])
    print(f'wide slice: {s_step:.4f} s per inversion step by the U-Net '
          f'calls\' events (calls 1 to {WIDE_TS - 1}); the CLI took '
          f'{seen["wall_s"]:.2f} s for {WIDE_TS} steps', flush=True)

    for preset, noise_type in BASELINES:
        label = f'{preset} ({noise_type} noise)'
        base = run_cli(dev, [
            '--config', str(paths[preset]), '--ts', str(BASELINE_TS),
            '--sample_index', '0', '--noise_std', str(WIDE_NOISE),
            '--noise_type', noise_type, '--missing_number',
            str(WIDE_MISSING)])
        check(not base['batches'], f'{label}: the U-Net ran')
        check(base['launches']['fwd_step'] > 0 and base['plain'] == 0,
              f'{label}: the kernels did not run the solver')
        mask = base['masks'][0]
        dead = mask == 0
        check(tuple(mask.shape) == (1, ctx['ns'], ctx['nt'], ctx['ng'])
              and torch.equal(dead, dead[:, :1, :1].expand_as(dead))
              and bool((dead[:, 0, 0].sum(dim=-1) == WIDE_MISSING).all()),
              f'{label}: the mask does not zero {WIDE_MISSING} receivers '
              'per sample on every shot')
        d = check_run(base, BASELINE_TS, label, WIDE_ROWS, ctx['n_grid'])
        check(np.isfinite(d['reg_losses']).all() and d['reg_losses'][0] > 0,
              f'{label}: no regulariser')
    return counts, s_step, seen['unrolls'], ctx


def wide_kernels(dev, ctx):
    """Each kernel at the wide field (1 sample, 5 shots, the preset's
    padded field) against its plain version over a pass, with its time
    (the plain version's over one pass): the forward (seismogram and
    carries rtol 2e-5 / atol 1e-7), the tape-free adjoint and
    ``sum_shots``, ``tape_step`` (bit for bit) and the taped adjoint; then
    the velocity gradient through the kernels against plain eager autograd
    and with ``adjoint='tape'`` forced against 'reverse' (max-rel 1e-4)."""
    from red_diffeq_tpu_torch.ops import stencil

    hp, wp = WIDE_ROWS + 2 * ctx['nbc'], ctx['n_grid'] + 2 * ctx['nbc']
    p = headline_problem(dev, ctx, batch=1, rows=WIDE_ROWS)
    check(p['shape'][-2:] == (hp, wp), f'wide field {p["shape"]}')
    label = f'{hp}x{wp}'
    fwd, carries, seis = phase_forward(p, label, plain_reps=1)
    grad_problem = gradient_problem(p['v_true'], seis[:, :, :ctx['nt']])
    del seis
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    grecs = random_grecs(p)
    bwd = adjoint_pass(
        p, 'bwd_reverse_step', stencil.bwd_reverse_steps,
        stencil.bwd_reverse_steps_plain,
        lambda i, gp0, gp1: (*carries[i + 1], gp0, gp1, grecs[i], *coef,
                             p['src'][i]), earlier=False, plain_reps=1)
    sums = sum_shots_pass(p, plain_reps=1)
    tapes, tape = tape_replays(p, carries, label, plain_reps=1)
    btape = adjoint_pass(
        p, 'bwd_tape_step', stencil.bwd_tape_steps,
        stencil.bwd_tape_steps_plain,
        lambda i, gp0, gp1: (tapes[i], gp0, gp1, grecs[i], *coef[:3],
                             p['src'][i]), earlier=False, plain_reps=1)
    del tapes, carries
    r_plain = compare_grads(ctx, *grad_problem,
                            f'kernels vs plain autograd at {label}',
                            ('plain', {}))
    r_tape = compare_grads(ctx, *grad_problem,
                           f"adjoint='tape' vs 'reverse' at {label}",
                           ('kernel', {'adjoint': 'reverse'}),
                           adjoint='tape')
    n_chunks = len(p['src'])
    bnd = bounds(p, n_chunks * CHUNK, n_chunks)
    res = dict(fwd_step=fwd, bwd_reverse_step=bwd, sum_shots=sums,
               tape_step=tape, bwd_tape_step=btape)
    for name, r in res.items():
        r.update(shape=list(p['shape']), bound_ms=bnd[name]['bound_ms'],
                 bound_by=bnd[name]['bound_by'])
        print(f'{name} at {label}: {r["ms"]:.3f} ms per pass, bound '
              f'{r["bound_ms"]:.3f} ms ({r["bound_by"]}), plain '
              f'{r["plain_ms"]:.3f} ms', flush=True)
    res['grad_max_rel'] = dict(plain=r_plain, tape=r_tape)
    return res


# The bench slice: the competitor methods through their CLI at the OpenFWI
# ablation preset's full depth and width, and the Marmousi ablation preset
# (the patched route) with its outer steps cut to BENCH_WIDE_DIFFUSION_TS.
BENCH_PRESET = 'configs/ablation/OpenFWI_Ablation/ablation_all_tricks_dt30_ts10.yaml'
BENCH_WIDE_PRESET = ('configs/ablation/Marmousi_Ablation/'
                     'ablation_all_tricks_dt30_ts10.yaml')
BENCH_METHODS = ('diffusionfwi', 'ilvr')
BENCH_SEED = 4321
# (diffusion_ts, ts) of every bench run, None for the presets' own.
BENCH_DEPTH = None
BENCH_WIDE_DIFFUSION_TS = 4
# The DDIM sampler's steps (the presets' sampling_timesteps) and batch.
SAMPLER_STEPS, SAMPLER_BATCH = 250, 4
BENCH_NPZ_KEYS = tuple(k for k in NPZ_KEYS if k != 'reg_losses')
# Growth of the allocated and peak device memory allowed between the second
# and the last outer step of a bench run.
MEMORY_SLACK = 2 << 20
# Share of the model's cells that may differ by more than 1e-4 between the
# kernels and the plain backend after a short DiffusionFWI run
# (bench_kernels_vs_plain says why any do).
BENCH_PLAIN_SHARE = 0.01


def write_bench_dataset(dev, root):
    """2 synthetic models of 70 x each bench preset family's width
    (``generate_mixed_dataset(2, seed=BENCH_SEED)``) with observations from
    :func:`refined_observations`, saved as the wide slice's are, once a
    family, and each preset (BENCH_PRESET, BENCH_WIDE_PRESET and the
    configurations phase's) read with the port's ``load_config``,
    pointed at its family's data, at sample 0 (``data.sample_index``), at
    the shipped prior (standing in for the presets' ``model-4.ckpt``, which
    the repository does not hold) and at ``<root>/results``, and written
    back. Returns {preset: config path}."""
    from pathlib import Path
    from red_diffeq_tpu_torch.config import load_config, save_config
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset

    t0 = time.perf_counter()
    root = Path(root)
    paths, written = {}, set()
    for preset in (BENCH_PRESET, BENCH_WIDE_PRESET,
                   *dict.fromkeys(config_preset(c) for c in CONFIG_BENCH)):
        cfg = load_config(preset)
        ctx = cfg.pde.to_dict()
        name = Path(cfg.data.seismic_data_dir).parts[-2]
        if name not in written:
            v_true = generate_mixed_dataset(2, h=WIDE_ROWS, w=ctx['n_grid'],
                                            seed=BENCH_SEED)
            y = refined_observations(dev, ctx, v_true)
            for sub, arr in (('Seismic_Data', y), ('Velocity_Data', v_true)):
                (root / name / sub).mkdir(parents=True, exist_ok=True)
                np.save(root / name / sub / 'synthetic.npy', arr)
            written.add(name)
            print(f'{name} family: dataset {v_true.shape}, observations '
                  f'{y.shape} (refined x2, plain path)', flush=True)
        cfg.data.seismic_data_dir = str(root / name / 'Seismic_Data')
        cfg.data.velocity_data_dir = str(root / name / 'Velocity_Data')
        cfg.data.sample_index = 0
        cfg.diffusion.model_path = str(Path(CKPT).resolve())
        cfg.experiment.results_dir = str(root / 'results')
        paths[preset] = root / f'{name.lower()}-{Path(preset).name}'
        save_config(cfg, paths[preset])
        print(f'{preset}: prior {CKPT} in place of '
              f'{load_config(preset).diffusion.model_path}', flush=True)
    print(f'bench datasets in {time.perf_counter() - t0:.2f} s', flush=True)
    return paths


def unet_timer(model, seen):
    """CUDA events before and after each forward of the U-Net instance
    ``model`` (once per outer step), its batch, and the device memory
    allocated and its peak at its end, into ``seen``."""
    import torch

    def pre(module, args):
        seen['starts'].append(torch.cuda.Event(enable_timing=True))
        seen['starts'][-1].record()

    def post(module, args, out):
        seen['batches'].append(args[0].shape[0])
        seen['events'].append(torch.cuda.Event(enable_timing=True))
        seen['events'][-1].record()
        seen['allocated'].append(torch.cuda.memory_allocated())
        seen['peak'].append(torch.cuda.max_memory_allocated())

    return (model.register_forward_pre_hook(pre),
            model.register_forward_hook(post))


def run_bench_cli(dev, argv):
    """``red_diffeq_tpu_torch.cli.run_bench.main(argv)`` on ``dev``, with
    the launch counters, the plain path's chunk count and the peak memory
    reset just before it and read just after, :func:`unet_timer` on the
    U-Net instance the CLI builds, and every observation loss the method
    computes (in its inner FWI steps, with autograd on, and at its
    evaluations) in order, the seconds of ``DiffusionFWI.optimize`` and the
    graphs captured (none). The method's programs run eagerly
    (``graphs.eager_loops()``), so that the hooks and the spy see every
    call; phase ``loop graphs`` holds the same CLI run graphed against
    this one."""
    import torch
    from red_diffeq_tpu_torch.bench_methods import diffusion_fwi
    from red_diffeq_tpu_torch.cli import run_bench
    from red_diffeq_tpu_torch.core import graphs
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    seen = dict(starts=[], batches=[], events=[], allocated=[], peak=[],
                losses=[], sample_s=[])
    build = run_bench.build_diffusion_model
    loss = diffusion_fwi.observation_loss
    optimize = diffusion_fwi.DiffusionFWI.optimize

    def build_and_time(*args, **kw):
        diffusion = build(*args, **kw)
        unet_timer(diffusion.model, seen)
        return diffusion

    def spy(predicted, y, mask):
        out = loss(predicted, y, mask)
        seen['losses'].append((torch.is_grad_enabled(), out.detach()))
        return out

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = optimize(self, *a, **kw)
        torch.cuda.synchronize()
        seen['sample_s'].append(time.perf_counter() - t0)
        return out

    run_bench.build_diffusion_model = build_and_time
    diffusion_fwi.observation_loss = spy
    diffusion_fwi.DiffusionFWI.optimize = timed
    try:
        torch.cuda.reset_peak_memory_stats()
        stencil.reset_launches()
        acoustic.plain_chunk_calls['chunk'] = 0
        captures = graphs.captures['n']
        t0 = time.perf_counter()
        with graphs.eager_loops():
            seen['out'] = run_bench.main([*argv, '--device', str(dev)])
        torch.cuda.synchronize()
        seen['wall_s'] = time.perf_counter() - t0
        seen['launches'] = dict(stencil.launches)
        seen['plain'] = acoustic.plain_chunk_calls['chunk']
        seen['captures'] = graphs.captures['n'] - captures
        seen['run_peak'] = torch.cuda.max_memory_allocated()
    finally:
        run_bench.build_diffusion_model = build
        diffusion_fwi.observation_loss = loss
        diffusion_fwi.DiffusionFWI.optimize = optimize
    return seen


def bench_launches(cfg, label):
    """The launches of a bench run of the config ``cfg`` (the tape-free
    route, which the check requires): (one gradient's, one evaluating
    forward's, the run's: per gradient a pass of ``fwd_step`` and of
    ``bwd_reverse_step``, one ``sum_shots`` a chunk; per outer step an
    evaluation), by kernel."""
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    o, ctx = cfg.optimization, cfg.pde.to_dict()
    dts, ts, chunk = o.diffusion_ts, o.ts, int(cfg.tpu.solver_chunk)
    geom = acoustic.Geometry.from_ctx(ctx)
    route = stencil.resolve_run_config(geom, chunk, None)[0]
    check(route == 'reverse', f'{label}: the preset takes {route!r}')
    hp, wp = WIDE_ROWS + 2 * ctx['nbc'], ctx['n_grid'] + 2 * ctx['nbc']
    chunks = len(acoustic.source_chunks(geom, chunk, 'cpu'))

    def per_chunk(name):
        return -(-chunk // stencil.pick_blocking(name, hp, wp)[0])

    grad = {'fwd_step': chunks * per_chunk('fwd_step'),
            'bwd_reverse_step': chunks * per_chunk('bwd_reverse_step'),
            'sum_shots': chunks}
    evaluation = {'fwd_step': grad['fwd_step']}
    grads, evals = (dts - 1) * ts, dts
    run = dict.fromkeys(stencil.launches, 0)
    for name in grad:
        run[name] = grads * grad[name] + evals * evaluation.get(name, 0)
    return grad, evaluation, run


def bench_run(dev, path, method, label, extra=()):
    """One bench CLI run of the preset config at ``path`` with ``method``:
    exact launch counts (per gradient a pass of ``fwd_step`` and of the
    tape-free adjoint, ``bwd_reverse_step`` and one ``sum_shots`` a chunk;
    per outer step an evaluating forward), the tape kernels never, the plain
    path never; one U-Net call of all windows an outer step; the eight
    ``.npz`` keys, finite, the model in [-1, 1] of the data's shape, one
    curve entry an outer step, the observation loss lower at the last
    outer step than at the first; device memory flat across outer steps.
    Prints SSIM at the initial model and at the end, s per outer step by
    the U-Net calls' events and the U-Net's share. Returns a summary."""
    import torch
    from red_diffeq_tpu_torch.config import load_config
    from red_diffeq_tpu_torch.core.metrics import calculate_metrics
    from red_diffeq_tpu_torch.utils.data_trans import v_normalize

    seen = run_bench_cli(dev, ['--config', str(path), '--method', method,
                               *extra])
    cfg = load_config(seen['out'] / 'config.yaml')
    o, ctx = cfg.optimization, cfg.pde.to_dict()
    dts, ts = o.diffusion_ts, o.ts
    grads, evals = (dts - 1) * ts, dts
    hp, wp = WIDE_ROWS + 2 * ctx['nbc'], ctx['n_grid'] + 2 * ctx['nbc']
    counts = seen['launches']
    want = bench_launches(cfg, label)[2]
    print(f'{label}: {dts} outer x {ts} inner steps ({grads} gradients, '
          f'{evals} evaluations) at {hp}x{wp}: launches {counts}, plain '
          f'chunks {seen["plain"]}, U-Net batches {seen["batches"]}',
          flush=True)
    for name in counts:
        check(counts[name] == want[name], f'{label}: {name} launched '
              f'{counts[name]} times, expected {want[name]}')
    check(seen['plain'] == 0, f'{label}: the plain path ran {seen["plain"]} '
          'chunks')
    kernel = o.get('patch_kernel_size') or [WIDE_ROWS, WIDE_ROWS]
    stride = o.get('patch_stride') or [1, 1]
    windows = ((WIDE_ROWS - kernel[0]) // stride[0] + 1) * (
        (ctx['n_grid'] - kernel[1]) // stride[1] + 1)
    check(seen['batches'] == [windows] * dts, f'{label}: U-Net calls '
          f'{seen["batches"]}, expected {dts} of batch {windows}')

    out = seen['out']
    check((out / 'config.yaml').is_file(), f'{label}: no config.yaml')
    npz = sorted(out.glob('*/0_results.npz'))
    check(len(npz) == 1, f'{label}: {len(npz)} results for sample 0')
    d = np.load(npz[0])
    check(sorted(d.files) == sorted(BENCH_NPZ_KEYS), f'{label}: keys '
          f'{d.files}')
    check(all(np.isfinite(d[k]).all() for k in BENCH_NPZ_KEYS),
          f'{label}: results are not finite')
    check(d['result'].shape == d['initial_velocity'].shape
          == (WIDE_ROWS, ctx['n_grid']), f'{label}: result of shape '
          f'{d["result"].shape}')
    check(float(np.abs(d['result']).max()) <= 1.0, f'{label}: the model '
          'leaves [-1, 1]')
    check(all(len(d[k]) == dts for k in BENCH_NPZ_KEYS[3:]),
          f'{label}: curves are not {dts} outer steps long')
    obs = d['obs_losses']
    # The method's own losses in order: per outer step with FWI, ts inner
    # steps (autograd on), then the evaluation; at t = 0 the evaluation.
    losses = [(grad, float(v[0])) for grad, v in seen['losses']]
    fwi, i = [], 0
    for step in range(dts - 1, -1, -1):
        if step:
            check(all(g for g, _ in losses[i:i + ts]), f'{label}: outer '
                  f'step {step} has no {ts} inner losses')
            start, i = losses[i][1], i + ts
        check(not losses[i][0], f'{label}: no evaluation at outer step '
              f'{step}')
        if step:
            fwi.append((start, losses[i][1]))
        i += 1
    check(i == len(losses) and np.allclose([e for _, e in fwi] + [
        losses[-1][1]], obs, rtol=1e-6), f'{label}: the evaluations are not '
          'the saved curve')
    first = calculate_metrics(
        torch.from_numpy(d['initial_velocity'])[None, None],
        v_normalize(torch.from_numpy(d['ground_truth'])[None, None]))[2]
    # Memory: what is allocated and its peak stay flat from the second
    # outer step on (each of the first steps holds one gradient's worth).
    mib = 1 << 20
    grew = (seen['allocated'][-1] - seen['allocated'][1],
            seen['peak'][-1] - seen['peak'][1])
    print(f'{label}: observation loss by outer step '
          + ' '.join(f'{x:.4g}' for x in obs) + '; SSIM '
          + ' '.join(f'{x:.4f}' for x in d['ssim']) + '; inner FWI loops '
          f'lowered it in {sum(e < b for b, e in fwi)} of {len(fwi)} outer '
          f'steps, by {np.mean([1 - e / b for b, e in fwi]):.1%} on average',
          flush=True)
    print(f'{label}: {npz[0].relative_to(out.parents[2])}: obs '
          f'{obs[0]:.5g} -> {obs[-1]:.5g}, SSIM {float(first):.4f} at the '
          f'initial model -> {d["ssim"][-1]:.4f}, MAE {d["mae"][-1]:.4f}; '
          f'device memory at the U-Net calls: allocated '
          f'{seen["allocated"][1] / mib:.1f} -> '
          f'{seen["allocated"][-1] / mib:.1f} MiB, peak '
          f'{seen["peak"][1] / mib:.1f} -> {seen["peak"][-1] / mib:.1f} MiB',
          flush=True)
    check(max(grew) <= MEMORY_SLACK, f'{label}: device memory grew by '
          f'{max(grew) / mib:.1f} MiB over the outer steps')
    period = (step_period(seen['events']) if len(seen['events']) > 2
              else float('nan'))
    unet_ms = float(np.mean([a.elapsed_time(b) for a, b in
                             zip(seen['starts'], seen['events'])]))
    share = unet_ms / (period * 1e3) if period else float('nan')
    print(f'{label}: {period:.4f} s per outer step by the U-Net calls\' '
          f'events (calls 1 to {dts - 1}), the U-Net {unet_ms:.2f} ms a call '
          f'({share:.1%}); the CLI took {seen["wall_s"]:.2f} s', flush=True)
    # The run as phase 'loop graphs' takes it for the eager twin of its
    # graphed run (loop_bench).
    eager = dict(out=out, s=seen['wall_s'], launches=counts,
                 plain=seen['plain'], peak=seen['run_peak'],
                 captures=seen['captures'], sample_s=seen['sample_s'][-1],
                 outer_s=period, argv=list(extra))
    return dict(counts=counts, s_per_outer_step=period, unet_ms=unet_ms,
                ts=ts, dts=dts, ssim=(float(first), float(d['ssim'][-1])),
                wall_s=seen['wall_s'], fwi=fwi, eager=eager)


def bench_kernel_ms(dev, ctx):
    """Device time (ms) of one pass of the forward kernel and of the
    tape-free adjoint (``bwd_reverse_step`` with its ``sum_shots``) at
    ``ctx`` for one sample, between CUDA events, and each kernel's bound
    there (:func:`bounds`)."""
    from red_diffeq_tpu_torch.ops import stencil
    p = headline_problem(dev, ctx, batch=1, rows=WIDE_ROWS)
    _, carries = forward_pass(stencil.fwd_chunk, p, keep=True)
    grecs = random_grecs(p)
    coef = (p['alpha'], p['t1'], p['t2'], p['inj'])
    fwd = cuda_ms(lambda: forward_pass(stencil.fwd_chunk, p), 5)
    adj = cuda_ms(lambda: reverse_pass(
        p, reverse_chunk(stencil.bwd_reverse_steps, stencil.sum_shots),
        lambda i, gp0, gp1: (*carries[i + 1], gp0, gp1, grecs[i], *coef,
                             p['src'][i])), 5)
    n_chunks = len(p['src'])
    return fwd, adj, bounds(p, n_chunks * CHUNK, n_chunks)


def bench_kernels_vs_plain(dev, diffusion, path):
    """One short ``DiffusionFWI.optimize`` (2 outer x 2 inner steps, the
    preset's tricks, sample 0 of its dataset) on the kernels and on the
    plain backend, on the card: the curves rtol 1e-4; the model atol 1e-4 on
    all but BENCH_PLAIN_SHARE of its cells and within a tenth of one Adam
    step (0.1 lr) on every cell. The kernels' velocity gradient differs
    from the plain path's by max-rel ~1e-5 of its largest value; the max-abs
    normalisation and Adam's per-cell normalised step turn that into a
    different fraction of a full step (lr) wherever a cell's gradient is
    within that error of 0, so the model's max-abs difference is not
    bounded by 1e-4 (on the card 1.7e-3 at 4 of 4900 cells). Returns the
    largest difference and the share of cells beyond 1e-4."""
    import torch
    from red_diffeq_tpu_torch.bench_methods import DiffusionFWI
    from red_diffeq_tpu_torch.config import load_config
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    from red_diffeq_tpu_torch.utils.data_trans import (
        prepare_initial_model, s_normalize_none, v_denormalize,
    )

    cfg = load_config(path)
    o = cfg.optimization
    v_true = np.load(f'{cfg.data.velocity_data_dir}/synthetic.npy')[:1]
    y = np.load(f'{cfg.data.seismic_data_dir}/synthetic.npy')[:1]
    mu0 = prepare_initial_model(v_true, o.initial_type, sigma=o.sigma)
    runs = {}
    for backend in ('kernel', 'plain'):
        op = FWIForward(cfg.pde.to_dict(), v_denorm_func=v_denormalize,
                        s_norm_func=s_normalize_none, backend=backend,
                        chunk=CHUNK, device=dev)
        t0 = time.perf_counter()
        runs[backend] = DiffusionFWI(diffusion, op, device=dev).optimize(
            mu0, v_true, y, op, ts=2, diffusion_ts=2, lr=o.lr,
            grad_norm=o.grad_norm, grad_smooth=o.grad_smooth,
            model_blur=o.model_blur, grad_clip=o.grad_clip,
            generator=torch.Generator(device=dev).manual_seed(0),
            progress=False)
        torch.cuda.synchronize()
        runs[backend + '_s'] = time.perf_counter() - t0
    (mu_k, c_k), (mu_p, c_p) = runs['kernel'], runs['plain']
    diff = (mu_k - mu_p).abs()
    d, share = float(diff.max()), float((diff > 1e-4).float().mean())
    print(f'DiffusionFWI 2 x 2 steps, kernels vs plain on the card: max |d '
          f'mu| {d:.3e}, {share:.2%} of the cells beyond 1e-4, mean '
          f'{float(diff.mean()):.3e}; obs {c_k[0]["obs_losses"][-1]:.6g} vs '
          f'{c_p[0]["obs_losses"][-1]:.6g}; {runs["kernel_s"]:.2f} s vs '
          f'{runs["plain_s"]:.2f} s', flush=True)

    check(share <= BENCH_PLAIN_SHARE and d <= 0.1 * o.lr,
          f'kernels vs plain: max |d mu| {d:.3e} (at most {0.1 * o.lr:.3g}), '
          f'{share:.2%} of the cells beyond 1e-4 (at most '
          f'{BENCH_PLAIN_SHARE:.0%})')
    for k in c_k[0]:
        np.testing.assert_allclose(c_k[0][k], c_p[0][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    return d, share


def bench_sampler(dev, path):
    """The preset's diffusion built by the inversion CLI's
    ``build_diffusion_model`` with
    ``sampling_timesteps`` = SAMPLER_STEPS (DDIM), and SAMPLER_BATCH
    images sampled from it: the shape, finite, in [0, 1]; its time."""
    import torch
    from red_diffeq_tpu_torch.cli.run_inversion import build_diffusion_model
    from red_diffeq_tpu_torch.config import load_config

    cfg = load_config(path)
    cfg.diffusion.sampling_timesteps = SAMPLER_STEPS
    diffusion = build_diffusion_model(cfg, device=dev)
    check(diffusion.is_ddim_sampling
          and diffusion.sampling_timesteps == SAMPLER_STEPS,
          'build_diffusion_model did not pass sampling_timesteps')
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    img = diffusion.sample(SAMPLER_BATCH, generator=gen)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    h, w = diffusion.image_size
    check(tuple(img.shape) == (SAMPLER_BATCH, 1, h, w)
          and bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
          and float(img.max()) <= 1.0, f'DDIM samples of shape '
          f'{tuple(img.shape)} out of range or not finite')
    print(f'DDIM sample, batch {SAMPLER_BATCH}, {SAMPLER_STEPS} steps: '
          f'{took:.2f} s ({took / SAMPLER_STEPS * 1e3:.2f} ms a step), '
          f'values in [{float(img.min()):.4f}, {float(img.max()):.4f}]',
          flush=True)
    return diffusion, took


def phase_bench(dev, root):
    """The bench slice (the datasets and presets of phases 'loop graphs'
    and 'configurations' written under ``root`` too). Returns the launches
    of the OpenFWI DiffusionFWI run, each run's summary and the presets'
    config paths."""
    from red_diffeq_tpu_torch.config import load_config

    paths = write_bench_dataset(dev, root)
    depth = ([] if BENCH_DEPTH is None else
             ['--diffusion_ts', str(BENCH_DEPTH[0]), '--ts',
              str(BENCH_DEPTH[1])])
    runs = {}
    for method in BENCH_METHODS:
        runs[method] = bench_run(dev, paths[BENCH_PRESET], method,
                                 f'{method}, OpenFWI ablation preset', depth)
    cut = ['--diffusion_ts', str(BENCH_WIDE_DIFFUSION_TS), *depth[2:]]
    for method in BENCH_METHODS:
        runs[f'{method} wide'] = bench_run(
            dev, paths[BENCH_WIDE_PRESET], method,
            f'{method}, Marmousi ablation preset (diffusion_ts cut to '
            f'{BENCH_WIDE_DIFFUSION_TS})', cut)
    diffusion, sampler_s = bench_sampler(dev, paths[BENCH_PRESET])
    d_mu, share = bench_kernels_vs_plain(dev, diffusion, paths[BENCH_PRESET])
    ctx = load_config(paths[BENCH_PRESET]).pde.to_dict()
    fwd, adj, bnd = bench_kernel_ms(dev, ctx)
    print(f'kernels at B=1 ({WIDE_ROWS + 2 * ctx["nbc"]}x'
          f'{ctx["n_grid"] + 2 * ctx["nbc"]} field): '
          f'fwd_step {fwd:.3f} ms a pass, bwd_reverse_step with sum_shots '
          f'{adj:.3f} ms; bounds: '
          + ', '.join(f'{k} {bnd[k]["bound_ms"]:.4f} ms ({bnd[k]["bound_by"]})'
                      for k in ('fwd_step', 'bwd_reverse_step',
                                'sum_shots')), flush=True)
    for method in BENCH_METHODS:
        r = runs[method]
        kernels = r['ts'] * (fwd + adj) + fwd
        print(f'{method}: {r["s_per_outer_step"]:.4f} s per outer step, of '
              f'which the kernels {kernels:.1f} ms ({r["ts"]} x (forward '
              f'{fwd:.3f} + adjoint {adj:.3f}) + forward, one sample, '
              f'device time) and the U-Net {r["unet_ms"]:.2f} ms; '
              f'{r["wall_s"]:.2f} s for the sample ({r["dts"]} outer steps)',
              flush=True)
    return runs[BENCH_METHODS[0]]['counts'], dict(
        runs=runs, sampler_s=sampler_s, kernels_vs_plain=(d_mu, share),
        paths=paths)


# Past tape_step's cluster limit: a 320x320 model at nbc=50 pads to
# 420x420, whose strip of ceil(420/16) rows does not fit a block's shared
# memory beside its three coefficient planes (tape_step_stream keeps two);
# at nbc=50 the t2 guard takes the taped route by itself. B=1, a short nt.
BEYOND = dict(HEADLINE, n_grid=320, ng=320, nbc=50, nt=200)
# 680x680, whose strip's two states alone do not fit (tape_step_global);
# one chunk.
BEYOND_STREAM = dict(HEADLINE, n_grid=580, ng=580, nbc=50, nt=CHUNK)


def beyond_gradient(p, ctx, seis, label, expect_tape):
    """The velocity gradient on ``p``'s field through the kernels (launches
    counted from 0 just before and read just after: the forward's and the
    taped adjoint's blocked launches, one ``sum_shots`` a chunk and
    ``expect_tape`` of the tape replays, no other tape replay, the
    tape-free adjoint and the plain path never) against plain eager
    autograd, max-rel 1e-4. Returns the launches and the max-rel."""
    import torch
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    hp = p['shape'][-1]
    mu, y, mask = gradient_problem(p['v_true'], seis[:, :, :ctx['nt']])
    stencil.reset_launches()
    acoustic.plain_chunk_calls['chunk'] = 0
    got = velocity_grad(ctx, 'kernel', mu, y, mask)
    counts = dict(stencil.launches)
    plain_calls = acoustic.plain_chunk_calls['chunk']
    want = velocity_grad(ctx, 'plain', mu, y, mask)
    r = max_rel(got, want)
    check(bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0,
          f'gradient at {label} is degenerate')
    check(r <= 1e-4, f'velocity gradient at {label} max-rel {r:.3e} > 1e-4')
    n_chunks = len(p['src'])
    expect = dict.fromkeys(counts, 0)
    for name in ('fwd_step', 'bwd_tape_step'):
        expect[name] = n_chunks * -(-CHUNK // stencil.pick_blocking(
            name, hp, hp)[0])
    expect.update(sum_shots=n_chunks, **expect_tape)
    for name in counts:
        check(counts[name] == expect[name], f'{label} gradient: {name} '
              f'launched {counts[name]} times, expected {expect[name]}')
    check(plain_calls == 0, f'the plain path ran {plain_calls} chunks')
    print(f'velocity gradient at {label} (B=1, nbc={ctx["nbc"]}, nt='
          f'{ctx["nt"]}), kernels vs plain autograd: max-rel {r:.3e}; '
          f'launches {counts}', flush=True)
    return counts, r


def phase_beyond(dev):
    """The taped route on fields past ``tape_step``'s cluster limit. At
    420x420 (BEYOND): the route and the instantiation picked by size,
    ``tape_step_stream`` (two coefficient planes in shared memory) against
    ``tape_chunk_plain`` bit for bit on every slot of one pass and its
    time per pass; ``tape_step_global`` forced at the same pass (the stream
    picker's refusal), bit for bit, timed; then the velocity gradient
    through the kernels (``beyond_gradient``: one ``tape_step_stream`` a
    chunk, ``tape_step_global`` never) against plain eager autograd. At
    680x680 (BEYOND_STREAM), past ``tape_step_stream``'s limit, one chunk:
    ``tape_step_global`` by size, bit for bit, timed, and the gradient with
    its chunk - 1 launches. Returns both kernels' numbers and the gradient
    runs' launches."""
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    out = {}
    for ctx, kernel in ((BEYOND, 'tape_step_stream'),
                        (BEYOND_STREAM, 'tape_step_global')):
        hp = ctx['n_grid'] + 2 * ctx['nbc']
        label = f'{hp}x{hp}'
        geom = acoustic.Geometry.from_ctx(ctx)
        mode = stencil.resolve_run_config(geom, CHUNK)[0]
        ranks, plan = stencil.pick_ranks(hp, hp), stencil.pick_stream(hp, hp)
        check(mode == 'tape' and ranks is None
              and (plan is None) == (kernel == 'tape_step_global'),
              f'{label} at nbc={ctx["nbc"]}: adjoint {mode!r}, tape_step '
              f'clusters of {ranks} blocks, tape_step_stream plan {plan}; '
              f"expected 'tape' and {kernel}")
        p = headline_problem(dev, ctx, batch=1)
        seis, carries = forward_pass(stencil.fwd_chunk, p, keep=True)
        _, res = tape_replays(p, carries, label, plain_reps=1, kernel=kernel)
        n_chunks = len(p['src'])
        bnd = bounds(p, n_chunks * CHUNK, n_chunks)['tape_step']
        res.update(shape=p['shape'], bound_ms=bnd['bound_ms'],
                   bound_by=bnd['bound_by'])
        if kernel == 'tape_step_stream':
            # The twin, forced at the same pass: the stream picker refuses.
            pick_stream = stencil.pick_stream
            stencil.pick_stream = lambda h, w: None
            try:
                _, forced = tape_replays(p, carries, f'{label}, forced',
                                         plain_reps=1,
                                         kernel='tape_step_global')
            finally:
                stencil.pick_stream = pick_stream
            out['global_at_stream'] = forced
            expect = dict(tape_step_stream=n_chunks)
        else:
            expect = dict(tape_step_global=n_chunks * (CHUNK - 1))
        del carries
        res['counts'], res['grad_max_rel'] = beyond_gradient(
            p, ctx, seis, label, expect)
        print(f'{kernel} at {label}: {res["ms"]:.3f} ms per pass with the '
              f'host\'s launches, {res["graph_ms"]:.3f} ms as a CUDA graph, '
              f'against a bound of {res["bound_ms"]:.3f} ms '
              f'({res["bound_by"]})', flush=True)
        out[kernel] = res
    return out


# The training slice: red-diffeq-torch-datagen, red-diffeq-torch-train at
# its defaults (the shipped prior's width: a dim-64 U-Net at 72x72, batch
# 32, lr 2e-4), graphed against eager, the resume (RESUME_STEPS steps from
# the eager run's milestone) and the EMA export.
TRAIN_FAMILY_N = 64          # velocity models a family, 4 families
TRAIN_STEPS, TRAIN_SAVE_EVERY, RESUME_STEPS = 200, 100, 10
TRAIN_ARGS = []              # the CLI's defaults
SIM_N = 8                    # models of the seismogram run, one batch
RED_TS = 5                   # RED-DiffEq steps on the exported prior
EXPORT_TOOL = 'tools/export_ema_torch.py'


def run_datagen(dev, argv):
    """``red-diffeq-torch-datagen`` with ``argv`` on ``dev``, the launch
    counters and the plain path's chunk count set to 0 just before and read
    just after; returns (dataset root, launches, plain chunks, seconds of
    each simulated batch)."""
    import torch
    from red_diffeq_tpu_torch.cli import datagen
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    timed, seconds = datagen.FWIForward.__call__, []

    def call(op, v):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = timed(op, v)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    datagen.FWIForward.__call__ = call
    stencil.reset_launches()
    acoustic.plain_chunk_calls['chunk'] = 0
    try:
        root = datagen.main([*argv, '--device', dev.type])
    finally:
        datagen.FWIForward.__call__ = timed
    return (root, dict(stencil.launches), acoustic.plain_chunk_calls['chunk'],
            seconds)


def train_cli(dev, argv, eager=False):
    """``red-diffeq-torch-train`` with ``argv`` on ``dev``. A forward hook
    on the U-Net instance the CLI builds records a CUDA event and the
    allocated device memory at each train step's forward (grad enabled;
    the samplers run without), and each milestone's sampling, FID and save
    is timed. The hook fires at every step only with ``eager`` (the train
    steps and samplers run in ``graphs.eager_loops()``); graphed, only at
    each graph's warm-up and capture. Returns (trainer, events, memory,
    milestone seconds)."""
    import torch
    from red_diffeq_tpu_torch.cli import diffusion_train
    from red_diffeq_tpu_torch.core import graphs
    from red_diffeq_tpu_torch.models import trainer as trainer_mod

    seen = dict(events=[], memory=[], milestones=[])
    build = diffusion_train.build_diffusion
    sample_and_save = trainer_mod.Trainer._sample_and_save

    def hooked(*a, **kw):
        diffusion = build(*a, **kw)

        def hook(module, args, out):
            if torch.is_grad_enabled():
                seen['events'].append(torch.cuda.Event(enable_timing=True))
                seen['events'][-1].record()
                seen['memory'].append(torch.cuda.memory_allocated())

        diffusion.model.register_forward_hook(hook)
        return diffusion

    def timed(self, milestone):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_and_save(self, milestone)
        torch.cuda.synchronize()
        seen['milestones'].append(time.perf_counter() - t0)

    diffusion_train.build_diffusion = hooked
    trainer_mod.Trainer._sample_and_save = timed
    try:
        with (graphs.eager_loops() if eager else contextlib.nullcontext()):
            trainer = diffusion_train.main([*argv, '--device', dev.type])
    finally:
        diffusion_train.build_diffusion = build
        trainer_mod.Trainer._sample_and_save = sample_and_save
    torch.cuda.synchronize()
    return trainer, seen['events'], seen['memory'], seen['milestones']


def phase_training(dev, root):
    """The training half of the system through its entry points: datasets
    from ``red-diffeq-torch-datagen`` (velocities, then seismograms on the
    forward kernel, held against the plain path at the forward gate, and a
    310x430 family), ``red-diffeq-torch-train`` at the shipped prior's
    width with milestones and the FID proxy, the train CLI graphed against
    eager (:func:`loop_trainer`) and a resume of the eager run's milestone,
    the EMA export, and RED-DiffEq on the exported prior. Returns the
    numbers it printed, the graphed-against-eager run's and the seismogram
    run's launches."""
    import importlib.util
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.io.checkpoints import load_diffusion_params
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers.acoustic import FWIForward
    from red_diffeq_tpu_torch.utils.data_trans import (
        prepare_initial_model, s_normalize_none, v_denormalize, v_normalize,
    )

    root = Path(root)
    n, nt, ns, nbc = (HEADLINE[k] for k in ('n_grid', 'nt', 'ns', 'nbc'))
    # 1. Datasets.
    t0 = time.perf_counter()
    run_datagen(dev, ['--out', str(root / 'train'), '--n',
                      str(TRAIN_FAMILY_N), '--velocity_only'])
    vel_s = time.perf_counter() - t0
    sim, counts, plain_calls, sim_s = run_datagen(dev, [
        '--out', str(root / 'sim'), '--n', str(SIM_N), '--families',
        'FlatVel', '--sim_batch', str(SIM_N), '--height', str(n), '--width',
        str(n), '--nt', str(nt), '--ns', str(ns), '--nbc', str(nbc)])
    hp = n + 2 * nbc
    per_chunk = -(-CHUNK // stencil.pick_blocking('fwd_step', hp, hp)[0])
    expect = dict.fromkeys(counts, 0)
    expect['fwd_step'] = -(-nt // CHUNK) * per_chunk
    check(counts == expect and plain_calls == 0, f'datagen launches '
          f'{counts}, plain chunks {plain_calls}; expected {expect}, 0')
    vel = np.load(sim / 'Velocity_Data' / 'FlatVel.npy')
    seis = np.load(sim / 'Seismic_Data' / 'FlatVel.npy')
    check(seis.shape == (SIM_N, ns, nt, n) and np.isfinite(seis).all(),
          f'datagen seismograms of shape {seis.shape}')
    plain = FWIForward(dict(HEADLINE), v_denorm_func=v_denormalize,
                       s_norm_func=s_normalize_none, backend='plain',
                       chunk=CHUNK, device=dev)
    with torch.no_grad():
        want = plain(v_normalize(torch.from_numpy(vel).to(dev)))
    got = torch.from_numpy(seis).to(dev)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-7)
    seis_err = float((got - want).abs().max())
    _, wide_counts, _, wide_s = run_datagen(dev, [
        '--out', str(root / 'wide'), '--n', '2', '--width', '190',
        '--families', 'CurveFault', '--nt', str(nt), '--nbc', str(nbc)])
    wide = np.load(root / 'wide' / 'Seismic_Data' / 'CurveFault.npy')
    check(wide.shape == (2, ns, nt, 190) and np.isfinite(wide).all()
          and np.abs(wide).max() > 0, f'wide seismograms {wide.shape}')
    print(f'datagen: {4 * TRAIN_FAMILY_N} velocity models in {vel_s:.2f} s; '
          f'seismograms of {SIM_N} models ({hp}x{hp}, nt={nt}) in '
          f'{sim_s[0]:.3f} s a simulated batch, launches {counts}, against '
          f'the plain path max abs err {seis_err:.3e}; 2 models at 310x430 '
          f'in {wide_s[0]:.3f} s ({wide_counts["fwd_step"]} fwd_step '
          'launches)', flush=True)

    # 2. Training at the CLI's defaults (its cuDNN settings included).
    run = root / 'run'
    data = ['--data_dir', str(root / 'train' / 'Velocity_Data'),
            '--save_every', str(TRAIN_SAVE_EVERY), *TRAIN_ARGS]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, events, memory, milestone_s = train_cli(
        dev, [*data, '--results_folder', str(run), '--calculate_fid',
              '--train_num_steps', str(TRAIN_STEPS)], eager=True)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [e['loss'] for e in trainer.training_losses]
    check(trainer.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS
          and len(events) == TRAIN_STEPS and np.isfinite(losses).all(),
          f'trainer at step {trainer.step} with {len(losses)} losses and '
          f'{len(events)} train forwards')
    k = min(20, TRAIN_STEPS // 2)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    check(last < 0.5 * first, f'loss did not fall to half: first {k} steps '
          f'{first:.4f}, last {k} {last:.4f}')
    n_ms = TRAIN_STEPS // TRAIN_SAVE_EVERY
    fid = json.loads((run / 'fid_scores.json').read_text())
    check(len(fid) == n_ms and all(np.isfinite(e['fid_frozen']) for e in fid),
          f'fid_scores.json: {fid}')
    for m in range(1, n_ms + 1):
        for name in (f'model-{m}.ckpt', f'training_losses-{m}.json'):
            check((run / name).exists(), f'milestone {m}: no {name}')
        smp = np.load(run / f'sample-{m}.npy')
        check(smp.shape == (25, 1, 72, 72) and smp.min() >= 0.0
              and smp.max() <= 1.0, f'sample-{m}.npy: {smp.shape}, '
              f'[{smp.min():.3f}, {smp.max():.3f}]')
    steady = memory[1:]
    grew = max(steady) - min(steady)
    check(grew <= MEMORY_SLACK, f'device memory moved by {grew} bytes over '
          'the train steps')
    # Spacing of the train steps' events up to the first milestone (the
    # first step warms up).
    span = min(TRAIN_SAVE_EVERY, TRAIN_STEPS) - 1

    def per_step(events):
        return events[1].elapsed_time(events[span]) / (span - 1) / 1e3

    s_step = per_step(events)
    batch = trainer.batch_size
    print(f'train: {TRAIN_STEPS} steps in {train_s:.2f} s; '
          f'{s_step:.4f} s per train step (CUDA events), '
          f'{batch / s_step:.1f} images/s at batch {batch}; peak device '
          f'memory {peak / 2**20:.1f} MiB, allocated {min(steady) / 2**20:.1f}'
          f'-{max(steady) / 2**20:.1f} MiB over the steps; milestones '
          + ', '.join(f'{t:.2f}' for t in milestone_s)
          + f' s (25-sample DDIM grid, {trainer.num_fid_samples}-sample '
          f'FID, save); loss {first:.4f} (first {k}) -> {last:.4f} (last '
          f'{k}); fid_frozen ' + ', '.join(f'{e["fid_frozen"]:.3f}'
                                           for e in fid), flush=True)

    # 3. The train CLI graphed against eagerly under deterministic cuDNN
    # (loop_trainer: the CLI's default lets cuDNN pick convolution
    # algorithms whose sums may run in another order each call), with a
    # milestone after 2 * LOOP_TRAIN_STEPS steps and no FID, which the run
    # above covers; then that eager run's milestone 1 resumed, graphed, for
    # RESUME_STEPS steps, which must repeat the eager run's losses.
    lt = loop_trainer(dev, root, root / 'train' / 'Velocity_Data')
    at = 2 * LOOP_TRAIN_STEPS
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        resumed, _, _, _ = train_cli(dev, [
            '--data_dir', str(root / 'train' / 'Velocity_Data'),
            '--save_every', str(10 ** 6), *TRAIN_ARGS, '--results_folder',
            str(lt['eager_folder']), '--train_num_steps',
            str(at + RESUME_STEPS), '--resume_milestone', '1'])
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    got = resumed.training_losses[at:]
    check(resumed.step == at + RESUME_STEPS
          and [e['step'] for e in got] == list(range(at, at + RESUME_STEPS)),
          f'resume reached step {resumed.step}')
    want = lt['losses'][at:at + RESUME_STEPS]
    check(len(want) == RESUME_STEPS, f'the eager run has {len(want)} losses '
          f'after step {at}')
    np.testing.assert_allclose([e['loss'] for e in got], want, rtol=1e-5)
    resume_d = max(abs(e['loss'] - w) / abs(w) for e, w in zip(got, want))
    s_step_det = lt['s_eager']
    print(f'train under deterministic cuDNN (the eager run resumed): '
          f'{s_step_det:.4f} s per train step (host clock), '
          f'{batch / s_step_det:.1f} images/s', flush=True)
    dim = trainer.diffusion.model.dim
    del trainer, resumed

    # 4. Export the EMA prior and run RED-DiffEq on it.
    spec = importlib.util.spec_from_file_location('export_ema_torch',
                                                  EXPORT_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    prior_path = tool.main(['--run', str(run), '--out',
                            str(root / 'ema.ckpt')])
    diffusion = GaussianDiffusion(Unet(dim=dim, dim_mults=(1, 2, 4, 8)),
                                  image_size=n + 2, timesteps=1000,
                                  device=dev)
    load_diffusion_params(diffusion, prior_path)
    op = FWIForward(dict(HEADLINE), v_denorm_func=v_denormalize,
                    s_norm_func=s_normalize_none, chunk=CHUNK, device=dev)
    v_true = vel[:1]
    mu0 = torch.nn.functional.pad(torch.from_numpy(prepare_initial_model(
        v_true, 'smoothed', sigma=10.0)), (1, 1, 1, 1))
    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)
    _, per_model = engine.optimize(
        mu0, v_true, torch.from_numpy(seis[:1]).to(dev), op, ts=RED_TS,
        lr=0.03, reg_lambda=0.75,
        generator=torch.Generator(device=dev).manual_seed(8888),
        progress=False)
    obs, tot = per_model[0]['obs_losses'], per_model[0]['total_losses']
    check(np.isfinite(tot).all() and obs[-1] < obs[1], f'RED-DiffEq on the '
          f'exported prior: obs loss {obs[1]:.5g} -> {obs[-1]:.5g}')
    print(f'resume from milestone 1: steps {at}-{at + RESUME_STEPS - 1} '
          f'repeat the uninterrupted losses (max rel diff {resume_d:.3e}); exported EMA prior -> '
          f'{RED_TS} RED-DiffEq steps on sample 0 of the seismogram run: obs '
          f'loss {obs[1]:.5g} -> {obs[-1]:.5g}, total {tot[0]:.5g} -> '
          f'{tot[-1]:.5g}, SSIM {per_model[0]["ssim"][0]:.4f} -> '
          f'{per_model[0]["ssim"][-1]:.4f}', flush=True)
    return dict(counts=counts, run=str(run), s_per_step=s_step,
                images_per_s=batch / s_step,
                peak_mib=peak / 2**20, milestone_s=milestone_s,
                sim_s=sim_s[0], resume_max_rel=resume_d,
                s_per_step_deterministic=s_step_det, loop_trainer=lt)


# The stencil-layout probe at the JAX tool's default workload
# (tools/kernel_layout_probe.py: batch 4 x 5 shots = 20 fields of 310x310,
# nt=1000), its kernels' source, the lines of the TPU kernels they replace,
# and its gates: the steps of the JAX tool's check against roll, which
# holds every variant within ROLL_GATE of roll; the products against their
# plain version (torch.matmul, another order of summation) within
# PRODUCT_GATE over those steps and PRODUCT_GATE_FULL, the JAX tool's
# gate, over the whole call (the rounding of another summation order
# compounds over the steps). PROBE_BEYOND is a field past the resident
# kernels' size limit (rows of 420 floats leave 2 bands of 14 rows a
# block), which roll and halo take through their *_global kernels;
# PROBE_CHUNK the main path's chunk of steps, at which the resident
# kernels are also timed (PROBE['nt'] / PROBE_CHUNK calls a timing).
PROBE_TOOL = 'tools/torch_layout_probe.py'
PROBE = dict(programs=20, size=310, nt=1000, reps=3)
PROBE_BEYOND = dict(programs=20, size=420, nt=200, reps=3)
PROBE_CHUNK = 20
PROBE_SOURCE = 'red_diffeq_tpu_torch/ops/csrc/layout_probe.cu'
PROBE_LINES = {'roll': 89, 'mxu_x': 106, 'mxu_xy': 129, 'halo': 158}
PROBE_GATE_STEPS = 20
ROLL_GATE, PRODUCT_GATE, PRODUCT_GATE_FULL = 1e-4, 1e-5, 1e-4
# The tensor cores' dense TF32 rate (NVIDIA H100 SXM data sheet, 700 W),
# from which the split-TF32 products' own floor is computed.
PEAK_TF32_PER_S = 495e12
PRODUCTS = ('mxu_x', 'mxu_xy')
RESIDENT = ('roll', 'halo')


def probe_bound(nprog, hp, wp, nt):
    """The least time of one probe call, shared by its four layouts: the
    recursion's 14 fp32 operations a cell and step (the banded circulants
    count as their 4 non-zeros a column), and its bytes (the two start
    states and the three planes read once, the result written once)."""
    field, plane = nprog * hp * wp, hp * wp
    nbytes, ops = 4 * (3 * field + 3 * plane), 14 * field * nt
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by='bytes' if by_bytes >= by_ops else 'operations',
                bytes=nbytes, ops=ops)


def probe_tf32_floor(variant, nprog, hp, wp, nt):
    """The split-TF32 products' own floor in ms a call, computed, not
    measured: a dense pass of 2 * Wp operations a cell (p @ D), and with
    ``mxu_xy`` 2 * Hp more (E @ p), for each part product the kernels keep,
    at PEAK_TF32_PER_S."""
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    depth = wp + (hp if variant == 'mxu_xy' else 0)
    return (len(lp.PART_PRODUCTS) * 2 * nprog * hp * wp * depth * nt
            / PEAK_TF32_PER_S * 1e3)


def hmma_tf32_counts(lib):
    """TF32 tensor-core instructions (``HMMA...TF32``) in each function of
    the shared library ``lib``'s SASS (``cuobjdump -sass``), by mangled
    name."""
    import re
    import shutil
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {part.split(None, 1)[0]: len(re.findall(r'HMMA[.\w]*TF32', part))
            for part in sass.split('Function : ')[1:]}


def probe_kernel_checks():
    """Registers, spill bytes and resident blocks per SM of the six probe
    kernels, ``probe_roll`` and ``probe_halo`` with their cluster at PROBE
    (blocks and fields a cluster, clusters resident at once), and the TF32
    HMMA instructions of the two products in the built library's SASS: the
    products and the resident kernels must not spill, and each product
    must hold TF32 HMMA (the tensor cores, not the CUDA cores, carry them).
    Returns the numbers by kernel name."""
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    from red_diffeq_tpu_torch.ops import stencil
    hmma = hmma_tf32_counts(stencil.build(source=lp._CSRC))
    info = {}
    shape = (PROBE['programs'], PROBE['size'], PROBE['size'])
    for name in lp.launches:
        k = (lp.kernel_info(name, *shape) if name in
             (lp.KERNELS['roll'], lp.KERNELS['halo']) else
             lp.kernel_info(name))
        line = (f'{name}: {k["regs"]} registers, {k["local_bytes"]} local '
                f'bytes, {k["blocks_per_sm"]} blocks per SM')
        if name in (lp.KERNELS[v] for v in PRODUCTS):
            tag = f'probe_mxuILb{int(name == lp.KERNELS["mxu_xy"])}E'
            found = [n for n in hmma if tag in n]
            check(len(found) == 1, f'{name}: {len(found)} functions named '
                  f'*{tag}* in the SASS')
            k['hmma_tf32'] = hmma[found[0]]
            check(k['hmma_tf32'] > 0, f'{name}: no TF32 HMMA in its SASS')
            line += f', {k["hmma_tf32"]} TF32 HMMA in its SASS'
        if 'clusters' in k:
            line += (f'; at {shape[0]} fields of {shape[1]}x{shape[2]}: '
                     f'{k["ranks"]} blocks a cluster, '
                     f'{k["fields_per_cluster"]} fields a cluster, '
                     f'{k["clusters"]} clusters resident at once')
            check(k['clusters'] > 0, f'{name}: no cluster fits the card')
        if 'hmma_tf32' in k or 'clusters' in k:
            check(k['local_bytes'] == 0, f'{name} spills to local memory')
        print(line, flush=True)
        info[name] = k
    return info


def probe_library_ms(variant, prob, nt, reps):
    """The library's time for the products of one call of ``variant``: the
    step's ``torch.matmul`` calls (full fp32) on its inputs, nt times, as a
    CUDA graph."""
    import torch
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    p = prob[1]
    d = lp.circulant(p.shape[-1], p.device)
    e = lp.circulant(p.shape[-2], p.device)
    out = torch.empty_like(p), torch.empty_like(p)

    def call():
        for _ in range(nt):
            torch.matmul(p, d, out=out[0])
            if variant == 'mxu_xy':
                torch.matmul(e, p, out=out[1])

    return graph_ms(call, reps)


def _probe_tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location('torch_layout_probe',
                                                  PROBE_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _probe_tool_run(tool, dev, cfg, variants):
    """The probe tool at ``cfg`` for ``variants``, its launches counted from
    0 just before and read just after; its check against roll must pass,
    and on the card each timing line must show one launch a call on the
    resident route and one a step on the other. Returns the counts and the
    timing records by variant."""
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    nt = cfg['nt']
    lp.reset_launches()
    records = tool.main(['--programs', str(cfg['programs']), '--size',
                         str(cfg['size']), '--nt', str(nt), '--reps',
                         str(cfg['reps']), '--device', dev.type,
                         '--variants', *variants])
    counts = dict(lp.launches)
    for rec in records[:len(variants)]:
        check(rec['ok'], f'probe tool: {rec["variant"]} differs from roll by '
              f'{rec["rel_err_vs_roll"]:.3e} (gate {ROLL_GATE})')
    timing = {rec['variant']: rec for rec in records[len(variants):]}
    if dev.type == 'cuda':
        for v, rec in timing.items():
            want = 1 if rec['route'] == 'resident' else nt
            check(rec['launches_per_call'] == want, f'probe tool: '
                  f'{rec["kernel"]} ({rec["route"]}) launched '
                  f'{rec["launches_per_call"]} times a call of {nt} steps')
    return counts, timing


def _probe_held(v, prob, steps, route_to=None):
    """``steps`` steps of ``v`` on its kernel (its route by size, or
    ``route_to``) against its plain version: roll and halo bit for bit, the
    products within their gate; exactly the launches of its route. Returns
    (the kernel's state, max abs err, max-rel, the kernel's name)."""
    import torch
    from red_diffeq_tpu_torch.ops import layout_probe as lp
    plan = lp.route(v, *prob[0].shape)
    if route_to == 'global':
        plan = dict(plan, kernel=lp.GLOBAL_KERNELS[v], route='global')
    kernel = plan['kernel']
    before = lp.launches[kernel]
    got = lp.run_variant(v, *prob, nt=steps, route_to=route_to)
    n = lp.launches[kernel] - before
    want_n = 1 if plan['route'] == 'resident' else steps
    check(n == want_n, f'{kernel}: {n} launches for {steps} steps (expected '
          f'{want_n})')
    want = lp.plain_variant(v, *prob, nt=steps)
    check(bool(torch.isfinite(got).all()) and float(want.abs().max()) > 0,
          f'{kernel}: the state after {steps} steps is degenerate')
    r = max_rel(got, want)
    if v in RESIDENT:
        check(torch.equal(got, want), f'{kernel} differs from its plain '
              f'version after {steps} steps (max-rel {r:.3e}; expected bit '
              'for bit)')
    else:
        gate = PRODUCT_GATE if steps <= PROBE_GATE_STEPS else \
            PRODUCT_GATE_FULL
        check(r <= gate, f'{kernel} vs its plain version after {steps} '
              f'steps: max-rel {r:.3e} > {gate}')
    return got, float((got - want).abs().max()), r, kernel


def phase_layout_probe(dev):
    """The probe kernels' registers, spills, blocks per SM, clusters and
    TF32 HMMA (``probe_kernel_checks``); the probe tool at PROBE (its
    launches counted from 0 just before and read just after: every kernel
    of a route taken there must have run), then each kernel against its
    plain version and ``roll`` over PROBE_GATE_STEPS and the whole call,
    with exactly one launch a call (``probe_roll``, ``probe_halo``) or a
    step (the products), and timed: ms a call with the host's launches
    (CUDA events) and as a CUDA graph, at nt and as nt / PROBE_CHUNK calls
    of PROBE_CHUNK steps, the plain version's ms, for the products the
    library's ms (printed beside the split-TF32 floor that
    ``probe_tf32_floor`` computes), for roll and halo their *_global
    kernels forced at the same call (bit for bit too). Then the tool at
    PROBE_BEYOND, past the resident kernels' size limit, for roll and halo
    (counts from 0 again: the *_global kernels must have run), each held
    bit for bit and timed there. Returns the numbers of each kernel."""
    import torch
    from red_diffeq_tpu_torch.ops import layout_probe as lp

    info = probe_kernel_checks() if dev.type == 'cuda' else {}
    tool = _probe_tool()
    nprog, size, nt = PROBE['programs'], PROBE['size'], PROBE['nt']
    counts, timing = _probe_tool_run(tool, dev, PROBE, lp.VARIANTS)
    for v in lp.VARIANTS:
        kernel = lp.route(v, nprog, size, size)['kernel']
        check(kernel == lp.KERNELS[v], f'{size}x{size} fields take {kernel}')
        check(counts[kernel] > 0, f'the probe tool never launched {kernel}')
    prob = [torch.from_numpy(a).to(dev)
            for a in lp.make_problem(nprog, size, size)]
    short = min(PROBE_GATE_STEPS, nt)
    chunks = max(nt // PROBE_CHUNK, 1)
    roll, out = {}, {}
    for v in lp.VARIANTS:
        errs = {}
        for steps in (short, nt):
            got, err, r, kernel = _probe_held(v, prob, steps)
            if v == 'roll':
                roll[steps] = got
            vs_roll = max_rel(got, roll[steps])
            check(vs_roll <= ROLL_GATE, f'{kernel} vs probe_roll after '
                  f'{steps} steps: max-rel {vs_roll:.3e} > {ROLL_GATE}')
            errs[steps] = (err, r, vs_roll)
            del got

        def call(v=v, steps=nt, route_to=None):
            return lp.run_variant(v, *prob, nt=steps, route_to=route_to)

        def chunked(v=v):
            for _ in range(chunks):
                lp.run_variant(v, *prob, nt=PROBE_CHUNK)

        ms = cuda_ms(call, PROBE['reps'])
        gms = graph_ms(call, PROBE['reps'])
        plain_ms = cuda_ms(lambda: lp.plain_variant(v, *prob, nt=nt), 1,
                           warm=False)
        out[v] = dict(max_abs_err=errs[nt][0], max_rel=errs[nt][1],
                      max_rel_vs_roll=errs[nt][2], ms=ms, graph_ms=gms,
                      plain_ms=plain_ms, library_ms=None,
                      **info.get(lp.KERNELS[v], {}))
        extra = ''
        if v in PRODUCTS:
            out[v]['library_ms'] = probe_library_ms(v, prob, nt,
                                                    PROBE['reps'])
            floor = probe_tf32_floor(v, nprog, size, size, nt)
            extra = (f', library (torch.matmul, fp32) '
                     f'{out[v]["library_ms"]:.3f} ms as a CUDA graph; '
                     f'computed TF32 floor {floor:.3f} ms (the split '
                     f'products at {PEAK_TF32_PER_S / 1e12:g} TFLOP/s)')
        else:
            out[v].update(chunk_ms=cuda_ms(chunked, PROBE['reps']),
                          chunk_graph_ms=graph_ms(chunked, PROBE['reps']))
            _probe_held(v, prob, nt, route_to='global')
            out[v]['global_ms'] = cuda_ms(
                lambda: call(route_to='global'), PROBE['reps'])
            out[v]['global_graph_ms'] = graph_ms(
                lambda: call(route_to='global'), PROBE['reps'])
            extra = (f'; as {chunks} calls of {PROBE_CHUNK} steps '
                     f'{out[v]["chunk_ms"]:.3f} ms, '
                     f'{out[v]["chunk_graph_ms"]:.3f} ms as a CUDA graph; '
                     f'{lp.GLOBAL_KERNELS[v]} forced (one launch a step, bit '
                     f'for bit) {out[v]["global_ms"]:.3f} ms, '
                     f'{out[v]["global_graph_ms"]:.3f} ms as a CUDA graph')
        print(f'{lp.KERNELS[v]} at {nprog} x {size}x{size}, {nt} steps: vs '
              f'plain max abs err {errs[short][0]:.3e} ({short} steps), '
              f'{errs[nt][0]:.3e} (max-rel {errs[nt][1]:.3e}); vs probe_roll'
              f' max-rel {errs[nt][2]:.3e}; {ms:.3f} ms a call with the '
              f"host's launches, {gms:.3f} ms as a CUDA graph, plain "
              f'{plain_ms:.3f} ms{extra}', flush=True)
    del prob
    # Past the resident kernels' limit: the *_global kernels' own route.
    bnprog, bsize, bnt = (PROBE_BEYOND['programs'], PROBE_BEYOND['size'],
                          PROBE_BEYOND['nt'])
    bcounts, btiming = _probe_tool_run(tool, dev, PROBE_BEYOND, RESIDENT)
    prob = [torch.from_numpy(a).to(dev)
            for a in lp.make_problem(bnprog, bsize, bsize)]
    beyond = {}
    for v in RESIDENT:
        kernel = lp.GLOBAL_KERNELS[v]
        check(lp.route(v, bnprog, bsize, bsize)['kernel'] == kernel,
              f'{bsize}x{bsize} fields do not take {kernel}')
        check(bcounts[kernel] > 0, f'the probe tool never launched {kernel} '
              f'at {bsize}x{bsize}')
        errs = [_probe_held(v, prob, steps)[1:3]
                for steps in (min(PROBE_GATE_STEPS, bnt), bnt)]

        def call(v=v):
            return lp.run_variant(v, *prob, nt=bnt)

        beyond[v] = dict(max_abs_err=errs[-1][0], max_rel=errs[-1][1],
                         ms=cuda_ms(call, PROBE_BEYOND['reps']),
                         graph_ms=graph_ms(call, PROBE_BEYOND['reps']),
                         plain_ms=cuda_ms(lambda: lp.plain_variant(
                             v, *prob, nt=bnt), 1, warm=False),
                         **info.get(kernel, {}))
        print(f'{kernel} at {bnprog} x {bsize}x{bsize} (past the resident '
              f'limit), {bnt} steps: bit for bit; {beyond[v]["ms"]:.3f} ms '
              f"a call with the host's launches, "
              f'{beyond[v]["graph_ms"]:.3f} ms as a CUDA graph, plain '
              f'{beyond[v]["plain_ms"]:.3f} ms', flush=True)
    bnd = probe_bound(nprog, size, size, nt)
    return dict(variants=out, counts=counts, shape=[nprog, size, size], nt=nt,
                routes={v: timing[v].get('route') for v in lp.VARIANTS},
                beyond=dict(variants=beyond, counts=bcounts,
                            shape=[bnprog, bsize, bsize], nt=bnt,
                            **probe_bound(bnprog, bsize, bsize, bnt)),
                **bnd)


# The api slice: the headline through the JAX package's public calls
# (``FWIForward(ctx, normalize=True, ...)``, ``InversionEngine(diffusion,
# None, 'diffusion')``) and optimize's options: API_TS steps resumed from a
# snapshot at API_RESUME_AT, API_TRACE_TS steps traced with profile_dir,
# the bf16 U-Net in the engine (API_TS steps), in the inversion CLI
# (API_CLI_TS steps at the wide slice's width) and in the trainer's amp
# (API_TRAIN_STEPS steps at the train CLI's defaults). BF16_GAP bounds the
# bf16 denoiser's output against fp32's, relative to fp32's largest value,
# and AMP_LOSS_RTOL the first amp loss against fp32's on the same draws:
# the JAX package's bounds (tests/test_misc_coverage.py:46-55, :168).
API_TS, API_RESUME_AT, API_TRACE_TS, API_CLI_TS = 20, 10, 5, 5
API_TRAIN_STEPS = 50
BF16_GAP, AMP_LOSS_RTOL = 0.1, 0.15
# The categories of a Chrome trace's device activity, and of the host's
# launch calls a kernel's correlation id points to.
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
API_KERNELS = ('fwd_step', 'bwd_reverse_step', 'sum_shots')


class Interrupted(Exception):
    """Raised to cut a run short (:func:`cut_after_snapshot`)."""


@contextlib.contextmanager
def cut_after_snapshot(step):
    """Within the block, an inversion run raises :class:`Interrupted` just
    after it has written its snapshot of ``step`` steps, as a run killed
    there would leave it; the block absorbs the raise."""
    from red_diffeq_tpu_torch.core import inversion
    save = inversion._save_snapshot

    def save_and_cut(path, at, *a, **kw):
        save(path, at, *a, **kw)
        if at == step:
            raise Interrupted

    inversion._save_snapshot = save_and_cut
    try:
        yield
        check(False, f'the run was not cut at step {step}')
    except Interrupted:
        pass
    finally:
        inversion._save_snapshot = save


def trace_split(path, steps):
    """Device time a step in the Chrome trace at ``path`` of ``steps``
    inversion steps: each solver kernel (API_KERNELS, and the tape
    kernels, which must not appear) by name, the U-Net's kernels (those
    launched inside a ``unet`` range), the rest, and the share of the
    device window (first device activity to last) in which nothing runs.
    Returns (launches by kernel name, ms a step by part, idle share, window
    ms a step, host ms a step by the ``inversion_step`` ranges)."""
    import re
    events = json.loads(path.read_text())['traceEvents']
    device = [e for e in events if e.get('ph') == 'X'
              and e.get('cat') in DEVICE_CATS]
    launch_ts = {e['args']['correlation']: e['ts'] for e in events
                 if e.get('cat') in LAUNCH_CATS
                 and 'correlation' in e.get('args', {})}
    unet = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                  if e.get('name') == 'unet' and e.get('ph') == 'X'
                  and e.get('cat') == 'user_annotation')
    host = [e['dur'] for e in events if e.get('name') == 'inversion_step'
            and e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    check(len(unet) == steps and len(host) == steps,
          f'trace: {len(unet)} unet and {len(host)} inversion_step ranges, '
          f'expected {steps}')
    names = (*API_KERNELS, *TAPE_KERNELS, 'bwd_tape_step')
    launches = dict.fromkeys(names, 0)
    us = dict.fromkeys((*API_KERNELS, 'unet', 'rest'), 0.0)
    for e in device:
        if e['cat'] == 'kernel':
            hit = [k for k in names if re.search(rf'\b{k}\b', e['name'])]
            if hit:
                launches[hit[0]] += 1
                us[hit[0]] += e['dur']
                continue
            t = launch_ts.get(e.get('args', {}).get('correlation'))
            if t is not None and any(a <= t <= b for a, b in unet):
                us['unet'] += e['dur']
                continue
        us['rest'] += e['dur']
    busy, window = device_window(device)
    ms = {k: v / steps / 1e3 for k, v in us.items()}
    return (launches, ms, 1.0 - busy / window, window / steps / 1e3,
            sum(host) / steps / 1e3)


def trace_margins(dev):
    """Seconds the tracer adds to a traced block on ``dev`` by the host's
    clock (``utils/profiling.WINDOW_MARGIN_S`` at each end on a card)."""
    from red_diffeq_tpu_torch.utils import profiling
    return 2 * profiling.WINDOW_MARGIN_S if dev.type == 'cuda' else 0.0


def device_window(device):
    """(µs in which some device activity of ``device``, a trace's events,
    runs; µs from the first to the last)."""
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in device)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, end - spans[0][0]


def phase_api(dev, root, training):
    """The JAX-style public calls at the headline's full width (B=4, 70x70,
    nt=1000, 5 shots, the shipped prior, the tape-free adjoint): a resume
    that repeats the uninterrupted run bit for bit, the trace and its split
    of a step, then the bf16 U-Net (engine, inversion CLI, train CLI's
    ``--amp``) against fp32. ``training``: the training slice's numbers,
    printed beside amp's."""
    from pathlib import Path
    import torch
    import red_diffeq_tpu_torch as rdt
    from red_diffeq_tpu_torch.cli import run_inversion
    from red_diffeq_tpu_torch.config import load_config, save_config
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    root = Path(root)
    diffusion = load_prior(dev)
    problem = slice_problem(dev, HEADLINE)
    op = rdt.FWIForward(dict(HEADLINE), normalize=True,
                        v_denorm_func=rdt.v_denormalize,
                        s_norm_func=rdt.s_normalize_none)
    check(op.backend == 'kernel' and op.device.type == dev.type
          and stencil.resolve_run_config(op.geom, CHUNK, None)[0]
          == 'reverse', f'the JAX-style operator runs {op.backend!r} on '
          f'{op.device}')

    def run(engine, ts, fwd=op, **kw):
        gen = torch.Generator(device=dev).manual_seed(8888)
        out = engine.optimize(problem['mu0'], problem['v_true'],
                              problem['y'], fwd, ts=ts, lr=0.03,
                              reg_lambda=0.75, generator=gen,
                              progress=False, **kw)
        torch.cuda.synchronize()
        return out

    def same(a, b):
        return all(np.array_equal(np.array(x[k]), np.array(y[k]))
                   for x, y in zip(a, b) for k in x)

    # 1. Resume, under deterministic cuDNN. The run is cut just after its
    # snapshot at API_RESUME_AT (the graphed loop runs no Python per step
    # that a cut could raise from).
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        engine = rdt.InversionEngine(diffusion, None, 'diffusion')
        t0 = time.perf_counter()
        want_mu, want = run(engine, API_TS, checkpoint_path=root / 'a.pt',
                            checkpoint_every=API_RESUME_AT)
        full_s = time.perf_counter() - t0
        with cut_after_snapshot(API_RESUME_AT):
            run(engine, API_TS, checkpoint_path=root / 'b.pt',
                checkpoint_every=API_RESUME_AT)
        fresh = rdt.InversionEngine(diffusion, None, 'diffusion')
        got_mu, got = run(fresh, API_TS, checkpoint_path=root / 'b.pt',
                          checkpoint_every=API_RESUME_AT, resume=True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    check(torch.equal(got_mu, want_mu) and same(got, want),
          f'the run resumed at step {API_RESUME_AT} differs from the '
          f'uninterrupted one: max |d mu| '
          f'{float((got_mu - want_mu).abs().max()):.3e}')
    check(all(np.isfinite(c[k]).all() and len(c[k]) == API_TS
              for c in want for k in c), 'the curves are not finite')
    print(f'api slice: {API_TS} steps with snapshots every '
          f'{API_RESUME_AT} in {full_s:.2f} s (deterministic cuDNN); a '
          f'fresh engine resumed at step {API_RESUME_AT} repeats the final '
          f'model and all {API_TS} steps\' metrics bit for bit; SSIM '
          + ', '.join(f'{c["ssim"][0]:.4f} -> {c["ssim"][-1]:.4f}'
                      for c in got), flush=True)

    # 2. The trace of API_TRACE_TS steps of the eager loop (each step's
    # U-Net range holds its kernels; the scan slice traces the graph).
    stencil.reset_launches()
    t0 = time.perf_counter()
    run(engine, API_TRACE_TS, profile_dir=str(root / 'trace'),
        use_scan=False)
    traced_s = (time.perf_counter() - t0 - trace_margins(dev)) / API_TRACE_TS
    counts = dict(stencil.launches)
    files = sorted((root / 'trace').glob('*.pt.trace.json'))
    check(len(files) == 1, f'profile_dir holds {files}')
    launches, ms, idle, window_ms, host_ms = trace_split(files[0],
                                                         API_TRACE_TS)
    hp = HEADLINE['n_grid'] + 2 * HEADLINE['nbc']
    chunks = API_TRACE_TS * -(-HEADLINE['nt'] // CHUNK)
    expect = dict.fromkeys(launches, 0)
    for name in ('fwd_step', 'bwd_reverse_step'):
        expect[name] = chunks * -(-CHUNK // stencil.pick_blocking(
            name, hp, hp)[0])
    expect['sum_shots'] = chunks
    for name in launches:
        check(launches[name] == counts[name] == expect[name],
              f'trace: {name} {launches[name]} kernels, counter '
              f'{counts[name]}, expected {expect[name]}')
    print(f'api slice trace ({files[0].stat().st_size / 2**20:.1f} MiB, '
          f'{API_TRACE_TS} steps, {traced_s:.4f} s a step by the host '
          f'clock under the profiler, its window margins left out): '
          f'launches '
          + ', '.join(f'{k} {launches[k]}' for k in API_KERNELS)
          + ' (= the counters); device ms a step: '
          + ', '.join(f'{k} {v:.3f}' for k, v in ms.items())
          + f'; device window {window_ms:.3f} ms a step, idle '
          f'{idle:.2%} of it; host {host_ms:.3f} ms a step in '
          'inversion_step', flush=True)

    # 3. bf16: the denoiser, the engine, the inversion CLI, the trainer.
    d16 = rdt.GaussianDiffusion(
        rdt.Unet(dim=diffusion.model.dim, dim_mults=(1, 2, 4, 8),
                 channels=1), image_size=diffusion.image_size,
        timesteps=diffusion.num_timesteps, objective='pred_noise',
        half_precision=True)
    d16.model.load_state_dict(diffusion.model.state_dict())
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(BATCH, 1, *diffusion.image_size, generator=g, device=dev)
    t = torch.randint(0, diffusion.num_timesteps, (BATCH,), generator=g,
                      device=dev)
    with torch.no_grad():
        o32, o16 = diffusion.apply_fn(x, t), d16.apply_fn(x, t)
        gap = float((o16 - o32).abs().max() / o32.abs().max())
        check(o16.dtype == torch.float32 and gap < BF16_GAP,
              f'bf16 denoiser: {o16.dtype}, {gap:.3e} of fp32\'s largest '
              f'value (bound {BF16_GAP})')
        unet_ms = {k: cuda_ms(lambda d=d: d.apply_fn(x, t), 20)
                   for k, d in (('fp32', diffusion), ('bf16', d16))}
    s_step = {}
    for label, d in (('fp32', diffusion), ('bf16', d16)):
        eng = rdt.InversionEngine(d, None, 'diffusion')
        run(eng, 1, use_scan=False)
        seen, handle = step_events(d.model)
        acoustic.plain_chunk_calls['chunk'] = 0
        t0 = time.perf_counter()
        try:
            mu, curves = run(eng, API_TS, use_scan=False)
        finally:
            handle.remove()
        host = (time.perf_counter() - t0) / API_TS
        check(seen['batches'] == [BATCH] * API_TS
              and acoustic.plain_chunk_calls['chunk'] == 0
              and all(np.isfinite(c[k]).all() for c in curves for k in c),
              f'{label} inversion: U-Net calls {seen["batches"]}, plain '
              f'chunks {acoustic.plain_chunk_calls["chunk"]}, or losses not '
              'finite')
        s_step[label] = (host, step_period(seen['events']))
    print(f'api slice bf16: the dim-{diffusion.model.dim} denoiser at '
          f'batch {BATCH}, {diffusion.image_size}: {unet_ms["bf16"]:.3f} '
          f'ms a call against fp32\'s '
          f'{unet_ms["fp32"]:.3f} (CUDA events), its output within '
          f'{gap:.3e} of fp32\'s largest value; {API_TS} RED-DiffEq steps '
          f'{s_step["bf16"][0]:.4f} s a step by the host clock '
          f'[{s_step["bf16"][1]:.4f} by the U-Net calls\' events] against '
          f'fp32\'s {s_step["fp32"][0]:.4f} [{s_step["fp32"][1]:.4f}]',
          flush=True)
    busy = sum(ms.values())
    print(f'api slice: the traced step keeps the card busy {busy:.3f} ms; '
          f'untraced, a fp32 step takes {s_step["fp32"][1] * 1e3:.3f} ms by '
          f'the U-Net calls\' events, so the card idles about '
          f'{1 - busy / (s_step["fp32"][1] * 1e3):.2%} of it (under the '
          f'profiler, whose host work stretches a step to {window_ms:.3f} '
          f'ms, {idle:.2%})', flush=True)
    del d16

    paths = write_wide_dataset(dev, root / 'wide')
    cfg = load_config(paths[WIDE_PRESET])
    cfg.tpu.bf16_unet = True
    cfg.tpu.use_scan = False        # the dtype hook sees every step
    bf16_cfg = root / 'marmousi-red-diffeq-bf16.yaml'
    save_config(cfg, bf16_cfg)
    built = []
    build = run_inversion.build_diffusion_model

    def build_and_note(*a, **kw):
        d = build(*a, **kw)
        built.append(d.half_precision)
        d.model.register_forward_hook(
            lambda m, args, out: built.append(args[0].dtype))
        return d

    run_inversion.build_diffusion_model = build_and_note
    try:
        seen = run_cli(dev, ['--config', str(bf16_cfg), '--ts',
                             str(API_CLI_TS), '--sample_index', '0'])
    finally:
        run_inversion.build_diffusion_model = build
    check(built[0] is True and set(built[1:]) == {torch.bfloat16}
          and len(built) == API_CLI_TS + 1, f'bf16 CLI: half_precision '
          f'{built[:1]}, U-Net input dtypes {set(built[1:])}')
    check(seen['plain'] == 0 and seen['launches']['fwd_step'] > 0,
          'bf16 CLI: the kernels did not run the solver')
    check_run(seen, API_CLI_TS, 'bf16 CLI (tpu.bf16_unet)', WIDE_ROWS,
              cfg.pde.n_grid)

    run_datagen(dev, ['--out', str(root / 'train'), '--n',
                      str(TRAIN_FAMILY_N), '--velocity_only'])
    data = ['--data_dir', str(root / 'train' / 'Velocity_Data'),
            *TRAIN_ARGS]
    fp32, _, _, _ = train_cli(dev, [*data, '--results_folder',
                                    str(root / 'fp32'),
                                    '--train_num_steps', '1'])
    torch.cuda.reset_peak_memory_stats()
    amp, events, memory, _ = train_cli(dev, [
        *data, '--results_folder', str(root / 'amp'), '--amp',
        '--train_num_steps', str(API_TRAIN_STEPS)], eager=True)
    peak = torch.cuda.max_memory_allocated()
    losses = [e['loss'] for e in amp.training_losses]
    first32 = fp32.training_losses[0]['loss']
    check(amp.amp and amp.step == API_TRAIN_STEPS
          and len(losses) == API_TRAIN_STEPS and np.isfinite(losses).all()
          and all(p.dtype == torch.float32 for p in amp.params),
          f'amp trainer at step {amp.step}, {len(losses)} losses')
    rel = abs(losses[0] - first32) / abs(first32)
    check(rel < AMP_LOSS_RTOL, f'amp first loss {losses[0]:.5g} against '
          f'fp32\'s {first32:.5g}: {rel:.3e} (bound {AMP_LOSS_RTOL})')
    amp_s = events[1].elapsed_time(events[-1]) / (len(events) - 2) / 1e3
    batch = amp.batch_size
    print(f'api slice amp: {API_TRAIN_STEPS} train steps, {amp_s:.4f} s a '
          f'step (CUDA events), {batch / amp_s:.1f} images/s at batch '
          f'{batch}, peak device memory {peak / 2**20:.1f} MiB; the fp32 '
          f'training slice: {training["s_per_step"]:.4f} s, '
          f'{training["images_per_s"]:.1f} images/s, peak '
          f'{training["peak_mib"]:.1f} MiB; first loss {losses[0]:.5f} '
          f'against fp32\'s {first32:.5f} on the same draws ({rel:.3e})',
          flush=True)
    return dict(idle=idle, ms=ms, unet_ms=unet_ms, s_step=s_step,
                amp_s=amp_s)


# The quality slice: tools/torch_eval_quality.py at QUALITY.md's protocol
# (n=4 held-out samples, 300 steps, refined observations) for TV and
# RED-DiffEq on the shipped prior, gated against QUALITY.md's refined rows
# (the JAX package's): each within QUALITY_GAP, and RED-DiffEq above TV
# (QUALITY_ORDER). RED sits 0.04 above TV and 0.06 above the competitors,
# so a wider miss would change the paper's conclusion. Then the other
# tools for their plumbing at full width, their depth cut: PLUMBING_TS
# RED-DiffEq steps, the competitors' outer steps cut to PLUMBING_DTS.
QUALITY_N, QUALITY_TS = 4, 300
QUALITY_REGS = ('tv', 'diffusion')
QUALITY_CKPT = CKPT
QUALITY_SSIM = {'tv': 0.8888, 'diffusion': 0.9274}
QUALITY_GAP = 0.03
QUALITY_ORDER = (('diffusion', 'tv'),)
PLUMBING_TS, PLUMBING_DTS = 5, 2
QUALITY_TOOLS = ('quality', 'eval_quality', 'compare_methods',
                 'milestone_eval', 'pick_best_milestone')
EXAMPLE = 'examples/torch_example_openfwi.py'
ROUTE_KERNELS = ('fwd_step', 'bwd_reverse_step', 'sum_shots')


def _load_file(name, path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def quality_tools():
    """The port's quality tools (``tools/torch_<name>.py``) by name, all on
    one ``torch_quality`` module (``'quality'``)."""
    return {name: _load_file(f'torch_{name}', f'tools/torch_{name}.py')
            for name in QUALITY_TOOLS}


def route_launches(steps, nt, hp, wp):
    """Launches of the tape-free route's kernels in ``steps`` inversion
    steps on an hp x wp field: per chunk ceil(chunk/U) of each blocked
    kernel and one ``sum_shots``."""
    from red_diffeq_tpu_torch.ops import stencil
    chunks = steps * -(-nt // CHUNK)
    want = dict.fromkeys(stencil.launches, 0)
    for name in ('fwd_step', 'bwd_reverse_step'):
        want[name] = chunks * -(-CHUNK // stencil.pick_blocking(
            name, hp, wp)[0])
    want['sum_shots'] = chunks
    return want


def phase_quality(dev, root, training):
    """The quality slice (see QUALITY_N above): the eval tool's refined
    rows gated against QUALITY.md, its warm-up holding the library's load
    and every kernel of the route and its timed rows none of it, exact
    launches, the plain path only for the refined observations; then
    compare_methods, milestone_eval over the training slice's milestones
    and the shipped prior (the bf16 copy renewed on each swap),
    pick_best_milestone (its export loaded back) and the OpenFWI example
    through the inversion CLI. Returns the rows and launches."""
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.io.checkpoints import (
        load_diffusion_params, load_params,
    )
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    root = Path(root)
    tools = quality_tools()
    Q = tools['quality']
    ctx = Q.CTX
    hp, wp = Q.HEIGHT + 2 * ctx['nbc'], ctx['n_grid'] + 2 * ctx['nbc']
    refined_chunks = -(-2 * ctx['nt'] // Q.CHUNK)
    log, stage, problems = [], ['set-up'], []
    warm, optimize, build = (InversionEngine.warm_compile,
                             InversionEngine.optimize, stencil.build)
    held = Q.held_out_problem

    def spy_warm(self, *a, **kw):
        stage[0] = 'warm-up'
        rec = warm(self, *a, **kw)
        stage[0] = 'set-up'
        log.append(('warm', rec))
        return rec

    def spy_optimize(self, *a, **kw):
        stage[0] = 'optimize'
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = optimize(self, *a, **kw)
        torch.cuda.synchronize()
        stage[0] = 'set-up'
        log.append(('optimize', dict(ts=kw['ts'], seconds=time.perf_counter()
                                     - t0)))
        return out

    def spy_build(*a, **kw):
        log.append(('build', stage[0]))
        return build(*a, **kw)

    def spy_held(*a, **kw):
        problems.append(held(*a, **kw))
        return problems[-1]

    def counted(fn):
        """fn() with the launch counters and the plain path's chunks from 0;
        returns its result, the launches and the plain chunks."""
        del log[:]
        stencil.reset_launches()
        acoustic.plain_chunk_calls['chunk'] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, dict(stencil.launches), acoustic.plain_chunk_calls['chunk']

    def check_counts(label, counts, plain, steps, forwards=0):
        """The route's launches in ``steps`` inversion steps and
        ``forwards`` passes of the forward alone, and the plain path only
        for the refined observations."""
        want = route_launches(steps, ctx['nt'], hp, wp)
        want['fwd_step'] += forwards * route_launches(
            1, ctx['nt'], hp, wp)['fwd_step']
        check(counts == want, f'{label}: launches {counts}, expected {want}')
        check(plain == refined_chunks, f'{label}: the plain path ran '
              f'{plain} chunks, the refined observations take '
              f'{refined_chunks}')

    InversionEngine.warm_compile, InversionEngine.optimize = (spy_warm,
                                                              spy_optimize)
    stencil.build, Q.held_out_problem = spy_build, spy_held
    try:
        # a. The refined rows at the full protocol, and the warm-up.
        stencil._lib = None     # so that the warm-up loads the library
        t0 = time.perf_counter()
        rows, counts, plain = counted(lambda: tools['eval_quality'].main([
            '--n', str(QUALITY_N), '--ts', str(QUALITY_TS), '--width',
            str(ctx['n_grid']), '--obs', 'refined', '--regs', *QUALITY_REGS,
            '--ckpt', str(QUALITY_CKPT),
            '--device', dev.type, '--out', str(root / 'quality.md')]))
        eval_s = time.perf_counter() - t0
        warms = [r for k, r in log if k == 'warm']
        runs = [r for k, r in log if k == 'optimize']
        builds = [s for k, s in log if k == 'build']
        one_step = route_launches(1, ctx['nt'], hp, wp)
        check(len(warms) == len(QUALITY_REGS)
              and len(runs) == len(QUALITY_REGS) + 1,
              f'eval tool: {len(warms)} warm-ups, {len(runs)} runs')
        for reg, rec in zip(QUALITY_REGS, warms):
            got = dict(one_step, **rec['launches'])
            check(rec['backend'] == 'kernel' and rec['route'] == 'reverse'
                  and got == one_step, f'warm-up of {reg}: {rec}, expected '
                  f"the kernel backend's 'reverse' route, {one_step}")
        check(builds == ['warm-up'], f'the kernel library was loaded in '
              f'{builds}: expected once, in the first warm-up')
        steps = len(warms) + sum(r['ts'] for r in runs)
        check_counts('eval tool', counts, plain, steps)
        p = problems[0]
        y = p.observations['refined']
        print(f'quality slice: held-out problem, refined observations '
              f'{tuple(y.shape)} from the {2 * hp}x{2 * wp} grid, '
              f'nt={2 * ctx["nt"]} (plain path) in '
              f'{p.obs_seconds["refined"]:.3f} s; warm-ups '
              + ', '.join(f'{reg} {r["seconds"]:.3f} s' for reg, r in
                          zip(QUALITY_REGS, warms))
              + f' ({warms[0]["launches"]} launches a step, U '
              f'{warms[0]["unroll"]}); the discarded first run '
              f'{runs[0]["seconds"]:.3f} s; tool {eval_s:.2f} s; launches '
              f'{counts}', flush=True)
        ssim = {}
        for reg, run in zip(QUALITY_REGS, runs[1:]):
            r = rows[f'refined/{reg}']
            ssim[reg] = r['SSIM']
            check(all(np.isfinite(r[k]) for k in ('MAE', 'RMSE', 'SSIM')),
                  f'refined/{reg}: {r}')
            print(f'quality slice, refined {reg}: MAE {r["MAE"]:.4f}  RMSE '
                  f'{r["RMSE"]:.4f}  SSIM {r["SSIM"]:.4f} (QUALITY.md '
                  f'{QUALITY_SSIM[reg]:.4f}, gap '
                  f'{r["SSIM"] - QUALITY_SSIM[reg]:+.4f})  '
                  f'{run["seconds"] / QUALITY_N:.4f} s/sample '
                  f'({run["seconds"] / run["ts"]:.4f} s a step; the table '
                  f'{r["seconds_per_sample"]})', flush=True)
            check(abs(r['SSIM'] - QUALITY_SSIM[reg]) <= QUALITY_GAP,
                  f'refined/{reg}: SSIM {r["SSIM"]:.4f}, QUALITY.md '
                  f'{QUALITY_SSIM[reg]:.4f} (gate {QUALITY_GAP})')
        for a, b in QUALITY_ORDER:
            check(ssim[a] > ssim[b], f'refined SSIM of {a} {ssim[a]:.4f} '
                  f'not above {b} {ssim[b]:.4f}')
        out = dict(rows=rows, counts=counts, eval_s=eval_s,
                   obs_s=p.obs_seconds['refined'],
                   warm_s=[r['seconds'] for r in warms],
                   first_s=runs[0]['seconds'],
                   s_per_sample={reg: run['seconds'] / QUALITY_N
                                 for reg, run in zip(QUALITY_REGS,
                                                     runs[1:])})
        del problems[:]

        # b. compare_methods at the refined protocol, depth cut.
        cm = tools['compare_methods']
        cm.RED_TS = PLUMBING_TS
        cm.BENCH_KW = dict(cm.BENCH_KW, diffusion_ts=PLUMBING_DTS)
        t0 = time.perf_counter()
        comp, counts, plain = counted(lambda: cm.main([
            '--n', str(QUALITY_N), '--obs', 'refined', '--ckpt',
            str(QUALITY_CKPT), '--device', dev.type, '--out',
            str(root / 'compare.md')]))
        methods = ('RED-DiffEq', 'DiffusionFWI', 'ILVR-FWI')
        check(list(comp) == [f'refined/{m}' for m in methods]
              and all(np.isfinite(list(r.values())).all()
                      and 0 < r['SSIM'] <= 1 for r in comp.values()),
              f'compare tool: {comp}')
        check(all(counts[k] > 0 for k in ROUTE_KERNELS)
              and not any(counts[k] for k in counts
                          if k not in ROUTE_KERNELS)
              and plain == refined_chunks, f'compare tool: launches '
              f'{counts}, plain chunks {plain}')
        check('Card:' in (root / 'compare.md').read_text(),
              'compare tool: no card line')
        print(f'quality slice, compare tool ({PLUMBING_TS} RED steps, '
              f'{PLUMBING_DTS} x {cm.BENCH_KW["ts"]} competitor steps, '
              f'{time.perf_counter() - t0:.2f} s): '
              + '; '.join(f'{m} SSIM {comp[f"refined/{m}"]["SSIM"]:.4f} '
                          f'{comp[f"refined/{m}"]["s_per_sample"]} s/sample'
                          for m in methods)
              + f'; launches {counts}', flush=True)

        # c. milestone_eval over the training slice's milestones and the
        # shipped prior, then the bf16 copy across a swap.
        run_dir = Path(training['run'])
        ckpts = sorted(run_dir.glob('model-*.ckpt'),
                       key=lambda f: int(f.stem.split('-')[1]))
        ckpts.append(Path(QUALITY_CKPT))
        t0 = time.perf_counter()
        ms_rows, counts, plain = counted(lambda: tools['milestone_eval']
                                         .main([
            '--ckpts', *map(str, ckpts), '--run', str(run_dir), '--n',
            str(QUALITY_N), '--ts', str(PLUMBING_TS), '--out',
            str(root / 'milestones.md'), '--device', dev.type]))
        n_ms = len(ckpts) - 1
        want_steps = [m * TRAIN_SAVE_EVERY for m in range(1, n_ms + 1)]
        check([r['step'] for r in ms_rows] == want_steps + ['?'],
              f'milestone tool: steps {[r["step"] for r in ms_rows]}')
        check(json.loads((root / 'milestones.json').read_text()) == ms_rows
              and '## Training loss' in (root / 'milestones.md').read_text(),
              'milestone tool: sidecar or loss summary missing')
        refined = [r['refined']['SSIM'] for r in ms_rows]
        check(len(set(refined)) == len(refined), 'milestone tool: equal '
              f'refined SSIMs {refined}: a swap kept the weights')
        # The clean observations a forward on the kernels, the refined on
        # the plain path, and PLUMBING_TS steps a checkpoint and protocol.
        check_counts('milestone tool', counts, plain,
                     2 * len(ckpts) * PLUMBING_TS, forwards=1)
        d = GaussianDiffusion(Unet(**Q.UNET), image_size=Q.IMAGE_SIZE,
                              timesteps=Q.TIMESTEPS, half_precision=True,
                              device=dev)
        copies = []
        for ck in (ckpts[0], ckpts[-1], ckpts[0]):
            state = load_params(ck)
            d.params = state.get('ema_params', state)
            fresh = GaussianDiffusion(Unet(**Q.UNET),
                                      image_size=Q.IMAGE_SIZE,
                                      timesteps=Q.TIMESTEPS,
                                      params=state.get('ema_params', state),
                                      device=dev)
            got = d.bf16_params()
            check(all(torch.equal(got[n], w.to(torch.bfloat16))
                      for n, w in fresh.model.named_parameters()),
                  f'bf16 copy after assigning {ck.name}: stale')
            copies.append(got)
        check(not all(torch.equal(copies[0][n], copies[1][n])
                      for n in copies[0]), 'bf16 copy did not change '
              'between a milestone and the shipped prior')
        print(f'quality slice, milestone tool ({len(ckpts)} checkpoints, '
              f'{PLUMBING_TS} steps, {time.perf_counter() - t0:.2f} s): '
              + '; '.join(f'step {r["step"]}: clean SSIM '
                          f'{r["clean"]["SSIM"]:.4f}, refined '
                          f'{r["refined"]["SSIM"]:.4f}' for r in ms_rows)
              + '; the bf16 copy renewed on every swap', flush=True)

        # d. pick_best_milestone on that table; the export loaded back.
        best = tools['pick_best_milestone'].main([
            '--eval', str(root / 'milestones.md'), '--out',
            str(root / 'best.ckpt')])
        want = max(ms_rows, key=lambda r: (r['refined']['SSIM'],
                                           r['clean']['SSIM']))
        check(best['ckpt'] == want['ckpt'], f'pick: {best["ckpt"]}, '
              f'expected {want["ckpt"]}')
        state = load_params(want['ckpt'])
        ref = GaussianDiffusion(Unet(**Q.UNET), image_size=Q.IMAGE_SIZE,
                                timesteps=Q.TIMESTEPS,
                                params=state.get('ema_params', state),
                                device=dev)
        load_diffusion_params(d, root / 'best.ckpt')
        check(all(torch.equal(a, b) for a, b in zip(
            d.model.parameters(), ref.model.parameters())),
            'the exported pick does not load back to its weights')

        # e. The OpenFWI example through the inversion CLI.
        ex = _load_file('torch_example_openfwi', EXAMPLE)
        from red_diffeq_tpu_torch.config import load_config
        pde = load_config('configs/openfwi/red-diffeq.yaml').pde.to_dict()
        t0 = time.perf_counter()
        final, counts, plain = counted(lambda: ex.main(
            ['--results_dir', str(root / 'example'), '--device', dev.type,
             '--ts', str(PLUMBING_TS)], data_root=root / 'example_data'))
        ex_hp = 70 + 2 * pde['nbc']
        ex_wp = pde['n_grid'] + 2 * pde['nbc']
        want = route_launches(PLUMBING_TS, pde['nt'], ex_hp, ex_wp)
        check(counts == want and plain == -(-2 * pde['nt'] // Q.CHUNK),
              f'example: launches {counts}, plain chunks {plain}; expected '
              f'{want} and the refined observations only')
        check(all(np.isfinite(v) for v in final.values()),
              f'example: {final}')
        print(f'quality slice, OpenFWI example ({PLUMBING_TS} steps through '
              f'the CLI, {time.perf_counter() - t0:.2f} s): MAE '
              f'{final["mae"]:.4f} RMSE {final["rmse"]:.4f} SSIM '
              f'{final["ssim"]:.4f}; launches {counts}', flush=True)
    finally:
        InversionEngine.warm_compile, InversionEngine.optimize = warm, \
            optimize
        stencil.build, Q.held_out_problem = build, held
    return out


# The mesh slice (phase 18): the headline over a (data x shot) mesh of the
# cards, round-robin (one card repeated on a one-card machine): MESH_TS
# RED-DiffEq steps sharded (2 x 5) against unsharded, the taped route
# (nbc=40) over (4 x 1) for MESH_NARROW_TS steps, the inversion CLI over
# its tpu.mesh_* for MESH_CLI_TS steps, the trainer's data-parallel step
# over MESH_TRAIN_DEVICES copies of the card for MESH_TRAIN_STEPS steps at
# batch MESH_TRAIN_BATCH, the U-Net's full constructor, and the upstream
# checkpoint converter.
MESH = dict(data=2, shot=5)
MESH_NARROW = dict(data=4, shot=1)
MESH_NARROW_TS, MESH_CLI_TS = 3, 5
MESH_PRESET = 'configs/openfwi/red-diffeq.yaml'
MESH_SEED = 6060
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_DEVICES = 6, 32, 2
MESH_TRAIN_SIZE, MESH_TRAIN_UNET = 72, dict(dim=64, dim_mults=(1, 2, 4, 8))
# PR 10's gate: Adam turns a gradient within rounding of 0 into another
# fraction of a step. The shot split is exact on the kernels; a data shard
# runs the U-Net on its own rows, whose convolutions may round apart from
# the whole batch's (cuDNN picks its algorithm by the batch).
MESH_SHARE, MESH_STEP_FRACTION = 0.01, 0.1
MESH_UNET = dict(dim=64, dim_mults=(1, 2, 4, 8), self_condition=True,
                 learned_variance=True, random_fourier_features=True,
                 full_attn=(False, True, False, True), attn_heads=(2, 4, 4, 8))
MESH_UNET_BATCH = 4
CONVERT_TOOL = 'tools/torch_convert_checkpoint.py'


def mesh_devices(dev, n):
    """``n`` devices for a mesh: the cards round-robin (on a one-card
    machine the card ``n`` times); ``dev`` repeated off the card."""
    import torch
    if dev.type != 'cuda':
        return [dev] * n
    return [torch.device('cuda', i % torch.cuda.device_count())
            for i in range(n)]


def gate_sharded(label, got, want, lr):
    """PR 10's gate of a sharded run (mu, curves) against the unsharded
    one: mu within 1e-4 on all but MESH_SHARE of its cells and within
    MESH_STEP_FRACTION of one Adam step (lr) on every cell, the curves rtol
    1e-4, and the first step's losses (before any update) 1e-6 relative.
    Returns (max |d mu|, share of cells beyond 1e-4)."""
    (mu_g, c_g), (mu_w, c_w) = got, want
    diff = (mu_g - mu_w).abs()
    d, share = float(diff.max()), float((diff > 1e-4).float().mean())
    check(share <= MESH_SHARE and d <= MESH_STEP_FRACTION * lr,
          f'{label}: max |d mu| {d:.3e} (at most '
          f'{MESH_STEP_FRACTION * lr:.3g}), {share:.2%} of the cells beyond '
          f'1e-4 (at most {MESH_SHARE:.0%})')
    for i, (g, w) in enumerate(zip(c_g, c_w)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f'{label}: sample {i} {k}')
        for k in ('obs_losses', 'total_losses'):
            rel = abs(g[k][0] - w[k][0]) / abs(w[k][0])
            check(rel <= 1e-6, f'{label}: sample {i} first {k} '
                  f'{g[k][0]:.9g} vs {w[k][0]:.9g} (rel {rel:.2e})')
    return d, share


def mesh_route_launches(route, steps, nt, hp, wp, layout=None):
    """Launches of ``route``'s kernels in ``steps`` steps
    (:func:`route_launches`; on the taped route ``bwd_tape_step`` in place
    of ``bwd_reverse_step`` and one ``tape_step`` a chunk). Over a mesh of
    ``layout`` every shard launches the stepping kernels as the unsharded
    run does, and each data shard one ``sum_shots`` a chunk over all its
    shots."""
    from red_diffeq_tpu_torch.ops import stencil
    want = route_launches(steps, nt, hp, wp)
    if route == 'tape':
        chunks = steps * -(-nt // CHUNK)
        want['bwd_reverse_step'] = 0
        want['bwd_tape_step'] = chunks * -(-CHUNK // stencil.pick_blocking(
            'bwd_tape_step', hp, wp)[0])
        want['tape_step'] = chunks
    if layout is not None:
        want = {k: v * (layout['data'] if k == 'sum_shots'
                        else layout['data'] * layout['shot'])
                for k, v in want.items()}
    return want


def mesh_inversion(dev, diffusion, ctx, layout, ts, route):
    """``ts`` RED-DiffEq steps of the headline problem at ``ctx``
    unsharded, then twice over a mesh of ``layout`` on
    :func:`mesh_devices`: the repeat bit for bit, the sharded run held to
    the unsharded one by :func:`gate_sharded`, each run's launches exactly
    the route's per shard times the shards, the plain path unused. Returns
    the sharded run's launches, s/step of both and the gate's numbers."""
    import torch
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.parallel.mesh import make_mesh
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize,
    )

    problem = slice_problem(dev, ctx)
    op = acoustic.FWIForward(ctx, v_denorm_func=v_denormalize,
                             s_norm_func=s_normalize_none, chunk=CHUNK,
                             device=dev)
    check(stencil.resolve_run_config(op.geom, CHUNK)[0] == route,
          f'nbc={ctx["nbc"]}: not the {route!r} route')
    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)
    shards = layout['data'] * layout['shot']
    mesh = make_mesh(devices=mesh_devices(dev, shards), **layout)

    def run(m, steps):
        gen = torch.Generator(device=dev).manual_seed(8888)
        stencil.reset_launches()
        acoustic.plain_chunk_calls['chunk'] = 0
        t0 = time.perf_counter()
        out = engine.optimize(problem['mu0'], problem['v_true'],
                              problem['y'], op, ts=steps, lr=0.03,
                              reg_lambda=0.75, generator=gen,
                              progress=False, mesh=m)
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / steps
        check(acoustic.plain_chunk_calls['chunk'] == 0,
              'the plain path ran')
        return out, s, dict(stencil.launches)

    run(None, 1)                # warm-ups: cuDNN plans at both U-Net
    run(mesh, 1)                # batches, the allocator
    one, s_one, n_one = run(None, ts)
    sharded, s_mesh, n_mesh = run(mesh, ts)
    again, _, _ = run(mesh, ts)
    hp = ctx['n_grid'] + 2 * ctx['nbc']
    want = mesh_route_launches(route, ts, ctx['nt'], hp, hp)
    want_mesh = mesh_route_launches(route, ts, ctx['nt'], hp, hp, layout)
    label = f'mesh {layout["data"]} x {layout["shot"]} at nbc={ctx["nbc"]}'
    for name in want:
        check(n_one[name] == want[name], f'unsharded: {name} launched '
              f'{n_one[name]} times, expected {want[name]}')
        check(n_mesh[name] == want_mesh[name], f'{label}: {name} launched '
              f'{n_mesh[name]} times, expected {want_mesh[name]}')
    check(torch.equal(again[0], sharded[0]) and again[1] == sharded[1],
          f'{label}: a second sharded run differs')
    d, share = gate_sharded(label, sharded, one, 0.03)
    print(f'{label} ({shards} shards on {len(set(mesh.devices.flat))} '
          f'card(s)), {ts} steps: {s_mesh:.4f} s/step sharded, {s_one:.4f} '
          f'unsharded (host clock); max |d mu| {d:.3e} ('
          + ('bit for bit' if d == 0 else f'{share:.2%} of the cells beyond '
             '1e-4') + f'); the repeat bit for bit; launches {n_mesh}',
          flush=True)
    return dict(counts=n_mesh, s_mesh=s_mesh, s_one=s_one, d=d, share=share)


def mesh_cli(dev, root):
    """The inversion CLI over ``tpu.mesh_data`` x ``tpu.mesh_shot`` = MESH
    on :func:`mesh_devices` (``run_experiment(mesh_devices=...)``) against
    the same preset unsharded, on a 2-sample synthetic dataset at the
    headline preset's width, MESH_CLI_TS steps of both samples as one
    batch: the results within :func:`gate_sharded`, the datasets read by
    native loaders. Returns the ms of a batch read and of its prefetch
    call."""
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.cli import run_inversion
    from red_diffeq_tpu_torch.config import load_config
    from red_diffeq_tpu_torch.io import native_loader
    from red_diffeq_tpu_torch.io.synthetic import generate_mixed_dataset

    root = Path(root)
    cfg = load_config(MESH_PRESET)
    ctx = cfg.pde.to_dict()
    v_true = generate_mixed_dataset(2, h=ctx['n_grid'], w=ctx['n_grid'],
                                    seed=MESH_SEED)
    y = refined_observations(dev, ctx, v_true)
    for key, sub, arr in (('seismic_data_dir', 'Seismic_Data', y),
                          ('velocity_data_dir', 'Velocity_Data', v_true)):
        (root / 'OpenFWI' / sub).mkdir(parents=True, exist_ok=True)
        np.save(root / 'OpenFWI' / sub / 'synthetic.npy', arr)
        cfg.data[key] = str(root / 'OpenFWI' / sub)
    cfg.diffusion.model_path = str(Path(CKPT).resolve())
    cfg.experiment.results_dir = str(root / 'results')
    cfg.optimization.ts = MESH_CLI_TS
    cfg.data.batch_size = 2
    loaders = []

    class Loader(native_loader.NpyBatchLoader):
        def __init__(self, path):
            super().__init__(path)
            loaders.append(self)

    opened = run_inversion.NpyBatchLoader
    run_inversion.NpyBatchLoader = Loader
    results = {}
    try:
        for name, layout in (('unsharded', dict(data=1, shot=1)),
                             ('sharded', MESH)):
            cfg.tpu.mesh_data, cfg.tpu.mesh_shot = layout['data'], \
                layout['shot']
            cfg.experiment.name = f'mesh_{name}'
            t0 = time.perf_counter()
            out = run_inversion.run_experiment(
                cfg, device=dev,
                mesh_devices=mesh_devices(dev, layout['data']
                                          * layout['shot']))
            torch.cuda.synchronize()
            results[name] = (out, time.perf_counter() - t0)
    finally:
        run_inversion.NpyBatchLoader = opened
    check(len(loaders) == 4 and all(ld.path.suffix == '.npy'
                                    for ld in loaders),
          f'{len(loaders)} loaders opened, expected 4')
    runs = {}
    for name, (out, _) in results.items():
        npz = [np.load(out / 'synthetic' / f'{i}_results.npz')
               for i in range(2)]
        runs[name] = (torch.from_numpy(np.stack([d['result'] for d in npz])),
                      [{k: d[k] for k in NPZ_KEYS[3:]} for d in npz])
    d, share = gate_sharded('CLI over the mesh', runs['sharded'],
                            runs['unsharded'], cfg.optimization.lr)
    probe = native_loader.NpyBatchLoader(
        root / 'OpenFWI' / 'Seismic_Data' / 'synthetic.npy')
    check(probe.native, 'the native loader is not built on the card')
    t0 = time.perf_counter()
    probe.prefetch(0, 2)
    prefetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = probe[0:2]
    read_ms = (time.perf_counter() - t0) * 1e3
    probe.close()
    check(np.array_equal(batch, y), 'the loader read other rows')
    print(f'CLI over tpu.mesh_data={MESH["data"]} x mesh_shot='
          f'{MESH["shot"]}: {MESH_CLI_TS} steps in '
          f'{results["sharded"][1]:.2f} s (unsharded '
          f'{results["unsharded"][1]:.2f} s, set-up included), max |d mu| '
          f'{d:.3e}, {share:.2%} of the cells beyond 1e-4; native loaders: '
          f'a batch of {batch.nbytes / 1e6:.2f} MB read in {read_ms:.3f} ms '
          f'(warm page cache), its prefetch call {prefetch_ms:.3f} ms',
          flush=True)
    return dict(read_ms=read_ms, prefetch_ms=prefetch_ms, d=d, share=share)


def mesh_trainer(dev, root):
    """The trainer's data-parallel step over MESH_TRAIN_DEVICES copies of
    the card (``Trainer(devices=...)``) against one device, at the shipped
    prior's width, MESH_TRAIN_STEPS steps of batch MESH_TRAIN_BATCH under
    deterministic cuDNN: the losses within rtol 2e-5. Returns s per step of
    both, the first step not timed."""
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.trainer import TensorDataset, Trainer
    from red_diffeq_tpu_torch.models.unet import Unet

    n = MESH_TRAIN_SIZE
    data = np.random.RandomState(0).rand(64, 1, n, n).astype(np.float32)
    losses, secs = {}, {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for split in (False, True):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                unet = Unet(**MESH_TRAIN_UNET)
            d = GaussianDiffusion(unet, image_size=n, timesteps=1000,
                                  device=dev)
            tr = Trainer(d, TensorDataset(data),
                         train_batch_size=MESH_TRAIN_BATCH,
                         train_num_steps=MESH_TRAIN_STEPS,
                         save_and_sample_every=10 ** 6, train_lr=2e-4,
                         results_folder=str(Path(root) / f'dp_{split}'),
                         seed=7, devices=(mesh_devices(
                             dev, MESH_TRAIN_DEVICES) if split else None))
            check((tr.devices is not None) is split, 'devices not taken')
            tr.train_num_steps = 1          # the first step picks cuDNN's
            tr.train(log_every=10 ** 6)     # plans: not timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_num_steps = MESH_TRAIN_STEPS
            tr.train(log_every=10 ** 6)
            torch.cuda.synchronize()
            secs[split] = (time.perf_counter() - t0) / (MESH_TRAIN_STEPS - 1)
            losses[split] = np.array([e['loss'] for e in tr.training_losses])
    finally:
        torch.backends.cudnn.deterministic = det
    check(losses[True].shape == (MESH_TRAIN_STEPS,),
          f'{losses[True].shape} losses')
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-5,
                               atol=1e-6, err_msg='data-parallel losses')
    rel = float(np.max(np.abs(losses[True] - losses[False])
                       / np.abs(losses[False])))
    print(f'trainer, batch {MESH_TRAIN_BATCH} split over '
          f'{MESH_TRAIN_DEVICES} copies of the card: losses max rel diff '
          f'{rel:.3e} from one device over {MESH_TRAIN_STEPS} steps; '
          f'{secs[True]:.4f} s/step split, {secs[False]:.4f} unsplit',
          flush=True)
    return dict(rel=rel, s_split=secs[True], s_one=secs[False])


def mesh_unet(dev):
    """A dim-64 U-Net with MESH_UNET's fields on the card against the same
    weights on the CPU (TF32 off): batch MESH_UNET_BATCH at 72x72, with a
    self-conditioning input, max-rel 1e-4. Returns the max-rel."""
    import copy
    import torch
    from red_diffeq_tpu_torch.models.unet import Unet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        unet = Unet(**MESH_UNET).eval()
        x = torch.randn(MESH_UNET_BATCH, 1, 72, 72)
        cond = torch.rand_like(x) * 2 - 1
    t = torch.tensor([0, 250, 500, 999])[:MESH_UNET_BATCH]
    with torch.no_grad():
        want = unet(x, t, cond)
        got = copy.deepcopy(unet).to(dev)(x.to(dev), t.to(dev),
                                          cond.to(dev)).cpu()
    check(tuple(got.shape) == (MESH_UNET_BATCH, 2, 72, 72),
          f'U-Net output {tuple(got.shape)}')
    rel = max_rel(got, want)
    check(rel <= 1e-4, f'U-Net fields on the card vs CPU: max-rel {rel:.3e}')
    print(f'U-Net with {sorted(k for k in MESH_UNET if k != "dim")}: '
          f'card vs CPU max-rel {rel:.3e}', flush=True)
    return rel


def mesh_converter(dev, root):
    """The shipped prior written out in the upstream layout (a
    ``model-<k>.pt`` dict, ``model.``-prefixed) and converted back by
    CONVERT_TOOL: every weight bit for bit, and the U-Net's output on the
    card unchanged. Returns the tool's seconds."""
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.io.checkpoints import (
        _flatten, load_diffusion_params, load_params,
    )
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet

    tool = _load_file('torch_convert_checkpoint', CONVERT_TOOL)
    prior = load_params(CKPT)
    pt = Path(root) / 'model-4.pt'
    torch.save({'step': 4, 'version': 'upstream', 'model': {
        f'model.{k}': torch.from_numpy(np.array(v))
        for k, v in tool.to_upstream(prior, 64, (1, 2, 4, 8)).items()}}, pt)
    out = Path(root) / 'model-4.ckpt'
    t0 = time.perf_counter()
    tool.main([str(pt), str(out), '--source', 'model'])
    secs = time.perf_counter() - t0
    want, got = dict(_flatten(prior)), dict(_flatten(load_params(out)))
    check(got.keys() == want.keys(), 'converted tree has other leaves')
    for k in want:
        check(got[k].dtype == want[k].dtype
              and np.array_equal(got[k], want[k]), f'{k} changed')
    outs = []
    x = torch.randn(2, 1, 72, 72, generator=torch.Generator().manual_seed(5))
    for path in (CKPT, out):
        d = GaussianDiffusion(Unet(dim=64, dim_mults=(1, 2, 4, 8)),
                              image_size=72, timesteps=1000, device=dev)
        load_diffusion_params(d, str(path))
        with torch.no_grad():
            outs.append(d.model(x.to(dev), torch.tensor([10, 900],
                                                        device=dev)))
    check(torch.equal(outs[0], outs[1]), 'the converted prior denoises '
          'differently')
    print(f'{CONVERT_TOOL}: the shipped prior through the upstream layout '
          f'and back, {len(want)} leaves bit for bit, the U-Net output '
          f'unchanged ({secs:.2f} s)', flush=True)
    return secs


def phase_mesh(dev, root):
    """The mesh slice (see MESH above). Returns the sharded headline's and
    the taped route's launches and the phase's numbers."""
    diffusion = load_prior(dev)
    out = dict(headline=mesh_inversion(dev, diffusion, HEADLINE, MESH, TS,
                                       'reverse'),
               narrow=mesh_inversion(dev, diffusion, NARROW, MESH_NARROW,
                                     MESH_NARROW_TS, 'tape'))
    del diffusion
    out['cli'] = mesh_cli(dev, root)
    out['trainer'] = mesh_trainer(dev, root)
    out['unet_rel'] = mesh_unet(dev)
    out['convert_s'] = mesh_converter(dev, root)
    return out


# The scan slice: the JAX engine's whole-loop dispatch as a CUDA graph of
# the step (core/graphs.py), at the headline. SCAN_TS steps a run, graphed
# against eager on each route; segments of SCAN_SEGMENT steps and snapshots
# as often, the resume from SCAN_RESUME_AT; a trace of SCAN_TRACE_TS
# replays; the mesh for SCAN_MESH_TS steps; the wide CLI for SCAN_CLI_TS;
# the plain backend at phase_small_reference's size for SCAN_PLAIN_TS.
SCAN_TS, SCAN_SEGMENT, SCAN_RESUME_AT = 20, 7, 14
SCAN_TRACE_TS, SCAN_MESH_TS, SCAN_CLI_TS, SCAN_PLAIN_TS = 3, 5, 5, 3
SMALL = dict(n_grid=16, nt=100, dx=10.0, dt=0.001, nbc=60, f=15.0, sz=10,
             gz=10, ng=16, ns=2)


def same_run(a, b):
    """Whether two runs' (mu, curves) are equal bit for bit."""
    import torch
    return torch.equal(a[0], b[0]) and all(
        np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
        for x, y in zip(a[1], b[1]) for k in x)


def scan_runner(dev, engine, op, problem, ts, mesh=None):
    """A function running ``ts`` steps of ``engine.optimize`` on
    ``problem`` from one generator seed, its keywords passed on, with the
    launch counters, the plain path's chunks and the peak device memory
    set to 0 just before it and read just after; returns (mu, curves), s
    a step by the host clock, launches, plain chunks, peak bytes."""
    import torch
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    def run(**kw):
        gen = torch.Generator(device=dev).manual_seed(8888)
        torch.cuda.synchronize()
        stencil.reset_launches()
        acoustic.plain_chunk_calls['chunk'] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = engine.optimize(problem['mu0'], problem['v_true'],
                              problem['y'], op, ts=ts, lr=0.03,
                              reg_lambda=0.75, generator=gen,
                              progress=False, mesh=mesh, **kw)
        torch.cuda.synchronize()
        return dict(out=out, s=(time.perf_counter() - t0) / ts,
                    launches=dict(stencil.launches),
                    plain=acoustic.plain_chunk_calls['chunk'],
                    peak=torch.cuda.max_memory_allocated())

    return run


def scan_pair(label, run, engine, ts, want=None):
    """Graph against eager: ``run`` eagerly (``use_scan=False``), graphed
    (the first step eager, then the capture), graphed again (the kept
    graph's replays, no capture) and eagerly again. Each graphed run equals
    the eager one bit for bit (the model, every curve) and launches as it
    did; one capture (none on the CPU, where the step runs eagerly and a
    replay's launches are an eager step's). ``want``: a launches dict one
    replay must make. Returns the numbers of each mode (s a step by the
    host clock of the second run of each, the graph's capture seconds,
    pool bytes, launches a replay, peak bytes) and the graphed run."""
    captures = engine.graph_captures
    eager, first, graphed, eager2 = (run(use_scan=False),
                                     run(use_scan=True), run(use_scan=True),
                                     run(use_scan=False))
    cuda = engine.device.type == 'cuda'
    check(engine.graph_captures == captures + cuda, f'{label}: '
          f'{engine.graph_captures - captures} captures, expected {int(cuda)}')
    per_step = {k: n // ts for k, n in eager['launches'].items() if n}
    info = (engine.graph_info()[-1] if cuda else
            dict(launches=per_step, seconds=0.0, pool_bytes=0))
    if eager['plain']:
        per_step['plain_chunk'] = eager['plain'] // ts
    for name, r in (('captured', first), ('replayed', graphed),
                    ('eager again', eager2)):
        d = float((r['out'][0] - eager['out'][0]).abs().max())
        check(same_run(r['out'], eager['out']), f'{label}: the {name} run '
              f'differs from the eager one (max |d mu| {d:.3e})')
        check(r['launches'] == eager['launches']
              and r['plain'] == eager['plain'], f'{label}: the {name} run '
              f'launched {r["launches"]} (plain {r["plain"]}), the eager '
              f'one {eager["launches"]} (plain {eager["plain"]})')
    check(info['launches'] == per_step and (want is None
                                            or info['launches'] == want),
          f'{label}: a replay launches {info["launches"]}, an eager step '
          f'{per_step}' + ('' if want is None else f', expected {want}'))
    res = dict(s_eager=eager2['s'], s_graph=graphed['s'],
               s_first=first['s'], capture_s=info['seconds'],
               pool_bytes=info['pool_bytes'], per_replay=info['launches'],
               peak_eager=eager2['peak'], peak_graph=graphed['peak'],
               peak_capture=first['peak'], launches=graphed['launches'])
    print(f'{label}: graphed = eager bit for bit over {ts} steps; '
          f'{res["s_graph"]:.4f} s/step graphed against '
          f'{res["s_eager"]:.4f} eager (host clock; '
          f'{res["s_first"]:.4f} with the capture), capture '
          f'{res["capture_s"]:.3f} s, pool {res["pool_bytes"] / 2**20:.1f} '
          f'MiB, a replay launches {res["per_replay"]}; peak allocated '
          f'{res["peak_graph"] / 2**20:.1f} MiB replaying, '
          f'{res["peak_capture"] / 2**20:.1f} capturing, '
          f'{res["peak_eager"] / 2**20:.1f} eager', flush=True)
    return res, graphed['out']


def scan_trace_kernels(trace_dir, run, want, label):
    """The Chrome trace in ``trace_dir`` of a SCAN_TRACE_TS-step ``run``
    (:func:`scan_runner`'s): its kernels by name equal the run's counters
    and SCAN_TRACE_TS times ``want``, one ``inversion_step`` range a step.
    Returns its device events."""
    import re
    files = sorted(trace_dir.glob('*.pt.trace.json'))
    check(len(files) == 1, f'{label}: profile_dir holds {files}')
    events = json.loads(files[0].read_text())['traceEvents']
    device = [e for e in events if e.get('ph') == 'X'
              and e.get('cat') in DEVICE_CATS]
    names = (*API_KERNELS, *TAPE_KERNELS, 'bwd_tape_step')
    kernels = dict.fromkeys(names, 0)
    for e in device:
        hit = [k for k in names if e['cat'] == 'kernel'
               and re.search(rf'\b{k}\b', e['name'])]
        if hit:
            kernels[hit[0]] += 1
    steps = [e for e in events if e.get('name') == 'inversion_step'
             and e.get('ph') == 'X' and e.get('cat') == 'user_annotation']
    expect = {k: SCAN_TRACE_TS * want.get(k, 0) for k in names}
    check(kernels == expect == {k: run['launches'][k] for k in names},
          f'{label}: kernels {kernels}, counters {run["launches"]}, '
          f'expected {expect}')
    check(len(steps) == SCAN_TRACE_TS, f'{label}: {len(steps)} '
          f'inversion_step ranges, expected {SCAN_TRACE_TS}')
    print(f'{label}: kernels {kernels} (= the counters)', flush=True)
    return device


def scan_trace(dev, engine, op, problem, root, want):
    """SCAN_TRACE_TS replays of a graph ``warm_compile`` captured, traced
    with ``profile_dir``: the trace's kernels by name equal the counters
    and SCAN_TRACE_TS times ``want`` (a replay's launches); then a traced
    run that captures its graph under the profiler, likewise. Returns the
    device window's idle share and its ms a step of the first."""
    y = problem['y']
    engine.warm_compile(problem['mu0'].shape, y.shape, op,
                        ts=SCAN_TRACE_TS, lr=0.03, reg_lambda=0.75)
    captures = engine.graph_captures
    r = scan_runner(dev, engine, op, problem, SCAN_TRACE_TS)(
        profile_dir=str(root / 'scan_trace'))
    check(engine.graph_captures == captures, 'the traced run captured')
    device = scan_trace_kernels(root / 'scan_trace', r, want,
                                'scan trace')
    engine.release_graphs()
    r2 = scan_runner(dev, engine, op, problem, SCAN_TRACE_TS)(
        profile_dir=str(root / 'scan_trace_capture'))
    check(engine.graph_captures == captures + 1, 'the second traced run '
          'did not capture')
    scan_trace_kernels(root / 'scan_trace_capture', r2, want,
                       'scan trace with the capture')
    busy, window = device_window(device)
    idle = 1.0 - busy / window
    print(f'scan trace ({SCAN_TRACE_TS} replays of a warm_compile graph): '
          f'the device window {window / SCAN_TRACE_TS / 1e3:.3f} ms a step, '
          f'busy {busy / SCAN_TRACE_TS / 1e3:.3f}, idle {idle:.2%}; '
          f'{r["s"] - trace_margins(dev) / SCAN_TRACE_TS:.4f} '
          's/step by the host clock under the profiler (its window '
          'margins left out)',
          flush=True)
    return idle, window / SCAN_TRACE_TS / 1e3


def phase_scan(dev, root):
    """The scan slice (see SCAN_TS above): ``optimize(use_scan=True)``, a
    CUDA graph of the step captured at the first step and replayed, against
    the eager loop, bit for bit, on the tape-free route, the taped route
    forced, nbc=40 (taped by the guard) and the bf16 U-Net; segments and a
    resume against the unsegmented graph; one ``warm_compile`` capture
    serving three runs; the launches of a replay by the counters and by a
    trace, with the graphed step's idle share; the (2 x 5) mesh over the
    card; the wide CLI with ``tpu.use_scan`` true against false; the plain
    backend. Returns the numbers and the headline's launches."""
    from pathlib import Path
    import torch
    from red_diffeq_tpu_torch.config import load_config, save_config
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.unet import Unet
    from red_diffeq_tpu_torch.parallel.mesh import make_mesh
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize, v_normalize,
    )

    root = Path(root)
    diffusion = load_prior(dev)
    out = {}

    def operator(ctx, adjoint=None, backend='auto'):
        return acoustic.FWIForward(ctx, v_denorm_func=v_denormalize,
                                   s_norm_func=s_normalize_none, chunk=CHUNK,
                                   adjoint=adjoint, backend=backend,
                                   device=dev)

    hp = HEADLINE['n_grid'] + 2 * HEADLINE['nbc']
    want = {k: n for k, n in route_launches(1, HEADLINE['nt'], hp,
                                            hp).items() if n}
    problem = slice_problem(dev, HEADLINE)
    op = operator(HEADLINE)
    engine = InversionEngine(diffusion, regularization='diffusion',
                             sigma_x0=1e-4, device=dev)
    run = scan_runner(dev, engine, op, problem, SCAN_TS)
    out['reverse'], graphed = scan_pair('scan, headline (reverse)', run,
                                        engine, SCAN_TS, want)

    # Segments, snapshots and the resume, against the unsegmented graph.
    seg = run(segment_steps=SCAN_SEGMENT)
    check(same_run(seg['out'], graphed), f'segment_steps={SCAN_SEGMENT} '
          'differs from the unsegmented graph')
    with cut_after_snapshot(SCAN_RESUME_AT):
        run(checkpoint_path=root / 'scan.pt', checkpoint_every=SCAN_SEGMENT)
    fresh = InversionEngine(diffusion, regularization='diffusion',
                            sigma_x0=1e-4, device=dev)
    resumed = scan_runner(dev, fresh, op, problem, SCAN_TS)(
        checkpoint_path=root / 'scan.pt', checkpoint_every=SCAN_SEGMENT,
        resume=True)
    check(same_run(resumed['out'], graphed), f'the graphed run resumed at '
          f'step {SCAN_RESUME_AT} differs from the uninterrupted one')
    print(f'scan: segment_steps={SCAN_SEGMENT} and a resume at step '
          f'{SCAN_RESUME_AT} (snapshots every {SCAN_SEGMENT}) equal the '
          'unsegmented graph bit for bit', flush=True)
    del fresh

    # One warm_compile capture serves three runs.
    warm = InversionEngine(diffusion, regularization='diffusion',
                           sigma_x0=1e-4, device=dev)
    rec = warm.warm_compile(problem['mu0'].shape, problem['y'].shape, op,
                            ts=SCAN_TS, lr=0.03, reg_lambda=0.75)
    check(rec['graph'] is not None and rec['graph']['launches'] == want
          and rec['launches'] == want, f'warm_compile: {rec}')
    wrun = scan_runner(dev, warm, op, problem, SCAN_TS)
    calls = [wrun() for _ in range(3)]
    check(warm.graph_captures == 1 and all(same_run(c['out'], graphed)
                                           for c in calls),
          f'warm_compile: {warm.graph_captures} captures for three runs, '
          'or a run differs from the graphed one')
    out['cache'] = dict(warm_s=rec['seconds'],
                        capture_s=rec['graph']['seconds'],
                        first_s=calls[0]['s'], third_s=calls[2]['s'])
    print(f'scan: warm_compile {rec["seconds"]:.3f} s (capture '
          f'{rec["graph"]["seconds"]:.3f} s), then 1 capture for 3 runs: '
          f'{calls[0]["s"]:.4f} s/step the first, {calls[2]["s"]:.4f} the '
          'third', flush=True)
    warm.release_graphs()
    del warm

    # The launches by a trace, and the graphed step's idle share.
    out['idle'], out['window_ms'] = scan_trace(dev, engine, op, problem,
                                               root, want)
    engine.release_graphs()

    # The taped route forced, and the bf16 U-Net.
    tape_want = {k: n for k, n in mesh_route_launches(
        'tape', 1, HEADLINE['nt'], hp, hp).items() if n}
    out['tape'], _ = scan_pair(
        'scan, headline (tape forced)',
        scan_runner(dev, engine, operator(HEADLINE, 'tape'), problem,
                    SCAN_TS), engine, SCAN_TS, tape_want)
    diffusion.half_precision = True
    try:
        out['bf16'], _ = scan_pair('scan, headline bf16 U-Net', run, engine,
                                   SCAN_TS, want)
    finally:
        diffusion.half_precision = False
    engine.release_graphs()

    # The mesh over the card repeated.
    mesh = make_mesh(devices=mesh_devices(dev, MESH['data'] * MESH['shot']),
                     **MESH)
    out['mesh'], _ = scan_pair(
        f'scan, mesh {MESH["data"]} x {MESH["shot"]}',
        scan_runner(dev, engine, op, problem, SCAN_MESH_TS, mesh=mesh),
        engine, SCAN_MESH_TS)
    engine.release_graphs()
    del problem

    # nbc=40: the guard's taped route.
    hn = NARROW['n_grid'] + 2 * NARROW['nbc']
    narrow = slice_problem(dev, NARROW)
    out['narrow'], _ = scan_pair(
        f'scan, nbc={NARROW["nbc"]} (tape)',
        scan_runner(dev, engine, operator(NARROW), narrow, SCAN_TS), engine,
        SCAN_TS, {k: n for k, n in mesh_route_launches(
            'tape', 1, NARROW['nt'], hn, hn).items() if n})
    engine.release_graphs()
    del narrow, engine

    # The wide CLI, tpu.use_scan true against false.
    paths = write_wide_dataset(dev, root / 'wide')
    results = {}
    for flag in (True, False):
        cfg = load_config(paths[WIDE_PRESET])
        cfg.tpu.use_scan = flag
        cfg.experiment.results_dir = str(root / f'scan_cli_{flag}')
        path = root / f'scan-cli-{flag}.yaml'
        save_config(cfg, path)
        seen = run_cli(dev, ['--config', str(path), '--ts', str(SCAN_CLI_TS),
                             '--sample_index', '0'])
        npz = sorted(seen['out'].glob('*/0_results.npz'))
        check(len(npz) == 1, f'scan CLI ({flag}): {npz}')
        results[flag] = (np.load(npz[0]), seen['wall_s'])
    d_scan, d_eager = results[True][0], results[False][0]
    check(sorted(d_scan.files) == sorted(NPZ_KEYS)
          and all(np.array_equal(d_scan[k], d_eager[k]) for k in NPZ_KEYS),
          'scan CLI: the graphed run\'s 0_results.npz differs from the '
          'eager one\'s')
    out['cli_s'] = {flag: r[1] for flag, r in results.items()}
    print(f'scan, wide CLI ({WIDE_ROWS}x{load_config(paths[WIDE_PRESET]).pde.n_grid}'
          f', {SCAN_CLI_TS} steps): tpu.use_scan true and false write the '
          f'same 0_results.npz; {results[True][1]:.2f} s against '
          f'{results[False][1]:.2f} s for the CLI', flush=True)

    # The plain backend at phase_small_reference's size.
    torch.manual_seed(0)
    small = GaussianDiffusion(Unet(dim=8, dim_mults=(1, 2), channels=1),
                              image_size=18, timesteps=20, device=dev)
    v_true = np.full((2, 1, 16, 16), 2000.0, np.float32)
    v_true[:, :, 9:] = 3200.0
    plain_op = operator(SMALL, backend='plain')
    with torch.no_grad():
        y = plain_op(v_normalize(torch.from_numpy(v_true).to(dev)))
    mu0 = np.pad(np.full((2, 1, 16, 16), -0.2, np.float32),
                 ((0, 0), (0, 0), (1, 1), (1, 1)))
    small_engine = InversionEngine(small, regularization='diffusion',
                                   sigma_x0=1e-4, device=dev)
    out['plain'], _ = scan_pair(
        'scan, plain backend (16x16)',
        scan_runner(dev, small_engine, plain_op,
                    dict(mu0=mu0, v_true=v_true, y=y), SCAN_PLAIN_TS),
        small_engine, SCAN_PLAIN_TS)
    small_engine.release_graphs()
    return out


# The loop-graphs slice: the JAX package's other one-program loops as CUDA
# graphs (core/graphs.py), each against its body run eagerly in the same
# call (graphs.eager_loops()), bit for bit: DiffusionFWI and ILVR-FWI at the
# OpenFWI ablation preset through red-diffeq-torch-bench (30 x 10 steps)
# and at the Marmousi ablation preset (the patched denoise) cut to
# BENCH_WIDE_DIFFUSION_TS outer steps, each against the bench slice's eager
# run of it, and a traced graphed DiffusionFWI run of LOOP_TRACE (outer,
# inner) steps for the idle share; DDIM at SAMPLER_STEPS and SAMPLER_BATCH
# (and once with return_all_timesteps); the ancestral chain on a
# LOOP_ANCESTRAL_T-step schedule of the prior's U-Net, interpolate from
# LOOP_INTERP_T on it and RED's post-process chain from LOOP_POST_TS on the
# prior's own schedule; at the train CLI's defaults under deterministic
# cuDNN with --amp and --calculate_fid (fp32 in the training slice, whose
# resume check takes its eager run): LOOP_TRAIN_STEPS train steps twice
# (the second call's replays timed), a milestone, and LOOP_TRAIN_STEPS
# steps after it.
LOOP_ANCESTRAL_T, LOOP_INTERP_T, LOOP_POST_TS = 100, 50, 50
LOOP_TRAIN_STEPS = 20
LOOP_TRACE = (3, 10)


@contextlib.contextmanager
def loop_spy():
    """Within the block, a spy on ``graphs.LoopGraphs.run``: a CUDA event
    recorded before each run of a program named 'denoise' (one an outer
    step of the competitor methods; their spacing is the period of an
    outer step), and the name and ``StepGraph.info()`` of each graph a run
    captures."""
    import torch
    from red_diffeq_tpu_torch.core import graphs

    seen = dict(events=[], graphs=[])
    run = graphs.LoopGraphs.run

    def spy(self, name, program, capture=True):
        if name == 'denoise':
            seen['events'].append(torch.cuda.Event(enable_timing=True))
            seen['events'][-1].record()
        had = name in self.graphs
        out = run(self, name, program, capture)
        if not had and name in self.graphs:
            seen['graphs'].append((name, self.graphs[name].info()))
        return out

    graphs.LoopGraphs.run = spy
    try:
        yield seen
    finally:
        graphs.LoopGraphs.run = run


def loop_mode(dev, graphed, fn):
    """``fn()`` graphed, or with ``graphed`` False inside
    ``graphs.eager_loops()``, under :func:`loop_spy`, with the launch
    counters, the plain path's chunk count and the peak device memory set
    to 0 just before and read just after. Returns its output, seconds by
    the host clock, launches, plain chunks, peak bytes, the graphs it
    captured (count and infos) and the spy's events."""
    import torch
    from red_diffeq_tpu_torch.core import graphs
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stencil.reset_launches()
    acoustic.plain_chunk_calls['chunk'] = 0
    n = graphs.captures['n']
    mode = contextlib.nullcontext() if graphed else graphs.eager_loops()
    with loop_spy() as seen, mode:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
    return dict(out=out, s=s, launches=dict(stencil.launches),
                plain=acoustic.plain_chunk_calls['chunk'],
                peak=torch.cuda.max_memory_allocated() if cuda else 0,
                captures=graphs.captures['n'] - n, graphs=seen['graphs'],
                events=seen['events'])


def loop_pair(dev, label, fn, same, captures):
    """``fn`` graphed (its graphs captured), graphed again (replays
    alone) and eagerly: each run ``same`` as the eager one, ``captures``
    graphs made by the first run and none by the others. Returns the three
    runs' records (:func:`loop_mode`)."""
    first = loop_mode(dev, True, fn)
    again = loop_mode(dev, True, fn)
    eager = loop_mode(dev, False, fn)
    graphed = dev.type == 'cuda'
    for name, r in (('captured', first), ('replayed', again)):
        check(same(r['out'], eager['out']), f'{label}: the {name} run '
              'differs from the eager one')
    check((first['captures'], again['captures'], eager['captures'])
          == ((captures if graphed else 0), 0, 0), f'{label}: captures '
          f'{first["captures"]}, {again["captures"]}, {eager["captures"]}; '
          f'expected {captures if graphed else 0}, 0, 0')
    return first, again, eager


def graph_numbers(rec):
    """(capture s, pool MiB, launches a replay by program, each program's
    capture s and pool MiB) of the graphs a :func:`loop_mode` run
    captured."""
    return (sum(i['seconds'] for _, i in rec['graphs']),
            sum(i['pool_bytes'] for _, i in rec['graphs']) / 2**20,
            {name: i['launches'] for name, i in rec['graphs']},
            {name: (round(i['seconds'], 3), i['pool_bytes'] / 2**20)
             for name, i in rec['graphs']})


def loop_bench(dev, path, root, method, depth=(),
               preset='OpenFWI ablation preset', tag='', eager=None,
               phase='loop graphs'):
    """``red-diffeq-torch-bench`` with ``method`` on the preset config at
    ``path`` and the flags ``depth`` (its outer steps cut with
    ``--diffusion_ts``, ILVR's schedule; the Marmousi preset takes the
    patched denoise), graphed and eagerly (or, given the bench slice's
    eager run of the same flags as ``eager``, graphed against that): the
    eight ``.npz`` arrays bit for bit, exact launches in both
    (:func:`bench_launches`), the plain path unused; graphed, the denoise,
    the inner step, the metrics and each of ILVR's blend factors captured
    once, a replay of the inner step one gradient's launches, of the
    metrics one evaluation's, of the denoise and the blends none. Times
    ``DiffusionFWI.optimize`` (s/sample, the captures included) and the
    outer step (the denoise events' spacing; the U-Net calls' for the bench
    slice's run). Returns the numbers."""
    from red_diffeq_tpu_torch.bench_methods import diffusion_fwi
    from red_diffeq_tpu_torch.bench_methods.ilvr_fwi import (
        ilvr_down_schedule,
    )
    from red_diffeq_tpu_torch.cli import run_bench
    from red_diffeq_tpu_torch.config import load_config

    label = f'{phase}, {method}, {preset}'
    timed = diffusion_fwi.DiffusionFWI.optimize
    sample_s = []

    def optimize(self, *a, **kw):
        t0 = time.perf_counter()
        out = timed(self, *a, **kw)
        sample_s.append(time.perf_counter() - t0)
        return out

    runs = {}
    if eager is not None:
        check(eager['argv'] == list(depth), f'{label}: the eager run took '
              f'{eager["argv"]}, the graphed one {list(depth)}')
        runs['eager'] = eager
    diffusion_fwi.DiffusionFWI.optimize = optimize
    try:
        for mode in ('graph', 'eager')[:1 if eager is not None else 2]:
            out = root / f'loops_{tag}{method}_{mode}'
            argv = ['--config', str(path), '--method', method, *depth,
                    '--results_dir', str(out), '--device', str(dev)]
            runs[mode] = loop_mode(dev, mode == 'graph',
                                   lambda: run_bench.main(argv))
            runs[mode]['sample_s'] = sample_s[-1]
            events = runs[mode]['events']
            runs[mode]['outer_s'] = (step_period(events) if len(events) > 2
                                     else float('nan'))
    finally:
        diffusion_fwi.DiffusionFWI.optimize = timed
    cfg = load_config(runs['graph']['out'] / 'config.yaml')
    o = cfg.optimization
    grad, evaluation, want = bench_launches(cfg, label)
    programs = {'denoise', 'inner', 'metrics'}
    if method != 'diffusionfwi' and o.get('use_ilvr', True):
        down = ilvr_down_schedule(o.get('ilvr_down_schedule', 'linear'),
                                  o.diffusion_ts)
        programs |= {f'blend {int(down[t])}'
                     for t in range(1, o.diffusion_ts)}
    npz = {m: np.load(sorted(r['out'].glob('*/0_results.npz'))[0])
           for m, r in runs.items()}
    check(sorted(npz['graph'].files) == sorted(BENCH_NPZ_KEYS)
          and all(np.array_equal(npz['graph'][k], npz['eager'][k])
                  for k in BENCH_NPZ_KEYS), f'{label}: the graphed run\'s '
          '0_results.npz differs from the eager one\'s')
    g, e = runs['graph'], runs['eager']
    for mode, r in runs.items():
        check(r['launches'] == want and r['plain'] == 0, f'{label} '
              f'({mode}): launches {r["launches"]}, plain {r["plain"]}; '
              f'expected {want}')
    capture_s, pool, per_replay, each = graph_numbers(g)
    if dev.type == 'cuda':
        check(set(per_replay) == programs and e['captures'] == 0
              and g['captures'] == len(programs), f'{label}: captured '
              f'{sorted(per_replay)} ({g["captures"]}), expected '
              f'{sorted(programs)}; eager {e["captures"]}')
        check(per_replay['inner'] == grad
              and per_replay['metrics'] == evaluation
              and all(not v for k, v in per_replay.items()
                      if k not in ('inner', 'metrics')),
              f'{label}: launches a replay {per_replay}, expected inner '
              f'{grad}, metrics {evaluation}, none elsewhere')
    res = {m: dict(sample_s=r['sample_s'], wall_s=r['s'], peak=r['peak'],
                   outer_s=r['outer_s']) for m, r in runs.items()}
    res.update(capture_s=capture_s, pool_mib=pool, per_replay=per_replay,
               each=each, launches=g['launches'], dts=o.diffusion_ts,
               ts=o.ts, captures=g['captures'])
    print(f'{label} ({o.diffusion_ts} x {o.ts} steps): graphed = eager bit '
          f'for bit (the model and every curve); s per outer step '
          f'{res["graph"]["outer_s"]:.4f} graphed against '
          f'{res["eager"]["outer_s"]:.4f} eager (outer steps 1 to '
          f'{o.diffusion_ts - 1}); s/sample '
          f'{res["graph"]["sample_s"]:.3f} against '
          f'{res["eager"]["sample_s"]:.3f} ({g["captures"]} captures, '
          f'{capture_s:.3f} s, pool {pool:.1f} MiB); peak allocated '
          f'{g["peak"] / 2**20:.1f} MiB graphed, {e["peak"] / 2**20:.1f} '
          f'eager; a replay launches {per_replay}; capture s and pool MiB '
          f'by graph {each}', flush=True)
    return res


def loop_bench_trace(dev, path, root):
    """A graphed DiffusionFWI run of LOOP_TRACE outer x inner steps on the
    preset at ``path`` (its graphs captured by an untraced run first),
    traced with ``utils/profiling.trace``: the trace's solver kernels by
    name equal the counters; the device window's idle share and its ms an
    outer step."""
    import re
    import torch
    from red_diffeq_tpu_torch.bench_methods import DiffusionFWI
    from red_diffeq_tpu_torch.cli.run_inversion import (
        build_diffusion_model, build_forward_operator,
    )
    from red_diffeq_tpu_torch.config import load_config
    from red_diffeq_tpu_torch.utils.data_trans import prepare_initial_model
    from red_diffeq_tpu_torch.utils.profiling import trace

    cfg = load_config(path)
    o = cfg.optimization
    diffusion = build_diffusion_model(cfg, device=dev)
    op = build_forward_operator(cfg, device=dev)
    v_true = np.load(f'{cfg.data.velocity_data_dir}/synthetic.npy')[:1]
    y = np.load(f'{cfg.data.seismic_data_dir}/synthetic.npy')[:1]
    mu0 = prepare_initial_model(v_true, o.initial_type, sigma=o.sigma)
    method = DiffusionFWI(diffusion, op, device=dev)
    dts, ts = LOOP_TRACE

    def run():
        return method.optimize(
            mu0, v_true, y, op, ts=ts, diffusion_ts=dts, lr=o.lr,
            grad_norm=o.grad_norm, grad_smooth=o.grad_smooth,
            model_blur=o.model_blur, grad_clip=o.grad_clip,
            generator=torch.Generator(device=dev).manual_seed(0),
            progress=False)

    loop_mode(dev, True, run)
    traced = loop_mode(dev, True, lambda: _traced(run, root / 'loop_trace',
                                                   trace, dev))
    check(traced['captures'] == 0, 'the traced run captured')
    files = sorted((root / 'loop_trace').glob('*.pt.trace.json'))
    check(len(files) == 1, f'loop trace: {files}')
    events = json.loads(files[0].read_text())['traceEvents']
    device = [e for e in events if e.get('ph') == 'X'
              and e.get('cat') in DEVICE_CATS]
    kernels = dict.fromkeys(API_KERNELS, 0)
    for e in device:
        hit = [k for k in API_KERNELS if e['cat'] == 'kernel'
               and re.search(rf'\b{k}\b', e['name'])]
        if hit:
            kernels[hit[0]] += 1
    check(kernels == {k: traced['launches'][k] for k in API_KERNELS},
          f'loop trace: kernels {kernels}, counters {traced["launches"]}')
    busy, window = device_window(device)
    idle = 1.0 - busy / window
    print(f'loop graphs, traced DiffusionFWI ({dts} x {ts} steps, graphed): '
          f'kernels {kernels} (= the counters); the device window '
          f'{window / dts / 1e3:.3f} ms an outer step, busy '
          f'{busy / dts / 1e3:.3f}, idle {idle:.2%}', flush=True)
    return idle, window / dts / 1e3


def _traced(fn, log_dir, trace, dev):
    with trace(str(log_dir), dev):
        return fn()


def loop_samplers(dev, path):
    """DDIM (SAMPLER_STEPS steps, batch SAMPLER_BATCH) of the preset's
    diffusion, with and without ``return_all_timesteps``; the ancestral
    chain on a LOOP_ANCESTRAL_T-step schedule of the same U-Net,
    ``interpolate`` from LOOP_INTERP_T on it; RED's post-process chain from
    LOOP_POST_TS: each graphed (captured, then replayed) against its body
    run eagerly, bit for bit, one capture each, finite and in range.
    Returns {loop: numbers}."""
    import torch
    from red_diffeq_tpu_torch.cli.run_inversion import build_diffusion_model
    from red_diffeq_tpu_torch.config import load_config
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.regularization.red import (
        RED_DiffEq_POST_PROCESS,
    )

    cfg = load_config(path)
    cfg.diffusion.sampling_timesteps = SAMPLER_STEPS
    d = build_diffusion_model(cfg, device=dev)
    ancestral = GaussianDiffusion(
        d.model, image_size=d.image_size, timesteps=LOOP_ANCESTRAL_T,
        objective=d.objective, device=dev)
    shape = (SAMPLER_BATCH, d.channels, *d.image_size)
    rng = np.random.RandomState(5)
    x1, x2, mu = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(
        np.float32)).to(dev) for _ in range(3))
    post = RED_DiffEq_POST_PROCESS(d)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    loops = {
        'ddim': (SAMPLER_STEPS, lambda: d.sample(SAMPLER_BATCH,
                                                 generator=gen())),
        'ddim_trail': (SAMPLER_STEPS, lambda: d.sample(
            SAMPLER_BATCH, generator=gen(), return_all_timesteps=True)),
        'ancestral': (LOOP_ANCESTRAL_T, lambda: ancestral.sample(
            SAMPLER_BATCH, generator=gen())),
        'interpolate': (LOOP_INTERP_T, lambda: ancestral.interpolate(
            x1, x2, generator=gen(), t=LOOP_INTERP_T)),
        'post_process': (LOOP_POST_TS, lambda: post.diffusion_denoise(
            mu, LOOP_POST_TS, generator=gen())),
    }
    res = {}
    for name, (steps, fn) in loops.items():
        first, again, eager = loop_pair(dev, f'loop graphs, {name}', fn,
                                        torch.equal, 1)
        out = again['out']
        check(bool(torch.isfinite(out).all()), f'{name}: not finite')
        if name == 'ddim':
            lo, hi = float(out.min()), float(out.max())
            check(lo >= 0.0 and hi <= 1.0, f'{name}: [{lo}, {hi}]')
        if name == 'ddim_trail':
            check(tuple(out.shape) == (SAMPLER_BATCH, SAMPLER_STEPS + 1,
                                       *shape[1:])
                  and torch.equal(out[:, -1], res['ddim']['out']),
                  f'ddim trail of shape {tuple(out.shape)}, or its last '
                  'image is not the sample')
        capture_s, pool, per_replay, _ = graph_numbers(first)
        res[name] = dict(out=out, steps=steps, s=again['s'],
                         s_eager=eager['s'], s_first=first['s'],
                         capture_s=capture_s, pool_mib=pool,
                         per_replay=per_replay, peak=again['peak'],
                         peak_eager=eager['peak'])
        print(f'loop graphs, {name} ({steps} steps, batch {SAMPLER_BATCH}): '
              f'graphed = eager bit for bit; {again["s"]:.3f} s '
              f'({again["s"] / steps * 1e3:.3f} ms a step) graphed against '
              f'{eager["s"]:.3f} s ({eager["s"] / steps * 1e3:.3f}) eager, '
              f'{first["s"]:.3f} s with the capture ({capture_s:.3f} s, pool '
              f'{pool:.1f} MiB, a replay launches {per_replay}); peak '
              f'allocated {again["peak"] / 2**20:.1f} MiB graphed, '
              f'{eager["peak"] / 2**20:.1f} eager', flush=True)
    for r in res.values():
        del r['out']
    return res


def loop_trainer(dev, root, data_dir, extra=(), tag='fp32', trainer_kw=None,
                 milestone=True, steps=None, phase='loop graphs'):
    """``red-diffeq-torch-train`` on the velocity models in ``data_dir`` at
    its defaults and ``extra`` (the ``Trainer`` it builds given
    ``trainer_kw`` too) for ``steps`` (default LOOP_TRAIN_STEPS) steps
    under deterministic cuDNN, graphed and eagerly, each then trained
    ``steps`` steps more (timed: a graphed call replays the kept graph),
    and with ``milestone`` milestone 1 (its samplers' graphs; with
    ``--calculate_fid`` the FID's chains at its batch sizes; the train
    step's graph released) and ``steps`` steps after it (the train step
    captured again): the losses, the weights, the milestone's samples and
    FID bit for bit; the captures exact. Returns the numbers, the eager
    run's losses and its results folder."""
    import functools
    import torch
    from red_diffeq_tpu_torch.cli import diffusion_train

    steps = steps or LOOP_TRAIN_STEPS
    data = ['--data_dir', str(data_dir), '--save_every', str(10 ** 6),
            *TRAIN_ARGS, *extra]
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark, diffusion_train.Trainer
    cudnn.deterministic, cudnn.benchmark = True, False
    if trainer_kw:
        diffusion_train.Trainer = functools.partial(saved[2], **trainer_kw)
    runs = {}
    try:
        for mode in ('graph', 'eager'):
            out = root / f'loops_train_{tag.replace(" ", "_")}_{mode}'
            graphed = mode == 'graph'
            first = loop_mode(dev, graphed, lambda: diffusion_train.main([
                *data, '--results_folder', str(out), '--train_num_steps',
                str(steps), '--device', dev.type]))
            tr = first['out']

            def more():
                tr.train_num_steps += steps
                tr.train(log_every=10 ** 6)

            second = loop_mode(dev, graphed, more)
            runs[mode] = dict(trainer=tr, first=first, second=second,
                              folder=out)
            if milestone:
                runs[mode]['milestone'] = loop_mode(
                    dev, graphed, lambda: tr._sample_and_save(1))
                runs[mode]['after'] = loop_mode(dev, graphed, more)
                fid = out / 'fid_scores.json'
                runs[mode].update(sample=np.load(out / 'sample-1.npy'),
                                  fid=(json.loads(fid.read_text())
                                       if fid.exists() else None))
    finally:
        (cudnn.deterministic, cudnn.benchmark,
         diffusion_train.Trainer) = saved
    g, e = runs['graph'], runs['eager']
    label = f'{phase}, trainer ({tag})'
    calls = ('first', 'second', 'milestone', 'after')[:4 if milestone else 2]
    n_steps = (3 if milestone else 2) * steps
    lg = [x['loss'] for x in g['trainer'].training_losses]
    le = [x['loss'] for x in e['trainer'].training_losses]
    check(len(lg) == n_steps and lg == le and all(
        torch.equal(a, b) for a, b in zip(g['trainer'].params,
                                          e['trainer'].params)),
          f'{label}: {len(lg)} losses; graphed and eager differ (max rel '
          f'{max(abs(a - b) / abs(b) for a, b in zip(lg, le)):.3e})')
    tr = g['trainer']
    kw = trainer_kw or {}
    check(tr.amp == ('--amp' in extra)
          and tr.calculate_fid == ('--calculate_fid' in extra)
          and tr.grad_accum == kw.get('gradient_accumulate_every', 1)
          and tr._device_data == kw.get('device_data', True),
          f'{label}: amp {tr.amp}, FID {tr.calculate_fid}, accumulation '
          f'{tr.grad_accum}, data on the device {tr._device_data}')
    sizes, chains = [], 0
    if milestone:
        check(np.array_equal(g['sample'], e['sample'])
              and g['fid'] == e['fid'], f'{label}: the graphed milestone\'s '
              f'samples or FID ({g["fid"]}) differ from the eager one\'s '
              f'({e["fid"]})')
        check((g['fid'] is not None) == tr.calculate_fid,
              f'{label}: FID {g["fid"]}')
        # The milestone's chains by batch: the grid, then the FID's; the
        # bundle keeps one DDIM graph, so each change of batch captures.
        sizes, done = [tr.num_samples], 0
        while tr.calculate_fid and done < tr.num_fid_samples:
            sizes.append(min(tr.batch_size, tr.num_fid_samples - done))
            done += sizes[-1]
        chains = 1 + sum(a != b for a, b in zip(sizes, sizes[1:]))
    want = ((1, 0, chains, 1)[:len(calls)] if dev.type == 'cuda'
            else (0,) * len(calls))
    got = tuple(g[k]['captures'] for k in calls)
    eager = tuple(e[k]['captures'] for k in calls)
    check(got == want and eager == (0,) * len(calls), f'{label}: captures '
          f'{got}, eager {eager}; expected {want} (milestone chains by batch '
          f'{sizes})')
    batch = tr.batch_size
    s_graph = g['second']['s'] / steps
    s_eager = e['second']['s'] / steps
    capture_s, pool, _, _ = graph_numbers(g['first'])
    res = dict(s_graph=s_graph, s_eager=s_eager,
               images_graph=batch / s_graph, images_eager=batch / s_eager,
               capture_s=capture_s, pool_mib=pool, peak=g['second']['peak'],
               peak_eager=e['second']['peak'], eager_folder=e['folder'],
               losses=le)
    text = ''
    if milestone:
        res.update(milestone_graph=g['milestone']['s'],
                   milestone_eager=e['milestone']['s'],
                   milestone_peak=g['milestone']['peak'],
                   milestone_peak_eager=e['milestone']['peak'])
        text = (f'; a milestone (DDIM chains of batch {sizes}, save) '
                f'{res["milestone_graph"]:.2f} s graphed against '
                f'{res["milestone_eager"]:.2f} s eager, peak '
                f'{res["milestone_peak"] / 2**20:.1f} MiB graphed, '
                f'{res["milestone_peak_eager"] / 2**20:.1f} eager')
    print(f'{label} ({n_steps} steps, batch {batch} x {tr.grad_accum} '
          f'micro-batches, data on the device {tr._device_data}, '
          'deterministic cuDNN): graphed = eager bit for bit (losses, '
          'weights' + (', the milestone\'s samples' if milestone else '')
          + (' and FID' if tr.calculate_fid else '') + f'); {s_graph:.4f} s '
          f'per train step graphed ({batch / s_graph:.1f} images/s) against '
          f'{s_eager:.4f} ({batch / s_eager:.1f}) eager, the kept graph\'s '
          f'call of {steps} steps; capture {capture_s:.3f} s, pool '
          f'{pool:.1f} MiB; peak allocated {res["peak"] / 2**20:.1f} MiB '
          f'graphed, {res["peak_eager"] / 2**20:.1f} eager{text}; captures '
          f'{got}', flush=True)
    return res


def phase_loops(dev, root, bench, train_data):
    """The loop-graphs slice (see LOOP_* above) on the bench slice's
    presets, each DiffusionFWI and ILVR-FWI run graphed against the bench
    slice's eager run of it (``bench``: :func:`phase_bench`'s summary), and
    the amp trainer on the training slice's velocity models
    (``train_data``). Returns the numbers and the graphed DiffusionFWI
    run's launches."""
    from pathlib import Path

    root = Path(root)
    paths, runs = bench['paths'], bench['runs']
    out = {m: loop_bench(dev, paths[BENCH_PRESET], root, m,
                         runs[m]['eager']['argv'], eager=runs[m]['eager'])
           for m in BENCH_METHODS}
    for m in BENCH_METHODS:
        eager = runs[f'{m} wide']['eager']
        out[f'{m} wide'] = loop_bench(
            dev, paths[BENCH_WIDE_PRESET], root, m, eager['argv'],
            f'Marmousi ablation preset (patched, diffusion_ts cut to '
            f'{BENCH_WIDE_DIFFUSION_TS})', 'wide_', eager)
    out['idle'], out['window_ms'] = loop_bench_trace(
        dev, paths[BENCH_PRESET], root)
    out['samplers'] = loop_samplers(dev, paths[BENCH_PRESET])
    out['trainer amp'] = loop_trainer(dev, root, train_data,
                                      ['--amp', '--calculate_fid'],
                                      'amp, FID')
    return out


# The configurations phase: configurations a user runs that only the CPU
# tests had run graphed, each graphed against eager in one call, bit for
# bit. The headline (the slice's problem, the shipped prior) at each batch
# of CONFIG_BATCHES for CONFIG_TS steps (scan_pair; a replay launches one
# step's kernels whatever the batch); the bench CLI on each (preset family,
# flag set, method, outer steps, further flags) of CONFIG_BENCH (loop_bench:
# the other flag sets' inner bodies, the ts=1 depth, whose every inner
# replay starts Adam anew, and ILVR's stepwise schedule at enough outer
# steps that each of its four factors blends twice); the train CLI with each
# Trainer keyword set of CONFIG_TRAIN for CONFIG_TRAIN_STEPS steps twice
# (loop_trainer, no milestone); and the refined TV and RED-DiffEq rows of
# the Marmousi-width quality table (tools/torch_eval_quality.py --n 2
# --width 190 --sigma 20), each within QUALITY_GAP SSIM of the JAX table's
# row (QUALITY_marmousi.md), RED above TV.
CONFIG_BATCHES, CONFIG_TS = (8, 16), 10
CONFIG_BENCH = (
    ('OpenFWI', 'no_tricks_dt30_ts10', 'diffusionfwi', 4, ()),
    ('OpenFWI', 'grad_norm_dt30_ts10', 'diffusionfwi', 4, ()),
    ('OpenFWI', 'grad_smooth_dt30_ts10', 'diffusionfwi', 4, ()),
    ('OpenFWI', 'model_blur_dt30_ts10', 'diffusionfwi', 4, ()),
    ('OpenFWI', 'all_tricks_dt300_ts1', 'diffusionfwi', 6, ()),
    ('OpenFWI', 'all_tricks_dt30_ts10', 'ilvr', 12,
     ('--ilvr_down_schedule', 'stepwise')),
    ('Marmousi', 'grad_norm_dt30_ts10', 'diffusionfwi', 4, ()),
)
CONFIG_TRAIN = (('accumulate 2', dict(gradient_accumulate_every=2)),
                ('host batches', dict(device_data=False)))
CONFIG_TRAIN_STEPS = 10
CONFIG_QUALITY = dict(n=2, width=190, sigma=20.0, ts=300)
CONFIG_QUALITY_SSIM = {'tv': 0.6390, 'diffusion': 0.7126}


def config_preset(c):
    """The preset file of a CONFIG_BENCH entry."""
    return f'configs/ablation/{c[0]}_Ablation/ablation_{c[1]}.yaml'


def config_headline(dev, diffusion):
    """RED-DiffEq at the headline for each batch of CONFIG_BATCHES,
    graphed against eager (:func:`scan_pair`), a replay launching one
    step's kernels; s/sample of a QUALITY_TS-step run. Returns {batch:
    numbers}."""
    from red_diffeq_tpu_torch.core.inversion import InversionEngine
    from red_diffeq_tpu_torch.solvers import acoustic
    from red_diffeq_tpu_torch.utils.data_trans import (
        s_normalize_none, v_denormalize,
    )

    hp = HEADLINE['n_grid'] + 2 * HEADLINE['nbc']
    want = {k: n for k, n in route_launches(1, HEADLINE['nt'], hp,
                                            hp).items() if n}
    op = acoustic.FWIForward(HEADLINE, v_denorm_func=v_denormalize,
                             s_norm_func=s_normalize_none, chunk=CHUNK,
                             device=dev)
    out = {}
    for b in CONFIG_BATCHES:
        problem = slice_problem(dev, HEADLINE, batch=b)
        engine = InversionEngine(diffusion, regularization='diffusion',
                                 sigma_x0=1e-4, device=dev)
        r, _ = scan_pair(f'configurations, headline at B={b}',
                         scan_runner(dev, engine, op, problem, CONFIG_TS),
                         engine, CONFIG_TS, want)
        r['s_sample'] = QUALITY_TS * r['s_graph'] / b
        r['s_sample_eager'] = QUALITY_TS * r['s_eager'] / b
        out[b] = r
        print(f'configurations, headline at B={b}: {r["s_graph"]:.4f} s/step '
              f'graphed ({r["s_sample"]:.4f} s/sample for {QUALITY_TS} '
              f'steps) against {r["s_eager"]:.4f} eager '
              f'({r["s_sample_eager"]:.4f}); capture {r["capture_s"]:.3f} s, '
              f'pool {r["pool_bytes"] / 2**20:.1f} MiB, peak allocated '
              f'{r["peak_graph"] / 2**20:.1f} MiB replaying, '
              f'{r["peak_eager"] / 2**20:.1f} eager', flush=True)
        engine.release_graphs()
        del engine, problem
    return out


def config_quality(dev):
    """The refined TV and RED-DiffEq rows of the Marmousi-width quality
    table (CONFIG_QUALITY's problem from ``held_out_problem``, the eval
    tool's lambdas and draws, graphed): finite, each SSIM within
    QUALITY_GAP of CONFIG_QUALITY_SSIM, ordered as QUALITY_ORDER. Returns
    {reg: MAE, RMSE, SSIM, s/sample}."""
    from red_diffeq_tpu_torch.core.inversion import InversionEngine

    tools = quality_tools()
    Q, lambdas = tools['quality'], tools['eval_quality'].LAMBDAS
    c = CONFIG_QUALITY
    prob = Q.held_out_problem(dev, n=c['n'], width=c['width'],
                              sigma=c['sigma'], obs=('refined',),
                              ckpt=QUALITY_CKPT)
    y = prob.observations['refined']
    rows = {}
    for reg in QUALITY_REGS:
        engine = InversionEngine(prob.diffusion, regularization=reg,
                                 sigma_x0=1e-4, device=dev)
        Q.sync(dev)
        t0 = time.perf_counter()
        _, per_model = engine.optimize(
            prob.mu0, prob.v_true_t, y, prob.op, ts=c['ts'], lr=0.03,
            reg_lambda=lambdas[reg], regularization=reg, use_scan=True,
            progress=False, generator=Q.draws(dev))
        Q.sync(dev)
        seconds = time.perf_counter() - t0
        engine.release_graphs()
        rows[reg] = dict(Q.final_metrics(per_model),
                         s_sample=seconds / c['n'])
        r = rows[reg]
        check(all(np.isfinite(v) for v in r.values()), f'configurations, '
              f'Marmousi-width quality, refined {reg}: {r}')
        gap = r['SSIM'] - CONFIG_QUALITY_SSIM[reg]
        print(f'configurations, Marmousi-width quality (n={c["n"]}, '
              f'70x{c["width"]}, sigma {c["sigma"]}, {c["ts"]} steps), '
              f'refined {reg}: MAE {r["MAE"]:.4f}  RMSE {r["RMSE"]:.4f}  '
              f'SSIM {r["SSIM"]:.4f} (QUALITY_marmousi.md '
              f'{CONFIG_QUALITY_SSIM[reg]:.4f}, gap {gap:+.4f})  '
              f'{r["s_sample"]:.4f} s/sample (the capture included)',
              flush=True)
        check(abs(gap) <= QUALITY_GAP, f'Marmousi-width refined {reg}: SSIM '
              f'{r["SSIM"]:.4f}, more than {QUALITY_GAP} from the JAX '
              f'table\'s {CONFIG_QUALITY_SSIM[reg]:.4f}')
    for hi, lo in QUALITY_ORDER:
        check(rows[hi]['SSIM'] > rows[lo]['SSIM'], f'Marmousi-width refined '
              f'{hi} SSIM {rows[hi]["SSIM"]:.4f} is not above {lo}\'s '
              f'{rows[lo]["SSIM"]:.4f}')
    return rows


def phase_configs(dev, root, paths, train_data):
    """The configurations phase (see CONFIG_* above) on the bench slice's
    presets (``paths``) and the training slice's velocity models
    (``train_data``). Returns the numbers by run."""
    from pathlib import Path

    root = Path(root)
    diffusion = load_prior(dev)
    out = {'headline': config_headline(dev, diffusion)}
    del diffusion
    out['bench'] = {}
    for i, c in enumerate(CONFIG_BENCH):
        family, flags, method, dts, extra = c
        out['bench'][f'{family} {flags} {method} {" ".join(extra)}'.strip()] \
            = loop_bench(dev, paths[config_preset(c)], root, method,
                         ['--diffusion_ts', str(dts), *extra],
                         f'{family} ablation preset {flags} (diffusion_ts '
                         f'cut to {dts}{"; " if extra else ""}'
                         f'{" ".join(extra)})', f'config{i}_',
                         phase='configurations')
    out['trainer'] = {
        tag: loop_trainer(dev, root, train_data, tag=tag, trainer_kw=kw,
                          milestone=False, steps=CONFIG_TRAIN_STEPS,
                          phase='configurations')
        for tag, kw in CONFIG_TRAIN}
    out['quality'] = config_quality(dev)
    return out


RED_PARITY_REFERENCE = 'tests/data/red_parity_reference.npz'
RED_PARITY_TOOL = 'tools/torch_red_parity.py'


def phase_red_parity(dev):
    """The red parity phase (see 22. above). Returns the launches, the
    first and last step's gaps and the final metrics of both packages."""
    from red_diffeq_tpu_torch.ops import stencil
    from red_diffeq_tpu_torch.solvers import acoustic

    tool = _load_file('torch_red_parity', RED_PARITY_TOOL)
    ref = tool.load_reference(RED_PARITY_REFERENCE)
    meta = ref['meta']
    ctx = meta['ctx']
    hp = ctx['n_grid'] + 2 * ctx['nbc']
    stencil.reset_launches()
    acoustic.plain_chunk_calls['chunk'] = 0
    res = tool.run_trajectory(ref, dev, backend='kernel')
    counts = dict(stencil.launches)
    plain = acoustic.plain_chunk_calls['chunk']
    cmp = tool.compare(ref, res)
    tool.report(ref, res, cmp)
    check(res['backend'] == 'kernel', f'red parity ran {res["backend"]}')
    want = route_launches(meta['ts'], ctx['nt'], hp, hp)
    check(counts == want, f'red parity: launches {counts}, expected {want}')
    check(plain == 0, f'red parity: the plain path ran {plain} chunks')
    check(cmp['first_mu'] is None, 'red parity: mu leaves its allowance at '
          f'(step, cell) {cmp["first_mu"]}')
    check(cmp['first_curve'] is None, 'red parity: a loss or metric leaves '
          f'its allowance at (step, name) {cmp["first_curve"]}')
    return dict(counts=counts, steps=cmp['steps'], final=cmp['final'],
                seconds=res['seconds'], ts=meta['ts'])


def main(argv=None):
    """Run every phase (no arguments), or with ``--write-wide-dataset DIR``
    or ``--write-bench-dataset DIR`` only write that slice's dataset and
    configs under DIR."""
    import argparse
    from pathlib import Path
    import torch
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument('--write-wide-dataset', metavar='DIR',
                      help='write the wide slice\'s synthetic dataset and '
                           'preset configs under DIR, and stop')
    args.add_argument('--write-bench-dataset', metavar='DIR',
                      help='write the bench slice\'s synthetic datasets and '
                           'ablation preset configs under DIR, and stop')
    args = args.parse_args(argv or [])
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    try:
        import red_diffeq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}',
              file=sys.stderr)
        return 1
    from red_diffeq_tpu_torch.ops import stencil

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    for root, write in ((args.write_wide_dataset, write_wide_dataset),
                        (args.write_bench_dataset, write_bench_dataset)):
        if root:
            for preset, path in write(dev, root).items():
                print(f'{preset}: {path}')
            return 0
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}', flush=True)

    with Phase('card'):
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    with Phase('build'):
        from concurrent.futures import ThreadPoolExecutor
        from red_diffeq_tpu_torch.ops import layout_probe
        with ThreadPoolExecutor(2) as pool:
            libs = list(pool.map(
                lambda src: stencil.build(verbose=True, source=src),
                (stencil._CSRC, layout_probe._CSRC)))
        for lib in libs:
            print(f'built {lib}', flush=True)
        hp = HEADLINE['n_grid'] + 2 * HEADLINE['nbc']
        hn = NARROW['n_grid'] + 2 * NARROW['nbc']
        hb = BEYOND['n_grid'] + 2 * BEYOND['nbc']
        tape_info, stream_info = phase_kernel_info(
            ((hp, hp), (hn, hn)), ((hb, hb), *STREAM_INFO_SHAPES))
    with Phase('forward kernel'):
        p = headline_problem(dev)
        fwd, carries, seis = phase_forward(p)
        grad_problem = gradient_problem(p['v_true'],
                                        seis[:, :, :HEADLINE['nt']])
        pn = headline_problem(dev, NARROW)
        fwd_narrow, carries_n, seis_n = phase_forward(
            pn, f'nbc={NARROW["nbc"]}', full=False)
        narrow_grad_problem = gradient_problem(pn['v_true'],
                                               seis_n[:, :, :NARROW['nt']])
        del seis_n
    with Phase('adjoint kernel'):
        bwd = phase_adjoint(p, carries, grad_problem)
    with Phase('determinism'):
        phase_determinism(((HEADLINE, *grad_problem),
                           (NARROW, *narrow_grad_problem)))
        del narrow_grad_problem
    with Phase('tape kernels'):
        tape = phase_tape(p, carries, grad_problem, pn, carries_n)
        del carries, pn, carries_n
    with Phase('small inversion vs CPU'):
        phase_small_reference(dev)
    with Phase('slice'):
        diffusion = load_prior(dev)
        problem = slice_problem(dev, HEADLINE)
        counts, s_per_step, unrolls = phase_slice(dev, diffusion, HEADLINE,
                                                  problem, 'reverse')
        _, s_tape_forced, _ = phase_slice(dev, diffusion, HEADLINE, problem,
                                          'tape', adjoint='tape')
        del problem
    with Phase('narrow-sponge slice'):
        narrow_counts, s_narrow, narrow_unrolls, narrow_grad = phase_narrow(
            dev, diffusion)
    del diffusion
    with Phase('wide slice'):
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            wide_counts, s_wide, wide_unrolls, wide_ctx = phase_wide(dev,
                                                                     root)
    with Phase('wide kernels'):
        wide = wide_kernels(dev, wide_ctx)
    # The bench slice's datasets, presets and eager runs stay for the loop
    # graphs and the configurations.
    bench_root = tempfile.TemporaryDirectory()
    with Phase('bench slice'):
        bench_counts, bench = phase_bench(dev, bench_root.name)
    with Phase('tape past the cluster limit'):
        beyond = phase_beyond(dev)
    # The training slice's milestones stay for the quality slice, its
    # velocity models for the loop graphs and the configurations.
    train_root = tempfile.TemporaryDirectory()
    train_data = Path(train_root.name) / 'train' / 'Velocity_Data'
    with Phase('training slice'):
        training = phase_training(dev, train_root.name)
    with Phase('layout probe'):
        probe = phase_layout_probe(dev)
    with Phase('api slice'):
        with tempfile.TemporaryDirectory() as root:
            phase_api(dev, root, training)
    with Phase('quality slice'):
        with tempfile.TemporaryDirectory() as root:
            quality = phase_quality(dev, root, training)
    with Phase('mesh slice'):
        with tempfile.TemporaryDirectory() as root:
            mesh = phase_mesh(dev, root)
    with Phase('scan slice'):
        with tempfile.TemporaryDirectory() as root:
            scan = phase_scan(dev, root)
    with Phase('loop graphs'):
        with tempfile.TemporaryDirectory() as root:
            loops = phase_loops(dev, root, bench, train_data)
    with Phase('configurations'):
        with tempfile.TemporaryDirectory() as root:
            configs = phase_configs(dev, root, bench['paths'], train_data)
    with Phase('red parity'):
        red_parity = phase_red_parity(dev)
    bench_root.cleanup()
    train_root.cleanup()

    n_chunks = len(p['src'])
    steps = n_chunks * CHUNK
    bnd = bounds(p, steps, n_chunks)
    kernels = []
    # Each kernel's launches, and the steps per launch its wrapper handed
    # the launcher, come from the slice that takes its route (sum_shots:
    # the headline's); one inversion step is one pass of each of that
    # route's kernels.
    for name, res, line, launched, unroll in (
            ('fwd_step', fwd, 150, counts, unrolls),
            ('bwd_reverse_step', bwd, 352, counts, unrolls),
            ('sum_shots', bwd['sum_shots'], 435, counts, unrolls),
            ('tape_step', tape['tape_step'], 233, narrow_counts,
             narrow_unrolls),
            ('bwd_tape_step', tape['bwd_tape_step'], 271, narrow_counts,
             narrow_unrolls)):
        check(launched[name] % TS == 0, f'{name}: {launched[name]} launches '
              f'in {TS} inversion steps')
        kernels.append(dict(
            name=name, route='cuda', source=SOURCE,
            replaces=f'red_diffeq_tpu/ops/stencil.py:{line}',
            launches=launched[name], max_abs_err=res['max_abs_err'],
            ms=res['ms'], plain_ms=res['plain_ms'],
            bound_ms=bnd[name]['bound_ms'], bound_by=bnd[name]['bound_by'],
            library_ms=res.get('library_ms'),
            **({'ranks': unroll[name]} if name == 'tape_step'
               else {'unroll': unroll[name]}),
            launches_per_pass=launched[name] // TS))
    # sum_shots runs on both routes: its launches on the taped one too, and
    # its times per call with the host's launch beside its device time.
    kernels[2].update(
        launches_taped_route=narrow_counts['sum_shots'],
        ms_per_call_with_host=bwd['sum_shots']['ms_per_call_with_host'],
        library_ms_per_call_with_host=bwd['sum_shots'][
            'library_ms_per_call_with_host'])
    # tape_step at nbc=40, its own route, and its registers and resident
    # clusters at the headline.
    # Each kernel at the wide preset's field, with its launches in the
    # wide slice's CLI run (the tape-free route).
    for k in kernels:
        w = wide[k['name']]
        k['wide'] = dict(shape=w['shape'], launches=wide_counts[k['name']],
                         unroll=wide_unrolls[k['name']],
                         max_abs_err=w['max_abs_err'], ms=w['ms'],
                         plain_ms=w['plain_ms'], bound_ms=w['bound_ms'],
                         bound_by=w['bound_by'],
                         library_ms=w.get('library_ms'))
    # Each kernel's launches in the bench slice's DiffusionFWI run of the
    # OpenFWI ablation preset, and in the training slice's seismogram run
    # of red-diffeq-torch-datagen.
    for k in kernels:
        k['bench'] = dict(launches=bench_counts[k['name']])
        k['training'] = dict(launches=training['counts'][k['name']])
        k['quality'] = dict(launches=quality['counts'][k['name']])
        k['mesh'] = dict(
            launches=mesh['headline']['counts'][k['name']],
            shards=MESH['data'] * MESH['shot'],
            launches_taped=mesh['narrow']['counts'][k['name']],
            shards_taped=MESH_NARROW['data'] * MESH_NARROW['shot'])
        # The scan slice's replayed headline run (its route's kernels) and
        # nbc=40 run (the taped route's), and one replay's launches.
        k['scan'] = dict(
            launches=scan['reverse']['launches'][k['name']],
            launches_per_replay=scan['reverse']['per_replay'].get(
                k['name'], 0),
            launches_taped=scan['narrow']['launches'][k['name']],
            launches_per_replay_taped=scan['narrow']['per_replay'].get(
                k['name'], 0))
        # The loop-graphs slice's graphed DiffusionFWI run of the OpenFWI
        # ablation preset, and a replay of its inner step and its metrics.
        d = loops['diffusionfwi']
        k['loops'] = dict(
            launches=d['launches'][k['name']],
            launches_per_replay={p: d['per_replay'].get(p, {}).get(
                k['name'], 0) for p in ('inner', 'metrics')})
        # The configurations phase's graphed runs: the headline by batch,
        # the bench CLI runs, and a replay of the headline's step.
        k['configs'] = dict(
            headline={str(b): r['launches'][k['name']]
                      for b, r in configs['headline'].items()},
            launches_per_replay={str(b): r['per_replay'].get(k['name'], 0)
                                 for b, r in configs['headline'].items()},
            bench={n: r['launches'][k['name']]
                   for n, r in configs['bench'].items()})
        k['red_parity'] = dict(launches=red_parity['counts'][k['name']])
    # The tape replay past tape_step's cluster limit (420x420, B=1):
    # tape_step_stream's launches in the velocity gradient there, its
    # numbers from that phase, its registers, planes and resident clusters
    # from the build phase. tape_step_global's launches in the gradient past
    # tape_step_stream's limit (680x680, one chunk), its numbers at 420x420
    # (forced, the same pass), and at 680x680 under 'beyond'.
    st, gl, forced = (beyond['tape_step_stream'], beyond['tape_step_global'],
                      beyond['global_at_stream'])
    kernels.append(dict(
        name='tape_step_stream', route='cuda', source=SOURCE,
        replaces='red_diffeq_tpu/ops/stencil.py:233',
        launches=st['counts']['tape_step_stream'],
        max_abs_err=st['max_abs_err'], ms=st['ms'], graph_ms=st['graph_ms'],
        plain_ms=st['plain_ms'], bound_ms=st['bound_ms'],
        bound_by=st['bound_by'], library_ms=None, shape=list(st['shape']),
        nt=BEYOND['nt'], launches_per_pass=st['counts']['tape_step_stream'],
        ranks=st['ranks'], planes=stream_info['planes'],
        registers=stream_info['regs'],
        local_bytes=stream_info['local_bytes'],
        clusters=stream_info['clusters'],
        training=dict(launches=training['counts']['tape_step_stream']),
        quality=dict(launches=quality['counts']['tape_step_stream'])))
    kernels.append(dict(
        name='tape_step_global', route='cuda', source=SOURCE,
        replaces='red_diffeq_tpu/ops/stencil.py:233',
        launches=gl['counts']['tape_step_global'],
        max_abs_err=max(gl['max_abs_err'], forced['max_abs_err']),
        ms=forced['ms'], graph_ms=forced['graph_ms'],
        plain_ms=forced['plain_ms'], bound_ms=st['bound_ms'],
        bound_by=st['bound_by'], library_ms=None, shape=list(st['shape']),
        nt=BEYOND['nt'], route_at_shape='forced',
        launches_per_pass=gl['counts']['tape_step_global'],
        launches_at_stream_shape=st['counts']['tape_step_global'],
        beyond=dict(shape=list(gl['shape']), nt=BEYOND_STREAM['nt'],
                    max_abs_err=gl['max_abs_err'], ms=gl['ms'],
                    graph_ms=gl['graph_ms'], plain_ms=gl['plain_ms'],
                    bound_ms=gl['bound_ms'], bound_by=gl['bound_by']),
        training=dict(launches=training['counts']['tape_step_global']),
        quality=dict(launches=quality['counts']['tape_step_global'])))
    # The probe's kernels: launches in the probe tool's run, their numbers
    # from the phase, one bound for all (the same function); roll and halo
    # one launch a call, with their *_global kernels' times at the same
    # call; the *_global kernels with the launches and numbers of the
    # tool's run past the resident limit.
    from red_diffeq_tpu_torch.ops import layout_probe
    for v, r in probe['variants'].items():
        name = layout_probe.KERNELS[v]
        k = dict(
            name=name, route='cuda', source=PROBE_SOURCE,
            replaces=f'tools/kernel_layout_probe.py:{PROBE_LINES[v]}',
            launches=probe['counts'][name], max_abs_err=r['max_abs_err'],
            ms=r['ms'], graph_ms=r['graph_ms'], plain_ms=r['plain_ms'],
            bound_ms=probe['bound_ms'], bound_by=probe['bound_by'],
            library_ms=r['library_ms'], shape=probe['shape'],
            nt=probe['nt'], probe_route=probe['routes'][v],
            launches_per_call=1 if v in RESIDENT else probe['nt'],
            registers=r.get('regs'), local_bytes=r.get('local_bytes'),
            blocks_per_sm=r.get('blocks_per_sm'))
        for key in ('hmma_tf32', 'ranks', 'fields_per_cluster', 'clusters',
                    'chunk_ms', 'chunk_graph_ms', 'global_ms',
                    'global_graph_ms'):
            if key in r:
                k[key] = r[key]
        kernels.append(k)
    by = probe['beyond']
    for v, r in by['variants'].items():
        kernels.append(dict(
            name=layout_probe.GLOBAL_KERNELS[v], route='cuda',
            source=PROBE_SOURCE,
            replaces=f'tools/kernel_layout_probe.py:{PROBE_LINES[v]}',
            launches=by['counts'][layout_probe.GLOBAL_KERNELS[v]],
            max_abs_err=r['max_abs_err'], ms=r['ms'], graph_ms=r['graph_ms'],
            plain_ms=r['plain_ms'], bound_ms=by['bound_ms'],
            bound_by=by['bound_by'], library_ms=None, shape=by['shape'],
            nt=by['nt'], launches_per_call=by['nt'],
            registers=r.get('regs'), local_bytes=r.get('local_bytes'),
            blocks_per_sm=r.get('blocks_per_sm')))
    kernels[3].update(ms_nbc40=tape['tape_step']['ms_nbc40'],
                      plain_ms_nbc40=tape['tape_step']['plain_ms_nbc40'],
                      registers=tape_info['regs'],
                      clusters=tape_info['clusters'])
    print(f'fwd_step at nbc={NARROW["nbc"]} ({hn}x{hn}): '
          f'{fwd_narrow["ms"]:.3f} ms per pass, max abs err '
          f'{fwd_narrow["max_abs_err"]:.3e}', flush=True)
    print(f'slice: s per inversion step by the host clock [by the U-Net '
          f"calls' events]: {s_per_step['host']:.4f} "
          f"[{s_per_step['events']:.4f}] at the headline (adjoint 'reverse'; "
          f'one launch per step: {EARLIER_S_PER_STEP:.4f}), '
          f"{s_tape_forced['host']:.4f} [{s_tape_forced['events']:.4f}] with "
          f"'tape' forced, {s_narrow['host']:.4f} [{s_narrow['events']:.4f}] "
          f"at nbc={NARROW['nbc']} ('tape'); velocity "
          f'gradient max-rel {bwd["grad_max_rel"]:.3e} (kernels vs plain), '
          f'{tape["grad_max_rel"]:.3e} (tape vs reverse), {narrow_grad:.3e} '
          f'(tape kernels vs plain, nbc={NARROW["nbc"]})', flush=True)
    print(f'wide slice: {s_wide:.4f} s per inversion step (U-Net calls\' '
          'events); '
          f'velocity gradient max-rel {wide["grad_max_rel"]["plain"]:.3e} '
          f'(kernels vs plain), {wide["grad_max_rel"]["tape"]:.3e} (tape vs '
          'reverse)', flush=True)
    for method in BENCH_METHODS:
        r = bench['runs'][method]
        print(f'bench slice, {method} (OpenFWI ablation preset, {r["dts"]} x '
              f'{r["ts"]} steps, one sample): {r["s_per_outer_step"]:.4f} s '
              f'per outer step, {r["wall_s"]:.2f} s for the sample, SSIM '
              f'{r["ssim"][0]:.4f} -> {r["ssim"][1]:.4f}, the inner FWI '
              f'loops lowering the observation loss in '
              f'{sum(e < b for b, e in r["fwi"])} of {len(r["fwi"])} outer '
              'steps', flush=True)
    print(f'bench slice: DDIM sample {bench["sampler_s"]:.2f} s; kernels vs '
          f'plain max |d mu| {bench["kernels_vs_plain"][0]:.3e} '
          f'({bench["kernels_vs_plain"][1]:.2%} of the cells beyond 1e-4)',
          flush=True)
    print(f'tape past the cluster limit ({st["shape"]}, nt={BEYOND["nt"]}): '
          f'tape_step_stream {st["ms"]:.3f} ms per pass [{st["graph_ms"]:.3f} '
          f'as a CUDA graph], tape_step_global forced {forced["ms"]:.3f} '
          f'[{forced["graph_ms"]:.3f}] (bound {st["bound_ms"]:.3f} ms, plain '
          f'{st["plain_ms"]:.3f} ms), gradient max-rel '
          f'{st["grad_max_rel"]:.3e}; past tape_step_stream\'s limit '
          f'({gl["shape"]}, nt={BEYOND_STREAM["nt"]}): tape_step_global '
          f'{gl["ms"]:.3f} [{gl["graph_ms"]:.3f}] (bound {gl["bound_ms"]:.3f}'
          f' ms), gradient max-rel {gl["grad_max_rel"]:.3e}', flush=True)
    print(f'training slice: {training["s_per_step"]:.4f} s per train step, '
          f'{training["images_per_s"]:.1f} images/s (deterministic cuDNN '
          f'{training["s_per_step_deterministic"]:.4f} s), peak '
          f'{training["peak_mib"]:.1f} MiB; milestones '
          + ', '.join(f'{t:.2f}' for t in training['milestone_s'])
          + f' s; datagen {training["sim_s"]:.3f} s per simulated batch; '
          f'resume max rel diff {training["resume_max_rel"]:.3e}', flush=True)
    print(f'layout probe ({probe["shape"]}, nt={probe["nt"]}), ms a call '
          f'[as a CUDA graph] against the shared bound of '
          f'{probe["bound_ms"]:.3f} ms ({probe["bound_by"]}): '
          + ', '.join(f'{v} {r["ms"]:.3f} [{r["graph_ms"]:.3f}]'
                      for v, r in probe['variants'].items())
          + f'; roll and halo as {probe["nt"] // PROBE_CHUNK} calls of '
          f'{PROBE_CHUNK} steps: '
          + ', '.join(f'{v} {probe["variants"][v]["chunk_ms"]:.3f} '
                      f'[{probe["variants"][v]["chunk_graph_ms"]:.3f}]'
                      for v in RESIDENT)
          + '; their *_global kernels at the same call: '
          + ', '.join(f'{v} {probe["variants"][v]["global_ms"]:.3f} '
                      f'[{probe["variants"][v]["global_graph_ms"]:.3f}]'
                      for v in RESIDENT)
          + '; the products\' library ms: '
          + ', '.join(f'{v} {probe["variants"][v]["library_ms"]:.3f}'
                      for v in PRODUCTS), flush=True)
    print(f'quality slice (n={QUALITY_N}, {QUALITY_TS} steps, refined '
          'observations): '
          + ', '.join(f'{reg} SSIM {quality["rows"][f"refined/{reg}"]["SSIM"]:.4f}'
                      f' (QUALITY.md {QUALITY_SSIM[reg]:.4f}), '
                      f'{quality["s_per_sample"][reg]:.4f} s/sample'
                      for reg in QUALITY_REGS)
          + f'; the refined observations {quality["obs_s"]:.3f} s; warm-ups '
          + ', '.join(f'{s:.3f}' for s in quality['warm_s'])
          + f' s; the discarded first run {quality["first_s"]:.3f} s',
          flush=True)
    h, nw, cli, tr = (mesh[k] for k in ('headline', 'narrow', 'cli',
                                         'trainer'))
    print(f'mesh slice: headline over {MESH["data"]} x {MESH["shot"]} '
          f'{h["s_mesh"]:.4f} s/step (unsharded {h["s_one"]:.4f}), max |d mu| '
          f'{h["d"]:.3e}; taped over {MESH_NARROW["data"]} x '
          f'{MESH_NARROW["shot"]} {nw["s_mesh"]:.4f} (unsharded '
          f'{nw["s_one"]:.4f}); CLI max |d mu| {cli["d"]:.3e}, a batch read '
          f'{cli["read_ms"]:.3f} ms, its prefetch call {cli["prefetch_ms"]:.3f}'
          f' ms; trainer split {tr["s_split"]:.4f} s/step (one device '
          f'{tr["s_one"]:.4f}), losses rel {tr["rel"]:.3e}; U-Net fields '
          f'max-rel {mesh["unet_rel"]:.3e}; converter {mesh["convert_s"]:.2f}'
          ' s', flush=True)
    print('scan slice (graphed s/step against eager by the host clock, '
          'capture s, pool MiB): '
          + '; '.join(f'{label} {scan[k]["s_graph"]:.4f} against '
                      f'{scan[k]["s_eager"]:.4f}, {scan[k]["capture_s"]:.3f}'
                      f' s, {scan[k]["pool_bytes"] / 2**20:.1f} MiB'
                      for k, label in (('reverse', 'headline'),
                                       ('tape', "'tape' forced"),
                                       ('narrow', f'nbc={NARROW["nbc"]}'),
                                       ('bf16', 'bf16 U-Net'),
                                       ('mesh', 'mesh'),
                                       ('plain', 'plain backend')))
          + f'; a graphed headline step idles {scan["idle"]:.2%} of its '
          f'{scan["window_ms"]:.3f} ms device window (traced); '
          f'warm_compile then 3 runs on 1 capture: '
          f'{scan["cache"]["first_s"]:.4f} s/step the first, '
          f'{scan["cache"]["third_s"]:.4f} the third', flush=True)
    lt, ls = training['loop_trainer'], loops['samplers']
    print('loop graphs (graphed against eager in one call, bit for bit): '
          + '; '.join(f'{m} {loops[m]["graph"]["outer_s"]:.4f} s per outer '
                      f'step against {loops[m]["eager"]["outer_s"]:.4f}, '
                      f'{loops[m]["graph"]["sample_s"]:.3f} s/sample against '
                      f'{loops[m]["eager"]["sample_s"]:.3f}'
                      for m in BENCH_METHODS)
          + f'; a graphed outer step idles {loops["idle"]:.2%} of its '
          f'{loops["window_ms"]:.3f} ms device window (traced); '
          + '; '.join(f'{n} {r["s"]:.3f} s against {r["s_eager"]:.3f}'
                      for n, r in ls.items())
          + f'; train {lt["s_graph"]:.4f} s a step against '
          f'{lt["s_eager"]:.4f}, a milestone {lt["milestone_graph"]:.2f} s '
          f'against {lt["milestone_eager"]:.2f}', flush=True)
    ch, cb = configs['headline'], configs['bench']
    print('configurations (graphed against eager in one call, bit for bit): '
          + '; '.join(f'headline B={b} {r["s_graph"]:.4f} s/step against '
                      f'{r["s_eager"]:.4f}, {r["s_sample"]:.4f} s/sample, '
                      f'pool {r["pool_bytes"] / 2**20:.1f} MiB'
                      for b, r in ch.items())
          + '; ' + '; '.join(f'{n} {r["graph"]["outer_s"]:.4f} s per outer '
                             f'step against {r["eager"]["outer_s"]:.4f}'
                             for n, r in cb.items())
          + '; ' + '; '.join(f'train ({n}) {r["s_graph"]:.4f} s a step '
                             f'against {r["s_eager"]:.4f}'
                             for n, r in configs['trainer'].items())
          + '; Marmousi-width refined SSIM ' + ', '.join(
              f'{reg} {r["SSIM"]:.4f}' for reg, r in
              configs['quality'].items()), flush=True)
    first, last = red_parity['steps'][0], red_parity['steps'][-1]
    print(f'red parity ({red_parity["ts"]} graphed steps on the kernels, '
          f'{red_parity["seconds"]:.2f} s, on JAX\'s draws): max |d mu| '
          f'{first[1]:.3e} after step 1, {last[1]:.3e} ({last[3]:.3%} of the '
          'cells beyond 1e-4) after the last; final SSIM port '
          f'{red_parity["final"]["port"]["SSIM"]:.4f}, JAX '
          f'{red_parity["final"]["jax"]["SSIM"]:.4f}', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
