#!/usr/bin/env python3
"""Where the bf16 U-Net's time goes on the card, against fp32's.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_bf16_breakdown.py [--reps N]

The dim-64 (1, 2, 4, 8) U-Net of the shipped prior at 72x72, in three
forms: fp32 (cuDNN without TF32, as the port runs it), bf16 as
``GaussianDiffusion(half_precision=True)`` runs it (NCHW, the weights
swapped in by ``torch.func.functional_call``), and bf16 on a bf16 copy of
the module in channels-last layout. For each, with cuDNN's heuristics and
with ``cudnn.benchmark``:

* the denoiser's forward at the headline's batch 4 (one RED step's call):
  ms a call between CUDA events with the host's launches, and as a CUDA
  graph (device time alone);
* a train step's loss forward and backward at the train CLI's batch 32
  (fp32 master weights; bf16 through a differentiable cast, as the
  trainer's ``amp``): ms a step between CUDA events;
* the trainer's whole step at batch 32, fp32 and ``amp``: ms between the
  steps' CUDA events and the host's ms a step to queue them.

Prints the card's name and power limit last.
"""
import argparse
import copy
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    import torch
    import chip_smoke as C
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.utils.precision import fp32_convolutions

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    d32 = C.load_prior(dev)
    d16 = GaussianDiffusion(copy.deepcopy(d32.model), image_size=72,
                            timesteps=1000, half_precision=True, device=dev)
    cl = copy.deepcopy(d32.model).to(torch.bfloat16).to(
        memory_format=torch.channels_last).requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(b):
        x = torch.randn(b, 1, 72, 72, generator=g, device=dev)
        t = torch.randint(0, 1000, (b,), generator=g, device=dev)
        return x, t

    x4, t4 = inputs(4)
    forwards = {
        'fp32': lambda: d32.apply_fn(x4, t4),
        'bf16 (half_precision)': lambda: d16.apply_fn(x4, t4),
        'bf16 channels-last module': lambda: cl(
            x4.to(torch.bfloat16, memory_format=torch.channels_last),
            t4).float(),
    }
    x32, t32 = inputs(32)
    names = [n for n, _ in d32.model.named_parameters()]
    params = list(d32.model.parameters())
    cl_train = copy.deepcopy(d32.model).to(memory_format=torch.channels_last)
    cl_params = dict(cl_train.named_parameters())

    def train_step(kind):
        for p in (*params, *cl_params.values()):
            p.grad = None
        with fp32_convolutions():
            if kind == 'fp32':
                out = d32.model(x32, t32)
            elif kind == 'amp':
                out = d32.run_model(x32, t32, {n: p.to(torch.bfloat16)
                                               for n, p in zip(names,
                                                               params)})
            else:
                out = torch.func.functional_call(
                    cl_train, {n: p.to(torch.bfloat16)
                               for n, p in cl_params.items()},
                    (x32.to(torch.bfloat16,
                            memory_format=torch.channels_last), t32))
            ((out - x32) ** 2).mean().backward()

    cudnn = torch.backends.cudnn
    for bench in (False, True):
        cudnn.benchmark = bench
        label = 'cudnn.benchmark' if bench else 'cuDNN heuristics'
        with torch.no_grad():
            for name, fn in forwards.items():
                host = C.cuda_ms(fn, args.reps)
                graph = C.graph_ms(fn, args.reps)
                print(f'{label}: U-Net forward at batch 4, {name}: '
                      f'{host:.3f} ms a call with the host\'s launches, '
                      f'{graph:.3f} ms as a CUDA graph', flush=True)
        for kind in ('fp32', 'amp', 'amp channels-last'):
            ms = C.cuda_ms(lambda: train_step(kind), max(args.reps // 2, 3))
            print(f'{label}: train step loss forward and backward at batch '
                  f'32, {kind}: {ms:.3f} ms', flush=True)
    cudnn.benchmark = False
    # The trainer's whole step (the loss, clip, Adam, EMA, the batch
    # gathered on the card) at the CLI's batch, fp32 and amp: the spacing
    # of CUDA events recorded after each step against the host's time to
    # queue the steps, so that a step the host holds back shows.
    import tempfile
    import time
    import numpy as np
    from red_diffeq_tpu_torch.models.trainer import TensorDataset, Trainer
    data = TensorDataset(np.random.RandomState(0).rand(
        256, 1, 72, 72).astype(np.float32))
    for amp in (False, True):
        d = GaussianDiffusion(copy.deepcopy(d32.model), image_size=72,
                              timesteps=1000, device=dev)
        with tempfile.TemporaryDirectory() as folder:
            tr = Trainer(d, data, train_batch_size=32, amp=amp,
                         results_folder=folder)
        tr._data_dev = torch.from_numpy(data.data).to(dev)
        n = max(args.reps, 3)
        events = []
        for i in range(n + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            tr.train_step(tr._next_batches())
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        host = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        dev_ms = events[0].elapsed_time(events[-1]) / n
        print(f'trainer step at batch 32, {"amp" if amp else "fp32"}: '
              f'{dev_ms:.3f} ms between the steps\' events, the host '
              f'{host:.3f} ms a step to queue them', flush=True)
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
