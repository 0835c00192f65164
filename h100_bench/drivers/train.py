"""Driver ``train``: the prior's training through ``Trainer.train``.

Set-up makes the U-Net's weights and the training set (synthetic velocity
models as the training CLI prepares them: (v - 1500) / 3000, zero-padded to
the denoiser's grid, resident on the device) from the seed, builds the
trainer with the training CLI's settings, and drives that same trainer
through its first ``follow_steps`` steps in the window's own call: one
step (its Adam state gives the first gradient as the optimizer got it),
then two (the train step's CUDA graph is captured there), then the rest
to the EMA's first update (a copy of the weights at step 10). The window
continues the
same trainer in calls of ``steps_per_train`` steps (the CLI's calls of
``steps_per_call`` steps inside) and starts no call once ``--seconds``
have passed: images/s is the images trained over the window's seconds.
A traced run's window is ``trace_calls`` calls.

The output check: the reference follows those steps from the same
weights, rows and draws (worked out again from the seed) and compares
each step's loss, the first gradient's norm per parameter, the norm of
each parameter's change after three steps, and the norm of each EMA
parameter's change after the last, by the worst parameter. The EMA's
first blends come at step 110 and after, in the window, where no
reference can follow 300 steps of the program: once the window has
closed, the same trainer goes on through the window's call to its next
EMA update, and the EMA's change there is held against the reference's
blend (the warm-up decay of that step) of the program's own EMA and
parameters.
"""
import shutil
import tempfile
import time

import numpy as np
import torch

from h100_bench.lib import counts, faults, harness, inputs, tracing
from h100_bench.reference import diffusion as rdiff, training as rtrain
from h100_bench.reference.arith import Arith, fp32_math
from h100_bench.reference.unet import Unet as RefUnet


def dataset(cfg, n, seed):
    rows, w = cfg['model_rows'], cfg['pde']['n_grid']
    v = inputs.mixed_models(n, rows, w, inputs.subseed(seed, 'train'))
    return np.pad((v - 1500.0) / 3000.0, ((0, 0), (0, 0), (1, 1), (1, 1)))


def build(cfg, tr, dev, weights, data, seed, folder):
    from red_diffeq_tpu_torch.models.diffusion import GaussianDiffusion
    from red_diffeq_tpu_torch.models.trainer import TensorDataset, Trainer
    from red_diffeq_tpu_torch.models.unet import Unet
    m, d = cfg['model'], cfg['diffusion']
    net = Unet(dim=m['dim'], dim_mults=tuple(m['dim_mults']),
               channels=m['channels'])
    net.load_state_dict(weights)
    diff = GaussianDiffusion(net, image_size=d['image_size'],
                             timesteps=d['timesteps'],
                             sampling_timesteps=d['sampling_timesteps'],
                             objective=d['objective'], device=dev)
    t = cfg['training']
    return Trainer(diff, TensorDataset(data),
                   train_batch_size=t['batch_size'], train_lr=t['lr'],
                   train_num_steps=1, ema_decay=t['ema_decay'],
                   save_and_sample_every=t['save_every'],
                   results_folder=folder, amp=t['amp'],
                   seed=inputs.subseed(seed, 'trainer'))


def run(cell, dev, seed, seconds, trace, t_start) -> harness.Outcome:
    cfg, tr = cell['config'], cell['traffic']
    t = cfg['training']
    t_inputs = time.perf_counter()
    weights = inputs.unet_weights(cfg['model'], seed, dev)
    data = dataset(cfg, tr['images'], seed)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_build = time.perf_counter()
    folder = tempfile.mkdtemp(prefix='h100_bench_train_')
    trainer = build(cfg, tr, dev, weights, data, seed, folder)
    t_warm = time.perf_counter()
    call = dict(log_every=t['log_every'], steps_per_call=t['steps_per_call'])
    p0 = [p.detach().clone() for p in trainer.params]
    trainer.train(**call)
    g1 = [m.detach() / (1 - trainer.optimizer.b1) for m in
          trainer.optimizer.mu]
    g1 = [g.clone() for g in g1]
    trainer.train_num_steps = 3
    trainer.train(**call)
    dp3 = [(p.detach() - q) for p, q in zip(trainer.params, p0)]
    trainer.train_num_steps = tr['follow_steps']
    trainer.train(**call)
    dema = [(e.detach() - q) for e, q in zip(trainer.ema_params, p0)]
    losses = [e['loss'] for e in trainer.training_losses[:tr['follow_steps']]]
    setup_s = time.perf_counter() - t_start

    spans = tracing.Spans(trace, dev)
    calls = 0
    t0 = time.perf_counter()
    with spans.window():
        while (calls < tr['trace_calls'] if trace else
               not calls or time.perf_counter() - t0 < seconds):
            trainer.train_num_steps += tr['steps_per_train']
            with spans.span('train'):
                trainer.train(**call)
            calls += 1
    window_s = time.perf_counter() - t0
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
              else 0)
    steps = calls * tr['steps_per_train']
    images = steps * t['batch_size']
    print(f'set-up {setup_s:.3f} s (imports {t_inputs - t_start:.3f}, '
          f'inputs {t_build - t_inputs:.3f}, build {t_warm - t_build:.3f}, '
          f'warm-up {t0 - t_warm:.3f}), window {window_s:.3f} s, '
          f'{steps} steps, loss {trainer.training_losses[-1]["loss"]:.5f}', flush=True)
    blend = next_blend(trainer, call)
    m = cfg['model']
    context = dict(trace=spans.trace, steps=steps, images=images,
                   train_flops_per_image=counts.unet_flops(
                       m['dim'], m['dim_mults'],
                       cfg['diffusion']['image_size'], 1, backward=True),
                   unet_precision='fp32')
    metrics = {'train_images_per_s': images / window_s, 'setup_s': setup_s}
    names = list(trainer.names)
    del trainer
    shutil.rmtree(folder, ignore_errors=True)
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    ref = reference_steps(cfg, tr, weights, data, seed, dev, Arith())
    got = compare(names, dict(losses=losses, g1=g1, dp3=dp3, dema=dema), ref)
    got['ema_blend'] = blend_gap(blend, t['ema_decay'])
    checks = {k: (v, tr['limits'][k]) for k, v in got.items()}
    n = tr['follow_steps']
    return harness.Outcome(
        metrics=metrics, context=context, checks=checks, attempted=steps + n,
        failed=n * int(not all(v <= lim for v, lim in checks.values())),
        memory_peak_bytes=int(memory), trace=spans.trace)


def reference_steps(cfg, tr, weights, data, seed, dev, ar) -> dict:
    """The first ``follow_steps`` steps of the reference from the same
    weights, with
    the rows and draws the trainer takes from its seed: rows from a numpy
    stream, then per step the timesteps and the noise from a generator on
    the device."""
    t = cfg['training']
    b = t['batch_size']
    tseed = inputs.subseed(seed, 'trainer')
    rng = np.random.RandomState(tseed)
    gen = torch.Generator(device=dev).manual_seed(tseed)
    with fp32_math():
        unet = RefUnet(dim=cfg['model']['dim'],
                       dim_mults=tuple(cfg['model']['dim_mults']),
                       ar=ar).to(dev)
        unet.load_state_dict(weights)
        sched = rdiff.Schedule(cfg['diffusion']['timesteps'], dev)
        st = rtrain.TrainState(unet, t['lr'], ema_decay=t['ema_decay'])
        p0 = [p.detach().clone() for p in st.params]
        losses, g1, dp3 = [], None, None
        for k in range(tr['follow_steps']):
            idx = rng.randint(0, len(data), size=b)
            ts = torch.randint(0, cfg['diffusion']['timesteps'], (b,),
                               generator=gen, device=dev)
            noise = torch.randn((b, *data.shape[1:]), generator=gen,
                                device=dev)
            img = torch.from_numpy(data[idx].astype(np.float32)).to(dev)
            losses.append(float(rtrain.step(st, sched, img, ts, noise)))
            if k == 0:
                g1 = [m / (1 - st.b1) for m in st.m]
            if k == 2:
                dp3 = [p.detach() - q for p, q in zip(st.params, p0)]
        dema = [e - q for e, q in zip(st.ema, p0)]
    return dict(names=st.names, losses=losses, g1=g1, dp3=dp3, dema=dema)


def next_blend(trainer, call) -> dict:
    """The trainer driven on through the window's call to its next EMA
    update (the next multiple of the reference's ``UPDATE_EVERY``): the
    step, the EMA before, and the parameters and the EMA after."""
    e0 = [e.detach().clone() for e in trainer.ema_params]
    every = rtrain.UPDATE_EVERY
    trainer.train_num_steps = (trainer.step // every + 1) * every
    trainer.train(**call)
    return dict(step=trainer.step, e0=e0,
                p=[p.detach().clone() for p in trainer.params],
                e=[e.detach().clone() for e in trainer.ema_params])


def blend_gap(b, decay) -> float:
    """The EMA's change at its update ``b['step']`` against the
    reference's blend of the program's EMA before and parameters after,
    (1 - d) * (p - e0) with the warm-up decay d of that step (a copy of p
    while d is 0), in float64: the worst parameter's norm of the
    difference over the larger of the reference's norm of that parameter
    and of the median parameter."""
    d = rtrain.warmup_decay(b['step'], decay)
    got, ref = [], []
    for e0, p, e in zip(b['e0'], b['p'], b['e']):
        e0, p, e = e0.double(), p.double(), e.double()
        got.append(e - e0)
        ref.append((1.0 - d) * (p - e0))
    norms = [float(torch.linalg.vector_norm(r)) for r in ref]
    med = float(np.median(norms))
    worst = 0.0
    for g, r, n in zip(got, ref, norms):
        gap = float(torch.linalg.vector_norm(g - r))
        if gap:     # where the blend is 0 everywhere, any change is wrong
            worst = max(worst, gap / max(n, med) if med else 1.0)
    return worst


def leaf_gap(names, got, ref, ref_for_rule):
    """The worst parameter's gap between the two norms, over the larger of
    the reference's norm of that parameter and of the median parameter;
    parameters whose reference gradient is under a thousandth of the
    median's are left out (they move by round-off alone)."""
    norms = {n: float(torch.linalg.vector_norm(r)) for n, r in zip(names, ref)}
    med = float(np.median(list(norms.values())))
    rule = {n: float(torch.linalg.vector_norm(g))
            for n, g in zip(names, ref_for_rule)}
    rule_med = float(np.median(list(rule.values())))
    worst = 0.0
    for n, g, r in zip(names, got, ref):
        if rule[n] < 1e-3 * rule_med:
            continue
        gap = abs(float(torch.linalg.vector_norm(g)) - norms[n])
        worst = max(worst, gap / max(norms[n], med))
    return worst


def compare(prog_names, prog, ref) -> dict:
    order = [prog_names.index(n) for n in ref['names']]
    dev = ref['g1'][0].device
    g1, dp3, dema = ([prog[k][i].to(dev) for i in order]
                     for k in ('g1', 'dp3', 'dema'))
    return {
        'loss': max(abs(a - b) / abs(b) for a, b in
                    zip(prog['losses'], ref['losses'])),
        'grad1': leaf_gap(ref['names'], g1, ref['g1'], ref['g1']),
        'dparam3': leaf_gap(ref['names'], dp3, ref['dp3'], ref['g1']),
        'dema': leaf_gap(ref['names'], dema, ref['dema'], ref['g1']),
    }


def control(cell, dev, seed) -> dict:
    """The numbers of the reference in TF32 put in the trainer's place."""
    cfg = cell['config']
    weights = inputs.unet_weights(cfg['model'], seed, dev)
    data = dataset(cfg, cell['traffic']['images'], seed)
    tr = cell['traffic']
    ref = reference_steps(cfg, tr, weights, data, seed, dev, Arith())
    tf32 = reference_steps(cfg, tr, weights, data, seed, dev,
                           Arith(tf32=True))
    return compare(tf32['names'], tf32, ref)


def fault(name: str):
    """The fault ``name`` of ``lib/faults.py`` planted in the program."""
    from red_diffeq_tpu_torch.models import diffusion, trainer

    if name == 'unchanged':
        def make(orig):
            def update(self, grads, *a, **kw):
                return [g * 0.0 for g in orig(self, grads, *a, **kw)]
            return update
        return faults.patched(trainer.Adam, 'update', make)
    if name == 'half':
        def make(orig):
            def loss(self, img, t=None, noise=None, **kw):
                h = img.shape[0] // 2
                return orig(self, img[:h], t=None if t is None else t[:h],
                            noise=None if noise is None else noise[:h], **kw)
            return loss
        return faults.patched(diffusion.GaussianDiffusion, 'loss', make)
    if name == 'altered':
        def make(orig):
            def loss(self, *a, **kw):
                return orig(self, *a, **kw) * 1.01
            return loss
        return faults.patched(diffusion.GaussianDiffusion, 'loss', make)
    if name == 'ema':
        def make(orig):
            def update_ema(self, at):
                return None
            return update_ema
        return faults.patched(trainer.Trainer, '_update_ema', make)
    if name == 'emadecay':
        def make(orig):
            def decay_at(step, cfg):
                return cfg.decay if orig(step, cfg) > 0.0 else 0.0
            return decay_at
        return faults.patched(trainer, '_ema_decay_at', make)
    raise ValueError(name)
