"""A training cell: the port's ``Trainer`` in this process.

Set-up builds one model and one ``TrainState`` from the seed's weights
and drives it through the first three steps, each on its own rows drawn
from the seed; those steps build the kernels and are what the reference
follows. The same state then trains on fresh rows for the window, each
step ending in ``torch.cuda.synchronize()``. The window is the span of
the steps it holds, so a rate has all of their work and all of their
time.
"""
from __future__ import annotations

import gc
import os
import statistics
import time
from typing import Dict, List

from perfbench import devtrace, program, weights
from perfbench.reference.train import B1

FIRST_STEPS = 3


def batch_tokens(seed: int, k: int, batch: int, seq: int, vocab: int,
                 device):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.leaf_seed(seed, 'batch', k))
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)


def _sync(device) -> None:
    import torch
    if str(device).startswith('cuda'):
        torch.cuda.synchronize()


def run(ctx: Dict) -> Dict:
    import torch
    from skypilot_tpu_torch.train.step import Trainer
    args, cfg, mix = ctx['args'], ctx['config'], ctx['mix']
    tr = cfg['train']
    device = ctx['device']
    b, t = int(mix['batch']), int(mix['seq'])
    config, model, dims = program.build(
        cfg, args.seed, device, layers=int(tr['num_hidden_layers']),
        remat=True, remat_policy=tr['remat'])
    trainer = Trainer(model, learning_rate=float(tr['lr']))
    state = trainer.state_from_params(model.params())
    step = trainer.step_fn()
    fault = ctx.get('fault')
    if fault:
        from perfbench import faults
        step = faults.plant_train(fault, trainer, step)

    def feed(k: int):
        tokens = batch_tokens(args.seed, k, b, t, dims['v'], device)
        return {'tokens': tokens, 'targets': torch.roll(tokens, -1, dims=1)}

    losses: List[float] = []
    grad: Dict = {}
    for k in range(FIRST_STEPS):
        state, m = step(state, feed(k))
        losses.append(float(m['loss']))
        if k == 0:
            opt = state.opt_state.state
            for name, i, p in _leaves(state.params):
                mom = opt.get(_owner(state.params, name), {}).get('exp_avg')
                if mom is None:  # the optimizer never ran
                    grad[(name, i)] = 0.0
                    continue
                mom = mom if i is None else mom[i]
                grad[(name, i)] = float(torch.linalg.vector_norm(
                    mom, dtype=torch.float32)) / (1 - B1)
    change = {}
    with torch.no_grad():
        for name, i, p in _leaves(state.params):
            p0 = torch.empty(p.shape, dtype=torch.bfloat16, device=device)
            shapes = (weights.top_leaves(dims) if i is None
                      else weights.layer_leaves(dims))
            weights.draw_into(p0.view(shapes[name][0]), args.seed, name, i,
                              shapes[name][1])
            change[(name, i)] = float(torch.linalg.vector_norm(
                p.detach().float() - p0.float()))
            del p0
    _sync(device)
    run_rec: Dict = {'kind': 'train', 'dims': dims, 'config': cfg,
                     'cell': ctx['cell'], 'seed': args.seed,
                     'program': {'loss': losses, 'grad': grad,
                                 'change': change},
                     'batch': b, 'seq': t}
    run_rec['setup_s'] = time.perf_counter() - ctx['t0']
    # With a trace, the profiler covers whole steps from trace_offset of
    # the window for about trace_s seconds (a trace of the whole window
    # takes longer to write and read than a run may last).
    cell = ctx['cell']
    trace_from = float(cell['trace_offset']) * float(args.seconds)
    trace_for = float(cell['trace_s'])
    prof = None
    traced: Dict = {}
    t_start = time.perf_counter()
    steps, k = 0, FIRST_STEPS
    nonfinite = torch.zeros((), dtype=torch.int32, device=device)
    while True:
        elapsed = time.perf_counter() - t_start
        if args.trace and prof is None and not traced \
                and elapsed >= trace_from:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if str(device).startswith('cuda')
                                       else ProfilerActivity.CPU])
            prof.start()
            traced = {'t0': time.perf_counter(), 'steps': 0}
        state, m = step(state, feed(k))
        nonfinite += ~torch.isfinite(m['loss'])
        _sync(device)
        end = time.perf_counter()
        steps += 1
        k += 1
        if prof is not None:
            traced['steps'] += 1
            if end - traced['t0'] >= trace_for or \
                    end - t_start >= float(args.seconds):
                prof.stop()
                traced['t1'] = end
                path = os.path.join(ctx['scratch'],
                                    f'train_trace_{os.getpid()}.json')
                prof.export_chrome_trace(path)
                traced['path'] = path
                prof = None
        if end - t_start >= float(args.seconds):
            break
    nonfinite = int(nonfinite)
    window_s = end - t_start
    if traced.get('path'):
        run_rec['trace'] = dict(devtrace.load(traced['path']),
                                window_s=traced['t1'] - traced['t0'],
                                steps=traced['steps'])
        os.remove(traced['path'])
    run_rec.update(steps=steps, window_s=window_s, nonfinite=nonfinite,
                   tokens=steps * b * t)
    if str(device).startswith('cuda'):
        run_rec['memory_peak_bytes'] = int(torch.cuda.max_memory_allocated())
    else:
        run_rec['memory_peak_bytes'] = 0
    del state, step, trainer, model, m
    gc.collect()
    if str(device).startswith('cuda'):
        torch.cuda.empty_cache()
    return run_rec


def _owner(params, name):
    return params[name] if name in params else params['layers'][name]


def _leaves(params):
    return weights.program_leaves(params)


def compare(run_rec: Dict, device, lowp=None) -> Dict:
    """The reference's three steps against the program's: each step's
    loss, and by the worst leaf the first clipped gradient's norm and the
    change after three steps, each against the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out."""
    from perfbench.reference import train as ref_train
    cfg, dims = run_rec['config'], run_rec['dims']
    b, t, seed = run_rec['batch'], run_rec['seq'], run_rec['seed']
    batches = [batch_tokens(seed, k, b, t, dims['v'], device)
               for k in range(FIRST_STEPS)]
    ref = ref_train.train_steps(dims, cfg, seed, batches,
                                float(cfg['train']['lr']), device, lowp)
    return gaps(run_rec['program'], ref)


def gaps(prog: Dict, ref: Dict) -> Dict:
    loss_gap = max(abs(a - r) for a, r in zip(prog['loss'], ref['loss']))
    med_g = statistics.median(ref['grad'].values())
    keep = [k for k, g in ref['grad'].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref['change'][k] for k in keep)

    def worst(kind, med):
        return max(abs(prog[kind][k] - ref[kind][k]) / max(ref[kind][k], med)
                   for k in keep)
    return {'loss_gap': loss_gap, 'grad_gap': worst('grad', med_g),
            'change_gap': worst('change', med_c),
            'loss_prog': prog['loss'], 'loss_ref': ref['loss'],
            'leaves': len(keep), 'left_out': len(ref['grad']) - len(keep)}
