"""Launchable trainer: the `run:` entrypoint for training task YAMLs.

    python -m skypilot_tpu_torch.train.run --preset llama-1b \
        --batch 4 --seq 8192 --remat dots --steps 500 --ckpt-dir ~/ckpt

Counterpart of ``skypilot_tpu/train/run.py``, with the same flags and the
same log lines, on one NVIDIA GPU: init (or resume from ``--ckpt-dir``),
a train step per synthetic batch, tokens/s and MFU against the card's
bf16 peak, checkpoints every ``--save-every`` steps. ``--device cpu``
runs it on the host (tests); without it the trainer refuses to start on
a machine with no GPU. ``--model mixtral`` trains the sparse-MoE model
with its router's aux loss; MFU counts its active (top-k) parameters.
Multi-device meshes (``--dp/--fsdp/--tp/--sp/--pp/--ep/--dcn`` above 1)
are not ported yet and exit naming ROADMAP.md. With ``$SKYTPU_WARM_INIT_CACHE`` set (and no
``--ckpt-dir``), the initialised state is restored from a snapshot there
when one matches, and written there otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog='skypilot_tpu_torch.train.run')
    p.add_argument('--preset', default='llama3-8b',
                   help='model preset (a PRESETS key of the --model family)')
    p.add_argument('--model', default='llama', choices=['llama', 'mixtral'],
                   help='model family')
    p.add_argument('--batch', type=int, default=8,
                   help='GLOBAL batch size (across all devices)')
    p.add_argument('--seq', type=int, default=8192)
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--accum', type=int, default=1)
    p.add_argument('--dp', type=int, default=1)
    p.add_argument('--fsdp', default='auto',
                   help="int, or 'auto' = all remaining devices (1 here)")
    p.add_argument('--tp', type=int, default=1)
    p.add_argument('--sp', type=int, default=1)
    p.add_argument('--pp', type=int, default=1)
    p.add_argument('--ep', type=int, default=1)
    p.add_argument('--dcn', default='auto',
                   help="cross-slice data-parallel degree; 'auto' = the "
                        'number of ganged slices (SKYTPU_NUM_SLICES)')
    p.add_argument('--remat', default=None,
                   help="remat policy override: 'none', 'full', 'dots', "
                        "'names', 'names_qkv' or 'names_offload'")
    p.add_argument('--ckpt-dir', default=None)
    p.add_argument('--save-every', type=int, default=50)
    p.add_argument('--log-every', type=int, default=10)
    # Parsed and never read, as in the JAX trainer: both train on
    # synthetic tokens.
    p.add_argument('--data', default='synthetic',
                   help="'synthetic' or a .npy token file")
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='device to train on (default cuda; the trainer '
                        'refuses to start without one unless cpu is '
                        'asked for)')
    return p.parse_args(argv)


def synthetic_tokens(step: int, batch: int, seq: int, vocab: int,
                     device) -> 'torch.Tensor':
    """Uniform random tokens [batch, seq] for ``step``, from a generator
    seeded with (1, step) (1 in the high word, the step in the low), the
    counterpart of ``fold_in(key(1), step)``; other bits than JAX's."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed((1 << 32) | step)
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         device=device)


def _check_single_device(args, num_slices: int) -> None:
    for flag in ('dp', 'tp', 'sp', 'pp', 'ep'):
        if getattr(args, flag) > 1:
            raise SystemExit(f'--{flag} {getattr(args, flag)}: multi-device '
                             'training is not yet ported to the PyTorch '
                             'trainer (ROADMAP.md queue 1, item 8)')
    fsdp = 1 if args.fsdp == 'auto' else int(args.fsdp)
    dcn = num_slices if args.dcn == 'auto' else max(1, int(args.dcn))
    if fsdp > 1 or dcn > 1:
        raise SystemExit(f'--fsdp {fsdp} --dcn {dcn}: multi-device training '
                         'is not yet ported to the PyTorch trainer '
                         '(ROADMAP.md queue 1, item 8)')


def main(argv=None,
         batch_fn: Optional[Callable[[int], Any]] = None) -> Dict[str, Any]:
    """Train; returns what the log lines show, per logged step.
    ``batch_fn(step)`` -> tokens [batch, seq] replaces the synthetic
    tokens (a caller that wants one fixed batch)."""
    args = parse_args(argv)

    from skypilot_tpu_torch import callbacks as skytpu_callback
    cb_armed = skytpu_callback.init(total_steps=args.steps)
    skytpu_callback.mark('proc_start')

    from skypilot_tpu_torch.runtime import distributed
    distributed.init()  # single process; raises for a multi-host contract

    import torch

    from skypilot_tpu_torch import accelerators
    from skypilot_tpu_torch.models import llama, mixtral
    from skypilot_tpu_torch.train import CheckpointManager, Trainer
    from skypilot_tpu_torch.utils.device import resolve_device
    # The benchmark reads this mark's name as "framework ready".
    skytpu_callback.mark('jax_ready')

    _check_single_device(args, distributed.num_slices())
    presets, model_cls = ((llama.PRESETS, llama.LlamaModel)
                          if args.model == 'llama' else
                          (mixtral.PRESETS, mixtral.MixtralModel))
    if args.preset not in presets:
        raise SystemExit(f'unknown --preset {args.preset!r}; valid: '
                         f'{sorted(presets)}')
    device = resolve_device(args.device)
    config = presets[args.preset]
    if args.remat is not None:
        config = (dataclasses.replace(config, remat=False)
                  if args.remat == 'none' else dataclasses.replace(
                      config, remat=True, remat_policy=args.remat))
    model = model_cls(config, device=device)
    trainer = Trainer(model, learning_rate=args.lr, accum_steps=args.accum)
    peak = accelerators.peak_bf16_flops(device)
    print(f'[train] devices=1 procs=1 device={device} model={args.preset} '
          f'params={config.num_params/1e9:.2f}B batch={args.batch} '
          f'seq={args.seq} remat='
          f'{config.remat_policy if config.remat else "none"}', flush=True)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                save_interval_steps=args.save_every)
        state = trainer.restore_or_init(mgr, gen)
        start_step = state.step
        if start_step:
            print(f'[train] resumed from step {start_step}', flush=True)
    else:
        warm_cache = os.environ.get('SKYTPU_WARM_INIT_CACHE')
        if warm_cache:
            state, source = trainer.init_with_warm_cache(warm_cache, gen)
            if source == 'restored':
                print('[train] warm-init snapshot restored '
                      f'(key {trainer.warm_cache_key()})', flush=True)
        else:
            state = trainer.init_fn()(gen)
    if cb_armed:
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        skytpu_callback.mark('init_done')

    step = trainer.step_fn()
    tokens_per_step = args.batch * args.seq
    flops_per_step = config.train_flops_per_token(args.seq) \
        * tokens_per_step
    log = []
    t_window = time.perf_counter()
    for i in range(start_step, args.steps):
        skytpu_callback.step_begin()
        tokens = (batch_fn(i) if batch_fn is not None else
                  synthetic_tokens(i, args.batch, args.seq,
                                   config.vocab_size, device))
        batch = trainer.shard_batch(
            {'tokens': tokens, 'targets': torch.roll(tokens, -1, dims=1)})
        state, metrics = step(state, batch)
        if cb_armed and (i == start_step or i + 1 == args.steps):
            float(metrics['loss'])  # sync the timing anchors only
        skytpu_callback.step_end()
        if (i + 1) % args.log_every == 0:
            loss = float(metrics['loss'])  # sync point
            dt = time.perf_counter() - t_window
            steps_done = args.log_every if i + 1 - start_step \
                >= args.log_every else i + 1 - start_step
            tok_s = tokens_per_step * steps_done / dt
            tflops = flops_per_step * steps_done / dt / 1e12
            mfu = tflops * 1e12 / peak if peak else None
            mfu_txt = f', MFU {mfu * 100:.1f}%' if peak else ''
            print(f'[train] step {i+1}: loss {loss:.4f}, '
                  f'{tok_s:,.0f} tok/s global '
                  f'({tflops:.1f} TFLOP/s/chip{mfu_txt})', flush=True)
            log.append({'step': i + 1, 'loss': loss,
                        'grad_norm': float(metrics['grad_norm']),
                        'seconds': dt / steps_done, 'tokens_per_s': tok_s,
                        'tflops': tflops, 'mfu': mfu})
            t_window = time.perf_counter()
        if mgr is not None:
            mgr.save(state)
    if mgr is not None:
        mgr.wait()
    print('[train] done.', flush=True)
    distributed.shutdown()
    return {'start_step': start_step, 'log': log, 'state': state,
            'trainer': trainer}


if __name__ == '__main__':
    main()
