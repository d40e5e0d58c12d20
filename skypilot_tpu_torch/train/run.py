"""Launchable trainer: the `run:` entrypoint for training task YAMLs.

    python -m skypilot_tpu_torch.train.run --preset llama-1b \
        --batch 4 --seq 8192 --remat dots --steps 500 --ckpt-dir ~/ckpt

Counterpart of ``skypilot_tpu/train/run.py``, with the same flags and the
same log lines: init (or resume from ``--ckpt-dir``), a train step per
synthetic batch, tokens/s and MFU against the card's bf16 peak,
checkpoints every ``--save-every`` steps. ``--device cpu`` runs it on the
host (tests); without it the trainer refuses to start on a machine with
no GPU. ``--model mixtral`` trains the sparse-MoE model with its router's
aux loss; MFU counts its active (top-k) parameters.

Multi-device: under the SKYTPU_* rank contract (``runtime/distributed
.py``; one process per host, one worker per local GPU, which this entry
point starts) the ranks form one process group and train on a mesh of
``--dp/--fsdp/--tp/--sp/--pp/--dcn`` (``--fsdp auto``: every device
left; ``--dcn auto``: the number of slices), sized as the JAX trainer
sizes it. Every rank makes the same global batch and keeps its rows
(and, with ``--sp``, its block of each sequence: ring attention);
``--pp`` runs the layers as GPipe stages
(``LlamaConfig.pp_microbatches`` microbatches, default one per stage),
not together with ``--sp``; ``--ep`` splits Mixtral's experts (a dense
Llama is replicated over it, as in JAX), and each MoE layer routes the
global batch; rank 0 prints.

    python -m skypilot_tpu_torch.train.run --model mixtral \
        --preset mixtral-8x7b --ep 8 --fsdp auto --batch 16 --seq 4096

    SKYTPU_COORDINATOR_ADDR=10.0.0.1:8476 SKYTPU_NUM_PROCESSES=2 \
    SKYTPU_PROCESS_ID=0 python -m skypilot_tpu_torch.train.run \
        --preset llama-1b --fsdp auto --batch 8 --seq 8192 --remat dots

With ``$SKYTPU_WARM_INIT_CACHE`` set (no ``--ckpt-dir``, one device), the
initialised state is restored from a snapshot there when one matches,
and written there otherwise.
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
                   help="int, or 'auto' = all remaining devices")
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


def mesh_spec(args, n: int, num_slices: int):
    """The mesh over ``n`` devices, sized with the JAX trainer's
    arithmetic and messages: ``--fsdp auto`` takes every device the other
    axes leave, ``--dcn auto`` the number of slices."""
    from skypilot_tpu_torch.parallel import MeshSpec
    dcn = num_slices if args.dcn == 'auto' else max(1, int(args.dcn))
    used = dcn * args.tp * args.sp * args.pp * args.ep * args.dp
    if args.fsdp == 'auto':
        if n % used:
            raise SystemExit(
                f'{n} devices not divisible by dcn*tp*sp*pp*ep*dp={used}')
        fsdp = n // used
    else:
        fsdp = int(args.fsdp)
        if used * fsdp != n:
            raise SystemExit(
                f'mesh {dcn}dcn*{args.tp}tp*{args.sp}sp*{args.pp}pp*'
                f'{args.ep}ep*{args.dp}dp*{fsdp}fsdp = {used * fsdp} '
                f'!= {n} devices')
    return MeshSpec(dcn=dcn, pp=args.pp, dp=args.dp, fsdp=fsdp, ep=args.ep,
                    sp=args.sp, tp=args.tp)


def _arm_callback(args) -> bool:
    """Arm the benchmark callback and mark the process start (a no-op
    without $SKYTPU_BENCHMARK_LOG_DIR). Done before the card is touched,
    as the JAX trainer marks it before it starts its backend: the bench's
    launch split reads runtime start-up as the time from this mark to
    'jax_ready'."""
    from skypilot_tpu_torch import callbacks as skytpu_callback
    armed = skytpu_callback.init(total_steps=args.steps)
    skytpu_callback.mark('proc_start')
    return armed


def _local_worker(argv, local_index: int, local_devices: int,
                  coordinator: str) -> None:
    args = parse_args(argv)
    _train(args, None, local_index, local_devices, coordinator,
           _arm_callback(args))


def local_workers(device_type: str,
                  batch_fn: Optional[Callable[[int], Any]]) -> int:
    """The worker processes ``main`` starts on this host: one per local
    GPU when there are several, no process group is up yet and the batch
    is the synthetic one. Otherwise 1: the trainer runs in the calling
    process, in the caller's group or on the caller's batch (which a
    spawned worker could not be handed)."""
    import torch
    from skypilot_tpu_torch.runtime import distributed
    if (device_type != 'cuda' or batch_fn is not None
            or distributed.is_initialized()):
        return 1
    return max(1, torch.cuda.device_count())


def main(argv=None,
         batch_fn: Optional[Callable[[int], Any]] = None) -> Dict[str, Any]:
    """Train; returns what the log lines show, per logged step.
    ``batch_fn(step)`` -> tokens [batch, seq] (the global batch) replaces
    the synthetic tokens (a caller that wants one fixed batch).

    Where ``local_workers`` says so, one worker process per GPU runs the
    trainer (a rank each, ``runtime/distributed.py``); this process waits
    for them and returns nothing."""
    args = parse_args(argv)
    from skypilot_tpu_torch.utils.device import resolve_device
    cb_armed = _arm_callback(args)
    local = local_workers(resolve_device(args.device).type, batch_fn)
    if local == 1:
        return _train(args, batch_fn, 0, 1, None, cb_armed)
    import multiprocessing
    import socket
    from skypilot_tpu_torch.runtime import distributed
    coordinator = os.environ.get(distributed.ENV_COORDINATOR_ADDR)
    if not coordinator:  # one host: its own rendezvous
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            coordinator = f'127.0.0.1:{sock.getsockname()[1]}'
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_local_worker,
                         args=(argv, i, local, coordinator))
             for i in range(local)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join()
    codes = [proc.exitcode for proc in procs]
    if any(codes):
        raise SystemExit(f'[train] local workers exited with {codes}')
    return {}


def _train(args, batch_fn, local_index: int, local_devices: int,
           coordinator: Optional[str], cb_armed: bool) -> Dict[str, Any]:
    from skypilot_tpu_torch import callbacks as skytpu_callback

    import torch

    from skypilot_tpu_torch import accelerators
    from skypilot_tpu_torch.models import llama, mixtral
    from skypilot_tpu_torch.parallel import make_mesh, multislice_rules
    from skypilot_tpu_torch.runtime import distributed
    from skypilot_tpu_torch.train import CheckpointManager, Trainer
    from skypilot_tpu_torch.utils.device import resolve_device
    device_type = resolve_device(args.device).type
    # No-op for one rank; a group over the SKYTPU_* contract otherwise. A
    # group the caller set up is used as it is, and left up at the end.
    owns_group = not distributed.is_initialized()
    distributed.init(coordinator, device_type=device_type,
                     local_devices=local_devices, local_index=local_index)
    device = resolve_device(args.device)  # this rank's card
    # The benchmark reads this mark's name as "framework ready".
    skytpu_callback.mark('jax_ready')

    n = distributed.world_size()
    spec = mesh_spec(args, n, distributed.num_slices())
    mesh = make_mesh(spec, device_type)
    rules = multislice_rules() if spec.dcn > 1 else llama.DEFAULT_RULES
    presets, model_cls = ((llama.PRESETS, llama.LlamaModel)
                          if args.model == 'llama' else
                          (mixtral.PRESETS, mixtral.MixtralModel))
    if args.preset not in presets:
        raise SystemExit(f'unknown --preset {args.preset!r}; valid: '
                         f'{sorted(presets)}')
    config = presets[args.preset]
    if args.remat is not None:
        config = (dataclasses.replace(config, remat=False)
                  if args.remat == 'none' else dataclasses.replace(
                      config, remat=True, remat_policy=args.remat))
    model = model_cls(config, device=device, mesh=mesh, rules=rules)
    trainer = Trainer(model, learning_rate=args.lr, accum_steps=args.accum)
    is_main = distributed.rank() == 0
    peak = accelerators.peak_bf16_flops(device)
    if is_main:
        print(f'[train] devices={n} procs={n // local_devices} '
              f'mesh={spec.sizes} device={device} model={args.preset} '
              f'params={config.num_params/1e9:.2f}B batch={args.batch} '
              f'seq={args.seq} remat='
              f'{config.remat_policy if config.remat else "none"}',
              flush=True)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                save_interval_steps=args.save_every)
        state = trainer.restore_or_init(mgr, gen)
        start_step = state.step
        if start_step and is_main:
            print(f'[train] resumed from step {start_step}', flush=True)
    else:
        warm_cache = os.environ.get('SKYTPU_WARM_INIT_CACHE')
        if warm_cache and n == 1:
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
        # The global batch, made alike on every rank; each keeps its rows.
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
            # Per device, as the JAX trainer reports TFLOP/s per chip.
            tflops = flops_per_step * steps_done / dt / 1e12 / n
            mfu = tflops * 1e12 / peak if peak else None
            mfu_txt = f', MFU {mfu * 100:.1f}%' if peak else ''
            if is_main:
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
    if is_main:
        print('[train] done.', flush=True)
    if owns_group:
        distributed.shutdown()
    return {'start_step': start_step, 'log': log, 'state': state,
            'trainer': trainer}


if __name__ == '__main__':
    main()
