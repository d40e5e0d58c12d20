"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py              # every phase, as the release check runs it
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases device,build,kernel,train
    python3 chip_smoke.py --phases build,breakdown   # where the time goes

Phases, each printing one JSON object per line:
  device  card name and power limit (torch + nvidia-smi);
  build   the hand-written CUDA kernels, compiled from csrc/ with nvcc,
          one nvcc per source, all started together;
  kernel  each kernel against its plain PyTorch version on the card, with
          stated tolerances, and timed beside its bound, its plain
          version and the PyTorch library call that computes the same
          function;
  train   the launchable trainer (train.run.main) at llama-1b full width
          and depth, batch 4 x seq 8192, remat 'dots', 3 steps on one
          fixed batch with checkpoints; kernel launch counts per step; a
          resume from the step-2 checkpoint; one 'full'-remat step; a
          full-width gate of loss and grads through the kernels against
          the reference attention; the step's device time by kernel;
  serve   the generation-server replica at llama3-8b full width (random
          weights from a seed, bf16, paged KV, speculative decode) behind
          its HTTP surface: greedy /generate requests, a prefix-cache hit,
          a stream, a repeat; kernel launch counts read from this run;
  breakdown  (only when asked for) host and device time per dispatch
          kind of the serve phase's engine, with its costliest ops.
Then a `kernels` line and, last, {"ok": true, "device": {...}}. Any
failure exits non-zero before the last line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

ALL_PHASES = ('device', 'build', 'kernel', 'train', 'serve')
# Run only when named in --phases: a per-dispatch time breakdown.
EXTRA_PHASES = ('breakdown',)
KERNELS = ('flash_fwd', 'flash_bwd')

# Llama-3-8B attention widths.
HQ, HKV, HEAD_DIM = 32, 8, 128
# K1's out and K2's dq, dk, dv: every (batch, 64-row tile, head) block's
# RMS error within TILE_RTOL of that block's RMS (utils/compare.py: bf16
# results, P and dS rounded to bf16 on both sides from sums taken in
# another order). K1's lse: absolute, f32 row reductions in another order.
LSE_TOL = 1e-3
LOGIT_RTOL = 5e-2  # kernel-path prefill logits vs reference attention
L2_SETS = 4  # input copies timed in turn: 4 x 31 MB at 1536 exceeds L2
# The trainer as the train phase drives it: llama-1b (16/8 heads, d 128),
# batch 4 x seq 8192 (the example's batch of 8 was global over 8 TPU
# chips; 8 does not fit one 80 GB card at remat 'dots'), 3 steps.
TRAIN_HQ, TRAIN_HKV, TRAIN_B, TRAIN_SEQ = 16, 8, 4, 8192
TRAIN_ARGV = ['--preset', 'llama-1b', '--batch', str(TRAIN_B), '--seq',
              str(TRAIN_SEQ), '--device', 'cuda', '--log-every', '1']
GATE_SEQ = 2048  # full-width gate: batch 1 x 2048 tokens
GATE_LOSS_RTOL = 1e-2  # loss through the kernels vs reference attention
GATE_GRAD_RTOL = 5e-2  # each leaf's grad, relative L2
# The replica as the serve phase starts it: llama3-8b, bf16 weights from
# seed 0, paged KV (64-row blocks), speculative decode K 4, 2 steps in
# flight (the SKYTPU_* defaults).
SERVE_ARGV = ['--preset', 'llama3-8b', '--batch-slots', '8', '--max-len',
              '4096', '--device', 'cuda', '--seed', '0']


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    if not causal:
        return sq * sk
    q_start = sk - sq
    return sum(min(sk, q_start + i + 1) for i in range(sq))


def _bound(flops: float, nbytes: float, ctx):
    t_ops, t_bytes = flops / ctx['peak_flops'], nbytes / ctx['peak_bw']
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def flash_bound_ms(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                   causal: bool, ctx):
    """K1: 4*hq*d FLOPs per visible pair (two products); q, k, v read
    and out written in bf16, lse written in f32."""
    flops = 4.0 * b * hq * d * visible_pairs(sq, sk, causal)
    nbytes = b * (2.0 * d * (2 * sq * hq + 2 * sk * hkv) + 4.0 * hq * sq)
    return _bound(flops, nbytes, ctx)


def flash_bwd_bound_ms(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                       causal: bool, ctx):
    """K2: 10*hq*d FLOPs per visible pair (five products); q, k, v, out,
    dO and lse read, dq, dk, dv written."""
    flops = 10.0 * b * hq * d * visible_pairs(sq, sk, causal)
    nbytes = b * (2.0 * d * (4 * sq * hq + 4 * sk * hkv) + 4.0 * hq * sq)
    return _bound(flops, nbytes, ctx)


# ---------------------------------------------------------------------------
def phase_build(ctx) -> None:
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from skypilot_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))  # re-raises a failed build
    for name in KERNELS:
        info = _build.build_info[name]
        ptxas = [ln.strip() for ln in str(info['log']).splitlines()
                 if 'registers' in ln or 'spill' in ln
                 or 'Compiling entry' in ln]
        emit({'phase': 'build', 'kernel': name,
              'nvcc_s': round(float(info['seconds']), 3),
              'wall_s': round(time.perf_counter() - t0, 3), 'ptxas': ptxas})


def phase_kernel(ctx) -> None:
    """K1, then K2, against their plain versions on the card. Every case
    is checked and printed before a failure raises."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1234)
    cases = [  # (sq, sk, causal, head_dim)
        (128, 128, True, HEAD_DIM), (1000, 1000, True, HEAD_DIM),
        (1536, 1536, True, HEAD_DIM), (2048, 2048, True, HEAD_DIM),
        (256, 1024, True, HEAD_DIM), (300, 777, False, HEAD_DIM),
        (200, 333, True, 64)]
    failures = []
    worst = 0.0
    for sq, sk, causal, d in cases:
        q, k, v = _qkv(gen, 1, sq, sk, HQ, HKV, d)
        rec = check_flash_fwd(q, k, v, causal,
                              attn.flash_attention_fwd_reference)
        if causal and sq == sk and sq in (1536, 2048):
            rec.update(time_flash(ctx, q, k, v, d ** -0.5))
        emit(rec)
        worst = max(worst, rec['out_max_abs_err'])
        if not rec['ok']:
            failures.append(rec)
    # K1 at the train phase's shape (llama-1b heads, batch 4 x 8192).
    q, k, v = _qkv(gen, TRAIN_B, TRAIN_SEQ, TRAIN_SEQ, TRAIN_HQ, TRAIN_HKV,
                   HEAD_DIM)
    rec = check_flash_fwd(q, k, v, True, _fwd_by_kv_head)
    rec.update(time_flash(ctx, q, k, v, HEAD_DIM ** -0.5, sets=2,
                          plain=_fwd_by_kv_head))
    emit(rec)
    worst = max(worst, rec['out_max_abs_err'])
    if not rec['ok']:
        failures.append(rec)
    del q, k, v
    ctx['flash'] = {'max_abs_err': worst}
    failures += check_flash_bwd(ctx, gen)
    if failures:
        raise RuntimeError(f'{len(failures)} kernel case(s) disagree with '
                           f'their plain versions: {failures}')


def _qkv(gen, b, sq, sk, hq, hkv, d):
    import torch
    dev = torch.device('cuda')

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen,
                           dtype=torch.float32).to(torch.bfloat16)
    return rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)


def check_flash_fwd(q, k, v, causal, plain):
    """One K1 case against ``plain`` on the same inputs: out per 64-row
    tile (TILE_RTOL), lse absolute (LSE_TOL)."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.utils.compare import TILE_RTOL, tile_rel_err
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    out, lse = attn.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = plain(q, k, v, causal, scale)
    tile_err = tile_rel_err(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (tile_err <= TILE_RTOL and lse_err <= LSE_TOL
          and bool(torch.isfinite(out.float()).all()))
    return {'phase': 'kernel', 'kernel': 'flash_fwd', 'b': b, 'sq': sq,
            'sk': sk, 'causal': causal, 'head_dim': d, 'hq': hq, 'hkv': hkv,
            'out_tile_rel_err': tile_err, 'tile_rtol': TILE_RTOL,
            'out_max_abs_err': (out.float() - ref_out.float()).abs().max()
            .item(), 'out_ref_max_abs': ref_out.float().abs().max().item(),
            'lse_max_abs_err': lse_err, 'lse_tol': LSE_TOL, 'ok': ok}


def _fwd_by_kv_head(q, k, v, causal, scale):
    """The plain K1 version, one KV head's query group at a time (the same
    function; the heads are independent), so that its f32 score tensors
    fit on the card at long sequences."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    hkv = k.shape[2]
    grp = q.shape[2] // hkv
    parts = [attn.flash_attention_fwd_reference(
        q[:, :, h * grp:(h + 1) * grp], k[:, :, h:h + 1], v[:, :, h:h + 1],
        causal, scale) for h in range(hkv)]
    return (torch.cat([p[0] for p in parts], dim=2),
            torch.cat([p[1] for p in parts], dim=1))


def _bwd_by_kv_head(q, k, v, out, lse, dout, causal, scale):
    """The plain K2 version, one KV head's query group at a time, as
    ``_fwd_by_kv_head``."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    hkv = k.shape[2]
    grp = q.shape[2] // hkv
    parts = []
    for h in range(hkv):
        qs = slice(h * grp, (h + 1) * grp)
        parts.append(attn.flash_attention_bwd_reference(
            q[:, :, qs], k[:, :, h:h + 1], v[:, :, h:h + 1], out[:, :, qs],
            lse[:, qs].contiguous(), dout[:, :, qs], causal, scale))
    return tuple(torch.cat([p[i] for p in parts], dim=2) for i in range(3))


def check_flash_bwd(ctx, gen):
    """K2 against its plain version on the card: llama-1b (16/8) and
    llama3-8b (32/8) heads at d 128 and one d 64 case; out and lse come
    from K1 on the same inputs. dq, dk and dv each per 64-row tile
    (TILE_RTOL). Then timed at the train shape. Returns the failed
    cases' records."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.utils.compare import TILE_RTOL, tile_rel_err
    cases = [  # (sq, sk, causal, head_dim)
        (128, 128, True, HEAD_DIM), (1000, 1000, True, HEAD_DIM),
        (2048, 2048, True, HEAD_DIM), (8192, 8192, True, HEAD_DIM),
        (256, 1024, True, HEAD_DIM), (300, 777, False, HEAD_DIM)]
    runs = [(hq, hkv, c) for hq, hkv in ((TRAIN_HQ, TRAIN_HKV), (HQ, HKV))
            for c in cases] + [(TRAIN_HQ, TRAIN_HKV, (200, 333, True, 64))]
    failures = []
    worst = 0.0
    for hq, hkv, (sq, sk, causal, d) in runs:
        q, k, v = _qkv(gen, 1, sq, sk, hq, hkv, d)
        dout = _qkv(gen, 1, sq, sq, hq, hkv, d)[0]
        scale = d ** -0.5
        out, lse = attn.flash_attention_fwd(q, k, v, causal, scale)
        got = attn.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       scale)
        torch.cuda.synchronize()
        want = _bwd_by_kv_head(q, k, v, out, lse, dout, causal, scale)
        rec = {'phase': 'kernel', 'kernel': 'flash_bwd', 'sq': sq, 'sk': sk,
               'causal': causal, 'head_dim': d, 'hq': hq, 'hkv': hkv,
               'tile_rtol': TILE_RTOL, 'ok': True}
        for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
            err = (g.float() - w.float()).abs().max().item()
            rec[f'{name}_tile_rel_err'] = tile_rel_err(g, w)
            rec[f'{name}_max_abs_err'] = err
            rec[f'{name}_ref_max_abs'] = w.float().abs().max().item()
            finite = bool(torch.isfinite(g.float()).all())
            if not (finite and rec[f'{name}_tile_rel_err'] <= TILE_RTOL):
                rec['ok'] = False
            worst = max(worst, err)
        emit(rec)
        if not rec['ok']:
            failures.append(rec)
        del q, k, v, dout, out, lse, got, want
    ctx['flash_bwd'] = {'max_abs_err': worst}
    timing = time_flash_bwd(ctx)
    ctx['flash_bwd_timing'] = timing
    emit({'phase': 'kernel', 'kernel': 'flash_bwd', 'b': TRAIN_B,
          'sq': TRAIN_SEQ, 'sk': TRAIN_SEQ, 'hq': TRAIN_HQ,
          'hkv': TRAIN_HKV, 'head_dim': HEAD_DIM, 'causal': True, **timing})
    return failures


def time_flash_bwd(ctx):
    """K2 / plain / library at the train shape (b 4, 8192, 16/8 heads,
    causal), inputs rotating over two copies (each more bytes than L2).
    The library call is PyTorch's flash-attention backward
    (aten._scaled_dot_product_flash_attention_backward) on KV repeated to
    16 heads, as it takes no GQA: it returns per-query-head dK/dV, which
    K2 sums over the group."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    gen = torch.Generator(device='cuda')
    gen.manual_seed(99)
    b, s, hq, hkv, d = TRAIN_B, TRAIN_SEQ, TRAIN_HQ, TRAIN_HKV, HEAD_DIM
    scale = d ** -0.5
    sets = []
    for _ in range(2):
        q, k, v = _qkv(gen, b, s, s, hq, hkv, d)
        dout = _qkv(gen, b, s, s, hq, hkv, d)[0]
        out, lse = attn.flash_attention_fwd(q, k, v, True, scale)
        sets.append((q, k, v, out, lse, dout))
    turn = itertools.count()

    def kernel():
        attn.flash_attention_bwd(*sets[next(turn) % 2], True, scale)

    kernel_ms = time_cuda(kernel, iters=10)
    plain_ms = time_cuda(lambda: _bwd_by_kv_head(*sets[0], True, scale),
                         iters=2, warmup=1)
    lib_sets = []
    for q, k, v, _, _, dout in sets:
        qt, dot = q.transpose(1, 2), dout.transpose(1, 2)
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False, scale=scale)
        lib_sets.append((dot, qt, kt, vt, fwd[:8]))

    def library():
        dot, qt, kt, vt, fwd = lib_sets[next(turn) % 2]
        out, lse, cq, ck, mq, mk, seed, offset = fwd
        torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True, seed,
            offset, scale=scale)

    library_ms = time_cuda(library, iters=10)
    bound_ms, bound_by = flash_bwd_bound_ms(b, s, s, hq, hkv, d, True, ctx)
    return {'kernel_ms': kernel_ms, 'plain_ms': plain_ms,
            'library_ms': library_ms,
            'library_call': 'aten._scaled_dot_product_flash_attention_'
                            'backward',
            'bound_ms': bound_ms, 'bound_by': bound_by, 'card': ctx['smi']}


def time_flash(ctx, q, k, v, scale, sets=L2_SETS, plain=None):
    """kernel / plain / SDPA times at one causal sq == sk shape. The
    kernel and SDPA take their turns over ``sets`` copies of the inputs,
    more bytes than the 50 MB L2 holds, so each call finds its q/k/v in
    HBM as a prefill does (they come fresh from the projections).
    ``plain`` defaults to ``flash_attention_fwd_reference``."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention as attn
    plain = plain or attn.flash_attention_fwd_reference
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    copies = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                            for _ in range(sets - 1)]
    turn = itertools.count()

    def kernel():
        qi, ki, vi = copies[next(turn) % sets]
        attn.flash_attention_fwd(qi, ki, vi, True, scale)

    def sdpa():
        qi, ki, vi = (t.transpose(1, 2) for t in copies[next(turn) % sets])
        F.scaled_dot_product_attention(qi, ki, vi, is_causal=True,
                                       scale=scale, enable_gqa=True)

    short = sq <= 2048
    kernel_ms = time_cuda(kernel, iters=48 if short else 10)
    plain_ms = time_cuda(lambda: plain(q, k, v, True, scale),
                         iters=5 if short else 2, warmup=1)
    library_ms = time_cuda(sdpa, iters=48 if short else 10)
    bound_ms, bound_by = flash_bound_ms(b, sq, sk, hq, hkv, d, True, ctx)
    timing = {'kernel_ms': kernel_ms, 'plain_ms': plain_ms,
              'library_ms': library_ms, 'bound_ms': bound_ms,
              'bound_by': bound_by, 'card': ctx['smi']}
    ctx.setdefault('flash_timing', {})[(b, sq, hq)] = timing
    return timing


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp(min=1e-30)).item()


def phase_train(ctx) -> None:
    """llama-1b at full width and depth through ``train.run.main``."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.models.llama import PRESETS
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.train import run
    from skypilot_tpu_torch.train.step import (cross_entropy_loss, get_leaf,
                                               leaf_names)
    cfg = PRESETS['llama-1b']
    layers = cfg.num_layers
    gen = torch.Generator(device='cuda')
    gen.manual_seed(7)
    fixed = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_SEQ),
                          device='cuda', generator=gen)
    batch = {'tokens': fixed, 'targets': torch.roll(fixed, -1, dims=1)}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    ckpt = os.path.join(tmp, 'ckpt')
    dots = TRAIN_ARGV + ['--remat', 'dots', '--steps', '3', '--ckpt-dir',
                         ckpt, '--save-every', '1']
    try:
        # 3 steps, 'dots', checkpoint after each: the main path's run.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        res = run.main(dots, batch_fn=lambda step: fixed)
        run_s = time.perf_counter() - t0
        launches = dict(attn.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log = res['log']
        losses = [r['loss'] for r in log]
        if len(losses) != 3 or not all(map(math.isfinite, losses)) \
                or not losses[2] < losses[0]:
            raise RuntimeError(f'train losses not finite and falling: '
                               f'{losses}')
        want = {'flash_fwd': 3 * layers, 'flash_bwd': 3 * layers}
        if launches != want:
            raise RuntimeError(f'3 dots steps launched {launches}, want '
                               f'{want}')
        ctx['train_launches'] = launches
        # One more step, synced, for the step time without checkpoint
        # copies; then one under torch.profiler for where it goes.
        trainer, state = res['trainer'], res['state']
        step = trainer.step_fn()
        _, step_ms = _wall_ms(lambda: step(state, batch), 1)
        prof = _profile_calls(lambda: step(state, batch), 1, top=12)
        del res, trainer, state, step
        tokens = TRAIN_B * TRAIN_SEQ
        flops = cfg.train_flops_per_token(TRAIN_SEQ) * tokens
        emit({'phase': 'train', 'preset': 'llama-1b',
              'params': cfg.num_params, 'layers': layers,
              'batch': TRAIN_B, 'seq': TRAIN_SEQ, 'remat': 'dots',
              'losses': losses,
              'grad_norms': [r['grad_norm'] for r in log],
              'logged_step_s': [r['seconds'] for r in log],
              'run_s': run_s, 'step_ms': step_ms,
              'tokens_per_s': tokens / step_ms * 1e3,
              'tflops': flops / step_ms / 1e9,
              'mfu': flops / step_ms / 1e-3 / ctx['peak_flops'],
              'peak_mem_gb': peak_gb, 'launches': launches,
              'launches_per_step': {k: v // 3 for k, v in launches.items()},
              'device_busy_ms': prof['busy_ms'],
              'port_kernels_ms': prof['port_kernels_ms'],
              'device_kernels': prof['kernels'], 'top_ops': prof['top_ops'],
              'card': ctx['smi']})

        # Resume from the step-2 checkpoint: step 3's loss again, bitwise.
        shutil.rmtree(os.path.join(ckpt, '3'))
        torch.cuda.empty_cache()
        attn.reset_launch_counts()
        res = run.main(dots, batch_fn=lambda step: fixed)
        again = res['log'][0]
        resumed = {'phase': 'train', 'check': 'resume',
                   'start_step': res['start_step'], 'step': again['step'],
                   'loss': again['loss'], 'want': losses[2],
                   'launches': dict(attn.LAUNCHES)}
        emit(resumed)
        del res
        if (resumed['start_step'] != 2 or again['step'] != 3
                or again['loss'] != losses[2]):
            raise RuntimeError(f'resume did not reproduce step 3: '
                               f'{resumed}')
        if resumed['launches'] != {'flash_fwd': layers, 'flash_bwd': layers}:
            raise RuntimeError(f'resumed step launched {resumed}')

        # One 'full' step: K1 runs again inside the backward.
        torch.cuda.empty_cache()
        attn.reset_launch_counts()
        res = run.main(TRAIN_ARGV + ['--remat', 'full', '--steps', '1'],
                       batch_fn=lambda step: fixed)
        full = dict(attn.LAUNCHES)
        emit({'phase': 'train', 'check': 'remat_full',
              'loss': res['log'][0]['loss'], 'launches': full})
        if full != {'flash_fwd': 2 * layers, 'flash_bwd': layers}:
            raise RuntimeError(f'a full-remat step launched {full}')

        # Full-width gate: loss and grads through K1/K2 against the
        # reference attention, batch 1 x 2048, the trained weights.
        model, params = res['trainer'].model, res['state'].params
        names = leaf_names(params)
        leaves = [get_leaf(params, n) for n in names]
        tokens = fixed[:1, :GATE_SEQ]
        out = {}
        for impl in (None, 'reference'):
            logits, _ = model.apply_with_aux(params, tokens, force_impl=impl)
            loss = cross_entropy_loss(logits, torch.roll(tokens, -1, 1))
            out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
            del logits, loss
        loss_rel = abs(out[None][0] - out['reference'][0]) / abs(
            out['reference'][0])
        grad_rel = {n: _rel_l2(g, w) for n, g, w in
                    zip(names, out[None][1], out['reference'][1])}
        ok = (loss_rel <= GATE_LOSS_RTOL
              and max(grad_rel.values()) <= GATE_GRAD_RTOL)
        emit({'phase': 'train', 'check': 'gate', 'tokens': GATE_SEQ,
              'loss_kernel': out[None][0], 'loss_reference':
              out['reference'][0], 'loss_rel_err': loss_rel,
              'loss_rtol': GATE_LOSS_RTOL, 'grad_rel_l2': grad_rel,
              'grad_rtol': GATE_GRAD_RTOL, 'ok': ok})
        del res, model, params, leaves, out
        if not ok:
            raise RuntimeError('kernel-path loss/grads off the reference')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(lm_head_cost(ctx, cfg))


def lm_head_cost(ctx, cfg):
    """The three lm-head GEMMs of a train step at batch 4 x 8192 (logits,
    dx, dW), in f32 as the port runs them and in bf16 for comparison."""
    import torch
    rows, e, vocab = TRAIN_B * TRAIN_SEQ, cfg.embed_dim, cfg.vocab_size
    rec = {'phase': 'train', 'check': 'lm_head', 'rows': rows, 'embed': e,
           'vocab': vocab, 'flops': 3 * 2.0 * rows * e * vocab}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(rows, e, device='cuda').to(dtype)
        w = torch.randn(e, vocab, device='cuda').to(dtype)
        g = torch.randn(rows, vocab, device='cuda').to(dtype)
        ms = (time_cuda(lambda: x @ w, iters=3, warmup=1)
              + time_cuda(lambda: g @ w.T, iters=3, warmup=1)
              + time_cuda(lambda: x.T @ g, iters=3, warmup=1))
        rec[f'{str(dtype).split(".")[1]}_ms'] = ms
        del x, w, g
        torch.cuda.empty_cache()
    rec['card'] = ctx['smi']
    return rec


def _post(base, body, timeout=600):
    req = urllib.request.Request(f'{base}/generate',
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        status = resp.status
    if body.get('stream'):
        lines = [json.loads(ln) for ln in raw.splitlines() if ln]
        return status, {'tokens': [c['token'] for c in lines
                                   if 'token' in c],
                        'ttft_ms': lines[-1].get('ttft_ms'),
                        'error': lines[-1].get('error')}
    return status, json.loads(raw)


def _run_wave(base, bodies):
    """POST every body concurrently; [(status, reply)] in order."""
    results = [None] * len(bodies)
    errors = []

    def one(i, body):
        try:
            results[i] = _post(base, body)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f'request {i}: {e!r}')

    threads = [threading.Thread(target=one, args=(i, b))
               for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(r is None for r in results):
        raise RuntimeError(f'requests failed: {errors}')
    return results


def phase_serve(ctx) -> None:
    """llama3-8b at full width through the replica's own entry points."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.serve import generation_server as gs

    args = gs.build_parser().parse_args(SERVE_ARGV)
    t0 = time.perf_counter()
    sched = gs.build_scheduler(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = sched.config
    sched.start()
    server = gs.GenerationServer(sched, host='127.0.0.1', port=0)
    http = threading.Thread(target=server.serve_forever, daemon=True)
    http.start()
    base = f'http://127.0.0.1:{server.port}'
    try:
        t0 = time.perf_counter()
        while True:
            try:
                with urllib.request.urlopen(f'{base}/health') as resp:
                    if resp.status == 200:
                        break
            except urllib.error.HTTPError:
                pass
            if time.perf_counter() - t0 > 600:
                raise RuntimeError('replica never became healthy')
            time.sleep(0.05)
        warm_s = time.perf_counter() - t0

        rng = np.random.default_rng(0)

        def prompt(n):
            return rng.integers(0, cfg.vocab_size, n).tolist()

        p100, p600, p1500, p50 = prompt(100), prompt(600), prompt(1500), \
            prompt(50)
        shared = p1500[:1024] + prompt(176)  # 16 cached blocks + suffix
        n_new = 32

        def body(tokens, **kw):
            return dict(tokens=tokens, max_tokens=n_new, temperature=0.0,
                        **kw)

        attn.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        # Wave 1: three prefill buckets (128, 1024, 1536) and a stream
        # (bucket 64), decoding together. Wave 2: a prompt sharing the
        # 1500-token prompt's first 1024 tokens (prefix-cache hit ->
        # prefill_chunk_final) and a repeat of the streamed prompt.
        wave1 = _run_wave(base, [body(p100), body(p600), body(p1500),
                                 body(p50, stream=True)])
        wave2 = _run_wave(base, [body(shared), body(p50)])
        run_s = time.perf_counter() - t_run
        launches = dict(attn.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        replies = wave1 + wave2
        for i, (status, reply) in enumerate(replies):
            toks = reply['tokens']
            if status != 200 or reply.get('error') or len(toks) != n_new \
                    or not all(0 <= t < cfg.vocab_size for t in toks):
                raise RuntimeError(f'bad reply {i}: {status} {reply}')
        if wave2[1][1]['tokens'] != wave1[3][1]['tokens']:
            raise RuntimeError('repeated prompt gave other tokens: '
                               f'{wave1[3][1]["tokens"]} vs '
                               f'{wave2[1][1]["tokens"]}')
        monolithic = 5  # every request but the prefix hit
        if launches['flash_fwd'] < cfg.num_layers * monolithic:
            raise RuntimeError(f'flash_fwd launched {launches} times for '
                               f'{monolithic} monolithic prefills')
        stats = json.loads(urllib.request.urlopen(f'{base}/stats').read())
        if not stats.get('prefix_hit_tokens'):
            raise RuntimeError(f'no prefix-cache hit: {stats}')
        metrics = urllib.request.urlopen(f'{base}/metrics').read().decode()
        engine_series = sorted({ln.split('{')[0].split(' ')[0]
                                for ln in metrics.splitlines()
                                if ln.startswith('skytpu_engine_')})
        if not engine_series:
            raise RuntimeError('no skytpu_engine_ series in /metrics')
    finally:
        server.shutdown()
        sched._thread.join(timeout=60)
        sched._emit_thread.join(timeout=60)
        http.join(timeout=60)
    if sched._thread.is_alive() or sched._emit_thread.is_alive():
        raise RuntimeError('scheduler threads did not stop')

    # One prefill's last-token logits through the kernel path (the
    # engine's monolithic prefill) against the full forward with the
    # plain reference attention, on the card. bf16 activations through
    # 32 layers: relative L2 error within LOGIT_RTOL.
    with torch.no_grad():
        eng, params = sched.engine, sched.params
        bucket = 128
        _, _, logits = eng.prefill(params, p100 + [0] * (bucket - 100), 100)
        ref = sched.engine.model.apply(
            params, torch.tensor([p100], device=eng.device),
            force_impl='reference')[0, -1]
        rel = ((logits - ref).norm() / ref.norm()).item()
        argmax_same = bool(logits.argmax() == ref.argmax())
    if not (rel <= LOGIT_RTOL and torch.isfinite(logits).all()):
        raise RuntimeError(f'prefill logits off the reference: rel {rel}')
    ttfts = sorted(r['ttft_ms'] for _, r in replies)
    n_tokens = sum(len(r['tokens']) for _, r in replies)
    ctx['flash_launches'] = launches['flash_fwd']
    emit({'phase': 'serve', 'preset': 'llama3-8b',
          'params': cfg.num_params, 'dtype': str(cfg.dtype),
          'batch_slots': 8, 'max_len': 4096,
          'kv_block': sched.engine.kv_block,
          'spec_tokens': sched.engine.spec_tokens,
          'inflight_steps': sched.inflight_steps,
          'init_s': init_s, 'warm_s': warm_s, 'requests': len(replies),
          'tokens_out': n_tokens, 'run_s': run_s,
          'tokens_per_s': n_tokens / run_s,
          'ttft_ms_p50': ttfts[len(ttfts) // 2], 'ttft_ms': ttfts,
          'peak_mem_gb': peak_gb, 'flash_fwd_launches': launches,
          'monolithic_prefills': monolithic,
          'prefix_hit_tokens': stats['prefix_hit_tokens'],
          'logits_rel_l2_err': rel, 'logits_rtol': LOGIT_RTOL,
          'logits_argmax_same': argmax_same,
          'engine_series': len(engine_series), 'card': ctx['smi']})


def _device_us(evt) -> float:
    """An averaged profiler event's self device time in microseconds (the
    attribute was renamed from cuda_* to device_* across torch versions)."""
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def _profile_calls(fn, reps: int, top: int = 10):
    """torch.profiler over ``reps`` calls of ``fn``: per call, the device
    busy ms (the sum of its kernels' times), the kernel count, and the
    host-side ops whose kernels take the most device time (ms per call).
    A kernel's time is counted once as a kernel event and once more as
    the self device time of the op that launched it, so the two are
    summed apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, ops = [], []
    for e in prof.key_averages():
        if _device_us(e) > 0:
            on_device = str(getattr(e, 'device_type', '')).endswith('CUDA')
            (kernels if on_device else ops).append(e)
    ops.sort(key=_device_us, reverse=True)
    # The port's own kernels launch through ctypes, under no aten op
    # (K2 is three kernels: flash_bwd_{delta,dkdv,dq}_kernel).
    from skypilot_tpu_torch.ops import attention as attn
    own = {name: sum(_device_us(e) for e in kernels
                     if name in e.key) / reps / 1e3
           for name in attn.LAUNCHES}
    return {
        'busy_ms': sum(_device_us(e) for e in kernels) / reps / 1e3,
        'kernels': sum(e.count for e in kernels) // reps,
        'port_kernels_ms': own,
        'top_ops': [{'op': e.key[:60], 'ms': _device_us(e) / reps / 1e3,
                     'calls': e.count // reps} for e in ops[:top]]}


def _wall_ms(fn, reps: int):
    """(host enqueue ms, synced wall ms) per call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    enqueue = wall = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue += t1 - t0
        wall += t2 - t0
    return enqueue / reps * 1e3, wall / reps * 1e3


def phase_breakdown(ctx) -> None:
    """Where a replica's time goes, one dispatch kind at a time, on the
    serve phase's engine (llama3-8b, 8 slots, max_len 4096): the host
    cost of one K1 call by route, monolithic prefill per bucket, then the plain step and the K-4 verify step with
    every slot live at ~1000 tokens of context. For each: the host's
    enqueue time, the synced wall time, the device busy time from
    torch.profiler, and the ops that take the most device time. Not run
    by default (``--phases ...,breakdown``)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.serve import generation_server as gs
    sched = gs.build_scheduler(gs.build_parser().parse_args(SERVE_ARGV))
    eng, params, cfg = sched.engine, sched.params, sched.config
    rng_np = np.random.default_rng(1)
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    reps = 5
    with torch.no_grad():
        # Host cost of one K1 call at a 128-token prefill's shape: the
        # wrapper called directly, through its custom op, and through
        # flash_attention (the model's call), synced after each call.
        q, k, v = _qkv(torch.Generator(device=eng.device), 1, 128, 128, HQ,
                       HKV, HEAD_DIM)
        scale = HEAD_DIM ** -0.5
        calls = {
            'direct': lambda: attn.flash_attention_fwd(q, k, v, True, scale),
            'custom_op': lambda: torch.ops.skytpu.flash_fwd(q, k, v, True,
                                                           scale),
            'flash_attention': lambda: attn.flash_attention(q, k, v, True,
                                                            scale)}
        rec = {'phase': 'breakdown', 'kind': 'k1_dispatch', 'tokens': 128}
        for name, fn in calls.items():
            fn()
            rec[f'{name}_enqueue_us'], rec[f'{name}_wall_us'] = (
                t * 1e3 for t in _wall_ms(fn, 200))
        emit({**rec, 'card': ctx['smi']})
        del q, k, v
        for bucket in (128, 1024, 1536):
            tokens = rng_np.integers(0, cfg.vocab_size, bucket).tolist()

            def prefill():
                eng.prefill(params, tokens, bucket)
            prefill()
            enqueue, wall = _wall_ms(prefill, reps)
            prof = _profile_calls(prefill, reps)
            emit({'phase': 'breakdown', 'kind': 'prefill', 'tokens': bucket,
                  'enqueue_ms': enqueue, 'wall_ms': wall,
                  'idle_share': 1.0 - prof['busy_ms'] / wall, **prof,
                  'card': ctx['smi']})
        state = sched.state
        ctx_len = 1000
        for slot in range(eng.batch_slots):
            prompt = rng_np.integers(0, cfg.vocab_size, 1024).tolist()
            state, _, gen = eng.admit(params, state, prompt, ctx_len, slot,
                                      gen)
        draft = [[0] * eng.spec_tokens] * eng.batch_slots
        kinds = {
            'step': lambda: eng.step(params, state, gen),
            'step_verify': lambda: eng.step_verify(params, state, gen,
                                                   draft),
        }
        for kind, fn in kinds.items():
            fn()
            enqueue, wall = _wall_ms(fn, reps)
            prof = _profile_calls(fn, reps)
            emit({'phase': 'breakdown', 'kind': kind,
                  'slots': eng.batch_slots, 'context': ctx_len,
                  'spec_tokens': eng.spec_tokens if kind != 'step' else 0,
                  'enqueue_ms': enqueue, 'wall_ms': wall,
                  'idle_share': 1.0 - prof['busy_ms'] / wall, **prof,
                  'card': ctx['smi']})


def kernels_line(ctx):
    """K1 timed at the serve path's largest prefill (1536, llama3-8b
    heads), K2 at the train shape; launches summed over the serve and
    train runs."""
    fwd = ctx['flash_timing'][(1, 1536, HQ)]
    bwd = ctx['flash_bwd_timing']
    train = ctx['train_launches']
    return [{
        'name': 'flash_fwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
        'replaces': 'skypilot_tpu/ops/attention.py:121',
        'launches': ctx['flash_launches'] + train['flash_fwd'],
        'max_abs_err': ctx['flash']['max_abs_err'],
        'ms': fwd['kernel_ms'], 'plain_ms': fwd['plain_ms'],
        'bound_ms': fwd['bound_ms'], 'bound_by': fwd['bound_by'],
        'library_ms': fwd['library_ms'],
    }, {
        'name': 'flash_bwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
        'replaces': 'skypilot_tpu/ops/attention.py:171',
        'launches': train['flash_bwd'],
        'max_abs_err': ctx['flash_bwd']['max_abs_err'],
        'ms': bwd['kernel_ms'], 'plain_ms': bwd['plain_ms'],
        'bound_ms': bwd['bound_ms'], 'bound_by': bwd['bound_by'],
        'library_ms': bwd['library_ms'],
    }]


# ---------------------------------------------------------------------------
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--phases', default=','.join(ALL_PHASES))
    args = parser.parse_args()
    phases = [p for p in args.phases.split(',') if p]
    unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
    if unknown:
        parser.error(f'unknown phases {sorted(unknown)}')

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible; this check runs on the '
              'GPU only', file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    ctx = {'name': torch.cuda.get_device_name(0),
           'count': torch.cuda.device_count()}
    ctx['smi'] = nvidia_smi_line()
    from skypilot_tpu_torch import accelerators
    ctx['peak_flops'], ctx['peak_bw'] = accelerators.card_peaks(ctx['smi'])
    emit({'phase': 'device', 'name': ctx['name'], 'count': ctx['count'],
          'nvidia_smi': ctx['smi'], 'torch': torch.__version__,
          'cuda': torch.version.cuda})
    runners = {'build': phase_build, 'kernel': phase_kernel,
               'train': phase_train, 'serve': phase_serve,
               'breakdown': phase_breakdown}
    for phase in phases:
        if phase == 'device':
            continue
        t0 = time.perf_counter()
        runners[phase](ctx)
        torch.cuda.empty_cache()
        emit({'phase': phase, 'seconds': time.perf_counter() - t0})
    if {'kernel', 'train', 'serve'} <= set(phases):
        emit({'kernels': kernels_line(ctx)})
    print(ctx['smi'], flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': ctx['name'],
                                 'count': ctx['count']}})
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failure is a failed check
        traceback.print_exc()
        sys.exit(1)
