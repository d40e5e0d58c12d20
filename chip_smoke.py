"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py              # every phase, as the release check runs it
    python3 chip_smoke.py --phases build,kernel
    python3 chip_smoke.py --phases device,build,kernel,train
    python3 chip_smoke.py --phases build,breakdown   # where the time goes
    python3 chip_smoke.py --phases build,kernel,serve_moe,train_moe
    python3 chip_smoke.py --phases device,build,kernel,train_mesh_moe
    python3 chip_smoke.py --phases device,build,kernel,train,train_mesh
    python3 chip_smoke.py --phases build,kernel --parent DIR  # old vs new
    python3 chip_smoke.py --phases device,build,kernel,bench

Phases, each printing one JSON object per line:
  device  card name and power limit (torch + nvidia-smi);
  build   the hand-written CUDA kernels, compiled from csrc/ with nvcc,
          one nvcc per source, all started together; per kernel function
          its registers and spills (-Xptxas -v) and its count of wgmma
          (HGMMA) and TMA-load (UTMALDG) SASS instructions (cuobjdump),
          failing if a flash kernel spills or lacks either;
  kernel  each kernel against its plain PyTorch version on the card, with
          stated tolerances, and timed beside its bound, its plain
          version and the PyTorch library call that computes the same
          function, at the shapes every phase gives it (the sp 2 ring's
          blocks among them: b 4 x 4096 x 4096, causal and full). Times
          are device time: the kernels' durations from torch.profiler
          (CUPTI), averaged over the calls, with CUDA events around the
          loop of calls beside them; a device time below its bound, or
          below two thirds of an event time the device paced, is read
          again, and fails the run if still short. With --parent, the
          kernels of another checkout (e.g. a `git archive` of an earlier
          commit) are built from its csrc/ and timed on the same inputs;
  train   the launchable trainer (train.run.main) at llama-1b full width
          and depth, batch 4 x seq 8192, remat 'dots', 3 steps on one
          fixed batch with checkpoints; kernel launch counts per step; a
          resume from the step-2 checkpoint; the named remat policies
          from the dots run's state (loss bit for bit, grad norm, median
          and spread of 5 timed calls, peak memory, pinned host bytes
          from the offloaded shapes); one 'full'-remat step; a
          full-width gate of loss and grads through the kernels against
          the reference attention; the step's device time by kernel; the
          warm-init snapshot (init against restore, bit for bit);
  train_mesh  the multi-device trainer: train.run under the SKYTPU_*
          rank contract at one process (--fsdp auto), its losses bit for
          bit the train phase's; a probe of two NCCL ranks; then two
          ranks (rank r on card r mod the cards: on one card they share
          it over gloo with CUDA tensors, as NCCL refuses two ranks on
          one device), each through train.run, llama-1b at full width
          and depth, remat 'dots', the train phase's batch and init, on
          the meshes {fsdp: 2}, {tp: 2}, {sp: 2} (ring attention, K1/K2
          per visited block) and {pp: 2} (GPipe stages, 2 microbatches),
          global batch 4 each: losses and grad norms against the
          one-device trainer, each re-assembled leaf's change from the
          init against the one-device run's, K1/K2 launches per rank
          against ``mesh_launches``, peak memory per rank, ms per step
          (two ranks on one card, collectives through the host: not a
          multi-GPU number); the collectives bench at world 2;
  serve   the generation-server replica at llama3-8b full width (random
          weights from a seed, bf16, paged KV, speculative decode) behind
          its HTTP surface: greedy /generate requests, a prefix-cache hit,
          a stream, a repeat; kernel launch counts read from this run;
  serve_modes  llama3-8b again, one set of random weights shared by
          every replica and engine: the replica with int8 KV and fused
          admission of 4 (a same-bucket wave through ONE admit_many, a
          1024-token prefix hit on int8 blocks), greedy agreement with
          the bf16 replica's streams and the int8 step's logits against
          bf16's from the same state; a contiguous-KV engine against the
          paged one token for token; admit_many against solo admits;
  serve_moe  the replica at mixtral-8x7b full width, 16 of its 32 layers
          (random bf16 weights from seed 0, the router rounded to bf16
          as the JAX replica rounds it, capacity factor 1.25): the serve
          phase's traffic, K1 launches exactly as the prefills predict;
          layer 0's dropped fraction per dispatch kind; prefill logits
          through K1 against the reference attention (and the routing
          choices that differ); then, on a second engine at capacity
          factor 4.0 (nothing drops), the engine against the decode_step
          oracle, speculative on against off, and a repeat;
  train_moe  the trainer at mixtral-8x7b full width, 4 layers, batch 1 x
          seq 4096, remat 'full': 3 steps on one fixed batch (aux loss,
          tokens/s, MFU of the active params, K1/K2 per step and layer),
          a profiled step, a forward + backward under 'full', 'dots' and
          'names' from one state, and loss and grads through K1/K2
          against the reference attention;
  train_mesh_moe  Mixtral on a mesh through train.run: mixtral-8x7b at
          full width, 2 layers, global batch 2 x seq 4096, remat 'full', 3
          steps on one fixed batch, one device and then two ranks sharing
          the card over gloo on {ep: 2} (experts 0-3 and 4-7, every token
          on both) and {fsdp: 2} (a row each, routed as one batch): losses,
          grad norms and each re-assembled leaf's change against one
          device's, K1/K2 launches per rank, each layer's dropped fraction
          equal on both ranks, the routing choices that differ from one
          device's (bounded), peak memory and ms per step per rank, and a
          profiled {ep: 2} step (expert bmm, the MoE all-reduce, K1/K2);
  bench   the port's measurement entry points (skypilot_tpu_torch/bench.py)
          at their card workload: its train phase (llama-1b, b 1 x 8192,
          remat 'names_qkv', 2 + 8 steps: tokens/s, MFU, the loss, K1/K2
          once per layer and step) and decode phase (16 slots, prefill
          TTFT, K1 once per layer and prefill) in this process; its
          launched phase as a subprocess (the trainer started cold and
          warm, startup split by the callback marks); serve_bench.run
          against a llama-1b replica subprocess at the bench's headline
          arguments, cut to one concurrency point (12) without the
          monolithic and int8 arms: completed requests without errors,
          TTFT/TPOT, the prefix arm's hit rate, the replica's /metrics
          summary, the card's memory.used peak;
  breakdown  (only when asked for) host and device time per dispatch
          kind of the serve phase's engine, with its costliest ops; an
          admit_many of 4 x 512 against 4 solo admits; the int8 step and
          verify against bf16's.
Then a `kernels` line and, last, {"ok": true, "device": {...}}. Any
failure exits non-zero before the last line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
from typing import NamedTuple

ALL_PHASES = ('device', 'build', 'kernel', 'train', 'train_mesh', 'serve',
              'serve_modes', 'serve_moe', 'train_moe', 'train_mesh_moe',
              'bench')
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
# serve_modes: the replica with int8 KV and SKYTPU_ADMIT_BATCH=4, a wave
# of 4 prompts of 300-500 tokens (one bucket, 512) and 32 new tokens
# each: 128 greedy tokens held against the bf16 replica's.
MODES_ARGV = SERVE_ARGV + ['--kv-dtype', 'int8']
MODES_WAVE = (300, 380, 440, 500)
MODES_BUCKET = 512
MODES_NEW = 32
MODES_LONG, MODES_SHARED = 1500, 1024  # a prompt, and a prefix hit on it
# int8 against bf16. The reference gates greedy agreement of whole
# streams at 90% (tests/test_decode.py:1352). On random 8B weights the
# logits are flat, a near tie parts two streams and every later token
# differs, so whole streams agreed on 63% in the first card run (PERF.md,
# PR 4): that agreement is printed, not gated. The gate holds the int8
# pool step by step along the bf16 stream (teacher forced): >= 90% of
# greedy tokens agree, the logits are within INT8_LOGIT_RTOL relative L2,
# and at every step where the tokens part, bf16's top-2 margin is below
# the largest logit difference (a near tie, not a wrong pool).
INT8_AGREE_MIN = 0.9
INT8_LOGIT_RTOL = 5e-2
# admit_many's KV rows against solo admits': the JAX test's allclose
# (tests/test_decode.py:592-594, rtol = atol = 2e-2).
ADMIT_KV_TOL = 2e-2
# The named remat policies, each from the dots run's state and batch:
# loss bit for bit with dots', grad norm within 1e-3 relative.
NAMED_POLICIES = ('names', 'names_qkv', 'names_offload')
GRAD_NORM_RTOL = 1e-3
POLICY_CALLS = 5  # timed forward + backward calls per policy
# train_mesh: two ranks on the one card, each through train.run (remat
# 'dots', the train phase's batch 4 and init, 3 steps), on two meshes
# (name, mesh flags): fsdp 2 (b 2 x 8192 per rank, 16/8 heads) and tp 2
# (b 4 x 8192, 8/4 heads per rank; the pair peaks at ~62 GB). Gates
# against the one-device trainer: loss GATE_LOSS_RTOL and grad norm
# GATE_GRAD_RTOL relative (the train phase's K1/K2 tolerances), K1/K2
# launches per rank per step as one device's, and each re-assembled
# leaf's change from the shared init within MESH_UPDATE_RTOL relative L2
# of the one-device run's change. Three AdamW steps at lr 3e-4 move a
# leaf by 2-7% of its norm, so the params themselves would hide a leaf
# left unchanged; its change reads 1.0 against the one-device run's.
MESH_STEPS = 3
MESH_UPDATE_RTOL = 0.5
MESH_RUNS = (('fsdp2', ['--fsdp', '2']), ('tp2', ['--tp', '2', '--fsdp', '1']),
             ('sp2', ['--sp', '2', '--fsdp', '1']),
             ('pp2', ['--pp', '2', '--fsdp', '1']))
# sp 2: rank r holds block r of every sequence (b 4 x 4096) and attends
# to r + 1 ring blocks per layer, the diagonal one causal and the earlier
# one full: K1 and K2 at b 4 x 4096 x 4096, 16/8 heads. pp 2: each rank
# runs 8 layers on 2 microbatches of b 2 x 8192 (the fsdp 2 shape).
RING_B, RING_SEQ = TRAIN_B, TRAIN_SEQ // 2
MESH_TIMEOUT_S = 600


def mesh_launches(name: str, rank: int, layers: int,
                  remat: str = 'dots') -> dict:
    """K1 and K2 launches of one rank's MESH_STEPS steps on mesh
    ``name``: under 'dots' (its recompute keeps K1's outputs) one each per
    layer and step, times the ring blocks rank r of sp 2 visits (r + 1),
    or over pp 2's half of the layers times its 2 microbatches; under
    'full' (train_mesh_moe) the recompute runs K1 again, so two K1 and
    one K2 per layer and step (train_moe's 8 + 4 at 4 layers)."""
    per_layer = {'sp2': rank + 1}.get(name, 1)
    n = MESH_STEPS * layers * per_layer
    return {'flash_fwd': n * (2 if remat == 'full' else 1), 'flash_bwd': n}


# Mixtral-8x7B at full width (skypilot_tpu/models/mixtral.py:81-85: embed
# 4096, 32/8 heads, 8 experts top-2, expert mlp 14336, capacity factor
# 1.25), its depth cut. serve_moe: 32 -> 16 layers (all 32 are 93.4 GB in
# bf16, over the 80 GB card; 16 are 46.4 GB), the serve phase's geometry
# and traffic. train_moe: 32 -> 4 layers (6.07 B params: bf16 params,
# grads and both AdamW moments 48.6 GB), batch 1 x seq 4096 (the per-chip
# share of examples/managed_job_with_ckpt.yaml's --batch 16 over 16
# chips), remat 'full' (the preset's), 3 steps on one fixed batch.
MOE_PRESET = 'mixtral-8x7b'
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 16, 4
MOE_SERVE_ARGV = ['--model', 'mixtral', '--preset', MOE_PRESET,
                  '--batch-slots', '8', '--max-len', '4096', '--device',
                  'cuda', '--seed', '0']
MOE_TRAIN_B, MOE_TRAIN_SEQ = 1, 4096
MOE_TRAIN_ARGV = ['--model', 'mixtral', '--preset', MOE_PRESET, '--batch',
                  str(MOE_TRAIN_B), '--seq', str(MOE_TRAIN_SEQ), '--remat',
                  'full', '--device', 'cuda', '--log-every', '1']
# train_mesh_moe: Mixtral on a mesh through train.run, as train_mesh
# drives Llama: mixtral-8x7b at full width, 32 -> MOE_MESH_LAYERS layers
# (one device's params, grads and both AdamW moments are 25 GB at 2 layers,
# and two ranks' share the card), global batch MOE_MESH_B x seq 4096 (the
# example's sequence), remat 'full' (the preset's), MESH_STEPS steps on one
# fixed batch (seed 7); one device, then two ranks: {ep: 2} (the example's
# --ep 8 --fsdp auto in miniature: each rank holds experts 0-3 or 4-7 and
# sees every token, b 2 x 4096) and {fsdp: 2} (each rank one row, b 1 x
# 4096; each layer routes both ranks' tokens as one batch). Gated as
# train_mesh (loss, grad norm, each re-assembled leaf's change), with K1/K2
# launches per rank by ``mesh_launches(..., 'full')``, each layer's dropped
# fraction equal on both ranks (it is the global batch's), and the routing
# choices of the first forward that differ from one device's at most
# MOE_MESH_FLIPS_MAX of them: bf16 sums in another order flip router near
# ties (train_moe's gate: 25 of 32768 between K1 and reference attention,
# PERF.md).
MOE_MESH_LAYERS, MOE_MESH_B = 2, 2
MOE_MESH_ARGV = ['--model', 'mixtral', '--preset', MOE_PRESET, '--batch',
                 str(MOE_MESH_B), '--seq', str(MOE_TRAIN_SEQ), '--remat',
                 'full', '--device', 'cuda', '--log-every', '1']
MOE_MESH_RUNS = (('ep2', ['--ep', '2', '--fsdp', '1']),
                 ('fsdp2', ['--fsdp', '2']))
MOE_MESH_FLIPS_MAX = 0.01
# The equivalence gates run on a second engine over the same weights at
# capacity factor 4.0 >= E/k: no assignment can drop, so a token's output
# does not depend on which tokens share its dispatch (at 1.25 it does, in
# the JAX package too). Teacher forced for MOE_ORACLE_TOKENS positions:
# the greedy tokens agree, or part at a near tie (the reference's top-2
# margin below the largest logit difference). Where the token's experts
# are the same in every layer, the logits are within LOGIT_RTOL relative
# L2. Where bf16 noise flipped a router near tie (the first card run,
# PERF.md: 7 of 16 oracle positions, on random weights), the token's
# later layers run other experts and its logits may differ by more; such
# positions are printed with their first flip, and may be at most
# MOE_ROUTED_OTHERWISE_MAX of all.
MOE_EQUIV_CF = 4.0
MOE_ROUTED_OTHERWISE_MAX = 0.75
MOE_ORACLE_TOKENS = 16
MOE_MONOLITHIC = 5  # the serve traffic's monolithic prefills (K1 each)
# bench: the port's measurement entry points (skypilot_tpu_torch/bench.py)
# at their card workload. phase_train: llama-1b, b 1 x 8192, remat
# 'names_qkv' (K1's out and lse kept: one K1 and one K2 per layer and
# step), 2 + 8 steps; phase_decode: 16 slots, 4 prefills of the 128-token
# prompt (one K1 per layer each). The kernel phase checks K1 and K2 at the
# train shape and K1 at the monolithic serve bucket (a 2500-token prompt
# pads to 2560). The serve call is the bench's headline arm cut to one
# concurrency point (12, the sweep's first), no monolithic A/B arm and no
# int8 arm (serve_modes drives int8 KV).
BENCH_B, BENCH_STEPS, BENCH_PREFILLS = 1, 2 + 8, 4
BENCH_SERVE_BUCKET = 2560
BENCH_TRAIN_FIELDS = ('metric', 'value', 'unit', 'vs_baseline',
                      'equivalent_8b_tokens_per_sec_per_chip',
                      'model_params_b', 'mfu_pct', 'mfu_6n_pct', 'chip',
                      'seq_len')
BENCH_DECODE_FIELDS = ('decode_tokens_per_sec_per_chip', 'decode_batch_slots',
                       'decode_ttft_ms', 'decode_prompt_len')
BENCH_LAUNCH_PARTS = ('control_plane_s', 'runtime_startup_s', 'param_init_s',
                      'first_step_s')
BENCH_TIMEOUT_S = 600


def _device_of(argv):
    return argv[argv.index('--device') + 1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def _event_and_host_ms(fn, iters: int, warmup: int = 3):
    """(CUDA-event ms, host enqueue ms) per call over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events). When
    a call's kernels take less time than the host takes to enqueue them,
    this reads the host."""
    return _event_and_host_ms(fn, iters, warmup)[0]


MS_SOURCE = 'torch.profiler device time, mean per call'
# Where the host enqueued the calls in under half their event time (the
# device, not the host, set the pace), a device time below this share of
# the event time is a profiler reading that missed kernels: the share was
# 0.86-1.08 in the sound readings of six card runs outside the 1536-token
# shape (0.61-0.93 there, where the host's enqueue can set the event
# time), and 0.482 and 0.518 in the two that missed about half (SDPA at b
# 4 x 4096², full, and at b 1 x 4096², causal).
DEVICE_EVENT_MIN = 2 / 3


def time_device(fn, iters: int, warmup: int = 3, bound_ms=None,
                what: str = ''):
    """(device ms, event ms) per call of ``fn``: the summed durations of
    the kernels it launched, from torch.profiler, averaged over ``iters``
    calls; and the CUDA-event time over as many calls, beside it. A
    device time below ``bound_ms`` (the least time the card could take),
    or below DEVICE_EVENT_MIN of a device-paced event time, means the
    profiler missed kernels: it is read once more, and if still short
    the run fails, naming ``what``. No such reading is ever returned."""
    for _ in range(warmup):
        fn()
    for _ in range(2):
        busy = _profile_calls(fn, iters)['busy_ms']
        event, host = _event_and_host_ms(fn, iters, warmup=0)
        short = ((bound_ms is not None and busy < bound_ms)
                 or (host < 0.5 * event and busy < DEVICE_EVENT_MIN * event))
        if not short:
            return busy, event
    raise RuntimeError(f'{what}: device time {busy} ms is below its bound '
                       f'{bound_ms} ms or {DEVICE_EVENT_MIN:.3f} of its event '
                       f'time {event} ms (host {host} ms), twice: the '
                       'profiler missed kernels')


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
    wall = time.perf_counter() - t0
    faults = []
    for name in KERNELS:
        info = _build.build_info[name]
        functions = _build.ptxas_report(str(info['log']))
        for fn, ops in _build.sass_counts(str(info['path'])).items():
            functions.setdefault(fn, {}).update(ops)
        # Registers: the count at entry (the launch bound); the producer
        # and consumer warpgroups then move to 24 and 240 (setmaxnreg).
        emit({'phase': 'build', 'kernel': name,
              'nvcc_s': round(float(info['seconds']), 3),
              'wall_s': round(wall, 3), 'functions': functions})
        for fn, rec in functions.items():
            if 'delta' in fn:  # K2's delta pass: a row sum, no product
                continue
            if (rec.get('spill_stores') or rec.get('spill_loads')
                    or not rec.get('HGMMA') or not rec.get('UTMALDG')):
                faults.append((fn, rec))
    if faults:
        raise RuntimeError(f'flash kernels spill or lack wgmma/TMA: {faults}')


def phase_kernel(ctx) -> None:
    """K1, then K2, against their plain versions on the card. Every case
    is checked and printed before a failure raises."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    if ctx.get('parent'):
        ctx['parent_libs'] = build_parent_kernels(ctx['parent'])
    gen = torch.Generator(device='cuda')
    gen.manual_seed(1234)
    failures = []
    worst = 0.0
    for case in FWD_CASES:
        q, k, v = _case_inputs(gen, case)[:3]
        rec = check_flash_fwd(q, k, v, case.causal,
                              attn.flash_attention_fwd_reference)
        rec['fused'] = case.fused
        if case.causal and case.sq == case.sk in (1536, 2048):
            rec.update(time_flash(ctx, q, k, v, case.d ** -0.5))
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
    # K1 at train_mesh's per-rank shapes (fsdp 2: b 2, 16/8 heads; tp 2:
    # b 4, 8/4 heads).
    for b, hq, hkv in MESH_KERNEL_SHAPES:
        q, k, v = _qkv(gen, b, TRAIN_SEQ, TRAIN_SEQ, hq, hkv, HEAD_DIM)
        rec = check_flash_fwd(q, k, v, True, _fwd_by_kv_head)
        rec.update(time_flash(ctx, q, k, v, HEAD_DIM ** -0.5, sets=2,
                              plain=_fwd_by_kv_head))
        emit(rec)
        worst = max(worst, rec['out_max_abs_err'])
        if not rec['ok']:
            failures.append(rec)
        del q, k, v
    # K1 at the sp 2 ring's block shapes: the diagonal block causal, the
    # earlier one full (b 4 x 4096 x 4096, 16/8 heads).
    for causal in (True, False):
        q, k, v = _qkv(gen, RING_B, RING_SEQ, RING_SEQ, TRAIN_HQ, TRAIN_HKV,
                       HEAD_DIM)
        rec = check_flash_fwd(q, k, v, causal, _fwd_by_kv_head)
        rec.update(time_flash(ctx, q, k, v, HEAD_DIM ** -0.5, sets=2,
                              plain=_fwd_by_kv_head, causal=causal),
                   ring_block='diagonal' if causal else 'earlier')
        emit(rec)
        worst = max(worst, rec['out_max_abs_err'])
        if not rec['ok']:
            failures.append(rec)
        del q, k, v
    # K1 at the train_moe shape (mixtral-8x7b heads, batch 1 x 4096; the
    # {fsdp: 2} rank's of train_mesh_moe) and at the {ep: 2} rank's
    # (batch 2 x 4096).
    for b in (MOE_TRAIN_B, MOE_MESH_B):
        q, k, v = _qkv(gen, b, MOE_TRAIN_SEQ, MOE_TRAIN_SEQ, HQ, HKV,
                       HEAD_DIM)
        rec = check_flash_fwd(q, k, v, True, _fwd_by_kv_head)
        rec.update(time_flash(ctx, q, k, v, HEAD_DIM ** -0.5,
                              plain=_fwd_by_kv_head))
        emit(rec)
        worst = max(worst, rec['out_max_abs_err'])
        if not rec['ok']:
            failures.append(rec)
        del q, k, v
    # K1 at the bench's train shape (b 1 x 8192) and at its monolithic
    # serve bucket (b 1 x 2560), llama-1b heads.
    for s in (TRAIN_SEQ, BENCH_SERVE_BUCKET):
        q, k, v = _qkv(gen, BENCH_B, s, s, TRAIN_HQ, TRAIN_HKV, HEAD_DIM)
        rec = check_flash_fwd(q, k, v, True, _fwd_by_kv_head)
        rec.update(time_flash(ctx, q, k, v, HEAD_DIM ** -0.5,
                              plain=_fwd_by_kv_head), shape='bench')
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


class Case(NamedTuple):
    b: int
    sq: int
    sk: int
    causal: bool
    d: int
    hq: int
    hkv: int
    fused: bool = False  # q, k, v as views of one [b, s, hq + 2 hkv, d]


# Ragged query and key tiles (127, 129, 1000, 193 x 1000), a prefix whose
# offset is no tile multiple (193 x 1000, 256 x 1024), non-causal, d 64,
# strided views of one fused projection, the serve path's prefills, and
# admit_many's batch of MODES_WAVE prompts in one MODES_BUCKET launch
# (q, k and v separate, as the engine's projections give them).
FWD_CASES = [Case(1, s, s, True, HEAD_DIM, HQ, HKV)
             for s in (127, 128, 129, 1000, 1536, 2048)] + [
    Case(1, 193, 1000, True, HEAD_DIM, HQ, HKV),
    Case(1, 256, 1024, True, HEAD_DIM, HQ, HKV),
    Case(1, 300, 777, False, HEAD_DIM, HQ, HKV),
    Case(1, 200, 333, True, 64, HQ, HKV),
    Case(2, 300, 300, True, HEAD_DIM, HQ, HKV, fused=True),
    Case(len(MODES_WAVE), MODES_BUCKET, MODES_BUCKET, True, HEAD_DIM, HQ,
         HKV)]
# K2 at llama-1b (16/8) and llama3-8b / mixtral-8x7b (32/8) heads, up to
# the train phase's 8192 (4096: the train_moe shape).
BWD_CASES = [Case(1, sq, sk, causal, HEAD_DIM, hq, hkv)
             for hq, hkv in ((TRAIN_HQ, TRAIN_HKV), (HQ, HKV))
             for sq, sk, causal in ((127, 127, True), (129, 129, True),
                                    (1000, 1000, True), (2048, 2048, True),
                                    (4096, 4096, True), (8192, 8192, True),
                                    (193, 1000, True), (256, 1024, True),
                                    (300, 777, False))] + [
    Case(1, 200, 333, True, 64, TRAIN_HQ, TRAIN_HKV),
    Case(2, 300, 300, True, HEAD_DIM, HQ, HKV, fused=True)]
# train_mesh's per-rank shapes at seq 8192: (b, hq, hkv).
MESH_KERNEL_SHAPES = ((TRAIN_B // 2, TRAIN_HQ, TRAIN_HKV),
                      (TRAIN_B, TRAIN_HQ // 2, TRAIN_HKV // 2))
BWD_CASES += [Case(b, TRAIN_SEQ, TRAIN_SEQ, True, HEAD_DIM, hq, hkv)
              for b, hq, hkv in MESH_KERNEL_SHAPES]
# The sp 2 ring's blocks: diagonal (causal) and earlier (full).
BWD_CASES += [Case(RING_B, RING_SEQ, RING_SEQ, causal, HEAD_DIM, TRAIN_HQ,
                   TRAIN_HKV) for causal in (True, False)]
# train_mesh_moe's {ep: 2} rank: b 2 x 4096, 32/8 heads.
BWD_CASES += [Case(MOE_MESH_B, MOE_TRAIN_SEQ, MOE_TRAIN_SEQ, True, HEAD_DIM,
                   HQ, HKV)]


def _qkv(gen, b, sq, sk, hq, hkv, d):
    import torch
    dev = torch.device('cuda')

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen,
                           dtype=torch.float32).to(torch.bfloat16)
    return rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)


def _case_inputs(gen, case):
    """q, k, v and a dO for one case; with ``fused``, q, k and v are
    strided views of one [b, s, hq + 2 hkv, d] tensor (sq == sk)."""
    import torch
    b, sq, sk, hq, hkv, d = (case.b, case.sq, case.sk, case.hq, case.hkv,
                             case.d)
    dout = _qkv(gen, b, sq, sq, hq, hkv, d)[0]
    if not case.fused:
        return (*_qkv(gen, b, sq, sk, hq, hkv, d), dout)
    qkv = torch.randn(b, sq, hq + 2 * hkv, d, device='cuda', generator=gen,
                      dtype=torch.float32).to(torch.bfloat16)
    return (qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:],
            dout)


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
    """K2 against its plain version on the card, case by case
    (``BWD_CASES``); out and lse come from K1 on the same inputs. dq, dk
    and dv each per 64-row tile (TILE_RTOL). Then timed at the train
    shape. Returns the failed cases' records."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.utils.compare import TILE_RTOL, tile_rel_err
    failures = []
    worst = 0.0
    for case in BWD_CASES:
        q, k, v, dout = _case_inputs(gen, case)
        causal, scale = case.causal, case.d ** -0.5
        out, lse = attn.flash_attention_fwd(q, k, v, causal, scale)
        got = attn.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       scale)
        torch.cuda.synchronize()
        want = _bwd_by_kv_head(q, k, v, out, lse, dout, causal, scale)
        rec = {'phase': 'kernel', 'kernel': 'flash_bwd', 'b': case.b,
               'sq': case.sq, 'sk': case.sk, 'causal': causal,
               'head_dim': case.d, 'hq': case.hq, 'hkv': case.hkv,
               'fused': case.fused, 'tile_rtol': TILE_RTOL, 'ok': True}
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
    # Timed at the train phase's shape, at train_moe's, at
    # train_mesh_moe's {ep: 2} rank's, at train_mesh's per-rank shapes and
    # at the sp 2 ring's block shapes.
    for key, (b, s, hq, hkv, causal) in (
            ('flash_bwd_timing', (TRAIN_B, TRAIN_SEQ, TRAIN_HQ, TRAIN_HKV,
                                  True)),
            ('flash_bwd_timing_moe', (MOE_TRAIN_B, MOE_TRAIN_SEQ, HQ, HKV,
                                      True)),
            ('flash_bwd_timing_moe_ep', (MOE_MESH_B, MOE_TRAIN_SEQ, HQ, HKV,
                                         True)),
            ('flash_bwd_timing_bench', (BENCH_B, TRAIN_SEQ, TRAIN_HQ,
                                        TRAIN_HKV, True))
    ) + tuple((('flash_bwd_timing_mesh', b, hq),
               (b, TRAIN_SEQ, hq, hkv, True))
              for b, hq, hkv in MESH_KERNEL_SHAPES) + tuple(
            (('flash_bwd_timing_ring', causal),
             (RING_B, RING_SEQ, TRAIN_HQ, TRAIN_HKV, causal))
            for causal in (True, False)):
        timing = time_flash_bwd(ctx, b, s, hq, hkv, causal)
        ctx[key] = timing
        emit({'phase': 'kernel', 'kernel': 'flash_bwd', 'b': b, 'sq': s,
              'sk': s, 'hq': hq, 'hkv': hkv, 'head_dim': HEAD_DIM,
              'causal': causal, **timing})
    return failures


def build_parent_kernels(parent: str):
    """The kernels of another checkout at ``parent`` (its csrc/), built
    side by side into build/kernels-parent/ and bound to the same C
    interface, for timing beside this checkout's."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import attention as attn
    csrc = os.path.join(parent, 'skypilot_tpu_torch', 'csrc')
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                       'kernels-parent')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = list(pool.map(lambda n: _build.build(n, csrc_dir=csrc,
                                                     build_dir=out),
                              KERNELS))
    emit({'phase': 'kernel', 'parent': parent,
          'build_s': time.perf_counter() - t0})
    libs = dict(zip(KERNELS, map(ctypes.CDLL, paths)))
    return {'flash_fwd': attn.bind_fwd(libs['flash_fwd']),
            'flash_bwd': attn.bind_bwd(libs['flash_bwd'])}


@contextlib.contextmanager
def _kernels_from(libs):
    """Route the wrappers to other libraries (``build_parent_kernels``)
    for the duration of the block."""
    from skypilot_tpu_torch.ops import attention as attn
    saved = attn._flash_lib, attn._flash_bwd_lib
    attn._flash_lib = libs['flash_fwd']
    attn._flash_bwd_lib = libs['flash_bwd']
    try:
        yield
    finally:
        attn._flash_lib, attn._flash_bwd_lib = saved


def _parent_ms(ctx, fn, iters, bound_ms=None, what=''):
    """Device ms of ``fn`` with the parent checkout's kernels, or None."""
    if not ctx.get('parent_libs'):
        return None
    with _kernels_from(ctx['parent_libs']):
        return time_device(fn, iters, bound_ms=bound_ms,
                           what=f'parent {what}')[0]


def time_flash_bwd(ctx, b, s, hq, hkv, causal=True):
    """K2 / plain / library at one shape (the train phase's: b 4, 8192,
    16/8 heads, causal; train_moe's: b 1, 4096, 32/8; the ring's blocks,
    causal and full), inputs rotating over
    two copies (each more bytes than L2). The library call is PyTorch's
    flash-attention backward
    (aten._scaled_dot_product_flash_attention_backward) on KV repeated to
    hq heads, as it takes no GQA: it returns per-query-head dK/dV, which
    K2 sums over the group."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    gen = torch.Generator(device='cuda')
    gen.manual_seed(99)
    d = HEAD_DIM
    scale = d ** -0.5
    sets = []
    for _ in range(2):
        q, k, v = _qkv(gen, b, s, s, hq, hkv, d)
        dout = _qkv(gen, b, s, s, hq, hkv, d)[0]
        out, lse = attn.flash_attention_fwd(q, k, v, causal, scale)
        sets.append((q, k, v, out, lse, dout))
    turn = itertools.count()

    def kernel():
        attn.flash_attention_bwd(*sets[next(turn) % 2], causal, scale)

    bound_ms, bound_by = flash_bwd_bound_ms(b, s, s, hq, hkv, d, causal,
                                            ctx)
    what = f'K2 b {b} x {s}, {hq}/{hkv} heads, causal {causal}'
    kernel_ms, kernel_event_ms = time_device(kernel, iters=10,
                                             bound_ms=bound_ms, what=what)
    parent_ms = _parent_ms(ctx, kernel, 10, bound_ms, what)
    plain_ms = time_device(lambda: _bwd_by_kv_head(*sets[0], causal, scale),
                           iters=2, warmup=1, bound_ms=bound_ms,
                           what=f'plain {what}')[0]
    lib_sets = []
    for q, k, v, _, _, dout in sets:
        qt, dot = q.transpose(1, 2), dout.transpose(1, 2)
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale)
        lib_sets.append((dot, qt, kt, vt, fwd[:8]))

    def library():
        dot, qt, kt, vt, fwd = lib_sets[next(turn) % 2]
        out, lse, cq, ck, mq, mk, seed, offset = fwd
        torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed,
            offset, scale=scale)

    library_ms, library_event_ms = time_device(
        library, iters=10, bound_ms=bound_ms, what=f'library {what}')
    return {'kernel_ms': kernel_ms, 'kernel_event_ms': kernel_event_ms,
            'parent_ms': parent_ms, 'plain_ms': plain_ms,
            'library_ms': library_ms, 'library_event_ms': library_event_ms,
            'library_call': 'aten._scaled_dot_product_flash_attention_'
                            'backward',
            'bound_ms': bound_ms, 'bound_by': bound_by, 'card': ctx['smi']}


def time_flash(ctx, q, k, v, scale, sets=L2_SETS, plain=None, causal=True):
    """kernel / plain / SDPA device times at one sq == sk shape
    (and the parent checkout's kernel, with --parent). The kernel and
    SDPA take their turns over ``sets`` copies of the inputs, more bytes
    than the 50 MB L2 holds, so each call finds its q/k/v in HBM as a
    prefill does (they come fresh from the projections).
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
        attn.flash_attention_fwd(qi, ki, vi, causal, scale)

    def sdpa():
        qi, ki, vi = (t.transpose(1, 2) for t in copies[next(turn) % sets])
        F.scaled_dot_product_attention(qi, ki, vi, is_causal=causal,
                                       scale=scale, enable_gqa=True)

    iters = 48 if sq <= 2048 else 10
    bound_ms, bound_by = flash_bound_ms(b, sq, sk, hq, hkv, d, causal, ctx)
    what = f'K1 b {b} x {sq} x {sk}, {hq}/{hkv} heads, causal {causal}'
    kernel_ms, kernel_event_ms = time_device(kernel, iters,
                                             bound_ms=bound_ms, what=what)
    parent_ms = _parent_ms(ctx, kernel, iters, bound_ms, what)
    plain_ms = time_device(lambda: plain(q, k, v, causal, scale),
                           iters=5 if sq <= 2048 else 2, warmup=1,
                           bound_ms=bound_ms, what=f'plain {what}')[0]
    library_ms, library_event_ms = time_device(
        sdpa, iters, bound_ms=bound_ms, what=f'SDPA {what}')
    timing = {'kernel_ms': kernel_ms, 'kernel_event_ms': kernel_event_ms,
              'parent_ms': parent_ms, 'plain_ms': plain_ms,
              'library_ms': library_ms, 'library_event_ms': library_event_ms,
              'bound_ms': bound_ms, 'bound_by': bound_by, 'card': ctx['smi']}
    ctx.setdefault('flash_timing', {})[(b, sq, hq, causal)] = timing
    return timing


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp(min=1e-30)).item()


def _rel_update(got, want, init) -> float:
    """Relative L2 between two runs' changes from the same ``init``: 0
    where neither moved, past any limit where only ``got`` did."""
    return _rel_l2(got.float() - init.float(), want.float() - init.float())


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
    fixed = _train_batch(cfg)
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
        ctx['train_losses'] = losses
        # One more step, synced, for the step time without checkpoint
        # copies; then one under torch.profiler for where it goes.
        trainer, state = res['trainer'], res['state']
        step = trainer.step_fn()
        _, step_ms = _wall_ms(lambda: step(state, batch), 1)
        prof = _profile_calls(lambda: step(state, batch), 1, top=12)
        named = _named_policies(ctx, cfg, state, batch)
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
        emit({'phase': 'train', 'check': 'remat_named', 'policies': named,
              'card': ctx['smi']})
        dots_rec = named['dots']
        want_launches = {'flash_fwd': POLICY_CALLS * layers,
                         'flash_bwd': POLICY_CALLS * layers}
        for policy in NAMED_POLICIES:
            rec = named[policy]
            if (rec['loss'] != dots_rec['loss']
                    or abs(rec['grad_norm'] - dots_rec['grad_norm'])
                    > GRAD_NORM_RTOL * dots_rec['grad_norm']
                    or rec['launches'] != want_launches):
                raise RuntimeError(f'remat {policy} off dots: {named}')
        # 'names' keeps on the device what 'names_offload' keeps on the
        # host: the peaks must differ by at least half of it.
        offload = named['names_offload']
        if not (named['names']['peak_mem_gb'] - offload['peak_mem_gb']
                >= offload['pinned_host_gb'] / 2):
            raise RuntimeError(f'names_offload kept its activations on '
                               f'the device: {named}')
        ctx['train_launches'] = {
            k: n + sum(r['launches'][k] for r in named.values())
            for k, n in launches.items()}

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
    warm = _warm_init_check(ctx, cfg)
    emit(warm)
    if (warm['miss'], warm['hit']) != ('initialized', 'restored') \
            or not warm['restored_equal']:
        raise RuntimeError(f'warm-init snapshot: {warm}')
    emit(lm_head_cost(ctx, cfg))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _environ(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _train_batch(cfg):
    """The train phase's fixed batch: [TRAIN_B, TRAIN_SEQ] from seed 7."""
    import torch
    gen = torch.Generator(device='cuda')
    gen.manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_SEQ),
                         device='cuda', generator=gen)


def _ms_per_step(log):
    """Host ms of the synced steps after the first (which warms up)."""
    return [r['seconds'] * 1e3 for r in log[1:]]


def phase_train_mesh(ctx) -> None:
    """The multi-device trainer (``train.run`` on a mesh), as far as one
    card can show it: the rank contract at one process, then two ranks
    sharing the card (see the module docstring)."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.models.llama import PRESETS
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.train import run
    from skypilot_tpu_torch.train.step import get_leaf, leaf_names
    cfg = PRESETS['llama-1b']
    fixed = _train_batch(cfg)
    dots = TRAIN_ARGV + ['--remat', 'dots', '--steps', str(MESH_STEPS)]
    tmp = tempfile.mkdtemp(prefix='chip_smoke_mesh_')
    import multiprocessing
    mp_ctx = multiprocessing.get_context('spawn')
    probes, procs = [], []
    try:
        # Can NCCL put two ranks on the one card? Probed beside the
        # contract run; the two-rank runs below take gloo if it cannot.
        probe_port = _free_port()
        probes = [mp_ctx.Process(target=_nccl_probe_rank,
                                 args=(rank, probe_port, tmp))
                  for rank in range(2)]
        # How gloo moves a CUDA tensor from one rank to the other.
        p2p_port = _free_port()
        p2p_probes = [mp_ctx.Process(target=_gloo_p2p_probe_rank,
                                     args=(rank, p2p_port, tmp))
                      for rank in range(2)]
        probes += p2p_probes
        for proc in probes:
            proc.start()
        want = ctx.get('train_losses')
        if want is None:  # the train phase did not run: its first run
            want = [r['loss'] for r in run.main(
                dots, batch_fn=lambda step: fixed)['log']]
        # The SKYTPU_* contract at one process, --fsdp auto: one device,
        # no process group, the train phase's path bit for bit.
        torch.cuda.empty_cache()
        attn.reset_launch_counts()
        with _environ(SKYTPU_COORDINATOR_ADDR=f'127.0.0.1:{_free_port()}',
                      SKYTPU_NUM_PROCESSES='1', SKYTPU_PROCESS_ID='0'):
            res = run.main(dots + ['--fsdp', 'auto'],
                           batch_fn=lambda step: fixed)
        launches = dict(attn.LAUNCHES)
        contract = {'phase': 'train_mesh', 'check': 'contract_world_1',
                    'losses': [r['loss'] for r in res['log']],
                    'want': want, 'ms_per_step': _ms_per_step(res['log']),
                    'launches': launches, 'card': ctx['smi']}
        emit(contract)
        if contract['losses'] != want:
            raise RuntimeError(f'the contract run at world 1 is not the '
                               f'train phase bit for bit: {contract}')
        # The contract run is the one-device reference: its params after
        # MESH_STEPS steps, and the init every run starts from (train.run
        # at 0 steps), go to the host, files for rank 0 to hold its
        # re-assembled params' change against.
        ref = {'losses': contract['losses'],
               'grad_norms': [r['grad_norm'] for r in res['log']],
               'ms_per_step': contract['ms_per_step'],
               'params': os.path.join(tmp, 'ref.pt'),
               'init': os.path.join(tmp, 'init.pt')}
        init = run.main(dots + ['--steps', '0'],
                        batch_fn=lambda step: fixed)['state'].params
        for params, path in ((res['state'].params, ref['params']),
                             (init, ref['init'])):
            torch.save({n: get_leaf(params, n).detach().cpu()
                        for n in leaf_names(params)}, path)
        del res, params, init
        gc.collect()
        torch.cuda.empty_cache()

        probe = _join_all(probes[:2], 120)
        p2p = _join_all(p2p_probes, 60)
        for rank in range(2):
            for name, rec in (('nccl', probe), ('p2p', p2p)):
                path = os.path.join(tmp, f'{name}{rank}.json')
                if os.path.exists(path):
                    with open(path) as f:
                        rec[f'rank{rank}'] = json.load(f)
        nccl_ok = all(probe.get(f'rank{r}', {}).get('ok') for r in range(2))
        backend = 'nccl' if nccl_ok else 'gloo'
        ctx['mesh_backend'] = backend
        emit({'phase': 'train_mesh', 'check': 'two_ranks_on_one_card',
              'nccl': probe, 'backend': backend, 'gloo_p2p': p2p,
              'card': ctx['smi']})

        # Two ranks on the card.
        port = _free_port()
        procs = [mp_ctx.Process(target=_mesh_rank,
                                args=(rank, port, backend, ref, tmp))
                 for rank in range(2)]
        t0 = time.perf_counter()
        for proc in procs:
            proc.start()
        codes = _join_all(procs, MESH_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        if codes['timed_out'] or any(codes['exitcodes']):
            raise RuntimeError(f'two-rank run: {codes}')
        ranks = []
        for rank in range(2):
            with open(os.path.join(tmp, f'rank{rank}.json')) as f:
                ranks.append(json.load(f))
    finally:
        _join_all(probes + procs, 0)  # stops any left on a failure
        shutil.rmtree(tmp, ignore_errors=True)

    layers = cfg.num_layers
    faults = []
    phase_launches = dict(launches)
    for name, _ in MESH_RUNS:
        recs = [r[name] for r in ranks]
        got = recs[0]
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(got['losses'], ref['losses'])]
        norm_rel = [abs(a - b) / abs(b)
                    for a, b in zip(got['grad_norms'], ref['grad_norms'])]
        rec = {'phase': 'train_mesh', 'mesh': name, 'ranks': 2,
               'backend': backend, 'global_batch': TRAIN_B, 'seq': TRAIN_SEQ,
               'remat': 'dots', 'losses': got['losses'],
               'losses_one_device': ref['losses'], 'loss_rel_err': loss_rel,
               'loss_rtol': GATE_LOSS_RTOL,
               'grad_norms': got['grad_norms'],
               'grad_norms_one_device': ref['grad_norms'],
               'grad_norm_rel_err': norm_rel, 'grad_rtol': GATE_GRAD_RTOL,
               'update_rel_l2': got['update_rel_l2'],
               'update_rtol': MESH_UPDATE_RTOL,
               'unmoved_leaves': got['unmoved'],
               'launches_per_rank': [r['launches'] for r in recs],
               'launches_predicted': [mesh_launches(name, rank, layers)
                                      for rank in range(2)],
               'peak_mem_gb_per_rank': [r['peak_mem_gb'] for r in recs],
               'ms_per_step': got['ms_per_step'],
               'ms_per_step_one_device': ref['ms_per_step'],
               'run_s': got['run_s'],
               'ms_note': 'two ranks share one card (collectives through '
                          'the host under gloo): not a multi-GPU number',
               'card': ctx['smi']}
        emit(rec)
        for r in recs:
            for k, n in r['launches'].items():
                phase_launches[k] += n
        if (max(loss_rel) > GATE_LOSS_RTOL or max(norm_rel) > GATE_GRAD_RTOL
                or max(got['update_rel_l2'].values()) > MESH_UPDATE_RTOL
                or any(r['launches'] != mesh_launches(name, rank, layers)
                       for rank, r in enumerate(recs))
                or any(r['losses'] != got['losses'] for r in recs)):
            faults.append(name)
    emit({'phase': 'train_mesh', 'check': 'collectives_bench', 'ranks': 2,
          'backend': backend, 'allreduce': ranks[0]['bench'],
          'note': 'two ranks on one card through the host: not an '
                  'interconnect number', 'wall_s': wall_s,
          'card': ctx['smi']})
    ctx['mesh_launches'] = phase_launches
    if faults:
        raise RuntimeError(f'train_mesh runs off the one-device trainer: '
                           f'{faults}')


def _join_all(procs, timeout_s: float):
    """Join ``procs`` within ``timeout_s`` in all; kill what is left.
    Returns their exit codes and whether any was still running."""
    deadline = time.monotonic() + timeout_s
    for proc in procs:
        proc.join(max(0.1, deadline - time.monotonic()))
    timed_out = any(proc.is_alive() for proc in procs)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    return {'exitcodes': [proc.exitcode for proc in procs],
            'timed_out': timed_out}


def _nccl_probe_rank(rank: int, port: int, out_dir: str) -> None:
    """One of two ranks in an NCCL group, on card ``rank`` mod the cards
    there are: one all-reduce; its outcome (or the error's first line)
    to out_dir."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank % torch.cuda.device_count())
    rec = {'ok': False}
    try:
        dist.init_process_group(
            'nccl', init_method=f'tcp://127.0.0.1:{port}', world_size=2,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device='cuda')
        dist.all_reduce(x)
        torch.cuda.synchronize()
        rec = {'ok': x.tolist() == [2.0] * 4}
    except Exception as e:  # noqa: BLE001 — the refusal is the finding
        rec['error'] = f'{type(e).__name__}: ' + ' '.join(
            line for line in str(e).splitlines()
            if 'NCCL' in line or 'Duplicate' in line)[:400]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f'nccl{rank}.json'), 'w') as f:
        json.dump(rec, f)


def _gloo_p2p_probe_rank(rank: int, port: int, out_dir: str) -> None:
    """One of two gloo ranks with CUDA tensors, on card ``rank`` mod the
    cards there are: the exchange that ring attention and the pipeline
    make (``sharding.ring_shift``, one ``all_to_all_single`` with split
    sizes) of 64 MiB of bf16, checked and timed; then ``isend``/``irecv``
    of a CUDA tensor, last, since a failure there breaks the pair.
    Outcomes to out_dir."""
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel import MeshSpec, make_mesh, sharding
    from skypilot_tpu_torch.runtime import distributed
    distributed.init(f'127.0.0.1:{port}', 2, rank, device_type='cuda',
                     backend='gloo', timeout_s=30)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh(MeshSpec(sp=2), 'cuda')
    x = torch.full((32 << 20,), float(rank + 1), dtype=torch.bfloat16,
                   device='cuda')
    rec = {'shift_mib': 64, 'shift_ms': []}
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = sharding.ring_shift(x, mesh, 'sp')
        torch.cuda.synchronize()
        rec['shift_ms'].append((time.perf_counter() - t0) * 1e3)
    rec['shift_ok'] = bool((y == float(2 - rank)).all())
    small = x[:8].clone()
    got = torch.zeros_like(small)
    try:
        works = [dist.isend(small, 1 - rank), dist.irecv(got, 1 - rank)]
        for work in works:
            work.wait()
        torch.cuda.synchronize()
        rec['send_recv'] = ('ok' if bool((got == float(2 - rank)).all())
                            else 'wrong values')
    except RuntimeError as e:  # the refusal is the finding
        rec['send_recv'] = f'{type(e).__name__}: {str(e).splitlines()[0]}'
    with open(os.path.join(out_dir, f'p2p{rank}.json'), 'w') as f:
        json.dump(rec, f)
    distributed.shutdown()


def _mesh_rank(rank: int, port: int, backend: str, ref: dict,
               out_dir: str) -> None:
    """One of the two ranks, on card ``rank`` mod the cards there are
    (``backend``: gloo with CUDA tensors where NCCL refuses), then each
    of MESH_RUNS through ``train.run.main`` (the group stays up between
    them), then the collectives bench; results to out_dir."""
    import torch
    from skypilot_tpu_torch.models.llama import PRESETS
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.ops import collectives_bench
    from skypilot_tpu_torch.runtime import distributed
    from skypilot_tpu_torch.train import run
    distributed.init(f'127.0.0.1:{port}', 2, rank, device_type='cuda',
                     backend=backend)
    # A process per rank (the contract's layout is a process per host,
    # whose init took card 0): rank r takes card r mod the cards.
    torch.cuda.set_device(rank % torch.cuda.device_count())
    cfg = PRESETS['llama-1b']
    fixed = _train_batch(cfg)
    out = {}
    for name, flags in MESH_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        res = run.main(TRAIN_ARGV + ['--remat', 'dots', '--steps',
                                     str(MESH_STEPS)] + flags,
                       batch_fn=lambda step: fixed)
        run_s = time.perf_counter() - t0
        launches = dict(attn.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rel, unmoved = _update_rel(res['trainer'], res['state'], ref,
                                   rank)
        out[name] = {'losses': [r['loss'] for r in res['log']],
                     'grad_norms': [r['grad_norm'] for r in res['log']],
                     'ms_per_step': _ms_per_step(res['log']),
                     'launches': launches, 'peak_mem_gb': peak_gb,
                     'run_s': run_s,
                     'update_rel_l2': rel, 'unmoved': unmoved}
        del res
    out['bench'] = collectives_bench.run_bench(
        [1.0, 16.0, 64.0], iters=5, device=torch.device('cuda'),
        verbose=False)
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    distributed.shutdown()


def _update_rel(trainer, state, ref, rank: int):
    """Each leaf's change from the shared init, re-assembled from every
    rank's shard (a collective: every rank calls it), against the
    one-device run's (``ref``'s files), on rank 0: ({leaf: relative L2},
    the leaves the one-device run left unchanged); empty elsewhere."""
    import torch
    from skypilot_tpu_torch.train.step import leaf_names
    full = trainer.model.full_params(state.params)
    rel, unmoved = {}, []
    if rank == 0:
        want, init = (torch.load(ref[k], mmap=True, weights_only=True)
                      for k in ('params', 'init'))
        flat = dict(full, **{f'layers/{k}': v
                             for k, v in full['layers'].items()})
        for n in leaf_names(full):
            dev = flat[n].device
            rel[n] = _rel_update(flat[n], want[n].to(dev), init[n].to(dev))
            if torch.equal(want[n], init[n]):
                unmoved.append(n)
    return rel, unmoved


def _named_policies(ctx, cfg, state, batch):
    """Forward + backward (``Trainer.grads``) under 'dots' and under each
    named policy, from the same state and batch: the first call's loss
    and grad norm; then POLICY_CALLS synced calls, each timed on the
    wall clock, with their peak device memory and kernel launches. The
    pinned host bytes per call follow from the offloaded names' shapes."""
    import dataclasses
    import statistics
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.train.step import Trainer, global_norm
    tokens = batch['tokens'].numel()
    per_token = {'attn_out': cfg.num_heads * cfg.head_dim,
                 'mlp_gated': cfg.mlp_dim}
    out = {}
    for policy in ('dots',) + NAMED_POLICIES:
        trainer = Trainer(llama.LlamaModel(dataclasses.replace(
            cfg, remat=True, remat_policy=policy), device='meta'))
        loss, grads = trainer.grads(state.params, batch)
        rec = {'loss': loss.item(), 'grad_norm': global_norm(grads).item()}
        del grads
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        attn.reset_launch_counts()
        times = []
        for _ in range(POLICY_CALLS):
            t0 = time.perf_counter()
            grads = trainer.grads(state.params, batch)[1]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del grads
        offloaded = llama.NAMED_POLICIES.get(policy, ((), ()))[1]
        pinned = cfg.num_layers * tokens * 2 * sum(per_token[n]
                                                   for n in offloaded)
        rec.update({'calls': POLICY_CALLS, 'fwd_bwd_ms': times,
                    'fwd_bwd_ms_median': statistics.median(times),
                    'fwd_bwd_ms_spread': max(times) - min(times),
                    'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
                    'pinned_host_gb': pinned / 1e9,
                    'launches': dict(attn.LAUNCHES)})
        out[policy] = rec
    return out


def _warm_init_check(ctx, cfg):
    """The warm-init snapshot at llama-1b: a miss (init + snapshot
    write), a plain init, and a restore, each on a fresh model; the
    restored state must equal the first one bit for bit."""
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.models.llama import LlamaModel
    from skypilot_tpu_torch.train.step import Trainer, get_leaf, leaf_names

    def seeded():
        gen = torch.Generator(device='cuda')
        gen.manual_seed(0)
        return gen

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix='chip_smoke_warm_')
    try:
        trainer = Trainer(LlamaModel(cfg, device='cuda'))
        (state, miss), miss_s = timed(
            lambda: trainer.init_with_warm_cache(tmp, seeded()))
        names = leaf_names(state.params)
        want = {n: get_leaf(state.params, n).detach().clone()
                for n in names}
        del trainer, state
        trainer = Trainer(LlamaModel(cfg, device='cuda'))
        _, init_s = timed(lambda: trainer.init_fn()(seeded()))
        del trainer
        trainer = Trainer(LlamaModel(cfg, device='cuda'))
        (state, hit), restore_s = timed(
            lambda: trainer.init_with_warm_cache(tmp, seeded()))
        same = all(torch.equal(get_leaf(state.params, n), want[n])
                   for n in names)
        snapshot = sum(os.path.getsize(os.path.join(root, f))
                       for root, _, files in os.walk(tmp) for f in files)
        key = trainer.warm_cache_key()
        del trainer, state, want
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {'phase': 'train', 'check': 'warm_init', 'key': key,
            'miss': miss, 'hit': hit, 'miss_s': miss_s, 'init_s': init_s,
            'restore_s': restore_s, 'snapshot_bytes': snapshot,
            'restored_equal': same, 'card': ctx['smi']}


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


def _run_wave(base, bodies, sched=None):
    """POST every body concurrently; [(status, reply)] in order. With
    ``sched``, its admission is held until all of them are queued, so
    that the scheduler drains them in one round (as a wave of arrivals
    during a long dispatch would be)."""
    results = [None] * len(bodies)
    errors = []

    def one(i, body):
        try:
            results[i] = _post(base, body)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f'request {i}: {e!r}')

    threads = [threading.Thread(target=one, args=(i, b))
               for i, b in enumerate(bodies)]
    if sched is not None:
        sched._admit = lambda: None  # held: requests queue up
    try:
        for t in threads:
            t.start()
        if sched is not None:
            t0 = time.perf_counter()
            while sched._pending.qsize() < len(bodies):
                if errors or time.perf_counter() - t0 > 120:
                    raise RuntimeError(f'wave never queued: {errors}')
                time.sleep(0.005)
    finally:
        if sched is not None:
            del sched._admit
            sched._wake.set()
    for t in threads:
        t.join(timeout=900)
    if errors or any(r is None for r in results):
        raise RuntimeError(f'requests failed: {errors}')
    return results


@contextlib.contextmanager
def _replica(sched):
    """Start ``sched`` behind a GenerationServer on a free local port
    and wait for /health; yields (base url, seconds to healthy). Stops
    the server and both scheduler threads on the way out."""
    from skypilot_tpu_torch.serve import generation_server as gs
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
        yield base, time.perf_counter() - t0
    finally:
        server.shutdown()
        sched._thread.join(timeout=60)
        sched._emit_thread.join(timeout=60)
        http.join(timeout=60)
    if sched._thread.is_alive() or sched._emit_thread.is_alive():
        raise RuntimeError('scheduler threads did not stop')


def _get(base, path):
    with urllib.request.urlopen(f'{base}{path}', timeout=120) as resp:
        return resp.read().decode()


def _metric(text: str, name: str) -> float:
    """The sum of a Prometheus series' samples in a /metrics text."""
    return sum(float(ln.rsplit(' ', 1)[1]) for ln in text.splitlines()
               if ln.split('{')[0].split(' ')[0] == name)


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
    with _replica(sched) as (base, warm_s):
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


def _modes_wave(base, sched, wave, n_new):
    """The same-bucket wave through the replica, held until all four are
    queued: the replies, and the K1 launches, engine variants and
    prefill tokens it added (one admit_many: num_layers launches)."""
    from skypilot_tpu_torch.ops import attention as attn
    before = _get(base, '/metrics')
    launched = dict(attn.LAUNCHES)
    replies = _run_wave(base, [dict(tokens=p, max_tokens=n_new,
                                    temperature=0.0) for p in wave], sched)
    launches = {k: n - launched[k] for k, n in attn.LAUNCHES.items()}
    after = _get(base, '/metrics')
    for i, (status, reply) in enumerate(replies):
        if status != 200 or reply.get('error') or \
                len(reply['tokens']) != n_new:
            raise RuntimeError(f'bad wave reply {i}: {status} {reply}')
    delta = {name: _metric(after, name) - _metric(before, name)
             for name in ('skytpu_engine_recompiles_total',
                          'skytpu_engine_prefill_tokens_total')}
    return [r['tokens'] for _, r in replies], launches, delta


def _int8_logits_check(eng_b, eng_q, params, toks, lens, steps):
    """Teacher-forced along the bf16 stream: admit the wave into a bf16
    and an int8 engine, then at every step compare the int8 pool's
    logits with bf16's from the same tokens (relative L2 per slot), and
    where the greedy tokens part, bf16's top-2 margin beside the largest
    logit difference."""
    import torch
    n = len(lens)
    states = []
    for eng in (eng_b, eng_q):
        gen = torch.Generator(device=eng.device)
        gen.manual_seed(0)
        st, firsts, _ = eng.admit_many(params, eng.init_state(), toks, lens,
                                       list(range(n)), gen, [0.0] * n,
                                       [0] * n)
        states.append((st, firsts))
    (st_b, first_b), (st_q, first_q) = states
    worst, agree, parted = 0.0, 0, []
    for step in range(steps):
        lb = eng_b._step_logits(params, st_b)[:n]
        lq = eng_q._step_logits(params, st_q)[:n]
        rel = ((lq - lb).norm(dim=-1) / lb.norm(dim=-1)).max().item()
        worst = max(worst, rel)
        top2 = lb.topk(2, dim=-1).values
        tok_b, tok_q = lb.argmax(-1), lq.argmax(-1)
        agree += int((tok_b == tok_q).sum())
        for slot in (tok_b != tok_q).nonzero().flatten().tolist():
            parted.append({
                'step': step, 'slot': slot,
                'bf16_top2_margin': (top2[slot, 0] - top2[slot, 1]).item(),
                'max_abs_logit_diff': (lq[slot] - lb[slot]).abs().max()
                .item()})
        for st in (st_b, st_q):
            st.lengths.add_(st.active.long())
            st.last_tokens[:n] = tok_b
    return {'first_tokens_same': bool(torch.equal(first_b, first_q)),
            'logits_rel_l2_max': worst, 'logits_rtol': INT8_LOGIT_RTOL,
            'teacher_forced_agreement': agree / (steps * n),
            'parted': parted}


def _drive_engine(eng, params, toks, lens, steps, verifies):
    """admit_many of the wave into slots 0..n-1, ``steps`` plain steps
    and ``verifies`` verify steps drafting by prompt lookup; every token
    and accept count, in order."""
    import torch
    from skypilot_tpu_torch.models.decode import draft_tokens
    n = len(lens)
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    state, firsts, gen = eng.admit_many(params, eng.init_state(), toks,
                                        lens, list(range(n)), gen,
                                        [0.0] * n, [0] * n)
    log = [firsts.tolist()]
    hist = [list(p[:ln]) + [t] for p, ln, t in zip(toks, lens, log[0])]
    for _ in range(steps):
        state, sampled, gen = eng.step(params, state, gen)
        log.append(sampled[:n].tolist())
        for h, t in zip(hist, log[-1]):
            h.append(t)
    k = eng.spec_tokens
    for _ in range(verifies):
        draft = [draft_tokens(h, k) for h in hist] + \
            [[0] * k] * (eng.batch_slots - n)
        state, out, acc, gen = eng.step_verify(params, state, gen, draft)
        out, acc = out[:n].tolist(), acc[:n].tolist()
        log.append(out + [acc])
        for h, o, a in zip(hist, out, acc):
            h.extend(o[:a + 1])
    return log


def _admit_many_vs_solo(eng, params, toks, lens):
    """One admit_many of the wave against as many solo admits into the
    same slots (the engine's auto tables, so the same blocks): first
    tokens, and every layer's pool rows by the JAX test's allclose."""
    import torch
    n = len(lens)
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    solo = eng.init_state()
    firsts = []
    for slot in range(n):
        solo, first, gen = eng.admit(params, solo, toks[slot], lens[slot],
                                     slot, gen)
        firsts.append(int(first))
    many, fused, gen = eng.admit_many(params, eng.init_state(), toks, lens,
                                      list(range(n)), gen, [0.0] * n,
                                      [0] * n)
    worst, excess = 0.0, -1.0
    for pool in ('k', 'v'):
        for layer in range(eng.config.num_layers):
            a = getattr(many, pool)[layer].float()
            b = getattr(solo, pool)[layer].float()
            diff = (a - b).abs()
            worst = max(worst, diff.max().item())
            excess = max(excess, (diff - ADMIT_KV_TOL
                                  - ADMIT_KV_TOL * b.abs()).max().item())
    return {'firsts_same': fused.tolist() == firsts,
            'kv_max_abs_diff': worst, 'kv_allclose': excess <= 0.0,
            'kv_tol': ADMIT_KV_TOL,
            'bookkeeping_same': all(
                torch.equal(getattr(many, f), getattr(solo, f))
                for f in ('lengths', 'active', 'last_tokens',
                          'block_tables'))}


def phase_serve_modes(ctx) -> None:
    """llama3-8b at full width through the replica with int8 KV and fused
    admission of 4, and the contiguous and paged engines, all on one set
    of random weights (seed 0)."""
    import gc
    import numpy as np
    import torch
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.serve import generation_server as gs

    saved_env = os.environ.get('SKYTPU_ADMIT_BATCH')
    os.environ['SKYTPU_ADMIT_BATCH'] = str(len(MODES_WAVE))
    try:
        t0 = time.perf_counter()
        sched_q = gs.build_scheduler(gs.build_parser().parse_args(
            MODES_ARGV))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sched_b = gs.GenerationScheduler(
            sched_q.config, sched_q.params,
            batch_slots=sched_q.engine.batch_slots,
            max_len=sched_q.engine.max_len, model=sched_q.engine.model,
            kv_block=sched_q.engine.kv_block, kv_dtype='bf16',
            device=sched_q.device)
    finally:
        if saved_env is None:
            os.environ.pop('SKYTPU_ADMIT_BATCH')
        else:
            os.environ['SKYTPU_ADMIT_BATCH'] = saved_env
    cfg, params, model = sched_q.config, sched_q.params, sched_q.engine.model
    layers = cfg.num_layers
    rng = np.random.default_rng(4)
    wave = [rng.integers(0, cfg.vocab_size, n).tolist() for n in MODES_WAVE]
    longp = rng.integers(0, cfg.vocab_size, MODES_LONG).tolist()
    shared = longp[:MODES_SHARED] + rng.integers(0, cfg.vocab_size,
                                                 100).tolist()
    eng_q = sched_q.engine
    rec = {'phase': 'serve_modes', 'preset': 'llama3-8b',
           'batch_slots': eng_q.batch_slots, 'max_len': eng_q.max_len,
           'kv_block': eng_q.kv_block,
           'admit_batch': sched_q.ADMIT_BATCH_MAX, 'init_s': init_s}
    torch.cuda.reset_peak_memory_stats()
    attn.reset_launch_counts()
    total = {name: 0 for name in attn.LAUNCHES}

    def read_launches():
        for name, n in attn.LAUNCHES.items():
            total[name] += n
        attn.reset_launch_counts()

    # (a) The int8 replica: a 1500-token prompt alone (solo admit), the
    # wave through ONE admit_many, then a prompt sharing the first 1024
    # tokens (a prefix hit on int8 blocks). Then the bf16 replica on the
    # same weights takes the same wave.
    streams = {}
    with _replica(sched_q) as (base, warm_s):
        rec['warm_s'] = warm_s
        status, reply = _post(base, dict(tokens=longp, max_tokens=8,
                                         temperature=0.0))
        if status != 200 or reply.get('error'):
            raise RuntimeError(f'int8 replica failed: {reply}')
        t0 = time.perf_counter()
        streams['int8'], wave_launches, delta = _modes_wave(
            base, sched_q, wave, MODES_NEW)
        rec['wave_s'] = time.perf_counter() - t0
        hits0 = json.loads(_get(base, '/stats'))['prefix_hit_tokens']
        status, reply = _post(base, dict(tokens=shared, max_tokens=8,
                                         temperature=0.0))
        stats = json.loads(_get(base, '/stats'))
        metrics = _get(base, '/metrics')
        read_launches()
    rec.update({
        'wave_flash_fwd_launches': wave_launches['flash_fwd'],
        'wave_want': layers, 'wave_metrics_delta': delta,
        'admit_many_variant': f'admit_many:{len(wave)}x{MODES_BUCKET}'
        in eng_q.profiler._variant_labels.values(),
        'prefix_hit_tokens': stats['prefix_hit_tokens'] - hits0,
        'prefix_reply_ok': status == 200 and not reply.get('error'),
        'kv_dtype': stats['kv_dtype'],
        'quant_scale_samples': _metric(
            metrics, 'skytpu_engine_kv_quant_scale_ratio_count'),
        'hbm': {k: stats['hbm'][k] for k in ('kv_code_pool',
                                             'kv_scale_pool')}})
    with _replica(sched_b) as (base, _):
        streams['bf16'], _, _ = _modes_wave(base, sched_b, wave, MODES_NEW)
        read_launches()
    rec['kv_bytes_per_token'] = {
        'bf16': sched_b.engine.kv_bytes_per_token(),
        'int8': eng_q.kv_bytes_per_token()}
    per_head = 2 * layers * cfg.num_kv_heads
    want_bytes = {'bf16': per_head * cfg.head_dim * cfg.dtype.itemsize,
                  'int8': per_head * (cfg.head_dim + 4)}
    bf16, int8 = streams['bf16'], streams['int8']
    n_tok = sum(len(s) for s in bf16)
    rec['greedy_tokens'] = n_tok
    rec['greedy_agreement'] = sum(
        a == b for sb, si in zip(bf16, int8) for a, b in zip(sb, si)) / n_tok
    rec['first_tokens_same'] = [s[0] for s in int8] == [s[0] for s in bf16]
    rec['greedy_agreement_gated'] = False  # see INT8_AGREE_MIN
    rec['parted_at'] = [next((j for j, (a, b) in enumerate(zip(sb, si))
                              if a != b), None)
                        for sb, si in zip(bf16, int8)]
    geometry = dict(batch_slots=eng_q.batch_slots, max_len=eng_q.max_len,
                    model=model, spec_tokens=4, device=model.device)
    block = eng_q.kv_block
    del sched_q, sched_b, eng_q
    gc.collect()
    torch.cuda.empty_cache()

    # (b), (c) and the logits check, engine by engine on the same weights.
    toks = [p + [0] * (MODES_BUCKET - len(p)) for p in wave]
    lens = [len(p) for p in wave]
    paged = decode.DecodeEngine(cfg, kv_block=block, kv_dtype='bf16',
                                **geometry)
    contiguous = decode.DecodeEngine(cfg, kv_block=0, kv_dtype='bf16',
                                     **geometry)
    log_p = _drive_engine(paged, params, toks, lens, 24, 4)
    log_c = _drive_engine(contiguous, params, toks, lens, 24, 4)
    rec['contiguous_equals_paged'] = log_c == log_p
    rec['contiguous_drive'] = {'admit_many': len(wave), 'steps': 24,
                               'verify_steps': 4}
    del contiguous
    torch.cuda.empty_cache()
    rec['admit_many_vs_solo'] = _admit_many_vs_solo(paged, params, toks,
                                                    lens)
    quant = decode.DecodeEngine(cfg, kv_block=block, kv_dtype='int8',
                                **geometry)
    rec['int8_logits'] = _int8_logits_check(paged, quant, params, toks,
                                            lens, MODES_NEW)
    read_launches()
    rec['launches'] = dict(total)
    rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    rec['card'] = ctx['smi']
    emit(rec)
    ctx['modes_launches'] = dict(total)
    faults = []
    if rec['wave_flash_fwd_launches'] != layers:
        faults.append('the wave did not go through one admit_many')
    if not rec['admit_many_variant'] or delta[
            'skytpu_engine_prefill_tokens_total'] != len(wave) * MODES_BUCKET:
        faults.append('admit_many variant or prefill tokens missing')
    if rec['prefix_hit_tokens'] < MODES_SHARED or \
            not rec['prefix_reply_ok']:
        faults.append('no prefix hit on the int8 replica\'s blocks')
    if rec['kv_bytes_per_token'] != want_bytes:
        faults.append('kv_bytes_per_token')
    if not rec['quant_scale_samples']:
        faults.append('no quant-scale samples in /metrics')
    if n_tok < 128 or not rec['first_tokens_same']:
        faults.append('int8 first tokens differ from bf16')
    logits = rec['int8_logits']
    if (not logits['first_tokens_same']
            or logits['logits_rel_l2_max'] > INT8_LOGIT_RTOL
            or logits['teacher_forced_agreement'] < INT8_AGREE_MIN
            or any(p['bf16_top2_margin'] >= p['max_abs_logit_diff']
                   for p in logits['parted'])):
        faults.append('int8 logits off bf16')
    if not rec['contiguous_equals_paged']:
        faults.append('contiguous streams differ from paged')
    solo = rec['admit_many_vs_solo']
    if not (solo['firsts_same'] and solo['kv_allclose']
            and solo['bookkeeping_same']):
        faults.append('admit_many differs from solo admits')
    if not total['flash_fwd']:
        faults.append('K1 never launched on the serve_modes path')
    if faults:
        raise RuntimeError(f'serve_modes: {faults}')


@contextlib.contextmanager
def _moe_depth(layers: int):
    """The MOE_PRESET config with its depth cut to ``layers``, for the
    entry points (which read the preset by name) inside the block."""
    import dataclasses
    from skypilot_tpu_torch.models import mixtral
    full = mixtral.PRESETS[MOE_PRESET]
    mixtral.PRESETS[MOE_PRESET] = dataclasses.replace(full,
                                                      num_layers=layers)
    try:
        yield mixtral.PRESETS[MOE_PRESET]
    finally:
        mixtral.PRESETS[MOE_PRESET] = full


@contextlib.contextmanager
def _routing_log(choices: bool = False):
    """Every ``ops.moe.top_k_routing`` call inside the block, in order:
    tokens N, capacity C, aux loss and dropped fraction (device scalars;
    on a mesh, of the global batch); with ``choices``, each token's
    experts [N, k] as the router picks them (ties to the lower index; on
    a mesh, this rank's tokens)."""
    import torch
    from skypilot_tpu_torch.ops import moe
    plain = moe.top_k_routing
    log = []

    def recorded(logits, top_k, capacity, **mesh):
        out = plain(logits, top_k, capacity, **mesh)
        entry = {'n': logits.shape[0], 'capacity': capacity,
                 'aux_loss': out[2]['aux_loss'].detach(),
                 'dropped': out[2]['dropped_frac']}
        if choices:
            entry['logits'] = logits.detach().float()
            probs = torch.softmax(entry['logits'], dim=-1)
            entry['choice'] = torch.sort(probs, dim=-1, descending=True,
                                         stable=True).indices[:, :top_k]
        log.append(entry)
        return out
    moe.top_k_routing = recorded
    try:
        yield log
    finally:
        moe.top_k_routing = plain


def _first_flip(ref_log, ref_row: int, got_log, got_row: int):
    """The first layer where one token's experts differ between two runs
    (logs of one dispatch each, the token at a row of each): the
    reference router's smallest gap among its top k + 1 logits there and
    the largest difference between the two runs' router logits for the
    token (two experts swap only if their gap is below twice that); None
    when they never differ."""
    import torch
    for layer, (a, b) in enumerate(zip(ref_log, got_log)):
        if torch.equal(a['choice'][ref_row], b['choice'][got_row]):
            continue
        ref, got = a['logits'][ref_row], b['logits'][got_row]
        top = ref.sort(descending=True).values[:a['choice'].shape[1] + 1]
        return {'layer': layer,
                'router_gap': (top[:-1] - top[1:]).min().item(),
                'router_max_abs_diff': (got - ref).abs().max().item()}
    return None


def _routing_differs(log_a, log_b) -> int:
    """(token, choice) pairs whose expert differs between two runs of the
    same dispatches."""
    return sum(int((a['choice'] != b['choice']).sum())
               for a, b in zip(log_a, log_b))


def _drop_record(log):
    import torch
    return {'tokens': log[0]['n'], 'capacity': log[0]['capacity'],
            'dropped_frac_layer0': float(log[0]['dropped']),
            'dropped_frac_mean': float(torch.stack(
                [e['dropped'] for e in log]).mean())}


def _agree(ref, got, ref_at, got_at):
    """One teacher-forced position: logits [V] of the reference and of the
    path under test, and (routing log, row) of the token in each."""
    top2 = ref.topk(2).values
    return {'same': int(ref.argmax()) == int(got.argmax()),
            'margin': (top2[0] - top2[1]).item(),
            'max_abs_diff': (got - ref).abs().max().item(),
            'rel_l2': _rel_l2(got, ref),
            'first_flip': _first_flip(*ref_at, *got_at)}


def _agree_summary(recs):
    """(record, ok) of a list of ``_agree`` positions (MOE_EQUIV_CF)."""
    parted = [r for r in recs if not r['same']]
    flipped = [r for r in recs if r['first_flip']]
    same_route = [r for r in recs if not r['first_flip']]
    ok = (all(r['margin'] <= r['max_abs_diff'] for r in parted)
          and all(r['rel_l2'] <= LOGIT_RTOL for r in same_route)
          and len(flipped) <= MOE_ROUTED_OTHERWISE_MAX * len(recs))
    return {'positions': len(recs), 'same_tokens': len(recs) - len(parted),
            'parted': parted,
            'rel_l2_max_same_routing': max(
                [r['rel_l2'] for r in same_route], default=None),
            'rel_l2_max': max(r['rel_l2'] for r in recs),
            'positions_routed_otherwise': len(flipped),
            'first_flips': [r['first_flip'] for r in flipped],
            'logits_rtol': LOGIT_RTOL, 'ok': ok}, ok


def _moe_equivalence(eng, model, params, prompt, n):
    """The equivalence gates on ``eng`` (capacity factor MOE_EQUIV_CF),
    one prompt in slot 0, ``n`` positions: the engine's greedy stream
    (its prefill, then plain steps) against the ``decode_step`` oracle,
    teacher forced along it; verify steps drafting that stream against
    the plain steps' logits (speculative on = off); the free-running
    speculative stream twice (a repeat reproduces)."""
    import torch
    from skypilot_tpu_torch.models import decode
    c, dev, k_spec = eng.config, eng.device, eng.spec_tokens
    bucket = decode.prefill_bucket(len(prompt), eng.max_len)
    padded = list(prompt) + [0] * (bucket - len(prompt))
    last = len(prompt) - 1

    def admitted():
        eng.reset_kv()
        state = eng.init_state()
        with _routing_log(choices=True) as log:
            k, v, logits = eng.prefill(params, padded, len(prompt))
        first = int(logits.argmax())
        state = eng.insert(state, k, v, len(prompt), first, 0)
        return state, logits, first, (log, last)

    # The plain stream and the oracle, teacher forced along the former.
    state, logits, first, routes = admitted()
    toks, plain = [first], [(logits, routes)]
    shape = (c.num_layers, 1, len(prompt) + n, c.num_kv_heads, c.head_dim)
    cache = {'k': torch.zeros(shape, dtype=c.dtype, device=dev),
             'v': torch.zeros(shape, dtype=c.dtype, device=dev),
             'length': 0}
    with _routing_log(choices=True) as log:
        logits, cache = model.decode_step(
            params, cache, torch.tensor([list(prompt)], device=dev))
    oracle = [(logits[0], (log, last))]
    for _ in range(1, n):
        with _routing_log(choices=True) as log:
            logits = eng._step_logits(params, state)[0]
        plain.append((logits, (log, 0)))
        with _routing_log(choices=True) as log:
            ref, cache = model.decode_step(
                params, cache, torch.tensor([[toks[-1]]], device=dev))
        oracle.append((ref[0], (log, 0)))
        toks.append(int(logits.argmax()))
        state.lengths[0] += 1
        state.last_tokens[0] = toks[-1]
    oracle_rec, oracle_ok = _agree_summary(
        [_agree(o[0], p[0], o[1], p[1]) for o, p in zip(oracle, plain)])

    # Verify steps drafting the plain stream: rows 0..K of a verify from
    # position ``pos`` hold the logits the plain steps gave at pos..pos+K.
    state = admitted()[0]
    spec, pos = [], 1
    while pos < n:
        draft = torch.zeros((eng.batch_slots, k_spec), dtype=torch.long,
                            device=dev)
        draft[0] = torch.tensor(toks[pos:pos + k_spec], device=dev)
        with _routing_log(choices=True) as log:
            logits = eng._verify_logits(params, state, draft)[0]
        for j in range(min(k_spec + 1, n - pos)):
            spec.append(_agree(plain[pos + j][0], logits[j],
                               plain[pos + j][1], (log, j)))
        state.lengths[0] += k_spec + 1
        state.last_tokens[0] = toks[pos + k_spec]
        pos += k_spec + 1
    spec_rec, spec_ok = _agree_summary(spec)

    def spec_stream():
        state, _, first, _ = admitted()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        out, hist = [first], list(prompt) + [first]
        while len(out) < n:
            draft = [decode.draft_tokens(hist, k_spec)] + \
                [[0] * k_spec] * (eng.batch_slots - 1)
            state, emitted, acc, gen = eng.step_verify(params, state, gen,
                                                       draft)
            new = emitted[0, :int(acc[0]) + 1].tolist()
            out += new
            hist += new
        return out[:n]

    stream, again = spec_stream(), spec_stream()
    return {'capacity_factor': c.capacity_factor, 'prompt_tokens':
            len(prompt), 'positions': n, 'oracle': oracle_rec,
            'spec_vs_plain': spec_rec, 'plain_stream': toks,
            'spec_stream_equals_plain': stream == toks,
            'repeat_equal': stream == again}, \
        oracle_ok and spec_ok and stream == again


def phase_serve_moe(ctx) -> None:
    """mixtral-8x7b at full width (16 of its 32 layers) through the
    replica's own entry points at the preset's capacity factor 1.25: the
    serve phase's traffic over HTTP. Then, on the same weights: layer 0's
    dropped fraction for each dispatch kind, the prefill logits through
    K1 against the same forward with the reference attention, and the
    equivalence gates on a second engine at MOE_EQUIV_CF."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from skypilot_tpu_torch.models import decode, mixtral
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.serve import generation_server as gs
    with _moe_depth(MOE_SERVE_LAYERS):
        t0 = time.perf_counter()
        sched = gs.build_scheduler(gs.build_parser().parse_args(
            MOE_SERVE_ARGV))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    cfg, params, eng = sched.config, sched.params, sched.engine
    layers = cfg.num_layers
    faults = []
    router = params['layers']['router']
    if router.dtype != torch.float32 or not torch.equal(
            router, router.to(cfg.dtype).float()):
        faults.append('the router is not its bf16 rounding upcast to f32')
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    p100, p600, p1500, p50 = prompt(100), prompt(600), prompt(1500), \
        prompt(50)
    shared = p1500[:1024] + prompt(176)
    n_new = 32

    def body(tokens, **kw):
        return dict(tokens=tokens, max_tokens=n_new, temperature=0.0, **kw)

    with _replica(sched) as (base, warm_s):
        attn.reset_launch_counts()
        t_run = time.perf_counter()
        # As the serve phase: three prefill buckets and a stream, then a
        # prefix hit (no K1: the chunk attends through the pool) and a
        # repeat of the streamed prompt.
        wave1 = _run_wave(base, [body(p100), body(p600), body(p1500),
                                 body(p50, stream=True)])
        wave2 = _run_wave(base, [body(shared), body(p50)])
        run_s = time.perf_counter() - t_run
        launches = dict(attn.LAUNCHES)
        stats = json.loads(_get(base, '/stats'))
    replies = wave1 + wave2
    for i, (status, reply) in enumerate(replies):
        toks = reply['tokens']
        if status != 200 or reply.get('error') or len(toks) != n_new \
                or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f'bad reply {i}: {status} {reply}')
    want_launches = {'flash_fwd': MOE_MONOLITHIC * layers, 'flash_bwd': 0}
    if launches != want_launches:
        faults.append(f'the traffic launched {launches}, the prefills '
                      f'predict {want_launches}')
    if not stats.get('prefix_hit_tokens'):
        faults.append('no prefix-cache hit')
    ctx['moe_serve_launches'] = launches
    rec = {'phase': 'serve_moe', 'preset': MOE_PRESET, 'layers': layers,
           'params': cfg.num_params, 'active_params': cfg.active_params,
           'capacity_factor': cfg.capacity_factor,
           'batch_slots': eng.batch_slots, 'max_len': eng.max_len,
           'kv_block': eng.kv_block, 'spec_tokens': eng.spec_tokens,
           'init_s': init_s, 'warm_s': warm_s, 'requests': len(replies),
           'tokens_out': sum(len(r['tokens']) for _, r in replies),
           'run_s': run_s, 'ttft_ms': sorted(r['ttft_ms']
                                             for _, r in replies),
           'launches': launches, 'launches_want': want_launches,
           'prefix_hit_tokens': stats['prefix_hit_tokens'],
           # At 1.25 a reply depends on what shared its dispatches.
           'repeat_equal_ungated': wave2[1][1]['tokens']
           == wave1[3][1]['tokens']}
    rec['tokens_per_s'] = rec['tokens_out'] / run_s

    # Layer 0's dropped fraction per dispatch kind, on a state of its own:
    # a 1536 prefill into slot 0, a 600-token prompt in two chunks into
    # slot 1, a plain step and a K-4 verify step over the 8 slots.
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(0)
    k_spec = eng.spec_tokens
    drops = {}
    with torch.no_grad():
        eng.reset_kv()
        state = eng.init_state()
        with _routing_log() as log:
            state, _, gen = eng.admit(params, state, p1500 + [0] * 36, 1500,
                                      0, gen)
        drops['prefill'] = _drop_record(log)
        with _routing_log() as log:
            state = eng.prefill_chunk(params, state, p600[:512], 0, 1)
        drops['chunk'] = _drop_record(log)
        with _routing_log() as log:
            state, _, gen = eng.prefill_chunk_final(
                params, state, p600[512:] + [0] * 40, 512, 1, 600, gen)
        drops['chunk_final'] = _drop_record(log)
        with _routing_log() as log:
            state, _, gen = eng.step(params, state, gen)
        drops['step'] = _drop_record(log)
        draft = [decode.draft_tokens(p1500, k_spec),
                 decode.draft_tokens(p600, k_spec)] + \
            [[0] * k_spec] * (eng.batch_slots - 2)
        with _routing_log() as log:
            eng.step_verify(params, state, gen, draft)
        drops['verify'] = _drop_record(log)
        del state
        rec['dropped'] = drops

        # Prefill logits through K1 against the same forward (the same
        # 128 padded rows, so the same dispatch) with reference attention.
        padded = p100 + [0] * 28
        with _routing_log(choices=True) as log_k:
            _, _, logits = eng.prefill(params, padded, len(p100))
        with _routing_log(choices=True) as log_r:
            ref = eng.model.apply(params, torch.tensor([padded],
                                                       device=eng.device),
                                  force_impl='reference')[0, len(p100) - 1]
        rel = _rel_l2(logits, ref)
        rec.update({'logits_rel_l2_err': rel, 'logits_rtol': LOGIT_RTOL,
                    'logits_argmax_same': bool(logits.argmax()
                                               == ref.argmax()),
                    'routing_choices_differ': _routing_differs(log_k, log_r),
                    'routing_choices': layers * len(padded) * cfg.top_k,
                    'logits_token_first_flip': _first_flip(
                        log_r, len(p100) - 1, log_k, len(p100) - 1)})
        if not (rel <= LOGIT_RTOL and rec['logits_argmax_same']
                and bool(torch.isfinite(logits).all())):
            faults.append(f'prefill logits off the reference: rel {rel}')

        # The equivalence gates at MOE_EQUIV_CF on the same weights.
        geometry = dict(batch_slots=eng.batch_slots, max_len=eng.max_len,
                        kv_block=eng.kv_block, spec_tokens=eng.spec_tokens,
                        device=eng.device)
        del sched, eng
        gc.collect()
        torch.cuda.empty_cache()
        cfg4 = dataclasses.replace(cfg, capacity_factor=MOE_EQUIV_CF)
        model4 = mixtral.MixtralModel(cfg4, device='meta')
        eng4 = decode.DecodeEngine(cfg4, model=model4, **geometry)
        equiv, ok = _moe_equivalence(eng4, model4, params, p100,
                                     MOE_ORACLE_TOKENS)
        rec['equivalence'] = equiv
        if not ok:
            faults.append('equivalence gates at capacity factor '
                          f'{MOE_EQUIV_CF}')
        del eng4
    rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    rec['card'] = ctx['smi']
    emit(rec)
    if faults:
        raise RuntimeError(f'serve_moe: {faults}')


def phase_train_moe(ctx) -> None:
    """mixtral-8x7b at full width (4 of its 32 layers) through
    ``train.run.main``: 3 full-remat steps on one fixed batch (seed 7),
    with the aux loss, tokens/s and MFU (active params) per step and the
    K1/K2 launches per step; a profiled step; one forward + backward each
    under 'full', 'dots' and 'names' from the same state; loss and grads
    through K1/K2 against the reference attention."""
    import dataclasses
    import torch
    from skypilot_tpu_torch.models import mixtral
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.train import run
    from skypilot_tpu_torch.train.step import (Trainer, cross_entropy_loss,
                                               get_leaf, global_norm,
                                               leaf_names)
    faults = []
    with _moe_depth(MOE_TRAIN_LAYERS) as cfg:
        layers = cfg.num_layers
        gen = torch.Generator(device=_device_of(MOE_TRAIN_ARGV))
        gen.manual_seed(7)
        fixed = torch.randint(0, cfg.vocab_size, (MOE_TRAIN_B,
                                                  MOE_TRAIN_SEQ),
                              device=gen.device, generator=gen)
        batch = {'tokens': fixed, 'targets': torch.roll(fixed, -1, dims=1)}
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        with _routing_log() as log:
            res = run.main(MOE_TRAIN_ARGV + ['--steps', '3'],
                           batch_fn=lambda step: fixed)
        run_s = time.perf_counter() - t0
    launches = dict(attn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res['log']
    losses = [r['loss'] for r in steps]
    if len(losses) != 3 or not all(map(math.isfinite, losses)) \
            or not losses[2] < losses[0]:
        faults.append(f'losses not finite and falling: {losses}')
    # 'full': per step K1 runs in the forward and again in the backward's
    # recompute, K2 once, in every layer.
    want = {'flash_fwd': 3 * 2 * layers, 'flash_bwd': 3 * layers}
    if launches != want:
        faults.append(f'3 steps launched {launches}, want {want}')
    per_step = len(log) // 3  # forward + recompute, layer by layer
    aux = [float(torch.stack([e['aux_loss']
                              for e in log[i * per_step:
                                           i * per_step + layers]]).mean())
           for i in range(3)]
    dropped = [float(torch.stack([e['dropped']
                                  for e in log[i * per_step:
                                               i * per_step + layers]])
                     .mean()) for i in range(3)]
    trainer, state = res['trainer'], res['state']
    step = trainer.step_fn()
    _, step_ms = _wall_ms(lambda: step(state, batch), 1)
    prof = _profile_calls(lambda: step(state, batch), 1, top=15, groups={
        'expert_bmm': ('aten::bmm',),
        'dense_mm': ('aten::mm', 'aten::addmm'),
        'dispatch_gather': ('aten::index', 'aten::gather', 'aten::sort',
                            'aten::cumsum', 'aten::one_hot',
                            'aten::scatter'),
        'optimizer': ('aten::_foreach', 'Optimizer')})
    tokens = MOE_TRAIN_B * MOE_TRAIN_SEQ
    flops = cfg.train_flops_per_token(MOE_TRAIN_SEQ) * tokens
    rec = {'phase': 'train_moe', 'preset': MOE_PRESET, 'layers': layers,
           'params': cfg.num_params, 'active_params': cfg.active_params,
           'batch': MOE_TRAIN_B, 'seq': MOE_TRAIN_SEQ, 'remat': 'full',
           'capacity_factor': cfg.capacity_factor, 'losses': losses,
           'aux_losses': aux, 'dropped_frac': dropped,
           'grad_norms': [r['grad_norm'] for r in steps],
           'tokens_per_s_by_step': [r['tokens_per_s'] for r in steps],
           'mfu_by_step': [r['mfu'] for r in steps],
           'logged_step_s': [r['seconds'] for r in steps], 'run_s': run_s,
           'step_ms': step_ms, 'tokens_per_s': tokens / step_ms * 1e3,
           'mfu': flops / step_ms / 1e-3 / ctx['peak_flops'],
           'peak_mem_gb': peak_gb, 'launches': launches,
           'launches_per_step': {k: v // 3 for k, v in launches.items()},
           'device_busy_ms': prof['busy_ms'],
           'port_kernels_ms': prof['port_kernels_ms'],
           'group_ms': prof['group_ms'], 'device_kernels': prof['kernels'],
           'top_ops': prof['top_ops']}

    # One forward + backward under each policy from the same state.
    named = {}
    for policy in ('full', 'dots', 'names'):
        tr = Trainer(mixtral.MixtralModel(dataclasses.replace(
            cfg, remat=True, remat_policy=policy), device='meta'))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = tr.grads(state.params, batch)
        norm = global_norm(grads).item()
        named[policy] = {'loss': loss.item(), 'grad_norm': norm,
                         'fwd_bwd_s': time.perf_counter() - t0,
                         'peak_mem_gb':
                         torch.cuda.max_memory_allocated() / 1e9,
                         'launches': dict(attn.LAUNCHES)}
        del grads
    rec['policies'] = named
    one = {'flash_fwd': layers, 'flash_bwd': layers}
    for policy in ('dots', 'names'):
        r = named[policy]
        if (r['loss'] != named['full']['loss']
                or abs(r['grad_norm'] - named['full']['grad_norm'])
                > GRAD_NORM_RTOL * named['full']['grad_norm']
                or r['launches'] != one):
            faults.append(f'remat {policy} off full: {named}')
    ctx['moe_train_launches'] = {
        k: n + sum(r['launches'][k] for r in named.values())
        for k, n in launches.items()}

    # Loss (with the aux term) and grads through K1/K2 against the
    # reference attention, on the same batch and params. The AdamW
    # moments are dropped first: nothing past here steps.
    state.opt_state.state.clear()
    model, params = trainer.model, state.params
    names = leaf_names(params)
    leaves = [get_leaf(params, n) for n in names]
    out, logs = {}, {}
    for impl in (None, 'reference'):
        with _routing_log(choices=True) as log:
            logits, aux_loss = model.apply_with_aux(params, fixed,
                                                    force_impl=impl)
            loss = cross_entropy_loss(logits, batch['targets']) \
                + model.aux_loss_weight * aux_loss
            del logits
            out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        logs[impl] = log[:layers]
        del loss
    loss_rel = abs(out[None][0] - out['reference'][0]) / abs(
        out['reference'][0])
    grad_rel = {n: _rel_l2(g, w) for n, g, w in
                zip(names, out[None][1], out['reference'][1])}
    gate_ok = (loss_rel <= GATE_LOSS_RTOL
               and max(grad_rel.values()) <= GATE_GRAD_RTOL)
    rec['gate'] = {'tokens': tokens, 'loss_kernel': out[None][0],
                   'loss_reference': out['reference'][0],
                   'loss_rel_err': loss_rel, 'loss_rtol': GATE_LOSS_RTOL,
                   'grad_rel_l2': grad_rel, 'grad_rtol': GATE_GRAD_RTOL,
                   'routing_choices_differ': _routing_differs(
                       logs[None], logs['reference']),
                   'routing_choices': layers * tokens * cfg.top_k,
                   'ok': gate_ok}
    del out, leaves, params, model, state, trainer, res, step
    if not gate_ok:
        faults.append('kernel-path loss/grads off the reference')
    rec['card'] = ctx['smi']
    emit(rec)
    if faults:
        raise RuntimeError(f'train_moe: {faults}')


def _moe_mesh_batch(cfg):
    """train_mesh_moe's fixed batch: [MOE_MESH_B, MOE_TRAIN_SEQ] from seed
    7 on the card."""
    import torch
    gen = torch.Generator(device='cuda')
    gen.manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (MOE_MESH_B, MOE_TRAIN_SEQ),
                         device='cuda', generator=gen)


def phase_train_mesh_moe(ctx) -> None:
    """Mixtral on a mesh through ``train.run`` (see MOE_MESH_LAYERS): the
    one-device run, then two ranks sharing the card on each of
    MOE_MESH_RUNS, gated against it."""
    import multiprocessing
    import shutil
    import tempfile
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.train import run
    from skypilot_tpu_torch.train.step import get_leaf, leaf_names
    tmp = tempfile.mkdtemp(prefix='chip_smoke_moe_mesh_')
    argv = MOE_MESH_ARGV + ['--steps', str(MESH_STEPS)]
    procs = []
    try:
        with _moe_depth(MOE_MESH_LAYERS) as cfg:
            fixed = _moe_mesh_batch(cfg)
            attn.reset_launch_counts()
            with _routing_log(choices=True) as log:
                res = run.main(argv, batch_fn=lambda step: fixed)
            launches = dict(attn.LAUNCHES)
            layers = cfg.num_layers
            ref = {'losses': [r['loss'] for r in res['log']],
                   'grad_norms': [r['grad_norm'] for r in res['log']],
                   'ms_per_step': _ms_per_step(res['log']),
                   'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9,
                   'dropped': [float(e['dropped']) for e in log],
                   'params': os.path.join(tmp, 'ref.pt'),
                   'init': os.path.join(tmp, 'init.pt'),
                   'choices': os.path.join(tmp, 'choices.pt')}
            torch.save([e['choice'].cpu() for e in log[:layers]],
                       ref['choices'])
            del log
            init = run.main(MOE_MESH_ARGV + ['--steps', '0'],
                            batch_fn=lambda step: fixed)['state'].params
            for params, path in ((res['state'].params, ref['params']),
                                 (init, ref['init'])):
                torch.save({n: get_leaf(params, n).detach().cpu()
                            for n in leaf_names(params)}, path)
            del res, params, init
        gc.collect()
        torch.cuda.empty_cache()
        backend = ctx.get('mesh_backend', 'gloo')
        port = _free_port()
        mp_ctx = multiprocessing.get_context('spawn')
        procs = [mp_ctx.Process(target=_moe_mesh_rank,
                                args=(rank, port, backend, ref, tmp))
                 for rank in range(2)]
        t0 = time.perf_counter()
        for proc in procs:
            proc.start()
        codes = _join_all(procs, MESH_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        if codes['timed_out'] or any(codes['exitcodes']):
            raise RuntimeError(f'two-rank Mixtral run: {codes}')
        ranks = []
        for rank in range(2):
            with open(os.path.join(tmp, f'rank{rank}.json')) as f:
                ranks.append(json.load(f))
    finally:
        _join_all(procs, 0)  # stops any left on a failure
        shutil.rmtree(tmp, ignore_errors=True)

    faults = []
    phase_launches = dict(launches)
    choices = layers * MOE_MESH_B * MOE_TRAIN_SEQ * cfg.top_k
    emit({'phase': 'train_mesh_moe', 'mesh': 'one_device',
          'preset': MOE_PRESET, 'layers': layers, 'params': cfg.num_params,
          'batch': MOE_MESH_B, 'seq': MOE_TRAIN_SEQ, 'remat': 'full',
          'capacity_factor': cfg.capacity_factor, 'losses': ref['losses'],
          'grad_norms': ref['grad_norms'], 'launches': launches,
          'dropped_frac_first_forward': ref['dropped'][:layers],
          'peak_mem_gb': ref['peak_mem_gb'],
          'ms_per_step': ref['ms_per_step'], 'card': ctx['smi']})
    if launches != mesh_launches('one', 0, layers, 'full'):
        faults.append(f'one device launched {launches}')
    for name, _ in MOE_MESH_RUNS:
        recs = [r[name] for r in ranks]
        got = recs[0]
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(got['losses'], ref['losses'])]
        norm_rel = [abs(a - b) / abs(b)
                    for a, b in zip(got['grad_norms'], ref['grad_norms'])]
        flips = sum(r['router_flips'] for r in recs)
        # {ep: 2}: both ranks route every token (count one); {fsdp: 2}: each
        # its own row.
        if name == 'ep2':
            flips = recs[0]['router_flips']
        want = [mesh_launches(name, rank, layers, 'full')
                for rank in range(2)]
        rec = {'phase': 'train_mesh_moe', 'mesh': name, 'ranks': 2,
               'backend': got['backend'], 'global_batch': MOE_MESH_B,
               'seq': MOE_TRAIN_SEQ, 'remat': 'full', 'layers': layers,
               'losses': got['losses'], 'losses_one_device': ref['losses'],
               'loss_rel_err': loss_rel, 'loss_rtol': GATE_LOSS_RTOL,
               'grad_norms': got['grad_norms'],
               'grad_norms_one_device': ref['grad_norms'],
               'grad_norm_rel_err': norm_rel, 'grad_rtol': GATE_GRAD_RTOL,
               'update_rel_l2': got['update_rel_l2'],
               'update_rtol': MESH_UPDATE_RTOL,
               'unmoved_leaves': got['unmoved'],
               'launches_per_rank': [r['launches'] for r in recs],
               'launches_predicted': want,
               'dropped_frac_first_forward_per_rank': [
                   r['dropped'][:layers] for r in recs],
               'dropped_frac_first_forward_one_device':
                   ref['dropped'][:layers],
               'dropped_equal_across_ranks': all(
                   r['dropped'] == got['dropped'] for r in recs),
               'router_flips_first_forward': flips,
               'routing_choices_first_forward': choices,
               'router_flips_max': MOE_MESH_FLIPS_MAX * choices,
               'peak_mem_gb_per_rank': [r['peak_mem_gb'] for r in recs],
               'ms_per_step': [r['ms_per_step'] for r in recs],
               'ms_per_step_one_device': ref['ms_per_step'],
               'run_s': [r['run_s'] for r in recs],
               'ms_note': 'two ranks share one card (collectives through '
                          'the host under gloo): not a multi-GPU number',
               'card': ctx['smi']}
        if got.get('profile'):
            rec['profiled_step'] = got['profile']
        emit(rec)
        for r in recs:
            for k, n in r['launches'].items():
                phase_launches[k] += n
        if (max(loss_rel) > GATE_LOSS_RTOL or max(norm_rel) > GATE_GRAD_RTOL
                or max(got['update_rel_l2'].values()) > MESH_UPDATE_RTOL
                or [r['launches'] for r in recs] != want
                or not rec['dropped_equal_across_ranks']
                or flips > rec['router_flips_max']
                or any(r['losses'] != got['losses'] for r in recs)):
            faults.append(name)
    emit({'phase': 'train_mesh_moe', 'wall_s_two_ranks': wall_s,
          'card': ctx['smi']})
    ctx['moe_mesh_launches'] = phase_launches
    if faults:
        raise RuntimeError(f'train_mesh_moe runs off the one-device '
                           f'trainer: {faults}')


def _moe_mesh_rank(rank: int, port: int, backend: str, ref: dict,
                   out_dir: str) -> None:
    """One of the two ranks of train_mesh_moe, on card ``rank`` mod the
    cards there are: each of MOE_MESH_RUNS through ``train.run.main``
    (the group stays up between them); on {ep: 2} one more step under
    torch.profiler; results to out_dir."""
    import torch
    from skypilot_tpu_torch.ops import attention as attn
    from skypilot_tpu_torch.runtime import distributed
    from skypilot_tpu_torch.train import run
    distributed.init(f'127.0.0.1:{port}', 2, rank, device_type='cuda',
                     backend=backend)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    one_choices = torch.load(ref['choices'], weights_only=True)
    out = {}
    with _moe_depth(MOE_MESH_LAYERS) as cfg:
        fixed = _moe_mesh_batch(cfg)
        for name, flags in MOE_MESH_RUNS:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            attn.reset_launch_counts()
            t0 = time.perf_counter()
            with _routing_log(choices=True) as log:
                res = run.main(MOE_MESH_ARGV + ['--steps', str(MESH_STEPS)]
                               + flags, batch_fn=lambda step: fixed)
            run_s = time.perf_counter() - t0
            launches = dict(attn.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            trainer, state = res['trainer'], res['state']
            # The first forward's choices for this rank's rows against one
            # device's for the same tokens.
            rows = trainer.row_index(MOE_MESH_B)
            flips = 0
            for layer, want in enumerate(one_choices):
                mine = want.view(MOE_MESH_B, -1, cfg.top_k)[rows]
                flips += int((log[layer]['choice'].cpu()
                              != mine.reshape(-1, cfg.top_k)).sum())
            rec = {'backend': backend,
                   'losses': [r['loss'] for r in res['log']],
                   'grad_norms': [r['grad_norm'] for r in res['log']],
                   'ms_per_step': _ms_per_step(res['log']),
                   'launches': launches, 'peak_mem_gb': peak_gb,
                   'run_s': run_s, 'router_flips': flips,
                   'dropped': [float(e['dropped']) for e in log]}
            del log
            rel, unmoved = _update_rel(trainer, state, ref, rank)
            rec.update(update_rel_l2=rel, unmoved=unmoved)
            # One more step, profiled, after the params are read.
            if name == 'ep2':
                step = trainer.step_fn()
                batch = trainer.shard_batch(
                    {'tokens': fixed,
                     'targets': torch.roll(fixed, -1, dims=1)})
                # Gloo runs the MoE all-reduces on the host: their device
                # part is the copies to and from it (memcpy_ms).
                groups = {'expert_bmm': ('aten::bmm',),
                          'dense_mm': ('aten::mm', 'aten::addmm'),
                          'optimizer': ('aten::_foreach', 'Optimizer')}
                prof = _profile_calls(lambda: step(state, batch), 1, top=12,
                                      groups=groups)
                rec['profile'] = {k: prof[k] for k in (
                    'busy_ms', 'memcpy_ms', 'port_kernels_ms', 'group_ms',
                    'top_ops')}
            out[name] = rec
            del res, trainer, state
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    distributed.shutdown()


def _device_us(evt) -> float:
    """An averaged profiler event's self device time in microseconds (the
    attribute was renamed from cuda_* to device_* across torch versions)."""
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def _profile_calls(fn, reps: int, top: int = 10, groups=None):
    """torch.profiler over ``reps`` calls of ``fn``: per call, the device
    busy ms (the sum of its kernels' times), the kernel count, and the
    host-side ops whose kernels take the most device time (ms per call);
    with ``groups`` ({name: op-name prefixes}), the device ms of each
    group's ops.
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
    out = {
        'busy_ms': sum(_device_us(e) for e in kernels) / reps / 1e3,
        # Host <-> device copies, gloo's with CUDA tensors among them.
        'memcpy_ms': sum(_device_us(e) for e in kernels
                         if 'Memcpy' in e.key) / reps / 1e3,
        'kernels': sum(e.count for e in kernels) // reps,
        'port_kernels_ms': own,
        'top_ops': [{'op': e.key[:60], 'ms': _device_us(e) / reps / 1e3,
                     'calls': e.count // reps} for e in ops[:top]]}
    if groups:
        out['group_ms'] = {
            name: sum(_device_us(e) for e in ops
                      if e.key.startswith(prefixes)) / reps / 1e3
            for name, prefixes in groups.items()}
    return out


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
    cost of one K1 call by route, monolithic prefill per bucket, an
    admit_many of 4 x 512 against 4 solo admits, then the plain step and
    the K-4 verify step with every slot live at ~1000 tokens of context,
    over the bf16 pool and over an int8 one. For each: the host's
    enqueue time, the synced wall time, the device busy time from
    torch.profiler, and the ops that take the most device time. Not run
    by default (``--phases ...,breakdown``)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.models import decode
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
        # One admit_many of 4 x 512 against 4 solo admits, into a state
        # of its own (the same slots and blocks each time).
        wave = [rng_np.integers(0, cfg.vocab_size, n).tolist()
                for n in MODES_WAVE]
        toks = [p + [0] * (MODES_BUCKET - len(p)) for p in wave]
        lens = [len(p) for p in wave]
        scratch = eng.init_state()
        admits = {
            'admit_many': lambda: eng.admit_many(
                params, scratch, toks, lens, list(range(len(toks))), gen,
                [0.0] * len(toks), [0] * len(toks)),
            'admit_solo_x4': lambda: [
                eng.admit(params, scratch, t, n, slot, gen)
                for slot, (t, n) in enumerate(zip(toks, lens))],
        }
        for kind, fn in admits.items():
            fn()
            enqueue, wall = _wall_ms(fn, reps)
            prof = _profile_calls(fn, reps)
            emit({'phase': 'breakdown', 'kind': kind, 'prompts': len(toks),
                  'bucket': MODES_BUCKET, 'enqueue_ms': enqueue,
                  'wall_ms': wall,
                  'idle_share': 1.0 - prof['busy_ms'] / wall, **prof,
                  'card': ctx['smi']})
        del scratch
        # The plain and verify steps with every slot live at ~1000 tokens
        # of context, over the bf16 pool and over an int8 pool.
        quant = decode.DecodeEngine(cfg, batch_slots=eng.batch_slots,
                                    max_len=eng.max_len, model=eng.model,
                                    kv_block=eng.kv_block, kv_dtype='int8',
                                    device=eng.device)
        ctx_len = 1000
        prompts = [rng_np.integers(0, cfg.vocab_size, 1024).tolist()
                   for _ in range(eng.batch_slots)]
        for engine, state in ((eng, sched.state),
                              (quant, quant.init_state())):
            for slot, prompt in enumerate(prompts):
                state, _, gen = engine.admit(params, state, prompt, ctx_len,
                                             slot, gen)
            draft = [[0] * engine.spec_tokens] * engine.batch_slots
            kinds = {
                'step': lambda: engine.step(params, state, gen),
                'step_verify': lambda: engine.step_verify(params, state,
                                                          gen, draft),
            }
            for kind, fn in kinds.items():
                fn()
                enqueue, wall = _wall_ms(fn, reps)
                prof = _profile_calls(fn, reps)
                emit({'phase': 'breakdown', 'kind': kind,
                      'kv_dtype': engine.kv_dtype,
                      'slots': engine.batch_slots, 'context': ctx_len,
                      'spec_tokens': (engine.spec_tokens if kind != 'step'
                                      else 0),
                      'enqueue_ms': enqueue, 'wall_ms': wall,
                      'idle_share': 1.0 - prof['busy_ms'] / wall, **prof,
                      'card': ctx['smi']})


class _MemorySampler:
    """The card's memory.used (nvidia-smi, MiB) sampled every
    ``period_s`` on a thread, for a subprocess's peak: what the card held
    at the start, and the most it held while the block ran."""

    def __init__(self, period_s: float = 0.5):
        self.period_s = period_s
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def read_mib() -> float:
        proc = subprocess.run(
            ['nvidia-smi', '--query-gpu=memory.used',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, check=True, timeout=30)
        return float(proc.stdout.strip().splitlines()[0])

    def _run(self):
        while not self._stop.is_set():
            try:
                self.samples.append(self.read_mib())
            except (subprocess.SubprocessError, OSError, ValueError):
                pass
            self._stop.wait(self.period_s)

    def __enter__(self):
        self.start_mib = self.read_mib()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def phase_bench(ctx) -> None:
    """The port's measurement entry points (``skypilot_tpu_torch/bench.py``)
    at their card workload: ``phase_train`` and ``phase_decode`` in this
    process (their K1/K2 launches counted), the ``launched`` phase as the
    bench runs it (a subprocess that starts the trainer twice), and
    ``serve_bench.run`` against a llama-1b replica subprocess with the
    bench's headline arguments, cut as ``BENCH_*`` says."""
    import tempfile
    import torch
    from skypilot_tpu_torch import bench
    from skypilot_tpu_torch.benchmark import serve_bench
    from skypilot_tpu_torch.models.llama import PRESETS
    from skypilot_tpu_torch.ops import attention as attn
    layers = PRESETS['llama-1b'].num_layers
    faults = []
    launches = {}

    # Train: the headline rate, K1/K2 once per layer and step.
    attn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = bench.phase_train(None, 'cuda')
    train_s = time.perf_counter() - t0
    launches['train'] = dict(attn.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({'phase': 'bench', 'part': 'train', 'record': rec,
          'launches': launches['train'], 'peak_mem_gb': peak_gb,
          'seconds': train_s, 'card': ctx['smi']})
    want = {'flash_fwd': BENCH_STEPS * layers, 'flash_bwd': BENCH_STEPS * layers}
    missing = [f for f in BENCH_TRAIN_FIELDS if f not in rec]
    if (missing or not rec['value'] > 0 or rec['vs_baseline'] is not None
            or not 0 < (rec['mfu_pct'] or 0) <= 100
            or not math.isfinite(rec['train_loss'])
            or launches['train'] != want):
        faults.append(f'train: missing {missing}, launches '
                      f'{launches["train"]} (want {want}), {rec}')
    gc.collect()
    torch.cuda.empty_cache()

    # Decode: the engine alone, one K1 per layer per prefill.
    attn.reset_launch_counts()
    rec = bench.phase_decode(None, 'cuda')
    launches['decode'] = dict(attn.LAUNCHES)
    emit({'phase': 'bench', 'part': 'decode', 'record': rec,
          'launches': launches['decode'], 'card': ctx['smi']})
    want = {'flash_fwd': BENCH_PREFILLS * layers, 'flash_bwd': 0}
    missing = [f for f in BENCH_DECODE_FIELDS if f not in rec]
    if (missing or not rec['decode_tokens_per_sec_per_chip'] > 0
            or not rec['decode_ttft_ms'] > 0
            or launches['decode'] != want):
        faults.append(f'decode: missing {missing}, launches '
                      f'{launches["decode"]} (want {want}), {rec}')
    ctx['bench_launches'] = {k: launches['train'][k] + launches['decode'][k]
                             for k in KERNELS}
    gc.collect()
    torch.cuda.empty_cache()

    # Launched: the bench's own phase subprocess, as the orchestrator
    # starts it (its trainers' launches are another process's).
    fd, out = tempfile.mkstemp(prefix='chip_smoke_launched_', suffix='.json')
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.bench', '--phase',
         'launched', '--out', out, '--device', 'cuda'], stdout=sys.stderr,
        timeout=BENCH_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    with open(out) as f:
        rec = json.load(f)
    os.remove(out)
    emit({'phase': 'bench', 'part': 'launched', 'record': rec,
          'rc': proc.returncode, 'seconds': time.perf_counter() - t0,
          'card': ctx['smi']})
    for prefix in ('', 'warm_'):
        parts = [rec.get(prefix + p) for p in BENCH_LAUNCH_PARTS]
        if (proc.returncode or rec.get(f'{prefix}launched_job_status')
                != 'SUCCEEDED' or rec.get(f'{prefix}launch_overhead_s')
                is None or any(p is None or p < 0 for p in parts)):
            faults.append(f'launched ({prefix or "cold"}): {rec}')

    # Serve: one replica subprocess (it owns the card's memory for its
    # lifetime); the card's memory.used sampled around it.
    args = dict(bench.SERVE_CARD, concurrencies=bench.SERVE_CARD[
        'concurrencies'][:1], ab_monolithic=False,
        service_name='chip-smoke-serve')
    t0 = time.perf_counter()
    with _MemorySampler() as mem:
        rec = serve_bench.run(device='cuda', **args)
    serve_s = time.perf_counter() - t0
    peak_mib = max(mem.samples, default=mem.start_mib)
    emit({'phase': 'bench', 'part': 'serve', 'args': args, 'record': rec,
          'card_mem_start_mib': mem.start_mib, 'card_mem_peak_mib': peak_mib,
          'replica_peak_gb': (peak_mib - mem.start_mib) * 2**20 / 1e9,
          'seconds': serve_s, 'card': ctx['smi']})
    sweep = rec.get('serve_sweep') or [{}]
    point = sweep[0]
    if (not point.get('completed') or point.get('errors')
            or not rec.get('serve_ttft_p50_ms', 0) > 0
            or not rec.get('serve_tpot_p50_ms', 0) > 0
            or not rec.get('serve_prefix_hit_rate', 0) > 0
            or 'skytpu_serve_ttft_ms' not in rec.get(
                'serve_replica_metrics_summary', {})):
        faults.append(f'serve: {rec}')
    if faults:
        raise RuntimeError(f'bench phase: {faults}')


def kernels_line(ctx):
    """K1 timed at the serve path's largest prefill (1536, llama3-8b
    heads), K2 at the train shape; launches summed over the serve,
    serve_modes, train, train_mesh (the contract run and both ranks'
    runs on every mesh), serve_moe, train_moe, train_mesh_moe (the
    one-device run and both ranks' runs) and bench (its in-process train
    and decode) runs (each read from counts zeroed just before it), and
    listed by phase. Every time is
    device time (``time_device``)."""
    fwd = ctx['flash_timing'][(1, 1536, HQ, True)]
    bwd = ctx['flash_bwd_timing']
    by_phase = {'serve': {'flash_fwd': ctx['flash_launches'],
                          'flash_bwd': 0},
                'serve_modes': ctx['modes_launches'],
                'train': ctx['train_launches'],
                'train_mesh': ctx['mesh_launches'],
                'serve_moe': ctx['moe_serve_launches'],
                'train_moe': ctx['moe_train_launches'],
                'train_mesh_moe': ctx['moe_mesh_launches'],
                'bench': ctx['bench_launches']}

    def launches(name):
        return {phase: n[name] for phase, n in by_phase.items()}
    return [{
        'name': 'flash_fwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
        'replaces': 'skypilot_tpu/ops/attention.py:121',
        'launches': sum(launches('flash_fwd').values()),
        'launches_by_phase': launches('flash_fwd'),
        'max_abs_err': ctx['flash']['max_abs_err'],
        'ms': fwd['kernel_ms'], 'plain_ms': fwd['plain_ms'],
        'bound_ms': fwd['bound_ms'], 'bound_by': fwd['bound_by'],
        'library_ms': fwd['library_ms'], 'ms_source': MS_SOURCE,
    }, {
        'name': 'flash_bwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
        'replaces': 'skypilot_tpu/ops/attention.py:171',
        'launches': sum(launches('flash_bwd').values()),
        'launches_by_phase': launches('flash_bwd'),
        'max_abs_err': ctx['flash_bwd']['max_abs_err'],
        'ms': bwd['kernel_ms'], 'plain_ms': bwd['plain_ms'],
        'bound_ms': bwd['bound_ms'], 'bound_by': bwd['bound_by'],
        'library_ms': bwd['library_ms'], 'ms_source': MS_SOURCE,
    }]


# ---------------------------------------------------------------------------
def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--phases', default=','.join(ALL_PHASES))
    parser.add_argument('--parent', default=None,
                        help='a checkout of an earlier commit (e.g. a git '
                        'archive) whose kernels the kernel phase times '
                        'beside these, on the same inputs')
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
           'count': torch.cuda.device_count(), 'parent': args.parent}
    ctx['smi'] = nvidia_smi_line()
    from skypilot_tpu_torch import accelerators
    ctx['peak_flops'], ctx['peak_bw'] = accelerators.card_peaks(ctx['smi'])
    emit({'phase': 'device', 'name': ctx['name'], 'count': ctx['count'],
          'nvidia_smi': ctx['smi'], 'torch': torch.__version__,
          'cuda': torch.version.cuda})
    runners = {'build': phase_build, 'kernel': phase_kernel,
               'train': phase_train, 'train_mesh': phase_train_mesh,
               'serve': phase_serve,
               'serve_modes': phase_serve_modes,
               'serve_moe': phase_serve_moe, 'train_moe': phase_train_moe,
               'train_mesh_moe': phase_train_mesh_moe,
               'bench': phase_bench, 'breakdown': phase_breakdown}
    for phase in phases:
        if phase == 'device':
            continue
        # Each phase starts from the memory the previous one freed, and
        # its peak is its own.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runners[phase](ctx)
        emit({'phase': phase, 'seconds': time.perf_counter() - t0})
    if set(ALL_PHASES) - {'device', 'build'} <= set(phases):
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
