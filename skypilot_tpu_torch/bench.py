"""Flagship benchmark of the port: train-step tokens/s per card with MFU,
the launched trainer's startup, the serve path and the decode engine.

    python -m skypilot_tpu_torch.bench                # on the card
    python -m skypilot_tpu_torch.bench --device cpu   # test-tiny, on the host

The port's counterpart of the JAX package's ``bench.py``, with its phases,
record fields and test seams. Prints the record as a JSON line after
every phase, each later line with that phase's fields merged in, so the
LAST stdout line is always the most complete record — and an earlier line
is still a complete, parseable record if a later phase is killed.
Required fields ride on every line: {"metric", "value", "unit",
"vs_baseline", ...extras}.

Every phase runs in its OWN subprocess with a hard wall-clock budget; the
orchestrator never initialises CUDA (it asks a throwaway subprocess what
card there is). On budget overrun the phase's process group is
SIGKILLed, and the replicas and trainers it started die with it
(``serve_bench.spawn``). There is no fallback: a phase that fails or
overruns leaves ``<phase>_error`` or ``<phase>_timeout`` in the record,
later phases still run, and the run exits non-zero. Without a card and
without ``--device cpu`` the run refuses to start.

Phases:
  train     in-process train steps: tokens/s per card, MFU against the
            card's bf16 peak (``accelerators.card_peaks``), the pure-6N
            MFU and the rate scaled to 8 B parameters; K1 and K2 in every
            layer of every step;
  launched  ``python -m skypilot_tpu_torch.train.run`` as a fresh process,
            cold then warm: submit -> first step, split by the trainer's
            callback marks into process spawn (``control_plane_s``),
            runtime start-up, param init and the first step;
  serve     ``benchmark.serve_bench.run`` against replica subprocesses:
            the chunked headline arm with its monolithic A/B control and
            the shared-prefix arm, then an int8-KV arm at twice the
            blocks;
  decode    the engine alone in a fresh process: decode tokens/s with
            every slot full, and the median-of-3 prefill TTFT (K1).

``vs_baseline`` is null: the JAX bench divides by a TPU throughput anchor,
which is no measure of this card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional

LLAMA3_8B_PARAMS = 8.03e9

# Test seams: scale every phase budget, or pin one phase's budget in
# seconds (SKYTPU_BENCH_BUDGET_TRAIN=8), so a wedged phase times out in
# seconds, not minutes.
_SCALE = float(os.environ.get('SKYTPU_BENCH_TIMEOUT_SCALE', '1.0'))

# Phase budgets in seconds: (on the card, on the CPU). The card's serve
# budget covers three replicas' sweeps (~12 minutes).
BUDGETS = {'train': (600, 300), 'launched': (480, 360),
           'serve': (1500, 450), 'decode': (300, 240)}
PROBE_BUDGET_S = 150
PHASES = ('train', 'launched', 'serve', 'decode')

# The serve phase's headline arm on the card: llama-1b, 64 slots over a
# pool of 2049 blocks of 64 rows (the KV budget of 32 contiguous 4096-row
# slots), ~2500 input / ~150 output tokens, a 4-point closed-loop sweep,
# 256-token prefill chunks with a 4.5 s TTFT SLO against a monolithic
# control, a 2048-token shared-prefix arm, speculative K 4.
SERVE_CARD = dict(
    preset='llama-1b', batch_slots=64, max_len=4096, prompt_len=2500,
    output_len=150, concurrencies=(12, 24, 36, 48), window_s=45.0,
    warmup_requests=2, ready_timeout_s=150.0, warmup_deadline_s=90.0,
    prefill_chunk=256, ttft_slo_ms=4500.0, ab_monolithic=True,
    prefix_share_len=2048, kv_block=64, kv_blocks=2049, spec_tokens=4)
SERVE_CPU = dict(
    preset='test-tiny', batch_slots=2, max_len=128, prompt_len=24,
    output_len=8, concurrencies=(1, 2, 3, 4), window_s=4.0,
    warmup_requests=1, ready_timeout_s=120.0, warmup_deadline_s=60.0,
    prefill_chunk=8, ttft_slo_ms=2000.0, ab_monolithic=True,
    prefix_share_len=16, kv_block=8, spec_tokens=4)
# The int8-KV arm: twice the blocks in about the same bytes (int8 codes
# plus f32 scales roughly halve a block), concurrency up to 96.
SERVE_INT8_CARD = dict(
    preset='llama-1b', batch_slots=64, max_len=4096, prompt_len=2500,
    output_len=150, concurrencies=(24, 48, 72, 96), window_s=45.0,
    warmup_requests=2, ready_timeout_s=150.0, warmup_deadline_s=90.0,
    prefill_chunk=256, ttft_slo_ms=4500.0, prefix_share_len=2048,
    kv_block=64, kv_blocks=4097, spec_tokens=4, kv_dtype='int8',
    service_name='bench-serve-int8')
SERVE_INT8_CPU = dict(
    preset='test-tiny', batch_slots=2, max_len=128, prompt_len=24,
    output_len=8, concurrencies=(2,), window_s=4.0, warmup_requests=1,
    ready_timeout_s=120.0, warmup_deadline_s=60.0, prefill_chunk=8,
    kv_block=8, spec_tokens=4, kv_dtype='int8',
    service_name='bench-serve-int8')
# Timed budgets inside the serve arms scale with the seam as the phase's
# own budget does.
_SCALED = ('ready_timeout_s', 'warmup_deadline_s')


def _phase_budget(phase: str, default_s: float) -> float:
    override = os.environ.get(f'SKYTPU_BENCH_BUDGET_{phase.upper()}')
    return float(override) if override else default_s * _SCALE


def _wedge_hook(phase: str) -> None:
    """Test seam: SKYTPU_BENCH_WEDGE_PHASE=<phase>[,<phase>...] makes
    those phases hang (a hung card or a deadlocked kernel). The JAX
    bench's SKYTPU_BENCH_WEDGE_ONCE tests its retry, which the port does
    not have."""
    wedged = os.environ.get('SKYTPU_BENCH_WEDGE_PHASE', '')
    if phase in [w.strip() for w in wedged.split(',')]:
        time.sleep(10 ** 6)


def _workload(on_card: bool):
    """One workload definition shared by every phase, so rates are
    directly comparable: on the card llama-1b at full width and depth,
    b 1 x 8192, remat 'names_qkv' (K1's out and lse kept, so one K1 and
    one K2 per layer and step), 8 timed steps; on the CPU test-tiny,
    b 4 x 256, 4 steps."""
    import dataclasses

    from skypilot_tpu_torch.models.llama import PRESETS

    if on_card:
        preset, batch, seq, steps = 'llama-1b', 1, 8192, 8
        config = dataclasses.replace(PRESETS[preset],
                                     remat_policy='names_qkv')
    else:
        preset, batch, seq, steps = 'test-tiny', 4, 256, 4
        config = PRESETS[preset]
    return preset, batch, seq, steps, config


def _card_name(device) -> str:
    import torch
    if device.type != 'cuda':
        return 'cpu'
    return torch.cuda.get_device_name(device)


def _sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


# ---- phase: train (in-process step throughput; THE headline) ---------------
def phase_train(out_path: Optional[str], device: str = 'cuda'
                ) -> Dict[str, Any]:
    """Warm up 2 steps, time ``steps`` more on a distinct batch each,
    synced at both ends; the record (also written to ``out_path``)."""
    _wedge_hook('train')
    import torch

    from skypilot_tpu_torch import accelerators
    from skypilot_tpu_torch.models.llama import LlamaModel
    from skypilot_tpu_torch.train import Trainer
    from skypilot_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    preset, batch, seq, steps, config = _workload(dev.type == 'cuda')
    model = LlamaModel(config, device=dev)
    trainer = Trainer(model)
    kind = _card_name(dev)
    peak = accelerators.peak_bf16_flops(dev)
    print(f'bench train: device={kind!r} preset={preset} '
          f'params={config.num_params/1e9:.2f}B batch={batch} seq={seq} '
          f'remat={config.remat_policy}', file=sys.stderr)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = trainer.init_fn()(gen)
    step = trainer.step_fn()
    # A distinct batch per step, from seed i, made before the clock runs.
    batches = []
    for i in range(steps + 2):
        g = torch.Generator(device=dev)
        g.manual_seed(i)
        tokens = torch.randint(0, config.vocab_size, (batch, seq),
                               generator=g, device=dev)
        batches.append(trainer.shard_batch(
            {'tokens': tokens, 'targets': torch.roll(tokens, -1, dims=1)}))

    for i in range(2):  # warm up (kernel build, allocator, libraries)
        state, metrics = step(state, batches[i])
    float(metrics['loss'])
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step(state, batches[2 + i])
    last_loss = float(metrics['loss'])  # the scalar fetch syncs
    _sync(dev)
    dt = time.perf_counter() - t0

    tok_per_s = batch * seq * steps / dt  # one card
    # MFU with the standard (PaLM appendix B) accounting: 6N plus the
    # causal self-attention matmuls; the pure-6N figure rides along.
    flops_per_token = config.train_flops_per_token(seq)
    tflops_per_s = flops_per_token * tok_per_s / 1e12
    mfu = tflops_per_s * 1e12 / peak if peak else None
    mfu_6n = 6 * config.num_params * tok_per_s / peak if peak else None
    tok8b_equiv = tok_per_s * config.num_params / LLAMA3_8B_PARAMS
    print(f'bench train: {tok_per_s:,.0f} tok/s @ '
          f'{config.num_params/1e9:.2f}B, {tflops_per_s:.1f} model TFLOP/s '
          f'(MFU {mfu * 100 if mfu else float("nan"):.1f}%), '
          f'8B-equivalent {tok8b_equiv:,.0f} tok/s, loss={last_loss:.3f}',
          file=sys.stderr)
    record = {
        'metric': 'train_tokens_per_sec_per_chip',
        'value': round(tok_per_s, 2),
        'unit': f'tokens/s/card @ {config.num_params/1e9:.2f}B seq {seq}',
        'vs_baseline': None,
        'equivalent_8b_tokens_per_sec_per_chip': round(tok8b_equiv, 2),
        'model_params_b': round(config.num_params / 1e9, 3),
        'mfu_pct': round(mfu * 100, 1) if mfu is not None else None,
        'mfu_6n_pct': round(mfu_6n * 100, 1) if mfu_6n is not None else None,
        'chip': kind,
        'seq_len': seq,
        'train_loss': last_loss,
        'train_seconds_per_step': dt / steps,
    }
    if out_path:
        _write_record(out_path, record)
    return record


# ---- phase: launched (the trainer as a fresh process) ----------------------
def _overhead_breakdown(summary: dict, t_submit: float,
                        prefix: str = '') -> dict:
    """Split submit->first-step into phases from the callback's marks:
    ``control_plane_s`` (here the process spawn and the imports before
    the trainer's first mark: no control plane stands in front of it),
    runtime start-up (the card and the process group), param init, the
    first step."""
    marks = summary.get('marks') or {}
    ps = marks.get('proc_start')
    jr = marks.get('jax_ready')  # the trainer's "framework ready" mark
    idn = marks.get('init_done')
    fse = summary.get('first_step_end_ts')
    out = {}
    if ps:
        out[f'{prefix}control_plane_s'] = round(ps - t_submit, 2)
    if ps and jr:
        out[f'{prefix}runtime_startup_s'] = round(jr - ps, 2)
    if jr and idn:
        out[f'{prefix}param_init_s'] = round(idn - jr, 2)
    if idn and fse:
        out[f'{prefix}first_step_s'] = round(fse - idn, 2)
    return out


def phase_launched(out_path: str, device: str = 'cuda',
                   n_devices: int = 1) -> None:
    """Start ``train.run`` with the workload as a fresh process with
    $SKYTPU_BENCHMARK_LOG_DIR, cold then warm (the second launch finds
    the kernels the first one built and the files it read in the page
    cache; the port has no compilation cache), and read submit -> first
    step and the steady step time from the trainer's callback summary."""
    _wedge_hook('launched')
    import shutil

    from skypilot_tpu_torch.benchmark import serve_bench
    from skypilot_tpu_torch.callbacks import SUMMARY_FILE

    on_card = device == 'cuda'
    preset, batch, seq, steps, config = _workload(on_card)
    remat = config.remat_policy
    # The global batch scales with the cards (train.run starts one worker
    # per card and shards over fsdp=auto), as the in-process rate is per
    # card.
    global_batch = batch * n_devices
    # Per-launch caps INSIDE the phase budget: a hung cold launch must
    # still leave time for the record write.
    cold_cap = (300 if on_card else 180) * _SCALE
    warm_cap = (150 if on_card else 120) * _SCALE

    def one_launch(cap: float) -> tuple:
        """(status, summary|None, t_submit) of one trainer process."""
        log_dir = tempfile.mkdtemp(prefix='skytpu-bench-cb-')
        cmd = [sys.executable, '-m', 'skypilot_tpu_torch.train.run',
               '--preset', preset, '--batch', str(global_batch),
               '--seq', str(seq), '--steps', str(steps + 2),
               '--remat', remat, '--log-every', str(steps + 2),
               '--device', device]
        env = dict(os.environ, SKYTPU_BENCHMARK_LOG_DIR=log_dir)
        t_submit = time.time()
        proc = serve_bench.spawn(cmd, env, sys.stderr)
        try:
            rc = proc.wait(timeout=cap)
            status = 'SUCCEEDED' if rc == 0 else f'FAILED (rc {rc})'
        except subprocess.TimeoutExpired:
            status = 'TIMED_OUT'
        finally:
            serve_bench.kill_group(proc)
        try:
            with open(os.path.join(log_dir, SUMMARY_FILE)) as f:
                summary = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            summary = None
        shutil.rmtree(log_dir, ignore_errors=True)
        return status, summary, t_submit

    out: dict = {}
    try:
        status, summary, t_submit = one_launch(cold_cap)
        out['launched_job_status'] = status
        if summary is None or not summary.get('first_step_end_ts'):
            out['launched_error'] = 'no benchmark summary from cold launch'
            _write_record(out_path, out)
            return
        if status != 'SUCCEEDED':
            out['launched_error'] = f'cold launch {status}'
        out['launch_overhead_s'] = round(
            summary['first_step_end_ts'] - t_submit, 2)
        out.update(_overhead_breakdown(summary, t_submit))
        if summary.get('seconds_per_step'):
            tok = (global_batch * seq / summary['seconds_per_step']
                   / n_devices)
            out['launched_tokens_per_sec_per_chip'] = round(tok, 2)
        _write_record(out_path, out)  # cold results survive a warm hang
        status_w, summary_w, t_submit_w = one_launch(warm_cap)
        out['warm_launched_job_status'] = status_w
        if status_w != 'SUCCEEDED':
            out['launched_error'] = f'warm launch {status_w}'
        if summary_w and summary_w.get('first_step_end_ts'):
            out['warm_launch_overhead_s'] = round(
                summary_w['first_step_end_ts'] - t_submit_w, 2)
            out.update(_overhead_breakdown(summary_w, t_submit_w,
                                           prefix='warm_'))
        else:
            out['launched_error'] = 'no benchmark summary from warm launch'
    except Exception as e:  # noqa: BLE001 — the record must still land
        out['launched_error'] = f'{type(e).__name__}: {e}'
    _write_record(out_path, out)


# ---- phase: serve (replica subprocesses) -----------------------------------
def _serve_args(args: dict, device: str) -> dict:
    return {**args, 'device': device,
            **{k: args[k] * _SCALE for k in _SCALED if k in args}}


def phase_serve(out_path: str, device: str = 'cuda') -> None:
    """The serve path under the serving anchor's traffic shape (~2500
    input / ~150 output tokens): the headline arm, then the int8 arm.
    A failed int8 arm leaves ``serve_int8_error`` beside the headline's
    record."""
    _wedge_hook('serve')
    from skypilot_tpu_torch.benchmark import serve_bench
    on_card = device == 'cuda'

    def progress(partial: dict) -> None:
        _write_record(out_path, partial)  # survive a mid-sweep SIGKILL

    try:
        out = serve_bench.run(progress=progress, **_serve_args(
            SERVE_CARD if on_card else SERVE_CPU, device))
    except Exception as e:  # noqa: BLE001 — a failed serve phase must
        # still contribute an explanatory record, not just rc!=0
        _write_record(out_path,
                      {'serve_error': f'{type(e).__name__}: {e}'})
        return
    try:
        i8 = serve_bench.run(**_serve_args(
            SERVE_INT8_CARD if on_card else SERVE_INT8_CPU, device))
        out['serve_sweep_int8'] = i8.get('serve_sweep')
        for fld in ('serve_kv_dtype', 'serve_kv_blocks',
                    'serve_req_per_s', 'serve_ttft_p99_ms',
                    'serve_tpot_p50_ms'):
            if fld in i8:
                out['serve_int8_' + fld[len('serve_'):]] = i8[fld]
    except Exception as e:  # noqa: BLE001
        out['serve_int8_error'] = f'{type(e).__name__}: {e}'
    _write_record(out_path, out)


# ---- phase: decode (standalone engine throughput, fresh process) -----------
def phase_decode(out_path: Optional[str], device: str = 'cuda'
                 ) -> Dict[str, Any]:
    """Decode tokens/s with every slot full (16 slots, max_len 1024, a
    128-token prompt, 64 timed steps on the card; 4 slots, 128, 24 on the
    CPU) and the median-of-3 TTFT of the prompt's monolithic prefill
    (through K1), after one untimed prefill; the record."""
    _wedge_hook('decode')
    import torch

    from skypilot_tpu_torch.benchmark.kv_microbench import (random_params,
                                                            random_prompt)
    from skypilot_tpu_torch.models.decode import DecodeEngine, prefill_bucket
    from skypilot_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == 'cuda'
    _, _, _, _, config = _workload(on_card)
    params = random_params(config, dev)
    slots, max_len, prompt_len = (16, 1024, 128) if on_card else (4, 128, 24)
    engine = DecodeEngine(config, batch_slots=slots, max_len=max_len,
                          device=dev)
    state = engine.init_state()
    prompt = random_prompt(config, prompt_len)
    bucket = prefill_bucket(prompt_len, engine.max_len)
    padded = prompt + [0] * (bucket - prompt_len)
    k, v, logits = engine.prefill(params, padded, prompt_len)
    first = int(torch.argmax(logits))  # warm + sync
    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        k, v, logits = engine.prefill(params, padded, prompt_len)
        first = int(torch.argmax(logits))
        ttfts.append(time.perf_counter() - t0)
    for s in range(slots):
        state = engine.insert(state, k, v, prompt_len, first, s)
    rng = torch.Generator(device=dev)
    rng.manual_seed(11)
    for _ in range(4):  # warm
        state, sampled, rng = engine.step(params, state, rng)
    int(sampled[0])
    n = 64
    t0 = time.perf_counter()
    for _ in range(n):
        state, sampled, rng = engine.step(params, state, rng)
    int(sampled[0])  # sync
    dt = time.perf_counter() - t0
    record = {
        'decode_tokens_per_sec_per_chip': round(slots * n / dt, 1),
        'decode_batch_slots': slots,
        'decode_ttft_ms': round(sorted(ttfts)[1] * 1e3, 1),
        'decode_prompt_len': prompt_len,
    }
    if out_path:
        _write_record(out_path, record)
    return record


# ---- orchestrator -----------------------------------------------------------
def _write_record(out_path: str, record: dict) -> None:
    tmp = out_path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(record, f)
    os.replace(tmp, out_path)


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


_PROBE_SRC = (
    'import torch\n'
    'ok = torch.cuda.is_available()\n'
    "name = torch.cuda.get_device_name(0) if ok else 'none'\n"
    "print('PROBE', int(ok), torch.cuda.device_count() if ok else 0,\n"
    "      name.replace(' ', '_'), flush=True)\n")


def probe_card(timeout: float) -> Optional[dict]:
    """Ask a throwaway subprocess which CUDA cards there are (so the
    orchestrator never holds one): {'n_devices', 'device_kind'}, or None
    when there is none or the probe hangs."""
    from skypilot_tpu_torch.benchmark import serve_bench
    with tempfile.TemporaryFile() as out:
        proc = serve_bench.spawn([sys.executable, '-c', _PROBE_SRC],
                                 dict(os.environ), out)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        serve_bench.kill_group(proc)
        out.seek(0)
        for line in out.read().decode('utf-8', 'replace').splitlines():
            if line.startswith('PROBE '):
                _, ok, count, kind = line.split()
                if int(ok) and int(count) > 0:
                    return {'n_devices': int(count),
                            'device_kind': kind.replace('_', ' ')}
    return None


def run_phase(phase: str, timeout: float, device: str,
              extra_args: Optional[list] = None) -> dict:
    """Run one bench phase in its own process group with a hard budget."""
    from skypilot_tpu_torch.benchmark import serve_bench
    fd, out_path = tempfile.mkstemp(prefix=f'skytpu-bench-{phase}-',
                                    suffix='.json')
    os.close(fd)
    os.remove(out_path)  # the phase writes it (a missing file = no record)
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.bench', '--phase',
           phase, '--out', out_path, '--device', device] + (extra_args or [])
    print(f'bench: phase {phase} (budget {timeout:.0f}s)', file=sys.stderr,
          flush=True)
    t0 = time.time()
    proc = serve_bench.spawn(cmd, dict(os.environ), sys.stderr)
    timed_out = False
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        timed_out = True
    # SIGKILL at once on overrun (a hung phase may not handle SIGTERM);
    # its replicas and trainers die with it.
    serve_bench.kill_group(proc, grace_s=0.0 if timed_out else 5.0)
    result: dict = {}
    try:
        # Phases write the record incrementally, so a phase killed
        # mid-way still contributes what it measured before it hung.
        with open(out_path) as f:
            result = json.load(f)
        os.remove(out_path)
    except (FileNotFoundError, json.JSONDecodeError):
        if not timed_out:
            result = {f'{phase}_error':
                      f'phase exited rc={proc.returncode} without a record'}
    if not timed_out and proc.returncode and f'{phase}_error' not in result:
        result[f'{phase}_error'] = f'phase exited rc={proc.returncode}'
    if timed_out:
        result[f'{phase}_timeout'] = True
        result[f'{phase}_budget_s'] = round(timeout, 1)
    result[f'{phase}_phase_s'] = round(time.time() - t0, 1)
    return result


def _failed(record: dict) -> list:
    return sorted(k for k in record
                  if k.endswith('_timeout') or k.endswith('_error'))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='skypilot_tpu_torch.bench',
                                     description=__doc__.split('\n')[0])
    parser.add_argument('--phase', choices=PHASES)
    parser.add_argument('--out')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='run on the card (default; refuses to start '
                             'without one) or, asked for, on the CPU')
    parser.add_argument('--n-devices', type=int, default=1)
    args = parser.parse_args(argv)

    if args.phase:
        {'train': lambda: phase_train(args.out, args.device),
         'launched': lambda: phase_launched(args.out, args.device,
                                            args.n_devices),
         'serve': lambda: phase_serve(args.out, args.device),
         'decode': lambda: phase_decode(args.out, args.device)}[args.phase]()
        return 0

    t_start = time.time()
    on_card = args.device == 'cuda'
    n_devices = 1
    if on_card:
        probe = probe_card(timeout=_phase_budget('probe', PROBE_BUDGET_S))
        if probe is None:
            print('bench: no CUDA device visible; pass --device cpu to run '
                  'the PyTorch port on the CPU', file=sys.stderr)
            return 2
        n_devices = probe['n_devices']
        print(f'bench: probe={probe}', file=sys.stderr)

    def budget(phase: str) -> float:
        return _phase_budget(phase, BUDGETS[phase][0 if on_card else 1])

    record: dict = {}
    # Phase 1 — train. THE metric: runs first, emitted immediately, so no
    # later phase can erase it.
    record.update(run_phase('train', budget('train'), args.device))
    if 'value' not in record:  # the phase failed: a record all the same
        record.setdefault('metric', 'train_tokens_per_sec_per_chip')
        record.setdefault('value', 0.0)
        record.setdefault('unit', 'tokens/s/card (train phase failed)')
        record.setdefault('vs_baseline', None)
    _emit(record)

    # Phase 2 — launched (the trainer as a fresh process).
    record.update(run_phase('launched', budget('launched'), args.device,
                            ['--n-devices', str(n_devices)]))
    if record.get('launched_tokens_per_sec_per_chip') and record.get(
            'value'):
        record['launched_vs_inprocess'] = round(
            record['launched_tokens_per_sec_per_chip'] / record['value'], 3)
    _emit(record)

    # Phase 3 — serve (the budget covers every arm).
    record.update(run_phase('serve', budget('serve'), args.device))
    _emit(record)

    # Phase 4 — decode (fresh-process engine throughput).
    record.update(run_phase('decode', budget('decode'), args.device))
    record['bench_elapsed_s'] = round(time.time() - t_start, 1)
    _emit(record)
    failed = _failed(record)
    if failed:
        print(f'bench: failed phases: {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
