"""Paged-vs-contiguous decode microbench: step time + KV device bytes.

The port's counterpart of ``scripts/kv_microbench.py``, on the port's
``DecodeEngine``, with the same arms, flags and one-line JSON record. A
full serve sweep takes minutes and a replica; this is the short
regression probe for the paged-KV engine. It runs the SAME fixed-batch
decode loop twice — contiguous per-slot KV (``kv_block=0``) and paged
(``--kv-block``) — and reports per-step wall time plus the exact KV
state bytes. Further arms: sync-vs-async dispatch (``--async-depths``),
speculative decode (``--spec-ks``: accepted tokens per step + effective
tok/s per draft length on a repetitive prompt), quantized KV
(``--quant-ks``: int8-vs-bf16 bytes/token, step-time ratio, round-trip
error, greedy-stream agreement with spec decode off and on), span
tracing (``--trace-overhead``: traced-vs-plain step time) and roofline
attribution (``--roofline``: per-variant FLOPs/bytes/arithmetic
intensity/MFU from the engine's analytic cost model; PyTorch has no
compiled-cost analysis). Every monolithic admission runs K1, the flash
forward kernel, on the card::

    python -m skypilot_tpu_torch.benchmark.kv_microbench --device cpu
    python -m skypilot_tpu_torch.benchmark.kv_microbench --preset llama-1b \\
        --slots 16 --max-len 1024 --kv-block 64          # on the card

Step times are host wall clock around a synced loop. Prompts and the
sampling generator come from seeds (7 and 11, as the JAX probe's keys);
the bits differ from JAX's generator.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence

import torch

from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models.decode import (DecodeEngine, draft_tokens,
                                              prefill_bucket)


def _state_kv_bytes(state) -> int:
    """KV state footprint: pool halves plus (int8 mode) their scales."""
    return (int(state.k.nbytes) + int(state.v.nbytes)
            + int(state.k_scale.nbytes) + int(state.v_scale.nbytes))


def random_prompt(config, prompt_len: int, seed: int = 7) -> List[int]:
    """``prompt_len`` uniform token ids from ``seed`` (the JAX probe's
    ``key(7)`` prompt; other bits)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randint(0, config.vocab_size, (prompt_len,),
                         generator=gen).tolist()


def _rng(engine: DecodeEngine, seed: int = 11) -> torch.Generator:
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(seed)
    return gen


def _fill_slots(engine: DecodeEngine, params, prompt_len: int):
    """Admit the same random prompt into every slot (one monolithic
    prefill each) and step 4 times to warm; returns (state, rng)."""
    state = engine.init_state()
    prompt = random_prompt(engine.config, prompt_len)
    bucket = prefill_bucket(prompt_len, engine.max_len)
    padded = prompt + [0] * (bucket - prompt_len)
    rng = _rng(engine)
    for s in range(engine.batch_slots):
        state, _, rng = engine.admit(params, state, padded, prompt_len,
                                     s, rng)
    for _ in range(4):  # warm
        state, sampled, rng = engine.step(params, state, rng)
    int(sampled[0])
    return state, rng


def bench_engine(config, params, *, slots: int, max_len: int,
                 prompt_len: int, steps: int, kv_block: int,
                 kv_blocks=None, kv_dtype=None, device=None) -> dict:
    """Decode-step timing at full occupancy for one engine mode."""
    engine = DecodeEngine(config, batch_slots=slots, max_len=max_len,
                          kv_block=kv_block, kv_blocks=kv_blocks,
                          kv_dtype=kv_dtype, device=device)
    state, rng = _fill_slots(engine, params, prompt_len)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, sampled, rng = engine.step(params, state, rng)
    int(sampled[0])  # sync
    dt = time.perf_counter() - t0
    return {
        'mode': 'paged' if kv_block > 0 else 'contiguous',
        'kv_block': kv_block,
        'kv_blocks': engine.kv_blocks,
        'kv_dtype': engine.kv_dtype,
        'kv_bytes_per_token': engine.kv_bytes_per_token(),
        'step_ms': round(dt / steps * 1e3, 3),
        'decode_tokens_per_s': round(slots * steps / dt, 1),
        'kv_state_bytes': _state_kv_bytes(state),
        'kv_state_mib': round(_state_kv_bytes(state) / 2**20, 2),
    }


def bench_async(config, params, *, slots: int, max_len: int,
                prompt_len: int, steps: int, kv_block: int,
                kv_blocks=None, depth: int = 2,
                host_work_ms: float = 1.0, device=None) -> dict:
    """Sync-vs-async dispatch arm: the serving scheduler's dispatch
    pattern at a given in-flight depth. Each round dispatches a burst of
    ``depth`` steps back-to-back, then runs one completion pass — a
    single batched device-to-host fetch plus ``host_work_ms`` of
    emulated per-round host work (admission / release bookkeeping /
    detokenization stand-in). depth=1 is the synchronous schedule, where
    every recorded gap eats the host pass whole; depth>=2 amortizes it
    across the burst."""
    from collections import deque
    engine = DecodeEngine(config, batch_slots=slots, max_len=max_len,
                          kv_block=kv_block, kv_blocks=kv_blocks,
                          device=device)
    state, rng = _fill_slots(engine, params, prompt_len)

    inflight: 'deque' = deque()
    gaps_ms = []
    last_end = None
    done = 0
    t0 = time.perf_counter()
    while done < steps:
        burst = min(depth, steps - done)
        for _ in range(burst):
            t_start = time.perf_counter()
            if last_end is not None:
                gaps_ms.append((t_start - last_end) * 1e3)
            state, sampled, rng = engine.step(params, state, rng)
            last_end = time.perf_counter()
            inflight.append(sampled)
            done += 1
        # Completion pass for the round: ONE batched device-to-host
        # fetch for every queued step, then the emulated host work.
        arrs = [inflight.popleft().reshape(-1) for _ in range(len(inflight))]
        (torch.cat(arrs) if len(arrs) > 1 else arrs[0]).cpu()
        if host_work_ms > 0:
            time.sleep(host_work_ms / 1e3)
    dt = time.perf_counter() - t0
    gaps_ms.sort()
    return {
        'depth': depth,
        'host_work_ms': host_work_ms,
        'step_gap_p50_ms': round(gaps_ms[len(gaps_ms) // 2], 3)
        if gaps_ms else None,
        'step_gap_max_ms': round(gaps_ms[-1], 3) if gaps_ms else None,
        'effective_tokens_per_s': round(slots * steps / dt, 1),
    }


def _pattern_prompt(config, prompt_len: int, pattern: Sequence[int]
                    ) -> List[int]:
    return [pattern[i % len(pattern)] % config.vocab_size
            for i in range(prompt_len)]


def _greedy_stream(config, params, engine, prompt, n_tokens: int,
                   k: int, ngram: int = 3) -> list:
    """One slot's greedy stream under a given spec draft length (k=0 =
    plain steps) — the int8-vs-bf16 agreement probe's loop."""
    state = engine.init_state()
    rng = _rng(engine)
    bucket = prefill_bucket(len(prompt), engine.max_len)
    padded = list(prompt) + [0] * (bucket - len(prompt))
    state, first, rng = engine.admit(params, state, padded, len(prompt),
                                     0, rng)
    hist = list(prompt) + [int(first)]
    out = [int(first)]
    while len(out) < n_tokens:
        if k > 0:
            draft = [draft_tokens(hist, k, ngram), [0] * k]
            state, toks, acc, rng = engine.step_verify(params, state, rng,
                                                       draft)
            take = toks[0][:int(acc[0]) + 1].tolist()
        else:
            state, sampled, rng = engine.step(params, state, rng)
            take = [int(sampled[0])]
        out.extend(take)
        hist.extend(take)
    return out[:n_tokens]


def bench_spec(config, params, *, max_len: int, prompt_len: int,
               k: int, ngram: int = 3, out_tokens: int = 160,
               kv_block: int = 64, device=None) -> dict:
    """Spec-decode arm: accepted-tokens-per-step and effective tok/s for
    one draft length ``k`` on a repetitive prompt (the traffic shape
    prompt-lookup drafting targets). One slot is driven end-to-end as
    the scheduler drives it — host-side ``draft_tokens`` over the
    request's own history, one ``step_verify`` per round — so the tok/s
    includes the drafter's host cost. ``k=0`` runs the plain one-token
    step loop as the baseline."""
    slots = 2  # slot 1 stays inactive: exercises the masked-slot path
    engine = DecodeEngine(config, batch_slots=slots, max_len=max_len,
                          kv_block=kv_block, spec_tokens=k, device=device)
    prompt = _pattern_prompt(config, prompt_len, (5, 9, 2, 7, 11, 3))
    bucket = prefill_bucket(prompt_len, engine.max_len)
    padded = prompt + [0] * (bucket - prompt_len)

    def run():
        state = engine.init_state()
        rng = _rng(engine)
        state, first, rng = engine.admit(params, state, padded,
                                         prompt_len, 0, rng)
        hist = prompt + [int(first)]
        emitted, steps = 1, 0
        while emitted < out_tokens:
            if k > 0:
                draft = [draft_tokens(hist, k, ngram), [0] * k]
                state, out, acc, rng = engine.step_verify(
                    params, state, rng, draft)
                take = int(acc[0]) + 1
                hist.extend(out[0][:take].tolist())
            else:
                state, sampled, rng = engine.step(params, state, rng)
                take = 1
                hist.append(int(sampled[0]))
            emitted += take
            steps += 1
        return emitted, steps

    run()  # warm every variant the timed run hits
    t0 = time.perf_counter()
    emitted, steps = run()
    dt = time.perf_counter() - t0
    return {
        'k': k,
        'tokens': emitted,
        'decode_steps': steps,
        'accepted_per_step': round(emitted / steps, 2),
        'effective_tokens_per_s': round(emitted / dt, 1),
    }


def bench_quant(config, params, *, slots: int, max_len: int,
                prompt_len: int, steps: int, kv_block: int,
                kv_blocks=None, spec_ks=(0, 4), agree_tokens: int = 128,
                device=None) -> dict:
    """Quantized-KV arm: int8-vs-bf16 bytes/token and step time on the
    SAME paged workload, greedy-stream agreement per spec draft length,
    and the raw quantize->dequantize round-trip error."""
    common = dict(slots=slots, max_len=max_len, prompt_len=prompt_len,
                  steps=steps, kv_block=kv_block, kv_blocks=kv_blocks,
                  device=device)
    bf = bench_engine(config, params, **common)
    i8 = bench_engine(config, params, kv_dtype='int8', **common)

    # Round-trip error on KV-shaped data: per-row absmax symmetric
    # quantization bounds the error at scale/2 = absmax/254 per element.
    gen = torch.Generator()
    gen.manual_seed(3)
    x = torch.randn((config.num_kv_heads, kv_block, config.head_dim),
                    generator=gen)
    q, s = decode.quantize_kv_rows(x)
    err = (decode.dequantize_kv_rows(q, s) - x).abs()
    rel = float(err.max() / x.abs().max())

    agree_len = min(agree_tokens, max_len - prompt_len - 8)
    agreement = {}
    prompt = _pattern_prompt(config, prompt_len, (5, 9, 2, 7, 11, 3, 13, 4))
    for k in spec_ks:
        e_bf = DecodeEngine(config, batch_slots=2, max_len=max_len,
                            kv_block=kv_block, spec_tokens=k, device=device)
        e_i8 = DecodeEngine(config, batch_slots=2, max_len=max_len,
                            kv_block=kv_block, spec_tokens=k,
                            kv_dtype='int8', device=device)
        s_bf = _greedy_stream(config, params, e_bf, prompt, agree_len, k)
        s_i8 = _greedy_stream(config, params, e_i8, prompt, agree_len, k)
        agreement[f'k{k}'] = round(
            sum(a == b for a, b in zip(s_bf, s_i8)) / agree_len, 4)

    return {
        'bf16': bf,
        'int8': i8,
        'kv_bytes_reduction': round(
            bf['kv_bytes_per_token'] / i8['kv_bytes_per_token'], 2),
        'step_time_ratio': round(i8['step_ms'] / bf['step_ms'], 3)
        if bf['step_ms'] else None,
        'roundtrip_rel_err': round(rel, 5),
        'greedy_agreement': agreement,
        'agree_tokens': agree_len,
    }


def bench_trace_overhead(config, params, *, slots: int, max_len: int,
                         prompt_len: int, steps: int, kv_block: int,
                         kv_blocks=None, rounds: int = 3,
                         device=None) -> dict:
    """Span-tracing overhead arm: the SAME paged decode loop with and
    without the scheduler's per-step trace-ring recording (one decode
    span per slot per step, a verify point, an exemplar'd histogram
    observe). Interleaved A/B rounds with min-per-arm timing keep drift
    out of the ratio."""
    from skypilot_tpu_torch.utils import metrics as metrics_lib
    from skypilot_tpu_torch.utils import timeline

    engine = DecodeEngine(config, batch_slots=slots, max_len=max_len,
                          kv_block=kv_block, kv_blocks=kv_blocks,
                          device=device)
    state, rng = _fill_slots(engine, params, prompt_len)
    hist = metrics_lib.histogram('skytpu_bench_trace_overhead_ms',
                                 'trace-overhead arm probe histogram')

    def run(traced: bool, tag: int) -> float:
        nonlocal state, rng
        rids = [f'bench-{tag}-{s}' for s in range(slots)]
        t0 = time.perf_counter()
        for i in range(steps):
            t_step = time.perf_counter()
            state, sampled, rng = engine.step(params, state, rng)
            if traced:
                end = time.time()
                dur = time.perf_counter() - t_step
                for rid in rids:
                    timeline.trace_span(rid, 'decode', end - dur, end,
                                        steps=1, spec=False)
                timeline.trace_point(rids[i % slots], 'verify', end,
                                     k=0, accepted=1)
                hist.observe(dur * 1e3, exemplar=rids[i % slots])
            if (i + 1) % 16 == 0:  # exercise ring sealing too
                if traced:
                    for rid in rids:
                        timeline.trace_finish(rid, status='ok')
                    rids = [f'bench-{tag}-{s}-{i}' for s in range(slots)]
        int(sampled[0])  # sync
        dt = time.perf_counter() - t0
        if traced:
            for rid in rids:
                timeline.trace_finish(rid, status='ok')
        return dt

    run(True, -1)  # warm the trace path (ring allocation)
    best = {False: float('inf'), True: float('inf')}
    for r in range(rounds):
        for traced in (False, True) if r % 2 == 0 else (True, False):
            best[traced] = min(best[traced], run(traced, r))
    plain_ms = best[False] / steps * 1e3
    traced_ms = best[True] / steps * 1e3
    return {
        'step_ms_plain': round(plain_ms, 4),
        'step_ms_traced': round(traced_ms, 4),
        'overhead_pct': round((traced_ms / plain_ms - 1) * 100, 2)
        if plain_ms else None,
        'spans_per_step': slots + 1,
        'rounds': rounds,
    }


def bench_roofline(config, params, *, slots: int, max_len: int,
                   prompt_len: int, steps: int, kv_block: int,
                   kv_blocks=None, device=None) -> dict:
    """Roofline arm: run the paged decode loop, timing each synced step
    into the profiler's per-variant EWMA, then attribute the engine's
    analytic FLOPs/bytes to each variant. Returns variant -> {flops,
    bytes, ai, step_ms, mfu} — the numbers the
    ``skytpu_engine_step_{flops,bytes,ai,mfu}`` gauges export. MFU is
    against $SKYTPU_PEAK_TFLOPS, else the card's bf16 peak (0 on the
    CPU)."""
    from skypilot_tpu_torch import accelerators
    engine = DecodeEngine(config, batch_slots=slots, max_len=max_len,
                          kv_block=kv_block, kv_blocks=kv_blocks,
                          device=device)
    state, rng = _fill_slots(engine, params, prompt_len)
    for _ in range(steps):  # measured: feeds the per-variant step EWMA
        t0 = time.perf_counter()
        state, sampled, rng = engine.step(params, state, rng)
        int(sampled[0])
        engine.profiler.note_step(time.perf_counter() - t0)
    engine.profiler.note_roofline(engine.roofline_costs(params, state))
    peak = (decode.peak_flops()
            or accelerators.peak_bf16_flops(engine.device) or 0.0)
    snap = engine.profiler.roofline_snapshot(peak)
    for variant in sorted(snap):
        row = snap[variant]
        print(f'# roofline {variant}: flops={row["flops"]:.3e} '
              f'bytes={row["bytes"]:.3e} ai={row["ai"]:.2f} '
              f'mfu={row["mfu"]:.4f}', file=sys.stderr)
    return snap


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='skypilot_tpu_torch.benchmark.kv_microbench',
        description=__doc__.split('\n')[0])
    parser.add_argument('--preset', default='test-tiny')
    parser.add_argument('--slots', type=int, default=4)
    parser.add_argument('--max-len', type=int, default=128)
    parser.add_argument('--prompt-len', type=int, default=24)
    parser.add_argument('--steps', type=int, default=32)
    parser.add_argument('--kv-block', type=int, default=64,
                        help='block rows for the paged arm')
    parser.add_argument('--kv-blocks', type=int, default=None,
                        help='paged pool size (default: contiguous memory '
                             'budget at --slots)')
    parser.add_argument('--async-depths', type=int, nargs='*',
                        default=(1, 2, 4),
                        help='in-flight depths for the sync-vs-async '
                             'arm (empty = skip)')
    parser.add_argument('--host-work-ms', type=float, default=1.0,
                        help='emulated per-step host latency in the '
                             'async arm')
    parser.add_argument('--spec-ks', type=int, nargs='*',
                        default=(0, 2, 4, 8),
                        help='draft lengths for the spec-decode arm '
                             '(0 = plain-step baseline; empty = skip)')
    parser.add_argument('--spec-ngram', type=int, default=3,
                        help='drafter n-gram length in the spec arm')
    parser.add_argument('--quant-ks', type=int, nargs='*',
                        default=(0, 4),
                        help='spec draft lengths for the int8-vs-bf16 '
                             'agreement probe in the quant arm '
                             '(empty = skip the quant arm)')
    parser.add_argument('--trace-overhead', action='store_true',
                        help='add the span-tracing overhead arm '
                             '(traced-vs-plain decode step time)')
    parser.add_argument('--roofline', action='store_true',
                        help='add the roofline-attribution arm '
                             '(variant -> FLOPs/bytes/AI/MFU)')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='device to run on (default cuda; refuses to '
                             'start without one unless cpu is asked for)')
    return parser


def random_params(config, device, seed: int = 0):
    """The preset's random weights in the config dtype, drawn on
    ``device`` from ``seed`` (the replica's ``--seed`` weights)."""
    from skypilot_tpu_torch.models.llama import LlamaModel
    model = LlamaModel(config, device=device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return model.init(gen)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from skypilot_tpu_torch.models.llama import PRESETS
    from skypilot_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = PRESETS[args.preset]
    params = random_params(config, device)

    common = dict(slots=args.slots, max_len=args.max_len,
                  prompt_len=min(args.prompt_len, args.max_len - 1),
                  steps=args.steps, device=device)
    contiguous = bench_engine(config, params, kv_block=0, **common)
    paged = bench_engine(config, params, kv_block=args.kv_block,
                         kv_blocks=args.kv_blocks, **common)
    record = {
        'preset': args.preset,
        'batch_slots': args.slots,
        'max_len': args.max_len,
        'prompt_len': common['prompt_len'],
        'backend': device.type,
        'contiguous': contiguous,
        'paged': paged,
        'paged_step_overhead_pct': round(
            (paged['step_ms'] / contiguous['step_ms'] - 1) * 100, 1)
        if contiguous['step_ms'] else None,
        # Sync-vs-async dispatch: step gap + effective tok/s per depth
        # (depth 1 = the synchronous oracle), paged engine.
        'async': [bench_async(config, params, kv_block=args.kv_block,
                              kv_blocks=args.kv_blocks, depth=d,
                              host_work_ms=args.host_work_ms, **common)
                  for d in (args.async_depths or ())],
    }
    if args.quant_ks:
        # Quant arm needs room for the agreement stream; reuse the spec
        # arm's length floor.
        quant_max_len = max(args.max_len, 256)
        record['quant'] = bench_quant(
            config, params, slots=args.slots, max_len=quant_max_len,
            prompt_len=common['prompt_len'], steps=args.steps,
            kv_block=args.kv_block, spec_ks=tuple(args.quant_ks),
            device=device)
    if args.spec_ks:
        # Own max_len: the stream needs room to settle into a cycle the
        # drafter can lock onto before the length budget runs out. Pool
        # size is left derived (kv_blocks=None) so a --kv-blocks tuned
        # for --max-len never undersizes this arm.
        spec_max_len = max(args.max_len, 256)
        spec_out = min(200, spec_max_len - common['prompt_len'] - 16)
        record['spec'] = [
            bench_spec(config, params, max_len=spec_max_len,
                       prompt_len=common['prompt_len'], k=k,
                       ngram=args.spec_ngram, out_tokens=spec_out,
                       kv_block=args.kv_block, device=device)
            for k in args.spec_ks]
    if args.trace_overhead:
        record['trace_overhead'] = bench_trace_overhead(
            config, params, kv_block=args.kv_block,
            kv_blocks=args.kv_blocks, **common)
    if args.roofline:
        record['roofline'] = bench_roofline(
            config, params, kv_block=args.kv_block,
            kv_blocks=args.kv_blocks, **common)
    print(json.dumps(record))
    return 0


if __name__ == '__main__':
    sys.exit(main())
