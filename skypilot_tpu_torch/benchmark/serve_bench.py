"""Serve-path benchmark: closed-loop streaming load against a replica.

The port's counterpart of ``skypilot_tpu/benchmark/serve_bench.py``: the
same client (streaming closed-loop clients, TTFT at the first streamed
line, nearest-rank percentiles, the shared-system-prompt arm, the
replica's ``/metrics`` summary) and the same ``run`` record. The
workload shape is the serving anchor's: ~2500 input / ~150 output tokens
per request at a sweep of client concurrencies.

What differs is the stand-up. The JAX harness starts a service through
its serve controller and load balancer on the local cloud; the port
imports no control plane, so ``_bench_replica`` starts the port's
replica (``python -m skypilot_tpu_torch.serve.generation_server``) as a
subprocess in its own process group on a free port, passes the arm's
knobs through the same ``SKYTPU_*`` environment variables, drives it
directly, and kills the process group on every way out. The replica
owns the card; the caller must not hold it.
"""
from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

# The replica knobs an arm sets through the environment (the JAX
# harness's ``make_task`` envs). The caller's own values of them are not
# inherited, so each arm runs exactly the configuration it names.
KNOB_ENV = ('SKYTPU_PREFILL_CHUNK', 'SKYTPU_TTFT_SLO_MS', 'SKYTPU_KV_BLOCK',
            'SKYTPU_KV_BLOCKS', 'SKYTPU_SPEC_TOKENS', 'SKYTPU_KV_DTYPE')
REPLICA_MODULE = 'skypilot_tpu_torch.serve.generation_server'


def summarize_metrics_text(text: str) -> Dict[str, Any]:
    """Server-side histogram/counter summaries from a replica's /metrics
    exposition — the production-signal counterpart of the client-side
    sweep numbers (client TTFT includes the HTTP path; these are the
    replica's own measurements, and the variant counter is invisible to
    clients entirely)."""
    from skypilot_tpu_torch.utils import metrics as metrics_lib
    samples = metrics_lib.parse_text(text)
    out: Dict[str, Any] = {}
    for name in ('skytpu_serve_ttft_ms', 'skytpu_serve_tpot_ms',
                 'skytpu_serve_queue_wait_ms',
                 'skytpu_serve_ttft_estimate_error_ms',
                 'skytpu_engine_step_ms',
                 # Spec-decode: accept histogram observes accept+1
                 # (tokens emitted per slot per verify step), so its
                 # mean is accepted_tokens_per_step directly.
                 'skytpu_engine_spec_accept_tokens',
                 'skytpu_engine_spec_verify_ms'):
        cum = metrics_lib.histogram_cumulative(samples, name)
        count = metrics_lib.sample_value(samples, f'{name}_count')
        total = metrics_lib.sample_value(samples, f'{name}_sum')
        if not cum or not count:
            continue
        p50 = metrics_lib.histogram_quantile(cum, 0.5)
        p99 = metrics_lib.histogram_quantile(cum, 0.99)
        out[name] = {
            'count': int(count),
            'mean': round(total / count, 3) if total is not None else None,
            'p50_est': round(p50, 2) if p50 is not None else None,
            'p99_est': round(p99, 2) if p99 is not None else None,
        }
    for name in ('skytpu_serve_requests_total',
                 'skytpu_serve_rejected_total',
                 'skytpu_serve_slo_violations_total',
                 'skytpu_engine_recompiles_total',
                 'skytpu_engine_prefill_tokens_total',
                 'skytpu_engine_decode_tokens_total',
                 'skytpu_engine_occupancy_ratio',
                 'skytpu_engine_kv_block_utilization_ratio',
                 'skytpu_engine_kv_prefix_hits_total',
                 'skytpu_engine_kv_prefix_hit_tokens_total',
                 'skytpu_engine_kv_prefix_lookup_tokens_total',
                 'skytpu_engine_kv_evictions_total',
                 'skytpu_engine_spec_draft_hits_total',
                 'skytpu_serve_slo_headroom_ms'):
        v = metrics_lib.sample_value(samples, name)
        if v is not None:
            out[name] = round(v, 3)
    return out


def _percentile(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile (no interpolation; robust for small N)."""
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(pct / 100.0
                                                 * (len(ordered) - 1)))))
    return ordered[idx]


def make_prompt(rnd: random.Random, vocab_size: int, prompt_len: int,
                shared_prefix: Optional[Sequence[int]] = None
                ) -> List[int]:
    """One workload prompt: random ids, optionally behind a common
    prefix (the millions-of-users-one-system-prompt shape the paged-KV
    prefix cache serves). The prefix is truncated to leave >= 1 random
    suffix token so every request is a distinct sequence."""
    if not shared_prefix:
        return [rnd.randrange(vocab_size) for _ in range(prompt_len)]
    prefix = list(shared_prefix)[:max(0, prompt_len - 1)]
    return prefix + [rnd.randrange(vocab_size)
                     for _ in range(prompt_len - len(prefix))]


def _post_generate(endpoint: str, tokens: List[int], max_tokens: int,
                   stream: bool, timeout: float = 900.0):
    body = json.dumps({'tokens': tokens, 'max_tokens': max_tokens,
                       'stream': stream}).encode()
    req = urllib.request.Request(endpoint + '/generate', data=body,
                                 headers={'Content-Type':
                                          'application/json'})
    return urllib.request.urlopen(req, timeout=timeout)


def drive_load(endpoint: str, *, vocab_size: int, prompt_len: int,
               output_len: int, concurrency: int, window_s: float,
               seed: int = 0,
               shared_prefix: Optional[Sequence[int]] = None
               ) -> Dict[str, Any]:
    """Closed-loop load: ``concurrency`` clients, each streaming one
    request at a time, for ``window_s`` seconds. Only requests that
    complete inside the window with at least two tokens count (their
    TTFT/TPOT are client-side wall-clock measurements, not
    server-reported). With ``shared_prefix``, every prompt starts with
    that common token run — the shared-system-prompt workload arm."""
    results: List[Tuple[float, float, int]] = []  # (ttft_s, total_s, n_out)
    errors = [0]
    rejected = [0]
    lock = threading.Lock()
    t_start = time.perf_counter()
    stop_at = t_start + window_s

    def client(tid: int) -> None:
        rnd = random.Random(seed * 1000 + tid)
        while time.perf_counter() < stop_at:
            tokens = make_prompt(rnd, vocab_size, prompt_len,
                                 shared_prefix)
            t0 = time.perf_counter()
            try:
                with _post_generate(endpoint, tokens, output_len,
                                    stream=True) as resp:
                    first: Optional[float] = None
                    n_out = 0
                    for line in resp:
                        if first is None:
                            first = time.perf_counter()
                        try:
                            obj = json.loads(line)
                        except ValueError:
                            continue
                        if 'token' in obj:
                            n_out += 1
                        if obj.get('done') or obj.get('error'):
                            break
                t1 = time.perf_counter()
                if first is not None and n_out >= 2 and t1 <= stop_at:
                    with lock:
                        results.append((first - t0, t1 - t0, n_out))
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    # Admission early-reject: expected behavior past the
                    # saturation knee, counted separately from errors.
                    # Honor Retry-After (capped: a closed-loop client
                    # that sleeps out the window measures nothing).
                    with lock:
                        rejected[0] += 1
                    try:
                        delay = float(e.headers.get('Retry-After', '1'))
                    except (TypeError, ValueError):
                        delay = 1.0
                    time.sleep(min(max(delay, 0.1), 2.0))
                else:
                    with lock:
                        errors[0] += 1
                    time.sleep(0.5)
            except (urllib.error.URLError, OSError, ValueError):
                with lock:
                    errors[0] += 1
                time.sleep(0.5)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=window_s + 900)

    if not results:
        return {'concurrency': concurrency, 'completed': 0,
                'errors': errors[0], 'rejected': rejected[0],
                'req_per_s': 0.0}
    ttfts = [r[0] * 1e3 for r in results]
    tpots = [(r[1] - r[0]) * 1e3 / (r[2] - 1) for r in results]
    total_out = sum(r[2] for r in results)
    return {
        'concurrency': concurrency,
        'completed': len(results),
        'errors': errors[0],
        'rejected': rejected[0],
        'req_per_s': round(len(results) / window_s, 3),
        'output_tokens_per_s': round(total_out / window_s, 1),
        'ttft_p50_ms': round(_percentile(ttfts, 50), 1),
        'ttft_p99_ms': round(_percentile(ttfts, 99), 1),
        'tpot_p50_ms': round(_percentile(tpots, 50), 2),
        'tpot_p99_ms': round(_percentile(tpots, 99), 2),
    }


def _fetch_stats(endpoint: str) -> Dict[str, Any]:
    try:
        with urllib.request.urlopen(endpoint + '/stats',
                                    timeout=30) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError):
        return {}


def _prefix_arm(endpoint: str, *, vocab_size: int, prompt_len: int,
                prefix_len: int, output_len: int, concurrency: int,
                window_s: float) -> Dict[str, Any]:
    """Shared-system-prompt arm: N closed-loop clients whose prompts
    share a ``prefix_len`` common prefix. Records the replica's
    prefix-cache hit rate over the arm (delta of the cumulative /stats
    counters, so earlier random-prompt traffic doesn't dilute it) and
    the KV block utilization sampled mid-load (after the window every
    release has freed its blocks and the gauge reads 0)."""
    rnd = random.Random(4242)
    prefix = [rnd.randrange(vocab_size)
              for _ in range(min(prefix_len, prompt_len - 1))]
    before = _fetch_stats(endpoint)
    sweep_box: Dict[str, Any] = {}

    def _drive() -> None:
        sweep_box.update(drive_load(
            endpoint, vocab_size=vocab_size, prompt_len=prompt_len,
            output_len=output_len, concurrency=concurrency,
            window_s=window_s, seed=77, shared_prefix=prefix))

    t = threading.Thread(target=_drive, daemon=True)
    t.start()
    time.sleep(window_s * 0.6)
    mid = _fetch_stats(endpoint)
    t.join(timeout=window_s + 900)
    after = _fetch_stats(endpoint)
    out: Dict[str, Any] = {'prefix_len': len(prefix),
                           'sweep': sweep_box}
    d_hit = (after.get('prefix_hit_tokens', 0)
             - before.get('prefix_hit_tokens', 0))
    d_lookup = (after.get('prefix_lookup_tokens', 0)
                - before.get('prefix_lookup_tokens', 0))
    d_admits = (after.get('prefix_lookups', 0)
                - before.get('prefix_lookups', 0))
    # Headline hit rate is over the SHAREABLE tokens (the block-aligned
    # common prefix) per admission: random suffixes can never hit, so a
    # whole-prompt denominator would cap the metric at prefix/prompt_len
    # (~0.82 at the 2048/2500 anchor shape) no matter how well the cache
    # works. Steady-state perfect sharing reads ~1.0 here; the raw
    # all-tokens ratio rides along for context.
    kv_block = int(after.get('kv_block', 0) or 0)
    shareable = (len(prefix) // kv_block) * kv_block if kv_block else 0
    if d_admits > 0 and shareable > 0:
        out['prefix_hit_rate'] = round(
            d_hit / (d_admits * shareable), 4)
    if d_lookup > 0:
        out['prefix_hit_rate_all_tokens'] = round(d_hit / d_lookup, 4)
    if 'kv_block_utilization' in mid:
        out['kv_block_utilization'] = mid['kv_block_utilization']
        out['kv_blocks_total'] = mid.get('kv_blocks_total')
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def package_pythonpath(env: Dict[str, str]) -> str:
    """``PYTHONPATH`` for a child process that runs a module of this
    package: the directory holding ``skypilot_tpu_torch`` first, then
    what ``env`` already had."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rest = env.get('PYTHONPATH')
    return root + (os.pathsep + rest if rest else '')


# Run as ``python -c SRC <parent pid> <cmd...>``: has the kernel SIGKILL
# this process when the thread that started it exits (Linux
# PR_SET_PDEATHSIG, kept across the exec), gives up if that parent is
# already gone, then execs the command in place.
_DIE_WITH_PARENT = (
    'import ctypes, os, signal, sys\n'
    'ctypes.CDLL(None).prctl(1, signal.SIGKILL)\n'
    'if os.getppid() != int(sys.argv[1]):\n'
    '    sys.exit(1)\n'
    'os.execvp(sys.argv[2], sys.argv[2:])\n')


def spawn(cmd: Sequence[str], env: Dict[str, str], stdout
          ) -> subprocess.Popen:
    """Start ``cmd`` as the leader of a process group of its own (so
    ``kill_group`` reaches everything it starts), with the package on its
    ``PYTHONPATH``. On Linux it also dies with the thread that started
    it, so a bench phase killed at its budget takes its replica or
    trainer with it."""
    env = dict(env, PYTHONPATH=package_pythonpath(env))
    try:
        stdout.fileno()
    except (AttributeError, OSError, ValueError):
        stdout = None  # not a real file (a test's capture): inherit
    if sys.platform.startswith('linux'):
        cmd = [sys.executable, '-c', _DIE_WITH_PARENT, str(os.getpid()),
               *cmd]
    return subprocess.Popen(list(cmd), env=env, stdout=stdout,
                            stderr=subprocess.STDOUT,
                            stdin=subprocess.DEVNULL,
                            start_new_session=True)


def kill_group(proc: subprocess.Popen, grace_s: float = 5.0) -> None:
    """SIGTERM ``proc``'s process group, SIGKILL whatever of it is left
    after ``grace_s``, and reap ``proc``."""
    for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 10.0)):
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            pass


def _log_tail(path: str, nbytes: int = 2000) -> str:
    try:
        with open(path, 'rb') as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode('utf-8', 'replace')
    except OSError:
        return ''


def start_replica(argv: Sequence[str], envs: Dict[str, str], log_path: str,
                  port: Optional[int] = None
                  ) -> Tuple[subprocess.Popen, str]:
    """Start the port's replica with ``argv`` and the knob ``envs`` in a
    process group of its own, on ``port`` (a free one by default), its
    output in ``log_path``. Returns (process, endpoint URL)."""
    port = port or _free_port()
    env = {k: v for k, v in os.environ.items() if k not in KNOB_ENV}
    env.update(envs)
    env['SKYTPU_SERVE_REPLICA_PORT'] = str(port)
    with open(log_path, 'ab') as log:
        proc = spawn([sys.executable, '-m', REPLICA_MODULE, *argv], env,
                     log)
    return proc, f'http://127.0.0.1:{port}'


def wait_healthy(proc: subprocess.Popen, endpoint: str, timeout_s: float,
                 log_path: str) -> float:
    """Wait until the replica answers /health with 200 (it answers 503
    until its warmup is done); seconds waited. Raises if the process
    exits or the deadline passes first."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if proc.poll() is not None:
            raise RuntimeError(
                f'replica exited with {proc.returncode} before it was '
                f'healthy; log tail:\n{_log_tail(log_path)}')
        try:
            with urllib.request.urlopen(endpoint + '/health',
                                        timeout=5) as resp:
                if resp.status == 200:
                    return time.time() - t0
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(1.0)
    raise TimeoutError(f'replica not healthy within {timeout_s}s; log '
                       f'tail:\n{_log_tail(log_path)}')


def _bench_replica(*, argv: Sequence[str], envs: Dict[str, str],
                   service_name: str, vocab_size: int, prompt_len: int,
                   output_len: int, concurrencies: Sequence[int],
                   window_s: float, warmup_requests: int,
                   ready_timeout_s: float, warmup_deadline_s: float,
                   prefix_share_len: int = 0,
                   progress=None) -> Dict[str, Any]:
    """Stand up ONE replica subprocess with ``argv`` and ``envs``, warm
    it, sweep concurrency, run the prefix arm, fetch its /stats and
    /metrics, tear it down. Returns {'sweep', 'warmup_failed', 'stats',
    'metrics', 'prefix'}; ``progress(sweep_so_far)`` persists partial
    results."""
    out: Dict[str, Any] = {'sweep': [], 'warmup_failed': False,
                           'stats': {}, 'metrics': {}, 'prefix': {}}
    log_fd, log_path = tempfile.mkstemp(prefix=f'{service_name}-',
                                        suffix='.log')
    os.close(log_fd)
    proc, endpoint = start_replica(argv, envs, log_path)
    try:
        ready_s = wait_healthy(proc, endpoint, ready_timeout_s, log_path)
        print(f'serve bench [{service_name}] replica healthy after '
              f'{ready_s:.1f}s (pid {proc.pid})', file=sys.stderr)

        # Warmup: the first full-length request runs the prompt's
        # prefill shapes (or the chunk variants) once; repeats hit the
        # caches. Per-attempt timeout + overall deadline: a healthy but
        # hung replica must fail the phase in minutes, not hang the
        # whole bench on 30 x 3-minute request timeouts.
        if progress is not None:
            progress([])  # replica healthy: persist the config fields
        rnd = random.Random(7)
        warm_deadline = time.time() + warmup_deadline_s
        warmed = False
        for i in range(max(1, warmup_requests)):
            tokens = [rnd.randrange(vocab_size)
                      for _ in range(prompt_len)]
            # The last warmup request goes through the STREAMING path —
            # the sweep measures streaming, so its first-hit costs must
            # be paid here, not inside the first measured window.
            stream = i == max(1, warmup_requests) - 1
            for _attempt in range(30):
                if time.time() > warm_deadline:
                    raise TimeoutError('serve warmup never completed '
                                       '(replica hung)')
                try:
                    with _post_generate(endpoint, tokens,
                                        min(output_len, 16),
                                        stream=stream,
                                        timeout=180) as resp:
                        resp.read()
                    warmed = True
                    break
                except (urllib.error.URLError, OSError):
                    time.sleep(2.0)
        if not warmed:
            # Every attempt failed but the deadline never fired (e.g. fast
            # connection-refused loops): the sweep below would fold
            # first-call costs into TTFT/TPOT. Record it so the numbers
            # are legible.
            out['warmup_failed'] = True
            print('serve bench WARNING: warmup exhausted all attempts '
                  'without a successful request; sweep numbers include '
                  'first-call costs', file=sys.stderr)

        if warmed and concurrencies:
            # Discarded burn-in at the first sweep's concurrency: the
            # first measured window otherwise absorbs one-time costs the
            # single-request warmup can't reach (per-client connections,
            # the admission queue filling to steady state). ~15s of load
            # washes that out of the measured numbers.
            burn = drive_load(endpoint, vocab_size=vocab_size,
                              prompt_len=prompt_len,
                              output_len=output_len,
                              concurrency=concurrencies[0],
                              window_s=15.0, seed=999)
            print(f'serve bench burn-in (discarded): {burn}',
                  file=sys.stderr)

        sweep: List[Dict[str, Any]] = []
        for conc in concurrencies:
            stats = drive_load(endpoint, vocab_size=vocab_size,
                               prompt_len=prompt_len,
                               output_len=output_len, concurrency=conc,
                               window_s=window_s, seed=conc)
            print(f'serve bench [{service_name}] @ concurrency {conc}: '
                  f'{stats}', file=sys.stderr)
            sweep.append(stats)
            if progress is not None:
                progress(sweep)
        out['sweep'] = sweep
        if warmed and prefix_share_len > 0 and concurrencies:
            # Shared-prefix workload arm at the sweep's top concurrency:
            # the prefix-cache measurement rides the same replica.
            out['prefix'] = _prefix_arm(
                endpoint, vocab_size=vocab_size, prompt_len=prompt_len,
                prefix_len=prefix_share_len, output_len=output_len,
                concurrency=max(concurrencies), window_s=window_s)
            print(f'serve bench [{service_name}] shared-prefix arm: '
                  f"{out['prefix']}", file=sys.stderr)
        # Replica counters: the rejected count is the admission-control
        # signal.
        out['stats'] = _fetch_stats(endpoint)
        # Server-side ttft/tpot/queue-wait histograms + the variant
        # counter land in the record next to the client-side sweep.
        try:
            with urllib.request.urlopen(endpoint + '/metrics',
                                        timeout=30) as resp:
                out['metrics'] = summarize_metrics_text(
                    resp.read().decode('utf-8', 'replace'))
        except (urllib.error.URLError, OSError, ValueError):
            pass
    finally:
        kill_group(proc)
        try:
            os.remove(log_path)
        except OSError:
            pass
    return out


def run(*, preset: str = 'llama-1b', batch_slots: int = 16,
        max_len: int = 4096, prompt_len: int = 2500, output_len: int = 150,
        concurrencies: Sequence[int] = (8, 24), window_s: float = 75.0,
        warmup_requests: int = 2, ready_timeout_s: float = 900.0,
        warmup_deadline_s: Optional[float] = None,
        service_name: str = 'bench-serve',
        progress=None, prefill_chunk: int = 0, ttft_slo_ms: float = 0.0,
        ab_monolithic: bool = False, prefix_share_len: int = 0,
        kv_block: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        spec_tokens: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        device: str = 'cuda') -> Dict[str, Any]:
    """Serve-path sweep, optionally A/B'd chunked-vs-monolithic.

    The headline replica runs with ``prefill_chunk``/``ttft_slo_ms``
    ($SKYTPU_PREFILL_CHUNK + $SKYTPU_TTFT_SLO_MS). With ``ab_monolithic``
    and a nonzero chunk, a monolithic-prefill control replica runs the
    SAME sweep first and its points land in ``serve_sweep_monolithic`` +
    the per-concurrency ``serve_ttft_p99_ab`` table. Returns the sweep
    plus the best-throughput point flattened into ``serve_*`` fields.

    ``prefix_share_len`` > 0 appends a shared-system-prompt arm to the
    headline replica and records ``serve_prefix_hit_rate`` +
    ``serve_kv_block_utilization``. ``kv_block``/``kv_blocks``
    ($SKYTPU_KV_BLOCK/$SKYTPU_KV_BLOCKS) pin the paged-KV pool geometry;
    ``spec_tokens`` ($SKYTPU_SPEC_TOKENS) the speculative draft length;
    ``kv_dtype`` ($SKYTPU_KV_DTYPE) the KV storage dtype. ``device`` is
    the replica's ``--device`` (``cpu`` only when asked for). The
    arguments and the record are the JAX harness's; ``service_name``
    names the replica's log here."""
    from skypilot_tpu_torch.models.llama import PRESETS

    config = PRESETS[preset]
    if warmup_deadline_s is None:
        warmup_deadline_s = max(300.0, ready_timeout_s / 2)

    def replica_args(chunk: int, slo_ms: float):
        envs = {}
        if chunk:
            envs['SKYTPU_PREFILL_CHUNK'] = str(int(chunk))
        if slo_ms:
            envs['SKYTPU_TTFT_SLO_MS'] = str(float(slo_ms))
        if kv_block is not None:
            envs['SKYTPU_KV_BLOCK'] = str(int(kv_block))
        if kv_blocks is not None:
            envs['SKYTPU_KV_BLOCKS'] = str(int(kv_blocks))
        if spec_tokens is not None:
            envs['SKYTPU_SPEC_TOKENS'] = str(int(spec_tokens))
        if kv_dtype is not None:
            envs['SKYTPU_KV_DTYPE'] = str(kv_dtype)
        argv = ['--preset', preset, '--batch-slots', str(batch_slots),
                '--max-len', str(max_len), '--device', device]
        return {'argv': argv, 'envs': envs}

    out: Dict[str, Any] = {
        'serve_model_params': int(config.num_params),
        'serve_model_params_b': round(config.num_params / 1e9, 3),
        'serve_prompt_len': prompt_len,
        'serve_output_len': output_len,
        'serve_batch_slots': batch_slots,
        'serve_prefill_chunk': prefill_chunk,
        'serve_ttft_slo_ms': ttft_slo_ms,
        'serve_prefix_share_len': prefix_share_len,
    }
    if kv_block is not None:
        out['serve_kv_block'] = kv_block
    if kv_blocks is not None:
        out['serve_kv_blocks'] = kv_blocks
    if spec_tokens is not None:
        out['serve_spec_tokens'] = spec_tokens
    if kv_dtype is not None:
        out['serve_kv_dtype'] = kv_dtype

    def sub_progress(field: str):
        if progress is None:
            return None

        def cb(sweep):
            progress({**out, field: sweep} if sweep else dict(out))
        return cb

    common = dict(vocab_size=config.vocab_size, prompt_len=prompt_len,
                  output_len=output_len, concurrencies=concurrencies,
                  window_s=window_s, warmup_requests=warmup_requests,
                  ready_timeout_s=ready_timeout_s,
                  warmup_deadline_s=warmup_deadline_s)
    if ab_monolithic and prefill_chunk:
        # The control arm is context, not the measurement: a flake here
        # (replica never healthy, warmup timeout) must not abort the
        # headline chunked arm below.
        try:
            mono = _bench_replica(service_name=service_name + '-mono',
                                  progress=sub_progress(
                                      'serve_sweep_monolithic'),
                                  **replica_args(0, 0.0), **common)
        except Exception as e:  # noqa: BLE001
            out['serve_mono_error'] = f'{type(e).__name__}: {e}'
            print(f'serve bench WARNING: monolithic control arm failed '
                  f'({e}); continuing to the chunked arm',
                  file=sys.stderr)
        else:
            out['serve_sweep_monolithic'] = mono['sweep']
            if mono['warmup_failed']:
                out['serve_mono_warmup_failed'] = True

    main = _bench_replica(service_name=service_name,
                          progress=sub_progress('serve_sweep'),
                          prefix_share_len=prefix_share_len,
                          **replica_args(prefill_chunk, ttft_slo_ms),
                          **common)
    sweep = main['sweep']
    out['serve_sweep'] = sweep
    if main['warmup_failed']:
        out['serve_warmup_failed'] = True
    if main.get('metrics'):
        out['serve_replica_metrics_summary'] = main['metrics']
    if main.get('prefix'):
        prefix = main['prefix']
        out['serve_prefix_sweep'] = prefix.get('sweep', {})
        if 'prefix_hit_rate' in prefix:
            out['serve_prefix_hit_rate'] = prefix['prefix_hit_rate']
        if 'kv_block_utilization' in prefix:
            out['serve_kv_block_utilization'] = (
                prefix['kv_block_utilization'])
    if main['stats']:
        out['serve_rejected'] = main['stats'].get('rejected', 0)
        out['serve_replica_stats'] = {
            k: main['stats'][k]
            for k in ('requests', 'rejected', 'queue_depth',
                      'prefill_chunk', 'ttft_slo_ms',
                      'prefill_tokens_per_s', 'kv_block',
                      'kv_blocks_total', 'prefix_hits',
                      'prefix_hit_rate', 'prefix_evictions')
            if k in main['stats']}
    if out.get('serve_sweep_monolithic'):
        # Per-concurrency TTFT p99 A/B: chunked + admission against the
        # monolithic control.
        mono_by_c = {s['concurrency']: s
                     for s in out['serve_sweep_monolithic']}
        out['serve_ttft_p99_ab'] = [
            {'concurrency': s['concurrency'],
             'monolithic_ms': mono_by_c.get(s['concurrency'],
                                            {}).get('ttft_p99_ms'),
             'chunked_ms': s.get('ttft_p99_ms')}
            for s in sweep]
    if sweep:
        best = max(sweep, key=lambda s: s.get('req_per_s', 0.0))
        if best.get('completed'):
            out.update({
                'serve_req_per_s': best['req_per_s'],
                'serve_output_tokens_per_s': best['output_tokens_per_s'],
                'serve_ttft_p50_ms': best['ttft_p50_ms'],
                'serve_ttft_p99_ms': best['ttft_p99_ms'],
                'serve_tpot_p50_ms': best['tpot_p50_ms'],
                'serve_tpot_p99_ms': best['tpot_p99_ms'],
                'serve_concurrency': best['concurrency'],
            })
    return out
