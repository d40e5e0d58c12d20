"""The port's measurement harnesses against the JAX package's, on the CPU.

- the Prometheus exposition parser and ``summarize_metrics_text`` of the
  port (``utils/metrics.py``, ``benchmark/serve_bench.py``) against the
  JAX package's on one exposition of the port registry: equal exactly;
- ``make_prompt`` and ``_percentile``: the same draws and ranks;
- ``drive_load`` and ``_prefix_arm`` against an in-process port replica
  (test-tiny on the CPU), and the replica's stream line per token;
- ``serve_bench.run`` end to end with replica subprocesses: the record's
  keys are the ones JAX's ``run`` builds from the same replica results,
  and no replica process is left;
- ``benchmark/kv_microbench.py`` on the JAX package's test-tiny weights
  (``params_from_numpy``): KV bytes per token equal to the JAX engine's,
  greedy streams equal to ``scripts/kv_microbench.py``'s
  ``_greedy_stream``, roofline rows with the JAX arm's keys, and the
  CLI's record keys.
"""
import json
import os
import random
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import scripts.kv_microbench as jax_kb
from skypilot_tpu.benchmark import serve_bench as jax_sb
from skypilot_tpu.models import decode as jax_decode
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.utils import metrics as jax_metrics
from skypilot_tpu_torch.benchmark import kv_microbench as kb
from skypilot_tpu_torch.benchmark import serve_bench as sb
from skypilot_tpu_torch.models import decode as torch_decode
from skypilot_tpu_torch.models import llama as torch_llama
from skypilot_tpu_torch.serve import generation_server as gs
from skypilot_tpu_torch.utils import metrics as torch_metrics

CFG = torch_llama.PRESETS['test-tiny']
JCFG = jax_llama.PRESETS['test-tiny']


@pytest.fixture(scope='module')
def weights():
    jm = jax_llama.LlamaModel(JCFG)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = torch_llama.LlamaModel(CFG, device='cpu')
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _exposition() -> str:
    """One exposition of a port registry with every sample kind the
    parser meets: counters, gauges, labelled series, histograms with
    labels, +Inf buckets, exemplars, _sum and _count, and the serve and
    engine series ``summarize_metrics_text`` reads."""
    reg = torch_metrics.Registry()
    reg.counter('skytpu_serve_requests_total', 'requests').inc(7)
    reg.counter('skytpu_serve_rejected_total', 'rejected').inc(2)
    reg.gauge('skytpu_engine_occupancy_ratio', 'occupancy').set(0.625)
    reg.gauge('skytpu_engine_hbm_bytes', 'hbm',
              labels={'component': 'kv_used'}).set(1.5e9)
    reg.gauge('skytpu_engine_hbm_bytes', 'hbm',
              labels={'component': 'params'}).set(2.25e9)
    reg.gauge('skytpu_engine_kv_dtype_info', 'dtype',
              labels={'dtype': 'int8'}).set(1)
    reg.counter('skytpu_engine_kv_prefix_hit_tokens_total', 'hits').inc(640)
    reg.gauge('skytpu_serve_slo_headroom_ms', 'headroom').set(-12.5)
    ttft = reg.histogram('skytpu_serve_ttft_ms', 'ttft')
    for i, v in enumerate((3.0, 40.0, 41.0, 700.0, 12000.0, 99999.0)):
        ttft.observe(v, exemplar=f'req-{i}')
    tpot = reg.histogram('skytpu_serve_tpot_ms', 'tpot',
                         buckets=(1, 5, 10, 50))
    for v in (0.5, 4.0, 7.5, 7.5, 60.0):
        tpot.observe(v)
    acc = reg.histogram('skytpu_engine_spec_accept_tokens', 'accept',
                        buckets=(1, 2, 3, 4, 5))
    for v in (1, 1, 2, 5, 3):
        acc.observe(v)
    lab = reg.histogram('skytpu_engine_step_ms', 'step',
                        buckets=(1, 10, 100),
                        labels={'variant': 'step:8'})
    lab.observe(4.0, exemplar='step-a')
    reg.histogram('skytpu_serve_queue_wait_ms', 'empty')  # count 0
    text = reg.render()
    assert ' # {request_id="req-' in text and 'le="+Inf"' in text
    return text


def test_exposition_parser_equals_jax():
    text = _exposition() + 'garbage line\nbad_value{a="b"} nan_x\n'
    got = torch_metrics.parse_text(text)
    assert got == jax_metrics.parse_text(text)
    assert len(got) > 40
    for name in ('skytpu_serve_ttft_ms', 'skytpu_serve_tpot_ms',
                 'skytpu_engine_step_ms', 'skytpu_serve_queue_wait_ms',
                 'skytpu_missing'):
        assert torch_metrics.histogram_cumulative(got, name) == \
            jax_metrics.histogram_cumulative(got, name)
    for name, labels in (('skytpu_engine_hbm_bytes', None),
                         ('skytpu_engine_hbm_bytes', {'component': 'params'}),
                         ('skytpu_engine_kv_dtype_info', {'dtype': 'int8'}),
                         ('skytpu_serve_ttft_ms_sum', None),
                         ('skytpu_serve_ttft_ms_count', None),
                         ('skytpu_serve_slo_headroom_ms', None),
                         ('skytpu_engine_hbm_bytes', {'component': 'no'})):
        assert torch_metrics.sample_value(got, name, labels) == \
            jax_metrics.sample_value(got, name, labels)
    inf = torch_metrics.histogram_cumulative(got, 'skytpu_serve_ttft_ms')
    assert inf[-1] == (float('inf'), 6.0)


def test_summarize_metrics_text_equals_jax():
    text = _exposition()
    got = sb.summarize_metrics_text(text)
    assert got == jax_sb.summarize_metrics_text(text)
    assert got['skytpu_serve_ttft_ms']['count'] == 6
    assert 'skytpu_serve_queue_wait_ms' not in got  # no observations
    assert got['skytpu_serve_slo_headroom_ms'] == -12.5


@pytest.mark.parametrize('seed', [0, 1, 77, 4242])
@pytest.mark.parametrize('prefix_len', [0, 5, 40])
def test_make_prompt_equals_jax(seed, prefix_len):
    prefix = list(range(3, 3 + prefix_len)) or None
    for vocab, n in ((256, 24), (32000, 2500), (256, 7)):
        a, b = random.Random(seed), random.Random(seed)
        for _ in range(3):
            assert sb.make_prompt(a, vocab, n, prefix) == \
                jax_sb.make_prompt(b, vocab, n, prefix)


def test_percentile_equals_jax():
    rnd = random.Random(3)
    for n in (1, 2, 5, 17, 100):
        vals = [rnd.random() * 100 for _ in range(n)]
        for pct in (0, 1, 50, 90, 99, 99.9, 100):
            assert sb._percentile(vals, pct) == jax_sb._percentile(vals, pct)


class _Replica:
    """The port's scheduler + HTTP server in this process, on the CPU."""

    def __init__(self, tm, tp, **kwargs):
        self.sched = gs.GenerationScheduler(
            CFG, tp, batch_slots=2, max_len=128, model=tm, device='cpu',
            **kwargs)
        self.sched.start(warmup=True)
        self.server = gs.GenerationServer(self.sched, host='127.0.0.1',
                                          port=0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f'http://127.0.0.1:{self.server.port}'
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if self.sched.warm.is_set():
                return
            time.sleep(0.02)
        raise AssertionError('replica never warmed')

    def close(self):
        self.server.shutdown()
        self.sched._thread.join(timeout=10)
        self.sched._emit_thread.join(timeout=10)


def test_drive_load_and_prefix_arm_against_the_port_replica(weights):
    _, _, tm, tp = weights
    rep = _Replica(tm, tp, kv_block=8, spec_tokens=0)
    try:
        stats = sb.drive_load(rep.base, vocab_size=CFG.vocab_size,
                              prompt_len=24, output_len=8, concurrency=2,
                              window_s=2.0, seed=1)
        assert stats['completed'] > 0 and stats['errors'] == 0
        assert stats['rejected'] == 0
        assert 0 < stats['ttft_p50_ms'] <= stats['ttft_p99_ms']
        assert stats['tpot_p50_ms'] > 0
        assert set(stats) == {'concurrency', 'completed', 'errors',
                              'rejected', 'req_per_s', 'output_tokens_per_s',
                              'ttft_p50_ms', 'ttft_p99_ms', 'tpot_p50_ms',
                              'tpot_p99_ms'}
        arm = sb._prefix_arm(rep.base, vocab_size=CFG.vocab_size,
                             prompt_len=40, prefix_len=32, output_len=4,
                             concurrency=2, window_s=2.0)
        assert arm['prefix_len'] == 32
        assert arm['sweep']['completed'] > 0 and arm['sweep']['errors'] == 0
        assert arm['prefix_hit_rate'] > 0
        assert 0 < arm['prefix_hit_rate_all_tokens'] <= 1
        assert arm['kv_blocks_total'] > 0
    finally:
        rep.close()


def test_replica_streams_a_line_per_token(weights):
    """TTFT is read at the first streamed line: the replica must send a
    line per token as it decodes, not the whole reply at the end."""
    _, _, tm, tp = weights
    rep = _Replica(tm, tp, kv_block=8, spec_tokens=0)
    try:
        t0 = time.perf_counter()
        arrivals = []
        with sb._post_generate(rep.base, [5, 9, 2, 7] * 4, 64,
                               stream=True) as resp:
            for line in resp:
                arrivals.append((time.perf_counter() - t0, json.loads(line)))
        tokens = [obj for _, obj in arrivals if 'token' in obj]
        assert len(tokens) == 64 and arrivals[-1][1]['done'] is True
        first, last = arrivals[0][0], arrivals[-1][0]
        assert first < 0.5 * last, (first, last)
    finally:
        rep.close()


def test_serve_bench_run_end_to_end(monkeypatch):
    """``run`` with replica subprocesses (the monolithic control, the
    chunked headline with its prefix arm): the record JAX's ``run``
    builds from the same replica results has the same keys, and every
    replica's process group is gone afterwards."""
    procs, results = [], {}
    real_spawn, real_bench = sb.spawn, sb._bench_replica

    def spawn(*a, **kw):
        proc = real_spawn(*a, **kw)
        procs.append(proc)
        return proc

    def bench(**kw):
        results[kw['service_name']] = out = real_bench(**kw)
        return out

    monkeypatch.setattr(sb, 'spawn', spawn)
    monkeypatch.setattr(sb, '_bench_replica', bench)
    args = dict(preset='test-tiny', batch_slots=2, max_len=128,
                prompt_len=24, output_len=8, concurrencies=(2,),
                window_s=3.0, warmup_requests=1, ready_timeout_s=120,
                warmup_deadline_s=60, prefill_chunk=8, ttft_slo_ms=2000.0,
                ab_monolithic=True, prefix_share_len=16, kv_block=8,
                kv_blocks=40, spec_tokens=4, kv_dtype='bf16',
                service_name='bench-serve-test')
    out = sb.run(device='cpu', **args)
    assert len(procs) == 2
    for proc in procs:
        assert proc.returncode is not None
        with pytest.raises(ProcessLookupError):
            os.killpg(proc.pid, 0)
    (point,) = out['serve_sweep']
    assert point['completed'] > 0 and point['errors'] == 0
    assert out['serve_req_per_s'] > 0 and out['serve_ttft_p50_ms'] > 0
    assert out['serve_tpot_p50_ms'] > 0
    assert out['serve_prefix_hit_rate'] > 0
    assert out['serve_sweep_monolithic'][0]['completed'] > 0
    assert out['serve_replica_stats']['prefill_chunk'] == 8
    # 40 blocks, one of them the reserved null block.
    assert out['serve_replica_stats']['kv_blocks_total'] == 39
    assert 'skytpu_serve_ttft_ms' in out['serve_replica_metrics_summary']

    # JAX's run over the same replica results (its service stand-up
    # replaced by what the port's replicas returned).
    monkeypatch.setattr(jax_sb, '_bench_service',
                        lambda *, task, service_name, **kw:
                        results[service_name])
    want = jax_sb.run(**args)
    assert set(out) == set(want)
    assert out == want


@pytest.mark.parametrize('kv_block,kv_dtype', [(0, None), (16, None),
                                               (16, 'int8')])
def test_kv_bytes_per_token_equals_jax(kv_block, kv_dtype):
    kw = dict(batch_slots=2, max_len=64, kv_block=kv_block,
              kv_dtype=kv_dtype)
    got = torch_decode.DecodeEngine(CFG, device='cpu', **kw)
    want = jax_decode.DecodeEngine(JCFG, **kw)
    assert got.kv_bytes_per_token() == want.kv_bytes_per_token()


@pytest.mark.parametrize('k', [0, 4])
def test_greedy_streams_equal_jax(weights, k):
    """bf16 paged engines, one slot, a repetitive prompt: the probe's
    greedy stream (plain steps, or verify steps over prompt-lookup
    drafts) is JAX's token for token."""
    jm, jp, tm, tp = weights
    prompt = kb._pattern_prompt(CFG, 24, (5, 9, 2, 7, 11, 3, 13, 4))
    got = kb._greedy_stream(
        CFG, tp, torch_decode.DecodeEngine(
            CFG, batch_slots=2, max_len=128, kv_block=16, spec_tokens=k,
            device='cpu'), prompt, 40, k)
    want = jax_kb._greedy_stream(
        JCFG, jp, jax_decode.DecodeEngine(
            JCFG, batch_slots=2, max_len=128, kv_block=16, spec_tokens=k),
        prompt, 40, k)
    assert got == want


def test_engine_arm_reports_jax_bytes(weights):
    """bench_engine's byte fields are the JAX probe's for the same
    engine (its KV state shapes are JAX's)."""
    _, jp, _, tp = weights
    for kv_block in (0, 16):
        got = kb.bench_engine(CFG, tp, slots=2, max_len=64, prompt_len=8,
                              steps=2, kv_block=kv_block, device='cpu')
        want = jax_kb.bench_engine(JCFG, jp, slots=2, max_len=64,
                                   prompt_len=8, steps=2, kv_block=kv_block)
        assert set(got) == set(want)
        for key in ('mode', 'kv_block', 'kv_blocks', 'kv_dtype',
                    'kv_bytes_per_token'):
            assert got[key] == want[key], key
        assert got['step_ms'] > 0


def test_roofline_arm_rows(weights):
    """The --roofline arm returns the gauge-shaped table (the JAX test's
    contract, tests/test_decode.py)."""
    _, _, _, tp = weights
    snap = kb.bench_roofline(CFG, tp, slots=2, max_len=64, prompt_len=8,
                             steps=2, kv_block=0, device='cpu')
    assert any(v.startswith('step:') for v in snap)
    for row in snap.values():
        assert set(row) == {'flops', 'bytes', 'ai', 'step_ms', 'mfu'}
        assert row['flops'] > 0 and row['bytes'] > 0
    step = next(v for k, v in snap.items() if k.startswith('step:'))
    assert step['step_ms'] > 0.0


def test_kv_microbench_cli_record(capsys):
    """The CLI's one JSON line has the JAX probe's record keys, every
    arm included; the spec arm accepts more than a token per step on
    the repetitive prompt, and int8 halves the bytes or better."""
    assert kb.main(['--device', 'cpu', '--steps', '4', '--slots', '2',
                    '--async-depths', '1', '2', '--spec-ks', '0', '4',
                    '--quant-ks', '0', '--trace-overhead',
                    '--roofline']) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {'preset', 'batch_slots', 'max_len', 'prompt_len',
                        'backend', 'contiguous', 'paged',
                        'paged_step_overhead_pct', 'async', 'quant', 'spec',
                        'trace_overhead', 'roofline'}
    assert rec['backend'] == 'cpu'
    assert [a['depth'] for a in rec['async']] == [1, 2]
    assert set(rec['quant']) == {'bf16', 'int8', 'kv_bytes_reduction',
                                 'step_time_ratio', 'roundtrip_rel_err',
                                 'greedy_agreement', 'agree_tokens'}
    assert rec['quant']['kv_bytes_reduction'] >= 1.9
    assert rec['quant']['roundtrip_rel_err'] <= 1 / 254 + 1e-6
    spec = {s['k']: s for s in rec['spec']}
    assert spec[0]['accepted_per_step'] == pytest.approx(
        spec[0]['tokens'] / spec[0]['decode_steps'], abs=0.01)
    assert spec[4]['accepted_per_step'] > 1.0
    assert set(rec['trace_overhead']) == {'step_ms_plain', 'step_ms_traced',
                                          'overhead_pct', 'spans_per_step',
                                          'rounds'}


def test_kv_microbench_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert kb.build_parser().parse_args([]).device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        kb.main(['--steps', '1'])


def test_post_generate_sends_the_jax_body(weights):
    """The client's request body is JAX's (tokens, max_tokens, stream),
    and the replica answers it."""
    _, _, tm, tp = weights
    rep = _Replica(tm, tp, kv_block=8, spec_tokens=0)
    try:
        with sb._post_generate(rep.base, [1, 2, 3], 4, stream=False) as r:
            assert len(json.loads(r.read())['tokens']) == 4
        with urllib.request.urlopen(rep.base + '/stats') as r:
            assert json.loads(r.read())['requests'] == 1
    finally:
        rep.close()
