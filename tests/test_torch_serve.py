"""The PyTorch port's generation server on the CPU, end to end over HTTP.

The port's scheduler + server (``device='cpu'``) serve test-tiny with
the JAX package's weights (``jax.random.key(0)`` via
``params_from_numpy``); greedy replies must equal the JAX naive oracle,
which recomputes the JAX forward for every token (as
tests/test_decode.py does for the JAX server). Token streams compare
exactly.
"""
import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.models import llama as torch_llama
from skypilot_tpu_torch.models import mixtral
from skypilot_tpu_torch.serve import generation_server as gs

CFG = torch_llama.PRESETS['test-tiny']
_JIT = {}
_STREAMS = {}


@pytest.fixture(scope='module')
def weights():
    jm = jax_llama.LlamaModel(jax_llama.PRESETS['test-tiny'])
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = torch_llama.LlamaModel(CFG, device='cpu')
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def jax_naive_greedy(jm, jp, prompt, n):
    """Full JAX forward per generated token (padded to 64: causal
    attention masks the padding at the last real position)."""
    fwd = _JIT.setdefault('fwd', jax.jit(jm.apply))
    toks = list(_STREAMS.get(tuple(prompt), ()))
    while len(toks) < n:
        seq = list(prompt) + toks
        logits = fwd(jp, jnp.asarray([seq + [0] * (64 - len(seq))],
                                     jnp.int32))
        toks.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    _STREAMS[tuple(prompt)] = toks
    return toks[:n]


class Replica:
    """Scheduler + HTTP server on a free local port, torn down fully."""

    def __init__(self, tm, tp, start=True, **kwargs):
        kwargs.setdefault('spec_tokens', 0)
        kwargs.setdefault('kv_block', 16)
        self.sched = gs.GenerationScheduler(
            CFG, tp, batch_slots=2, max_len=64, model=tm, device='cpu',
            **kwargs)
        if start:
            self.sched.start(warmup=True)
        self.server = gs.GenerationServer(self.sched, host='127.0.0.1',
                                          port=0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f'http://127.0.0.1:{self.server.port}'
        self.started = start

    def wait_healthy(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f'{self.base}/health') as r:
                    if r.status == 200:
                        return
            except urllib.error.HTTPError:
                pass
            time.sleep(0.02)
        raise AssertionError('replica never became healthy')

    def get(self, path):
        with urllib.request.urlopen(f'{self.base}{path}', timeout=60) as r:
            return r.read()

    def post(self, path, body):
        req = urllib.request.Request(f'{self.base}{path}',
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()

    def close(self):
        self.server.shutdown()
        if self.started:
            self.sched._thread.join(timeout=10)
            self.sched._emit_thread.join(timeout=10)
            assert not self.sched._thread.is_alive()
            assert not self.sched._emit_thread.is_alive()


def test_generation_server_e2e(weights):
    """/health, /generate plain and streamed, /stats and /metrics."""
    jm, jp, tm, tp = weights
    rep = Replica(tm, tp)
    try:
        rep.wait_healthy()
        prompt = [3, 141, 59, 26]
        status, raw = rep.post('/generate', {'tokens': prompt,
                                             'max_tokens': 6})
        result = json.loads(raw)
        assert status == 200
        assert result['tokens'] == jax_naive_greedy(jm, jp, prompt, 6)
        assert result['ttft_ms'] is not None
        assert result['latency_ms'] >= result['ttft_ms']

        _, raw = rep.post('/generate', {'tokens': prompt, 'max_tokens': 3,
                                        'stream': True})
        lines = [json.loads(l) for l in raw.splitlines() if l]
        assert [c['token'] for c in lines if 'token' in c] == \
            jax_naive_greedy(jm, jp, prompt, 3)
        assert lines[-1]['done'] is True

        stats = json.loads(rep.get('/stats'))
        assert stats['requests'] == 2
        assert stats['slots_active'] == 0
        assert stats['kv_dtype'] == 'bf16'
        assert stats['hbm']['kv_code_pool'] > 0

        text = rep.get('/metrics').decode()
        names = {l.split('{')[0].split(' ')[0] for l in text.splitlines()
                 if l and not l.startswith('#')}
        for name in ('skytpu_serve_requests_total', 'skytpu_serve_ttft_ms_count',
                     'skytpu_engine_steps_total',
                     'skytpu_engine_prefill_tokens_total',
                     'skytpu_engine_kv_pool_blocks_count',
                     'skytpu_engine_hbm_bytes',
                     'skytpu_engine_step_flops'):
            assert name in names, name
    finally:
        rep.close()


def test_spec_decode_and_prefix_hit_over_http(weights):
    """Speculative decode (K = 4) and a prefix-cache hit through the
    server: the same greedy tokens as the JAX oracle."""
    jm, jp, tm, tp = weights
    rep = Replica(tm, tp, spec_tokens=4)
    try:
        rep.wait_healthy()
        long = [(7 * i) % 250 + 1 for i in range(40)]   # 2 full blocks
        shared = long[:32] + [9, 8, 7, 6, 5]             # hits both
        for prompt in (long, shared, [4, 2, 4, 2, 4, 2, 4]):
            _, raw = rep.post('/generate', {'tokens': prompt,
                                            'max_tokens': 10})
            assert json.loads(raw)['tokens'] == \
                jax_naive_greedy(jm, jp, prompt, 10)
        stats = json.loads(rep.get('/stats'))
        assert stats['prefix_hit_rate'] > 0
        text = rep.get('/metrics').decode()
        assert 'skytpu_engine_spec_accept_tokens_count' in text
    finally:
        rep.close()


def test_health_is_503_until_warm(weights):
    _, _, tm, tp = weights
    rep = Replica(tm, tp, start=False)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            rep.get('/health')
        assert err.value.code == 503
    finally:
        rep.close()


def test_profile_endpoint_writes_a_torch_trace(weights, tmp_path,
                                               monkeypatch):
    _, _, tm, tp = weights
    monkeypatch.setenv('SKYTPU_PROFILE_DIR', str(tmp_path))
    rep = Replica(tm, tp)
    try:
        rep.wait_healthy()
        status, raw = rep.post('/profile?ms=20', {})
        body = json.loads(raw)
        assert status == 200 and body['mode'] == 'torch'
        assert os.path.exists(os.path.join(body['artifact'], 'trace.json'))
    finally:
        rep.close()


def test_cli_defaults_to_the_card_and_refuses_unported_options(
        monkeypatch):
    parser = gs.build_parser()
    args = parser.parse_args([])
    assert args.device == 'cuda' and args.preset == 'llama-1b'
    args = parser.parse_args(['--preset', 'test-tiny', '--device', 'cpu',
                              '--ckpt-dir', '/nonexistent'])
    with pytest.raises(SystemExit, match='no checkpoint found'):
        gs.build_scheduler(args)
    # Mixtral is served: an engine over a MixtralModel whose router stays
    # f32 holding values rounded to the model dtype, as the JAX replica
    # routes (a bf16 copy of the tiny preset shows the rounding).
    moe = ['--model', 'mixtral', '--preset', 'test-tiny-moe', '--device',
           'cpu', '--max-len', '64']
    for dtype in (torch.float32, torch.bfloat16):
        monkeypatch.setitem(mixtral.PRESETS, 'test-tiny-moe',
                            dataclasses.replace(
                                mixtral.PRESETS['test-tiny-moe'],
                                dtype=dtype))
        sched = gs.build_scheduler(parser.parse_args(moe))
        assert isinstance(sched.engine.model, mixtral.MixtralModel)
        router = sched.params['layers']['router']
        assert router.dtype == torch.float32
        assert sched.params['layers']['we_gate'].dtype == dtype
        assert torch.equal(router, router.to(dtype).float())
    gen = torch.Generator().manual_seed(0)
    drawn = mixtral.MixtralModel(sched.config, device='cpu').init(gen)
    assert not torch.equal(router, drawn['layers']['router'])
    assert torch.equal(router,
                       drawn['layers']['router'].to(torch.bfloat16).float())
    with pytest.raises(SystemExit, match='unknown --preset'):
        gs.build_scheduler(parser.parse_args(
            ['--model', 'mixtral', '--device', 'cpu']))
    args = parser.parse_args(['--preset', 'nope', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='unknown --preset'):
        gs.build_scheduler(args)
    # The serving modes of this package: int8 KV, contiguous KV and
    # fused batched admission, from the CLI and the environment.
    tiny = ['--preset', 'test-tiny', '--device', 'cpu', '--max-len', '64']
    sched = gs.build_scheduler(parser.parse_args(tiny + ['--kv-dtype',
                                                         'int8']))
    assert sched.engine.kv_dtype == 'int8' and sched.engine.paged
    assert sched.state.k.dtype == torch.int8
    sched = gs.build_scheduler(parser.parse_args(tiny + ['--kv-block',
                                                         '0']))
    assert not sched.engine.paged and sched.stats()['hbm']
    with pytest.raises(ValueError, match='requires the paged KV'):
        gs.build_scheduler(parser.parse_args(
            tiny + ['--kv-block', '0', '--kv-dtype', 'int8']))
    monkeypatch.setenv('SKYTPU_ADMIT_BATCH', '2')
    assert gs.build_scheduler(parser.parse_args(tiny)).ADMIT_BATCH_MAX == 2


def test_build_scheduler_serves_seeded_random_weights():
    """``build_scheduler`` (what ``main`` runs) draws the weights from
    ``--seed`` on the chosen device; the same seed gives the same
    weights."""
    parser = gs.build_parser()
    argv = ['--preset', 'test-tiny', '--device', 'cpu', '--max-len', '64',
            '--batch-slots', '2', '--seed', '3']
    a = gs.build_scheduler(parser.parse_args(argv))
    b = gs.build_scheduler(parser.parse_args(argv))
    assert a.device.type == 'cpu' and a.engine.batch_slots == 2
    assert a.params['lm_head'].equal(b.params['lm_head'])


def _collect(req, timeout=60):
    out = []
    while True:
        tok = req.out_queue.get(timeout=timeout)
        if tok is None:
            return out
        out.append(tok)


@pytest.mark.parametrize('kv_block', [16, 0])
def test_scheduler_batches_same_bucket_wave(weights, kv_block):
    """Four same-bucket requests queued before the scheduler drains go
    through ONE admit_many (no solo admit), paged and contiguous, and
    every request still completes with the oracle's tokens."""
    jm, jp, tm, tp = weights
    sched = gs.GenerationScheduler(CFG, tp, batch_slots=4, max_len=64,
                                   kv_block=kv_block, spec_tokens=0,
                                   model=tm, device='cpu')
    sched.ADMIT_BATCH_MAX = 4
    calls = {'admit': 0, 'admit_many': 0}
    for name in calls:
        real = getattr(sched.engine, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        setattr(sched.engine, name, counted)
    prompts = [[1, 9, 77, 123], [5, 6, 7, 8], [9, 10, 11, 12],
               [44, 3, 2, 1]]
    reqs = [gs._Request(p, max_tokens=4, temperature=0.0, top_k=0,
                        eos_id=None) for p in prompts]
    for req in reqs:
        sched.submit(req)
    sched.start(warmup=True)
    try:
        for p, req in zip(prompts, reqs):
            assert _collect(req) == jax_naive_greedy(jm, jp, p, 4)
            assert req.error is None
    finally:
        sched.stop()
        sched._thread.join(timeout=10)
        sched._emit_thread.join(timeout=10)
    assert calls == {'admit': 0, 'admit_many': 1}
    labels = sched.engine.profiler._variant_labels.values()
    assert 'admit_many:4x16' in labels


@pytest.mark.parametrize('spec_tokens', [0, 4])
def test_int8_replica_agrees_with_bf16_over_http(weights, spec_tokens):
    """The int8 gate of the JAX package (tests/test_decode.py): greedy
    streams from the int8 pool agree with the bf16 replica's on >= 90%
    of >= 128 tokens, drafting off and on, first tokens identical; the
    quant-scale canary reaches /metrics."""
    _, _, tm, tp = weights
    prompts = [[1, 9, 77, 123], [5, 17, 200], [4, 8]]
    streams = {}
    for dtype in ('bf16', 'int8'):
        rep = Replica(tm, tp, kv_dtype=dtype, spec_tokens=spec_tokens)
        try:
            rep.wait_healthy()
            streams[dtype] = [
                json.loads(rep.post('/generate', {'tokens': p,
                                                  'max_tokens': 48})[1])[
                    'tokens'] for p in prompts]
            stats = json.loads(rep.get('/stats'))
            metrics = rep.get('/metrics').decode()
        finally:
            rep.close()
        assert stats['kv_dtype'] == dtype
    bf16, int8 = streams['bf16'], streams['int8']
    total = sum(len(s) for s in bf16)
    assert total >= 128 and [len(s) for s in int8] == [len(s) for s in bf16]
    assert [s[0] for s in int8] == [s[0] for s in bf16]
    agree = sum(a == b for sb, si in zip(bf16, int8) for a, b in zip(sb, si))
    assert agree / total >= 0.9
    assert stats['kv_bytes_per_token'] == 2 * CFG.num_layers * \
        CFG.num_kv_heads * (CFG.head_dim + 4)
    assert 'skytpu_engine_kv_quant_scale_ratio_count' in metrics
    assert stats['hbm']['kv_scale_pool'] > 0


def test_contiguous_replica_over_http(weights):
    """kv_block 0: no block reservation and no prefix cache; greedy
    replies (speculative decode on) equal the JAX oracle."""
    jm, jp, tm, tp = weights
    rep = Replica(tm, tp, kv_block=0, spec_tokens=4)
    try:
        rep.wait_healthy()
        long = [(7 * i) % 250 + 1 for i in range(40)]
        for prompt in (long, long[:32] + [9, 8, 7], [4, 2, 4, 2, 4]):
            _, raw = rep.post('/generate', {'tokens': prompt,
                                            'max_tokens': 10})
            assert json.loads(raw)['tokens'] == \
                jax_naive_greedy(jm, jp, prompt, 10)
        stats = json.loads(rep.get('/stats'))
        assert 'prefix_hit_rate' not in stats and stats['slots_active'] == 0
        assert rep.sched.engine.allocator is None
    finally:
        rep.close()
