"""The PyTorch port's generation server on the CPU, end to end over HTTP.

The port's scheduler + server (``device='cpu'``) serve test-tiny with
the JAX package's weights (``jax.random.key(0)`` via
``params_from_numpy``); greedy replies must equal the JAX naive oracle,
which recomputes the JAX forward for every token (as
tests/test_decode.py does for the JAX server). Token streams compare
exactly.
"""
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

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.models import llama as torch_llama
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
        self.sched = gs.GenerationScheduler(
            CFG, tp, batch_slots=2, max_len=64, kv_block=16, model=tm,
            device='cpu', **kwargs)
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
    args = parser.parse_args(['--model', 'mixtral', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='not yet ported'):
        gs.build_scheduler(args)
    args = parser.parse_args(['--preset', 'test-tiny', '--device', 'cpu',
                              '--max-len', '64', '--kv-dtype', 'int8'])
    with pytest.raises(NotImplementedError, match='int8'):
        gs.build_scheduler(args)
    args = parser.parse_args(['--preset', 'nope', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='unknown --preset'):
        gs.build_scheduler(args)
    monkeypatch.setenv('SKYTPU_ADMIT_BATCH', '2')
    args = parser.parse_args(['--preset', 'test-tiny', '--device', 'cpu',
                              '--max-len', '64'])
    with pytest.raises(NotImplementedError, match='SKYTPU_ADMIT_BATCH'):
        gs.build_scheduler(args)


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
