"""The decode engine's attention over its paged pool on the CPU: K3's
plain version (``ops/attention.py`` ``paged_attention_reference``) and
the engine's counters of K3's launches and the KV blocks they read.

The plain version is held bit for bit against the gather and f32
einsums the engine ran before K3 (written out below as they were), on
bf16 and f32 pools. The counters are checked on planted lengths, and
their device values are read off the scheduler thread (the stand-in
event pattern of ``tests/test_torch_tracing.py``). The kernel itself
runs on the card only: ``tests/test_torch_paged_attn_cuda.py``.
"""
import math
import threading
import time

import pytest
import torch

from perfbench import promtext
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.serve import generation_server as gs
from skypilot_tpu_torch.utils import metrics as metrics_lib

CFG = llama.PRESETS['test-tiny']
LAUNCHES = 'skytpu_engine_pool_attn_launches_total'
BLOCKS = 'skytpu_engine_pool_attn_kv_blocks_total'


def _gather_then_attend(q, k_pool, v_pool, tables, valid):
    """The engine's pool attention before K3: ``_gather_batch`` and
    ``_attend_pool`` as they were."""
    def gather(pool):
        g = pool[tables].permute(0, 2, 1, 3, 4)
        return g.reshape(g.shape[0], g.shape[1], -1, g.shape[4])

    k_rows, v_rows = gather(k_pool), gather(v_pool)
    n, t, hq, d = q.shape
    kvh = k_pool.shape[1]
    qg = q.reshape(n, t, kvh, hq // kvh, d).float()
    s = torch.einsum('ntkgd,nkmd->ntkgm', qg, k_rows.float())
    s = s * (d ** -0.5)
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    attn = torch.einsum('ntkgm,nkmd->ntkgd', p.to(q.dtype).float(),
                        v_rows.float())
    return attn.reshape(n, t, hq, d).to(q.dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('t', [1, 5])
def test_plain_version_equals_the_gather_bit_for_bit(dtype, t):
    gen = torch.Generator().manual_seed(t)
    b, hq, kvh, d, bs, max_blocks, nb = 6, 8, 2, 32, 16, 4, 30
    q = torch.randn(b, t, hq, d, generator=gen).to(dtype)
    k_pool = torch.randn(nb, kvh, bs, d, generator=gen).to(dtype)
    v_pool = torch.randn(nb, kvh, bs, d, generator=gen).to(dtype)
    tables = torch.randint(0, nb, (b, max_blocks), generator=gen)
    m_pad = max_blocks * bs
    lengths = torch.tensor([0, 1, bs - 1, bs, bs + 1, m_pad - t])
    positions = lengths[:, None] + torch.arange(t)[None]
    valid = torch.arange(m_pad)[None, None, :] <= positions[:, :, None]
    got = attention_ops.paged_attention(q, k_pool, v_pool, tables, lengths)
    want = _gather_then_attend(q, k_pool, v_pool, tables, valid)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert attention_ops.LAUNCHES['paged_attn'] == 0  # no kernel here


def test_paged_pools_take_the_paged_path():
    """Paged pools (any dtype on the CPU) go through paged_attention;
    int8 pools and the contiguous layout keep the gather."""
    assert decode.DecodeEngine(CFG, batch_slots=2, max_len=64, kv_block=16,
                               device='cpu')._pool_kernel
    for kw in (dict(kv_block=16, kv_dtype='int8'), dict(kv_block=0)):
        assert not decode.DecodeEngine(CFG, batch_slots=2, max_len=64,
                                       device='cpu', **kw)._pool_kernel


def _scrape():
    return promtext.parse(metrics_lib.REGISTRY.render())


@pytest.fixture(scope='module')
def weights():
    model = llama.LlamaModel(CFG, device='cpu')
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize('k_spec', [0, 4])
def test_block_counter_counts_what_each_launch_reads(weights, k_spec):
    model, params = weights
    bs, max_len = 64, 512
    t = 1 + k_spec
    eng = decode.DecodeEngine(CFG, batch_slots=6, max_len=max_len,
                              model=model, kv_block=bs, spec_tokens=k_spec,
                              device='cpu')
    state = eng.init_state()
    lengths = [0, 1, 63, 64, 65, max_len - t]
    state.lengths.copy_(torch.tensor(lengths))
    state.active.fill_(True)
    before = _scrape()
    rng = torch.Generator().manual_seed(0)
    if k_spec:
        eng.step_verify(params, state, rng, [[1] * k_spec] * 6)
    else:
        eng.step(params, state, rng)
    assert eng.profiler.resolve() == 1
    after = _scrape()
    per_launch = sum(min(math.ceil((n + t) / bs), eng.max_blocks)
                     for n in lengths)
    assert per_launch == {1: 15, 5: 16}[t]
    assert after[LAUNCHES] - before.get(LAUNCHES, 0.0) == CFG.num_layers
    assert (after[BLOCKS] - before.get(BLOCKS, 0.0)
            == CFG.num_layers * per_launch)


def test_gathered_layouts_count_no_pool_attention(weights):
    model, params = weights
    before = _scrape()
    for kw in (dict(kv_block=16, kv_dtype='int8'), dict(kv_block=0)):
        eng = decode.DecodeEngine(CFG, batch_slots=2, max_len=64,
                                  model=model, device='cpu', **kw)
        eng.step(params, eng.init_state(), torch.Generator().manual_seed(0))
        eng.profiler.resolve()
    after = _scrape()
    assert after.get(LAUNCHES, 0.0) == before.get(LAUNCHES, 0.0)
    assert after.get(BLOCKS, 0.0) == before.get(BLOCKS, 0.0)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU (as in
    ``tests/test_torch_tracing.py``): stamps the host clock when
    recorded."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_block_counts_are_read_off_the_scheduler_thread(weights,
                                                        monkeypatch):
    """On the card a read of the block count waits for the device: the
    count is read only by the resolvers (emitter, scrape), never on the
    scheduler thread once it serves."""
    model, params = weights
    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **kw: None)
    sched = gs.GenerationScheduler(CFG, params, batch_slots=4, max_len=128,
                                   model=model, kv_block=16, spec_tokens=4,
                                   inflight_steps=2, device='cpu')
    prof = sched.engine.profiler
    prof._cuda = True  # stamps are (stand-in) events
    counts, reads = [], []
    note = prof.note_pool_attn

    def noted(*a, **kw):
        note(*a, **kw)
        counts.append(prof._open.pool_attn[1])
    monkeypatch.setattr(prof, 'note_pool_attn', noted)
    item = torch.Tensor.item

    def logged(self):
        if any(self is c for c in counts):
            reads.append((threading.current_thread().name,
                          sched.warm.is_set()))
        return item(self)
    monkeypatch.setattr(torch.Tensor, 'item', logged)
    before = _scrape()
    reqs = [gs._Request(list(range(1, 9 + 5 * i)), 10, 0.0, 0, None)
            for i in range(6)]
    for r in reqs:
        sched.submit(r)
    sched.start()
    try:
        for r in reqs:
            while r.out_queue.get(timeout=120) is not None:
                pass
            assert r.error is None
        sched.observe_gauges()
    finally:
        sched.stop()
        sched._thread.join(timeout=30)
        sched._emit_thread.join(timeout=30)
    assert not sched._thread.is_alive()
    prof.resolve()
    assert reads
    assert [r for r in reads if r == ('generation-scheduler', True)] == []
    after = _scrape()
    launched = after[LAUNCHES] - before.get(LAUNCHES, 0.0)
    assert launched > 0 and launched % CFG.num_layers == 0
    # Every launch reads at least one block of each slot, at most all.
    blocks = after[BLOCKS] - before.get(BLOCKS, 0.0)
    assert launched * 4 <= blocks <= launched * 4 * sched.engine.max_blocks
    assert blocks % CFG.num_layers == 0
