"""Each metric's arithmetic on a canned ``/metrics`` delta, canned
request records and a canned Chrome trace."""
import json

import pytest

from perfbench import devtrace, promtext, readers, registry, yardstick
from perfbench.loadgen import Record
from perfbench.traffic import Request

BEFORE = '''# HELP skytpu_serve_queue_wait_ms submit to admission-start wall time
# TYPE skytpu_serve_queue_wait_ms histogram
skytpu_serve_queue_wait_ms_bucket{le="10"} 3
skytpu_serve_queue_wait_ms_bucket{le="+Inf"} 4 # {trace_id="a"} 12.0
skytpu_serve_queue_wait_ms_sum 40.0
skytpu_serve_queue_wait_ms_count 4
skytpu_engine_step_ms_sum{variant="verify"} 1000
skytpu_engine_step_ms_count{variant="verify"} 10
skytpu_engine_step_ms_sum{variant="step"} 50
skytpu_engine_step_ms_count{variant="step"} 1
'''
AFTER = BEFORE.replace('_sum 40.0', '_sum 340.0').replace(
    '_count 4', '_count 7').replace('"verify"} 1000', '"verify"} 2600'
                                   ).replace('"verify"} 10', '"verify"} 30')


def _read(name, run):
    return registry.reader(name)(run)


def _serve_run(records, window=(100.0, 110.0), trace=None):
    dims = yardstick.model_dims(registry.config('mistral-7b'))
    return {'kind': 'serve', 'records': records, 'window': window,
            'drained': 115.0, 'dims': dims, 'metrics_before':
            promtext.parse(BEFORE), 'metrics_after': promtext.parse(AFTER),
            'trace': trace, 'setup_s': 33.0}


def _rec(index, due, times, plen=100):
    r = Record(Request(index, 0.0, [1] * plen, len(times)), due=due)
    r.token_times = list(times)
    r.tokens = [5] * len(times)
    r.done = True
    return r


def test_exposition_deltas():
    run = _serve_run([])
    assert _read('sched_queue_wait_ms', run) == pytest.approx(300.0 / 3)
    assert _read('engine_step_ms', run) == pytest.approx(1600.0 / 20)
    assert promtext.parse(BEFORE)['skytpu_engine_step_ms_count'] == 11


def test_ttft_tpot_output():
    recs = [_rec(i, 100.0 + i, [100.0 + i + 0.1 * (i + 1) + 0.05 * k
                                for k in range(3)]) for i in range(10)]
    late = _rec(10, 109.5, [])        # due in the window, never served
    after = _rec(11, 112.0, [112.5])  # due after the close: not counted
    run = _serve_run(recs + [late, after])
    ttfts = sorted([100.0 * (i + 1) for i in range(10)] + [5500.0])
    # p75 of 11 values by linear interpolation: rank 7.5
    assert _read('ttft_p75_ms', run) == pytest.approx(
        (ttfts[7] + ttfts[8]) / 2)
    assert _read('tpot_p75_ms', run) == pytest.approx(50.0)
    inside = sum(1 for r in recs for t in r.token_times if t < 110.0)
    assert _read('output_tok_s', run) == pytest.approx(inside / 10.0)
    # The steady-state set's tokens inside the window count too.
    run['steady'] = [_rec(-1000, 90.0, [95.0, 100.5, 101.5, 111.0])]
    assert _read('output_tok_s', run) == pytest.approx((inside + 2) / 10.0)
    assert _read('ttft_p75_ms', run) == pytest.approx(
        (ttfts[7] + ttfts[8]) / 2)
    assert _read('setup_s', run) == 33.0


def _trace_file(tmp_path, events):
    body = {'traceEvents': [
        {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
        for cat, name, ts, dur in events] + [
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
         'ts': 0, 'dur': 5}]}
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(body))
    return str(path)


def test_trace_reduction(tmp_path):
    path = _trace_file(tmp_path, [
        ('kernel', 'void flash_fwd_kernel<128>(Params)', 0, 100),
        ('kernel', 'gemm_a', 50, 100),          # overlaps: busy counts once
        ('gpu_memcpy', 'Memcpy HtoD', 400, 50),
        ('kernel', 'gemm_a', 1000, 200)])
    red = devtrace.load(path)
    assert red['busy_s'] == pytest.approx((150 + 50 + 200) * 1e-6)
    assert red['by_name']['gemm_a'] == pytest.approx(300e-6)
    assert devtrace.device_seconds(red, 'flash_fwd_kernel') == \
        pytest.approx(100e-6)
    assert red['gaps'] == pytest.approx({'before Memcpy HtoD': 250e-6,
                                         'before gemm_a': 550e-6})
    bd = devtrace.breakdown(red)
    assert bd['device_ops'][0][0] == 'gemm_a'
    assert bd['idle_gaps'][0] == ['before gemm_a', pytest.approx(550e-6)]


def _k1(start, n, grid, layers=32, step=0.001):
    """n K1 launches of one grid, ``step`` apart (device seconds)."""
    return [[start + i * step, start + i * step + 0.0005, [grid, 1, 1]]
            for i in range(n)]


def test_prefill_groups_cut_at_the_trace_edges():
    # 5 launches of a prefill the trace caught late, two whole prefills
    # of one grid, a whole one of another, 7 of one it cut.
    launches = (_k1(0.0, 5, 64) + _k1(1.0, 64, 64) + _k1(2.0, 32, 96)
                + _k1(3.0, 7, 32))
    groups = readers.prefill_groups(launches, 32)
    assert [(g[0], len(g[1])) for g in groups] == [
        ((64, 1, 1), 5), ((64, 1, 1), 32), ((64, 1, 1), 32),
        ((96, 1, 1), 32), ((32, 1, 1), 7)]


def test_serve_trace_metrics():
    """Prefills are taken from K1's launches in the trace: each by the
    prompt of the request whose first token follows it, the order of
    grids matching the order of prompt lengths; partial ones by their
    share of layers. Later tokens count where the client got them inside
    the trace."""
    launches = (_k1(0.010, 8, 256) + _k1(0.500, 32, 512)
                + _k1(1.200, 32, 256) + _k1(2.000, 16, 768))
    red = devtrace.reduce([(ev[0], ev[1], 'flash_fwd_kernel<128>')
                           for ev in launches] + [(2.1, 3.9, 'gemm')])
    red.update(launches={'flash_fwd_kernel': launches}, first_s=0.0)
    trace = dict(red, t0=100.0, t1=104.0, window_s=4.0)
    # Requests in the order of their first tokens; each first token comes
    # 0.2 s after its prefill's last launch (host clock = 100 + device).
    recs = [_rec(0, 97.0, [99.0], plen=3000),            # before the trace
            _rec(1, 98.0, [100.22, 100.4], plen=900),    # 8 of 32 layers
            _rec(2, 98.0, [100.73, 101.0, 104.5], plen=2000),
            _rec(3, 99.0, [101.43], plen=1000),
            _rec(4, 99.0, [102.215], plen=2500),         # 16 of 32
            _rec(5, 99.0, [104.6], plen=1500)]           # after the trace
    run = _serve_run(recs, trace=trace)
    d = run['dims']

    def k1(n):
        return 32 * yardstick.flash_fwd_bound_s(1, n, n, 32, 8, 128)
    shares = [(900, 0.25), (2000, 1.0), (1000, 1.0), (2500, 0.5)]
    flops = (sum(s * yardstick.prefill_flops(d, n) for n, s in shares)
             + yardstick.decode_token_flops(d, 900)
             + yardstick.decode_token_flops(d, 2000))
    assert _read('mfu.serve', run) == pytest.approx(
        100 * flops / (red['busy_s'] * yardstick.PEAK_BF16_FLOPS))
    k1_s = sum(ev[1] - ev[0] for ev in launches)
    assert _read('k1_roofline.serve', run) == pytest.approx(
        100 * sum(s * k1(n) for n, s in shares) / k1_s)
    assert trace['match']['violations'] == 0
    assert _read('device_idle.serve', run) == pytest.approx(
        100 * (1 - red['busy_s'] / 4.0))


def test_trace_keeps_k1_launches(tmp_path):
    body = {'traceEvents': [
        {'ph': 'X', 'cat': 'kernel', 'name': 'void flash_fwd_kernel<128>',
         'ts': 20, 'dur': 10, 'args': {'grid': [64, 1, 1]}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'gemm', 'ts': 10, 'dur': 5}]}
    path = tmp_path / 'k1.json'
    path.write_text(json.dumps(body))
    red = devtrace.load(str(path), keep=('flash_fwd_kernel',))
    assert red['launches']['flash_fwd_kernel'] == [
        [pytest.approx(20e-6), pytest.approx(30e-6), [64, 1, 1]]]
    assert red['first_s'] == pytest.approx(10e-6)


def test_readers_find_nothing_without_a_trace():
    run = _serve_run([_rec(0, 101.0, [101.5])])
    for name in ('k1_roofline.serve', 'mfu.serve', 'device_idle.serve',
                 'k2_roofline.train', 'mfu.train', 'device_idle.train',
                 'train_tok_s'):
        assert _read(name, run) is None


def test_train_metrics():
    dims = dict(yardstick.model_dims(registry.config('mistral-7b')),
                layers=8)
    red = devtrace.reduce([(0.0, 0.01, 'flash_bwd_dkdv_kernel<128>'),
                           (0.01, 0.02, 'flash_bwd_dq_kernel<128>'),
                           (0.02, 9.0, 'gemm')])
    run = {'kind': 'train', 'dims': dims, 'steps': 10, 'batch': 2,
           'seq': 8192, 'window_s': 10.0, 'tokens': 163840,
           'trace': dict(red, window_s=10.0, steps=10), 'setup_s': 1.0}
    assert _read('train_tok_s', run) == pytest.approx(16384.0)
    assert _read('mfu.train', run) == pytest.approx(
        100 * 10 * yardstick.train_step_flops(dims, 2, 8192)
        / (10.0 * yardstick.PEAK_BF16_FLOPS))
    bound = 10 * 8 * yardstick.flash_bwd_bound_s(2, 8192, 8192, 32, 8, 128)
    assert _read('k2_roofline.train', run) == pytest.approx(
        100 * bound / 0.02)
    assert _read('device_idle.train', run) == pytest.approx(
        100 * (1 - 9.0 / 10.0))
