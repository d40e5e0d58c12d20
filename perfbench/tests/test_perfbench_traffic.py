"""The traffic generator: same seed same schedule, lengths inside the
mix's clips, the same work for every seed in another order,
Poisson-spaced arrivals, and the steady-state set."""
import math
import statistics

import pytest

from perfbench import registry, traffic


def _sched(seed, mix='conv', rate=2.0, horizon=60.0, after=0.0):
    return traffic.schedule(registry.mix(mix), rate, horizon, after, seed,
                            32768)


def test_same_seed_same_schedule():
    a, b = _sched(2 ** 31 + 11), _sched(2 ** 31 + 11)
    assert [(r.offset_s, r.prompt, r.max_tokens) for r in a] == \
        [(r.offset_s, r.prompt, r.max_tokens) for r in b]


def test_other_seed_same_work_other_order():
    """The window holds the same requests for every seed: the same
    lengths and the same gaps, in another order; so does the time after
    it."""
    a, b = (_sched(s, horizon=51.0, after=15.0) for s in (1, 3_000_000_019))
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert len(a) == len(b) == 102 + 30

    def window(reqs, lo, hi):
        return [r for r in reqs if lo <= r.offset_s < hi]
    for lo, hi in ((0.0, 51.0), (51.0, 66.0)):
        wa, wb = window(a, lo, hi), window(b, lo, hi)
        assert len(wa) == len(wb) == round(2.0 * (hi - lo))
        assert sorted(len(r.prompt) for r in wa) == sorted(
            len(r.prompt) for r in wb)
        assert sorted(r.max_tokens for r in wa) == sorted(
            r.max_tokens for r in wb)

    def gaps(reqs, hi):
        """Each request's gap to the next, the last one's to ``hi``."""
        ends = [r.offset_s for r in reqs[1:]] + [hi]
        return sorted(round(e - r.offset_s, 6) for r, e in zip(reqs, ends))
    assert gaps(window(a, 0.0, 51.0), 51.0) == gaps(window(b, 0.0, 51.0),
                                                    51.0)
    assert gaps(window(a, 51.0, 66.0), 66.0) == gaps(window(b, 51.0, 66.0),
                                                     66.0)
    # The lengths are not in sorted order.
    assert [len(r.prompt) for r in a] != sorted(len(r.prompt) for r in a)


def test_lengths_inside_clips_around_medians():
    for name in ('conv', 'code'):
        mix = registry.mix(name)
        reqs = _sched(7, name, rate=5.0, horizon=200.0)
        plens = [len(r.prompt) for r in reqs]
        outs = [r.max_tokens for r in reqs]
        assert min(plens) >= mix['prompt']['min']
        assert max(plens) <= mix['prompt']['max']
        assert min(outs) >= mix['output']['min']
        assert max(outs) <= mix['output']['max']
        assert abs(statistics.median(plens) / mix['prompt']['median']
                   - 1) < 0.05
        assert abs(statistics.median(outs) / mix['output']['median']
                   - 1) < 0.1
        assert all(0 <= t < 32768 for r in reqs for t in r.prompt)


def test_arrivals_poisson_at_rate():
    rate = 4.0
    reqs = _sched(5, rate=rate, horizon=250.0)
    gaps = [b.offset_s - a.offset_s for a, b in zip(reqs, reqs[1:])]
    assert all(g > 0 for g in gaps)
    assert reqs[0].offset_s == 0.0 and reqs[-1].offset_s < 250.0
    assert abs(statistics.mean(gaps) * rate - 1) < 0.05
    # Exponential gaps: the median is ln 2 / rate, the sd about the mean.
    assert abs(statistics.median(gaps) * rate - math.log(2)) < 0.05
    assert abs(statistics.pstdev(gaps) / statistics.mean(gaps) - 1) < 0.1



def _steady(seed, rate=0.7, tpot=0.375):
    return traffic.in_flight(registry.mix('conv'), rate, tpot, seed, 32768,
                             8192)


def test_steady_state_set():
    """Little's law sets the number; outputs are length-biased (a longer
    request is in flight longer), each part-way through; every seed holds
    the same set of outputs and prompt lengths, paired in another order."""
    mix = registry.mix('conv')
    a, b = _steady(1), _steady(3_000_000_019)
    n = round(0.7 * 0.375 * traffic.mean_output(mix))
    assert len(a) == len(b) == n
    assert all(len(r.prompt) + r.max_tokens <= 8191 and r.max_tokens >= 1
               for r in a)
    assert all(r.index < 0 for r in a)
    # Length-biased: the set's outputs are longer than the mix's.
    assert statistics.median(len(r.prompt) + r.max_tokens for r in a) > (
        mix['prompt']['median'] + mix['output']['median'])
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert sum(len(r.prompt) + r.max_tokens for r in a) == pytest.approx(
        sum(len(r.prompt) + r.max_tokens for r in b), rel=0.02)
    assert _steady(5) == _steady(5)
    assert traffic.in_flight(mix, 0.7, 0.0, 1, 32768, 8192) == []
