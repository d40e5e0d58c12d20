"""The one traffic generator: a mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

Every seed gets the same work in another order. Lengths are the
quantiles of the mix's clipped log-normal at (i + 0.5) / n, and the gaps
between arrivals those of an exponential at the cell's rate, scaled so
that the window holds the same requests whatever their order; the seed
shuffles each list and draws the token ids (and the run's weights).

``in_flight`` gives the requests a replica holds in steady state, which
a serving cell admits during set-up so that its window opens on a
loaded replica and not an empty one.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
import random
import statistics
from typing import Dict, List

# Outputs drawn for the steady-state set come from this many quantiles.
STEADY_GRID = 4096


@dataclasses.dataclass
class Request:
    index: int
    offset_s: float           # due time after the start of the schedule
    prompt: List[int]
    max_tokens: int


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> List[int]:
    norm = statistics.NormalDist()
    out = []
    for i in range(n):
        z = norm.inv_cdf((i + 0.5) / n)
        out.append(int(min(hi, max(lo, round(median * math.exp(sigma * z))))))
    return out


def exponential_gaps(n: int, rate: float) -> List[float]:
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


def _lengths(part: Dict, n: int) -> List[int]:
    return lognormal_quantiles(n, part['median'], part['sigma'],
                               part['min'], part['max'])


def _tokens(rnd: random.Random, n: int, vocab: int) -> List[int]:
    return [rnd.randrange(vocab) for _ in range(n)]


def _part(mix: Dict, rate: float, span_s: float, order: random.Random
          ) -> List[tuple]:
    """(offset, prompt length, output) of round(rate x span_s) requests
    over ``span_s`` seconds: the mix's length quantiles, and an
    exponential's gap quantiles scaled to fill the span exactly, each
    list shuffled by ``order``."""
    n = max(1, int(round(rate * span_s)))
    prompts = _lengths(mix['prompt'], n)
    outputs = _lengths(mix['output'], n)
    gaps = exponential_gaps(n, rate)
    scale = span_s / sum(gaps)
    for seq in (prompts, outputs, gaps):
        order.shuffle(seq)
    out, t = [], 0.0
    for i in range(n):
        out.append((t, prompts[i], outputs[i]))
        t += gaps[i] * scale
    return out


def schedule(mix: Dict, rate: float, window_s: float, after_s: float,
             seed: int, vocab: int) -> List[Request]:
    """Requests due at ``rate`` per second over the window, and then over
    ``after_s`` seconds more. The window's requests are the same set for
    every seed (lengths and gaps), in the seed's order; so are those
    after it."""
    order = random.Random(f'order/{mix.get("name", "")}/{int(seed)}')
    rnd = random.Random(f'traffic/{int(seed)}')
    parts = [(0.0, _part(mix, rate, window_s, order))]
    if after_s > 0:
        parts.append((window_s, _part(mix, rate, after_s, order)))
    reqs = []
    for base, part in parts:
        for t, plen, out in part:
            reqs.append(Request(len(reqs), base + t,
                                _tokens(rnd, plen, vocab), out))
    return reqs


def mean_output(mix: Dict) -> float:
    return statistics.fmean(_lengths(mix['output'], STEADY_GRID))


def in_flight(mix: Dict, rate: float, tpot_s: float, seed: int, vocab: int,
              max_len: int) -> List[Request]:
    """The requests in a replica that has served ``rate`` per second for
    longer than any request lives, each token taking ``tpot_s``.

    Their number is rate x tpot_s x the mean output (Little's law). A
    request stays for a time in proportion to its output, so the outputs
    are the quantiles of the length-biased output distribution; each is
    part-way through, at fractions (i + 0.5) / n. Its ``prompt`` is the
    mix's prompt followed by the tokens already served (random, from the
    seed), and ``max_tokens`` what is left. Every seed gets the same
    set, paired in another order.
    """
    grid = sorted(_lengths(mix['output'], STEADY_GRID))
    n = int(round(rate * tpot_s * statistics.fmean(grid)))
    if n <= 0:
        return []
    cum = list(itertools.accumulate(grid))
    outputs = [grid[min(len(grid) - 1,
                        bisect.bisect_left(cum, (i + 0.5) / n * cum[-1]))]
               for i in range(n)]
    prompts = _lengths(mix['prompt'], n)
    fracs = [(i + 0.5) / n for i in range(n)]
    order = random.Random(f'steady/{mix.get("name", "")}/{n}/{int(seed)}')
    order.shuffle(prompts)
    order.shuffle(fracs)
    rnd = random.Random(f'steady-tokens/{int(seed)}')
    reqs = []
    for i in range(n):
        served = int(fracs[i] * outputs[i])
        context = min(prompts[i] + served, max_len - 2)
        left = min(outputs[i] - served, max_len - 1 - context)
        reqs.append(Request(-1000 - i, 0.0, _tokens(rnd, context, vocab),
                            max(1, left)))
    return reqs
