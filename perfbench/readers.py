"""What the metric readers (``metrics/<name>.py``) share: the requests
of a serving window and the work a traced window held, counted from the
inputs."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

from perfbench import yardstick

# K1's kernel, by the name the port gives it.
K1_KERNEL = 'flash_fwd_kernel'
# A first token may seem to come this much before its prefill's end, the
# error of placing the trace on the host's clock.
LAG_SLACK_S = 0.1


def window_records(run: Dict) -> List:
    close_at = run['window'][1]
    return [r for r in run['records'] if r.due < close_at]


def ttfts_ms(run: Dict) -> List[float]:
    """Each window request's time from due to first token; one that never
    got a first token counts from due to the end of the wait, a lower
    bound that misses any limit a served request met."""
    out = []
    for r in window_records(run):
        end = r.first if r.first is not None else run['drained']
        out.append((end - r.due) * 1e3)
    return out


def tpots_ms(run: Dict) -> List[float]:
    return [(r.token_times[-1] - r.token_times[0]) * 1e3
            / (len(r.token_times) - 1)
            for r in window_records(run) if len(r.token_times) >= 2]


def all_records(run: Dict) -> List:
    """The scheduled requests and the steady-state set admitted in
    set-up, whose tokens the window also carries."""
    return run['records'] + run.get('steady', [])


def prefill_groups(launches: List, layers: int) -> List[List]:
    """K1's launches in a trace cut into prefills, in order: [grid,
    launches] each. A prefill launches K1 once a layer with one grid, so
    a run of equal grids holds whole prefills, but for the trace's two
    edges: the part of a prefill that the trace cut holds fewer."""
    runs: List[List] = []
    for ev in launches:
        grid = tuple(ev[2]) if ev[2] is not None else None
        if runs and runs[-1][0] == grid:
            runs[-1][1].append(ev)
        else:
            runs.append([grid, [ev]])
    groups = []
    for i, (grid, evs) in enumerate(runs):
        lead = len(evs) % layers if i == 0 else 0
        cuts = ([evs[:lead]] if lead else []) + [
            evs[p:p + layers] for p in range(lead, len(evs), layers)]
        groups += [[grid, c] for c in cuts]
    return groups


def _size(grid) -> int:
    return math.prod(grid) if grid else 0


def match_prefills(run: Dict) -> List[Tuple[object, float]]:
    """(request, share) for each prefill whose K1 launches the trace
    holds, the share being the part of its layers held.

    Prefills run one after another, and each one's first token reaches
    the client after it, in the same order; so the traced prefills are
    consecutive requests in the order of their first tokens. Of each
    such run of requests, the one taken is the one whose prompt lengths
    order as the groups' grids do (a larger grid, a longer prompt) and
    whose first tokens follow their groups' ends (placed on the host's
    clock by the trace's first operation, at the profiler's start) by
    the steadiest lag."""
    tr = run['trace']
    layers = run['dims']['layers']
    launches = (tr.get('launches') or {}).get(K1_KERNEL) or []
    groups = prefill_groups(launches, layers)
    cands = sorted((r for r in all_records(run) if r.first is not None),
                   key=lambda r: r.first)
    k = len(groups)
    if not k or len(cands) < k:
        return []
    ends = [tr['t0'] + (g[1][-1][1] - tr['first_s']) for g in groups]
    sizes = [_size(g[0]) for g in groups]
    best = None
    for j in range(len(cands) - k + 1):
        sel = cands[j:j + k]
        lens = [len(r.request.prompt) for r in sel]
        bad = sum(1 for i in range(k - 1)
                  if (sizes[i] < sizes[i + 1] and lens[i] >= lens[i + 1])
                  or (sizes[i] > sizes[i + 1] and lens[i] <= lens[i + 1]))
        lags = [r.first - e for r, e in zip(sel, ends)]
        bad += sum(1 for x in lags if x < -LAG_SLACK_S)
        key = (bad, max(lags) - min(lags), abs(statistics.median(lags)))
        if best is None or key < best[0]:
            best = (key, j)
    tr['match'] = {'prefills': k, 'offset': best[1],
                   'violations': best[0][0], 'lag_spread_s': best[0][1],
                   'lag_median_s': best[0][2]}
    sel = cands[best[1]:best[1] + k]
    return [(r, len(g[1]) / layers) for r, g in zip(sel, groups)]


def traced_work(run: Dict) -> Optional[Tuple[float, float, float]]:
    """(model FLOPs, K1's least seconds, prefills) of the traced window:
    each prefill K1 ran in the trace by its real prompt length and the
    share of its layers the trace holds, and each later token that
    reached the client inside the trace at its position."""
    tr = run.get('trace')
    if tr is None or 't0' not in tr:
        return None
    t0, t1 = tr['t0'], tr['t1']
    dims = run['dims']
    flops = k1 = prefills = 0.0
    for r, share in match_prefills(run):
        plen = len(r.request.prompt)
        prefills += share
        flops += share * yardstick.prefill_flops(dims, plen)
        k1 += share * dims['layers'] * yardstick.flash_fwd_bound_s(
            1, plen, plen, dims['h'], dims['kvh'], dims['d'])
    for r in all_records(run):
        plen = len(r.request.prompt)
        for j, t in enumerate(r.token_times[1:], start=1):
            if t0 <= t < t1:
                flops += yardstick.decode_token_flops(dims, plen + j - 1)
    return flops, k1, prefills
