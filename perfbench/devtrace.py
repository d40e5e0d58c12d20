"""Reduce a torch.profiler Chrome trace (CUDA activity) to what the
per-layer metrics read: device busy time, device time by operation, and
the idle gaps between operations.

Busy time is the union of the intervals in which a kernel, copy or set
ran on the card, so overlapping streams count once. An idle gap is
labelled by the operation that ended it, the work the host was preparing
while the card waited.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
NAME_CHARS = 120


def device_events(trace: Dict) -> List[Tuple[float, float, str]]:
    """(start s, end s, name) of every device operation, by start."""
    out = []
    for ev in trace.get('traceEvents', []):
        if ev.get('ph') != 'X' or ev.get('cat') not in DEVICE_CATS:
            continue
        start = float(ev['ts']) * 1e-6
        out.append((start, start + float(ev.get('dur', 0.0)) * 1e-6,
                    str(ev.get('name', '?'))))
    out.sort()
    return out


def reduce(events: List[Tuple[float, float, str]]) -> Dict:
    by_name: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    busy = 0.0
    cur_s = cur_e = None
    for s, e, name in events:
        by_name[name] += e - s
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps['before ' + name[:NAME_CHARS]] += s - cur_e
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {'busy_s': busy, 'by_name': dict(by_name), 'gaps': dict(gaps),
            'count': len(events)}


def launches(trace: Dict, needle: str) -> List[List]:
    """[start s, end s, grid] of every kernel whose name holds ``needle``,
    by start; the grid is the launch's as the trace records it, or None."""
    out = []
    for ev in trace.get('traceEvents', []):
        if (ev.get('ph') != 'X' or ev.get('cat') != 'kernel'
                or needle not in str(ev.get('name', ''))):
            continue
        start = float(ev['ts']) * 1e-6
        grid = (ev.get('args') or {}).get('grid')
        out.append([start, start + float(ev.get('dur', 0.0)) * 1e-6,
                    list(grid) if grid is not None else None])
    out.sort(key=lambda x: x[0])
    return out


def load(path: str, keep: Tuple[str, ...] = ()) -> Dict:
    """The reduced trace; with ``keep``, also the launches of the kernels
    named there (``launches``) and the first device operation's start
    (``first_s``), on the trace's clock."""
    with open(path, encoding='utf-8') as f:
        trace = json.load(f)
    events = device_events(trace)
    out = reduce(events)
    if keep:
        out['launches'] = {k: launches(trace, k) for k in keep}
        out['first_s'] = events[0][0] if events else None
    return out


def device_seconds(reduced: Dict, needle: str) -> float:
    """Device time of every operation whose name holds ``needle``."""
    return sum(t for n, t in reduced['by_name'].items() if needle in n)


def breakdown(reduced: Dict, top: int = 10) -> Dict:
    ops = sorted(reduced['by_name'].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(reduced['gaps'].items(), key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[n[:NAME_CHARS], t] for n, t in ops],
            'idle_gaps': [[n, t] for n, t in gaps]}
