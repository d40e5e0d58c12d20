"""Prometheus text exposition, read as the replica's ``/metrics`` renders
it (a frozen copy of what the port's ``serve_bench`` reads): sums and
counts of histograms, values of counters, summed over label sets."""
from __future__ import annotations

from typing import Dict


def parse(text: str) -> Dict[str, float]:
    """sample name -> value, summed over label sets; exemplars dropped."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        line = line.split(' # ', 1)[0]
        head, _, value = line.rpartition(' ')
        name = head.split('{', 1)[0]
        if name.endswith('_bucket'):
            continue
        try:
            out[name] = out.get(name, 0.0) + float(value)
        except ValueError:
            continue
    return out


def delta_mean(before: Dict[str, float], after: Dict[str, float],
               histogram: str):
    """Mean of a histogram's observations between two scrapes, or None
    when none fell between them."""
    count = (after.get(f'{histogram}_count', 0.0)
             - before.get(f'{histogram}_count', 0.0))
    if count <= 0:
        return None
    total = (after.get(f'{histogram}_sum', 0.0)
             - before.get(f'{histogram}_sum', 0.0))
    return total / count
