"""The sweep that found each serving cell's knee, run once on the chip:

    python3 -m perfbench.sweep --workload <cell> --rates 0.4,0.6,0.8 \
        --seconds 120 --seed <n>

One fresh replica per rate (a replica finishes the requests a client
left), each filled in set-up with the steady-state set of that rate (as
a run of the cell is) and offered the cell's mix at that rate for
``--seconds``. Per rate one JSON line: requests due, TTFT and output
tokens/s by quarter of the window, requests in the replica at the start
and the close. The knee is the highest rate that keeps up: output
tokens/s at the offered tokens, TTFT not growing from quarter to
quarter, the replica no fuller at the close than at the start.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from perfbench import readers, stats, traffic


def quarters(run):
    start, close = run['window']
    q = (close - start) / 4
    out = []
    for i in range(4):
        lo, hi = start + i * q, start + (i + 1) * q
        recs = [r for r in run['records'] if lo <= r.due < hi]
        ttft = [((r.first if r.first else run['drained']) - r.due) * 1e3
                for r in recs]
        toks = sum(1 for r in readers.all_records(run) for t in r.token_times
                   if lo <= t < hi)
        out.append({'due': len(recs),
                    'ttft_p50_ms': stats.percentile(ttft, 50),
                    'ttft_p90_ms': stats.percentile(ttft, 90),
                    'tok_s': toks / q})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog='perfbench.sweep')
    p.add_argument('--workload', required=True)
    p.add_argument('--rates', required=True)
    p.add_argument('--seconds', type=float, default=120.0)
    p.add_argument('--seed', type=int, default=2_147_483_659)
    a = p.parse_args(argv)
    from perfbench import registry, run as run_mod, serve
    for rate in [float(r) for r in a.rates.split(',')]:
        t0 = time.perf_counter()
        args = run_mod.parse_args(['--workload', a.workload, '--seed',
                                   str(a.seed), '--seconds', str(a.seconds)])
        ctx = run_mod.context(args, t0, rate_per_s=rate, grace_s=30)
        rec = serve.run(ctx)
        close = rec['window'][1]
        inside = readers.window_records(rec)
        offered = rate * traffic.mean_output(ctx['mix'])
        start = rec['window'][0]

        def held_at(t):
            return [r for r in readers.all_records(rec)
                    if r.sent is not None and r.sent < t and not
                    (r.token_times and r.done and r.token_times[-1] < t)]

        def kv_bytes_at(t):
            d = rec['dims']
            per_token = 2 * 2 * d['layers'] * d['kvh'] * d['d']
            return per_token * sum(
                len(r.request.prompt) + sum(1 for x in r.token_times if x < t)
                for r in held_at(t))
        print(json.dumps({
            'workload': a.workload, 'rate': rate, 'seconds': a.seconds,
            'due': len(inside), 'failed': len(serve.failed(rec)),
            'offered_tok_s': offered,
            'output_tok_s': registry.reader('output_tok_s')(rec),
            'ttft_p75_ms': registry.reader('ttft_p75_ms')(rec),
            'ttft_p90_ms': stats.percentile(readers.ttfts_ms(rec), 90),
            'tpot_p75_ms': registry.reader('tpot_p75_ms')(rec),
            'tpot_p50_ms': stats.percentile(readers.tpots_ms(rec), 50),
            'steady_admitted': len(rec['steady']),
            'in_replica_at_start': len(held_at(start)),
            'in_replica_at_close': len(held_at(close)),
            'kv_bytes_at_start': kv_bytes_at(start),
            'kv_bytes_at_close': kv_bytes_at(close),
            'setup_s': rec['setup_s'], 'quarters': quarters(rec),
            'memory_peak_bytes': rec['memory_peak_bytes']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
