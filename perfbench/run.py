"""One run of one benchmark cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with a trace
``breakdown``, and last ``checks``: each number compared with its limit
(also the last lines of standard error). Exits non-zero and prints no
result without as many CUDA devices as the cell asks for, or if JAX or
the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from perfbench import guard, registry  # noqa: E402

CACHE = os.path.join(registry.HERE, '.cache')


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog='perfbench.run')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment(cache: str = CACHE) -> Dict[str, str]:
    """The program's caches at fixed paths inside the checkout, metrics
    on, and nothing that would load JAX."""
    env = dict(os.environ)
    env.update({
        'SKYTPU_KERNEL_CACHE_DIR': os.path.join(cache, 'kernels'),
        'TRITON_CACHE_DIR': os.path.join(cache, 'triton'),
        'SKYTPU_PROFILE_DIR': os.path.join(cache, 'profiles'),
        'SKYTPU_STATE_DIR': os.path.join(cache, 'state'),
        'SKYTPU_METRICS': '1',
        'PYTHONPATH': registry.ROOT,
    })
    env.pop('SKYTPU_TIMELINE', None)
    for key in ('SKYTPU_KERNEL_CACHE_DIR', 'TRITON_CACHE_DIR',
                'SKYTPU_PROFILE_DIR', 'SKYTPU_STATE_DIR'):
        os.makedirs(env[key], exist_ok=True)
    return guard.quiet_env(env)


def context(args, t0: float, device: str = 'cuda',
            here: str = registry.HERE, fault: Optional[str] = None,
            cache: str = CACHE, **cell_overrides) -> Dict:
    """What a run of ``args.workload`` reads: its cell, configuration and
    mix, and the environment (also set in this process)."""
    env = environment(cache)
    os.environ.update(env)
    cell = dict(registry.cell(args.workload, here), **cell_overrides)
    return {'args': args, 'cell': cell,
            'config': registry.config(cell['config'], here),
            'mix': registry.mix(cell['traffic'], here), 't0': t0,
            'device': device, 'env': env, 'fault': fault, 'scratch': cache}


def run_cell(args, t0: float, device: str = 'cuda',
             here: str = registry.HERE, root: str = registry.ROOT,
             fault: Optional[str] = None,
             cache: str = CACHE) -> Dict:
    """Run the cell and return the result object. ``device='cpu'`` is a
    rehearsal at whatever size the cell's files give: it returns no
    metric, since a CPU run measures no device."""
    ctx = context(args, t0, device, here, fault, cache)
    cell = ctx['cell']
    if cell['kind'] == 'serve':
        from perfbench import serve as kind
    elif cell['kind'] == 'train':
        from perfbench import train as kind
    else:
        raise ValueError(f'unknown cell kind {cell["kind"]!r}')
    run = kind.run(ctx)
    bench = registry.benchmark(root)
    entries = registry.metrics_for(bench, args.workload, bool(args.trace))
    metrics = (registry.read_metrics(entries, run, here)
               if device == 'cuda' else {})
    missing = [m['name'] for m in entries if m['name'] not in metrics]
    checks, correct = judge(run, kind, cell, device)
    dev = {'platform': 'gpu' if device == 'cuda' else 'cpu',
           'kind': _device_name(device), 'count': int(cell['chips']),
           'memory_peak_bytes': int(run['memory_peak_bytes'])}
    result = {'correct': bool(correct and (device != 'cuda'
                                           or not missing)),
              'attempted': 0, 'failed': 0, 'metrics': metrics,
              'device': dev}
    if run['kind'] == 'serve':
        result['attempted'] = len(kind.in_window(run))
        result['failed'] = len(kind.failed(run))
        if run['child_forbidden']:
            result['correct'] = False
            checks['replica_loads_jax'] = {'value': 1, 'limit': 0}
    else:
        result['attempted'] = run['steps']
        result['failed'] = run['nonfinite']
    if missing and device == 'cuda':
        checks['metrics_missing'] = {'value': len(missing), 'limit': 0}
    if args.trace and 'trace' in run:
        from perfbench import devtrace
        tr = run['trace']
        dev['busy_s'] = tr['busy_s']
        dev['window_s'] = tr['window_s']
        result['breakdown'] = devtrace.breakdown(tr)
        if 'match' in tr:
            print(f'trace prefills: {json.dumps(tr["match"])}',
                  file=sys.stderr)
    result['checks'] = checks
    return result


def judge(run: Dict, kind, cell: Dict, device: str):
    """The comparison with the reference, each number beside its limit."""
    limits = cell['limits']
    if run['kind'] == 'serve':
        got = kind.compare(run, device)
        if not got.get('served'):
            return {'served_tokens_min': {
                'value': 0, 'limit': cell['check']['min_served_tokens']}}, False
        checks = {name: {'value': got[name], 'limit': limits[name]}
                  for name in limits}
        ok = got['in_vocab'] and all(c['value'] <= c['limit']
                                     for c in checks.values())
        # A floor, not a ceiling: the sample has to hold this many tokens.
        floor = cell['check']['min_served_tokens']
        checks['served_tokens_min'] = {'value': got['served'],
                                       'limit': floor}
        ok = ok and got['served'] >= floor
        if not got['in_vocab']:
            checks['tokens_out_of_vocab'] = {'value': 1, 'limit': 0}
        return checks, ok
    got = kind.compare(run, device)
    checks = {name: {'value': got[name], 'limit': limits[name]}
              for name in limits}
    ok = run['nonfinite'] == 0 and all(c['value'] <= c['limit']
                                       for c in checks.values())
    return checks, ok


def _device_name(device: str) -> str:
    if device != 'cuda':
        return 'cpu'
    import torch
    return torch.cuda.get_device_name(0)


def emit(result: Dict) -> None:
    for name, c in result['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = registry.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print('perfbench: no CUDA device; a run measures the card only',
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell['chips']):
        print(f'perfbench: {args.workload} needs {cell["chips"]} CUDA '
              f'devices, found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    result = run_cell(args, T0)
    found = guard.forbidden_loaded()
    if found:
        print(f'perfbench: loaded after the window: {found}', file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
