"""Readings that set a cell's limits, run on the chip apart from the
benchmark's own runs:

    python3 -m perfbench.controls --workload <cell> --seeds a,b,c \
        --seconds <s> [--fault half_batch]

For each seed it makes one run of the cell (a short window at the cell's
own load and sizes) and prints one JSON line with the program's numbers
and, at the same prompts and tokens (serving) or from the same weights
and rows (training), the control's: the reference computed with fp8
(e4m3) matrix products, the precision below the configurations' bf16.
With ``--fault`` the training program runs with that fault planted.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog='perfbench.controls')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=15.0)
    p.add_argument('--fault', default=None)
    p.add_argument('--no-control', action='store_true')
    a = p.parse_args(argv)
    from perfbench import registry, run as run_mod
    cell = registry.cell(a.workload)
    for seed in [int(s) for s in a.seeds.split(',')]:
        t0 = time.perf_counter()
        args = run_mod.parse_args(['--workload', a.workload, '--seed',
                                   str(seed), '--seconds', str(a.seconds)])
        ctx = run_mod.context(args, t0, fault=a.fault)
        out = {'workload': a.workload, 'seed': seed, 'fault': a.fault}
        if cell['kind'] == 'serve':
            from perfbench import serve
            rec = serve.run(ctx)
            lowp = (None,) if a.no_control else (None, 'fp8')
            out.update(serve.compare(rec, 'cuda', lowp))
            out['attempted'] = len(serve.in_window(rec))
            out['failed'] = len(serve.failed(rec))
        else:
            from perfbench import train
            rec = train.run(ctx)
            ref = _train_reference(rec, None)
            out['program'] = train.gaps(rec['program'], ref)
            if not a.no_control:
                out['control'] = train.gaps(_train_reference(rec, 'fp8'),
                                            ref)
        out['seconds'] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        # The reference's blocks stay cached in this process; the next
        # seed's replica needs the card.
        del rec
        gc.collect()
        import torch
        torch.cuda.empty_cache()
    return 0


def _train_reference(rec, lowp):
    """The reference's three steps from the run's weights and rows, in
    f32 or (the control, in the program's place) with fp8 products."""
    from perfbench import train
    from perfbench.reference import train as ref_train
    cfg, dims = rec['config'], rec['dims']
    b, t, seed = rec['batch'], rec['seq'], rec['seed']
    batches = [train.batch_tokens(seed, k, b, t, dims['v'], 'cuda')
               for k in range(train.FIRST_STEPS)]
    return ref_train.train_steps(dims, cfg, seed, batches,
                                 float(cfg['train']['lr']), 'cuda', lowp)


if __name__ == '__main__':
    sys.exit(main())
