"""Collectives micro-benchmark: all-reduce bus bandwidth over every rank.

Counterpart of ``skypilot_tpu/ops/collectives_bench.py`` (the reference's
NCCL all-reduce test, examples/nccl_test.yaml:12-14), with the same
payload convention and accounting: the buffer is each rank's
contribution, algbw = bytes / time and busbw = algbw * 2(n-1)/n (each
element crosses the wire 2(n-1)/n times in a ring all-reduce). The
collective is ``torch.distributed.all_reduce`` over every rank of the
job's group (NCCL between GPUs, gloo on the CPU); the JSON line matches
JAX's, with ``predicted_bisection_gbps`` null (the port has no
interconnect model of its cards).

    SKYTPU_COORDINATOR_ADDR=... SKYTPU_NUM_PROCESSES=... SKYTPU_PROCESS_ID=... \\
        python -m skypilot_tpu_torch.ops.collectives_bench --sizes-mb 1 16 128
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import torch

from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device


def run_bench(sizes_mb: Optional[List[float]] = None, iters: int = 10,
              warmup: int = 3, device: DeviceLike = None,
              verbose: bool = True) -> List[dict]:
    """One record per payload size (bandwidths in GB/s), over every rank
    of the process group (one rank without one). The buffers live on the
    card unless ``device`` is the CPU; with no card that raises."""
    import torch.distributed as dist

    from skypilot_tpu_torch.runtime import distributed
    sizes_mb = sizes_mb or [1.0, 16.0, 128.0]
    n = distributed.world_size()
    device = resolve_device(device)

    def allreduce(x):
        if n > 1:  # the default group: the 1-D mesh of every rank
            dist.all_reduce(x)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    records = []
    for mb in sizes_mb:
        elems = int(mb * 1e6 / 4)  # the per-rank buffer, f32
        x = torch.ones(elems, dtype=torch.float32, device=device)
        for _ in range(warmup + 1):
            allreduce(x)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            allreduce(x)
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        nbytes = elems * 4
        algbw = nbytes / t / 1e9
        busbw = algbw * 2 * (n - 1) / n
        rec = {
            'payload_mb': round(nbytes / 1e6, 2),
            'ranks': n,
            'time_ms': round(t * 1e3, 3),
            'algbw_gbps': round(algbw, 3),
            'busbw_gbps': round(busbw, 3),
        }
        records.append(rec)
        if verbose and distributed.rank() == 0:
            print(f'allreduce {rec["payload_mb"]:>10.2f} MB x {n} ranks: '
                  f'{rec["time_ms"]:>8.3f} ms  busbw {busbw:.2f} GB/s',
                  flush=True)
    return records


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog='skypilot_tpu_torch.ops.collectives_bench')
    parser.add_argument('--sizes-mb', type=float, nargs='*', default=None)
    parser.add_argument('--iters', type=int, default=10)
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='where the buffers live (default cuda; cpu '
                        'runs over gloo)')
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.runtime import distributed
    distributed.init(device_type=resolve_device(args.device).type)
    # Resolved again after init, which picks this rank's card.
    records = run_bench(args.sizes_mb, iters=args.iters, device=args.device)
    if distributed.rank() == 0:
        print(json.dumps({'allreduce': records,
                          'predicted_bisection_gbps': None}))
    distributed.shutdown()


if __name__ == '__main__':
    main()
