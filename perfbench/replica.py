"""A generation-server replica of the port, run by a serving cell in a
process of its own: ``python3 -m perfbench.replica`` with one JSON line
of arguments on standard input.

It draws the weights from the seed, starts ``GenerationScheduler`` and
``GenerationServer`` on 127.0.0.1, and prints ``{"port": N}`` once
``/health`` would answer. Then it reads commands from standard input,
one JSON line each, and answers each on standard output:
``profile_start`` / ``profile_stop`` (a CUDA-only torch.profiler trace,
written where the command says), ``peak`` (the process's peak device
memory) and ``stop``. It exits when its parent closes standard input or
dies.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time


# Replies go to the pipe the parent reads; whatever the program prints
# goes to standard error.
_OUT = sys.stdout


def _reply(obj) -> None:
    _OUT.write(json.dumps(obj) + '\n')
    _OUT.flush()


def _die_with_parent() -> None:
    try:
        import ctypes
        libc = ctypes.CDLL('libc.so.6', use_errno=True)
        libc.prctl(1, 15)  # PR_SET_PDEATHSIG, SIGTERM
    except OSError:
        pass


def main() -> None:
    _die_with_parent()
    sys.stdout = sys.stderr
    args = json.loads(sys.stdin.readline())
    import torch
    from perfbench import program
    from skypilot_tpu_torch.serve.generation_server import (
        GenerationScheduler, GenerationServer)
    cfg, eng = args['config'], args['engine']
    device = args.get('device', 'cuda')
    config, model, _ = program.build(cfg, args['seed'], device)
    sched = GenerationScheduler(
        config, model.params(), model=model,
        batch_slots=eng['batch_slots'], max_len=eng['max_len'],
        kv_block=eng['kv_block'], kv_blocks=eng.get('kv_blocks'),
        spec_tokens=eng['spec_tokens'],
        inflight_steps=eng['inflight_steps'],
        prefill_chunk=eng['prefill_chunk'], kv_dtype=eng['kv_dtype'],
        device=device)
    fault = args.get('fault')
    if fault:
        from perfbench import faults
        faults.plant(fault, sched)
    sched.start()
    server = GenerationServer(sched, host='127.0.0.1', port=0)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name='perfbench-http').start()
    sched.warm.wait()
    _reply({'port': server.port})
    prof = None
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd['op']
        if op == 'profile_start':
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if device == 'cuda'
                                       else ProfilerActivity.CPU])
            prof.start()
            _reply({'t': time.perf_counter()})
        elif op == 'profile_stop':
            t = time.perf_counter()
            prof.stop()
            prof.export_chrome_trace(cmd['path'])
            prof = None
            _reply({'t': t})
        elif op == 'peak':
            peak = (torch.cuda.max_memory_allocated()
                    if torch.cuda.is_available() and device == 'cuda' else 0)
            from perfbench import guard
            _reply({'memory_peak_bytes': int(peak),
                    'forbidden': guard.forbidden_loaded()})
        elif op == 'stop':
            break
    server.httpd.shutdown()
    sched.stop()
    _reply({'stopped': True})
    os._exit(0)


if __name__ == '__main__':
    main()
