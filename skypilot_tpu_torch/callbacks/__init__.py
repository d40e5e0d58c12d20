"""skytpu_callback: in-task step timing for the benchmark tool.

The port's own copy of ``skypilot_tpu/callbacks/__init__.py`` (which
imports no JAX; the port imports nothing of the JAX package), with the
same file format, so the benchmark tool reads a port trainer's summary
unchanged. User training code (or ``train.run``) calls:

    import skypilot_tpu_torch.callbacks as skytpu_callback
    skytpu_callback.init(total_steps=1000)
    for batch in data:
        with skytpu_callback.step():
            train_step(batch)

Every ``_SUMMARY_EVERY`` steps a JSON summary lands in
``$SKYTPU_BENCHMARK_LOG_DIR/benchmark_summary.json`` (the benchmark tool
sets the env; without it the callback is a no-op so the same code runs
outside benchmarks). The benchmark harness fetches the file from the
cluster and derives seconds/step and $/step.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

SUMMARY_FILE = 'benchmark_summary.json'
_SUMMARY_EVERY = 10

_state: Optional[dict] = None


def init(total_steps: Optional[int] = None,
         log_dir: Optional[str] = None) -> bool:
    """Arm the callback; returns False (no-op mode) outside a benchmark."""
    global _state
    log_dir = log_dir or os.environ.get('SKYTPU_BENCHMARK_LOG_DIR')
    if not log_dir:
        _state = None
        return False
    os.makedirs(log_dir, exist_ok=True)
    _state = {
        'log_dir': log_dir,
        'total_steps': total_steps,
        'num_steps': 0,
        'start_ts': time.time(),
        'first_step_end_ts': None,
        'last_step_ts': None,
    }
    _write()
    return True


def _write() -> None:
    assert _state is not None
    path = os.path.join(_state['log_dir'], SUMMARY_FILE)
    tmp = path + '.tmp'
    summary = {k: v for k, v in _state.items() if k != 'log_dir'}
    if _state['num_steps'] > 1:
        # Steady-state rate: interval from END of step 1 to END of step N
        # spans exactly N-1 steps and excludes step-1 compile/warm-up
        # (which would otherwise skew $/step against slow-compiling
        # configs).
        summary['seconds_per_step'] = (
            (_state['last_step_ts'] - _state['first_step_end_ts'])
            / (_state['num_steps'] - 1))
    with open(tmp, 'w') as f:
        json.dump(summary, f)
    os.replace(tmp, path)


def mark(name: str) -> None:
    """Record a named phase timestamp (e.g. 'proc_start', 'jax_ready',
    'init_done') into the summary — the launch-overhead decomposition the
    bench reads (submit -> control plane -> runtime startup -> param init
    -> first-step compile)."""
    if _state is None:
        return
    _state.setdefault('marks', {})[name] = time.time()
    _write()


def step_begin() -> None:
    pass  # kept for API symmetry; timing anchors on step ends


def step_end() -> None:
    if _state is None:
        return
    _state['num_steps'] += 1
    _state['last_step_ts'] = time.time()
    if _state['first_step_end_ts'] is None:
        _state['first_step_end_ts'] = _state['last_step_ts']
    if _state['num_steps'] % _SUMMARY_EVERY == 0 or \
            _state['num_steps'] == _state.get('total_steps'):
        _write()


@contextlib.contextmanager
def step() -> Iterator[None]:
    step_begin()
    try:
        yield
    finally:
        step_end()
