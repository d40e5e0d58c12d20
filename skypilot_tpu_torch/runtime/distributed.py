"""Process-group glue for the port's trainer: single process for now.

Counterpart of ``skypilot_tpu/runtime/distributed.py``. It reads the same
``SKYTPU_*`` rank contract that the on-host agent exports to every job
process. One process on one card needs no rendezvous, so ``init`` is a
no-op there; a contract asking for more than one process raises, because
multi-device training (``torch.distributed`` over the contract) is not
ported yet (ROADMAP.md queue 1, item 8).
"""
from __future__ import annotations

import os


def init() -> bool:
    """Returns False for a single-process run (contract absent or one
    process): nothing to set up. Raises for a multi-process contract."""
    raw = os.environ.get('SKYTPU_NUM_PROCESSES')
    num_processes = int(raw) if raw else 1
    if os.environ.get('SKYTPU_COORDINATOR_ADDR') and num_processes > 1:
        raise NotImplementedError(
            f'SKYTPU_NUM_PROCESSES={num_processes}: multi-process training '
            'is not yet ported to the PyTorch trainer (ROADMAP.md queue 1, '
            'item 8)')
    if num_slices() > 1:
        raise NotImplementedError(
            f'SKYTPU_NUM_SLICES={num_slices()}: multi-slice training is not '
            'yet ported to the PyTorch trainer (ROADMAP.md queue 1, item 8)')
    return False


def num_slices() -> int:
    """Number of slices ganged into this job (1 = single slice)."""
    return int(os.environ.get('SKYTPU_NUM_SLICES') or 1)


def shutdown() -> None:
    """Nothing to tear down for one process."""
