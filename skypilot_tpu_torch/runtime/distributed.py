"""Process-group glue: turn the SKYTPU_* rank contract into one job.

Counterpart of ``skypilot_tpu/runtime/distributed.py``. It reads the same
contract that the on-host agent exports to every job process
(``SKYTPU_COORDINATOR_ADDR`` = host 0's ``ip:port``,
``SKYTPU_NUM_PROCESSES``, ``SKYTPU_PROCESS_ID``, and for a multi-slice
gang ``SKYTPU_NUM_SLICES`` / ``SKYTPU_SLICE_ID``); explicit arguments
override it.

The contract has one process per host, because JAX drives every local
chip from one process. PyTorch's idiom is one process per GPU, so a host
with ``local_devices`` GPUs runs that many workers (``train/run.py``
starts them), and worker ``local_index`` of process ``process_id`` is
global rank ``process_id * local_devices + local_index`` of a world of
``num_processes * local_devices`` ranks, ordered host-major (and so
slice-major). On the CPU a process is one rank.

The backend follows the device: NCCL for CUDA, gloo for the CPU.
``backend=`` names another for a caller that must (two ranks sharing one
card cannot use NCCL).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_COORDINATOR_ADDR = 'SKYTPU_COORDINATOR_ADDR'
ENV_NUM_PROCESSES = 'SKYTPU_NUM_PROCESSES'
ENV_PROCESS_ID = 'SKYTPU_PROCESS_ID'
ENV_NUM_SLICES = 'SKYTPU_NUM_SLICES'
ENV_SLICE_ID = 'SKYTPU_SLICE_ID'


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         device_type: str = 'cuda',
         local_devices: int = 1,
         local_index: int = 0,
         backend: Optional[str] = None,
         timeout_s: int = 300) -> bool:
    """Join the job's process group, from the contract unless the values
    are passed.

    Returns False, and builds no group, when the job is one rank (the
    contract absent or one process, with one local device): the port
    then runs as it does on one device. Returns True once the group is
    up; a second call is a no-op. With CUDA, the rank's device is
    ``cuda:local_index``.
    """
    if is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get(ENV_COORDINATOR_ADDR)
    if num_processes is None:
        raw = env.get(ENV_NUM_PROCESSES)
        num_processes = int(raw) if raw else 1
    if process_id is None:
        raw = env.get(ENV_PROCESS_ID)
        process_id = int(raw) if raw else None
    world = num_processes * local_devices
    if world <= 1:
        return False
    if not coordinator_address:
        raise ValueError(
            f'{world} ranks need a coordinator address: set '
            f'{ENV_COORDINATOR_ADDR} or pass coordinator_address')
    if process_id is None:
        if num_processes > 1:
            raise ValueError(
                f'{ENV_COORDINATOR_ADDR} is set but {ENV_PROCESS_ID} is '
                'missing: the rank contract is incomplete; jobs must run '
                'under the skypilot_tpu agent or set both explicitly.')
        process_id = 0
    if not 0 <= local_index < local_devices:
        raise ValueError(f'local_index {local_index} not in '
                         f'[0, {local_devices})')
    if device_type == 'cuda':
        torch.cuda.set_device(local_index)
    elif local_devices != 1:
        raise ValueError('on the CPU a process is one rank '
                         f'(local_devices={local_devices})')
    dist.init_process_group(
        backend or ('nccl' if device_type == 'cuda' else 'gloo'),
        init_method=f'tcp://{coordinator_address}',
        world_size=world,
        rank=process_id * local_devices + local_index,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def num_slices() -> int:
    """Number of slices ganged into this job (1 = single slice)."""
    return int(os.environ.get(ENV_NUM_SLICES) or 1)


def slice_id() -> int:
    """This host's slice index in a multi-slice gang (0 on one slice)."""
    return int(os.environ.get(ENV_SLICE_ID) or 0)


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
