"""Train-state checkpointing (save / resume) in the port's own format.

Counterpart of ``skypilot_tpu/train/checkpoint.py``, with the same
manager surface (``latest_step``, ``save``, ``restore``, ``wait``,
``close``, ``max_to_keep``, ``save_interval_steps``). The JAX package
writes orbax checkpoints; the port writes one directory per step. Names
follow the JAX tree (step, params/..., opt_state/{count, mu, nu}/...).

- One device: ``<directory>/<step>/state.pt``, a ``torch.save`` of
  ``TrainState.to_tree()``. ``save`` returns once the state is copied to
  the host; the write runs on a background thread until ``wait``.
- A mesh of more than one rank: each rank writes the slices it is the
  first holder of (``shards-<rank>.pt``), and rank 0 an ``index.json``
  (each leaf's shape, which rank holds which global slice of it, the
  mesh). The save is synchronous: the ranks
  meet at a barrier before rank 0 renames the step into place and again
  after it.

Either way the step is written under a temporary name and renamed, so a
reader never sees half a checkpoint. ``restore`` into a state on the same
mesh reads its own slices; ``read`` (one device, or the replica's
``--ckpt-dir``) and a restore on another mesh assemble the leaves from
the slices they need.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.utils.tree import flatten, unflatten

STATE_FILE = 'state.pt'
INDEX_FILE = 'index.json'
_MOMENT_PREFIXES = ('params/', 'opt_state/mu/', 'opt_state/nu/')


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    return tree


def _leaf_of(key: str) -> str:
    """'opt_state/mu/layers/wq' -> 'layers/wq'."""
    for prefix in _MOMENT_PREFIXES:
        if key.startswith(prefix):
            return key[len(prefix):]
    raise KeyError(key)


def _shard_file(rank: int) -> str:
    return f'shards-{rank:05d}.pt'


Region = Tuple[slice, ...]


class CheckpointManager:
    """Saves and restores ``TrainState``s under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint on disk, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and any(
                          os.path.exists(os.path.join(self.directory, name, f))
                          for f in (STATE_FILE, INDEX_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending)
        return max(steps) if steps else None

    def save(self, state: Any, step: Optional[int] = None,
             force: bool = False) -> bool:
        """Persist ``state`` (a TrainState). ``step`` defaults to
        ``state.step``. Unless ``force``, the first save into an empty
        directory is written whatever its step, and after it only steps
        that are a multiple of ``save_interval_steps`` and newer than the
        latest saved step (orbax's default policy: the initial save and
        the fixed interval). Returns whether a save started."""
        if step is None:
            step = int(state.step)
        if not force:
            latest = self.latest_step()
            if latest is not None and (step % self.save_interval_steps
                                       or step <= latest):
                return False
        self.wait()
        if state.mesh is not None:
            self._save_sharded(state, step)
            return True
        tree = _to_host(state.to_tree())
        self._pending = step
        self._thread = threading.Thread(target=self._write,
                                        args=(step, tree), daemon=True)
        self._thread.start()
        return True

    def _write(self, step: int, tree: Dict[str, Any]) -> None:
        try:
            tmp = os.path.join(self.directory, f'.{step}.tmp-{os.getpid()}')
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(tree, os.path.join(tmp, STATE_FILE))
            self._commit(tmp, step)
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self._error = e

    def _commit(self, tmp: str, step: int) -> None:
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:  # None keeps every step, as orbax
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def _save_sharded(self, state: Any, step: int) -> None:
        import torch.distributed as dist
        from skypilot_tpu_torch.parallel.sharding import (dim_slices,
                                                          owns_slice)
        mesh, specs = state.mesh, state.specs
        flat = flatten(state.to_tree())
        tensors = {k: v for k, v in flat.items()
                   if isinstance(v, torch.Tensor)}
        tmp = os.path.join(self.directory, f'.{step}.tmp')
        if mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        dist.barrier()
        mine = {k: v.detach().cpu() for k, v in tensors.items()
                if owns_slice(specs[_leaf_of(k)], mesh)}
        torch.save(mine, os.path.join(tmp, _shard_file(mesh.rank)))
        if mesh.rank == 0:
            leaves = {}
            for key, local in tensors.items():
                spec = specs[_leaf_of(key)]
                shape = [n * mesh.size(spec[d]) if d < len(spec) else n
                         for d, n in enumerate(local.shape)]
                pieces = []
                for r in range(mesh.num_devices):
                    coords = mesh.coords_of(r)
                    if owns_slice(spec, mesh, coords):
                        pieces.append([r, [[s.start, s.stop] for s in
                                           dim_slices(shape, spec, mesh,
                                                      coords)]])
                leaves[key] = {'shape': shape, 'pieces': pieces}
            index = {'step': flat['step'],
                     'count': flat['opt_state/count'],
                     'world': mesh.num_devices, 'mesh': mesh.shape,
                     'leaves': leaves}
            with open(os.path.join(tmp, INDEX_FILE), 'w') as f:
                json.dump(index, f)
        dist.barrier()
        if mesh.rank == 0:
            self._commit(tmp, step)
        dist.barrier()

    def _step_dir(self, step: Optional[int]) -> str:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoint under {self.directory}')
        return os.path.join(self.directory, str(step))

    def _read(self, step: Optional[int],
              region: Callable[[str, Sequence[int]], Optional[Region]]
              ) -> Dict[str, Any]:
        """The saved tree of ``step``, each tensor cut to
        ``region(key, full_shape)`` (None: whole), on the CPU."""
        path = self._step_dir(step)
        if os.path.exists(os.path.join(path, STATE_FILE)):
            flat = flatten(torch.load(os.path.join(path, STATE_FILE),
                                       map_location='cpu',
                                       weights_only=True))
            for key, value in flat.items():
                if isinstance(value, torch.Tensor):
                    want = region(key, value.shape)
                    if want is not None:
                        flat[key] = value[want].clone()
            return unflatten(flat)
        with open(os.path.join(path, INDEX_FILE)) as f:
            index = json.load(f)
        files: Dict[int, Dict[str, torch.Tensor]] = {}

        def shard(rank: int) -> Dict[str, torch.Tensor]:
            if rank not in files:  # mapped, so only the slices read load
                files[rank] = torch.load(
                    os.path.join(path, _shard_file(rank)),
                    map_location='cpu', weights_only=True, mmap=True)
            return files[rank]

        flat = {'step': index['step'], 'opt_state/count': index['count']}
        for key, leaf in index['leaves'].items():
            shape = leaf['shape']
            want = region(key, shape) or tuple(slice(0, n) for n in shape)
            out, filled = None, 0
            for rank, bounds in leaf['pieces']:
                lo = [max(a, w.start) for (a, _), w in zip(bounds, want)]
                hi = [min(b, w.stop) for (_, b), w in zip(bounds, want)]
                if any(x >= y for x, y in zip(lo, hi)):
                    continue
                piece = shard(rank)[key]
                if out is None:
                    out = torch.empty([w.stop - w.start for w in want],
                                      dtype=piece.dtype)
                src = tuple(slice(x - a, y - a) for x, y, (a, _) in
                            zip(lo, hi, bounds))
                dst = tuple(slice(x - w.start, y - w.start) for x, y, w in
                            zip(lo, hi, want))
                out[dst] = piece[src]
                filled += out[dst].numel()
            if out is None or filled != out.numel():
                raise ValueError(f'checkpoint {path}: {key} is not covered '
                                 'by its slices')
            flat[key] = out
        return unflatten(flat)

    def read(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved tree of ``step`` (default: the latest), whole, on the
        CPU (sharded checkpoints assembled from their slices)."""
        return self._read(step, lambda key, shape: None)

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Copy the checkpoint of ``step`` (default: the latest) into
        ``target`` (a live TrainState) in place; returns it. A target on a
        mesh reads just its own slices of each leaf."""
        if target.mesh is None:
            return target.load_tree(self.read(step))
        from skypilot_tpu_torch.parallel.sharding import dim_slices

        def region(key: str, shape: Sequence[int]) -> Region:
            return dim_slices(shape, target.specs[_leaf_of(key)],
                              target.mesh)
        return target.load_tree(self._read(step, region))

    def wait(self) -> None:
        """Block until an in-flight save is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError('checkpoint write failed') from err

    def close(self) -> None:
        self.wait()
