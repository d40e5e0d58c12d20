"""Train-state checkpointing (save / resume) in the port's own format.

Counterpart of ``skypilot_tpu/train/checkpoint.py``, with the same
manager surface (``latest_step``, ``save``, ``restore``, ``wait``,
``close``, ``max_to_keep``, ``save_interval_steps``). The JAX package
writes orbax checkpoints; the port writes one directory per step,
``<directory>/<step>/state.pt``: a ``torch.save`` of
``TrainState.to_tree()``, whose names follow the JAX tree (step,
params/..., opt_state/{count, mu, nu}/...). A step is written under a
temporary name and renamed into place, so a reader never sees half a
checkpoint. ``save`` returns once the state is copied to the host; the
write to disk runs on a background thread until ``wait``.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = 'state.pt'


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    return tree


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
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending)
        return max(steps) if steps else None

    def save(self, state: Any, step: Optional[int] = None,
             force: bool = False) -> bool:
        """Persist ``state`` (a TrainState). ``step`` defaults to
        ``state.step``. Unless ``force``, only steps that are a multiple
        of ``save_interval_steps`` and newer than the latest saved step
        are written. Returns whether a save started."""
        if step is None:
            step = int(state.step)
        if not force:
            latest = self.latest_step()
            if step % self.save_interval_steps or (
                    latest is not None and step <= latest):
                return False
        self.wait()
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
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            if self.max_to_keep:  # None keeps every step, as orbax
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self._error = e

    def read(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved tree of ``step`` (default: the latest), on the CPU."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoint under {self.directory}')
        return torch.load(os.path.join(self.directory, str(step),
                                       STATE_FILE),
                          map_location='cpu', weights_only=True)

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Copy the checkpoint of ``step`` (default: the latest) into
        ``target`` (a live TrainState) in place; returns it."""
        return target.load_tree(self.read(step))

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
