"""Training loop layer: train state, train step, checkpoints, and the
launchable trainer (``python -m skypilot_tpu_torch.train.run``).

Counterpart of ``skypilot_tpu/train/``, on one device.
"""
from skypilot_tpu_torch.train.checkpoint import CheckpointManager
from skypilot_tpu_torch.train.step import (Trainer, TrainState,
                                           cross_entropy_loss)

__all__ = ['CheckpointManager', 'Trainer', 'TrainState',
           'cross_entropy_loss']
