"""Train state and train step for the port's Llama, on one device.

Counterpart of ``skypilot_tpu/train/step.py``: the same loss, the same
optimizer (clip_by_global_norm(1.0), then AdamW with b1 0.9, b2 0.95,
eps 1e-8, weight decay 0.1 on every leaf), the same gradient
accumulation and the same metrics. JAX donates the state to a jitted
step; here the step updates the parameters and the optimizer state in
place and returns a ``TrainState`` that holds the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.models.llama import LAYER_PARAMS, LlamaModel, Params

MAX_GRAD_NORM = 1.0
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits [B,S,V], targets [B,S]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def leaf_names(params: Params) -> List[str]:
    """Leaf paths of a parameter tree, named as the JAX pytree's
    ('embed', 'layers/wq', ...), in a fixed order."""
    names = [n for n in ('embed', 'final_norm', 'lm_head') if n in params]
    return names + [f'layers/{n}' for n in LAYER_PARAMS]


def get_leaf(tree: Params, name: str) -> Any:
    for part in name.split('/'):
        tree = tree[part]
    return tree


def tree_from_leaves(names: List[str], values: List[Any]) -> Params:
    tree: Params = {}
    for name, value in zip(names, values):
        *parents, last = name.split('/')
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value
    return tree


@dataclasses.dataclass
class TrainState:
    """step, the parameter tree (leaves that require grad) and the AdamW
    optimizer over those leaves (its moments are the JAX ``opt_state``)."""
    step: int
    params: Params
    opt_state: torch.optim.Optimizer

    def to_tree(self) -> Dict[str, Any]:
        """The state as a nested dict named after the JAX tree: step,
        params, and opt_state {count, mu, nu} (the AdamW moments, zeros
        before the first update)."""
        names = leaf_names(self.params)
        leaves = [get_leaf(self.params, n) for n in names]
        opt = [self.opt_state.state.get(p, {}) for p in leaves]
        count = int(opt[0]['step']) if opt[0] else 0
        return {
            'step': int(self.step),
            'params': tree_from_leaves(names, [p.detach() for p in leaves]),
            'opt_state': {
                'count': count,
                'mu': tree_from_leaves(names, [
                    s['exp_avg'] if s else torch.zeros_like(p.detach())
                    for s, p in zip(opt, leaves)]),
                'nu': tree_from_leaves(names, [
                    s['exp_avg_sq'] if s else torch.zeros_like(p.detach())
                    for s, p in zip(opt, leaves)]),
            },
        }

    @torch.no_grad()
    def load_tree(self, tree: Dict[str, Any]) -> 'TrainState':
        """Copy a ``to_tree`` dict into this state's tensors in place."""
        names = leaf_names(self.params)
        if leaf_names(tree['params']) != names:
            raise ValueError('checkpoint parameter tree differs from the '
                             'model\'s')
        count = int(tree['opt_state']['count'])
        for name in names:
            p = get_leaf(self.params, name)
            src = get_leaf(tree['params'], name)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f'{name}: checkpoint shape '
                                 f'{tuple(src.shape)} != {tuple(p.shape)}')
            p.copy_(src)
            self.opt_state.state.pop(p, None)
            if count:
                self.opt_state.state[p] = {
                    'step': torch.tensor(float(count), dtype=torch.float32),
                    'exp_avg': get_leaf(tree['opt_state']['mu'], name).to(
                        device=p.device, dtype=p.dtype),
                    'exp_avg_sq': get_leaf(tree['opt_state']['nu'],
                                           name).to(device=p.device,
                                                    dtype=p.dtype),
                }
        self.step = int(tree['step'])
        return self


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class Trainer:
    """Init and train-step functions for a model, as the JAX ``Trainer``
    builds them (without a mesh: one device)."""

    def __init__(self, model: LlamaModel, learning_rate: float = 3e-4,
                 accum_steps: int = 1,
                 accum_dtype: torch.dtype = torch.float32):
        self.model = model
        self.learning_rate = learning_rate
        # Gradient accumulation: the batch is split into `accum_steps`
        # microbatches whose grads are averaged (in accum_dtype) before
        # one optimizer update.
        if accum_steps < 1:
            raise ValueError(f'accum_steps must be >= 1, got {accum_steps}')
        self.accum_steps = accum_steps
        self.accum_dtype = accum_dtype

    # -- public API ---------------------------------------------------------
    def state_from_params(self, params: Params) -> TrainState:
        """A fresh TrainState over ``params``. The state's leaves share
        storage with the given tensors (a model's own parameters stay
        ``requires_grad=False`` for serving; the state's leaves require
        grad) and the optimizer starts empty, as ``optax.adamw.init``."""
        names = leaf_names(params)
        leaves = [get_leaf(params, n).detach().requires_grad_(True)
                  for n in names]
        opt = torch.optim.AdamW(leaves, lr=self.learning_rate,
                                betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                                weight_decay=WEIGHT_DECAY)
        return TrainState(step=0, params=tree_from_leaves(names, leaves),
                          opt_state=opt)

    def init_fn(self) -> Callable[[torch.Generator], TrainState]:
        """init(generator) -> TrainState: random weights drawn on the
        model's device (``LlamaModel.init``), fresh optimizer state."""
        return lambda generator: self.state_from_params(
            self.model.init(generator))

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        logits, aux = self.model.apply_with_aux(params, batch['tokens'])
        loss = cross_entropy_loss(logits, batch['targets'],
                                  batch.get('mask'))
        # MoE router load-balance loss (0 weight for dense models).
        return loss + self.model.aux_loss_weight * aux

    def grads(self, params: Params, batch: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, grads in ``leaf_names`` order), averaged over
        ``accum_steps`` microbatches."""
        leaves = [get_leaf(params, n) for n in leaf_names(params)]
        accum = self.accum_steps
        if accum == 1:
            loss = self.loss_fn(params, batch)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        rows = batch['tokens'].shape[0]
        if rows % accum:
            raise ValueError(f'batch {rows} not divisible by accum_steps '
                             f'{accum}')
        micro = rows // accum
        acc = [torch.zeros(p.shape, dtype=self.accum_dtype, device=p.device)
               for p in leaves]
        losses = []
        for i in range(accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            loss = self.loss_fn(params, mb)
            for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                a.add_((g.float() / accum).to(self.accum_dtype))
            losses.append(loss.detach())
        grads = [a.to(p.dtype) for a, p in zip(acc, leaves)]
        return torch.stack(losses).mean(), grads

    def step_fn(self) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            loss, grads = self.grads(state.params, batch)
            norm = global_norm(grads)
            # optax.clip_by_global_norm: unchanged below the limit, else
            # g / norm * limit (no epsilon added to the norm).
            divisor = torch.where(norm < MAX_GRAD_NORM,
                                  torch.ones_like(norm),
                                  norm / MAX_GRAD_NORM)
            leaves = [get_leaf(state.params, n)
                      for n in leaf_names(state.params)]
            for p, g in zip(leaves, grads):
                p.grad = g.div_(divisor.to(g.dtype))
            state.opt_state.step()
            state.opt_state.zero_grad(set_to_none=True)
            metrics = {'loss': loss, 'grad_norm': norm, 'step': state.step}
            return TrainState(step=state.step + 1, params=state.params,
                              opt_state=state.opt_state), metrics

        return step

    def restore_or_init(self, ckpt_mgr, generator: torch.Generator
                        ) -> TrainState:
        """Resume from the latest checkpoint if one exists, else fresh
        init. The restore target is a fresh init, filled in place."""
        state = self.init_fn()(generator)
        if ckpt_mgr.latest_step() is None:
            return state
        return ckpt_mgr.restore(state)

    def shard_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """One device: the batch as it is (it is made on the device)."""
        return batch
