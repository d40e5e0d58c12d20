"""Train state and train step for the port's Llama, on one device or a
mesh.

Counterpart of ``skypilot_tpu/train/step.py``: the same loss, the same
optimizer (clip_by_global_norm(1.0), then AdamW with b1 0.9, b2 0.95,
eps 1e-8, weight decay 0.1 on every leaf), the same gradient
accumulation and the same metrics. JAX donates the state to a jitted
step; here the step updates the parameters and the optimizer state in
place and returns a ``TrainState`` that holds the same tensors.

On a mesh (the model's) each rank holds its shards of the parameters and
of the AdamW moments and trains on its rows of the global batch
(``shard_batch``; microbatch-major when the batch is split into
microbatches, so that each is JAX's global one). What GSPMD did for the
JAX trainer is explicit: the loss is vocab-parallel and global
(``cross_entropy_loss``), each leaf's gradient is summed over the batch
axes that do not split it, and the clip's global norm counts every
element once. Loss and grad norm are
global, equal on every rank.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.models.llama import LlamaModel, Params
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import Mesh
from skypilot_tpu_torch.parallel.sharding import DEFAULT_RULES, LogicalRules
from skypilot_tpu_torch.utils.tree import unflatten

MAX_GRAD_NORM = 1.0
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.1


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       mesh: Optional[Mesh] = None,
                       rules: LogicalRules = DEFAULT_RULES) -> torch.Tensor:
    """Mean next-token cross entropy; logits [B,S,V], targets [B,S].

    On a mesh, logits are this rank's rows, sequence block and vocab
    shard [B/b, S/s, V/v] and targets its rows and block: the row max,
    the sum of exponentials and the target's logit are each all-reduced
    over the vocab axes in f32 (the function of ``log_softmax`` over the
    whole vocab; a target in another rank's shard adds 0 here), and the
    mean is over the global batch and sequence. The result is the global
    loss on every rank; its backward gives each rank the gradient of its
    own tokens (sum them over the batch and sequence axes)."""
    vocab_axes = () if mesh is None else mesh.live(rules.axes('vocab'))
    token_axes = () if mesh is None else token_axes_of(mesh, rules)
    if not vocab_axes and not token_axes:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
        if mask is None:
            return nll.mean()
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    x = logits.float()
    top = sharding.all_reduce(x.detach().amax(-1, keepdim=True), mesh,
                              vocab_axes, op=torch.distributed.ReduceOp.MAX)
    z = x - top
    lse = sharding.reduce_from(z.exp().sum(-1), mesh, vocab_axes).log()
    v_local = x.shape[-1]
    idx = targets.long() - mesh.index(vocab_axes) * v_local
    ok = (idx >= 0) & (idx < v_local)
    picked = z.gather(-1, idx.clamp(0, v_local - 1)[..., None])[..., 0]
    picked = sharding.reduce_from(
        torch.where(ok, picked, torch.zeros((), device=x.device)), mesh,
        vocab_axes)
    nll = lse - picked
    if mask is None:
        total = nll.sum()
        count = torch.tensor(float(nll.numel() * mesh.size(token_axes)),
                             device=x.device)
    else:
        mask = mask.float()
        total = (nll * mask).sum()
        count = sharding.all_reduce(mask.sum(), mesh,
                                    token_axes).clamp(min=1.0)
    return sharding.reduce_from(total / count, mesh, token_axes)


def token_axes_of(mesh: Mesh, rules: LogicalRules) -> Tuple[str, ...]:
    """The live mesh axes that split the tokens of a batch: the batch
    axes and the sequence axes, in ``MESH_AXES`` order."""
    return sharding.token_axes(mesh, rules.axes('batch'), rules.axes('seq'))


def leaf_names(params: Params) -> List[str]:
    """Leaf paths of a parameter tree, named as the JAX pytree's
    ('embed', 'layers/wq', ...): the top-level leaves, then the layer
    leaves in the tree's order (the model's)."""
    names = [n for n in ('embed', 'final_norm', 'lm_head') if n in params]
    return names + [f'layers/{n}' for n in params['layers']]


def get_leaf(tree: Params, name: str) -> Any:
    for part in name.split('/'):
        tree = tree[part]
    return tree


def tree_from_leaves(names: List[str], values: List[Any]) -> Params:
    return unflatten(dict(zip(names, values)))


@dataclasses.dataclass
class TrainState:
    """step, the parameter tree (leaves that require grad) and the AdamW
    optimizer over those leaves (its moments are the JAX ``opt_state``).
    On a mesh the leaves and moments are this rank's shards, laid out by
    ``specs`` (leaf name -> spec) over ``mesh``."""
    step: int
    params: Params
    opt_state: torch.optim.Optimizer
    mesh: Optional[Mesh] = None
    specs: Dict[str, Any] = dataclasses.field(default_factory=dict)

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
    builds them, on one device or on the model's mesh."""

    def __init__(self, model: LlamaModel, learning_rate: float = 3e-4,
                 accum_steps: int = 1,
                 accum_dtype: torch.dtype = torch.float32):
        self.model = model
        self.mesh = model.mesh
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
                          opt_state=opt, mesh=self.mesh,
                          specs=self.model.specs)

    def init_fn(self) -> Callable[[torch.Generator], TrainState]:
        """init(generator) -> TrainState: random weights drawn on the
        model's device (``LlamaModel.init``), fresh optimizer state."""
        return lambda generator: self.state_from_params(
            self.model.init(generator))

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        logits, aux = self.model.apply_with_aux(params, batch['tokens'])
        loss = cross_entropy_loss(logits, batch['targets'],
                                  batch.get('mask'), self.mesh,
                                  self.model.rules)
        # MoE router load-balance loss (0 weight for dense models).
        return loss + self.model.aux_loss_weight * aux

    def grads(self, params: Params, batch: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, grads in ``leaf_names`` order), averaged over
        ``accum_steps`` microbatches (of this rank's rows, on a mesh)."""
        names = leaf_names(params)
        leaves = [get_leaf(params, n) for n in names]
        accum = self.accum_steps
        if accum == 1:
            loss = self.loss_fn(params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            return loss.detach(), self._sum_over_batch(names, grads)
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
        return torch.stack(losses).mean(), self._sum_over_batch(names, grads)

    def _sum_over_batch(self, names: List[str], grads: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Each leaf's gradient summed over the batch and sequence axes
        that do not split the leaf (the split ones summed in the gather's
        backward), so every rank holds the global gradient of its shard.
        Weights are replicated over sp, each rank's tokens adding to them
        (GSPMD's sum for JAX); pp and ep split no tokens and are not
        summed (an expert's gradient is whole on the ep rank holding it,
        the router's on every ep rank: ``ops/moe.py``)."""
        if self.mesh is None:
            return grads
        tokens = token_axes_of(self.mesh, self.model.rules)
        for name, g in zip(names, grads):
            split = set(sharding.spec_axes(self.model.specs[name]))
            sharding.all_reduce(g, self.mesh,
                                tuple(a for a in tokens if a not in split))
        return grads

    def _global_norm(self, names: List[str], grads: List[torch.Tensor]
                     ) -> torch.Tensor:
        """The global norm in f32, each element counted once: the squares
        of a leaf's shard are summed over the axes that split it and not
        over those it is replicated on."""
        if self.mesh is None:
            return global_norm(grads)
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for name, g in zip(names, grads):
            axes = self.mesh.live(sharding.spec_axes(self.model.specs[name]))
            by_axes.setdefault(axes, []).append(
                torch.linalg.vector_norm(g, dtype=torch.float32).square())
        total = [sharding.all_reduce(torch.stack(sq).sum(), self.mesh, axes)
                 for axes, sq in by_axes.items()]
        return torch.stack(total).sum().sqrt()

    def step_fn(self) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
        def step(state: TrainState, batch: Dict[str, torch.Tensor]):
            loss, grads = self.grads(state.params, batch)
            norm = self._global_norm(leaf_names(state.params), grads)
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
            return dataclasses.replace(state, step=state.step + 1), metrics

        return step

    def warm_cache_key(self) -> str:
        """Cache key for the warm-init snapshot: everything that changes
        the init result or its shapes (model config and class,
        accumulation, device type, the world's size, torch version)."""
        from skypilot_tpu_torch.runtime import distributed
        payload = json.dumps({
            'config': {k: str(v) for k, v in
                       dataclasses.asdict(self.model.config).items()},
            'model': type(self.model).__name__,
            'accum_steps': self.accum_steps,
            'device': self.model.device.type,
            'n_devices': distributed.world_size(),
            'torch': torch.__version__,
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def init_with_warm_cache(self, cache_dir: str,
                             generator: torch.Generator
                             ) -> Tuple[TrainState, str]:
        """Init through a persisted snapshot when one matches the key:
        a restore copies the saved state into the model's tensors and
        skips the init. On a miss, init normally and write the snapshot
        (``train/checkpoint.py``: a temp name renamed into place); a
        failed write is printed, not raised. Returns (state,
        'restored' | 'initialized'). One device only, as in JAX."""
        from skypilot_tpu_torch.train.checkpoint import CheckpointManager
        path = os.path.join(os.path.expanduser(cache_dir),
                            self.warm_cache_key())
        if os.path.isdir(path):
            mgr = CheckpointManager(path)
            if mgr.latest_step() is not None:
                target = self.state_from_params(self.model.params())
                return mgr.restore(target), 'restored'
        state = self.init_fn()(generator)
        try:
            mgr = CheckpointManager(path, max_to_keep=1)
            mgr.save(state, force=True)
            mgr.wait()
        except (OSError, RuntimeError) as e:  # the cache is best-effort
            print(f'[train] warm-init cache save failed: {e}', flush=True)
        return state, 'initialized'

    def restore_or_init(self, ckpt_mgr, generator: torch.Generator
                        ) -> TrainState:
        """Resume from the latest checkpoint if one exists, else fresh
        init. The restore target is a fresh init, filled in place."""
        state = self.init_fn()(generator)
        if ckpt_mgr.latest_step() is None:
            return state
        return ckpt_mgr.restore(state)

    def microbatches(self) -> int:
        """The global batch's microbatches, each routed as a whole: the
        accumulation steps, times the pipeline's microbatches under pp
        (JAX splits the global batch, not a rank's rows)."""
        groups = self.accum_steps
        if self.mesh is not None and self.mesh.shape['pp'] > 1:
            groups *= (self.model.config.pp_microbatches
                       or self.mesh.shape['pp'])
        return groups

    def row_index(self, rows: int) -> torch.Tensor:
        """The global rows this rank holds of a batch of ``rows``: its
        block of each microbatch (``microbatches``), microbatch-major, so
        that its i-th chunk is its part of the global microbatch i. One
        contiguous block when the batch is one microbatch."""
        axes = self.mesh.live(self.model.rules.axes('batch'))
        n, i = self.mesh.size(axes), self.mesh.index(axes)
        groups = self.microbatches()
        if rows % (n * groups):
            raise ValueError(f'global batch {rows} not divisible by {n} '
                             f'batch shards {axes} x {groups} microbatches')
        return torch.arange(rows).view(groups, n, -1)[:, i].reshape(-1)

    def shard_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows ('batch' -> the rules' batch axes;
        ``row_index``) and sequence block ('seq' -> the sequence axes) of
        the global batch; the batch as it is on one device. Targets are
        shifted on the whole sequence before (``train/run.py``), so a
        block's last target is the next block's first token."""
        if self.mesh is None:
            return batch
        out = dict(batch)
        axes = self.mesh.live(self.model.rules.axes('batch'))
        if axes:
            rows = next(iter(out.values())).shape[0]
            index = self.row_index(rows)
            out = {key: value.index_select(0, index.to(value.device))
                   for key, value in out.items()}
        axes = self.mesh.live(self.model.rules.axes('seq'))
        n, i = self.mesh.size(axes), self.mesh.index(axes)
        for key, value in out.items():
            if value.shape[1] % n:
                raise ValueError(f'global seq {value.shape[1]} not '
                                 f'divisible by {n} seq shards {axes}')
            size = value.shape[1] // n
            out[key] = value.narrow(1, i * size, size)
        return out
