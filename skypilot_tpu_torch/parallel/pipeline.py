"""GPipe pipeline parallelism over the ``pp`` mesh axis.

Counterpart of ``skypilot_tpu/parallel/pipeline.py``. Each rank of
``pp`` holds one *stage*: a contiguous block of the stacked layers (its
``[L/S, ...]`` shard of every layer leaf). The batch is split into ``M``
microbatches that flow stage to stage over ``T = M + S - 1`` ticks:
stage 0 takes microbatch t at tick t, stage s works on microbatch
t - s while t is in [s, s + M) and passes its output to stage s + 1;
the last stage's outputs, summed over ``pp`` (every other stage adds
zeros), are the result on every rank.

JAX runs the schedule as a ``scan`` under ``shard_map`` and lets autodiff
transpose it; every stage computes on every tick (zeros when idle) so
that the graph is static. Eager PyTorch has no static graph to keep, so
a stage skips its idle ticks (the same function) and the schedule is one
``torch.autograd.Function`` whose backward runs the reverse schedule
itself: each live tick's stage graph is kept from the forward, and the
backward walks the ticks last to first, takes the gradient of each
tick's output (from the caller on the last stage, from stage s + 1
otherwise), runs that tick's graph back to its input and the stage's
parameters, and sends the input's gradient to stage s - 1. So every rank
makes the same exchanges in the same order, forward and backward, which
autograd's own graph order would not promise across stages. An exchange
moves a tensor only where the schedule has one to move
(``sharding.send_recv``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import Mesh
from skypilot_tpu_torch.utils.tree import flatten, unflatten


def split_stages(params: Any, num_stages: int) -> Any:
    """Layer-stacked leaves [L, ...] -> stage-major [S, L/S, ...] (the
    layout JAX's ``pipeline`` takes; a ``pp`` rank's own stage is its
    ``[L/S, ...]`` shard)."""
    if isinstance(params, dict):
        return {k: split_stages(v, num_stages) for k, v in params.items()}
    if params.shape[0] % num_stages:
        raise ValueError(f'layer dim {params.shape[0]} not divisible by '
                         f'{num_stages} stages')
    return params.reshape(num_stages, params.shape[0] // num_stages,
                          *params.shape[1:])


class _Schedule:
    """What the pipeline's autograd function needs besides its tensors."""

    def __init__(self, stage_fn, names, broadcast, mesh, axes, micro,
                 with_aux):
        self.stage_fn = stage_fn
        self.names = names
        self.broadcast = broadcast
        self.mesh = mesh
        self.axes = axes
        self.micro = micro
        self.with_aux = with_aux
        self.stages = mesh.size(axes)
        self.stage = mesh.index(axes)

    def live(self, stage: int, t: int) -> bool:
        return stage <= t < stage + self.micro

    def run(self, params: List[torch.Tensor], h: torch.Tensor):
        res = self.stage_fn(unflatten(dict(zip(self.names, params))), h,
                            *self.broadcast)
        return res if self.with_aux else (res, None)


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sched: _Schedule, x: torch.Tensor, *params):
        s, S, M = sched.stage, sched.stages, sched.micro
        mb = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        keep = any(ctx.needs_input_grad)
        ticks: Dict[int, Any] = {}
        outs = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        recv = None
        for t in range(M + S - 1):
            out = None
            if sched.live(s, t):
                inp = mb[t] if s == 0 else recv
                if keep:
                    inp = inp.detach().requires_grad_(True)
                with torch.set_grad_enabled(keep):
                    out, a = sched.run(list(params), inp)
                if a is not None:
                    aux = aux + a.detach().float()
                if keep:
                    ticks[t] = (inp, out, a)
                if s == S - 1:
                    outs.append(out.detach())
            if S > 1 and t < M + S - 2:  # s's output feeds s + 1's next tick
                recv = sharding.send_recv(
                    out.detach() if out is not None else mb[0],
                    sched.mesh, sched.axes, s + 1, s - 1,
                    send=out is not None and s < S - 1,
                    receive=s > 0 and sched.live(s - 1, t))
        result = (torch.cat(outs) if outs else torch.zeros_like(x))
        sharding.all_reduce(result, sched.mesh, sched.axes)
        ctx.sched, ctx.ticks, ctx.params = sched, ticks, params
        return result, sharding.all_reduce(aux, sched.mesh, sched.axes) / M

    @staticmethod
    def backward(ctx, g_result, g_aux):
        sched, ticks, params = ctx.sched, ctx.ticks, ctx.params
        ctx.ticks = ctx.params = None
        s, S, M = sched.stage, sched.stages, sched.micro
        g_mb = g_result.reshape(M, g_result.shape[0] // M,
                                *g_result.shape[1:])
        g_params: List[Optional[torch.Tensor]] = [None] * len(params)
        g_x = [None] * M
        recv = None
        for t in reversed(range(M + S - 1)):
            g_in = None
            if sched.live(s, t):
                inp, out, a = ticks.pop(t)
                outputs = [out]
                grads = [g_mb[t - s] if s == S - 1 else recv]
                if a is not None and a.requires_grad:
                    outputs.append(a)
                    grads.append((g_aux / M).to(a.dtype))
                wanted = [inp] + [p for p in params if p.requires_grad]
                got = list(torch.autograd.grad(outputs, wanted, grads,
                                               allow_unused=True))
                g_in = got.pop(0)
                it = iter(got)
                for j, p in enumerate(params):
                    if not p.requires_grad:
                        continue
                    g = next(it)
                    if g is not None:
                        g_params[j] = g if g_params[j] is None \
                            else g_params[j] + g
                if s == 0:
                    g_x[t] = g_in
            if S > 1 and t > 0:  # s + 1's tick-t input: s's tick t - 1 output
                recv = sharding.send_recv(
                    g_in if g_in is not None else g_mb[0],
                    sched.mesh, sched.axes, s - 1, s + 1,
                    send=g_in is not None and s > 0,
                    receive=s < S - 1 and sched.live(s + 1, t))
        if s == 0:
            dx = torch.cat([g.to(g_result.dtype) for g in g_x])
        else:
            dx = torch.zeros_like(g_result)
        g_params = [torch.zeros_like(p) if g is None and p.requires_grad
                    else g for g, p in zip(g_params, params)]
        return (None, dx, *g_params)


def pipeline(stage_fn: Callable[..., Any], stage_params: Any,
             x: torch.Tensor, *broadcast: Any, mesh: Mesh,
             axis: str = 'pp', num_microbatches: Optional[int] = None,
             with_aux: bool = False) -> Any:
    """Run ``x`` through the ``S`` pipeline stages of ``stage_fn``.

    ``stage_fn(local_params, h, *broadcast) -> h`` (or ``(h, aux)`` with
    ``with_aux``; aux a scalar tensor) is one stage; ``stage_params`` is this
    rank's stage, a dict tree of its ``[L/S, ...]`` leaves (on a ``pp``
    mesh, the local shards; ``split_stages(...)[stage]`` of the whole
    stack).
    ``x`` [B, ...] is split into ``num_microbatches`` (default ``S``).
    Returns [B, ...] outputs, and with ``with_aux`` the aux summed over
    the stages' live ticks and divided by M, both the same on every rank
    of ``axis``.

    ``x`` enters stage 0 only: a caller whose ``x`` is replicated over
    ``axis`` passes it through ``sharding.copy_to`` first, so that every
    rank gets its whole gradient. The output's backward is the identity
    (``reduce_from``'s): every rank must hold the whole gradient."""
    axes = mesh.live(axis)
    S = mesh.size(axes)
    M = num_microbatches or S
    if x.shape[0] % M:
        raise ValueError(f'batch {x.shape[0]} not divisible by {M} '
                         'microbatches')
    flat = flatten(stage_params)
    names = list(flat)
    sched = _Schedule(stage_fn, names, broadcast, mesh, axes, M, with_aux)
    out, aux = _Pipeline.apply(sched, x, *flat.values())
    return (out, aux) if with_aux else out
