"""Mixture-of-Experts routing + expert FFN (PyTorch counterpart of
``skypilot_tpu/ops/moe.py``).

The same routing, bit for bit in which assignments are kept and where:

  1. router probs = softmax(x @ w_router) in f32             [N, E]
  2. top-k experts per token (ties to the lower expert index, as
     ``lax.top_k``), gates renormalised by max(sum, 1e-9)
  3. the queue position of each (choice, token) in its expert by a cumsum
     over the choice-major [k*N, E] one-hot: every choice-0 assignment
     outranks every choice-1
  4. assignments at position >= C are dropped and contribute zero; with
     ``capacity_factor`` >= E/k none can be.

The Switch load-balance loss is ``E * sum_e f_e * p_e / k``, f over all
k choices before any drop, p the mean router probability.

The JAX package builds dense [N, E, C] dispatch and combine tensors from
a [k, N, E, C] one-hot, so that every step is an MXU einsum. Here each
kept assignment gets its flat (expert, slot) index instead: the token
rows are copied into an [E, C, D] buffer, the experts run as three
``bmm``s, and each token gathers its rows back weighted by its gates. The
dispatch einsum adds one row to zeros and the combine einsum sums k
gated rows, so both forms compute the same values without the one-hot
(336 MB of f32 per layer at N 4096, C 1280) or its two products.

On a mesh (``MoeMesh``) the layer computes what GSPMD makes of the JAX
function, which is one program over the global batch:

- Routing is global. Each rank runs the router on its own tokens
  (replicated over ``ep`` and ``tp``), gathers the top-k expert ids of
  every token over the axes that split the tokens
  (``sharding.gather_tokens``), and runs the same cumsum over the
  choice-major [k*N, E] one-hot of the global batch, in global (b, s)
  order; it keeps its own tokens' slots. The capacity counts the global
  N; the routed fractions and the dropped fraction are global; the mean
  probabilities are summed over the token axes with ``reduce_from``,
  whose backward gives each rank the aux gradient of its own tokens
  (the trainer sums it over the token axes once).
- The experts are split over ``ep`` and their mlp dim over ``tp``.
  Tokens are replicated over ``ep`` (``ep`` splits no batch), so no
  token moves between ranks: ``h`` and the gates enter the expert region
  through ``copy_to`` over (ep, tp), each rank runs its E/ep experts on
  the [E/ep, C, D] rows that keep their global slots (another rank's
  slots stay zero), and its partial output leaves through one
  ``reduce_from`` over (ep, tp).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import MESH_AXES, Mesh


@dataclasses.dataclass(frozen=True)
class MoeMesh:
    """Where an MoE layer's tokens and experts live on a mesh: the live
    axes that split the batch rows and the sequence, and those that
    split the experts and their mlp dim."""
    mesh: Mesh
    batch_axes: Tuple[str, ...] = ()
    seq_axes: Tuple[str, ...] = ()
    expert_axes: Tuple[str, ...] = ()
    tp_axes: Tuple[str, ...] = ()

    @property
    def token_axes(self) -> Tuple[str, ...]:
        return sharding.token_axes(self.mesh, self.batch_axes,
                                   self.seq_axes)

    @property
    def region_axes(self) -> Tuple[str, ...]:
        """The axes an expert's partial output is summed over."""
        named = set(self.expert_axes) | set(self.tp_axes)
        return self.mesh.live(tuple(a for a in MESH_AXES
                                    if a in named))


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert queue length C, padded to a multiple of 8 (at least 8)."""
    cap = int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def _queue_positions(expert: torch.Tensor, num_experts: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each assignment's position in its expert's queue, the count of
    assignments per expert) for ``expert`` [k*N], choice-major: a cumsum
    over the [k*N, E] one-hot (int32)."""
    onehot = (expert[:, None] == torch.arange(
        num_experts, device=expert.device)).to(torch.int32)
    pos = (onehot.cumsum(0, dtype=torch.int32) - onehot).gather(
        1, expert[:, None])[:, 0]
    return pos.long(), onehot.sum(0)


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                  on: Optional[MoeMesh] = None,
                  local_shape: Optional[Tuple[int, int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Route N tokens to their top-k experts' capacity slots.

    Args:
      router_logits: [N, E].
      top_k: experts per token.
      capacity: per-expert queue length C.
      on: with a mesh, the N tokens are this rank's block ``local_shape``
        (rows, sequence) of the global batch, which is routed as one
        (see the module docstring); C must count the global tokens.

    Returns:
      dest: [k, N] int64, ``e * C + c`` when choice k of token n holds
        slot c of expert e, ``E * C`` when it was dropped. The JAX
        ``dispatch[n, e, c]`` is the count of k with ``dest[k, n] == e * C
        + c``.
      weights: [k, N] f32, the renormalised gate of each kept assignment,
        0 where dropped (the JAX ``combine`` at the same places).
      aux: dict with 'aux_loss' (load balance) and 'dropped_frac', both
        of the global batch.
    """
    n, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    # A stable descending sort puts equal probabilities in index order,
    # as lax.top_k does; torch.topk promises no order among ties.
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[:, :top_k]       # [N, k]
    gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    expert = gate_idx.T.reshape(-1)                 # [k*N], choice-major
    sum_probs = probs.sum(0)                        # [E]
    if on is None or not on.token_axes:
        pos, routed = _queue_positions(expert, e)
        n_all, kept = n, None
    else:
        # Every token's choices in global (b, s) order, the same cumsum,
        # then this rank's block of the positions.
        ids = sharding.gather_tokens(expert.view(top_k, *local_shape),
                                     on.mesh, on.batch_axes, on.seq_axes)
        pos_all, routed = _queue_positions(ids.reshape(-1), e)
        n_all, kept = ids[0].numel(), (pos_all < capacity).sum()
        pos = sharding.own_tokens(pos_all.view(ids.shape), on.mesh,
                                  on.batch_axes, on.seq_axes).reshape(-1)
        sum_probs = sharding.reduce_from(sum_probs, on.mesh, on.token_axes)
    keep = pos < capacity
    dest = torch.where(keep, expert * capacity + pos,
                       torch.full_like(pos, e * capacity)).view(top_k, n)
    weights = gate_vals.T * keep.view(top_k, n)

    frac_routed = routed.float() / n_all            # [E], all k choices
    mean_prob = sum_probs / n_all                   # [E]
    aux_loss = e * torch.sum(frac_routed * mean_prob) / top_k
    kept = keep.sum() if kept is None else kept
    dropped = 1.0 - kept.float() / (top_k * n_all)
    return dest, weights, {'aux_loss': aux_loss, 'dropped_frac': dropped}


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int = 2,
            capacity_factor: float = 1.25, on: Optional[MoeMesh] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """SwiGLU expert FFN with top-k routing over the B*S tokens of ``x``.

    Args:
      x: [B, S, D] activations (flattened row-major to N = B*S tokens).
      w_router: [D, E], used in f32.
      w_gate/w_up: [E, D, M]; w_down: [E, M, D].
      on: with a mesh, x is this rank's block of the global batch
        (replicated over the expert and tp axes), w_router is whole, and
        the expert weights are this rank's [E/ep, D, M/tp] and [E/ep,
        M/tp, D]; the output is this rank's block, whole.

    Returns ([B, S, D] output in x's dtype, aux dict). Gradient reaches
    the router through the gates (and the aux loss through the mean
    probabilities) only: the slots are integers.
    """
    b, s, d = x.shape
    e = w_router.shape[-1]
    n = b * s
    xt = x.reshape(n, d)
    logits = xt.float() @ w_router.float()
    n_all = n * (on.mesh.size(on.token_axes) if on is not None else 1)
    cap = expert_capacity(n_all, e, top_k, capacity_factor)
    dest, weights, aux = top_k_routing(logits, top_k, cap, on=on,
                                       local_shape=(b, s))
    gates = weights.to(x.dtype)
    # The rows of this rank's experts: all E*C of them off a mesh.
    rows = w_gate.shape[0] * cap
    region = on.region_axes if on is not None else ()
    if region:
        first = on.mesh.index(on.expert_axes) * rows
        dest = dest - first
        mine = (dest >= 0) & (dest < rows)
        dest = torch.where(mine, dest, torch.full_like(dest, rows))
        xt = sharding.copy_to(xt, on.mesh, region)
        gates = sharding.copy_to(gates, on.mesh, region) * mine

    # Row e*C + c of the buffer is slot c of expert e; dropped choices (and
    # on a mesh those of other ranks' experts) go to the sink row, which
    # no expert reads. Empty slots stay zero and come out of the SwiGLU
    # as zero.
    token = torch.arange(n, device=x.device).repeat(top_k)
    buf = x.new_zeros(rows + 1, d).index_copy(0, dest.reshape(-1),
                                              xt[token])
    xe = buf[:rows].view(w_gate.shape[0], cap, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).view(rows, d)
    # A choice not held here reads some real row with gate 0. The gates
    # are rounded to x's dtype (as the JAX combine tensor is) and the k
    # rows summed in f32.
    got = ye[dest.clamp(max=rows - 1)]              # [k, N, D]
    y = (gates.float()[..., None] * got.float()).sum(0).to(x.dtype)
    if region:
        y = sharding.reduce_from(y, on.mesh, region)
    return y.reshape(b, s, d), aux
