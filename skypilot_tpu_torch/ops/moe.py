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
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert queue length C, padded to a multiple of 8 (at least 8)."""
    cap = int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Route N tokens to their top-k experts' capacity slots.

    Args:
      router_logits: [N, E].
      top_k: experts per token.
      capacity: per-expert queue length C.

    Returns:
      dest: [k, N] int64, ``e * C + c`` when choice k of token n holds
        slot c of expert e, ``E * C`` when it was dropped. The JAX
        ``dispatch[n, e, c]`` is the count of k with ``dest[k, n] == e * C
        + c``.
      weights: [k, N] f32, the renormalised gate of each kept assignment,
        0 where dropped (the JAX ``combine`` at the same places).
      aux: dict with 'aux_loss' (load balance) and 'dropped_frac'.
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
    onehot = F.one_hot(expert, e)                   # [k*N, E]
    pos = (onehot.cumsum(0) - onehot).gather(1, expert[:, None])[:, 0]
    keep = pos < capacity
    dest = torch.where(keep, expert * capacity + pos,
                       torch.full_like(pos, e * capacity)).view(top_k, n)
    weights = gate_vals.T * keep.view(top_k, n)

    frac_routed = onehot.sum(0).float() / n         # [E], all k choices
    mean_prob = probs.mean(0)                       # [E]
    aux_loss = e * torch.sum(frac_routed * mean_prob) / top_k
    dropped = 1.0 - keep.sum().float() / (top_k * n)
    return dest, weights, {'aux_loss': aux_loss, 'dropped_frac': dropped}


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int = 2,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, Dict]:
    """SwiGLU expert FFN with top-k routing over the B*S tokens of ``x``.

    Args:
      x: [B, S, D] activations (flattened row-major to N = B*S tokens).
      w_router: [D, E], used in f32.
      w_gate/w_up: [E, D, M]; w_down: [E, M, D].

    Returns ([B, S, D] output in x's dtype, aux dict). Gradient reaches
    the router through the gates (and the aux loss through the mean
    probabilities) only: the slots are integers.
    """
    b, s, d = x.shape
    e = w_router.shape[-1]
    n = b * s
    xt = x.reshape(n, d)
    logits = xt.float() @ w_router.float()
    cap = expert_capacity(n, e, top_k, capacity_factor)
    dest, weights, aux = top_k_routing(logits, top_k, cap)

    # Row e*C + c of the buffer is slot c of expert e; dropped choices go
    # to the sink row E*C, which no expert reads. Empty slots stay zero
    # and come out of the SwiGLU as zero.
    token = torch.arange(n, device=x.device).repeat(top_k)
    buf = x.new_zeros(e * cap + 1, d).index_copy(0, dest.reshape(-1),
                                                 xt[token])
    xe = buf[:e * cap].view(e, cap, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).view(e * cap, d)
    # A dropped choice reads some real row with weight 0. The gates are
    # rounded to x's dtype (as the JAX combine tensor is) and the k rows
    # summed in f32.
    rows = ye[dest.clamp(max=e * cap - 1)]          # [k, N, D]
    gates = weights.to(x.dtype).float()[..., None]
    y = (gates * rows.float()).sum(0).to(x.dtype)
    return y.reshape(b, s, d), aux
