"""Ring attention: exact causal attention over a sequence-sharded mesh axis.

Counterpart of ``skypilot_tpu/parallel/ring_attention.py``. q, k and v
are split along the sequence over ``axis`` (``sp``): rank i holds the
i-th block of every sequence. K/V blocks travel once around the ring,
and each rank attends its query block to the blocks that started on
ranks ``src <= i`` (a later block is wholly masked, as JAX's
``lax.cond(src <= my_idx, ...)`` skips it).

JAX accumulates an online softmax over einsum scores; here every visited
block goes through the flash kernels, as one ``torch.autograd.Function``
over the ring:

- forward: kernel K1 per visited block (``skytpu::flash_fwd``, so the
  'dots' remat policy keeps its outputs as it keeps the one-device K1's),
  causal on the diagonal block and full on earlier ones; GQA is read in
  place (no repeated KV). Each block's (out, lse) merges into f32
  running out and lse, out = sum_i exp(lse_i - lse) * out_i, rounded to
  the input dtype once;
- backward: kernel K2 per visited block with that block's k/v and the
  ring's final out and lse, which gives the block's exact share of the
  gradient. dq sums locally in f32; the dk/dv partials travel around
  the ring with their block, summed in f32, and reach its owner after
  the last shift.

CPU tensors take the kernels' plain versions (``ops/attention.py``), as
the one-device path does; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import Mesh


def _merge(acc_out: torch.Tensor, acc_lse: torch.Tensor,
           out: torch.Tensor, lse: torch.Tensor):
    """Two partial softmaxes over disjoint keys -> their union's (out in
    f32 [b, s, h, d], lse f32 [b, h, s])."""
    new_lse = torch.logaddexp(acc_lse, lse)

    def weight(x):  # [b, h, s] -> [b, s, h, 1]
        return torch.exp(x - new_lse).transpose(1, 2)[..., None]
    return acc_out * weight(acc_lse) + out.float() * weight(lse), new_lse


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axes, causal, scale):
        n, i = mesh.size(axes), mesh.index(axes)
        kv = torch.stack([k, v])
        acc_out = acc_lse = None
        for step in range(n):
            src = (i - step) % n
            if not causal or src <= i:
                out, lse = torch.ops.skytpu.flash_fwd(
                    q, kv[0], kv[1], causal and src == i, scale)
                if acc_out is None:
                    acc_out, acc_lse = out.float(), lse
                else:
                    acc_out, acc_lse = _merge(acc_out, acc_lse, out, lse)
            if step < n - 1:
                kv = sharding.ring_shift(kv, mesh, axes)
        out = acc_out.to(q.dtype)
        lse = acc_lse.contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axes, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axes, causal, scale = ctx.args
        n, i = mesh.size(axes), mesh.index(axes)
        dout = dout.contiguous()
        kv = torch.stack([k, v])
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step in range(n):
            src = (i - step) % n
            if not causal or src <= i:
                dq_b, dk_b, dv_b = torch.ops.skytpu.flash_bwd(
                    q, kv[0], kv[1], out, lse, dout, causal and src == i,
                    scale)
                dq += dq_b.float()
                dkv[0] += dk_b.float()
                dkv[1] += dv_b.float()
            if step < n - 1:
                kv = sharding.ring_shift(kv, mesh, axes)
            # The partials go with their block; after the n-th shift they
            # are home.
            dkv = sharding.ring_shift(dkv, mesh, axes)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Optional[Mesh], axis='sp', causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with K/V ring-rotated over ``axis``.

    q [b, s_local, hq, d], k/v [b, s_local, hkv, d] (hq a multiple of
    hkv; KV is not repeated): this rank's block of the sequence, whose
    global positions follow the rank's place on ``axis``. Returns [b,
    s_local, hq, d] in q's dtype. On an axis of size 1 (or no mesh) it
    is the one-device flash attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    axes = () if mesh is None else mesh.live(axis)
    if not axes:
        return attention_ops.flash_attention(q, k, v, causal, scale)
    return _RingAttention.apply(q, k, v, mesh, axes, causal, float(scale))
