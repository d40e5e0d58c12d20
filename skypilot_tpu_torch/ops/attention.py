"""Attention: reference, blockwise (memory-efficient), CUDA flash.

Counterpart of ``skypilot_tpu/ops/attention.py``. Layouts are
[batch, seq, heads, head_dim] throughout, as in the JAX package.

Dispatch (``attention``):
  1. CUDA tensors -> flash attention: the hand-written forward kernel K1
     (``csrc/flash_fwd.cu``) and, when a gradient is taken, the backward
     kernel K2 (``csrc/flash_bwd.cu``), replacing the two Pallas TPU
     kernels. Both are ``torch.library`` custom ops (``skytpu::flash_fwd``,
     ``skytpu::flash_bwd``) joined by one ``torch.autograd.Function``, the
     counterpart of the JAX ``custom_vjp``. They take any sq <= sk,
     head_dim 64 or 128, bf16. A CUDA call they cannot take raises: there
     is no quiet fallback on the card.
  2. CPU tensors -> the blockwise online-softmax loop, exactly as the JAX
     dispatcher picks it off the TPU.
  ``force_impl`` ('flash' | 'blockwise' | 'reference') overrides either;
  'flash' on CPU tensors runs the same custom ops and autograd function
  over the kernels' plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

_NEG_INF = -1e30

# Kernel launch counts, by kernel name: each wrapper adds one where it
# launches its kernel and nowhere else (a CPU tensor takes the plain
# version and leaves the count alone).
LAUNCHES: Dict[str, int] = {'flash_fwd': 0, 'flash_bwd': 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _maybe_repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat KV heads for grouped-query attention."""
    hq, hk = q.shape[2], k.shape[2]
    if hq == hk:
        return k, v
    if hq % hk:
        raise ValueError(f'q heads {hq} not a multiple of kv heads {hk}')
    rep = hq // hk
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] allowed positions, queries at the END of the keys."""
    q_pos = sk - sq + torch.arange(sq, device=device)
    return q_pos[:, None] >= torch.arange(sk, device=device)[None, :]


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """O(S^2)-memory reference attention, f32 inside.

    ``mask``: optional explicit [Sq, Sk] (or broadcastable) boolean mask
    of *allowed* positions; overrides ``causal``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _maybe_repeat_kv(q, k, v)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if mask is None and causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
    if mask is not None:
        m = mask[None, None] if mask.dim() == 2 else mask
        s = torch.where(m, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        block_size: int = 512) -> torch.Tensor:
    """Exact attention as a loop over KV blocks with an online softmax;
    never materialises the [Sq, Sk] score matrix."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _maybe_repeat_kv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    blk = min(block_size, sk)
    if sk % blk:
        blk = sk  # irregular shapes: single block (== reference memory-wise)
    q32 = q.float()
    q_start = sk - sq  # kv may include a prefix (decode with cache)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    q_pos = q_start + torch.arange(sq, device=q.device)
    for start in range(0, sk, blk):
        k_blk = k[:, start:start + blk].float()
        v_blk = v[:, start:start + blk].float()
        s = torch.einsum('bqhd,bkhd->bhqk', q32, k_blk) * scale
        if causal:
            kv_pos = start + torch.arange(blk, device=q.device)
            allowed = (q_pos[:, None] >= kv_pos[None, :])[None, None]
            s = torch.where(allowed, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum('bhqk,bkhd->bqhd', p, v_blk))
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash-attention forward: CUDA kernel K1 and its plain version.
# ---------------------------------------------------------------------------

FLASH_HEAD_DIMS = (64, 128)


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool,
                                  scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward: (out [b, sq, hq, d] in
    q's dtype, lse [b, hq, sq] f32). f32 scores, masked to -1e30, P cast
    to the input dtype before P.V as the TPU kernel does, l clamped to
    1e-30; GQA reads KV head h // (hq / hkv)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f'q heads {hq} not a multiple of kv heads {hkv}')
    grp = hq // hkv
    qg = q.float().reshape(b, sq, hkv, grp, d)
    s = torch.einsum('bqkgd,bskd->bkgqs', qg, k.float()) * scale
    if causal:
        allowed = _causal_mask(sq, sk, q.device)
        s = torch.where(allowed, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum('bkgqs,bskd->bqkgd', p.to(q.dtype).float(), v.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].reshape(b, hq, sq)
    return o.reshape(b, sq, hq, d).to(q.dtype), lse


_flash_lib = None


def _bind_error_string(lib: ctypes.CDLL) -> None:
    lib.skytpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.skytpu_cuda_error_string.restype = ctypes.c_char_p


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K1's C interface on a loaded library (``csrc/flash_fwd.cu``
    of this or another checkout: the interface has not changed)."""
    fn = lib.skytpu_flash_fwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bind_error_string(lib)
    return lib


def _flash_kernel():
    global _flash_lib
    if _flash_lib is None:
        _flash_lib = bind_fwd(_build.load('flash_fwd'))
    return _flash_lib


def _check_flash_operand(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f'{name} must be [b, s, h, d], got {tuple(t.shape)}')
    if t.dtype != torch.bfloat16:
        raise ValueError(f'flash kernel takes bf16, {name} is {t.dtype}')
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f'{name} needs a unit head_dim stride and '
                         f'16-byte aligned rows, strides {t.stride()}')
    if t.data_ptr() % 16:
        raise ValueError(f'{name} data is not 16-byte aligned')


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward -> (out [b, sq, hq, d], lse [b, hq, sq]).

    CUDA tensors launch kernel K1 (``csrc/flash_fwd.cu``, the port of the
    Pallas kernel ``_flash_fwd_kernel``); CPU tensors take
    ``flash_attention_fwd_reference``. On the card, inputs the kernel does
    not take raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        if q.is_cuda or k.is_cuda or v.is_cuda:
            raise ValueError('flash_attention_fwd: q, k, v must share a '
                             'device')
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    for name, t in (('q', q), ('k', k), ('v', v)):
        _check_flash_operand(name, t)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f'flash kernel head_dim must be one of '
                         f'{FLASH_HEAD_DIMS}, got {d}')
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if hq % hkv:
        raise ValueError(f'q heads {hq} not a multiple of kv heads {hkv}')
    if sq < 1 or sk < 1:
        raise ValueError('flash kernel needs sq >= 1 and sk >= 1')
    if causal and sq > sk:
        raise ValueError(f'causal flash needs sq <= sk, got {sq} > {sk}')
    if not (q.device == k.device == v.device):
        raise ValueError('flash_attention_fwd: q, k, v must share a device')
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _flash_kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.skytpu_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(scale), int(bool(causal)),
        q.device.index or 0, stream)
    if err != 0:
        msg = lib.skytpu_cuda_error_string(err).decode()
        raise RuntimeError(f'flash_fwd kernel launch failed: {msg} ({err})')
    LAUNCHES['flash_fwd'] += 1
    return out, lse


# ---------------------------------------------------------------------------
# Flash-attention backward: CUDA kernel K2 and its plain version.
# ---------------------------------------------------------------------------

def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, dout: torch.Tensor,
                                  causal: bool, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the flash backward -> (dq, dk, dv) in the
    dtypes of q, k, v. f32 math from the saved lse [b, hq, sq]; P and dS
    cast to q's dtype before their products, as the TPU kernel does;
    delta = rowsum(dO * O) in f32; GQA reads KV head h // (hq / hkv) and
    dK/dV are summed over each KV head's group in f32."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f'q heads {hq} not a multiple of kv heads {hkv}')
    grp = hq // hkv
    qg = q.float().reshape(b, sq, hkv, grp, d)
    dog = dout.float().reshape(b, sq, hkv, grp, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum('bqkgd,bskd->bkgqs', qg, kf) * scale
    if causal:
        allowed = _causal_mask(sq, sk, q.device)
        s = torch.where(allowed, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse.reshape(b, hkv, grp, sq, 1)).to(q.dtype).float()
    delta = (dog * out.float().reshape(b, sq, hkv, grp, d)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]  # [b, hkv, grp, sq, 1]
    dv = torch.einsum('bkgqs,bqkgd->bskd', p, dog)
    dp = torch.einsum('bqkgd,bskd->bkgqs', dog, vf)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dk = torch.einsum('bkgqs,bqkgd->bskd', ds, qg) * scale
    dq = torch.einsum('bkgqs,bskd->bqkgd', ds, kf) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_flash_bwd_lib = None


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K2's C interface on a loaded library, as ``bind_fwd``."""
    fn = lib.skytpu_flash_bwd_bf16
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _bind_error_string(lib)
    return lib


def _flash_bwd_kernel():
    global _flash_bwd_lib
    if _flash_bwd_lib is None:
        _flash_bwd_lib = bind_bwd(_build.load('flash_bwd'))
    return _flash_bwd_lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward -> (dq, dk, dv), shaped and typed as q, k,
    v, from the forward's out [b, sq, hq, d] and lse [b, hq, sq].

    CUDA tensors launch kernel K2 (``csrc/flash_bwd.cu``, the port of the
    Pallas kernel ``_flash_bwd_kernel``); CPU tensors take
    ``flash_attention_bwd_reference``. On the card, inputs the kernel does
    not take raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tensors = (q, k, v, out, lse, dout)
    if not all(t.is_cuda for t in tensors):
        if any(t.is_cuda for t in tensors):
            raise ValueError('flash_attention_bwd: all inputs must share a '
                             'device')
        return flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                             causal, scale)
    for name, t in (('q', q), ('k', k), ('v', v), ('out', out),
                    ('dout', dout)):
        _check_flash_operand(name, t)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f'flash kernel head_dim must be one of '
                         f'{FLASH_HEAD_DIMS}, got {d}')
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f'k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f'out/dout shapes {tuple(out.shape)}/'
                         f'{tuple(dout.shape)} do not match q '
                         f'{tuple(q.shape)}')
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f'lse must be a contiguous f32 [b, hq, sq], got '
                         f'{tuple(lse.shape)} {lse.dtype}')
    if hq % hkv:
        raise ValueError(f'q heads {hq} not a multiple of kv heads {hkv}')
    if sq < 1 or sk < 1:
        raise ValueError('flash kernel needs sq >= 1 and sk >= 1')
    if causal and sq > sk:
        raise ValueError(f'causal flash needs sq <= sk, got {sq} > {sk}')
    if len({t.device for t in tensors}) != 1:
        raise ValueError('flash_attention_bwd: all inputs must share a '
                         'device')
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    lib = _flash_bwd_kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.skytpu_flash_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d, strides,
        float(scale), int(bool(causal)), q.device.index or 0, stream)
    if err != 0:
        msg = lib.skytpu_cuda_error_string(err).decode()
        raise RuntimeError(f'flash_bwd kernel launch failed: {msg} ({err})')
    LAUNCHES['flash_bwd'] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels as custom ops, and the autograd function that joins them.
# Selective checkpointing (models/llama.py, remat 'dots') names
# torch.ops.skytpu.flash_fwd to keep K1's out and lse instead of
# recomputing them in the backward.
# ---------------------------------------------------------------------------

@torch.library.custom_op('skytpu::flash_fwd', mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal, scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    b, sq, hq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, sq), dtype=torch.float32))


@torch.library.custom_op('skytpu::flash_bwd', mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                 causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, dout, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v): forward K1, saving q, k, v, out
    and lse; backward K2. The counterpart of the JAX ``_flash_attention``
    custom_vjp, without its repeat and transposes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = torch.ops.skytpu.flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.skytpu.flash_bwd(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention: through ``FlashAttention`` when a
    gradient can flow, else K1's op alone (serving)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, float(scale))
    return torch.ops.skytpu.flash_fwd(q, k, v, causal, float(scale))[0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              block_size: int = 512,
              force_impl: Optional[str] = None) -> torch.Tensor:
    """Dispatching attention entry point (see module docstring)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    impl = force_impl
    if impl is None:
        impl = 'flash' if q.is_cuda else 'blockwise'
    if impl == 'flash':
        return flash_attention(q, k, v, causal, scale)
    if impl == 'blockwise':
        return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                   block_size=block_size)
    if impl == 'reference':
        return mha_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f'unknown attention impl {impl!r}')
