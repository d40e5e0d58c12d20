"""Llama-family decoder-only transformer (PyTorch counterpart of
``skypilot_tpu/models/llama.py``).

The module holds the JAX package's parameter tree 1:1: the same names
and the same stacked per-layer layout (``wq [L, e, h, d]``,
``wo [L, h, d, e]``, ``w_gate [L, e, m]``, ...), so JAX parameters carry
over by name (``params_from_numpy``) and both sides compute the same
thing. Methods take the parameter tree as an explicit dict, as the JAX
functions do; ``params()`` returns the module's own.

GQA, RoPE, SwiGLU, RMSNorm; bf16 weights and activations, f32 norms,
softmax and logits. ``apply`` is the no-grad forward that serving uses;
``apply_with_aux`` is the differentiable one that training uses, with the
configured rematerialisation policy around each layer. Sharding and
pipeline stages are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops.layers import (apply_rotary, precompute_rotary,
                                           rms_norm)
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

LAYER_PARAMS = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down',
                'attn_norm', 'mlp_norm')


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    embed_dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = True
    # Rematerialisation policy of each layer in training: 'full' recomputes
    # the whole layer in the backward; 'dots' keeps the outputs of the
    # matmuls with no batch dims and the flash forward's out and lse.
    # 'names', 'names_qkv' and 'names_offload' are not ported yet.
    remat_policy: str = 'full'
    # Pipeline microbatches when the mesh has pp > 1 (multi-device is not
    # ported; kept so configs carry over field by field).
    pp_microbatches: Optional[int] = None

    @property
    def num_params(self) -> int:
        e, l, v = self.embed_dim, self.num_layers, self.vocab_size
        qkv = e * self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
        o = self.num_heads * self.head_dim * e
        mlp = 3 * e * self.mlp_dim
        per_layer = qkv + o + mlp + 2 * e
        head = 0 if self.tie_embeddings else e * v
        return v * e + l * per_layer + e + head

    @property
    def flops_params(self) -> int:
        """Param count for FLOPs accounting (an MoE config would count the
        per-token active parameters)."""
        return self.num_params

    def train_flops_per_token(self, seq_len: int,
                              causal: bool = True) -> float:
        """Training matmul FLOPs per token: 6N plus the attention term
        12·L·H·D·T (QK^T and PV, forward and backward), halved when
        causal because the flash kernels skip masked tiles."""
        attn = 12 * self.num_layers * self.num_heads * self.head_dim \
            * seq_len
        if causal:
            attn //= 2
        return 6 * self.flops_params + attn


PRESETS: Dict[str, LlamaConfig] = {
    'test-tiny': LlamaConfig(vocab_size=256, embed_dim=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             mlp_dim=128, max_seq_len=512,
                             dtype=torch.float32, remat=False),
    'llama-1b': LlamaConfig(vocab_size=32000, embed_dim=2048, num_layers=16,
                            num_heads=16, num_kv_heads=8, head_dim=128,
                            mlp_dim=5632, max_seq_len=8192,
                            rope_theta=10000.0),
    'llama2-7b': LlamaConfig(vocab_size=32000, embed_dim=4096, num_layers=32,
                             num_heads=32, num_kv_heads=32, head_dim=128,
                             mlp_dim=11008, max_seq_len=4096,
                             rope_theta=10000.0),
    'llama3-8b': LlamaConfig(),  # defaults are Llama-3-8B
    'llama3-70b': LlamaConfig(embed_dim=8192, num_layers=80, num_heads=64,
                              num_kv_heads=8, mlp_dim=28672),
}


def param_shapes(config: LlamaConfig) -> Params:
    """name -> (shape, fan_in) for every parameter; fan_in None marks a
    norm weight (initialised to ones)."""
    c = config
    l, e, h, kvh, d, m = (c.num_layers, c.embed_dim, c.num_heads,
                          c.num_kv_heads, c.head_dim, c.mlp_dim)
    shapes: Params = {
        'embed': ((c.vocab_size, e), 1.0),
        'final_norm': ((e,), None),
        'layers': {
            'wq': ((l, e, h, d), e),
            'wk': ((l, e, kvh, d), e),
            'wv': ((l, e, kvh, d), e),
            'wo': ((l, h, d, e), h * d),
            'w_gate': ((l, e, m), e),
            'w_up': ((l, e, m), e),
            'w_down': ((l, m, e), m),
            'attn_norm': ((l, e), None),
            'mlp_norm': ((l, e), None),
        },
    }
    if not c.tie_embeddings:
        shapes['lm_head'] = ((e, c.vocab_size), e)
    return shapes


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):  # e.g. a checkpoint's CPU tensors
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == 'bfloat16':  # ml_dtypes bf16 from JAX
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


class LlamaModel(nn.Module):
    """Parameters of one Llama model plus its forward math.

    ``apply`` is the full forward to f32 logits; ``init_cache`` +
    ``decode_step`` are the plain decode oracle. The serving engine
    (``models/decode.py``) reuses ``_qkv``/``_mlp_delta`` so the block
    math lives once.
    """

    def __init__(self, config: LlamaConfig, device: DeviceLike = None):
        super().__init__()
        self.config = config
        # 'meta' holds the block math without weights (the decode engine
        # builds one when it is given no model).
        self.device = (torch.device('meta') if device == 'meta'
                       else resolve_device(device))
        shapes = param_shapes(config)

        def empty(shape):
            return nn.Parameter(torch.empty(shape, dtype=config.dtype,
                                            device=self.device),
                                requires_grad=False)

        self.embed = empty(shapes['embed'][0])
        self.final_norm = empty(shapes['final_norm'][0])
        self.layers = nn.ParameterDict(
            {name: empty(shape)
             for name, (shape, _) in shapes['layers'].items()})
        self.lm_head = (empty(shapes['lm_head'][0])
                        if 'lm_head' in shapes else None)

    # -- parameters -----------------------------------------------------------
    def params(self) -> Params:
        """The parameter tree, named and nested as the JAX pytree."""
        tree: Params = {
            'embed': self.embed, 'final_norm': self.final_norm,
            'layers': {name: self.layers[name] for name in LAYER_PARAMS},
        }
        if self.lm_head is not None:
            tree['lm_head'] = self.lm_head
        return tree

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Params:
        """Random weights drawn on the model's device with ``generator``
        (which must live there): N(0, 1/fan_in) in f32, cast to the config
        dtype one layer at a time, so an 8 B model never exists in f32;
        norm weights are ones. The distributions of the JAX ``init``; the
        bits differ (another generator)."""
        shapes = param_shapes(self.config)
        tree = self.params()

        def fill(param, shape, fan_in):
            if fan_in is None:
                param.fill_(1.0)
                return
            rows = param if len(shape) > 2 else param[None]
            for row in rows:
                draw = torch.randn(row.shape, dtype=torch.float32,
                                   device=self.device, generator=generator)
                row.copy_(draw * fan_in ** -0.5)

        fill(tree['embed'], *shapes['embed'])
        fill(tree['final_norm'], *shapes['final_norm'])
        for name in LAYER_PARAMS:
            fill(tree['layers'][name], *shapes['layers'][name])
        if 'lm_head' in tree:
            fill(tree['lm_head'], *shapes['lm_head'])
        return tree

    @torch.no_grad()
    def params_from_numpy(self, tree: Params) -> Params:
        """Copy a JAX parameter tree (``LlamaModel.init`` output as numpy
        arrays) into this module, 1:1 by name; returns ``params()``."""
        own = self.params()

        def copy(dst: torch.Tensor, src, name: str) -> None:
            t = _tensor_from_numpy(src)
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f'{name}: shape {tuple(t.shape)} does not '
                                 f'match {tuple(dst.shape)}')
            dst.copy_(t.to(dst.dtype))

        missing = set(own) ^ set(tree)
        if missing:
            raise ValueError(f'parameter trees differ in {sorted(missing)}')
        for name, value in tree.items():
            if name == 'layers':
                for lname in LAYER_PARAMS:
                    copy(own['layers'][lname], value[lname],
                         f'layers.{lname}')
            else:
                copy(own[name], value, name)
        return own

    # -- block math -------------------------------------------------------------
    def _qkv(self, lp: Params, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pre-attention norm + QKV projections + rotary."""
        c = self.config
        b, s, e = x.shape
        h = rms_norm(x, lp['attn_norm'], c.norm_eps)
        q = (h @ lp['wq'].reshape(e, -1)).view(b, s, c.num_heads, c.head_dim)
        k = (h @ lp['wk'].reshape(e, -1)).view(b, s, c.num_kv_heads,
                                                c.head_dim)
        v = (h @ lp['wv'].reshape(e, -1)).view(b, s, c.num_kv_heads,
                                                c.head_dim)
        return (apply_rotary(q, cos, sin, positions),
                apply_rotary(k, cos, sin, positions), v)

    def _attn_out(self, lp: Params, attn: torch.Tensor) -> torch.Tensor:
        """[B, S, H, D] attention context -> [B, S, E] through wo."""
        b, s = attn.shape[:2]
        return attn.reshape(b, s, -1) @ lp['wo'].reshape(-1,
                                                          self.config.embed_dim)

    def _mlp_delta(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        """Post-attention SwiGLU feed-forward delta."""
        h = rms_norm(x, lp['mlp_norm'], self.config.norm_eps)
        gate = h @ lp['w_gate']
        up = h @ lp['w_up']
        return (torch.nn.functional.silu(gate) * up) @ lp['w_down']

    def _head(self, params: Params) -> torch.Tensor:
        return (params['embed'].T if self.config.tie_embeddings
                else params['lm_head'])

    @staticmethod
    def layer_params(params: Params, i: int) -> Params:
        return {name: t[i] for name, t in params['layers'].items()}

    # -- forward ------------------------------------------------------------
    @torch.no_grad()
    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              force_impl: Optional[str] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] (f32). ``force_impl`` picks
        the attention implementation (ops/attention.py names)."""
        c = self.config
        dev = tokens.device
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=dev)
        cos, sin = precompute_rotary(c.head_dim, c.max_seq_len,
                                     c.rope_theta, device=dev)
        x = params['embed'][tokens].to(c.dtype)
        for i in range(c.num_layers):
            lp = self.layer_params(params, i)
            q, k, v = self._qkv(lp, x, cos, sin, positions)
            attn = attention_ops.attention(q, k, v, causal=True,
                                           force_impl=force_impl)
            x = x + self._attn_out(lp, attn)
            x = x + self._mlp_delta(lp, x)
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        # bf16 operands, f32 products and sums: f32-accurate logits.
        return x.float() @ self._head(params).float()

    @property
    def aux_loss_weight(self) -> float:
        return 0.0

    def apply_with_aux(self, params: Params, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       force_impl: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Differentiable forward -> (logits [B, S, V] f32, aux loss).

        aux is 0 for this dense model (the Trainer adds
        ``aux_loss_weight * aux``). Each stacked ``[L, ...]`` parameter is
        split with one ``unbind`` per call, whose backward is one
        ``stack``, so no layer allocates a full-size zero gradient."""
        c = self.config
        dev = tokens.device
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=dev)
        cos, sin = precompute_rotary(c.head_dim, c.max_seq_len,
                                     c.rope_theta, device=dev)

        def layer(x, *values):
            lp = dict(zip(LAYER_PARAMS, values))
            q, k, v = self._qkv(lp, x, cos, sin, positions)
            attn = attention_ops.attention(q, k, v, causal=True,
                                           force_impl=force_impl)
            x = x + self._attn_out(lp, attn)
            return x + self._mlp_delta(lp, x)

        layer = _maybe_remat(layer, c)
        stacked = [params['layers'][name].unbind(0) for name in LAYER_PARAMS]
        x = params['embed'][tokens].to(c.dtype)
        for i in range(c.num_layers):
            x = layer(x, *(values[i] for values in stacked))
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        # f32 operands: f32-accurate logits, as ``apply``.
        logits = x.float() @ self._head(params).float()
        return logits, torch.zeros((), dtype=torch.float32, device=dev)

    # -- decode oracle -------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        c = self.config
        shape = (c.num_layers, batch, max_len, c.num_kv_heads, c.head_dim)
        return {
            'k': torch.zeros(shape, dtype=c.dtype, device=self.device),
            'v': torch.zeros(shape, dtype=c.dtype, device=self.device),
            'length': 0,
        }

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """Append ``tokens`` [B, T] at cache length, return last-token
        logits [B, V] (f32) and the new cache. Prefill (T = prompt length)
        and decode (T = 1) share the one code path."""
        c = self.config
        dev = tokens.device
        start = int(cache['length'])
        t = tokens.shape[1]
        positions = start + torch.arange(t, device=dev)
        cos, sin = precompute_rotary(c.head_dim, c.max_seq_len,
                                     c.rope_theta, device=dev)
        x = params['embed'][tokens].to(c.dtype)
        max_len = cache['k'].shape[2]
        kv_pos = torch.arange(max_len, device=dev)
        valid = kv_pos[None, :] <= positions[:, None]  # [T, max_len]
        new_k, new_v = [], []
        for i in range(c.num_layers):
            lp = self.layer_params(params, i)
            q, k, v = self._qkv(lp, x, cos, sin, positions)
            k_cache = cache['k'][i].clone()
            v_cache = cache['v'][i].clone()
            k_cache[:, start:start + t] = k
            v_cache[:, start:start + t] = v
            new_k.append(k_cache)
            new_v.append(v_cache)
            attn = attention_ops.mha_reference(q, k_cache, v_cache,
                                               mask=valid)
            x = x + self._attn_out(lp, attn)
            x = x + self._mlp_delta(lp, x)
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        logits = x[:, -1].float() @ self._head(params).float()
        return logits, {'k': torch.stack(new_k), 'v': torch.stack(new_v),
                        'length': start + t}


# -- rematerialisation --------------------------------------------------------

def _dots_policy(ctx, op, *args, **kwargs):
    """Keep what JAX's 'dots' policy keeps: outputs of matmuls with no
    batch dims (aten.mm; a [b, s, e] @ [e, n] product lowers to one) and
    the flash forward's out and lse; recompute everything else."""
    del ctx, args, kwargs
    if op in (torch.ops.aten.mm.default,
              torch.ops.skytpu.flash_fwd.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return torch_checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _maybe_remat(layer_fn: Callable, config: LlamaConfig) -> Callable:
    """Wrap one layer's function in the configured rematerialisation
    policy (the counterpart of ``skypilot_tpu/models/llama.py``
    ``_maybe_remat``)."""
    if not config.remat:
        return layer_fn
    policy = config.remat_policy
    if policy == 'full':
        return functools.partial(torch_checkpoint.checkpoint, layer_fn,
                                 use_reentrant=False)
    if policy == 'dots':
        return functools.partial(torch_checkpoint.checkpoint, layer_fn,
                                 use_reentrant=False,
                                 context_fn=_dots_context)
    if policy in ('names', 'names_qkv', 'names_offload'):
        raise NotImplementedError(
            f'remat_policy {policy!r} is not yet ported to the PyTorch '
            f'trainer (ROADMAP.md queue 1)')
    raise ValueError(
        f'unknown remat_policy {policy!r}; expected one of \'full\', '
        "'dots', 'names', 'names_qkv', 'names_offload'")
