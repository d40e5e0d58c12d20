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
configured rematerialisation policy around each layer.

On a mesh (``mesh=``, ``parallel/mesh.py``) every parameter is held as
this rank's shard of its ``logical_axes`` layout under ``rules``, and the
forward calls the collectives that GSPMD inserted for the JAX model: the
vocab-parallel ``embed_lookup``; in each layer the fsdp-sharded weights
gathered where they are used (inside the checkpointed layer, so remat
gathers them again); q/k/v, gate and up column-parallel over tp (K1 and
K2 see ``Hq/tp`` and ``Hkv/tp`` heads), ``wo`` and ``w_down``
row-parallel with an all-reduce; the f32 lm head's logits sharded over
the vocab, as JAX's ``act_vocab`` -> tp. With ``sp`` > 1 each rank holds
a block of every sequence, its rotary positions are global, and
attention is ``parallel/ring_attention.py`` (K1/K2 per visited block);
with ``pp`` > 1 the ``layers`` dim is split over ``pp`` and the layer
stack runs as GPipe stages (``parallel/pipeline.py``). Not both at once,
as in JAX. ``ep`` splits only the experts of an MoE model
(``models/mixtral.py``); activations and every other weight are
replicated over it.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from skypilot_tpu_torch.ops import attention as attention_ops
from skypilot_tpu_torch.ops.embedding import embed_lookup
from skypilot_tpu_torch.ops.layers import (apply_rotary, precompute_rotary,
                                           rms_norm)
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import Mesh, as_axes
from skypilot_tpu_torch.parallel.pipeline import pipeline
from skypilot_tpu_torch.parallel.ring_attention import ring_attention
from skypilot_tpu_torch.parallel.sharding import DEFAULT_RULES, LogicalRules
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device
from skypilot_tpu_torch.utils.tree import flatten, unflatten

Params = Dict[str, Any]
Aux = Union[torch.Tensor, float]


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
    # matmuls with no batch dims and the flash forward's out and lse;
    # 'names' / 'names_qkv' / 'names_offload' keep the tagged activations
    # of REMAT_NAMES (the last one on the host for two of them).
    remat_policy: str = 'full'
    # Pipeline microbatches when the mesh has pp > 1 (None: one per stage,
    # the fewest that keep every stage busy).
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


def logical_axes(config: LlamaConfig) -> Params:
    """The logical axis of every dim of every parameter, as the JAX
    ``logical_axes`` names them."""
    axes = {
        'embed': ('vocab', 'embed'),
        'final_norm': (None,),
        'layers': {
            'wq': ('layers', 'embed', 'heads', None),
            'wk': ('layers', 'embed', 'kv_heads', None),
            'wv': ('layers', 'embed', 'kv_heads', None),
            'wo': ('layers', 'heads', None, 'embed'),
            'w_gate': ('layers', 'embed', 'mlp'),
            'w_up': ('layers', 'embed', 'mlp'),
            'w_down': ('layers', 'mlp', 'embed'),
            'attn_norm': ('layers', None),
            'mlp_norm': ('layers', None),
        },
    }
    if not config.tie_embeddings:
        axes['lm_head'] = ('embed', 'vocab')
    return axes


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
    math lives once; a subclass swaps the feed-forward by overriding
    ``_param_shapes`` and ``_mlp_delta`` (``models/mixtral.py``).
    """

    # Layer parameters kept in f32 whatever the config dtype.
    F32_PARAMS: Tuple[str, ...] = ()

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 mesh: Optional[Mesh] = None,
                 rules: LogicalRules = DEFAULT_RULES):
        super().__init__()
        self.config = config
        # 'meta' holds the block math without weights (the decode engine
        # builds one when it is given no model).
        self.device = (torch.device('meta') if device == 'meta'
                       else resolve_device(device))
        # A mesh of one device is no mesh: the one-device path, unchanged.
        self.mesh = mesh if mesh is not None and mesh.num_devices > 1 \
            else None
        if self.mesh is not None and self.mesh.shape['pp'] > 1:
            # Stage-major layers: each pp rank holds its stage's layers.
            rules = rules.with_overrides(layers='pp')
        self.rules = rules
        shapes = self._param_shapes()
        self.specs: Dict[str, Tuple] = {}
        if self.mesh is not None:
            self._check_mesh(self.mesh, rules)
            self.specs = flatten(sharding.tree_specs(rules,
                                                     self.logical_axes()))
        batch = set(rules.axes('batch'))
        # Per leaf, (dim, mesh axes) to all-gather before use: the dims
        # split over axes that also split the batch (fsdp).
        self._gathers = {
            name: [(d, tuple(a for a in as_axes(e) if a in batch))
                   for d, e in enumerate(spec) if set(as_axes(e)) & batch]
            for name, spec in self.specs.items()}
        self._tp = (self.mesh.live(rules.axes('heads'))
                    if self.mesh is not None else ())

        def empty(shape, name):
            dtype = (torch.float32 if name.split('/')[-1] in self.F32_PARAMS
                     else config.dtype)
            if name in self.specs:
                shape = sharding.local_shape(shape, self.specs[name],
                                             self.mesh)
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=self.device),
                                requires_grad=False)

        self.embed = empty(shapes['embed'][0], 'embed')
        self.final_norm = empty(shapes['final_norm'][0], 'final_norm')
        # An OrderedDict keeps the declared order (a dict would be sorted).
        self.layers = nn.ParameterDict(OrderedDict(
            (name, empty(shape, f'layers/{name}'))
            for name, (shape, _) in shapes['layers'].items()))
        self.lm_head = (empty(shapes['lm_head'][0], 'lm_head')
                        if 'lm_head' in shapes else None)

    @staticmethod
    def _check_mesh(mesh: Mesh, rules: LogicalRules) -> None:
        """The layouts this port takes: dp, fsdp, tp, dcn, sp (ring
        attention), pp (pipeline stages) and ep (experts; a dense model
        is replicated over it, as under GSPMD), not sp with pp."""
        if mesh.shape['pp'] > 1 and mesh.shape['sp'] > 1:
            raise NotImplementedError('pp > 1 with sp > 1 is not supported '
                                      'yet; use ring attention without '
                                      'pipeline stages or vice versa')
        # Weight dims split over batch axes are gathered where used (fsdp);
        # the head, mlp and vocab dims split over the tensor-parallel axes
        # stay split, and so do the experts. Other layouts GSPMD would
        # take are not ported.
        tp = mesh.live(rules.axes('heads'))
        batch = set(rules.axes('batch'))
        for name in ('kv_heads', 'mlp', 'vocab'):
            if mesh.live(rules.axes(name)) != tp:
                raise NotImplementedError(
                    f'logical axis {name!r} must shard over the heads\' '
                    f'axes {tp}, not {rules.axes(name)}')
        if set(tp) & batch:
            raise NotImplementedError(f'tensor-parallel axes {tp} also '
                                      'shard the batch')
        if not set(mesh.live(rules.axes('embed'))) <= batch:
            raise NotImplementedError(
                f'embed axes {rules.axes("embed")} outside the batch axes '
                f'{sorted(batch)} are not supported')
        seq = mesh.live(rules.axes('seq'))
        if set(seq) & (batch | set(tp)):
            raise NotImplementedError(f'sequence axes {seq} also shard the '
                                      'batch or the heads')
        expert = mesh.live(rules.axes('expert'))
        if set(expert) & (batch | set(tp) | set(seq)):
            raise NotImplementedError(f'expert axes {expert} also shard the '
                                      'batch, the sequence or the heads')

    def logical_axes(self) -> Params:
        return logical_axes(self.config)

    def _param_shapes(self) -> Params:
        return param_shapes(self.config)

    # -- parameters -----------------------------------------------------------
    def params(self) -> Params:
        """The parameter tree, named and nested as the JAX pytree."""
        tree: Params = {
            'embed': self.embed, 'final_norm': self.final_norm,
            'layers': dict(self.layers.items()),
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
        bits differ (another generator). On a mesh each full draw is made
        and this rank keeps its shard (of every layer, its own layers when
        pp splits them), so every mesh starts from the bits of the
        one-device init with the same seed."""
        shapes = self._param_shapes()
        tree = self.params()

        def fill(param, name, shape, fan_in):
            if fan_in is None:
                param.fill_(1.0)
                return
            spec = self.specs.get(name, ())
            if len(shape) > 2:  # one draw per layer, every layer in order
                mine = (sharding.dim_slices(shape, spec, self.mesh)[0]
                        if self.mesh is not None else slice(0, shape[0]))
                count, shape, spec = shape[0], shape[1:], spec[1:]
            else:
                param, mine, count = param[None], slice(0, 1), 1
            for index in range(count):
                draw = torch.randn(shape, dtype=torch.float32,
                                   device=self.device, generator=generator)
                if mine.start <= index < mine.stop:
                    param[index - mine.start].copy_(sharding.local_shard(
                        draw * fan_in ** -0.5, spec, self.mesh))

        fill(tree['embed'], 'embed', *shapes['embed'])
        fill(tree['final_norm'], 'final_norm', *shapes['final_norm'])
        for name, param in tree['layers'].items():
            fill(param, f'layers/{name}', *shapes['layers'][name])
        if 'lm_head' in tree:
            fill(tree['lm_head'], 'lm_head', *shapes['lm_head'])
        return tree

    @torch.no_grad()
    def params_from_numpy(self, tree: Params) -> Params:
        """Copy a JAX parameter tree (``LlamaModel.init`` output as numpy
        arrays, or full tensors) into this module, 1:1 by name, keeping
        this rank's shards on a mesh; returns ``params()``."""
        own = flatten(self.params())
        src = flatten(tree)
        missing = set(own) ^ set(src)
        if missing:
            raise ValueError(f'parameter trees differ in {sorted(missing)}')
        for name, dst in own.items():
            t = _tensor_from_numpy(src[name])
            if name in self.specs and t.shape != dst.shape:
                t = sharding.local_shard(t, self.specs[name], self.mesh)
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f'{name}: shape {tuple(t.shape)} does not '
                                 f'match {tuple(dst.shape)}')
            dst.copy_(t.to(dst.dtype))
        return self.params()

    @torch.no_grad()
    def full_params(self, params: Optional[Params] = None) -> Params:
        """The whole parameter tree, each leaf all-gathered from its
        shards (for tests, checkpoints and serving); ``params()`` itself
        without a mesh."""
        params = self.params() if params is None else params
        if self.mesh is None:
            return params

        return unflatten({
            name: sharding.gather_full(t.detach(), self.specs[name],
                                       self.mesh)
            for name, t in flatten(params).items()})

    def _use(self, name: str, t: torch.Tensor, layer: bool = False
             ) -> torch.Tensor:
        """Leaf ``name`` as the math uses it: its fsdp-split dims
        all-gathered (a layer's slice drops the leading layer dim)."""
        for d, axes in self._gathers.get(name, ()):
            t = sharding.gather_on_use(t, d - 1 if layer else d, self.mesh,
                                       axes)
        return t

    def _tp_in(self, h: torch.Tensor) -> torch.Tensor:
        """Into a column-parallel product over tp."""
        return sharding.copy_to(h, self.mesh, self._tp)

    def _tp_out(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a row-parallel product over tp: the partial sums."""
        return sharding.reduce_from(y, self.mesh, self._tp)

    # -- block math -------------------------------------------------------------
    def _qkv(self, lp: Params, x: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, positions: torch.Tensor,
             tag: Optional[Callable] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pre-attention norm + QKV projections + rotary. ``tag(name,
        t)`` marks the results for a selective remat policy ('q_rot',
        'k_rot', 'v_proj', as the JAX ``checkpoint_name``s)."""
        c = self.config
        b, s, e = x.shape
        h = self._tp_in(rms_norm(x, lp['attn_norm'], c.norm_eps))
        # Heads per rank: all of them, or Hq/tp and Hkv/tp on a mesh.
        q = (h @ lp['wq'].reshape(e, -1)).view(b, s, -1, c.head_dim)
        k = (h @ lp['wk'].reshape(e, -1)).view(b, s, -1, c.head_dim)
        v = (h @ lp['wv'].reshape(e, -1)).view(b, s, -1, c.head_dim)
        q = apply_rotary(q, cos, sin, positions)
        k = apply_rotary(k, cos, sin, positions)
        if tag is None:
            return q, k, v
        return tag('q_rot', q), tag('k_rot', k), tag('v_proj', v)

    def _attn_out(self, lp: Params, attn: torch.Tensor) -> torch.Tensor:
        """[B, S, H, D] attention context -> [B, S, E] through wo."""
        b, s = attn.shape[:2]
        return self._tp_out(attn.reshape(b, s, -1) @ lp['wo'].reshape(
            -1, self.config.embed_dim))

    def _mlp_delta(self, lp: Params, x: torch.Tensor,
                   tag: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, Aux]:
        """Post-attention SwiGLU feed-forward -> (delta, aux loss); the
        aux loss of this dense feed-forward is 0.0 (a float, so that the
        decode path makes no tensor for it). ``tag`` marks
        silu(gate) * up as 'mlp_gated'."""
        h = self._tp_in(rms_norm(x, lp['mlp_norm'], self.config.norm_eps))
        gate = h @ lp['w_gate']
        up = h @ lp['w_up']
        gated = torch.nn.functional.silu(gate) * up
        if tag is not None:
            gated = tag('mlp_gated', gated)
        return self._tp_out(gated @ lp['w_down']), 0.0

    def _head(self, params: Params) -> torch.Tensor:
        """[E, V] (or this rank's [E, V/tp] on a mesh)."""
        if self.config.tie_embeddings:
            return self._use('embed', params['embed']).T
        return self._use('lm_head', params['lm_head'])

    @staticmethod
    def layer_params(params: Params, i: int) -> Params:
        return {name: t[i] for name, t in params['layers'].items()}

    # -- forward ------------------------------------------------------------
    @torch.no_grad()
    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              force_impl: Optional[str] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] (f32). ``force_impl`` picks
        the attention implementation (ops/attention.py names). On a mesh:
        ``apply_with_aux``'s logits (this rank's rows and vocab shard)."""
        if self.mesh is not None:
            return self.apply_with_aux(params, tokens, positions,
                                       force_impl)[0]
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
            x = x + self._mlp_delta(lp, x)[0]
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

        aux is the mean over layers of each layer's feed-forward aux loss:
        0 for this dense model, the router's load-balance loss for an MoE
        one (the Trainer adds ``aux_loss_weight * aux``). Each layer's aux
        is an output of its checkpointed function, so the remat policies
        recompute it with the rest. Each stacked ``[L, ...]`` parameter is
        split with one ``unbind`` per call, whose backward is one
        ``stack``, so no layer allocates a full-size zero gradient.

        On a mesh, ``tokens`` are this rank's rows and sequence block
        [B/batch, S/seq] and the logits are [B/batch, S/seq, V/tp]: this
        rank's vocab shard. Default positions are the block's global
        ones. With sp > 1 attention is the ring over the sequence axes;
        with pp > 1 the layers run as pipeline stages
        (``_apply_pipelined``)."""
        c = self.config
        dev = tokens.device
        seq_axes = (self.mesh.live(self.rules.axes('seq'))
                    if self.mesh is not None else ())
        if positions is None:
            s_local = tokens.shape[1]
            start = self.mesh.index(seq_axes) * s_local if seq_axes else 0
            positions = start + torch.arange(s_local, device=dev)
        cos, sin = precompute_rotary(c.head_dim, c.max_seq_len,
                                     c.rope_theta, device=dev)

        def attend(q, k, v):
            if seq_axes:
                return ring_attention(q, k, v, self.mesh, seq_axes,
                                      causal=True)
            return attention_ops.attention(q, k, v, causal=True,
                                           force_impl=force_impl)

        names = list(params['layers'])

        def layer(x, *values, tag=None):
            lp = {name: self._use(f'layers/{name}', value, layer=True)
                  for name, value in zip(names, values)}
            q, k, v = self._qkv(lp, x, cos, sin, positions, tag)
            attn = attend(q, k, v)
            if tag is not None:
                attn = tag('attn_out', attn)
            x = x + self._attn_out(lp, attn)
            delta, aux = self._mlp_delta(lp, x, tag)
            return x + delta, aux

        layer = _maybe_remat(layer, c)

        def stack(x, layers):
            """The layers of ``layers`` ([n, ...] leaves) in turn -> (x,
            the sum of their aux)."""
            values = [layers[name].unbind(0) for name in names]
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(len(values[0])):
                x, layer_aux = layer(x, *(v[i] for v in values))
                aux = aux + layer_aux
            return x, aux

        x = embed_lookup(params['embed'], tokens, self.mesh,
                         self.rules).to(c.dtype)
        if self.mesh is not None and self.mesh.shape['pp'] > 1:
            x, aux = self._apply_pipelined(params['layers'], x, stack)
        else:
            x, aux = stack(x, params['layers'])
            aux = aux / c.num_layers
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        # f32 operands: f32-accurate logits, as ``apply`` (on a mesh the
        # tp all-reduce of x's gradient is in f32 too).
        logits = self._tp_in(x.float()) @ self._head(params).float()
        return logits, aux

    def _apply_pipelined(self, layers: Params, x: torch.Tensor,
                         stack: Callable) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """The layer stack as ``pp`` pipeline stages (JAX
        ``_apply_pipelined``): this rank's ``[L/pp, ...]`` layers are its
        stage, run by ``stack`` on each microbatch (remat per layer, as
        on one device). x is replicated over pp and enters stage 0 only,
        so it passes ``copy_to`` (every pp rank gets its whole gradient).
        aux: the stage means, summed over the live ticks and pp and
        divided by the microbatches (``pipeline``), then by pp: the mean
        over layers."""
        pp = self.mesh.shape['pp']

        def stage_fn(local, h):
            h, aux = stack(h, local)
            return h, aux / (self.config.num_layers // pp)

        x = sharding.copy_to(x, self.mesh, 'pp')
        out, aux = pipeline(stage_fn, layers, x, mesh=self.mesh, axis='pp',
                            num_microbatches=self.config.pp_microbatches,
                            with_aux=True)
        return out, aux / pp

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
        and decode (T = 1) share the one code path. One device only."""
        if self.mesh is not None:
            raise NotImplementedError('decoding on a mesh is not ported')
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
            x = x + self._mlp_delta(lp, x)[0]
        x = rms_norm(x, params['final_norm'], c.norm_eps)
        logits = x[:, -1].float() @ self._head(params).float()
        return logits, {'k': torch.stack(new_k), 'v': torch.stack(new_v),
                        'length': start + t}


# -- rematerialisation --------------------------------------------------------

# Activations a selective policy can keep, by the JAX package's
# ``checkpoint_name``s: 'flash_out' and 'flash_lse' are K1's two outputs
# (``skytpu::flash_fwd``); the others pass through ``skytpu::tag``.
REMAT_NAMES = ('q_rot', 'k_rot', 'v_proj', 'attn_out', 'mlp_gated',
               'flash_out', 'flash_lse')
# policy -> (kept on the device, offloaded to pinned host memory).
NAMED_POLICIES: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    'names': (('attn_out', 'mlp_gated', 'flash_out', 'flash_lse'), ()),
    'names_qkv': (('attn_out', 'mlp_gated', 'flash_out', 'flash_lse',
                   'q_rot', 'k_rot', 'v_proj'), ()),
    'names_offload': (('flash_out', 'flash_lse'),
                      ('attn_out', 'mlp_gated')),
}
# One side stream per device for the copies to pinned host memory.
_OFFLOAD_STREAMS: Dict[torch.device, 'torch.cuda.Stream'] = {}


def _offload_stream(device: torch.device) -> 'torch.cuda.Stream':
    if device not in _OFFLOAD_STREAMS:
        _OFFLOAD_STREAMS[device] = torch.cuda.Stream(device)
    return _OFFLOAD_STREAMS[device]


@torch.library.custom_op('skytpu::tag', mutates_args=())
def _tag_op(x: torch.Tensor, name: str) -> torch.Tensor:
    """A named copy of ``x``: the op a selective-checkpoint policy keeps
    by name. A custom op may not return its input, so the name costs
    one copy of the tensor in the forward (none in the recompute, which
    takes the kept copy)."""
    return x.clone()


@_tag_op.register_fake
def _tag_fake(x, name):
    return torch.empty_like(x)


def _pass_grad(ctx, grad):
    return grad, None


_tag_op.register_autograd(_pass_grad)


@torch.library.custom_op('skytpu::to_host', mutates_args=())
def _to_host_op(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` copied to pinned host memory (a plain copy for a CPU
    tensor). The copy runs on the offload stream, so the forward goes on
    while it drains; ``x`` stays allocated until it has."""
    if not x.is_cuda:
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, device='cpu', pin_memory=True)
    stream = _offload_stream(x.device)
    stream.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(stream):
        out.copy_(x, non_blocking=True)
    x.record_stream(stream)
    return out


@_to_host_op.register_fake
def _to_host_fake(x, name):
    return torch.empty_like(x, device='cpu')


@torch.library.custom_op('skytpu::from_host', mutates_args=())
def _from_host_op(host: torch.Tensor, x: torch.Tensor,
                  recompute: bool) -> torch.Tensor:
    """The offloaded activation on ``x``'s device. In the forward it is a
    copy of ``x`` on the device, as ``skytpu::tag`` makes. In the
    recompute it is ``host`` copied back once the offload copies queued
    before it have drained. The forward and the recompute must run the
    same ops for the selective checkpoint, so one op does both."""
    if not recompute:
        return x.clone()
    if x.is_cuda:
        torch.cuda.current_stream(x.device).wait_stream(
            _offload_stream(x.device))
    return host.to(x.device, non_blocking=True, copy=True)


@_from_host_op.register_fake
def _from_host_fake(host, x, recompute):
    return torch.empty_like(x)


class _Offload(torch.autograd.Function):
    """y = x, with x copied once to pinned host memory. The policy keeps
    only the host copy (``skytpu::to_host``): the forward goes on with x
    on the device, and the backward's recompute takes y from the host
    (``skytpu::from_host``). The gradient passes straight through on the
    device."""

    @staticmethod
    def forward(ctx, x, name: str, recompute: bool):
        host = torch.ops.skytpu.to_host(x, name)
        return torch.ops.skytpu.from_host(host, x, recompute)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Tagger:
    """``tag(name, t)`` for one checkpointed layer call under a named
    policy. The checkpoint runs the layer twice, forward and then the
    backward's recompute, and an offloaded name takes its value from the
    host only in the second."""

    def __init__(self, policy: str):
        self.offloaded = NAMED_POLICIES[policy][1]
        self.recompute = False

    def __call__(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if name in self.offloaded:
            return _Offload.apply(t, name, self.recompute)
        return torch.ops.skytpu.tag(t, name)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep what JAX's 'dots' policy keeps: outputs of matmuls with no
    batch dims (aten.mm; a [b, s, e] @ [e, n] product lowers to one) and
    the flash forward's out and lse; recompute everything else. On an
    MoE layer that keeps the router product (an mm) and not the expert
    products, whose expert dim is a batch dim (aten.bmm), as
    ``dots_with_no_batch_dims_saveable`` does. JAX also keeps its
    dispatch and combine einsums (no batch dims); here they are a copy
    and a weighted sum, recomputed (ops/moe.py). On a tp mesh JAX keeps
    a row-parallel einsum's whole result, after GSPMD's all-reduce; here
    the all-reduce's output is kept too, so the recompute runs no
    collective but the fsdp gathers (which JAX recomputes as well)."""
    del ctx, args, kwargs
    if op in (torch.ops.aten.mm.default,
              torch.ops.skytpu.flash_fwd.default,
              torch.ops._c10d_functional.all_reduce.default,
              torch.ops._c10d_functional.wait_tensor.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return torch_checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _names_context(policy: str):
    """A selective-checkpoint context that keeps the outputs of K1 and of
    the ``skytpu::tag`` ops whose name the policy lists, and the host
    copies of the names it offloads; everything else is recomputed.
    Unlike XLA, the recompute also reruns the ops that produced a kept
    tensor (it takes the kept value in their place)."""
    kept, _ = NAMED_POLICIES[policy]

    def keep(ctx, op, *args, **kwargs):
        del ctx, kwargs
        if op is torch.ops.skytpu.flash_fwd.default:
            save = 'flash_out' in kept
        elif op is torch.ops.skytpu.tag.default:
            save = args[1] in kept
        else:
            save = op is torch.ops.skytpu.to_host.default
        return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if save
                else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)
    return torch_checkpoint.create_selective_checkpoint_contexts(keep)


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
    if policy in NAMED_POLICIES:
        def run(*args):
            tag = _Tagger(policy)

            def body(*args):
                out = layer_fn(*args, tag=tag)
                tag.recompute = True  # the next call is the recompute
                return out
            return torch_checkpoint.checkpoint(
                body, *args, use_reentrant=False,
                context_fn=functools.partial(_names_context, policy))
        return run
    raise ValueError(
        f'unknown remat_policy {policy!r}; expected one of \'full\', '
        "'dots', 'names', 'names_qkv', 'names_offload'")
