"""Mixtral-family sparse-MoE decoder (PyTorch counterpart of
``skypilot_tpu/models/mixtral.py``).

The Llama block (GQA + RoPE + RMSNorm) with the SwiGLU feed-forward
swapped for a top-k routed mixture of experts (``ops/moe.py``). The
layer parameters are the JAX tree's: ``router [L, e, E]`` in f32 (routing
decisions stay stable), ``we_gate``/``we_up [L, E, e, m]`` and
``we_down [L, E, m, e]`` in the config dtype, in place of Llama's
``w_gate``/``w_up``/``w_down``. The decode engine serves it through its
``model=`` hook and the trainer trains it with the router's aux loss.
On a mesh the experts are split over ``ep`` (``logical_axes``, as JAX's
rules lay them out) and each layer routes the global batch
(``ops/moe.py`` ``MoeMesh``). Architecture constants follow the public
Mixtral-8x7B config (32 layers, 8 experts, top-2, 14336 ffn dim).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.models.llama import (LlamaConfig, LlamaModel, Params,
                                             logical_axes as llama_axes,
                                             param_shapes as llama_shapes)
from skypilot_tpu_torch.ops.layers import rms_norm
from skypilot_tpu_torch.ops.moe import MoeMesh, moe_ffn


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02

    @property
    def num_params(self) -> int:
        e, l, v = self.embed_dim, self.num_layers, self.vocab_size
        qkv = e * self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
        o = self.num_heads * self.head_dim * e
        moe = self.num_experts * 3 * e * self.mlp_dim + e * self.num_experts
        per_layer = qkv + o + moe + 2 * e
        head = 0 if self.tie_embeddings else e * v
        return v * e + l * per_layer + e + head

    @property
    def flops_params(self) -> int:
        return self.active_params

    @property
    def active_params(self) -> int:
        """Params touched per token (the top-k experts): the count the
        trainer's MFU uses."""
        e, l, v = self.embed_dim, self.num_layers, self.vocab_size
        qkv = e * self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
        o = self.num_heads * self.head_dim * e
        moe = self.top_k * 3 * e * self.mlp_dim + e * self.num_experts
        per_layer = qkv + o + moe + 2 * e
        head = 0 if self.tie_embeddings else e * v
        return v * e + l * per_layer + e + head


PRESETS: Dict[str, MixtralConfig] = {
    'test-tiny-moe': MixtralConfig(vocab_size=256, embed_dim=64, num_layers=2,
                                   num_heads=4, num_kv_heads=2, head_dim=16,
                                   mlp_dim=128, max_seq_len=512,
                                   dtype=torch.float32, remat=False,
                                   num_experts=4, top_k=2,
                                   capacity_factor=4.0),
    'mixtral-8x7b': MixtralConfig(vocab_size=32000, embed_dim=4096,
                                  num_layers=32, num_heads=32, num_kv_heads=8,
                                  head_dim=128, mlp_dim=14336,
                                  max_seq_len=32768, rope_theta=1e6,
                                  num_experts=8, top_k=2),
}


def param_shapes(config: MixtralConfig) -> Params:
    """Llama's ``param_shapes`` with the dense feed-forward replaced by
    the router and the expert-stacked weights (same fan-ins as the JAX
    init)."""
    c = config
    l, e, m, ne = c.num_layers, c.embed_dim, c.mlp_dim, c.num_experts
    shapes = llama_shapes(config)
    for name in ('w_gate', 'w_up', 'w_down'):
        shapes['layers'].pop(name)
    shapes['layers'].update({
        'router': ((l, e, ne), e),
        'we_gate': ((l, ne, e, m), e),
        'we_up': ((l, ne, e, m), e),
        'we_down': ((l, ne, m, e), m),
    })
    return shapes


def logical_axes(config: MixtralConfig) -> Params:
    """Llama's ``logical_axes`` with the router's and the experts' in
    place of the dense feed-forward's (JAX's ``logical_axes``): experts
    over 'expert', their embed dim over 'embed', their mlp dim over
    'mlp'."""
    axes = llama_axes(config)
    for name in ('w_gate', 'w_up', 'w_down'):
        axes['layers'].pop(name)
    axes['layers'].update({
        'router': ('layers', 'embed', None),
        'we_gate': ('layers', 'expert', 'embed', 'mlp'),
        'we_up': ('layers', 'expert', 'embed', 'mlp'),
        'we_down': ('layers', 'expert', 'mlp', 'embed'),
    })
    return axes


class MixtralModel(LlamaModel):
    """Llama block stack with a routed-MoE feed-forward."""

    config: MixtralConfig
    F32_PARAMS = ('router',)

    def __init__(self, config: MixtralConfig, device=None, mesh=None,
                 **kwargs):
        super().__init__(config, device, mesh, **kwargs)
        self._moe = None
        if self.mesh is not None:
            m, rules = self.mesh, self.rules
            self._moe = MoeMesh(m, m.live(rules.axes('batch')),
                                m.live(rules.axes('seq')),
                                m.live(rules.axes('expert')), self._tp)
            # A group over several axes is made by every rank together:
            # make the layer's now, not inside a pipeline stage's tick.
            if m.device_mesh is not None:
                for axes in (self._moe.token_axes, self._moe.region_axes):
                    if len(axes) > 1:
                        m.group(axes)

    def logical_axes(self) -> Params:
        return logical_axes(self.config)

    @property
    def aux_loss_weight(self) -> float:
        return self.config.router_aux_weight

    def _param_shapes(self) -> Params:
        return param_shapes(self.config)

    def _mlp_delta(self, lp: Params, x: torch.Tensor,
                   tag: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Post-attention MoE feed-forward -> (delta, router aux loss).
        JAX's ``moe_ffn`` names no activation, so no tag is set here: the
        named remat policies keep only the attention's tensors."""
        del tag
        c = self.config
        h = rms_norm(x, lp['mlp_norm'], c.norm_eps)
        y, aux = moe_ffn(h, lp['router'], lp['we_gate'], lp['we_up'],
                         lp['we_down'], top_k=c.top_k,
                         capacity_factor=c.capacity_factor, on=self._moe)
        return y, aux['aux_loss']
