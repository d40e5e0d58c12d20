"""The system under test, built from a configuration file through the
port's public classes: ``LlamaModel`` / ``MixtralModel`` with their
parameters drawn from the seed (``perfbench.weights``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from perfbench import yardstick


def port_config(cfg: Dict, layers: int = None, **overrides):
    """The port's config object for a configuration file's published
    keys (its ``model`` says which family)."""
    from skypilot_tpu_torch.models import llama, mixtral
    dims = yardstick.model_dims(cfg)
    common = dict(
        vocab_size=dims['v'], embed_dim=dims['e'],
        num_layers=layers or dims['layers'], num_heads=dims['h'],
        num_kv_heads=dims['kvh'], head_dim=dims['d'], mlp_dim=dims['m'],
        max_seq_len=int(cfg['max_position_embeddings']),
        rope_theta=float(cfg['rope_theta']),
        norm_eps=float(cfg['rms_norm_eps']), dtype=torch.bfloat16,
        tie_embeddings=bool(cfg.get('tie_word_embeddings', False)))
    if dims['experts']:
        common.update(num_experts=dims['experts'], top_k=dims['top_k'],
                      capacity_factor=float(cfg['capacity_factor']),
                      router_aux_weight=float(
                          cfg.get('router_aux_loss_coef', 0.02)))
        config = mixtral.MixtralConfig(**common)
        cls = mixtral.MixtralModel
    else:
        config = llama.LlamaConfig(**common)
        cls = llama.LlamaModel
    return dataclasses.replace(config, **overrides), cls


def build(cfg: Dict, seed: int, device, layers: int = None,
          **overrides) -> Tuple[object, object, Dict[str, int]]:
    """(config, model with its weights drawn, dims as run)."""
    config, cls = port_config(cfg, layers, **overrides)
    model = cls(config, device=device)
    dims = dict(yardstick.model_dims(cfg), layers=config.num_layers)
    from perfbench import weights
    weights.fill_program(model.params(), dims, seed)
    return config, model, dims
