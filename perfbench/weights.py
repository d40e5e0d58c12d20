"""Weights made from the run's seed, one generator per leaf and layer.

Every leaf of every layer is drawn by its own generator, seeded from
(seed, leaf name, layer), on the device and in bf16, the type the
configurations are served and trained in. So the program and the
reference each draw any one layer alone and get the same bits. Matrices
are N(0, 1/fan_in) (the embedding N(0, 1)); norm weights are ones. A
Mixtral router is drawn in bf16 and held in f32, the rounding a replica
applies to its f32 router.

Shapes are the math's, ``x @ W`` with W [in, out]; a leaf the program
stacks over layers ([L, e, h, d]) holds each layer's draw in the same
element order.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Optional, Tuple

import torch

NORMS = ('attn_norm', 'mlp_norm')


def leaf_seed(seed: int, name: str, layer: Optional[int] = None) -> int:
    key = f'{int(seed)}/{name}/{"" if layer is None else int(layer)}'
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:8], 'little') & ((1 << 63) - 1)


def generator(seed: int, name: str, layer: Optional[int],
              device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name, layer))
    return gen


def layer_leaves(dims: Dict[str, int]) -> Dict[str, Tuple[Tuple[int, ...],
                                                          Optional[int]]]:
    """name -> (shape, fan_in) of one layer's leaves; fan_in None marks a
    norm weight."""
    e, h, kvh, d, m = (dims[k] for k in ('e', 'h', 'kvh', 'd', 'm'))
    leaves = {
        'attn_norm': ((e,), None), 'mlp_norm': ((e,), None),
        'wq': ((e, h * d), e), 'wk': ((e, kvh * d), e),
        'wv': ((e, kvh * d), e), 'wo': ((h * d, e), h * d),
    }
    if dims['experts']:
        n = dims['experts']
        leaves.update({'router': ((e, n), e),
                       'we_gate': ((n, e, m), e), 'we_up': ((n, e, m), e),
                       'we_down': ((n, m, e), m)})
    else:
        leaves.update({'w_gate': ((e, m), e), 'w_up': ((e, m), e),
                       'w_down': ((m, e), m)})
    return leaves


def top_leaves(dims: Dict[str, int]):
    e, v = dims['e'], dims['v']
    return {'embed': ((v, e), 1), 'final_norm': ((e,), None),
            'lm_head': ((e, v), e)}


@torch.no_grad()
def draw_into(out: torch.Tensor, seed: int, name: str,
              layer: Optional[int], fan_in: Optional[int]) -> torch.Tensor:
    """Fill ``out`` (any float dtype; drawn in bf16) with the leaf's
    values, in place."""
    if fan_in is None:
        return out.fill_(1.0)
    gen = generator(seed, name, layer, out.device)
    if out.dtype == torch.bfloat16 and out.is_contiguous():
        return out.normal_(0.0, fan_in ** -0.5, generator=gen)
    tmp = torch.empty(out.shape, dtype=torch.bfloat16, device=out.device)
    tmp.normal_(0.0, fan_in ** -0.5, generator=gen)
    return out.copy_(tmp)


def draw(seed: int, name: str, layer: Optional[int], shape, fan_in,
         device, dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.bfloat16, device=device)
    draw_into(out, seed, name, layer, fan_in)
    return out.to(dtype)


def layer_weights(seed: int, dims: Dict[str, int], layer: int, device,
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {name: draw(seed, name, layer, shape, fan_in, device, dtype)
            for name, (shape, fan_in) in layer_leaves(dims).items()}


def top_weight(seed: int, dims: Dict[str, int], name: str, device,
               dtype=torch.float32) -> torch.Tensor:
    shape, fan_in = top_leaves(dims)[name]
    return draw(seed, name, None, shape, fan_in, device, dtype)


def program_leaves(params) -> Iterator[Tuple[str, Optional[int],
                                             torch.Tensor]]:
    """(name, layer or None, tensor) over a parameter tree named as the
    port names it (``LlamaModel.params()``), a layer at a time."""
    for name in ('embed', 'final_norm', 'lm_head'):
        if name in params:
            yield name, None, params[name]
    for name, stacked in params['layers'].items():
        for i in range(stacked.shape[0]):
            yield name, i, stacked[i]


@torch.no_grad()
def fill_program(params, dims: Dict[str, int], seed: int) -> None:
    """Draw every leaf of the program's parameter tree in place."""
    layer = layer_leaves(dims)
    top = top_leaves(dims)
    for name, i, t in program_leaves(params):
        shape, fan_in = (top if i is None else layer)[name]
        numel = 1
        for s in shape:
            numel *= s
        if t.numel() != numel:
            raise ValueError(f'{name}: the program holds {tuple(t.shape)}, '
                             f'the configuration asks for {shape}')
        draw_into(t, seed, name, i, fan_in)
