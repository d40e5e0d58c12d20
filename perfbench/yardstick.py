"""The benchmark's own arithmetic: published peaks, the operations and
bytes a model step and an attention call need, counted from the inputs.

Frozen here so that a change to the program cannot move the yardstick:
nothing below reads the program's buckets, padding or capacity slots.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def model_dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the counts below need, from a configuration file's
    published keys (``configs/<name>.json``)."""
    e = int(cfg['hidden_size'])
    h = int(cfg['num_attention_heads'])
    return {
        'e': e, 'h': h, 'kvh': int(cfg['num_key_value_heads']),
        'd': int(cfg.get('head_dim') or e // h),
        'm': int(cfg['intermediate_size']),
        'v': int(cfg['vocab_size']),
        'layers': int(cfg['num_hidden_layers']),
        'experts': int(cfg.get('num_local_experts') or 0),
        'top_k': int(cfg.get('num_experts_per_tok') or 0),
    }


def layer_matmul_params(dims: Dict[str, int]) -> int:
    """Weights one token multiplies with in one layer: q, k, v, o, and
    the SwiGLU feed-forward (the active experts' and the router's for a
    sparse model)."""
    e, h, kvh, d, m = (dims[k] for k in ('e', 'h', 'kvh', 'd', 'm'))
    attn = e * d * (h + 2 * kvh) + h * d * e
    if dims['experts']:
        ffn = dims['top_k'] * 3 * e * m + e * dims['experts']
    else:
        ffn = 3 * e * m
    return attn + ffn


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: the causal triangle of the
    last sq of sk positions, or all sq * sk."""
    if not causal:
        return sq * sk
    q_start = sk - sq
    # sum over i < sq of min(sk, q_start + i + 1)
    return sq * q_start + sq * (sq + 1) // 2


def attention_flops(dims: Dict[str, int], sq: int, sk: int,
                    causal: bool = True) -> float:
    """QK^T and PV of one layer: 4 * hq * d per visible pair."""
    return 4.0 * dims['h'] * dims['d'] * visible_pairs(sq, sk, causal)


def prefill_flops(dims: Dict[str, int], prompt_len: int) -> float:
    """A prompt's prefill: every layer for every prompt token, causal
    attention, and the head for the last token only."""
    t = prompt_len
    return (2.0 * t * layer_matmul_params(dims) * dims['layers']
            + dims['layers'] * attention_flops(dims, t, t)
            + 2.0 * dims['e'] * dims['v'])


def decode_token_flops(dims: Dict[str, int], position: int) -> float:
    """One generated token whose input sits at ``position`` (it attends
    to position + 1 keys), head included."""
    return (2.0 * layer_matmul_params(dims) * dims['layers']
            + dims['layers'] * attention_flops(dims, 1, position + 1, False)
            + 2.0 * dims['e'] * dims['v'])


def train_step_flops(dims: Dict[str, int], batch: int, seq: int) -> float:
    """A training step's model FLOPs: forward + backward = 3x the
    forward's products (layers and head; the embedding is a lookup),
    causal attention; recomputation is not counted."""
    fwd = (2.0 * batch * seq * (layer_matmul_params(dims) * dims['layers']
                                + dims['e'] * dims['v'])
           + batch * dims['layers'] * attention_flops(dims, seq, seq))
    return 3.0 * fwd


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def flash_fwd_bound_s(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                      causal: bool = True) -> float:
    """K1's least time: 4 * hq * d FLOPs per visible pair; q, k, v read
    and out written in bf16, lse written in f32, each byte once."""
    flops = 4.0 * b * hq * d * visible_pairs(sq, sk, causal)
    nbytes = b * (2.0 * d * (2 * sq * hq + 2 * sk * hkv) + 4.0 * hq * sq)
    return _bound_s(flops, nbytes)


def flash_bwd_bound_s(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                      causal: bool = True) -> float:
    """K2's least time: 10 * hq * d FLOPs per visible pair (five
    products); q, k, v, out, dO and lse read, dq, dk, dv written."""
    flops = 10.0 * b * hq * d * visible_pairs(sq, sk, causal)
    nbytes = b * (2.0 * d * (4 * sq * hq + 4 * sk * hkv) + 4.0 * hq * sq)
    return _bound_s(flops, nbytes)

