"""Forward pass of the Mistral-7B / Mixtral-8x7B block in float32.

Pre-norm decoder: RMSNorm, GQA attention with rotary embeddings (the two
halves of each head rotate as pairs, as the published models' rotate-half),
causal; RMSNorm and a SwiGLU feed-forward, or for Mixtral a router whose
softmax picks the top-k experts, their gates renormalised to sum to 1
(the router's input and gates rounded to bf16, the model's dtype).
Untied head. The sequences run one at a time, layer by layer, with each
layer's weights drawn afresh from the seed, so the whole model never has
to be held in f32.

``lowp='fp8'`` is the lower-precision control: every matrix product takes
its inputs rounded to float8 e4m3 (activations per row, weights per
output column, each scaled to its absolute maximum).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from perfbench import weights

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 at its scale; a gradient passes straight through
    (the products' inputs are fp8, the gradients stay f32)."""
    with torch.no_grad():
        scale = (x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
                 / FP8_MAX)
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


def mm(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    if lowp == 'fp8':
        return _fp8(x, -1) @ _fp8(w, -2)
    if lowp is not None:
        raise ValueError(f'unknown precision {lowp!r}')
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float
           ) -> torch.Tensor:
    """x [T, H, D] rotated by position: pairs (i, i + D/2)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = positions.double()[:, None] * inv[None]
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """q [T, H, D], k/v [T, KVH, D] -> [T, H, D], in query blocks."""
    t, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)   # [H, T, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, t, block):
        e = min(t, s + block)
        qb = q[s:e].transpose(0, 1)                          # [H, b, D]
        scores = (qb @ k[:, :e].transpose(1, 2)) * d ** -0.5
        mask = (torch.arange(e, device=q.device)[None, :]
                <= torch.arange(s, e, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, float('-inf'))
        out[s:e] = (torch.softmax(scores, -1) @ v[:, :e]).transpose(0, 1)
    return out


def attention_block(x: torch.Tensor, w: Dict[str, torch.Tensor],
                    dims: Dict[str, int], cfg: Dict,
                    lowp: Optional[str]) -> torch.Tensor:
    t = x.shape[0]
    h, kvh, d = dims['h'], dims['kvh'], dims['d']
    hn = rms_norm(x, w['attn_norm'], cfg['rms_norm_eps'])
    pos = torch.arange(t, device=x.device)
    q = rotary(mm(hn, w['wq'], lowp).view(t, h, d), pos, cfg['rope_theta'])
    k = rotary(mm(hn, w['wk'], lowp).view(t, kvh, d), pos,
               cfg['rope_theta'])
    v = mm(hn, w['wv'], lowp).view(t, kvh, d)
    return x + mm(causal_attention(q, k, v).reshape(t, h * d), w['wo'], lowp)


def swiglu(x, gate, up, down, lowp):
    return mm(torch.nn.functional.silu(mm(x, gate, lowp)) * mm(x, up, lowp),
              down, lowp)


def ffn_block(x: torch.Tensor, w: Dict[str, torch.Tensor],
              dims: Dict[str, int], cfg: Dict,
              lowp: Optional[str]) -> torch.Tensor:
    hn = rms_norm(x, w['mlp_norm'], cfg['rms_norm_eps'])
    if not dims['experts']:
        return x + swiglu(hn, w['w_gate'], w['w_up'], w['w_down'], lowp)
    # The router reads its input rounded to bf16 and its gates are
    # rounded to bf16, as the configuration's dtype has them; its product
    # and softmax stay in f32.
    hr = hn.to(torch.bfloat16).float()
    probs = torch.softmax(mm(hr, w['router'], lowp), dim=-1)
    gate, idx = probs.topk(dims['top_k'], dim=-1)
    gate = (gate / gate.sum(-1, keepdim=True)).to(torch.bfloat16).float()
    y = torch.zeros_like(x)
    for e in range(dims['experts']):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = swiglu(hn[rows], w['we_gate'][e], w['we_up'][e],
                         w['we_down'][e], lowp)
            y.index_add_(0, rows, gate[rows, slot, None] * out)
    return x + y


@torch.no_grad()
def score_logits(seqs: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
                 cfg: Dict, dims: Dict[str, int], seed: int, device,
                 lowp_list: Sequence[Optional[str]] = (None,)
                 ) -> Dict[Optional[str], List[torch.Tensor]]:
    """Logits [len(rows_i), V] at the given positions of each sequence
    (token ids [T_i]), for each precision in ``lowp_list``; every layer's
    weights are drawn once and run over all sequences."""
    no_tf32()
    embed = weights.top_weight(seed, dims, 'embed', device)
    xs = {p: [embed[s.to(device)] for s in seqs] for p in lowp_list}
    del embed
    for i in range(dims['layers']):
        w = weights.layer_weights(seed, dims, i, device)
        for p in lowp_list:
            xs[p] = [ffn_block(attention_block(x, w, dims, cfg, p), w, dims,
                               cfg, p) for x in xs[p]]
        del w
    norm = weights.top_weight(seed, dims, 'final_norm', device)
    head = weights.top_weight(seed, dims, 'lm_head', device)
    out = {}
    for p in lowp_list:
        out[p] = [mm(rms_norm(x[r.to(device)], norm, cfg['rms_norm_eps']),
                     head, p) for x, r in zip(xs[p], rows)]
    return out
