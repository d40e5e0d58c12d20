"""Three training steps of a dense configuration in float32.

The loss is the mean next-token cross entropy over every position of
the batch, the targets the tokens rolled left by one (as the trainer
under test builds them). The gradient is clipped to a global norm of 1.0,
then AdamW (b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay 0.1)
updates every leaf. All arithmetic is f32; the parameters are stored in
bf16 between steps, the type the configuration states, so a step that
moves a weight by less than half its bf16 spacing leaves it where it
was, here as in a bf16 trainer. Each layer is recomputed in the backward
(and each attention block within it), so the pass fits beside its f32
optimizer state.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from perfbench import weights
from perfbench.reference import model as ref

B1, B2, EPS, WD, MAX_NORM = 0.9, 0.95, 1e-8, 0.1, 1.0


def leaf_list(dims: Dict[str, int]) -> List[Tuple[str, Optional[int]]]:
    """(name, layer) of every leaf, in a fixed order."""
    out = [('embed', None), ('final_norm', None), ('lm_head', None)]
    for i in range(dims['layers']):
        out += [(n, i) for n in weights.layer_leaves(dims)]
    return out


def init_params(dims, seed, device) -> Dict[Tuple[str, Optional[int]],
                                            torch.Tensor]:
    params = {}
    for name, layer in leaf_list(dims):
        if layer is None:
            shape, fan_in = weights.top_leaves(dims)[name]
        else:
            shape, fan_in = weights.layer_leaves(dims)[name]
        params[(name, layer)] = weights.draw(
            seed, name, layer, shape, fan_in, device).requires_grad_(True)
    return params


def _attn_rows(q, k, v, s, e):
    """Causal attention of query rows [s, e) of one sequence."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kk = k[:e].repeat_interleave(group, dim=1).transpose(0, 1)
    vv = v[:e].repeat_interleave(group, dim=1).transpose(0, 1)
    scores = (q[s:e].transpose(0, 1) @ kk.transpose(1, 2)) * d ** -0.5
    mask = (torch.arange(e, device=q.device)[None, :]
            <= torch.arange(s, e, device=q.device)[:, None])
    scores = scores.masked_fill(~mask, float('-inf'))
    return (torch.softmax(scores, -1) @ vv).transpose(0, 1)


def _layer(x, w, dims, cfg, lowp, block):
    """One block over x [B, T, e]; attention one query block at a time,
    each recomputed in the backward."""
    h, kvh, d = dims['h'], dims['kvh'], dims['d']
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    out = []
    for row in range(b):
        hn = ref.rms_norm(x[row], w['attn_norm'], cfg['rms_norm_eps'])
        q = ref.rotary(ref.mm(hn, w['wq'], lowp).view(t, h, d), pos,
                       cfg['rope_theta'])
        k = ref.rotary(ref.mm(hn, w['wk'], lowp).view(t, kvh, d), pos,
                       cfg['rope_theta'])
        v = ref.mm(hn, w['wv'], lowp).view(t, kvh, d)
        attn = torch.cat([checkpoint(_attn_rows, q, k, v, s,
                                     min(t, s + block), use_reentrant=False)
                          for s in range(0, t, block)])
        y = x[row] + ref.mm(attn.reshape(t, h * d), w['wo'], lowp)
        out.append(ref.ffn_block(y, w, dims, cfg, lowp))
    return torch.stack(out)


def loss_fn(params, tokens, dims, cfg, lowp=None, block=1024):
    x = params[('embed', None)][tokens]
    names = list(weights.layer_leaves(dims))
    for i in range(dims['layers']):
        w = {n: params[(n, i)] for n in names}
        x = checkpoint(functools.partial(_layer, dims=dims, cfg=cfg,
                                         lowp=lowp, block=block),
                       x, w, use_reentrant=False)
    x = ref.rms_norm(x, params[('final_norm', None)], cfg['rms_norm_eps'])
    logits = ref.mm(x, params[('lm_head', None)], lowp)
    targets = torch.roll(tokens, -1, dims=1)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def train_steps(dims, cfg, seed, batches, lr, device, lowp=None):
    """Run len(batches) steps from the seed's weights. Returns the loss of
    each step, each leaf's first clipped gradient norm, and each leaf's
    change after the last step (its norm), keyed (name, layer)."""
    ref.no_tf32()
    params = init_params(dims, seed, device)
    init_norms = {}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_norms = [], {}
    for step, tokens in enumerate(batches, start=1):
        loss = loss_fn(params, tokens.to(device), dims, cfg, lowp)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        total = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        divisor = max(1.0, float(total) / MAX_NORM)
        with torch.no_grad():
            for (key, p), g in zip(params.items(), grads):
                g = g / divisor
                if step == 1:
                    grad_norms[key] = float(torch.linalg.vector_norm(g))
                    init_norms[key] = p.detach().to(torch.bfloat16)
                m[key].mul_(B1).add_(g, alpha=1 - B1)
                v[key].mul_(B2).addcmul_(g, g, value=1 - B2)
                mhat = m[key] / (1 - B1 ** step)
                vhat = v[key] / (1 - B2 ** step)
                new = p * (1 - lr * WD) - lr * mhat / (vhat.sqrt() + EPS)
                # Stored in the configuration's type between steps.
                p.copy_(new.to(torch.bfloat16).float())
        del grads
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
            p.detach() - init_norms[k].float())) for k, p in params.items()}
    return {'loss': losses, 'grad': grad_norms, 'change': change}
