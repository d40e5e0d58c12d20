"""The plain references against a forward written out by hand, and the
reference AdamW against torch's."""
import math

import pytest
import torch

from perfbench import weights, yardstick
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

CFG = {'hidden_size': 8, 'intermediate_size': 12, 'num_attention_heads': 2,
       'num_key_value_heads': 1, 'head_dim': 4, 'num_hidden_layers': 1,
       'vocab_size': 16, 'rms_norm_eps': 1e-5, 'rope_theta': 100.0,
       'max_position_embeddings': 64}


def _by_hand(tokens, dims, seed, moe=False):
    """One layer, each position computed alone with Python loops."""
    e, h, d = dims['e'], dims['h'], dims['d']
    w = weights.layer_weights(seed, dims, 0, 'cpu')
    emb = weights.top_weight(seed, dims, 'embed', 'cpu')
    head = weights.top_weight(seed, dims, 'lm_head', 'cpu')

    def norm(x):
        return x / math.sqrt(float((x * x).mean()) + 1e-5)

    def rot(v, p):
        half = d // 2
        out = v.clone()
        for i in range(half):
            ang = p / 100.0 ** (2 * i / d)
            c, s = math.cos(ang), math.sin(ang)
            out[i] = v[i] * c - v[i + half] * s
            out[i + half] = v[i + half] * c + v[i] * s
        return out

    xs = [emb[t].clone() for t in tokens]
    hs = [norm(x) for x in xs]
    qs = [(hn @ w['wq']).view(h, d) for hn in hs]
    ks = [rot((hn @ w['wk']).view(d), p) for p, hn in enumerate(hs)]
    vs = [(hn @ w['wv']).view(d) for hn in hs]
    out = []
    for p, x in enumerate(xs):
        ctx = []
        for head_i in range(h):
            q = rot(qs[p][head_i], p)
            sc = torch.tensor([float(q @ ks[j]) / math.sqrt(d)
                               for j in range(p + 1)])
            pr = torch.softmax(sc, 0)
            ctx.append(sum(pr[j] * vs[j] for j in range(p + 1)))
        y = x + torch.cat(ctx) @ w['wo']
        hn = norm(y)
        if moe:
            # The router's input and gates in bf16, as the model's dtype.
            hr = hn.to(torch.bfloat16).float()
            probs = torch.softmax(hr @ w['router'], 0)
            top = sorted(range(len(probs)), key=lambda i: -float(probs[i]))
            top = top[:dims['top_k']]
            z = sum(float(probs[i]) for i in top)

            def gate(i):
                return float(torch.tensor(float(probs[i]) / z,
                                          dtype=torch.bfloat16))
            ffn = sum(gate(i) * (
                torch.nn.functional.silu(hn @ w['we_gate'][i])
                * (hn @ w['we_up'][i])) @ w['we_down'][i] for i in top)
        else:
            ffn = (torch.nn.functional.silu(hn @ w['w_gate'])
                   * (hn @ w['w_up'])) @ w['w_down']
        out.append(norm(y + ffn) @ head)
    return torch.stack(out)


@pytest.mark.parametrize('moe', [False, True])
def test_forward_matches_hand_built(moe):
    cfg = dict(CFG, num_local_experts=3, num_experts_per_tok=2) if moe \
        else CFG
    dims = yardstick.model_dims(cfg)
    tokens = [3, 1, 4, 1, 5, 9, 2]
    got = ref.score_logits([torch.tensor(tokens)], [torch.arange(7)], cfg,
                           dims, 11, 'cpu')[None][0]
    want = _by_hand(tokens, dims, 11, moe)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fp8_control_moves_the_logits():
    dims = yardstick.model_dims(CFG)
    out = ref.score_logits([torch.tensor([1, 2, 3, 4])], [torch.arange(4)],
                           CFG, dims, 5, 'cpu', (None, 'fp8'))
    diff = (out[None][0] - out['fp8'][0]).abs().max()
    assert 1e-3 < float(diff) < 1.0


def test_adamw_step_matches_torch():
    """One step of the reference's update on a lone f32 leaf against
    torch.optim.AdamW (bf16 storage off: a leaf of bf16 values and a
    step that lands on bf16 values)."""
    torch.manual_seed(0)
    p = torch.randn(64).to(torch.bfloat16).float()
    g = torch.randn(64)
    lr = 0.25
    q = p.clone().requires_grad_(True)
    opt = torch.optim.AdamW([q], lr=lr, betas=(ref_train.B1, ref_train.B2),
                            eps=ref_train.EPS, weight_decay=ref_train.WD)
    q.grad = g.clone()
    opt.step()
    m = (1 - ref_train.B1) * g
    v = (1 - ref_train.B2) * g * g
    new = p * (1 - lr * ref_train.WD) - lr * (m / (1 - ref_train.B1)) / (
        (v / (1 - ref_train.B2)).sqrt() + ref_train.EPS)
    torch.testing.assert_close(new, q.detach())


def test_train_reference_loss_is_the_mean_cross_entropy():
    dims = yardstick.model_dims(CFG)
    params = ref_train.init_params(dims, 3, 'cpu')
    tokens = torch.tensor([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]])
    loss = ref_train.loss_fn(params, tokens, dims, CFG, block=2)
    logits = torch.stack([ref.score_logits([t], [torch.arange(6)], CFG, dims,
                                           3, 'cpu')[None][0]
                          for t in tokens])
    targets = torch.roll(tokens, -1, dims=1)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 16),
                                             targets.reshape(-1))
    torch.testing.assert_close(loss.detach(), want, rtol=1e-5, atol=1e-5)
