"""The port's flash-attention backward (K2's plain version) and the
autograd function that joins K1 and K2, against the JAX package.

Inputs are made with numpy from a seed and handed to both sides. The
port's ``flash_attention_bwd`` on CPU tensors (its plain version, what
the wrapper runs off the card) is held against the Pallas TPU kernel
``_flash_attention_bwd_tpu`` run in interpret mode, as the JAX package's
own tests run it on the CPU; gradients through ``attention(...,
force_impl='flash')`` are held against ``jax.grad`` of the JAX
``attention(..., force_impl='flash')`` (its custom_vjp) in interpret mode.
f32 everywhere, where the point is the algorithm: tolerances are f32
round-off (sums taken in another order), 1e-5 unless stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu_torch.ops import attention as torch_attention

TOL = 1e-5

# (head_dim, causal, sq, sk, hq, hkv): d 64 and 128, causal and not,
# sq < sk (queries at the end of the keys), GQA. The shapes of
# tests/test_torch_attention.py's forward cases.
FLASH_CASES = [
    (64, True, 32, 32, 4, 4),
    (64, False, 24, 40, 4, 2),
    (128, True, 16, 48, 4, 2),
    (128, False, 32, 32, 2, 2),
    (128, True, 40, 40, 8, 2),
]


def _arrays(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    g = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    return q, k, v, g


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('d,causal,sq,sk,hq,hkv', FLASH_CASES)
def test_flash_bwd_matches_pallas_kernel(monkeypatch, d, causal, sq, sk, hq,
                                         hkv):
    """dq, dk, dv from the same q, k, v, out, lse and dO. JAX is handed
    the GQA-repeated KV, as its dispatcher does, so its dk/dv are per
    query head: they are summed over each KV head's group here, which the
    port does inside the function."""
    monkeypatch.setattr(jax_attention, '_INTERPRET', True)
    b = 2
    q, k, v, g = _arrays(d * 7 + sq + sk, b, sq, sk, hq, hkv, d)
    scale = d ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jk, jv = jax_attention._maybe_repeat_kv(jq, jk, jv)
    _, res = jax_attention._flash_attention_fwd_tpu(jq, jk, jv, causal,
                                                    scale)
    jdq, jdk, jdv = jax_attention._flash_attention_bwd_tpu(
        res, jnp.asarray(g), causal, scale)
    grp = hq // hkv

    def per_q_head(x, s):  # [b*hq, s, d] -> [b, s, hq, d]
        return np.array(x).reshape(b, hq, s, d).transpose(0, 2, 1, 3).copy()

    def per_kv_head(x, s):  # summed over each group -> [b, s, hkv, d]
        return per_q_head(x, s).reshape(b, s, hkv, grp, d).sum(3)

    out = torch.from_numpy(per_q_head(res[3], sq))
    lse = torch.from_numpy(np.array(res[4]).reshape(b, hq, sq))
    before = dict(torch_attention.LAUNCHES)
    dq, dk, dv = torch_attention.flash_attention_bwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), out,
        lse, torch.from_numpy(g), causal, scale)
    assert dq.shape == (b, sq, hq, d) and dk.shape == (b, sk, hkv, d)
    assert dv.shape == dk.shape and dq.dtype == torch.float32
    _close(dq, per_q_head(jdq, sq))
    _close(dk, per_kv_head(jdk, sk))
    _close(dv, per_kv_head(jdv, sk))
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert torch_attention.LAUNCHES == before


@pytest.mark.parametrize('d,causal,sq,sk,hq,hkv', FLASH_CASES[1:3])
def test_grads_through_the_autograd_function_match_jax(monkeypatch, d,
                                                       causal, sq, sk, hq,
                                                       hkv):
    """``attention(force_impl='flash')`` builds a graph through
    ``FlashAttention`` (forward K1's op, backward K2's op); its q/k/v
    grads equal ``jax.grad`` through the JAX custom_vjp."""
    monkeypatch.setattr(jax_attention, '_INTERPRET', True)
    q, k, v, g = _arrays(sq * sk + hq, 1, sq, sk, hq, hkv, d)
    scale = d ** -0.5

    def jax_loss(q_, k_, v_):
        out = jax_attention.attention(q_, k_, v_, causal=causal,
                                      scale=scale, force_impl='flash')
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = torch_attention.attention(tq, tk, tv, causal=causal, scale=scale,
                                    force_impl='flash')
    assert type(out.grad_fn).__name__ == 'FlashAttentionBackward'
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, w in zip(got, want):
        _close(a, w)


def test_flash_ops_have_fake_implementations():
    """``skytpu::flash_fwd`` and ``skytpu::flash_bwd`` run on fake
    tensors (shape and dtype only), as tracing and checkpoint policies
    need."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 8, 4, 16)
        k = torch.empty(2, 12, 2, 16)
        out, lse = torch.ops.skytpu.flash_fwd(q, k, k, True, 0.25)
        assert out.shape == q.shape and lse.shape == (2, 4, 8)
        assert lse.dtype == torch.float32
        dq, dk, dv = torch.ops.skytpu.flash_bwd(q, k, k, out, lse, out,
                                                True, 0.25)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_serving_calls_skip_the_autograd_function():
    """Without a gradient to take (serving runs under no_grad), flash
    attention is K1's op alone: no graph, nothing saved."""
    q, k, v, _ = _arrays(3, 1, 8, 8, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        out = torch_attention.attention(tq, tk, tv, force_impl='flash')
    assert out.grad_fn is None
    ref = torch_attention.mha_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v)))
    _close(out, ref)
