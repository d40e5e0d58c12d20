"""The flash-attention kernels (``csrc/flash_fwd.cu``, K1, and
``csrc/flash_bwd.cu``, K2) on the card.

These tests need an NVIDIA GPU with ``nvcc``: they carry the ``cuda``
marker and skip where there is none. On the GPU machine:

    python -m pytest tests/test_torch_flash_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine need not have.)

Inputs are bf16 from a seeded numpy generator. The kernel is held
against its plain PyTorch version on the same tensors: K1's out and K2's
dq, dk and dv with every (batch, 64-row tile, head) block's RMS error
within ``TILE_RTOL`` (1e-2) of that block's RMS
(``skypilot_tpu_torch/utils/compare.py``: bf16 results, P and dS rounded
to bf16 on both sides from sums taken in another order), and K1's lse
within 1e-3 (f32 row reductions in another order).
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import attention as torch_attention
from skypilot_tpu_torch.utils.compare import TILE_RTOL, tile_rel_err

LSE_TOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(device=device, dtype=torch.bfloat16)


# (b, sq, sk, hq, hkv, d, causal): ragged tile edges (one row short of
# and past the kernels' 128-row tiles, 1000), sq < sk with a prefix that
# is no tile multiple (193 x 1000), GQA, d 64 and 128, non-causal, and a
# long causal sequence whose late tiles hold values far below the early
# ones'.
CASES = [
    (1, 1, 1, 4, 4, 128, True),
    (2, 77, 77, 8, 2, 128, True),
    (1, 64, 200, 4, 1, 64, True),
    (2, 100, 129, 6, 3, 64, False),
    (1, 130, 130, 32, 8, 128, False),
    (1, 4096, 4096, 4, 2, 128, True),
    (1, 127, 127, 32, 8, 128, True),
    (1, 129, 129, 32, 8, 128, True),
    (1, 1000, 1000, 32, 8, 128, True),
    (1, 193, 1000, 32, 8, 128, True),
    (1, 300, 777, 32, 8, 128, False),
    (1, 200, 333, 16, 8, 64, True),
]


@pytest.mark.parametrize('b,sq,sk,hq,hkv,d,causal', CASES)
def test_kernel_matches_plain_version(cuda, b, sq, sk, hq, hkv, d, causal):
    rng = np.random.default_rng(sq * 1000 + sk)
    q = _bf16(rng, (b, sq, hq, d), cuda)
    k = _bf16(rng, (b, sk, hkv, d), cuda)
    v = _bf16(rng, (b, sk, hkv, d), cuda)
    before = torch_attention.LAUNCHES['flash_fwd']
    out, lse = torch_attention.flash_attention_fwd(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert torch_attention.LAUNCHES['flash_fwd'] == before + 1
    ref_out, ref_lse = torch_attention.flash_attention_fwd_reference(
        q, k, v, causal, d ** -0.5)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tile_rel_err(out, ref_out) <= TILE_RTOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as column slices of one fused [b, s, h, d] projection: the
    wrapper passes strides instead of copying."""
    rng = np.random.default_rng(0)
    qkv = _bf16(rng, (2, 96, 12, 64), cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out, lse = torch_attention.flash_attention_fwd(q, k, v, True, 0.125)
    ref_out, ref_lse = torch_attention.flash_attention_fwd_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), True, 0.125)
    assert tile_rel_err(out, ref_out) <= TILE_RTOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_kernels_read_views_of_a_fused_projection(cuda):
    """b 2, llama3-8b heads: q, k, v cut from one [b, s, hq + 2 hkv, d]
    tensor, forward and backward."""
    rng = np.random.default_rng(4)
    qkv = _bf16(rng, (2, 300, 48, 128), cuda)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    dout = _bf16(rng, (2, 300, 32, 128), cuda)
    scale = 128 ** -0.5
    out, lse = torch_attention.flash_attention_fwd(q, k, v, True, scale)
    ref_out, ref_lse = torch_attention.flash_attention_fwd_reference(
        q, k, v, True, scale)
    assert tile_rel_err(out, ref_out) <= TILE_RTOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    got = torch_attention.flash_attention_bwd(q, k, v, out, lse, dout, True,
                                              scale)
    _assert_grads_close(got, torch_attention.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, True, scale))


def test_bwd_kernel_is_deterministic(cuda):
    """No atomics: the same inputs give the same bits (the train resume
    compares losses bit for bit)."""
    rng = np.random.default_rng(6)
    q = _bf16(rng, (1, 1000, 16, 128), cuda)
    k, v = (_bf16(rng, (1, 1000, 8, 128), cuda) for _ in range(2))
    dout = _bf16(rng, (1, 1000, 16, 128), cuda)
    out, lse = torch_attention.flash_attention_fwd(q, k, v, True, 0.1)
    first = torch_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                True, 0.1)
    again = torch_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                True, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_attention_on_the_card_dispatches_to_the_kernel(cuda):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, (1, 40, 4, 128), cuda) for _ in range(3))
    before = torch_attention.LAUNCHES['flash_fwd']
    torch_attention.attention(q, k, v)
    assert torch_attention.LAUNCHES['flash_fwd'] == before + 1
    torch_attention.attention(q, k, v, force_impl='reference')
    assert torch_attention.LAUNCHES['flash_fwd'] == before + 1


@pytest.mark.parametrize('change,match', [
    (dict(d=96), 'head_dim'),
    (dict(dtype=torch.float16), 'bf16'),
    (dict(sq=20, sk=10), 'sq <= sk'),
])
def test_kernel_refuses_what_it_does_not_take(cuda, change, match):
    spec = dict(sq=16, sk=16, d=64, dtype=torch.bfloat16)
    spec.update(change)
    q = torch.zeros(1, spec['sq'], 2, spec['d'], device=cuda,
                    dtype=spec['dtype'])
    k = torch.zeros(1, spec['sk'], 2, spec['d'], device=cuda,
                    dtype=spec['dtype'])
    with pytest.raises(ValueError, match=match):
        torch_attention.flash_attention_fwd(q, k, k, True)


def _assert_grads_close(got, want):
    """Each 64-row tile of each head within TILE_RTOL of its own RMS. A
    gradient that is zero in exact arithmetic (one key: dS = P * (dP -
    delta) = 0) is f32 rounding noise on both sides, ~1e-6, under the
    comparison's 1e-4 floor."""
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g.float()).all(), name
        err = tile_rel_err(g, w)
        assert err <= TILE_RTOL, (name, err)


@pytest.mark.parametrize('b,sq,sk,hq,hkv,d,causal', CASES)
def test_bwd_kernel_matches_plain_version(cuda, b, sq, sk, hq, hkv, d,
                                          causal):
    rng = np.random.default_rng(sq * 1000 + sk + 7)
    q = _bf16(rng, (b, sq, hq, d), cuda)
    k = _bf16(rng, (b, sk, hkv, d), cuda)
    v = _bf16(rng, (b, sk, hkv, d), cuda)
    dout = _bf16(rng, (b, sq, hq, d), cuda)
    scale = d ** -0.5
    out, lse = torch_attention.flash_attention_fwd(q, k, v, causal, scale)
    before = torch_attention.LAUNCHES['flash_bwd']
    got = torch_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal, scale)
    torch.cuda.synchronize()
    assert torch_attention.LAUNCHES['flash_bwd'] == before + 1
    _assert_grads_close(got, torch_attention.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, causal, scale))


def test_bwd_kernel_reads_strided_inputs(cuda):
    rng = np.random.default_rng(3)
    qkv = _bf16(rng, (2, 96, 12, 64), cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    dout = _bf16(rng, (2, 96, 8, 64), cuda)
    out, lse = torch_attention.flash_attention_fwd(q, k, v, True, 0.125)
    got = torch_attention.flash_attention_bwd(q, k, v, out, lse, dout, True,
                                              0.125)
    _assert_grads_close(got, torch_attention.flash_attention_bwd_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), out, lse, dout, True,
        0.125))


def test_gradients_flow_through_the_kernels(cuda):
    """A CUDA ``attention()`` call that requires grad goes through
    ``FlashAttention``: K1 forward, K2 backward, and q/k/v grads that
    match the plain versions'."""
    rng = np.random.default_rng(5)
    q = _bf16(rng, (2, 130, 8, 128), cuda).requires_grad_()
    k = _bf16(rng, (2, 130, 2, 128), cuda).requires_grad_()
    v = _bf16(rng, (2, 130, 2, 128), cuda).requires_grad_()
    dout = _bf16(rng, (2, 130, 8, 128), cuda)
    before = dict(torch_attention.LAUNCHES)
    out = torch_attention.attention(q, k, v)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert torch_attention.LAUNCHES['flash_fwd'] == before['flash_fwd'] + 1
    assert torch_attention.LAUNCHES['flash_bwd'] == before['flash_bwd'] + 1
    with torch.no_grad():
        ref_out, ref_lse = torch_attention.flash_attention_fwd_reference(
            q, k, v, True, 128 ** -0.5)
        want = torch_attention.flash_attention_bwd_reference(
            q, k, v, ref_out, ref_lse, dout, True, 128 ** -0.5)
    _assert_grads_close(got, want)
