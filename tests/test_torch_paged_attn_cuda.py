"""The paged decode-attention kernel K3 (``csrc/paged_attn.cu``) on the
card.

These tests need an NVIDIA GPU with ``nvcc``: they carry the ``cuda``
marker and skip where there is none. On the GPU machine:

    python -m pytest tests/test_torch_paged_attn_cuda.py -m cuda --noconftest -q

K3 is held against its plain version (``paged_attention_reference``) at
the serving cells' attention: 64 slots, 32/8 heads of 128, blocks of
64, the decode step's T 1 and the verify step's T 5, lengths at the
block edges (0, 1, 63, 64, 65, max_len - T) and drawn between them,
through shuffled block tables that share blocks across slots. Per
(slot, query head) the relative RMS error over [T, d] must be within
``HEAD_RTOL``: both sides round O to bf16 (2^-9 relative) and P to bf16
before P V, K3 against its running maximum per warp and split rather
than the row's, so a value's P may differ by one bf16 step (2^-8
relative) before the sums; the same 1e-2 K1 holds per tile.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import attention as attention_ops

pytestmark = pytest.mark.cuda

HEAD_RTOL = 1e-2
B, HQ, HKV, D, BS = 64, 32, 8, 128, 64
MAX_LEN = 2048  # 32 blocks a slot: four 512-key splits to combine
EDGES = (0, 1, 63, 64, 65)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


def _inputs(t, seed, device):
    """q, pools, block tables and lengths: every slot's table a shuffled
    draw from a pool of B * max_blocks / 2 blocks, so slots share."""
    rng = np.random.default_rng(seed)
    max_blocks = MAX_LEN // BS
    nb = B * max_blocks // 2

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(device=device, dtype=torch.bfloat16)
    q = bf16((B, t, HQ, D))
    k_pool, v_pool = bf16((nb, HKV, BS, D)), bf16((nb, HKV, BS, D))
    tables = torch.from_numpy(rng.integers(0, nb, (B, max_blocks))).to(device)
    lengths = list(EDGES) + [MAX_LEN - t]
    lengths += rng.integers(0, MAX_LEN - t + 1, B - len(lengths)).tolist()
    return q, k_pool, v_pool, tables, torch.tensor(lengths, device=device)


def _head_rel_err(got, want):
    """Largest relative RMS error over the (slot, query head) blocks."""
    g, w = got.float(), want.float()
    num = (g - w).pow(2).sum(dim=(1, 3)).sqrt()
    return (num / w.pow(2).sum(dim=(1, 3)).sqrt().clamp(min=1e-30)).max()


@pytest.mark.parametrize('t', [1, 5])
def test_kernel_matches_plain_version(cuda, t):
    q, k_pool, v_pool, tables, lengths = _inputs(t, t, cuda)
    before = attention_ops.LAUNCHES['paged_attn']
    got = attention_ops.paged_attention(q, k_pool, v_pool, tables, lengths)
    torch.cuda.synchronize()
    assert attention_ops.LAUNCHES['paged_attn'] == before + 1
    want = attention_ops.paged_attention_reference(q, k_pool, v_pool,
                                                   tables, lengths)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _head_rel_err(got, want).item() <= HEAD_RTOL


@pytest.mark.parametrize('t', [1, 5])
def test_kernel_reads_no_block_past_the_visible_ones(cuda, t):
    """Blocks no slot sees are NaN: K3's output equals its output with
    them zeroed (the plain version reads them, and 0 x NaN in its P V is
    NaN, so it is no reference here)."""
    q, k_pool, v_pool, tables, lengths = _inputs(t, 10 + t, cuda)
    seen = torch.zeros(k_pool.shape[0], dtype=torch.bool, device=cuda)
    n_blocks = ((lengths + t + BS - 1) // BS).clamp(max=tables.shape[1])
    for slot in range(B):
        seen[tables[slot, :int(n_blocks[slot])]] = True
    assert 0 < int((~seen).sum()) < k_pool.shape[0]
    outs = []
    for fill in (0.0, float('nan')):
        k, v = k_pool.clone(), v_pool.clone()
        k[~seen] = fill
        v[~seen] = fill
        outs.append(attention_ops.paged_attention(q, k, v, tables, lengths))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0].float()).all())
    assert torch.equal(outs[0], outs[1])


def test_a_long_verify_step_is_launched_in_parts(cuda):
    """T 9 at 32/8 heads is 36 query rows a pair, past one launch's 32:
    the wrapper launches K3 on two parts of T, offset by the first."""
    q, k_pool, v_pool, tables, lengths = _inputs(9, 3, cuda)
    got = attention_ops.paged_attention(q, k_pool, v_pool, tables, lengths)
    want = attention_ops.paged_attention_reference(q, k_pool, v_pool,
                                                   tables, lengths)
    torch.cuda.synchronize()
    assert _head_rel_err(got, want).item() <= HEAD_RTOL


def test_every_decode_dispatch_launches_k3_once_per_layer(cuda):
    cfg = llama.LlamaConfig(vocab_size=256, embed_dim=256, num_layers=3,
                            num_heads=8, num_kv_heads=2, head_dim=128,
                            mlp_dim=512, max_seq_len=512)
    model = llama.LlamaModel(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    eng = decode.DecodeEngine(cfg, batch_slots=4, max_len=512, model=model,
                              kv_block=64, spec_tokens=4, device=cuda)
    state = eng.init_state()
    rng = torch.Generator(device=cuda).manual_seed(0)
    state, _, _ = eng.admit(params, state, list(range(1, 17)), 16, 0, rng)
    before = attention_ops.LAUNCHES['paged_attn']
    state, _, _ = eng.step(params, state, rng)
    assert attention_ops.LAUNCHES['paged_attn'] == before + cfg.num_layers
    eng.step_verify(params, state, rng, [[1, 2, 3, 4]] * 4)
    torch.cuda.synchronize()
    assert (attention_ops.LAUNCHES['paged_attn']
            == before + 2 * cfg.num_layers)
