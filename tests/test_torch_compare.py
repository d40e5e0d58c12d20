"""The per-tile comparison the kernel checks use
(``skypilot_tpu_torch/utils/compare.py``).

It must pass what two correct bf16 computations of attention differ by,
and fail a fault confined to the late tiles of a long causal sequence,
where values are far below the tensor's largest: the plain versions'
results with a planted fault stand in for a faulty kernel. The old
criterion (max abs error within 2e-2, or within 2e-2 of the largest
|value|) is computed beside it to show what it let through.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import attention as torch_attention
from skypilot_tpu_torch.utils.compare import (TILE_FLOOR, TILE_ROWS,
                                              TILE_RTOL, tile_rel_err)

OLD_TOL = 2e-2
S, HQ, HKV, D = 4096, 2, 1, 64


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(torch.bfloat16)


@pytest.fixture(scope='module')
def long_causal():
    """b 1 x 4096 causal, GQA 2/1, d 64: K1's and K2's plain versions."""
    rng = np.random.default_rng(0)
    q, k, v = _bf16(rng, (1, S, HQ, D)), _bf16(rng, (1, S, HKV, D)), \
        _bf16(rng, (1, S, HKV, D))
    dout = _bf16(rng, (1, S, HQ, D))
    scale = D ** -0.5
    out, lse = torch_attention.flash_attention_fwd_reference(q, k, v, True,
                                                             scale)
    grads = torch_attention.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, True, scale)
    return dict(q=q, k=k, v=v, out=out, lse=lse, grads=grads, scale=scale)


def test_identical_and_shape_mismatch():
    x = torch.randn(2, 100, 3, 8)
    assert tile_rel_err(x, x.clone()) == 0.0
    with pytest.raises(ValueError, match='shapes differ'):
        tile_rel_err(x, x[:, :99])


def test_passes_another_correct_bf16_computation(long_causal):
    """The blockwise online-softmax loop (f32 P, another summation order)
    against the plain K1 version (P rounded to bf16): both bf16."""
    c = long_causal
    other = torch_attention.blockwise_attention(c['q'], c['k'], c['v'], True,
                                                c['scale'], block_size=256)
    err = tile_rel_err(other, c['out'])
    assert 0.0 < err <= TILE_RTOL / 2, err


def test_floor_takes_zero_blocks():
    """A block that is zero in exact arithmetic holds rounding noise."""
    want = torch.zeros(1, 3, 2, 16)
    got = torch.full_like(want, TILE_FLOOR * TILE_RTOL / 2)
    assert tile_rel_err(got, want) <= TILE_RTOL


def test_ragged_last_tile_is_its_own_block():
    """A fault in the 5 rows of a ragged last tile is measured against
    those rows alone."""
    want = torch.ones(1, 2 * TILE_ROWS + 5, 1, 8)
    got = want.clone()
    got[:, -5:] *= 1.05
    assert tile_rel_err(got, want) == pytest.approx(0.05, rel=1e-5)


def test_fails_a_fwd_fault_in_the_last_tile(long_causal):
    """The last 64 query rows miss P.V over their own diagonal key tile
    (lse left right): out there is sum_{j < s-64} p_ij v_j / l_i."""
    c = long_causal
    tail = slice(S - TILE_ROWS, S)
    part, part_lse = torch_attention.flash_attention_fwd_reference(
        c['q'][:, tail], c['k'][:, :S - TILE_ROWS], c['v'][:, :S - TILE_ROWS],
        False, c['scale'])
    keep = torch.exp(part_lse - c['lse'][:, :, tail]).permute(0, 2, 1)
    faulty = c['out'].clone()
    faulty[:, tail] = (part.float() * keep[..., None]).to(faulty.dtype)
    old_err = (faulty.float() - c['out'].float()).abs().max().item()
    assert old_err <= OLD_TOL  # what the absolute criterion let through
    assert tile_rel_err(faulty, c['out']) > TILE_RTOL


@pytest.mark.parametrize('which', [1, 2])  # dk, dv
def test_fails_a_bwd_fault_in_the_last_key_tile(long_causal, which):
    """The last 64 keys' dK (dV) never written, left at zero."""
    want = long_causal['grads'][which]
    faulty = want.clone()
    faulty[:, S - TILE_ROWS:] = 0
    old_err = (faulty.float() - want.float()).abs().max().item()
    assert old_err <= OLD_TOL * want.float().abs().max().item()
    assert tile_rel_err(faulty, want) > TILE_RTOL
