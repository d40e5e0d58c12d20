"""How close a kernel's result is to its plain version, tile by tile.

Attention outputs and gradients shrink along the sequence: a causal row
that sees i keys averages i values, so its magnitude goes as 1/sqrt(i),
and a tolerance taken from the tensor's largest |value| is many times a
late row's typical value. A fault confined to the late tiles (a dropped
last tile, a wrong ragged or causal mask) would pass it. So each block of
64 rows of one head (the kernels' tile) is held to its own magnitude:
``tile_rel_err`` is the largest, over (batch, row tile, head) blocks, of
rms(got - want) / max(rms(want), TILE_FLOOR). The floor only matters for
blocks that are zero in exact arithmetic (one visible key gives dS = 0),
where both sides hold f32 rounding noise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_ROWS = 64
# bf16 results: two roundings of nearly equal f32 values differ by at
# most one bf16 ulp (2^-8 to 2^-7 of the value), on a fraction of the
# elements, so a block's relative RMS error sits near 2e-3.
TILE_RTOL = 1e-2
TILE_FLOOR = 1e-4


def _block_mean_square(x: torch.Tensor) -> torch.Tensor:
    """[b, s, h, d] -> [b, ceil(s / TILE_ROWS), h], the mean of x^2 over
    each block of TILE_ROWS rows (the ragged last block over its own
    rows)."""
    b, s, h, d = x.shape
    pad = (-s) % TILE_ROWS
    sq = F.pad(x.float().square(), (0, 0, 0, 0, 0, pad))
    sums = sq.reshape(b, (s + pad) // TILE_ROWS, TILE_ROWS, h, d).sum(
        dim=(2, 4))
    rows = torch.full((sums.shape[1],), float(TILE_ROWS), device=x.device)
    rows[-1] = s - (sums.shape[1] - 1) * TILE_ROWS
    return sums / (rows[None, :, None] * d)


def tile_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative RMS error over (batch, row tile, head) blocks of
    two [b, s, h, d] tensors."""
    if got.shape != want.shape:
        raise ValueError(f'shapes differ: {tuple(got.shape)} vs '
                         f'{tuple(want.shape)}')
    err = _block_mean_square(got.float() - want.float()).sqrt()
    ref = _block_mean_square(want).sqrt().clamp(min=TILE_FLOOR)
    return (err / ref).max().item()
