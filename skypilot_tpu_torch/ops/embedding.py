"""Distributed embedding lookup over a mesh-sharded table.

Counterpart of ``skypilot_tpu/ops/embedding.py``. With the table sharded
('vocab' -> tp, 'embed' -> fsdp), every transfer stays activation-sized,
never table-sized, in the same four steps as the JAX ``shard_map`` body,
here as explicit collectives (``parallel/sharding.py``):

  1. all-gather the *tokens* over the embed-sharding axes, so each rank
     holds every batch row it will need feature columns for;
  2. gather from the local vocab shard (indices clamped, rows outside
     the shard zeroed);
  3. all-reduce over the vocab axes sums the one non-zero contribution;
  4. all-to-all over the embed axes re-splits the rows and concatenates
     the features, so each rank ends with its batch rows x every feature.

The embed axes must shard the batch (fsdp, as every rules table of the
repo has it); JAX's other layouts raise ``NotImplementedError``.

The backward runs the same steps transposed: the all-to-all back, the
gradient passed whole to each vocab shard, a masked scatter-add into the
local rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.mesh import Mesh


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 mesh: Optional[Mesh] = None,
                 rules: Optional[sharding.LogicalRules] = None
                 ) -> torch.Tensor:
    """``table[tokens]`` for this rank: the local table shard [V/v, E/e]
    and the local tokens [B/b, S] -> [B/b, S, E], replicated over the
    embed and vocab axes. A plain gather without a mesh or with an
    unsharded table."""
    if mesh is None or rules is None:
        return table[tokens]
    vocab_axes = mesh.live(rules.axes('vocab'))
    embed_axes = mesh.live(rules.axes('embed'))
    if not vocab_axes and not embed_axes:
        return table[tokens]
    batch_axes = set(rules.axes('batch'))
    if not set(embed_axes) <= batch_axes:
        # JAX gathers features over embed axes the batch is replicated
        # over, and leaves embed axes partly in the batch axes to GSPMD.
        # No rules table of the repo makes either layout.
        raise NotImplementedError(
            f'embedding with embed axes {embed_axes} outside the batch '
            f'axes {sorted(batch_axes)} is not supported')
    # [B_loc, S] -> every row of this rank's dp block, axis-major.
    tokens = sharding.all_gather_rows(tokens, mesh, embed_axes)
    if vocab_axes:
        v_local = table.shape[0]
        idx = tokens - mesh.index(vocab_axes) * v_local
        ok = (idx >= 0) & (idx < v_local)
        x = table[idx.clamp(0, v_local - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
        x = sharding.reduce_from(x, mesh, vocab_axes)
    else:
        x = table[tokens]
    return sharding.all_to_all(x, mesh, embed_axes)
