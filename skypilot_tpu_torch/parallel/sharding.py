"""Logical-axis sharding rules, shard layouts, and the collectives that
GSPMD inserted for the JAX package.

Counterpart of ``skypilot_tpu/parallel/sharding.py``: model code names
each array dim with a *logical* axis ('batch', 'embed', 'heads', ...) and
a ``LogicalRules`` table maps each name to zero or more mesh axes. In JAX
a ``NamedSharding`` then places the array and GSPMD inserts every
collective; here a leaf's *layout* (``spec``: per dim, the mesh axes that
split it) says which slice each rank holds (``local_shard``), and the
model calls the collectives itself, as autograd functions:

- ``gather_on_use``: a weight dim split over axes that also split the
  batch (fsdp) is all-gathered where the weight is used; the backward
  reduce-scatters its gradient (each rank's batch rows add to it). Inside
  a checkpointed layer the gather is recomputed in the backward, as JAX
  recomputes it under remat.
- ``copy_to`` / ``reduce_from``: the tensor-parallel pair. An activation
  replicated over ``tp`` enters a column-parallel product through
  ``copy_to`` (identity; the backward all-reduces the partial input
  gradients) and a row-parallel product's partial sums leave through
  ``reduce_from`` (all-reduce; the backward passes the gradient, which
  every rank holds whole).
- ``all_gather_rows`` / ``all_to_all``: the embedding's token gather and
  row/feature exchange (``ops/embedding.py``).
- ``gather_tokens`` / ``own_tokens``: a per-token tensor of every rank
  in global (b, s) order, and a rank's block of one (the MoE layer's
  global routing, ``ops/moe.py``).
- ``ppermute`` / ``send_recv``: a tensor moved a fixed number of places
  along a mesh axis (``lax.ppermute``; the backward is the reverse
  shift), and the scheduled exchanges of ring attention and the
  pipeline (``parallel/ring_attention.py``, ``parallel/pipeline.py``).

Convention: a tensor replicated over an axis carries its whole gradient
on every rank of that axis; a leaf's gradient is summed over the batch
axes that do not split it (``Trainer``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from skypilot_tpu_torch.parallel.mesh import MESH_AXES, Mesh, as_axes

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]


class LogicalRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes)."""

    def __init__(self, rules: Dict[str, AxisVal]):
        self.rules = dict(rules)

    def spec(self, *logical_axes: Optional[str]) -> Spec:
        """Per dim, the mesh axes of its logical name (a
        ``PartitionSpec``'s entries)."""
        return tuple(self.rules.get(a) if a else None for a in logical_axes)

    def axes(self, logical: str) -> Tuple[str, ...]:
        return as_axes(self.rules.get(logical))

    def with_overrides(self, **overrides: AxisVal) -> 'LogicalRules':
        merged = dict(self.rules)
        merged.update(overrides)
        return LogicalRules(merged)


# Batch over (dp, fsdp); every weight's embed dim over fsdp; head, mlp and
# vocab dims over tp; sequence over sp; experts over ep. Activation dims
# ('act_*') shard only over tp.
DEFAULT_RULES = LogicalRules({
    'batch': ('dp', 'fsdp'),
    'seq': 'sp',
    'embed': 'fsdp',
    'mlp': 'tp',
    'heads': 'tp',
    'kv_heads': 'tp',
    'qkv': 'tp',
    'vocab': 'tp',
    'expert': 'ep',
    'layers': None,
    'act_embed': None,
    'act_mlp': 'tp',
    'act_heads': 'tp',
    'act_kv_heads': 'tp',
    'act_vocab': 'tp',
})


def multislice_rules(base: Optional[LogicalRules] = None) -> LogicalRules:
    """Rules for a mesh with a ``dcn`` (cross-slice) axis: only the batch
    shards over dcn, so the data-parallel gradient reduction is the one
    collective that crosses slices."""
    base = base or DEFAULT_RULES
    return base.with_overrides(batch=('dcn',) + base.axes('batch'))


def tree_specs(rules: LogicalRules, logical_tree):
    """A tree of logical-axis tuples -> the same tree of specs (the
    counterpart of ``tree_shardings``)."""
    if isinstance(logical_tree, dict):
        return {k: tree_specs(rules, v) for k, v in logical_tree.items()}
    return rules.spec(*logical_tree)


# -- layouts ------------------------------------------------------------------
def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in ``MESH_AXES`` order."""
    named = {a for entry in spec for a in as_axes(entry)}
    return tuple(a for a in MESH_AXES if a in named)


def dim_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
               coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The global slice, per dim, that the rank at ``coords`` (default:
    the mesh's own rank) holds of an array of ``shape`` laid out by
    ``spec`` (trailing dims beyond the spec are whole)."""
    coords = coords or mesh.coords
    out = []
    for d, n in enumerate(shape):
        axes = as_axes(spec[d]) if d < len(spec) else ()
        parts = mesh.size(axes)
        if n % parts:
            raise ValueError(f'dim {d} of {tuple(shape)} ({n}) does not '
                             f'divide over mesh axes {axes} ({parts})')
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in dim_slices(shape, spec, mesh))


def local_shard(full: torch.Tensor, spec: Spec, mesh: Optional[Mesh],
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The slice of ``full`` that JAX's ``NamedSharding(mesh, spec)``
    puts on the device at the rank's mesh coordinate (a view)."""
    if mesh is None:
        return full
    return full[dim_slices(full.shape, spec, mesh, coords)]


def owns_slice(spec: Spec, mesh: Mesh,
               coords: Optional[Dict[str, int]] = None) -> bool:
    """Whether the rank at ``coords`` (default: this rank) is the first
    holder of its slice: every mesh axis the spec does not split is at 0
    (one writer per slice)."""
    named = set(spec_axes(spec))
    return all(c == 0 for a, c in (coords or mesh.coords).items()
               if a not in named)


# -- collectives --------------------------------------------------------------
def _gather(x: torch.Tensor, dim: int, mesh: Mesh,
            axes: Tuple[str, ...]) -> torch.Tensor:
    n = mesh.size(axes)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group(axes))
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh,
                    axes: Tuple[str, ...]) -> torch.Tensor:
    n = mesh.size(axes)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=mesh.group(axes))
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh], axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over ``axes`` (no autograd); returns ``x``.
    Over several axes, one group spans them all."""
    axes = () if mesh is None else mesh.live(axes)
    if axes:
        dist.all_reduce(x, op=op, group=mesh.group(axes))
    return x


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return _gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, *ctx.args), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes = ctx.args
        grad = grad.contiguous()
        dist.all_reduce(grad, group=mesh.group(axes))
        return grad, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        # The functional all-reduce returns a new tensor (the input is not
        # mutated), so a remat policy can keep it by op
        # (``models/llama.py`` ``_dots_policy``).
        out = torch.ops._c10d_functional.all_reduce(
            x.contiguous(), 'sum', mesh.group(axes).group_name)
        return torch.ops._c10d_functional.wait_tensor(out)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllToAll(torch.autograd.Function):
    """Rows [n * b, ...] split over the group, features concatenated:
    rank j gets rows j and every rank's feature block (``lax.all_to_all``
    with ``split_axis=0, concat_axis=-1, tiled=True``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _rows_to_features(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return _features_to_rows(grad, *ctx.args), None, None


def _exchange(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


def _rows_to_features(x, mesh, axes):
    n = mesh.size(axes)
    chunk = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    got = _exchange(chunk, mesh, axes)  # got[j]: my rows, rank j's features
    return got.movedim(0, -2).reshape(*got.shape[1:-1], n * x.shape[-1])


def _features_to_rows(g, mesh, axes):
    n = mesh.size(axes)
    per = g.reshape(*g.shape[:-1], n, g.shape[-1] // n).movedim(-2, 0)
    got = _exchange(per, mesh, axes)  # got[j]: rank j's rows, my features
    return got.reshape(n * got.shape[1], *got.shape[2:])


def gather_on_use(x: torch.Tensor, dim: int, mesh: Optional[Mesh],
                  axes) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axes``; the backward
    reduce-scatters (sums) the gradient."""
    axes = () if mesh is None else mesh.live(axes)
    return _GatherOnUse.apply(x, dim, mesh, axes) if axes else x


@torch.no_grad()
def gather_full(x: torch.Tensor, spec: Spec, mesh: Optional[Mesh]
                ) -> torch.Tensor:
    """The whole array from this rank's shard: every split dim
    all-gathered (no autograd)."""
    for d, entry in enumerate(spec):
        axes = () if mesh is None else mesh.live(entry)
        if axes:
            x = _gather(x, d, mesh, axes)
    return x


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh], axes
                    ) -> torch.Tensor:
    """All-gather along dim 0, no autograd (e.g. token ids)."""
    axes = () if mesh is None else mesh.live(axes)
    return _gather(x, 0, mesh, axes) if axes else x


def token_axes(mesh: Mesh, batch_axes, seq_axes) -> Tuple[str, ...]:
    """The live axes that split a batch's tokens, in ``MESH_AXES`` order
    (the batch axes come before ``sp`` there)."""
    named = set(as_axes(batch_axes)) | set(as_axes(seq_axes))
    return mesh.live(tuple(a for a in MESH_AXES if a in named))


@torch.no_grad()
def gather_tokens(x: torch.Tensor, mesh: Optional[Mesh], batch_axes,
                  seq_axes) -> torch.Tensor:
    """All-gather ``x`` [..., B/b, S/s] (this rank's rows and sequence
    block of a per-token tensor, e.g. its router's expert ids) over the
    axes that split the tokens -> [..., B, S] in global (b, s) order:
    rows placed by each rank's position along the batch axes, and within
    a row the sequence blocks by its position along the sequence axes.
    No autograd."""
    axes = () if mesh is None else token_axes(mesh, batch_axes, seq_axes)
    if not axes:
        return x
    batch, seq = mesh.live(batch_axes), mesh.live(seq_axes)
    parts = _gather(x.unsqueeze(0), 0, mesh, axes)  # [G, ..., b, s]
    b, s = x.shape[-2:]
    out = x.new_empty(*x.shape[:-2], mesh.size(batch) * b,
                      mesh.size(seq) * s)
    for g, rank in enumerate(mesh.ranks(axes)):
        coords = mesh.coords_of(rank)
        i, j = mesh.index(batch, coords), mesh.index(seq, coords)
        out[..., i * b:(i + 1) * b, j * s:(j + 1) * s] = parts[g]
    return out


def own_tokens(full: torch.Tensor, mesh: Optional[Mesh], batch_axes,
               seq_axes) -> torch.Tensor:
    """This rank's block [..., B/b, S/s] of a per-token tensor [..., B,
    S] in global order (the inverse of ``gather_tokens``; a view)."""
    if mesh is None:
        return full
    batch, seq = mesh.live(batch_axes), mesh.live(seq_axes)
    b = full.shape[-2] // mesh.size(batch)
    s = full.shape[-1] // mesh.size(seq)
    i, j = mesh.index(batch), mesh.index(seq)
    return full[..., i * b:(i + 1) * b, j * s:(j + 1) * s]


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes) -> torch.Tensor:
    axes = () if mesh is None else mesh.live(axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes
                ) -> torch.Tensor:
    axes = () if mesh is None else mesh.live(axes)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh], axes) -> torch.Tensor:
    axes = () if mesh is None else mesh.live(axes)
    return _AllToAll.apply(x, mesh, axes) if axes else x


# -- point to point -----------------------------------------------------------
def send_recv(x: torch.Tensor, mesh: Mesh, axes, dst: int, src: int,
              send: bool = True, receive: bool = True
              ) -> Optional[torch.Tensor]:
    """One exchange over the group of ``axes``, which every rank of the
    group calls: with ``send``, this rank's ``x`` goes to position
    ``dst`` along ``axes``; with ``receive``, a tensor shaped, typed and
    placed as ``x`` comes from position ``src`` (else None). It is one
    ``all_to_all_single`` whose split sizes are zero but for the
    destination and the source: gloo carries it with CUDA tensors, where
    its send/recv fail (``PERF.md``, PR 8 probe), and so does NCCL. A
    backend that refuses it raises."""
    n = mesh.size(axes)
    flat = (x.contiguous().view(-1) if send
            else x.new_empty(0))
    out = x.new_empty(x.numel() if receive else 0)
    in_splits, out_splits = [0] * n, [0] * n
    in_splits[dst % n] = flat.numel()
    out_splits[src % n] = out.numel()
    dist.all_to_all_single(out, flat, out_splits, in_splits,
                           group=mesh.group(axes))
    return out.view(x.shape) if receive else None


def ring_shift(x: torch.Tensor, mesh: Mesh, axes, offset: int = 1
               ) -> torch.Tensor:
    """The tensor of the rank ``offset`` places before this one along
    ``axes`` (mod the axis size): every rank sends its ``x`` (all of one
    shape) ``offset`` places on. No autograd."""
    i = mesh.index(axes)
    return send_recv(x, mesh, axes, i + offset, i - offset)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, offset):
        ctx.args = (mesh, axes, offset)
        return ring_shift(x, mesh, axes, offset)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, offset = ctx.args
        return ring_shift(grad, mesh, axes, -offset), None, None, None


def ppermute(x: torch.Tensor, mesh: Optional[Mesh], axis, shift: int = 1
             ) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + shift) % n)])``: this rank's
    ``x`` goes to the rank ``shift`` places on along ``axis``, which
    returns the tensor of the rank ``shift`` places before. The backward
    is the reverse shift (JAX's transpose). Identity on an axis of size
    1."""
    axes = () if mesh is None else mesh.live(axis)
    if not axes or shift % mesh.size(axes) == 0:
        return x
    return _PPermute.apply(x, mesh, axes, shift)
