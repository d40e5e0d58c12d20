"""Named-axis device meshes over the ranks of a process group.

Counterpart of ``skypilot_tpu/parallel/mesh.py``: the same canonical axes
(``MESH_AXES``, ``tp`` innermost, ``dcn`` outermost), the same
``MeshSpec`` and its validation. A rank sits at the row-major coordinate
of its global rank over the axis sizes, so ranks are slice-major (the
contract orders hosts by slice) and a ``tp`` group is the closest ranks,
one host's GPUs first.

``make_mesh`` returns a ``Mesh``: the spec, this rank's coordinate, the
torch ``DeviceMesh`` with one dim per axis (named after ``MESH_AXES``, in
that order), and the process group over any tuple of axes that the
collectives of ``parallel/sharding.py`` need. A ``Mesh`` built for a rank
without a process group (``Mesh(spec, rank)``) answers every layout
question and runs no collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

MESH_AXES: Tuple[str, ...] = ('dcn', 'pp', 'dp', 'fsdp', 'ep', 'sp', 'tp')

# The minimum nontrivial width of an axis that shards a static model dim
# (every real mesh sizes an axis at 1 or a multiple of 2).
MESH_AXIS_DIVISORS: Dict[str, int] = {'tp': 2, 'sp': 2, 'ep': 2,
                                      'fsdp': 2}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each canonical mesh axis; unspecified axes default to 1.
    Axis order is fixed (``MESH_AXES``) with ``tp`` innermost (its
    collectives move the most bytes) and ``dcn`` outermost (only the data-
    parallel gradient reduction may cross slices)."""
    dcn: int = 1
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @property
    def num_devices(self) -> int:
        return math.prod(self.sizes.values())

    def __post_init__(self):
        for a in MESH_AXES:
            if getattr(self, a) < 1:
                raise ValueError(f'Mesh axis {a!r} must be >= 1, got '
                                 f'{getattr(self, a)}')

    @classmethod
    def for_devices(cls,
                    n: int,
                    tp: int = 1,
                    sp: int = 1,
                    pp: int = 1,
                    ep: int = 1,
                    dcn: int = 1,
                    fsdp: Optional[int] = None) -> 'MeshSpec':
        """Fill the leftover device factor into fsdp (or dp if fsdp given)."""
        used = tp * sp * pp * ep * dcn
        if n % used:
            raise ValueError(
                f'{n} devices not divisible by dcn*tp*sp*pp*ep={used}')
        rest = n // used
        if fsdp is None:
            return cls(dcn=dcn, pp=pp, fsdp=rest, ep=ep, sp=sp, tp=tp)
        if rest % fsdp:
            raise ValueError(f'residual {rest} not divisible by fsdp={fsdp}')
        return cls(dcn=dcn, pp=pp, dp=rest // fsdp, fsdp=fsdp, ep=ep,
                   sp=sp, tp=tp)


def as_axes(axes) -> Tuple[str, ...]:
    """A spec entry or axis list (None, a name, or names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """One rank's view of a named mesh (see the module docstring)."""

    def __init__(self, spec: MeshSpec, rank: int = 0, device_mesh=None):
        if not 0 <= rank < spec.num_devices:
            raise ValueError(f'rank {rank} outside a mesh of '
                             f'{spec.num_devices} devices')
        self.spec = spec
        self.rank = rank
        self.device_mesh = device_mesh
        self.coords = self.coords_of(rank)
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.sizes

    @property
    def num_devices(self) -> int:
        return self.spec.num_devices

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinate of ``rank``: row-major over ``MESH_AXES``."""
        coords = {}
        for axis in reversed(MESH_AXES):
            rank, coords[axis] = divmod(rank, self.shape[axis])
        return {a: coords[a] for a in MESH_AXES}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for axis in MESH_AXES:
            rank = rank * self.shape[axis] + coords.get(axis, 0)
        return rank

    def live(self, axes) -> Tuple[str, ...]:
        """``axes`` without the axes of size 1, checked to follow
        ``MESH_AXES`` order (a tiled collective over a tuple of axes
        concatenates in that order, as ``lax.all_gather`` does)."""
        axes = as_axes(axes)
        order = [MESH_AXES.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f'mesh axes {axes} must follow the order of '
                             f'{MESH_AXES}')
        return tuple(a for a in axes if self.shape[a] > 1)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in as_axes(axes))

    def index(self, axes, coords: Optional[Dict[str, int]] = None) -> int:
        """This rank's (or the rank at ``coords``) position along
        ``axes``, the first axis major (``lax.axis_index`` of a tuple of
        axes)."""
        coords = coords or self.coords
        idx = 0
        for a in as_axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def ranks(self, axes, coords: Optional[Dict[str, int]] = None
              ) -> List[int]:
        """The ranks of the group along ``axes`` through ``coords``
        (default: this rank's), in the order of ``index``; ascending,
        since the axes follow ``MESH_AXES``."""
        axes = self.live(axes)
        base = dict(coords or self.coords)
        out = []
        for i in range(self.size(axes)):
            c = dict(base)
            for a in reversed(axes):
                i, c[a] = divmod(i, self.shape[a])
            out.append(self.rank_of(c))
        return out

    def group(self, axes):
        """The process group of this rank along ``axes`` (size-1 axes
        dropped). One axis: the ``DeviceMesh``'s group of that dim. More:
        made once, on every rank in the same order (the creation is a
        collective call), over every group of those axes."""
        axes = self.live(axes)
        if not axes:
            raise ValueError('no group over a mesh axis of size 1')
        if axes not in self._groups:
            if len(axes) == 1 and self.device_mesh is not None:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            else:
                import torch.distributed as dist
                rest = [a for a in MESH_AXES if a not in axes]
                firsts = {}
                for r in range(self.num_devices):
                    c = self.coords_of(r)
                    firsts.setdefault(tuple(c[a] for a in rest), c)
                enumeration = [self.ranks(axes, c) for c in firsts.values()]
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                    enumeration)
        return self._groups[axes]


def make_mesh(spec: MeshSpec, device_type: str = 'cuda') -> Mesh:
    """The mesh of ``spec`` over the process group's ranks, for this rank.
    The spec must cover every rank (JAX's ``make_mesh`` message
    otherwise); one device needs no process group."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spec.num_devices != world:
        raise ValueError(
            f'MeshSpec wants {spec.num_devices} devices '
            f'({spec.sizes}), got {world}')
    if world == 1:
        return Mesh(spec)
    from torch.distributed.device_mesh import init_device_mesh
    device_mesh = init_device_mesh(
        device_type, tuple(spec.sizes[a] for a in MESH_AXES),
        mesh_dim_names=MESH_AXES)
    return Mesh(spec, dist.get_rank(), device_mesh)

