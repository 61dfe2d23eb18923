"""Mesh construction, ported from `deepreduce_tpu/parallel/mesh.py`.

The JAX package names the axes of a `jax.sharding.Mesh` and every
collective names the axis it rides on. The port's counterpart of a named
axis is a group: `make_mesh` gives this worker one `Collectives` per axis,
the workers that differ from it on that axis alone. Ranks are laid out
row-major over the axes in their given order, the layout of JAX's
`Mesh(np.reshape(devices, shape), names)`. In-process workers take theirs
from `collectives.InProcessMesh(axes).member(rank)`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch.distributed as dist

from deepreduce_tpu_torch.collectives import Collectives, ProcessGroupCollectives, Solo, collectives_for, mesh_lines


def factor_devices(n: int, axes: Sequence[str]) -> Dict[str, int]:
    """Factor a device count into mesh axis sizes, greedily giving the
    earlier axes the larger factors (data first, then seq/model).

    8, ('data','seq') -> {'data': 4, 'seq': 2};  7 -> {'data': 7, 'seq': 1}.
    """
    sizes = {a: 1 for a in axes}
    remaining = n
    names = list(axes)
    for i, name in enumerate(names[:-1]):
        # largest factor <= sqrt-balanced split that divides `remaining`,
        # biased so the leading axis keeps the bulk
        target = max(1, round(remaining ** (1.0 - 1.0 / (len(names) - i))))
        best = 1
        for f in range(1, remaining + 1):
            if remaining % f == 0 and f <= max(target, 1):
                best = f
        # leading axis gets the co-factor (the big one)
        sizes[name] = remaining // best if i == 0 else best
        remaining = remaining // sizes[name]
    sizes[names[-1]] = remaining
    return sizes


def make_mesh(axes: Dict[str, int], group=None, *, dcn_axis: Optional[str] = None) -> Dict[str, Collectives]:
    """This worker's `{axis: Collectives}` over `group` (a
    `torch.distributed` group; None: the default group once
    `torch.distributed` is initialized, else one worker), whose size must
    be the product of `axes`. `make_mesh({'data': 2, 'seq': 2}, group)`.

    `dcn_axis` names the axis that crosses the inter-node link; it must be
    the LEADING axis, so that the other axes stay inside a node. A
    `torch.distributed` group is split with `dist.new_group`, a collective
    call of every rank of the default group: each rank creates every line
    of every axis (`collectives.mesh_lines`), axis by axis in the given
    order, and keeps its own."""
    names = tuple(axes)
    n = math.prod(axes.values())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    coll = collectives_for(group)
    if coll.world_size != n:
        raise ValueError(f"need {n} devices for mesh {axes}, have {coll.world_size}")
    if dcn_axis is not None and names[0] != dcn_axis:
        raise ValueError(f"dcn_axis={dcn_axis!r} must be the leading mesh axis, got axis order {names}")
    if isinstance(coll, Solo):
        return {a: Solo() for a in names}
    if not isinstance(coll, ProcessGroupCollectives):
        raise ValueError("in-process workers take their axes from collectives.InProcessMesh(axes).member(rank)")
    out = {}
    for a, lines in mesh_lines(axes).items():
        for line in lines:
            g = dist.new_group([dist.get_global_rank(coll.group, r) for r in line])
            if coll.rank in line:
                out[a] = ProcessGroupCollectives(g)
    return out


def make_hybrid_mesh(n_slices: int, per_slice: int, group=None, dcn_axis: str = "dcn",
                     ici_axis: str = "ici") -> Dict[str, Collectives]:
    """This worker's (dcn, ici) mesh, `make_mesh({dcn: n_slices, ici:
    per_slice}, group, dcn_axis=dcn)`: worker r in slice r // per_slice at
    position r % per_slice."""
    return make_mesh({dcn_axis: n_slices, ici_axis: per_slice}, group, dcn_axis=dcn_axis)
