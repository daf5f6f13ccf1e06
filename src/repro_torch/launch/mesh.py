"""Device meshes over the ranks of a ``torch.distributed`` job.

The JAX package's mesh is a grid of devices one process drives
(``jax.make_mesh``); the port runs one process per rank, so a mesh here is
this rank's place in a grid of ranks: its coordinate on each named axis
and, for each axis, the process group of the ranks that share every other
coordinate (the ranks a collective over that axis talks to). Ranks are
laid out row-major: on a ``(data, tensor)`` mesh of shape ``(dp, tp)``,
rank ``d * tp + t``.

The groups are made with ``torch.distributed.new_group``, not a
``DeviceMesh``: a ``DeviceMesh`` binds the mesh to one device type and
its default backend, while a rank here computes on its CUDA device and
may move the payload over gloo, staged through host memory
(``dist/collectives.py``), which only a group of the job's own backend
allows. Every rank makes every group, in the same order, as
``new_group`` requires; an axis of size 1 gets no group (its collectives
are the identity).

Nothing here runs at import: :func:`make_mesh` builds only inside a
launched job, whose process group the caller initialised
(``torch.distributed.init_process_group(backend, init_method=
"tcp://localhost:<port>", world_size=N, rank=r)``). The data-parallel
axes are the reference's ``pod`` and ``data`` (:func:`dp_axes`).

:func:`make_production_mesh` is the reference's deployment plan: a
``(data, model)`` mesh of 16 x 16 ranks, or ``(pod, data, model)`` of
2 x 16 x 16, the ``pod`` axis carrying data parallelism only (the slow
cross-pod links the compressed collectives target). It needs a job of
256 or 512 ranks; the dry run (``launch/dryrun.py``) gives it a fake
one in-process.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Sequence, Tuple

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "dp_axes",
           "batch_spec_axes", "LAUNCH_HINT", "RANK_TIMEOUT",
           "PRODUCTION_MESHES"]

# the reference's production meshes: (shape, axis names) by multi_pod
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}

# how long a rank of the selftests and chip_smoke.py's job waits on a
# hop before it fails (gloo's default is 30 minutes): a rank that dies
# then stops its peers well inside a test run's limit
RANK_TIMEOUT = datetime.timedelta(minutes=5)

LAUNCH_HINT = ("launch one process per rank and call "
               "torch.distributed.init_process_group(backend, init_method="
               "'tcp://localhost:<port>', world_size=N, rank=r) in each "
               "before building the mesh (python -m "
               "repro_torch.serve.shard_selftest --world N shows how)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a grid of ranks: axis names and sizes, its
    coordinate on each axis, and the process group of each axis line
    through it (None for an axis of size 1)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[object, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise KeyError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.axis_names.index(name)

    def group(self, name: str):
        return self.groups[self._axis(name)]

    def axis_size(self, name: str) -> int:
        return self.sizes[self._axis(name)]

    def coord(self, name: str) -> int:
        return self.coords[self._axis(name)]


def _strides(sizes: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(sizes):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The mesh of ``shape`` over the job's ranks (row-major), with one
    process group per axis line. Raises, naming how to launch, unless a
    process group of exactly ``prod(shape)`` ranks is initialised; a
    mesh of one rank needs none (every axis has size 1, so every
    collective over it is the identity)."""
    import torch.distributed as dist
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    need = math.prod(shape)
    what = f"a mesh of {need} ranks {dict(zip(axis_names, shape))}"
    initialised = dist.is_available() and dist.is_initialized()
    if need == 1 and not initialised:
        return Mesh(axis_names, shape, (0,) * len(shape),
                    (None,) * len(shape))
    if not initialised:
        raise ValueError(f"{what} needs an initialised torch.distributed "
                         f"process group, and none is: {LAUNCH_HINT}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"{what} needs a process group of {need}, but the "
                         f"job has {world}: {LAUNCH_HINT}")
    me = dist.get_rank()
    strides = _strides(shape)
    coords = tuple((me // st) % s for st, s in zip(strides, shape))
    groups = []
    for size, st in zip(shape, strides):
        if size == 1:
            groups.append(None)
            continue
        mine = None
        # every line along this axis: the ranks that differ only there
        for base in range(need):
            if (base // st) % size:
                continue
            ranks = [base + i * st for i in range(size)]
            g = dist.new_group(ranks)
            if me in ranks:
                mine = g
        groups.append(mine)
    return Mesh(axis_names, shape, coords, tuple(groups))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """This rank's place on the reference's production mesh: (16, 16)
    over ``("data", "model")`` (256 ranks), or with ``multi_pod`` (2, 16,
    16) over ``("pod", "data", "model")`` (512 ranks)."""
    return make_mesh(*PRODUCTION_MESHES[bool(multi_pod)])


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec_axes(mesh, global_batch: int) -> tuple:
    """The longest prefix of the data-parallel axes whose sizes divide the
    batch (batch 1, lockstep decode, replicates: ``()``).

    A batch that divides no data axis is a configuration error, not a
    request for replication (every device would process the whole batch,
    an N-fold redundant step that looks like a working run): it raises,
    naming the mesh and the batch."""
    if global_batch == 1:
        return ()
    axes = []
    div = 1
    for a in dp_axes(mesh):
        if global_batch % (div * mesh.shape[a]) == 0:
            axes.append(a)
            div *= mesh.shape[a]
    if not axes:
        dp = {a: mesh.shape[a] for a in dp_axes(mesh)}
        raise ValueError(
            f"global_batch={global_batch} divides no DP axis of mesh "
            f"{dict(mesh.shape)} (DP axes: {dp or 'none'}); pick a "
            "batch divisible by a DP axis size or reshape the mesh")
    return tuple(axes)

