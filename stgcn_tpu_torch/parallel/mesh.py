"""The ``(data, time, model)`` grid of ranks and its sharding rules (port
of ``stgcn_tpu/parallel/mesh.py``).

The mesh has the JAX package's three axes:

* ``data``  -- the batch; gradients summed over it (averaged: each rank's
  loss is its share);
* ``time``  -- the frames; the temporal conv's ``(gamma-1)/2``-frame halo
  is exchanged with the time neighbours (:mod:`.halo`);
* ``model`` -- the channels, Megatron-style: the spatial conv's output
  channels and the temporal conv's input channels are split over it; or,
  with ``shard_joints``, the joints (:mod:`.spatial_halo`).

A mesh in the port is one process per rank, laid out data-major as
``jax.sharding.Mesh`` lays devices out (``rank = (d * time + t) * model +
m``), with one ``torch.distributed`` group for every set of axes a
collective runs over: ``mesh.group("data", "time")`` for channel mode's BN
statistics and gradients, ``mesh.group("model")`` for tensor parallelism,
and so on.  There is no GSPMD: the steps (:mod:`.train`, :mod:`.fused_dp`)
issue every collective themselves.

:func:`param_partition_specs` says which parameter leaves are sliced on
which axis, as the JAX function does (``:71-99``), as tuples of axis names
per dimension (``()`` replicated), and :func:`shard_params` /
:func:`gather_params` turn whole parameters (for instance the JAX
package's, through ``models/convert.params_from_jax``) into each model
rank's slices and back.  The same rule applies to any tree whose leaves sit
under such paths, Adam's moments included.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.tree import tree_items

AXIS_DATA = "data"
AXIS_TIME = "time"
AXIS_MODEL = "model"
AXES = (AXIS_DATA, AXIS_TIME, AXIS_MODEL)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the grid: the axis sizes (``shape``), its own
    coordinates, its device, the backend, and the groups of every set of
    axes (:meth:`group`)."""

    shape: dict
    coords: dict
    device: torch.device
    backend: str
    groups: dict

    @property
    def size(self) -> int:
        return self.shape[AXIS_DATA] * self.shape[AXIS_TIME] * \
            self.shape[AXIS_MODEL]

    def group(self, *axes: str):
        """The group of the ranks that differ from this one only along
        ``axes``."""
        return self.groups[tuple(a for a in AXES if a in axes)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def neighbour(self, axis: str, step: int) -> int | None:
        """Global rank of the neighbour ``step`` along ``axis``, or None
        past the edge."""
        i = self.coords[axis] + step
        if not 0 <= i < self.shape[axis]:
            return None
        c = dict(self.coords, **{axis: i})
        return self._rank_of(c)

    def _rank_of(self, c: dict) -> int:
        return ((c[AXIS_DATA] * self.shape[AXIS_TIME] + c[AXIS_TIME])
                * self.shape[AXIS_MODEL] + c[AXIS_MODEL])


def make_mesh(data: int = 1, time: int = 1, model: int = 1, *,
              device: str | torch.device | None = None) -> Mesh | None:
    """Lay a ``data x time x model`` mesh over the first ranks of the
    ``torch.distributed`` world and make its groups.

    Every rank of the world must call it (groups are made collectively);
    a rank past the mesh's ``data * time * model`` gets None.  Raises
    ``ValueError`` when the world is too small, as the JAX function does
    for too few devices.  Without an initialized world, a one-rank mesh
    makes a one-process world of its own (NCCL on CUDA, gloo on the CPU).
    ``device`` is the rank's device, CUDA (the current device) unless the
    CPU is asked for.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    need = data * time * model
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(f"mesh {data}x{time}x{model} needs {need} "
                             f"devices, have 1 (no torch.distributed world "
                             f"is initialized)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if need > world:
        raise ValueError(f"mesh {data}x{time}x{model} needs {need} "
                         f"devices, have {world}")
    shape = {AXIS_DATA: data, AXIS_TIME: time, AXIS_MODEL: model}
    rank = dist.get_rank()
    coords = None
    if rank < need:
        coords = {AXIS_DATA: rank // (time * model),
                  AXIS_TIME: rank // model % time, AXIS_MODEL: rank % model}
    groups = {}
    for k in range(1, len(AXES) + 1):
        for axes in itertools.combinations(AXES, k):
            for ranks in _partition(shape, axes):
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axes] = g
    if coords is None:
        return None
    return Mesh(shape=shape, coords=coords, device=dev,
                backend=dist.get_backend(), groups=groups)


def _partition(shape: dict, axes: tuple[str, ...]) -> list[list[int]]:
    """The rank lists of the groups along ``axes``: one per setting of the
    other axes, in a fixed order."""
    other = [a for a in AXES if a not in axes]
    out = []
    for fixed in itertools.product(*(range(shape[a]) for a in other)):
        c = dict(zip(other, fixed))
        ranks = []
        for free in itertools.product(*(range(shape[a]) for a in axes)):
            c.update(zip(axes, free))
            ranks.append((c[AXIS_DATA] * shape[AXIS_TIME] + c[AXIS_TIME])
                         * shape[AXIS_MODEL] + c[AXIS_MODEL])
        out.append(ranks)
    return out


def batch_spec(shard_joints: bool = False) -> tuple:
    """Input batch ``(N, T, V, C)``: N over data, T over time; with
    ``shard_joints`` V over model instead of the channels."""
    if shard_joints:
        return (AXIS_DATA, AXIS_TIME, AXIS_MODEL, None)
    return (AXIS_DATA, AXIS_TIME, None, None)


def label_spec() -> tuple:
    return (AXIS_DATA,)


def time_mask_spec() -> tuple:
    """``(N, T)`` frame-validity mask: sharded like the batch's N and T."""
    return (AXIS_DATA, AXIS_TIME)


def leaf_spec(path: str) -> tuple:
    """The partition of the leaf at key path ``path`` (``a/b/0/w``): spatial
    conv ``w (C_in, K, C_out)`` and ``b (K, C_out)`` split C_out over
    ``model`` (column parallel), temporal conv ``w (gamma, 1, C_in,
    C_out)`` splits C_in (row parallel; its bias is replicated and added
    once, after the sum over ``model``); everything else is replicated.
    bn2 stays replicated too: in the residual order it normalizes the
    channel-sharded spatial output, and each model rank takes its slice of
    it in the forward (:func:`~stgcn_tpu_torch.ops.batchnorm.batchnorm_train`
    with a ``channel_group``)."""
    keys = path.split("/")
    if "spatial" in keys and keys[-1] == "w":
        return (None, None, AXIS_MODEL)
    if "spatial" in keys and keys[-1] == "b":
        return (None, AXIS_MODEL)
    if "temporal" in keys and keys[-1] == "w":
        return (None, None, AXIS_MODEL, None)
    return ()


def param_partition_specs(params) -> dict:
    """``{key path: spec}`` of every leaf of ``params`` (:func:`leaf_spec`)."""
    return {k: leaf_spec(k) for k in tree_items(params)}


def replicated_param_specs(params) -> dict:
    """All-replicated specs: joint mode and the data-parallel fused path,
    where the parallelism lives in the activations."""
    return {k: () for k in tree_items(params)}


def sharded_dim(spec: tuple) -> int | None:
    """The dimension split over ``model`` in ``spec``, or None."""
    return spec.index(AXIS_MODEL) if AXIS_MODEL in spec else None


def _map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def shard_params(params, mesh: Mesh, *, replicated: bool = False):
    """This model rank's slices of whole parameters (copies); with
    ``replicated`` every leaf whole.  Leaves keep their device."""
    n, i = mesh.shape[AXIS_MODEL], mesh.index(AXIS_MODEL)

    def cut(path, leaf):
        dim = None if replicated else sharded_dim(leaf_spec(path))
        if dim is None or n == 1:
            return leaf.detach().clone()
        if leaf.shape[dim] % n:
            raise ValueError(f"{path}: dimension {dim} of size "
                             f"{leaf.shape[dim]} does not split over the "
                             f"model axis {n}")
        return leaf.detach().chunk(n, dim=dim)[i].clone()

    return _map_with_path(cut, params)


def gather_params(params, mesh: Mesh, *, replicated: bool = False):
    """Whole parameters from every model rank's slices (a collective: every
    rank of the model group calls it); the inverse of
    :func:`shard_params`."""
    from stgcn_tpu_torch.parallel.collectives import gather_tensor

    group = mesh.group(AXIS_MODEL)

    def join(path, leaf):
        dim = None if replicated else sharded_dim(leaf_spec(path))
        if dim is None or mesh.shape[AXIS_MODEL] == 1:
            return leaf.detach().clone()
        return gather_tensor(leaf.detach(), group, dim, "params")

    return _map_with_path(join, params)


def activation_constrainer(mesh: Mesh, shard_joints: bool = False):
    """The ``constrain(x, tag)`` hook of the model forward (the JAX
    function pins GSPMD's activation shardings; here the hook is where
    channel mode's Megatron ``f`` goes).  Channel mode, ``model > 1``: the
    spatial conv's inputs, its activations (tag ``"spatial_in"``) and the
    effective adjacency (``"adjacency"``), are replicated over ``model``
    and feed a column-parallel conv, so each rank's gradient of them is
    its channels' share: they pass through
    :func:`~.collectives.copy_to_group` (identity forward, all-reduce of
    the gradient over ``model`` backward).  Joint mode and other tags:
    the identity."""
    from stgcn_tpu_torch.parallel.collectives import copy_to_group

    group = mesh.group(AXIS_MODEL)
    channel_tp = not shard_joints and mesh.shape[AXIS_MODEL] > 1

    def constrain(x, tag: str):
        if channel_tp and tag in ("spatial_in", "adjacency"):
            return copy_to_group(x, group)
        return x

    return constrain


def validate_joint_sharding(v: int, model_axis: int) -> None:
    """Joint (graph) sharding requires the model axis to divide V exactly
    (for V=25: 1, 5 or 25)."""
    if model_axis > 1 and v % model_axis:
        raise ValueError(
            f"V={v} joints not divisible by model axis {model_axis}; "
            f"joint sharding needs an axis size dividing V")


def validate_time_sharding(t: int, time_axis: int, total_stride: int = 4,
                           gamma: int = 9) -> None:
    """T must split evenly and keep stride phase aligned across shards.

    Each time shard's slice must be divisible by the cumulative temporal
    stride so the strided conv windows on shard boundaries line up with the
    single-device computation.
    """
    if t % time_axis:
        raise ValueError(f"T={t} not divisible by time axis {time_axis}")
    t_loc = t // time_axis
    if time_axis > 1 and t_loc % total_stride:
        raise ValueError(
            f"local T={t_loc} must be divisible by the cumulative stride "
            f"{total_stride} for sharded strided temporal convs")
