"""The (data, model) mesh of the ranks and the placement rules.

Port of ``segmantic_tpu/parallel/mesh.py`` under PyTorch's process model:
one process per card (``torchrun --nproc-per-node N`` or
``torch.multiprocessing.spawn``), rank r computing on ``cuda:LOCAL_RANK``,
where the JAX package drives every device of a host from one process. A JAX
process (a host) is a torchrun node here: the agent whose ``LOCAL_WORLD_SIZE``
ranks share ``GROUP_RANK``; torchrun numbers the ranks node by node. The names
are the JAX ones:

- :func:`initialize_distributed` starts the process group from torchrun's
  environment (a no-op where none is set); ``LOCAL_WORLD_SIZE`` gives the
  nodes;
- :func:`make_mesh` arranges the ranks as a (data, model) grid, rank
  ``i * model + j`` at (i, j), as the JAX mesh reshapes its process-major
  device list, with a process group along each axis; a world of one needs no
  process group. The mesh carries ``process_index`` / ``process_count``, the
  node's index and the number of nodes (0 and 1 on one node);
- :func:`put_batch` / :func:`shard_batch` keep this rank's rows of a batch.
  On one node the batch is the global batch: a rank keeps its rows when the
  data axis divides their count, else the whole batch (the JAX package
  replicates such a batch). On several nodes each node passes its own
  batch, and the global batch is the nodes' batches in node order (the
  JAX package's ``make_array_from_process_local_data``): a rank keeps its
  rows of its node's batch, by its data index within the node;
- :func:`replicate` broadcasts a module's parameters and buffers from rank 0;
- :func:`shard_params` is tensor parallelism: the rule of the JAX function
  (output-feature axis >= ``min_features`` and divisible by the model axis)
  on the flax layout of each tensor (:func:`flax_axes`); the kernels it
  picks are sliced along their output axis and their layers run
  column-parallel (``Conv`` / ``ConvTranspose`` / ``Dense``), the 1-D
  vectors it picks stay whole on every rank;
- :func:`zero_placement` / :func:`shard_opt_state` are ZeRO-1: each moment
  tensor of the optimizer is sliced over the data axis along the largest
  axis that divides, chosen on the flax layout as the JAX rule chooses.

Across nodes the model axis stays inside a node: ``model`` must divide
``LOCAL_WORLD_SIZE``, so that every row of the mesh lies on one node and is
fed by one node's batch. A row across nodes would be fed by processes that
draw different rows; :func:`make_mesh` refuses it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import comm

__all__ = [
    "Mesh", "initialize_distributed", "make_mesh", "put_batch", "shard_batch", "replicate",
    "flax_axes", "tp_placement", "shard_params", "gather_params", "unshard_params",
    "zero_placement", "shard_opt_state", "TensorParallel", "is_main", "splits_batch",
]

def _local_world_size(world: int) -> int:
    """The ranks a node: torchrun's ``LOCAL_WORLD_SIZE``, the world where it
    is not set (one node)."""
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_node < 1 or world % per_node:
        raise ValueError(f"{world} ranks do not form nodes of {per_node} ranks: the nodes "
                         "must hold the same number of ranks")
    return per_node


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           local_rank: Optional[int] = None,
                           local_world_size: Optional[int] = None) -> bool:
    """Start the default process group; returns whether one is running.

    Without arguments it reads torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` and does
    nothing when ``WORLD_SIZE`` is not set (or a group is already running).
    ``LOCAL_WORLD_SIZE`` is the ranks of a node (the world where it is not
    set); torchrun numbers the ranks node by node, so rank r runs on node
    ``r // LOCAL_WORLD_SIZE``. A ``local_world_size`` argument is exported as
    ``LOCAL_WORLD_SIZE``, as torchrun sets it for its ranks. The backend
    defaults to NCCL where CUDA is available and gloo otherwise (the entry
    points pass NCCL for the card, gloo for ``device="cpu"``); under NCCL the
    process takes ``cuda:LOCAL_RANK`` as its device."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return False
    world_size = int(world_size if world_size is not None else env["WORLD_SIZE"])
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None else env.get("LOCAL_RANK", rank))
    if local_world_size is not None:
        if local_world_size < 1 or world_size % local_world_size:
            raise ValueError(f"{world_size} ranks do not form nodes of {local_world_size} "
                             "ranks: the nodes must hold the same number of ranks")
        env["LOCAL_WORLD_SIZE"] = str(local_world_size)
    if init_method is None:
        init_method = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks. ``shape`` reads as the JAX mesh's
    (``mesh.shape["data"]``); ``data_group`` / ``model_group`` are the
    process groups of this rank's row and column (None without a process
    group, where the mesh is one rank)."""

    shape: Dict[str, int]
    ranks: tuple  # the global ranks, data-major
    rank: int  # this process's global rank
    data_group: Any = None
    model_group: Any = None
    process_index: int = 0  # this rank's node (the JAX process index)
    process_count: int = 1  # the number of nodes (the JAX process count)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def position(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def data_index(self) -> int:
        return self.position // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.position % self.shape["model"]

    @property
    def local_data(self) -> int:
        """The data rows of the mesh on one node: the rows a node's batch is
        split into."""
        return self.shape["data"] // self.process_count

    @property
    def local_data_index(self) -> int:
        """This rank's data index within its node."""
        return self.data_index - self.process_index * self.local_data

    @property
    def distributed(self) -> bool:
        """Does the mesh run collectives (a process group is running)?"""
        return self.data_group is not None

    def peer(self, data_index: int) -> int:
        """Global rank at (data_index, this rank's model index)."""
        return self.ranks[data_index * self.shape["model"] + self.model_index]


def _group(ranks: Sequence[int]):
    """The process group of ``ranks`` (the default group when it is the
    world). Every rank creates every group, in the same order."""
    ranks = [int(r) for r in ranks]
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(devices: Optional[Sequence[int]] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A (data, model) mesh over ``devices``, the global ranks (default: the
    world's). ``data`` defaults to ``len(devices) // model``. Every rank of
    the world calls it alike (the axis groups are created collectively).

    On more than one node the mesh takes every rank in order and ``model``
    divides the ranks of a node (``LOCAL_WORLD_SIZE``), so that each node
    holds whole rows of the mesh; anything else raises ``ValueError``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    devices = list(range(world)) if devices is None else [int(d) for d in devices]
    if data is None:
        data = len(devices) // model
    if data < 1 or model < 1 or data * model > len(devices):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, "
                         f"{len(devices)} given")
    grid = np.asarray(devices[:data * model]).reshape(data, model)
    shape = {"data": int(data), "model": int(model)}
    if not dist.is_initialized():
        if grid.size != 1:
            raise ValueError(f"a mesh of {grid.size} ranks needs a running process group "
                             "(initialize_distributed)")
        return Mesh(shape, (0,), 0)
    per_node = _local_world_size(world)
    nodes = world // per_node
    if nodes > 1 and (grid.reshape(-1).tolist() != list(range(world)) or per_node % model):
        raise ValueError(
            f"a ({data}, {model}) mesh over {nodes} nodes of {per_node} ranks: across nodes "
            "the mesh takes every rank in order and model_parallel must divide the ranks of "
            "a node (LOCAL_WORLD_SIZE), so that each row of the mesh is fed by one node's "
            "batch")
    data_groups = [_group(grid[:, j]) for j in range(model)]
    model_groups = [_group(grid[i, :]) for i in range(data)]
    ranks = tuple(int(r) for r in grid.reshape(-1))
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh {ranks}")
    i, j = divmod(ranks.index(rank), model)
    return Mesh(shape, ranks, rank, data_groups[j], model_groups[i], rank // per_node,
                nodes)


def is_main(mesh: Optional[Mesh] = None) -> bool:
    """Is this a rank that writes files: the first rank of its node (global
    rank 0 on one node)? The JAX package writes from every process, a node
    here."""
    if mesh is not None:
        return mesh.position % (mesh.size // mesh.process_count) == 0
    return not dist.is_initialized() or \
        dist.get_rank() % _local_world_size(dist.get_world_size()) == 0


def splits_batch(mesh: Optional[Mesh], rows: int) -> bool:
    """Does each rank take its rows of a batch of ``rows`` (:func:`put_batch`,
    the gradients then averaged over the data group)? With a process group:
    on one node when the data axis divides ``rows`` (at a data axis of 1 the
    rows are the whole batch), on several nodes always (each node's batch is
    its own)."""
    if mesh is None or not mesh.distributed:
        return False
    return mesh.process_count > 1 or rows % mesh.shape["data"] == 0


def put_batch(mesh: Optional[Mesh], x):
    """This rank's rows of ``x`` (numpy or tensor). On one node ``x`` is the
    global batch: the rank's rows when the data axis divides their count,
    else the whole batch. On several nodes ``x`` is this node's batch (the
    global batch is the nodes' batches in node order): the rank's rows of it
    by its data index within the node; the node's data rows must divide its
    row count (``ValueError`` otherwise, as ``make_array_from_process_local_data``
    refuses a local batch its devices cannot split)."""
    if mesh is None:
        return x
    n = mesh.local_data
    rows = x.shape[0]
    if mesh.process_count > 1:
        if rows % n:
            raise ValueError(f"a node's batch of {rows} rows does not split over its {n} "
                             "data rows")
    elif n == 1 or rows % n:
        return x
    k = rows // n
    i = mesh.local_data_index
    return x[i * k:(i + 1) * k]


def shard_batch(mesh: Optional[Mesh], batch):
    """:func:`put_batch` over a dict, list or tuple of arrays."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return put_batch(mesh, batch)


def replicate(mesh: Optional[Mesh], module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the parameters and buffers of ``module`` from the mesh's
    first rank, in place; returns the module."""
    if mesh is not None and mesh.distributed and mesh.size > 1:
        with torch.no_grad():
            comm.broadcast_([t.data for t in module.parameters()]
                            + [t.data for t in module.buffers()], src=mesh.ranks[0])
    return module


# -- placements ---------------------------------------------------------------


def _owners(module: torch.nn.Module):
    """(owner module, local name, tensor) of every parameter and buffer."""
    for owner in module.modules():
        for name, t in owner.named_parameters(recurse=False):
            yield owner, name, t
        for name, t in owner.named_buffers(recurse=False):
            yield owner, name, t


def flax_axes(owner: torch.nn.Module, name: str, ndim: int) -> List[int]:
    """The torch axes of a tensor in the order of its flax layout:
    ``flax_shape[j] == torch_shape[flax_axes(...)[j]]``. Conv kernels are
    (O, I, *k) here and (*k, I, O) in flax, transposed-conv kernels
    (Ci, Co, *k) and (*k, Ci, Co), Dense kernels (out, in) and (in, out);
    every other tensor has flax's layout."""
    from ..models.unet import Conv, ConvTranspose
    from ..models.unetr import Dense

    if name == "weight" and ndim > 2 and isinstance(owner, Conv):
        return list(range(2, ndim)) + [1, 0]
    if name == "weight" and ndim > 2 and isinstance(owner, ConvTranspose):
        return list(range(2, ndim)) + [0, 1]
    if name == "weight" and ndim == 2 and isinstance(owner, Dense):
        return [1, 0]
    return list(range(ndim))


def tp_placement(module: torch.nn.Module, model_size: int,
                 min_features: int = 64) -> Dict[str, int]:
    """{state_dict key: torch axis} of the tensors the JAX ``shard_params``
    rule shards over 'model': those whose flax output-feature axis (the last)
    is >= ``min_features`` and divisible by ``model_size``, except the
    layers of a phase-space region (``phase_space``, packed UNETR's), which
    stay whole: their outputs are phase-major, and gathering their column
    slices as plain channels would interleave the phases wrongly."""
    out: Dict[str, int] = {}
    if model_size <= 1:
        return out
    names = {id(t): k for k, t in module.state_dict(keep_vars=True).items()}
    for owner, name, t in _owners(module):
        if t.ndim < 1 or getattr(owner, "phase_space", False):
            continue
        axis = flax_axes(owner, name, t.ndim)[-1]
        if t.shape[axis] >= min_features and t.shape[axis] % model_size == 0:
            out[names[id(t)]] = axis
    return out


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A column-parallel layer's share: ``index`` of ``size`` slices of its
    kernel's output axis, gathered over ``group``."""

    group: Any
    index: int
    size: int

    def column(self, x: torch.Tensor, fn) -> torch.Tensor:
        """``fn`` (the layer with its local kernel) on x, its output channels
        all-gathered; the gradient of x summed over the group."""
        y = fn(comm.copy_to_group(x, self.group))
        return comm.gather_channels(y, self.group, self.index, self.size)


def _column_layers():
    from ..models.unet import Conv, ConvTranspose
    from ..models.unetr import Dense

    return (Conv, ConvTranspose, Dense)


def shard_params(mesh: Mesh, module: torch.nn.Module,
                 min_features: int = 64) -> Dict[str, int]:
    """Tensor-parallel placement over the mesh's 'model' axis, in place.

    The kernels :func:`tp_placement` picks keep this rank's slice of their
    output axis and their layers run column-parallel (the layer's own route
    on the local kernel, the output channels all-gathered over the model
    group, the input's gradient summed over it). The 1-D vectors it picks
    (bias, norm scale and shift, running statistics) stay whole; so do
    UNETR's attention projections and position embedding, and the layers of
    its phase-space region (:func:`tp_placement`). Returns {key:
    axis} of the sliced kernels. A model axis of 1 changes nothing."""
    m = mesh.shape["model"]
    picked = tp_placement(module, m, min_features)
    sliced: Dict[str, int] = {}
    if not picked:
        return sliced
    tp = TensorParallel(mesh.model_group, mesh.model_index, m)
    keys = {id(t): k for k, t in module.state_dict(keep_vars=True).items()}
    for owner, name, t in list(_owners(module)):
        key = keys[id(t)]
        if key not in picked or t.ndim < 2 or not isinstance(owner, _column_layers()):
            continue
        axis = picked[key]
        k = t.shape[axis] // m
        with torch.no_grad():
            t.data = t.data.narrow(axis, tp.index * k, k).clone()
        owner.tp = tp
        sliced[key] = axis
    module._tp_sliced = sliced
    return sliced


def gather_params(mesh: Optional[Mesh], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's whole ``state_dict``: the kernels :func:`shard_params`
    sliced are all-gathered over the model group (every rank of the group
    calls it)."""
    state = dict(module.state_dict())
    sliced = getattr(module, "_tp_sliced", {})
    if mesh is None or not sliced:
        return state
    m = mesh.shape["model"]
    for key, axis in sliced.items():
        local = state[key].movedim(axis, 0).contiguous()
        full = torch.empty((m * local.shape[0],) + local.shape[1:], dtype=local.dtype,
                           device=local.device)
        dist.all_gather_into_tensor(full, local, group=mesh.model_group)
        state[key] = full.movedim(0, axis).contiguous()
    return state


def unshard_params(mesh: Optional[Mesh], module: torch.nn.Module) -> torch.nn.Module:
    """Undo :func:`shard_params`: every rank holds the whole kernels again and
    the layers run unsharded."""
    if not getattr(module, "_tp_sliced", None):
        return module
    state = gather_params(mesh, module)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for key in module._tp_sliced:
            params[key].data = state[key]
    for owner in module.modules():
        if "tp" in owner.__dict__:
            del owner.tp
    module._tp_sliced = {}
    return module


def zero_placement(mesh: Mesh, x) -> Optional[int]:
    """ZeRO-1 placement of one leaf (a tensor or a shape): the axis sharded
    over 'data', the largest one the data size divides (the first of equal
    ones), or None (scalars and leaves without one replicate)."""
    n = int(mesh.shape["data"])
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    if n <= 1 or not shape:
        return None
    divisible = [i for i in range(len(shape)) if shape[i] >= n and shape[i] % n == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda i: shape[i])


def shard_opt_state(mesh: Mesh, optimizer: torch.optim.Optimizer,
                    module: torch.nn.Module) -> torch.optim.Optimizer:
    """ZeRO-1, in place: the optimizer steps this rank's slice of each
    parameter (a view into it) along the axis :func:`zero_placement` picks
    on the parameter's flax layout, so every moment tensor it creates or
    holds is 1/N of the parameter's; leaves without such an axis stay whole.
    ``optimizer.zero_shards`` lists ``(parameter, slice, axis or None)`` for
    the train step: it reduce-scatters the gradients into the slices, steps,
    and all-gathers the parameters."""
    if getattr(optimizer, "zero_shards", None) is not None:
        return optimizer
    n, i = mesh.shape["data"], mesh.data_index
    owners = {id(t): (o, name) for o, name, t in _owners(module)}
    shards = []
    for group in optimizer.param_groups:
        new_params = []
        for p in group["params"]:
            owner, name = owners[id(p)]
            order = flax_axes(owner, name, p.ndim)
            fa = zero_placement(mesh, [p.shape[a] for a in order])
            if fa is None:
                shards.append((p, p, None))
                new_params.append(p)
                continue
            axis = order[fa]
            k = p.shape[axis] // n
            piece = p.detach().narrow(axis, i * k, k)
            state = optimizer.state.pop(p, None)
            if state:
                optimizer.state[piece] = {
                    key: (v.narrow(axis, i * k, k).clone()
                          if torch.is_tensor(v) and v.shape == p.shape else v)
                    for key, v in state.items()}
            shards.append((p, piece, axis))
            new_params.append(piece)
        group["params"] = new_params
    optimizer.zero_shards = shards
    return optimizer
