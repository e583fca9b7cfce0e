"""Data parallelism over the batch (counterpart of `tpufusion/parallel/mesh.py`).

The reference picks a `jax.sharding.Mesh`, shards the batch over its
`data` axis, replicates the parameters, and lets XLA's SPMD partitioner
insert the collectives. Here the mesh is a `torch.distributed` process
group, one rank a device, and the same names do the same jobs:

  make_mesh            the group (an initialized one, one from the
                       torchrun environment, or a group of one), the
                       rank's device, axis_names ("data",)
  batch_sharding       each rank takes rows [r B/n, (r+1) B/n) of a global
  shard_batch          batch of B rows, as P("data") lays them out
  replicate            parameters and buffers broadcast from rank 0
  image_sharding,      the identity on a data-only mesh
  constrain_spatial

Under SPMD a mean over a batch-sharded array is the global batch's mean,
so the port's collectives keep the reference's model, not DDP's:
`all_reduce_mean` / `all_reduce_sum` are differentiable (their backward
all-reduces the gradient, so the other ranks' rows reach every rank's
gradient), BatchNorm takes flax's own terms E[x] and E[x^2] over the
global batch through them (`models/fcn.py`), and `average_gradients`
averages the gradients in one flat all-reduce. Shards are equal, so an
average of per-rank means is the global mean; on a mesh of one every
collective returns its input's values, bit for bit.

Not in this slice: the `spatial` axis (width partitioning of the FCN with
halo exchanges for the 5 x 5 convolutions, the pools and the transposed
convolutions, BatchNorm statistics across the width shards too). A
MeshConfig with n_spatial > 1 raises (ROADMAP Queue 1, "The spatial mesh
axis").
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from tpufusion_torch.config import MeshConfig

SPATIAL_NOT_PORTED = (
    "the spatial mesh axis (width partitioning of the FCN with halo exchanges) is not "
    "ported: ROADMAP Queue 1, \"The spatial mesh axis\"; use n_spatial=1"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel mesh."""

    group: dist.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    backend: str
    axis_names: tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.world_size}


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    if device.index is None:  # torchrun sets LOCAL_RANK: one card a rank
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    torch.cuda.set_device(device)  # also raises here when there is no card
    return device


def make_mesh(
    cfg: MeshConfig = MeshConfig(),
    device: torch.device | str = "cuda",
    backend: str | None = None,
) -> Mesh:
    """The data-parallel mesh of this process.

    It uses the process group already initialized, or initializes one from
    the torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
    or, with neither and cfg.n_devices of 0 or 1, a group of one on a free
    localhost port. cfg.n_devices (0: the group's size) must equal the
    world size. `device` "cuda" gives each rank its card, cuda:<LOCAL_RANK>;
    "cuda:<i>" puts every rank on card i (ranks sharing a card need
    backend="gloo": NCCL refuses two ranks on one device); "cpu" runs on
    the CPU. `backend` defaults to NCCL on the card and gloo on the CPU."""
    if cfg.n_spatial > 1:
        raise NotImplementedError(SPATIAL_NOT_PORTED)
    device = torch.device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            torch.empty(0, device=device)  # without a card, raise before any group exists
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        elif cfg.n_devices in (0, 1):
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        else:
            raise RuntimeError(
                f"a mesh of {cfg.n_devices} ranks needs a process group: launch with "
                "torchrun, or call torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if cfg.n_devices and cfg.n_devices != world:
        raise ValueError(f"MeshConfig(n_devices={cfg.n_devices}) on a group of {world} ranks")
    return Mesh(group=dist.group.WORLD, rank=rank, world_size=world,
                device=_rank_device(device, rank), backend=dist.get_backend(),
                axis_names=(cfg.data_axis,))


def _check(mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis split over the data axis: this rank's
    contiguous block of rows."""

    mesh: Mesh

    def rows(self, global_batch: int) -> slice:
        n = self.mesh.world_size
        if global_batch % n:
            raise ValueError(f"a batch of {global_batch} rows does not split over {n} ranks")
        per = global_batch // n
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole tensor (rank 0's values)."""

    mesh: Mesh


def batch_sharding(mesh: Mesh) -> BatchSharding:
    _check(mesh)
    return BatchSharding(mesh)


def image_sharding(mesh: Mesh, ndim: int = 4) -> BatchSharding:
    """(B, H, W, ...) images: batch over data. On a data-only mesh the
    width is not split, so this is batch_sharding for any ndim >= 3."""
    if ndim < 3:
        raise ValueError(f"an image has at least 3 axes, got {ndim}")
    return batch_sharding(mesh)


def constrain_spatial(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Pin an image-like tensor to the data x spatial layout: the identity
    on a data-only mesh."""
    _check(mesh)
    return x


def replicated_sharding(mesh: Mesh) -> Replicated:
    _check(mesh)
    return Replicated(mesh)


def shard_batch(batch: dict, mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch (numpy arrays or tensors), as
    tensors on the mesh's device."""
    out = {}
    for k, v in batch.items():
        rows = batch_sharding(mesh).rows(len(v))
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v[rows]))
        else:
            v = v[rows]
        out[k] = v.to(mesh.device)
    return out


def replicate(tree, mesh: Mesh):
    """Broadcasts rank 0's values into every rank's copy, in place: a
    module's parameters and buffers, or a tensor, or a list / tuple / dict
    of tensors. Returns `tree`."""
    _check(mesh)
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


class _AllReduce(torch.autograd.Function):
    """Sum (or mean) over the ranks; the backward all-reduces the gradient
    the same way, so every rank's rows reach every rank's gradient."""

    @staticmethod
    def forward(ctx, x, group, divisor):
        ctx.group, ctx.divisor = group, divisor
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y.div_(divisor) if divisor != 1 else y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g.div_(ctx.divisor) if ctx.divisor != 1 else g), None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over the ranks of x, differentiable."""
    return _AllReduce.apply(x, mesh.group, 1)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ranks of x, differentiable: the global batch's
    mean of a per-rank mean, the shards being equal."""
    return _AllReduce.apply(x, mesh.group, mesh.world_size)


def average_gradients(params, mesh: Mesh) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, in
    one flat all-reduce (a missing gradient counts as zeros). Each
    `.grad` becomes a view of the one reduced buffer."""
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x concatenated along the batch axis in rank order: the
    global batch of a sharded result (bool goes as uint8, which every
    backend carries)."""
    _check(mesh)
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.world_size)]
    dist.all_gather(parts, send, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out
