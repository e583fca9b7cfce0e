"""Data x spatial meshes (counterpart of `tpufusion/parallel/mesh.py`).

The reference picks a `jax.sharding.Mesh`, shards the batch over its
`data` axis and, with `n_spatial > 1`, the range image's width over a
`spatial` axis, replicates the parameters, and lets XLA's SPMD
partitioner insert the collectives. Here the mesh is a
`torch.distributed` process group, one rank a device, laid out as the
reference lays its devices out: rank d has data coordinate d // n_spatial
and spatial coordinate d % n_spatial. The same names do the same jobs:

  make_mesh            the group (an initialized one, one from the
                       torchrun environment, or a group of one), the
                       rank's device, axis_names ("data",) or ("data",
                       "spatial"), and on a spatial mesh a process group
                       for each data row (the ranks that share a data
                       coordinate) and each spatial column
  batch_sharding       each data row takes rows [d B/n, (d+1) B/n) of a
  shard_batch          global batch of B rows, as P("data") lays them out;
                       the ranks of a row hold the same frames
  image_sharding,      the width cut into contiguous column blocks over
  constrain_spatial    the spatial axis (GSPMD's layout, `column_blocks`);
                       the identity on a data-only mesh
  all_gather_columns   the width put back together
  replicate            parameters and buffers broadcast from rank 0

Under SPMD a mean over a sharded array is the global array's mean, so the
port's collectives keep the reference's model, not DDP's. Every reduction
names its axis: `all_reduce_sum` sums over "data", "spatial" or the whole
mesh; `all_reduce_mean` divides a sum over the data axis, or over the
whole mesh, by the number of data rows. The data shards are equal, so
that is the global mean of per-rank means over rows; the spatial shards
are not (1801 columns split 901 / 900), so a mean over pixels on a spatial
mesh is each rank's sum divided by its data row's global count, then
summed over the spatial axis: never a mean of per-rank means. Both are
differentiable (their backward all-reduces the gradient, so the other
ranks' pixels reach every rank's gradient). BatchNorm takes flax's own
terms E[x] and E[x^2] over the global batch through them
(`models/fcn.py`), and `average_gradients` sums each rank's share of the
gradient over the spatial axis and averages over the data axis in one
flat all-reduce. A small float's gradients are combined in the format
instead, axis by axis in XLA's order (`reduce_gradients`). On a mesh of one every collective returns its input's
values, bit for bit, and a data-only mesh runs the ops it ran before the
spatial axis existed.

The halo exchanges that let a width-sharded convolution see its
neighbours' edge columns are `parallel/halo.py`.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpufusion_torch.config import MeshConfig


@dataclasses.dataclass
class HaloStats:
    """What the halo exchanges (`parallel/halo.py`) of one mesh moved, on
    this rank: forward exchanges `calls`, the columns they received
    (`columns`, each a (B, C, H) slab, every strip of the spatial
    all-gather counted) and the gradient columns their backwards received
    (`grad_columns`). With `keep` on, `records` also gets one entry a
    forward exchange: its input shape, dtype, global width, every spatial
    rank's window and the columns received."""

    calls: int = 0
    columns: int = 0
    grad_columns: int = 0
    keep: bool = False
    records: list = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.calls = self.columns = self.grad_columns = 0
        self.records.clear()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data (x spatial) mesh. `group` spans every
    rank; on a spatial mesh `data_group` spans this rank's spatial column
    (the ranks of its spatial coordinate, one a data row) and
    `spatial_group` its data row. On a data-only mesh `data_group` is
    `group` and `spatial_group` is None."""

    group: dist.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    backend: str
    axis_names: tuple[str, ...] = ("data",)
    n_spatial: int = 1
    data_group: dist.ProcessGroup | None = None
    spatial_group: dist.ProcessGroup | None = None
    halo: HaloStats = dataclasses.field(default_factory=HaloStats, compare=False)

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (self.n_data, self.n_spatial)))

    def axis_group(self, axis: str | None):
        """The process group of `axis`: "data" (this rank's spatial
        column), "spatial" (its data row) or None (every rank)."""
        if axis is None:
            return self.group
        if axis == "data":
            return self.data_group if self.data_group is not None else self.group
        if axis == "spatial":
            if self.spatial_group is None:
                raise ValueError("a data-only mesh has no spatial axis")
            return self.spatial_group
        raise ValueError(f"unknown mesh axis {axis!r}")


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
    """The data (x spatial) mesh of this process.

    It uses the process group already initialized, or initializes one from
    the torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
    or, with neither and cfg.n_devices of 0 or 1, a group of one on a free
    localhost port. cfg.n_devices (0: the group's size) must equal the
    world size. cfg.n_spatial > 1 lays the ranks out as a (world /
    n_spatial) x n_spatial grid, row-major as the reference reshapes its
    devices, and raises when n_spatial does not divide the world size; it
    creates the groups of every data row and every spatial column, so every
    rank must call it, in the same order. A second call on the same world
    makes another layout. `device` "cuda" gives each rank its card,
    cuda:<LOCAL_RANK>; "cuda:<i>" puts every rank on card i (ranks sharing
    a card need backend="gloo": NCCL refuses two ranks on one device);
    "cpu" runs on the CPU. `backend` defaults to NCCL on the card and gloo
    on the CPU."""
    if cfg.n_spatial < 1:
        raise ValueError(f"MeshConfig(n_spatial={cfg.n_spatial}) must be at least 1")
    if cfg.n_devices % cfg.n_spatial:
        raise ValueError(f"{cfg.n_devices} ranks are not divisible by n_spatial={cfg.n_spatial}")
    device = torch.device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            torch.empty(0, device=device)  # without a card, raise before any group exists
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        elif cfg.n_devices in (0, 1) and cfg.n_spatial == 1:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        else:
            raise RuntimeError(
                f"a mesh of {cfg.n_devices or cfg.n_spatial} ranks needs a process group: launch "
                "with torchrun, or call torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if cfg.n_devices and cfg.n_devices != world:
        raise ValueError(f"MeshConfig(n_devices={cfg.n_devices}) on a group of {world} ranks")
    if world % cfg.n_spatial:
        raise ValueError(f"{world} ranks are not divisible by n_spatial={cfg.n_spatial}")
    mesh = dict(group=dist.group.WORLD, rank=rank, world_size=world,
                device=_rank_device(device, rank), backend=dist.get_backend())
    k = cfg.n_spatial
    if k == 1:
        return Mesh(**mesh, axis_names=(cfg.data_axis,))
    groups = {}
    for axis, members in (("spatial", [list(range(d * k, (d + 1) * k)) for d in range(world // k)]),
                          ("data", [list(range(s, world, k)) for s in range(k)])):
        for ranks in members:  # every rank creates every group, in one order
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(**mesh, axis_names=(cfg.data_axis, cfg.spatial_axis), n_spatial=k,
                data_group=groups["data"], spatial_group=groups["spatial"])


def _check(mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")


def column_blocks(width: int, n: int) -> list[slice]:
    """The width cut into n contiguous blocks as GSPMD cuts it: every block
    holds ceil(width / n) columns except the last, which holds the rest
    (1801 over 2: 901 / 900). Raises when a block would be empty."""
    per = -(-width // n)
    if per * (n - 1) >= width:
        raise ValueError(f"a width of {width} columns leaves a block empty over {n} spatial ranks")
    return [slice(s * per, min((s + 1) * per, width)) for s in range(n)]


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis split over the data axis: this rank's data
    row's contiguous block of rows. The width stays whole."""

    mesh: Mesh

    def rows(self, global_batch: int) -> slice:
        n = self.mesh.n_data
        if global_batch % n:
            raise ValueError(f"a batch of {global_batch} rows does not split over {n} data rows")
        per = global_batch // n
        return slice(self.mesh.data_index * per, (self.mesh.data_index + 1) * per)


@dataclasses.dataclass(frozen=True)
class ImageSharding(BatchSharding):
    """(B, H, W, ...) images on a spatial mesh: rows over data, the width
    over spatial in `column_blocks`."""

    def columns(self, width: int) -> slice:
        return column_blocks(width, self.mesh.n_spatial)[self.mesh.spatial_index]


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole tensor (rank 0's values)."""

    mesh: Mesh


def batch_sharding(mesh: Mesh) -> BatchSharding:
    _check(mesh)
    return BatchSharding(mesh)


def image_sharding(mesh: Mesh, ndim: int = 4) -> BatchSharding:
    """(B, H, W, ...) images: batch over data, width over spatial if the
    mesh has the axis (ndim 3 covers (B, H, W) masks). On a data-only mesh
    this is batch_sharding for any ndim >= 3."""
    if ndim < 3:
        raise ValueError(f"an image has at least 3 axes, got {ndim}")
    _check(mesh)
    return ImageSharding(mesh) if mesh.n_spatial > 1 else BatchSharding(mesh)


def constrain_spatial(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's columns (`column_blocks` of x.shape[2]) of an image-like
    tensor (B, H, W[, C]) whose width is whole on every rank: the identity
    on a data-only mesh."""
    _check(mesh)
    if mesh.n_spatial == 1:
        return x
    return x[:, :, image_sharding(mesh, x.ndim).columns(x.shape[2])]


def all_gather_columns(x: torch.Tensor, mesh: Mesh, width: int) -> torch.Tensor:
    """The whole width of a tensor (B, H, W[, C]) sharded on its width in
    `column_blocks` over this rank's data row (bool goes as uint8, which
    every backend carries): the inverse of `constrain_spatial`, not
    differentiable. The identity on a data-only mesh."""
    _check(mesh)
    if mesh.n_spatial == 1:
        return x
    blocks = column_blocks(width, mesh.n_spatial)
    per = blocks[0].stop
    send = x.to(torch.uint8) if x.dtype == torch.bool else x
    send = send.movedim(2, -1)
    send = F.pad(send, (0, per - send.shape[-1])).contiguous()
    parts = [torch.empty_like(send) for _ in blocks]
    dist.all_gather(parts, send, group=mesh.spatial_group)
    out = torch.cat([p[..., : b.stop - b.start] for p, b in zip(parts, blocks)], dim=-1).movedim(-1, 2)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def replicated_sharding(mesh: Mesh) -> Replicated:
    _check(mesh)
    return Replicated(mesh)


def shard_batch(batch: dict, mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's data row's rows of a global batch (numpy arrays or
    tensors), as tensors on the mesh's device."""
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
    """Sum (then a division) over a group; the backward all-reduces the
    gradient the same way, so every rank's pixels reach every rank's
    gradient."""

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


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """Σ of x over the ranks of `axis` ("data", "spatial", or None for the
    whole mesh), differentiable."""
    return _AllReduce.apply(x, mesh.axis_group(axis), 1)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """Σ of x over `axis` ("data" or None, the whole mesh) divided by the
    number of data rows, differentiable. Each rank's x is its data row's
    value, or on the whole mesh of a spatial mesh its share of that value
    (a sum over its columns divided by the row's global count), so this
    is the global batch's mean over equal row shards. There is no mean
    over the spatial axis alone: its shards are unequal."""
    if axis not in (None, "data"):
        raise ValueError("a mean over unequal spatial shards is not a mean: sum the shares "
                         "(all_reduce_sum) and divide by the global count")
    return _AllReduce.apply(x, mesh.axis_group(axis), mesh.n_data)


def average_gradients(params, mesh: Mesh) -> None:
    """Every parameter's gradient replaced by its global value in one flat
    all-reduce (a missing gradient counts as zeros): each rank's gradient
    is its share of its data row's gradient, so the sum over the mesh is
    divided by the number of data rows (summed over spatial, averaged over
    data). Each `.grad` becomes a view of the one reduced buffer."""
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.n_data)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def reduce_gradients(plan, mesh: Mesh, fmt) -> None:
    """A small float's gradients combined over the mesh as XLA's
    partitioned program combines them (`average_gradients` for every
    other dtype). `plan`: (parameter, axes) pairs (`FCN.gradient_plan`),
    each rank's gradient already the format's values and its share of the
    global batch's gradient (the loss's `global_share`), so nothing is
    divided. Over each axis in turn ("data", "spatial"; an axis of one
    rank, or one the mesh lacks, is skipped) the ranks' values are
    gathered and every rank sums them in rank order, each sum rounded to
    float16, the total to the format (`small_float.sum_in_order`, XLA's
    CPU all-reduce of the format's float16 values); axes None: a float32
    gradient summed over the whole mesh. A missing gradient counts as
    zeros."""
    from tpufusion_torch.ops.small_float import sum_in_order

    sizes = {"data": mesh.n_data, "spatial": mesh.n_spatial}
    for p, _ in plan:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    plain = [p for p, axes in plan if axes is None]
    if plain:
        flat = torch.cat([p.grad.reshape(-1) for p in plain])
        dist.all_reduce(flat, group=mesh.group)
        for p, g in zip(plain, flat.split([p.numel() for p in plain])):
            p.grad = g.view_as(p).clone()
    for step in range(2):
        for axis in ("data", "spatial"):
            params = [p for p, axes in plan if axes is not None and len(axes) > step
                      and axes[step] == axis]
            if not params or sizes[axis] == 1:
                continue
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            parts = [torch.empty_like(flat) for _ in range(sizes[axis])]
            dist.all_gather(parts, flat.contiguous(), group=mesh.axis_group(axis))
            total = sum_in_order(parts, fmt)
            for p, g in zip(params, total.split([p.numel() for p in params])):
                p.grad = g.view_as(p).clone()


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data row's x concatenated along the batch axis in data order,
    gathered over this rank's spatial column: the global batch of a
    sharded result (bool goes as uint8, which every backend carries)."""
    _check(mesh)
    group = mesh.axis_group("data")
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.n_data)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out
