"""Halo exchanges for width-sharded convolutions on a spatial mesh.

The reference leaves the spatial axis to GSPMD, which partitions each
convolution and inserts the exchanges a 5 x 5 kernel needs at the shard
edges. Here the FCN (`models/fcn.py`) asks for them itself: every layer
computes the columns it owns of its global output, and the columns of its
input that those outputs read are fetched with `fetch_columns`.

`fetch_columns(x, mesh, width, windows)` takes a tensor sharded on its
last axis in `parallel.mesh.column_blocks` of a global width `width`, and
every spatial rank's window [a, b) of global columns (each rank computes
them all from the layer's geometry, so every rank knows what its
neighbours will ask of it). It returns this rank's window, with zeros
outside [0, width), its columns taken from its own block and from the
edge strips of its immediate neighbours. A window that reaches past a
neighbour's block raises: the width is never gathered whole.

The strips go in one `all_gather` over the data row (gloo carries it for
CUDA tensors as well as NCCL does; gloo's point-to-point sends are for
CPU tensors): every rank contributes its first `SL` and its last `SR`
columns, `SL` and `SR` being the most any rank needs from its right and
its left neighbour. The backward sends each fetched column's gradient
back to the column's owner the same way, and the owner adds it, in the
window's dtype: a small float's FCN fetches float32 windows in training,
so that a column's partial dgrads are summed before any rounding, as
XLA's partitioned dgrad (the whole sum for a rank's own columns, from
the cotangent's halo) is rounded once. `block_columns` moves a
backward's columns into other blocks (a small float's bias gradient
reduces XLA's blocks of a layer's output, not the port's).

Every call adds to the mesh's `HaloStats` (`mesh.halo`) the columns it
received: (n_spatial - 1) * (SL + SR) a call, each a (B, C, H) slab.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpufusion_torch.parallel.mesh import Mesh, column_blocks


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One exchange's geometry: the blocks of `width` over the spatial
    ranks, each rank's window, how many columns each rank takes from its
    left (`left`) and right (`right`) neighbour, and the strip widths."""

    width: int
    blocks: tuple[slice, ...]
    windows: tuple[tuple[int, int], ...]
    left: tuple[int, ...]
    right: tuple[int, ...]

    @property
    def strip_left(self) -> int:  # SL: the first columns of a block, for its left neighbour
        return max(self.right)

    @property
    def strip_right(self) -> int:  # SR: the last columns of a block, for its right neighbour
        return max(self.left)

    @property
    def received(self) -> int:
        """Columns each rank receives in one exchange."""
        return (len(self.blocks) - 1) * (self.strip_left + self.strip_right)


def halo_plan(width: int, windows) -> HaloPlan:
    """The plan of an exchange over len(windows) spatial ranks. Raises
    ValueError when a window reaches past an immediate neighbour's block."""
    blocks = column_blocks(width, len(windows))
    left, right = [], []
    for s, ((a, b), own) in enumerate(zip(windows, blocks)):
        if b <= a:
            raise ValueError(f"spatial rank {s}: an empty window [{a}, {b})")
        lo, hi = max(a, 0), min(b, width)
        need_l = max(own.start - lo, 0)
        need_r = max(hi - own.stop, 0)
        if (need_l and (s == 0 or need_l > blocks[s - 1].stop - blocks[s - 1].start)) or (
                need_r and (s == len(blocks) - 1 or need_r > blocks[s + 1].stop - blocks[s + 1].start)):
            raise ValueError(
                f"spatial rank {s}: the window [{a}, {b}) of a width of {width} reaches past its "
                f"neighbours' blocks {[(x.start, x.stop) for x in blocks[max(s - 1, 0): s + 2]]}: "
                "too many spatial ranks for this layer's width")
        left.append(need_l)
        right.append(need_r)
    return HaloPlan(width, tuple(blocks), tuple(map(tuple, windows)), tuple(left), tuple(right))


def _fit(t: torch.Tensor, n: int, at_end: bool) -> torch.Tensor:
    """t's last axis cut or zero-padded to n columns, keeping its first
    columns (at_end False) or its last (at_end True)."""
    w = t.shape[-1]
    if w >= n:
        return t[..., w - n:] if at_end else t[..., :n]
    return F.pad(t, (n - w, 0) if at_end else (0, n - w))


def _is_channels_last(x: torch.Tensor) -> bool:
    return x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def _zeros(like: torch.Tensor, width: int, channels_last: bool) -> torch.Tensor:
    """Zeros of like's shape with `width` columns, NHWC-strided if asked:
    the FCN's activations are (permuted from its NHWC input), and a window
    kept so makes the convolution that reads it pick the kernels the
    unsharded FCN's picks, so both compute the same bits."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return torch.empty(*like.shape[:-1], width, dtype=like.dtype, device=like.device,
                       memory_format=fmt).zero_()


def _gather(send: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    parts = [torch.empty_like(send) for _ in range(mesh.n_spatial)]
    dist.all_gather(parts, send.contiguous(), group=mesh.spatial_group)
    return parts


def _window(x: torch.Tensor, mesh: Mesh, plan: HaloPlan) -> torch.Tensor:
    """This rank's window of `plan` from x, its block of the width."""
    s = mesh.spatial_index
    own = plan.blocks[s]
    if x.shape[-1] != own.stop - own.start:
        raise ValueError(f"spatial rank {s} holds {x.shape[-1]} columns of a width of "
                         f"{plan.width}; its block is [{own.start}, {own.stop})")
    a, b = plan.windows[s]
    sl, sr = plan.strip_left, plan.strip_right
    out = _zeros(x, b - a, _is_channels_last(x))
    lo, hi = max(a, own.start), min(b, own.stop)
    if lo < hi:
        out[..., lo - a: hi - a] = x[..., lo - own.start: hi - own.start]
    if sl + sr:
        parts = _gather(torch.cat([_fit(x, sl, False), _fit(x, sr, True)], dim=-1), mesh)
        if plan.left[s]:  # the last columns of the left neighbour's block
            src = parts[s - 1][..., sl:]
            lo, hi = max(a, 0), min(b, own.start)
            out[..., lo - a: hi - a] = src[..., sr - (own.start - lo): sr - (own.start - hi)]
        if plan.right[s]:  # the first columns of the right neighbour's block
            src = parts[s + 1][..., :sl]
            lo, hi = max(a, own.stop), min(b, plan.width)
            out[..., lo - a: hi - a] = src[..., lo - own.stop: hi - own.stop]
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, plan: HaloPlan):
        ctx.mesh, ctx.plan, ctx.own_width = mesh, plan, x.shape[-1]
        ctx.channels_last = _is_channels_last(x)
        out = _window(x, mesh, plan)
        stats = mesh.halo
        stats.calls += 1
        stats.columns += plan.received
        if stats.keep:
            stats.records.append({"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
                                  "width": plan.width, "windows": [list(w) for w in plan.windows],
                                  "received": plan.received})
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh, plan = ctx.mesh, ctx.plan
        s = mesh.spatial_index
        own = plan.blocks[s]
        a, b = plan.windows[s]
        sl, sr = plan.strip_left, plan.strip_right
        g = _zeros(grad, ctx.own_width, ctx.channels_last)
        lo, hi = max(a, own.start), min(b, own.stop)
        if lo < hi:
            g[..., lo - own.start: hi - own.start] = grad[..., lo - a: hi - a]
        if sl + sr:
            to_left = grad.new_zeros(*grad.shape[:-1], sr)  # aligned with the left block's last columns
            to_right = grad.new_zeros(*grad.shape[:-1], sl)  # with the right block's first columns
            if plan.left[s]:
                lo, hi = max(a, 0), min(b, own.start)
                to_left[..., sr - (own.start - lo): sr - (own.start - hi)] = grad[..., lo - a: hi - a]
            if plan.right[s]:
                lo, hi = max(a, own.stop), min(b, plan.width)
                to_right[..., lo - own.stop: hi - own.stop] = grad[..., lo - a: hi - a]
            parts = _gather(torch.cat([to_right, to_left], dim=-1), mesh)
            w = ctx.own_width
            if s + 1 < mesh.n_spatial and sr:  # the right neighbour's gradient of my last columns
                back = parts[s + 1][..., sl:]
                n = min(sr, w)
                g[..., w - n:] += back[..., sr - n:]
            if s > 0 and sl:  # the left neighbour's gradient of my first columns
                back = parts[s - 1][..., :sl]
                n = min(sl, w)
                g[..., :n] += back[..., :n]
            mesh.halo.grad_columns += plan.received
        return g, None, None


def fetch_columns(x: torch.Tensor, mesh: Mesh, width: int, windows) -> torch.Tensor:
    """Global columns [a, b) of x (sharded on its last axis in
    `column_blocks` of `width` over the spatial axis), zeros outside [0,
    width): `windows[s]` is spatial rank s's (a, b), this rank's is
    `windows[mesh.spatial_index]`. Differentiable."""
    return _Halo.apply(x, mesh, halo_plan(width, windows))


def block_columns(x: torch.Tensor, mesh: Mesh, width: int, windows) -> torch.Tensor:
    """`fetch_columns` without autograd and without the forward's count: a
    backward's columns moved into other blocks than the forward's (the
    small floats' bias gradient reduces each rank's block of XLA's layout,
    `models/fcn.py`). The columns it receives count as `grad_columns`."""
    plan = halo_plan(width, windows)
    with torch.no_grad():
        out = _window(x, mesh, plan)
    mesh.halo.grad_columns += plan.received
    return out
