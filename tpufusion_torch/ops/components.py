"""Plain connected-component labelling with bbox extents (counterpart of
`tpufusion/ops/components.py`), written out over a batch of frames.

The state is the reference's channel stack (-flat_id, -col, col, -row,
row) with background at -BIG. Each sweep takes the max over shifts
{1, 2, 4, 8, 16} along columns and {1, 2, 4} along rows, each shift gated
so it stays inside one foreground run, and resets background; the loop
stops when no frame changes or at `max_iters`. A frame that has converged
is a fixed point of the sweep, so sweeping the batch until its slowest
frame converges gives every frame the reference's per-frame result. No
wrap across column 0 / W-1: the shifts pad with -BIG.

This is the plain version of the CUDA kernel `csrc/components.cu`; the
dispatch between the two lives in `ops/cc.py`.
"""

from __future__ import annotations

import torch

_BIG = torch.iinfo(torch.int32).max - 1

_H_DISTS = (1, -1, 2, -2, 4, -4, 8, -8, 16, -16)
_V_DISTS = (1, -1, 2, -2, 4, -4)


def _shift(x: torch.Tensor, axis: int, d: int, fill) -> torch.Tensor:
    """out[..., i, ...] = x[..., i - d, ...] where in range, else `fill`."""
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(axis, d, n - d).copy_(x.narrow(axis, 0, n - d))
    else:
        out.narrow(axis, 0, n + d).copy_(x.narrow(axis, -d, n + d))
    return out


def _run_gates(mask: torch.Tensor, axis: int, dists) -> dict:
    """gate[d] = True where the |d|-1 cells between a pixel and its pull
    source are all foreground (None for |d| = 1)."""
    gates = {}
    for d in dists:
        if abs(d) == 1:
            gates[d] = None
            continue
        step = 1 if d > 0 else -1
        g = None
        for j in range(1, abs(d)):
            m = _shift(mask, axis, step * j, False)
            g = m if g is None else (g & m)
        gates[d] = g
    return gates


def propagate(
    st0: torch.Tensor,  # (B, C, H, W) int32
    mask: torch.Tensor,  # (B, H, W) bool
    max_iters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed point of the gated sweeps -> (state, sweeps (B,) int32), where
    sweeps[b] counts the sweeps frame b ran, the last being the one that
    changed nothing (as the reference's while_loop counts them)."""
    h_gates = _run_gates(mask, 2, _H_DISTS)  # (B, H, W): columns are axis 2
    v_gates = _run_gates(mask, 1, _V_DISTS)
    fg = mask[:, None]

    def sweep(st):
        out = st
        for axis, dists, gates in ((3, _H_DISTS, h_gates), (2, _V_DISTS, v_gates)):
            for d in dists:
                s = _shift(st, axis, d, -_BIG)
                g = gates[d]
                if g is not None:
                    s = torch.where(g[:, None], s, -_BIG)
                out = torch.maximum(out, s)
        return torch.where(fg, out, -_BIG)

    st = st0
    sweeps = torch.zeros(st0.shape[0], dtype=torch.int32, device=st0.device)
    active = torch.ones(st0.shape[0], dtype=torch.bool, device=st0.device)
    for _ in range(max_iters):
        nxt = sweep(st)
        sweeps += active.to(torch.int32)
        active = active & (nxt != st).flatten(1).any(dim=1)
        st = nxt
        if not bool(active.any()):
            break
    return st, sweeps


def init_state(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, 5, H, W) int32 (-flat_id, -col, col, -row, row)."""
    b, h, w = mask.shape
    dev = mask.device
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    flat = rows * w + cols
    chans = torch.stack([-flat, -cols, cols, -rows, rows])[None]  # (1, 5, H, W)
    return torch.where(mask[:, None], chans, -_BIG).to(torch.int32)


def connected_components_with_bbox(mask: torch.Tensor, max_iters: int = 128):
    """(B, H, W) bool -> (labels, min_x, max_x, min_y, max_y), each
    (B, H, W) int32. Background: label -1, extents (BIG, -BIG, BIG, -BIG)."""
    st, _ = propagate(init_state(mask), mask, max_iters)
    labels = torch.where(mask, -st[:, 0], -1)
    return labels, -st[:, 1], st[:, 2], -st[:, 3], st[:, 4]
