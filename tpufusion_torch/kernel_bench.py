"""Kernel timing on the card: CUDA-event timers, each kernel's bound, its
library yardstick, and an A/B of the kernels against an earlier design.

`chip_smoke.py` times the kernels with these helpers. Run alone, on a
machine with an NVIDIA GPU and nvcc, it times the current kernels
against the previous design's sources in turns, in one process:

    python -m tpufusion_torch.kernel_bench --old-csrc DIR

DIR holds an earlier `components.cu` and `nearest_wins.cu` with their
eight- and eleven-argument C interfaces:
`tf_components_with_bbox(mask, scratch (5, B*H*W) int32, labels, ext, B, H,
W, stream)` and `tf_nearest_wins_image(pix, key, valid, payload, grid
(B, P) int64 filled with INT64_MAX, img, B, N, P, min_height, stream)`;
the earlier wrapper's fill of the grid counts as part of its call; where
DIR also holds the packed z-buffer of its twelve-argument interface,
`tf_nearest_wins_packed_image(pix, key, valid, payload, grid (B, P) int32,
img, B, N, P, idx_bits, min_height, stream)` (its grid in L2, the kernel
fills it), the packed kernels are held against each other too. Both
the first design (the four-launch global-memory union-find, and the fill
/ scatter / gather z-buffer) and the 32-row strip union-find with the
cluster z-buffer take them (the strips' frame counters fit in the
scratch, the cluster kernel fills the grid itself), so either can be
held against the current 32 x 64 tiles. The
inputs are chip_smoke's: beam scans at 64 x 32,768 points with the
float32 asset's heat masks, and config 5's 16 x 131,072 (64 beams) with
the bf16 asset's. Every pair of kernels is checked equal on every input
before it is timed. Each function is timed in turns (old, new,
yardstick, yardstick, new, old), once between CUDA events per call (what
a caller waits, the host's launch work included) and once as device time
(the calls queued behind a sleep, `queued_ms`). The packed rows time, in
turns at 64 x 32,768 and 16 x 131,072 into 32 x 1801 and at 64 x 32,768
of 64 beams into 63 x 1801: the earlier packed kernel, the current one,
the current one built with 8-CTA clusters (`-DTF_PACKED_CLUSTER=8`), the
exact kernel and the yardstick (`packed_amin_yardstick`), and the current
kernel on the same inputs with every point invalid (its fill, decode and
image stores alone). The encode rows time the fused label-encode kernel
and its plain version (the torch composition it replaced) in turns at 32
x 32 x 1801 and 32 x 63 x 1801, beside a fill of the label's size; the
encode_direct rows the direct head's kernel likewise, at 10 and 12
channels. The decode_direct rows time the direct head's per-cluster
decode kernel and its plain version (the torch composition it replaced)
in turns, beside an empty kernel (the launch floor) and the kernel's
bound (the bytes its lanes need on the run's data,
`decode_direct_bound_bytes`), at DECODE_SHAPES: 64 x 32 x 1801 at k 1 with the live asset's
clusters, config 5's 16 frames at k 4, and 64 x 63 x 1801 at k 1; with
--old-csrc, DIR's direct decode (the one-CTA-a-lane design, the same C
interface) in the same turns ("old"), and with `--decode-clusters 4,8`
the current kernel built with 4 and 8 CTAs a lane ("new_c4", "new_c8");
with `--decode-dtypes float32,bfloat16,float16` the kernel's bf16 and
float16 instances and their plain versions on the same outputs rounded
to bf16 ("new_bf16", "plain_bf16") and to float16 ("new_f16",
"plain_f16") in the same turns, beside their bound at 2 B a channel.
The corner_vote rows time the corner head's vote kernel (handed the
positives map, as the decode hands it) and its plain version (the torch
composition it replaced) likewise, beside its bound (the larger of its
bytes at 3.35 TB/s and its FP32 FMAs, 24 a candidate pair, at 67 TFLOP/s,
`corner_vote_bound`), at CORNER_SHAPES: the corner row's 64 frames (its
seeded FCN votes no lane), the corner head on the asset's trunk at 64
frames k 1, 16 frames k 4 and 63 rows, and every lane at 2048 candidates
(at most 6 sets); with --old-csrc, DIR's vote (the three-launch design,
through its own C interface, reading y_pred's channel 1) in the same
turns. `--kernels` picks among exact, cc, packed, encode, encode_direct,
decode_direct, corner_vote, small_float and small_float_backward: the
small-float epilogue (`csrc/small_float.cu`) on the eight layers of one
forward of the shipped asset in float8_e4m3fn at 64 x 32 x 1801, the
kernel, its plain version and torch's own cast chain
(`small_float_yardstick`) in turns, beside the bound of its bytes, and
the input cast beside one `x.to(torch.float8_e4m3fn)`; the backward on
the calls of one train step of that asset at 32 x 32 x 1801
(`small_float_backward_rows`). With `--out FILE` the rows are also
written there as JSON.

    python -m tpufusion_torch.kernel_bench --dsmem-probe

builds and runs `probes/dsmem_min64.cu`, which checks whether atomics on
distributed shared memory are exact on this card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import json
import os
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)


def time_ms(fn, inputs, warmup: int = 2) -> float:
    """Mean ms per call over distinct inputs, between CUDA events."""
    for x in inputs[:warmup]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(inputs)


_SLEEP_CYCLES_PER_MS: list[float] = []  # the card's clock under torch.cuda._sleep, once


def _sleep_cycles(ms: float) -> int:
    """Cycles of `torch.cuda._sleep` that hold the stream about `ms`."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 10_000_000
        torch.cuda._sleep(cycles)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return int(ms * _SLEEP_CYCLES_PER_MS[0])


def queued_ms(fn, inputs, warmup: int = 2, tries: int = 4) -> float:
    """Mean device ms per call over distinct inputs: every call is queued
    behind a `torch.cuda._sleep` and timed between CUDA events recorded
    after the sleep and after the last call, so the host's launch work
    overlaps the sleep and the events see the card's work alone, back to
    back. The sleep lasts twice a first pass's time (doubled on a retry);
    if the start event has fired before the last call is queued, the
    queue did not hold. Raises after `tries` such passes: a `fn` that
    waits on the card (a readback) cannot be queued; time it with
    `time_ms`."""
    for x in inputs[:warmup]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    cycles = _sleep_cycles(2 * (time.perf_counter() - t0) * 1e3 + 1.0)
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / len(inputs)
        cycles *= 2
    raise RuntimeError(f"{tries} passes: the calls did not queue behind the sleep")


def _device_kernel_us(fn, inputs) -> dict[str, float]:
    """{kernel or memset name: summed device µs} over one call of `fn` per
    input after a warm-up call (torch.profiler's CUPTI records). Raises
    if two profiles in a row hold no device record."""
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])  # warm-up
    torch.cuda.synchronize()
    for _ in range(2):  # CUPTI has dropped a whole profile's records once: one more try
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                fn(x)
            torch.cuda.synchronize()
        rows = {e.key: e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        if any(rows.values()):
            return rows
    raise RuntimeError("torch.profiler returned no device record of the calls")


def device_ms(fn, inputs) -> float:
    """Mean device time per call over distinct inputs: the summed
    durations of the kernels and memsets the calls ran on the card,
    without the host's time between them. A small kernel's call is
    host-bound, so its time between CUDA events measures the host; this
    measures the kernel."""
    return sum(_device_kernel_us(fn, inputs).values()) / 1e3 / len(inputs)


def top_device_kernels(fn, inputs, k: int = 5) -> list[dict]:
    """The `k` kernels with the longest summed device time over one call
    of `fn` per input, each as {"name", "ms" (a call), "share" (of the
    calls' whole device time)}, longest first."""
    rows = _device_kernel_us(fn, inputs)
    total = sum(rows.values())
    top = sorted(rows.items(), key=lambda r: r[1], reverse=True)[:k]
    return [{"name": name, "ms": t / 1e3 / len(inputs), "share": t / total} for name, t in top]


def queued_each(fn, inputs) -> float:
    """`queued_ms` of one call at a time, the mean over the inputs: a
    plain version that launches hundreds of kernels a call fills the
    card's launch queue behind the sleep with a few calls."""
    return sum(queued_ms(fn, [x]) for x in inputs) / len(inputs)


def time_turns(fns: dict, inputs, timer=time_ms) -> dict[str, float]:
    """Each function timed twice with `timer`, in turns (a, b, c, c, b,
    a), on the same inputs; the mean of each function's two times."""
    names = list(fns)
    times: dict[str, list[float]] = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(timer(fns[k], inputs))
    return {k: sum(v) / len(v) for k, v in times.items()}


def zbuffer_bound_ms(pix, key_bits, valid, num_pixels: int) -> float:
    """Least time for the z-buffer's bytes at 3.35 TB/s: each point's id,
    key and validity read once (9 B), each occupied pixel's winning
    payload read once (12 B), the (B, P, 3) float32 image written once."""
    b, n = pix.shape
    frame = torch.arange(b, device=pix.device, dtype=torch.int64)[:, None] * num_pixels
    occupied = torch.unique((frame + pix.to(torch.int64))[valid]).numel()
    nbytes = 9 * b * n + 12 * occupied + 12 * b * num_pixels
    return nbytes / HBM_BYTES_PER_S * 1e3


def cc_bound_ms(mask) -> float:
    """Least time for the CC's bytes at 3.35 TB/s: the bool mask read once,
    the labels and four int32 extent planes written once (21 B a pixel)."""
    return 21 * mask.numel() / HBM_BYTES_PER_S * 1e3


def pixels_bound_ms(points, valid) -> float:
    """Least time for the pixel kernel's bytes at 3.35 TB/s: the (B, N, C)
    float32 points and the validity bytes read once; the pixel id, key,
    ok byte and (3,) float32 payload written once (21 B a point)."""
    b, n, c = points.shape
    nbytes = b * n * (4 * c + (0 if valid is None else 1) + 21)
    return nbytes / HBM_BYTES_PER_S * 1e3


def project_2d_bound_ms(n: int) -> float:
    """Least time for `project_2d`'s bytes at 3.35 TB/s: three float32
    coordinates read and two int32 written an element (20 B)."""
    return 20 * n / HBM_BYTES_PER_S * 1e3


def label_encode_bound_ms(center, size, yaw, image) -> float:
    """Least time for the label encode's bytes at 3.35 TB/s: the image
    (12 B a pixel at 3 channels) and the boxes read once, the (..., H, W,
    26) float32 label written once (104 B a pixel)."""
    pixels = image.numel() // image.shape[-1]
    nbytes = 4 * (image.numel() + center.numel() + size.numel() + yaw.numel()) + 104 * pixels
    return nbytes / HBM_BYTES_PER_S * 1e3


def direct_encode_bound_ms(center, size, yaw, image, channels: int) -> float:
    """Least time for the direct label encode's bytes at 3.35 TB/s: the
    image (12 B a pixel at 3 channels) and the boxes read once, the (...,
    H, W, `channels`) float32 label written once (40 B a pixel at 10
    channels, 48 at 12)."""
    pixels = image.numel() // image.shape[-1]
    nbytes = (4 * (image.numel() + center.numel() + size.numel() + yaw.numel())
              + 4 * channels * pixels)
    return nbytes / HBM_BYTES_PER_S * 1e3


def torch_pixels_composition(points, valid, spec):
    """The torch composition the pixel kernel replaced (the range view's
    pixel, key and payload math before the kernel: torch.atan2,
    torch.asin, division by Python numbers), kept as the kernel's
    yardstick and used nowhere in the port. It is not the reference's
    arithmetic on the card: only its time is read."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    l2 = torch.sqrt((x * x + y * y + z * z).double()).float()
    az = torch.atan2(-y, x) / spec.res_h_rad - spec.x_min
    ratio = torch.where(l2 > 0, z / torch.clamp(l2, min=1e-12), 0.0)
    el = torch.asin(ratio) / spec.res_v_rad - spec.y_min
    col = torch.remainder(torch.trunc(az).to(torch.int32), spec.width)
    row = spec.y_max - torch.remainder(torch.trunc(el).to(torch.int32), spec.height)
    ok = torch.isfinite(points).all(dim=-1) & valid
    pix = torch.where(ok, row * spec.width + col, 0).to(torch.int32)
    intensity = points[..., 3] if points.shape[-1] > 3 else torch.zeros_like(x)
    payload = torch.stack([torch.sqrt((x * x + y * y).double()).float(), z, intensity], dim=-1)
    return pix, l2.view(torch.int32), ok, payload


def torch_project_2d_composition(x, y, z, spec):
    """The torch composition `project_2d`'s kernel replaced (the reference's
    formula in torch ops: torch.atan2, torch.asin, division by Python
    numbers), kept as the kernel's yardstick and used nowhere in the port.
    Only its time is read."""
    l2 = torch.sqrt(x * x + y * y + z * z)
    col = torch.trunc(torch.atan2(-y, x) / spec.res_h_rad - spec.x_min).to(torch.int32)
    ratio = torch.where(l2 > 0, z / torch.clamp(l2, min=1e-12), 0.0)
    row = torch.trunc(torch.asin(ratio) / spec.res_v_rad - spec.y_min).to(torch.int32)
    return col, spec.y_max - torch.clamp(row, 0, spec.y_max)


def empty_kernel(_=None) -> None:
    """One launch of a kernel that does nothing (`torch.cuda._sleep(0)`):
    timed by `queued_ms`, the card's floor for any one launch."""
    torch.cuda._sleep(0)


def scatter_amin_yardstick(pix, key_bits, valid, num_pixels: int):
    """The library call that computes the z-buffer's scatter half:
    `Tensor.scatter_reduce_(..., "amin")` of the packed key into a grid
    filled beforehand (what `ops/scatter.py` calls). Returns a function of
    no arguments that runs that call alone; the packing and the fill stay
    outside it."""
    b, n = pix.shape
    idx = torch.arange(n, device=pix.device, dtype=torch.int64)
    packed = torch.where(valid, (key_bits.to(torch.int64) << 32) | idx, torch.iinfo(torch.int64).max)
    ids = torch.where(valid, pix, 0).to(torch.int64)
    grid = torch.full((b, num_pixels), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=pix.device)
    return lambda: grid.scatter_reduce_(1, ids, packed, "amin", include_self=True)


def packed_amin_yardstick(pix, key_bits, valid, payload, spec):
    """The library calls that compute the packed z-buffer's function:
    `Tensor.scatter_reduce_(..., "amin")` of the reference's int32 packs
    into a grid filled beforehand, then the winners' decode and the image
    gather (`ops/projection.py::gather_image`). Returns a function of no
    arguments that runs those calls; the packing and the fill stay outside
    it."""
    from tpufusion_torch.ops.projection import gather_image

    b, n = pix.shape
    idx_bits = max((n - 1).bit_length(), 1)
    int32_max = torch.iinfo(torch.int32).max
    idx = torch.arange(n, device=pix.device, dtype=torch.int32)
    packed = torch.where(valid, ((key_bits >> idx_bits) << idx_bits) | idx, int32_max)
    ids = torch.where(valid, pix, 0).to(torch.int64)
    grid = torch.full((b, spec.height * spec.width), int32_max, dtype=torch.int32,
                      device=pix.device)

    def run():
        grid.scatter_reduce_(1, ids, packed, "amin", include_self=True)
        occupied = grid != int32_max
        return gather_image(payload, torch.where(occupied, grid & ((1 << idx_bits) - 1), 0),
                            occupied, spec)

    return run


# -- the A/B against an earlier design ----------------------------------------


def _build_old(csrc: str) -> ctypes.CDLL:
    from tpufusion_torch import _build

    out = os.path.join(_build.BUILD_DIR, "libtpufusion_kernels_old.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", out,
           *sorted(glob.glob(os.path.join(csrc, "*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tf_nearest_wins_image.argtypes = [p, p, p, p, p, p, i, i, i, f, p]
    lib.tf_components_with_bbox.argtypes = [p, p, p, p, i, i, i, p]
    lib.tf_nearest_wins_image.restype = lib.tf_components_with_bbox.restype = i
    if hasattr(lib, "tf_nearest_wins_packed_image"):
        lib.tf_nearest_wins_packed_image.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
        lib.tf_nearest_wins_packed_image.restype = i
    if hasattr(lib, "tf_decode_direct"):  # the one-CTA-a-lane design: the same interface
        lib.tf_decode_direct.argtypes = _build.load().tf_decode_direct.argtypes
        lib.tf_decode_direct.restype = i
    if hasattr(lib, "tf_corner_vote"):  # the three-launch design: it reads y_pred's channel 1
        lib.tf_corner_vote.argtypes = [p, i, p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                       ctypes.POINTER(f), p, p, p, p, p, p, p, p, p, p]
        lib.tf_corner_vote.restype = i
    if hasattr(lib, "tf_small_float_cast"):  # the one-element-an-iteration cast: x (n,) -> out (n,)
        lib.tf_small_float_cast.argtypes = [p, i, p, i, ctypes.c_longlong, ctypes.POINTER(i), p]
        lib.tf_small_float_cast.restype = i
    if hasattr(lib, "tf_small_float_backward") and not hasattr(lib, "tf_small_float_bias_grad"):
        # the serial reduce: a codes buffer in place of the segments' maps
        ll = ctypes.c_longlong
        ip = ctypes.POINTER(i)
        lib.tf_small_float_backward.argtypes = [
            ctypes.POINTER(p), ip, ctypes.POINTER(ll), i, p, i, i, p, i, i, i, i, i, p, ip, i, p,
            i, p, p, p, ip, i, p]
        lib.tf_small_float_backward.restype = i
    lib.tf_error_string.argtypes = [i]
    lib.tf_error_string.restype = ctypes.c_char_p
    return lib


def _old_small_float_cast(lib):
    """The earlier design's direct cast (the same C interface): fn(x, fmt,
    out) -> fmt(x) as `out`, one launch."""
    from tpufusion_torch import _build
    from tpufusion_torch.ops import small_float

    def cast(x, fmt, out):
        x = x.contiguous()  # as its wrapper did
        res = torch.empty(x.shape, dtype=out, device=x.device)
        err = lib.tf_small_float_cast(x.data_ptr(), small_float.IN_DTYPES.index(x.dtype),
                                      res.data_ptr(), small_float.OUT_DTYPES.index(out), x.numel(),
                                      small_float._params(fmt),
                                      torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "the earlier small_float cast")
        return res
    return cast


def _old_small_float_backward(lib):
    """The earlier design's backward (the serial reduce, its own add table
    in its own layout, acc-major): fn(call) for a `recorded_backwards`
    call, one launch, as its wrapper made it."""
    from tpufusion_torch import _build
    from tpufusion_torch.ops import small_float as sf

    tables: dict = {}
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")

    def backward(grads, saved, fmt, relu, out=None, bias=True):
        out = sf._out_dtype(fmt, out)
        dev = grads[0].device
        shape = tuple(grads[0].shape)
        b, c, hh, w = shape
        res = torch.empty(shape, dtype=out, device=dev)
        gb = torch.empty(c, dtype=torch.float32, device=dev) if bias else None
        ptrs = (ctypes.c_void_p * sf.MAX_GRADS)(*[g.data_ptr() for g in grads])
        kinds = (ctypes.c_int * sf.MAX_GRADS)(*[sf.IN_DTYPES.index(g.dtype) for g in grads])
        strides = (ctypes.c_longlong * (4 * sf.MAX_GRADS))(*[x for g in grads for x in g.stride()])
        levels = sf.xla_sum_levels((b, hh, w)) if bias else []
        flat = [v for level in levels for dim in level for v in dim]
        lv = (ctypes.c_int * max(len(flat), 1))(*flat)
        table = scratch = codes = None
        build = 0
        if bias:
            table = tables.get(fmt.name)
            build = int(table is None)
            if table is None:
                table = tables[fmt.name] = torch.empty(sf._n_codes(fmt) ** 2, dtype=torch.uint8,
                                                       device=dev)
            first = [cnt for _, cnt, _ in levels[0]]
            scratch = torch.empty(2 * c * first[0] * first[1] * first[2], dtype=torch.int32,
                                  device=dev)
            codes = torch.empty(shape, dtype=torch.uint8, device=dev)
        if relu:
            saved = saved.contiguous()
        err = lib.tf_small_float_backward(
            ptrs, kinds, strides, len(grads), None if saved is None else saved.data_ptr(),
            sf.IN_DTYPES.index(saved.dtype) if relu else 0, int(relu), res.data_ptr(),
            sf.OUT_DTYPES.index(out), b, c, hh, w, None if gb is None else gb.data_ptr(), lv,
            len(levels), None if table is None else table.data_ptr(), build,
            None if codes is None else codes.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            counter.data_ptr() if bias else None, sf._params(fmt), int(fmt.via_f16),
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "the earlier small_float backward")
        return res, gb
    return backward


@contextlib.contextmanager
def using_library(lib: ctypes.CDLL):
    """The port's wrappers launch through `lib` (an earlier design's, a
    variant's or a probe's build of the same C entry) inside the block."""
    from tpufusion_torch import _build

    saved = _build.load()
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def _build_decode_variant(cluster: int) -> ctypes.CDLL:
    """The current direct decode kernel built with `cluster` CTAs a lane."""
    from tpufusion_torch import _build

    out = os.path.join(_build.BUILD_DIR, f"libtpufusion_decode_{cluster}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DTF_DECODE_CLUSTER={cluster}", "-shared",
           "-o", out, os.path.join(_build.CSRC, "decode_direct.cu"),
           os.path.join(_build.CSRC, "nearest_wins.cu")]  # the latter: tf_error_string
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {cluster}-CTA direct decode:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    main = _build.load()
    for name in ("tf_decode_direct", "tf_error_string"):
        getattr(lib, name).argtypes = getattr(main, name).argtypes
        getattr(lib, name).restype = getattr(main, name).restype
    return lib


def _old_corner_vote(lib, spec, cfg):
    """The three-launch vote through its own C interface (has-pos
    over y_pred's channel 1, counts, winners), on kernel_bench's corner
    inputs; returns (pose, box, ok, overflow)."""
    import numpy as np

    from tpufusion_torch.ops.label_encode import pixel_trig

    def run(a):
        y, im, bbox, c3, lanes = a[:5]
        y = y.to(torch.float32).contiguous()
        b, h, w, ch = y.shape
        n, k, dev = bbox.shape[1], min(cfg.max_candidates, h * w), y.device
        lanes = torch.ones((b, n), dtype=torch.bool, device=dev) if lanes is None else lanes
        f32 = np.float32
        consts = (ctypes.c_float * 6)(f32(cfg.min_prob), *(f32(d) for d in cfg.far_delta),
                                      f32(1e-9), f32(cfg.max_bbox_dist**2))
        out = [torch.empty((b, n, 7), device=dev), torch.empty((b, n, 8, 3), device=dev),
               torch.empty((b, n), dtype=torch.bool, device=dev),
               torch.empty((b, n), dtype=torch.bool, device=dev)]
        scratch = [torch.empty((b, w), dtype=torch.uint8, device=dev),
                   torch.empty((b, -(-w // 256), -(-h // 32)), dtype=torch.int32, device=dev),
                   torch.empty((b, n, k), dtype=torch.int32, device=dev),
                   torch.empty((b, n, k, 24), device=dev),
                   torch.empty((b, n, 2), dtype=torch.int32, device=dev)]
        err = lib.tf_corner_vote(
            y.data_ptr(), ch, im.data_ptr(), im.shape[-1], bbox.data_ptr(), c3.data_ptr(),
            lanes.data_ptr(), *(t.data_ptr() for t in pixel_trig(spec, dev)), b, n, h, w, k,
            cfg.margin_x, cfg.margin_y, consts, *(t.data_ptr() for t in scratch),
            *(t.data_ptr() for t in out), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"the three-launch corner vote: CUDA error {err}"
        return out

    return run


def _build_packed_variant(cluster: int) -> ctypes.CDLL:
    """The current packed kernel built with `cluster` CTAs a frame."""
    from tpufusion_torch import _build

    out = os.path.join(_build.BUILD_DIR, f"libtpufusion_packed_{cluster}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DTF_PACKED_CLUSTER={cluster}", "-shared",
           "-o", out, os.path.join(_build.CSRC, "nearest_wins_packed.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {cluster}-CTA packed kernel:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tf_nearest_wins_packed_image.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    lib.tf_nearest_wins_packed_shape.argtypes = [i, p, p, p, p]
    lib.tf_nearest_wins_packed_image.restype = lib.tf_nearest_wins_packed_shape.restype = i
    return lib


def packed_shape(lib, num_pixels: int) -> dict[str, int]:
    """The packed kernel's plan for an image of num_pixels: slots a CTA, its
    dynamic shared memory, the bands, and the clusters the card holds at
    once (`cudaOccupancyMaxActiveClusters`)."""
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.tf_nearest_wins_packed_shape(num_pixels, *(ctypes.byref(o) for o in out))
    if err != 0:
        raise RuntimeError(f"tf_nearest_wins_packed_shape: CUDA error {err}")
    return dict(zip(("slots", "smem_bytes", "bands", "clusters"), (o.value for o in out)))


def _packed_call(lib, spec, old: bool):
    """One call of a packed kernel library as its wrapper makes it: the
    image (and for the earlier design its grid scratch) allocated, then
    the launch."""
    def run(args):
        pix, key, valid, payload = args
        b, n = pix.shape
        p = spec.height * spec.width
        idx_bits = max((n - 1).bit_length(), 1)
        img = torch.empty((b, spec.height, spec.width, 3), dtype=torch.float32,
                          device=pix.device)
        ptrs = [pix.data_ptr(), key.data_ptr(), valid.data_ptr(), payload.data_ptr()]
        if old:
            grid = torch.empty((b, p), dtype=torch.int32, device=pix.device)
            ptrs.append(grid.data_ptr())
        err = lib.tf_nearest_wins_packed_image(
            *ptrs, img.data_ptr(), b, n, p, idx_bits, float(spec.min_height),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"packed z-buffer: CUDA error {err}"
        return img
    return run


def _old_zbuffer(lib, spec):
    """The earlier wrapper's work: fill the grid, launch, as one call."""
    def run(args):
        pix, key, valid, payload = args
        b, n = pix.shape
        p = spec.height * spec.width
        grid = torch.full((b, p), torch.iinfo(torch.int64).max, dtype=torch.int64,
                          device=pix.device)
        img = torch.empty((b, spec.height, spec.width, 3), dtype=torch.float32,
                          device=pix.device)
        err = lib.tf_nearest_wins_image(
            pix.data_ptr(), key.data_ptr(), valid.data_ptr(), payload.data_ptr(),
            grid.data_ptr(), img.data_ptr(), b, n, p, float(spec.min_height),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"old z-buffer: CUDA error {err}"
        return img
    return run


def _old_cc(lib):
    def run(mask):
        b, h, w = mask.shape
        scratch = torch.empty((5, b * h * w), dtype=torch.int32, device=mask.device)
        labels = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
        ext = torch.empty((4, b, h, w), dtype=torch.int32, device=mask.device)
        err = lib.tf_components_with_bbox(
            mask.data_ptr(), scratch.data_ptr(), labels.data_ptr(), ext.data_ptr(),
            b, h, w, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"old CC: CUDA error {err}"
        return labels, ext[0], ext[1], ext[2], ext[3]
    return run


def _inputs(dev, batch: int, n_points: int, beams: int, dtype: str, sets: int):
    """(zbuffer args, heat masks), one per distinct batch, as chip_smoke
    makes them."""
    import dataclasses

    import numpy as np

    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import heat_mask
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys, range_view_project_batch
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import asset_configs, load_state_npz

    asset = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
    mcfg, dcfg = asset_configs(asset)
    model = FCN(dataclasses.replace(mcfg, dtype=dtype))
    load_state_npz(asset, model)
    model = model.to(dev).eval()
    spec = RangeViewSpec()
    zargs, masks = [], []
    with torch.inference_mode():
        for i in range(sets):
            p, _, v = synthesize_beam_scan_batch(
                np.random.default_rng(100 + i), batch, n_points, n_beams=beams)
            p, v = torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)
            zargs.append(_frame_pixels_keys(p, spec, v))
            masks.append(heat_mask(model(range_view_project_batch(p, spec, v))[..., 1], dcfg))
    return spec, zargs, masks


PACKED_SHAPES = (  # label, batch, points a frame, beams, the range view's res_v_deg
    ("64 x 32,768", 64, 32768, 32, 1.33),
    ("16 x 131,072", 16, 131072, 64, 1.33),
    ("64 x 32,768 into 63 x 1801", 64, 32768, 64, 0.665),
)


def packed_ab(lib, sets: int = 12) -> list[dict]:
    """The packed z-buffer's rows: the earlier kernel (`lib`, or None), the
    current one, its 8-CTA build, the exact kernel, the yardstick, and
    the current one with every point invalid, in turns on beam scans;
    each checked bit for bit against the plain version first."""
    import numpy as np

    from tpufusion_torch import RangeViewSpec, _build
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys
    from tpufusion_torch.ops import projection

    dev = torch.device("cuda", 0)
    lib8 = _build_packed_variant(8)
    rows = []
    for label, batch, n, beams, res_v in PACKED_SHAPES:
        spec = RangeViewSpec(res_v_deg=res_v)
        p = spec.height * spec.width
        zargs = []
        with torch.inference_mode():
            for i in range(sets):
                pts, _, v = synthesize_beam_scan_batch(np.random.default_rng(2700 + i), batch, n,
                                                       n_beams=beams)
                zargs.append(_frame_pixels_keys(torch.from_numpy(pts).to(dev), spec,
                                                torch.from_numpy(v).to(dev)))
            none = [(a[0], a[1], torch.zeros_like(a[2]), a[3]) for a in zargs]
            fns = {"new": lambda a: projection.nearest_wins_packed_image(*a, spec),
                   "new8": _packed_call(lib8, spec, old=False)}
            if lib is not None:
                fns["old"] = _packed_call(lib, spec, old=True)
            for a in zargs[:2] + none[:1]:
                want = projection.nearest_wins_packed_image_reference(*a, spec)
                for name, fn in fns.items():
                    assert torch.equal(fn(a), want), f"packed {name} differs from plain ({label})"
            yard = {id(a): packed_amin_yardstick(*a, spec) for a in zargs}
            fns["exact"] = lambda a: projection.nearest_wins_image(*a, spec)
            fns["library"] = lambda a: yard[id(a)]()
            call, dev_t = (time_turns(fns, zargs, t) for t in (time_ms, queued_ms))
            empty = {"new_no_valid": fns["new"]}
            call.update(time_turns(empty, none, time_ms))
            dev_t.update(time_turns(empty, none, queued_ms))
        bound = sum(zbuffer_bound_ms(*a[:3], p) for a in zargs) / sets
        rows.append({"shape": label, "kernel": "nearest_wins_packed_image", "bound_ms": bound,
                     "plan_16": packed_shape(_build.load(), p), "plan_8": packed_shape(lib8, p),
                     **{f"{k}_call_ms": v for k, v in call.items()},
                     **{f"{k}_device_ms": v for k, v in dev_t.items()}})
    return rows


def ab(lib, sets: int = 12, kernels=("exact", "cc", "packed")) -> list[dict]:
    """The exact z-buffer's, the CC's and the packed z-buffer's rows
    against an earlier design's library `lib` (`_build_old`, or None)."""
    from tpufusion_torch.ops import cc, components, projection

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows = []
    if "packed" in kernels:
        old = lib if lib is not None and hasattr(lib, "tf_nearest_wins_packed_image") else None
        rows += packed_ab(old, sets)
    if lib is None or not {"exact", "cc"} & set(kernels):
        return rows
    for label, batch, n, beams, dtype in (("64 x 32,768", 64, 32768, 32, "float32"),
                                          ("16 x 131,072", 16, 131072, 64, "bfloat16")):
        spec, zargs, masks = _inputs(dev, batch, n, beams, dtype, sets)
        p = spec.height * spec.width
        old_z, old_cc = _old_zbuffer(lib, spec), _old_cc(lib)
        with torch.inference_mode():
            for a, m in zip(zargs, masks):
                want = projection.nearest_wins_image_reference(*a, spec)
                assert torch.equal(projection.nearest_wins_image(*a, spec), want)
                assert torch.equal(old_z(a), want)
                plain = components.connected_components_with_bbox(m, 4096)
                for got in (cc.connected_components_with_bbox(m), old_cc(m)):
                    assert torch.equal(got[0], plain[0])
                    assert all(torch.equal(g[m], w[m]) for g, w in zip(got[1:], plain[1:]))
            yard = [scatter_amin_yardstick(*a[:3], p) for a in zargs]
            zfns = {
                "old": lambda i: old_z(zargs[i]),
                "new": lambda i: projection.nearest_wins_image(*zargs[i], spec),
                "library": lambda i: yard[i](),
            }
            cfns = {"old": old_cc, "new": cc.connected_components_with_bbox}
            z_call, z_dev = (time_turns(zfns, list(range(sets)), t) for t in (time_ms, queued_ms))
            c_call, c_dev = (time_turns(cfns, masks, t) for t in (time_ms, queued_ms))
        zb = sum(zbuffer_bound_ms(*a[:3], p) for a in zargs) / sets
        cb = sum(cc_bound_ms(m) for m in masks) / sets
        for name, call, dev_t, bound in (("nearest_wins_image", z_call, z_dev, zb),
                                         ("connected_components_with_bbox", c_call, c_dev, cb)):
            rows.append({"shape": label, "kernel": name, "bound_ms": bound,
                         **{f"{k}_call_ms": v for k, v in call.items()},
                         **{f"{k}_device_ms": v for k, v in dev_t.items()}})
    return rows


ENCODE_SHAPES = (  # label, frames, the range view's res_v_deg
    ("32 x 32 x 1801", 32, 1.33),
    ("32 x 63 x 1801", 32, 0.665),
)


def encode_rows(sets: int = 12) -> list[dict]:
    """The fused label encode's rows: the kernel, its plain version (the
    torch composition the kernel replaced, unchanged, with its one
    project_2d launch) and a fill of a label-sized tensor (the card's
    rate for the label's stores alone, no image read) in turns at a train
    batch of 32 frames, 32 and 63 rows, on `parity_inputs.label_inputs`
    boxes all round (outer_rect, the train step's method); each set
    checked bit for bit first."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.geometry.encoding import encode_label_reference
    from tpufusion_torch.ops import label_encode, parity_inputs

    dev = torch.device("cuda", 0)
    rows = []
    for label, frames, res_v in ENCODE_SHAPES:
        spec = RangeViewSpec(res_v_deg=res_v)
        args = [[torch.from_numpy(a).to(dev) for a in parity_inputs.label_inputs(
            spec, frames, seed=1600 + i)] for i in range(sets)]
        with torch.inference_mode():
            for a in args[:2]:
                got, want = label_encode.encode_label(*a, spec), encode_label_reference(*a, spec)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), label
            labels = {id(a): torch.empty(a[3].shape[:-1] + (label_encode.CHANNELS,),
                                         dtype=torch.float32, device=dev) for a in args}
            fns = {"new": lambda a: label_encode.encode_label(*a, spec),
                   "plain": lambda a: encode_label_reference(*a, spec),
                   "fill": lambda a: labels[id(a)].fill_(0.0)}
            call = time_turns(fns, args, time_ms)
            dev_t = time_turns(fns, args, lambda fn, xs: (
                queued_each if fn is fns["plain"] else queued_ms)(fn, xs))
        rows.append({"shape": label, "kernel": "encode_label",
                     "bound_ms": sum(label_encode_bound_ms(*a) for a in args) / sets,
                     **{f"{k}_call_ms": v for k, v in call.items()},
                     **{f"{k}_device_ms": v for k, v in dev_t.items()}})
    return rows


DIRECT_TIMED = (("surface", "local"), ("surface", "both"))  # 10 and 12 channels


def encode_direct_rows(sets: int = 12) -> list[dict]:
    """The direct head's fused label encode's rows, as `encode_rows`: the
    kernel, its plain version (the torch composition the kernel replaced,
    unchanged) and a fill of a label-sized tensor in turns at 32 frames,
    32 and 63 rows, the surface footprint with the local yaw frame (10
    channels) and with both (12); each set checked bit for bit first."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.geometry.encoding import encode_direct_label_reference
    from tpufusion_torch.ops import label_encode, parity_inputs

    dev = torch.device("cuda", 0)
    rows = []
    for label, frames, res_v in ENCODE_SHAPES:
        spec = RangeViewSpec(res_v_deg=res_v)
        args = [[torch.from_numpy(a).to(dev) for a in parity_inputs.label_inputs(
            spec, frames, seed=1700 + i)] for i in range(sets)]
        for footprint, yaw_frame in DIRECT_TIMED:
            channels = label_encode.direct_channels(yaw_frame)
            with torch.inference_mode():
                new = lambda a: label_encode.encode_direct_label(  # noqa: E731
                    *a, spec, footprint, yaw_frame)
                plain = lambda a: encode_direct_label_reference(  # noqa: E731
                    *a, spec, footprint, yaw_frame)
                for a in args[:2]:
                    assert torch.equal(new(a).view(torch.int32), plain(a).view(torch.int32)), label
                labels = {id(a): torch.empty(a[3].shape[:-1] + (channels,), dtype=torch.float32,
                                             device=dev) for a in args}
                fns = {"new": new, "plain": plain, "fill": lambda a: labels[id(a)].fill_(0.0)}
                call = time_turns(fns, args, time_ms)
                dev_t = time_turns(fns, args, lambda fn, xs: (
                    queued_each if fn is fns["plain"] else queued_ms)(fn, xs))
            rows.append({"shape": f"{label}, {channels} channels",
                         "kernel": "encode_direct_label",
                         "bound_ms": sum(direct_encode_bound_ms(*a, channels) for a in args) / sets,
                         **{f"{k}_call_ms": v for k, v in call.items()},
                         **{f"{k}_device_ms": v for k, v in dev_t.items()}})
    return rows


def decode_direct_bound_bytes(y_pred, images, mask, labels, min_x, max_x, min_y, max_y, root,
                              found, spec, cfg, center: str) -> int:
    """The bytes the direct decode must move on this run's data, each read
    once: every pixel of the found lanes' bbox windows (a frame's union
    of them) its mask (1 B) and, where the mask is set, its label (4 B);
    the image's distance and height (8 B) on each lane's cluster pixels,
    and for the centers that back-project on its centroid pixel and, where
    that pixel is not valid, on the window shrunk by 2 the fallback
    searches; on the cluster's valid pixels the probability (4 B), and
    where it passes min_prob the channels the center and yaw frame read
    (4 B each: l w h, the yaw frame's sin / cos, both frames' for "auto",
    the head's three offsets for "head"; 2 B each for a bf16 or float16
    y_pred);
    each lane's found flag read and its pose and flag written, a found
    lane's root and four extents read."""
    b, h, w = mask.shape
    k = root.shape[1]
    dev = mask.device
    x0, x1, y0, y1 = (t.reshape(b, -1).gather(1, root).long() for t in (min_x, max_x, min_y,
                                                                           max_y))
    rows = torch.arange(h, device=dev).view(1, 1, h, 1)
    cols = torch.arange(w, device=dev).view(1, 1, 1, w)

    def box(left, right, top, bottom, lanes):
        return ((cols >= left[..., None, None]) & (cols <= right[..., None, None])
                & (rows >= top[..., None, None]) & (rows <= bottom[..., None, None])
                & lanes[..., None, None])

    window = box(x0, x1, y0, y1, found)  # (B, k, H, W)
    cluster = window & mask[:, None] & (labels[:, None].long() == root[..., None, None])
    valid = (images[..., 0] > 0) & (images[..., 1] > spec.min_height)
    image_px = cluster.any(1)
    if center in ("backproject", "geometric", "consensus", "fit"):
        cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
        centroid = cy * w + cx
        centroid_ok = valid.reshape(b, -1).gather(1, centroid)
        fallback = found & ~centroid_ok & (x0 + 2 != 0) & (x1 - 2 != 0)
        image_px |= box(x0 + 2, x1 - 2, y0 + 2, y1 - 2, fallback).any(1)
        at_centroid = torch.zeros(b, h * w, dtype=torch.int32, device=dev).scatter_add_(
            1, centroid, found.int())
        image_px |= (at_centroid > 0).view(b, h, w)
    cover = window.any(1)
    in_cluster = cluster & valid[:, None]
    passes = in_cluster & (y_pred[..., 1] >= cfg.min_prob)[:, None]
    yaw_channels = 4 if cfg.direct_yaw_frame == "auto" else 2
    channels = 3 + yaw_channels + (3 if center == "head" else 0)
    n_found = int(found.sum())
    e = y_pred.element_size()
    return (int(cover.sum()) + 4 * int((cover & mask).sum()) + 8 * int(image_px.sum())
            + e * int(in_cluster.sum()) + e * channels * int(passes.sum())
            + b * k * (1 + 7 * 4 + 1) + n_found * (8 + 4 * 4))


DECODE_SHAPES = (  # label, frames, points a frame, beams, res_v_deg, k
    ("64 x 32 x 1801, k 1, the live asset", 64, 32768, 32, 1.33, 1),
    ("16 x 32 x 1801, k 4, config 5", 16, 131072, 64, 1.33, 4),
    ("64 x 63 x 1801, k 1, 64 beams", 64, 32768, 64, 0.665, 1),
)


def decode_direct_inputs(dev, shape, sets: int, seed0: int = 1800):
    """(spec, decode config, k, [(y_pred, image, mask, labels, 4 extents,
    root, found), ...]) at one of DECODE_SHAPES: the shipped asset's bf16
    FCN on distinct beam-scan batches, its heat mask, the CC and the
    top-k roots, as `decode_batch_direct` hands them to the kernel."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.benchmarks import asset_model, point_sets
    from tpufusion_torch.decode import decode as td
    from tpufusion_torch.geometry.range_view import range_view_project_batch

    _, frames, n_points, beams, res_v, k = shape
    model, dcfg, _ = asset_model(os.path.join(_REPO, "tpufusion", "assets",
                                              "synthetic_detector.npz"))
    model = model.to(dev).eval()
    spec = RangeViewSpec(res_v_deg=res_v)
    out = []
    with torch.inference_mode():
        for p, v in point_sets(sets, frames, n_points, dev, n_beams=beams, seed0=seed0):
            image = range_view_project_batch(p, spec, v)
            y_pred = model(image)
            comps = td._heat_components(y_pred[..., 1], dcfg)
            root, found, *_ = td._topk_roots(*comps, dcfg, k)
            out.append((y_pred, image, *comps, root, found))
    return spec, dcfg, k, out


LOW_TAGS = {torch.bfloat16: "bf16", torch.float16: "f16"}  # a head type's row suffix


def decode_direct_rows(sets: int = 12, shapes=DECODE_SHAPES, old=None,
                       clusters=(), low=()) -> list[dict]:
    """The direct decode kernel's rows: the kernel and its plain version
    (the torch composition it replaced) in turns, and an empty kernel (the
    card's launch floor), at each of `shapes`, beside the kernel's bound
    (`decode_direct_bound_bytes` at 3.35 TB/s) from the same inputs; the
    contract held on the first two sets. With `old` (an earlier design's
    library, `_build_old`, which reads float32 only) its kernel ("old") in
    the same turns, held to the current one's poses within 1e-4 first;
    each width of `clusters` a build of the current kernel with that many
    CTAs a lane ("new_c<N>"). For each dtype of `low` (torch.bfloat16,
    torch.float16), the kernel's instance and its plain version on the
    same outputs rounded to it ("new_bf16", "plain_bf16"; "new_f16",
    "plain_f16") in the same turns, held to the contract first, and their
    bound ("bound_ms_bf16", "bound_ms_f16": 2 B a channel)."""
    from tpufusion_torch.decode.decode import decode_direct_clusters_reference
    from tpufusion_torch.ops import decode_direct

    dev = torch.device("cuda", 0)
    libs = {f"new_c{c}": _build_decode_variant(c) for c in clusters}
    if old is not None:
        libs["old"] = old
    rows = []
    for shape in shapes:
        spec, cfg, k, args = decode_direct_inputs(dev, shape, sets)
        center = cfg.direct_center
        # the same sets with y_pred in each low type, looked up by the float32 set
        sets_in = {LOW_TAGS[dt]: {id(a): (a[0].to(dt), *a[1:]) for a in args} for dt in low}
        with torch.inference_mode():
            for a in args[:2]:
                for y in (a[0], *(by_set[id(a)][0] for by_set in sets_in.values())):
                    r = decode_direct.against_plain(y, a[1], spec, cfg, k)
                    assert r["ok"] and r["near"] == 0, (shape[0], y.dtype, r)
            new = lambda a: decode_direct.decode_direct_clusters(*a, spec, cfg, center)  # noqa: E731
            plain = lambda a: decode_direct_clusters_reference(*a, spec, cfg, center)  # noqa: E731
            fns = {"new": new, "plain": plain, "empty": empty_kernel}
            for tag, by_set in sets_in.items():
                fns[f"new_{tag}"] = lambda a, by_set=by_set: new(by_set[id(a)])
                fns[f"plain_{tag}"] = lambda a, by_set=by_set: plain(by_set[id(a)])
            plains = [fns["plain"], *(fns[f"plain_{tag}"] for tag in sets_in)]
            for name, lib in libs.items():
                def on(a, lib=lib):
                    with using_library(lib):
                        return new(a)
                for a in args[:2]:  # each within 1e-4 of the plain version
                    (pa, fa), (pb, fb) = new(a), on(a)
                    gap = float((pa - pb).abs().max()) if pa.numel() else 0.0
                    assert torch.equal(fa, fb) and gap <= 2e-4, (name, shape[0], gap)
                fns[name] = on
            call = time_turns(fns, args, time_ms)
            dev_t = time_turns(fns, args, lambda fn, xs: (
                queued_each if fn in plains else queued_ms)(fn, xs))
        need = [decode_direct_bound_bytes(*a, spec, cfg, center) for a in args]
        low_bounds = {}
        for tag, by_set in sets_in.items():
            need_low = [decode_direct_bound_bytes(*by_set[id(a)], spec, cfg, center)
                        for a in args]
            low_bounds[f"bound_ms_{tag}"] = sum(need_low) / sets / HBM_BYTES_PER_S * 1e3
            low_bounds[f"bound_bytes_{tag}"] = sum(need_low) / sets
        windows = [int(decode_direct.window_pixels(*a[4:]).sum()) for a in args]
        found = [int(a[-1].sum()) for a in args]
        rows.append({"shape": shape[0], "kernel": "decode_direct",
                     "bound_ms": sum(need) / sets / HBM_BYTES_PER_S * 1e3,
                     "bound_bytes": sum(need) / sets, **low_bounds,
                     "window_pixels": sum(windows) / sets, "found_lanes": sum(found) / sets,
                     **{f"{k}_call_ms": v for k, v in call.items()},
                     **{f"{k}_device_ms": v for k, v in dev_t.items()}})
    return rows


FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores, NVIDIA's data sheet


def corner_vote_bound(y_pred, image, bbox, centroid_3d, lanes, cfg) -> dict:
    """The corner vote's least time on this run's data: its bytes (the
    positives map of each frame with a voted lane, 1 B a pixel; every
    lane's flag in and its pose, box and flags out; each voted lane's bbox
    and centroid; each real candidate's 24 regressions, distance and
    height) at 3.35 TB/s, and its FP32 FMAs (24 a pair over the real
    candidates' n_c^2 pairs of each voted lane) at 67 TFLOP/s; {"bytes",
    "fmas", "bound_ms", "bound_by", "lanes", "candidates" (real,
    summed)}."""
    b, h, w = y_pred.shape[:3]
    k = min(cfg.max_candidates, h * w)
    pos = y_pred[..., 1] >= cfg.min_prob
    col, row = pos.any(dim=1), pos.any(dim=2)  # (B, W), (B, H)
    cols = torch.arange(w, device=pos.device)
    rows = torch.arange(h, device=pos.device)
    lo_c, hi_c = bbox[..., 0:1] - cfg.margin_x, bbox[..., 2:3] + cfg.margin_x
    lo_r, hi_r = bbox[..., 1:2] - cfg.margin_y, bbox[..., 3:4] + cfg.margin_y
    n_cols = (col[:, None] & (cols >= lo_c) & (cols < hi_c)).sum(dim=-1)
    n_rows = (row[:, None] & (rows >= lo_r) & (rows < hi_r)).sum(dim=-1)
    voted = torch.ones(bbox.shape[:2], dtype=torch.bool, device=bbox.device) if lanes is None \
        else lanes
    n_c = torch.where(voted, (n_cols * n_rows).clamp(max=k), 0).double()
    n_lanes = int(voted.sum())
    frames = int(voted.any(dim=1).sum())
    need = (frames * h * w + voted.numel() * (1 + 4 * (7 + 24) + 2) + n_lanes * (32 + 12)
            + 26 * 4 * float(n_c.sum()))
    fmas = 24.0 * float((n_c * n_c).sum())
    t_bytes, t_ops = need / HBM_BYTES_PER_S, 2.0 * fmas / FP32_FLOPS
    return {"bytes": need, "fmas": fmas, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "lanes": n_lanes,
            "candidates": float(n_c.sum())}


CORNER_SHAPES = (  # label, frames, points a frame, beams, res_v_deg, k, FCN
    ("64 x 32 x 1801, k 1, the corner row's seeded FCN", 64, 32768, 32, 1.33, 1, "row"),
    ("64 x 32 x 1801, k 1, the corner head on the asset's trunk", 64, 32768, 32, 1.33, 1,
     "hybrid"),
    ("16 x 32 x 1801, k 4, the corner head on the asset's trunk", 16, 32768, 32, 1.33, 4,
     "hybrid"),
    ("64 x 63 x 1801, k 1, 64 beams, the corner head on the asset's trunk", 64, 32768, 64, 0.665,
     1, "hybrid"),
    ("64 x 32 x 1801, k 1, every pixel positive (2048 candidates a lane)", 64, 32768, 32, 1.33,
     1, "full"),
)


def corner_fcn(which: str, dev, dtype: str = "bfloat16"):
    """(FCN, its decode config) of a corner path: "row" the corner row's
    (and config 2's) seeded default-width corner head in bf16, else the
    shipped asset's trunk with the multi golden's corner regression branch
    in `dtype` (phase 8's hybrid steps)."""
    import dataclasses

    from tpufusion_torch._golden import hybrid_corner_arrays, load_npz
    from tpufusion_torch.benchmarks import CFG, seeded_fcn
    from tpufusion_torch.models.io import asset_configs, fcn_from_arrays

    if which == "row":
        return seeded_fcn(CFG.model, 0, dev), CFG.decode
    asset = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
    mcfg, dcfg = asset_configs(asset)
    arrays = hybrid_corner_arrays(load_npz(asset), load_npz(os.path.join(
        _REPO, "tests", "data", "torch_port_golden_multi.npz")))
    mcfg = dataclasses.replace(mcfg, head="corner", dtype=dtype)
    return fcn_from_arrays(arrays, mcfg, device=dev).eval(), dcfg


def corner_vote_inputs(dev, shape, sets: int, seed0: int = 1700):
    """(spec, decode config, [(y_pred, image, bbox, centroid_3d, stage2,
    positives), ...]) at one of CORNER_SHAPES: the path's FCN on distinct
    beam-scan batches, the lanes `decode_batch` / `decode_batch_multi`
    vote and the positives map they hand the vote ("full": the hybrid's
    outputs with every probability set to 0.9)."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.benchmarks import point_sets
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.ops.corner_vote import corner_lanes

    from tpufusion_torch.decode.decode import _positives

    _, frames, n_points, beams, res_v, k, which = shape
    model, dcfg = corner_fcn("row" if which == "row" else "hybrid", dev)
    spec = RangeViewSpec(res_v_deg=res_v)
    out = []
    with torch.inference_mode():
        for p, v in point_sets(sets, frames, n_points, dev, n_beams=beams, seed0=seed0):
            image = range_view_project_batch(p, spec, v)
            y_pred = model(image)
            if which == "full":
                y_pred[..., 1] = 0.9
            out.append((y_pred, image, *corner_lanes(y_pred, image, spec, dcfg, k),
                        _positives(y_pred[..., 1], dcfg)))
    return spec, dcfg, out


def corner_vote_rows(sets: int = 6, shapes=CORNER_SHAPES, old=None) -> list[dict]:
    """The corner vote kernel's rows: the kernel (handed the positives map,
    as the decode hands it) and its plain version (the torch composition
    it replaced) in turns, and an empty kernel (the launch floor), at each
    of `shapes`, beside the kernel's bound (`corner_vote_bound`) on the
    same inputs; the contract held on the first two sets (undecided and
    pose-sensitive lanes counted). With `old` (`_build_old` of the
    three-launch design's sources) its vote ("old") in the same turns, its
    ok and overflow held equal to the current one's first."""
    from tpufusion_torch.decode.decode import corner_vote_reference
    from tpufusion_torch.ops import corner_vote

    dev = torch.device("cuda", 0)
    rows = []
    for shape in shapes:
        spec, cfg, args = corner_vote_inputs(dev, shape, sets)
        with torch.inference_mode():
            checks = [corner_vote.against_plain(*a[:4], a[4], spec, cfg) for a in args[:2]]
            assert all(r["ok"] for r in checks), (shape[0], checks)
            fns = {"new": lambda a: corner_vote.corner_vote_lanes(*a[:5], spec, cfg, a[5]),
                   "plain": lambda a: corner_vote_reference(*a[:4], spec, cfg),
                   "empty": empty_kernel}
            if old is not None:
                fns["old"] = _old_corner_vote(old, spec, cfg)
                for a in args[:2]:
                    got, want = fns["old"](a), fns["new"](a)
                    assert all(torch.equal(g, w) for g, w in zip(got[2:], want[2:])), shape[0]
            call = time_turns(fns, args, time_ms)
            dev_t = time_turns(fns, args, lambda fn, xs: (
                queued_each if fn is fns["plain"] else queued_ms)(fn, xs))
        bounds = [corner_vote_bound(*a[:5], cfg) for a in args]
        mean = {key: sum(b[key] for b in bounds) / sets
                for key in ("bytes", "fmas", "bound_ms", "lanes", "candidates")}
        rows.append({"shape": shape[0], "kernel": "corner_vote",
                     "bound_ms": mean["bound_ms"], "bound_bytes": mean["bytes"],
                     "bound_fmas": mean["fmas"], "bound_by": (
                         "bytes" if mean["bytes"] / HBM_BYTES_PER_S >= 2 * mean["fmas"] / FP32_FLOPS
                         else "operations"),
                     "voted_lanes": mean["lanes"], "candidates": mean["candidates"],
                     "undecided_lanes": sum(r["undecided"] for r in checks),
                     "sensitive_lanes": sum(r["sensitive"] for r in checks),
                     **{f"{k}_call_ms": v for k, v in call.items()},
                     **{f"{k}_device_ms": v for k, v in dev_t.items()}})
    return rows


SMALL_FLOAT_FORMAT = "float8_e4m3fn"  # the format of the small_float rows


@contextlib.contextmanager
def recorded_epilogues(into: list):
    """While open, every FCN layer's epilogue call appends (y, bias,
    relu) to `into`: its raw convolution output, its bias, its relu."""
    from tpufusion_torch.models import fcn

    real = fcn._Layer._finish

    def finish(self, y, relu, uses=1, bias_block=None):
        into.append((y, self.bias.detach(), relu))
        return real(self, y, relu, uses, bias_block)

    fcn._Layer._finish = finish
    try:
        yield into
    finally:
        fcn._Layer._finish = real


def small_float_bound_ms(ins, outs) -> float:
    """Least time for an elementwise pass that reads each of `ins` and
    writes each of `outs` once, at 3.35 TB/s."""
    n = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    return n / HBM_BYTES_PER_S * 1e3


def small_float_forward(layers, fmt, out, epilogue=None):
    """One forward's epilogues (the list `small_float_layers` returns) through
    `epilogue` (the kernel's wrapper by default)."""
    from tpufusion_torch.ops import small_float

    epilogue = epilogue or small_float.conv_epilogue
    return [epilogue(y, b, fmt, relu, out=out) for y, b, relu in layers]


def small_float_yardstick(layers, dtype: torch.dtype):
    """torch's own cast chain for one forward's epilogues where torch has
    the format (`dtype`): fmt(f16(y)), plus fmt(bias), through float16 to
    fmt, relu; several launches a layer, and torch's conversions, not
    ml_dtypes'."""
    outs = []
    for y, b, relu in layers:
        r = y.half().to(dtype).float()
        s = (r + b.to(dtype).float().view(-1, 1, 1)).half().to(dtype).float()
        outs.append(torch.relu(s) if relu else s)
    return outs


def _queued_by_layer(fn, sets) -> float:
    """Device ms of `fn` on a forward's layers, each layer queued on its
    own (`queued_ms`): a whole forward of the plain version, an integer
    op at a time on every element, does not queue behind the sleep."""
    return sum(queued_ms(fn, [[layer]]) for layers in sets
               for layer in layers) / len(sets)


def small_float_layers(model, images) -> tuple:
    """The kernel's inputs in one forward of a small-float `model` on
    `images`: (the input cast's: the normalised, padded float32 input;
    the epilogues': [(raw convolution output, bias, relu)] of its eight
    layers)."""
    rec: list = []
    inputs: list = []
    real = model._cast_input
    model._cast_input = lambda x: (inputs.append(x), real(x))[1]
    try:
        with torch.inference_mode(), recorded_epilogues(rec):
            model(images)
    finally:
        del model._cast_input
    return inputs[0], rec


def small_float_rows(sets: int = 4, batch: int = 64, old=None) -> list[dict]:
    """The small-float epilogue's rows at the live asset's shapes: the
    eight epilogues of one forward of the asset in SMALL_FLOAT_FORMAT at
    `batch` x 32 x 1801 (beam scans), the kernel, its plain version and
    torch's cast chain (`small_float_yardstick`) in turns, beside the
    bound of the kernel's bytes; each set's kernel output checked bit for
    bit against the plain version first; the input cast (the kernel's
    direct mode) and its plain version; and the wrapper's host time a
    call (`wrapper_host_us`: 200 calls on 8 elements, which the card
    runs faster than the host issues them). With `old` (an earlier
    library, `_build_old`), its direct cast in the same turns
    (`cast_old`), each set's output held bit for bit to the new one's."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.ops import small_float

    import numpy as np

    dev = torch.device("cuda", 0)
    model, _ = _asset_fcn(dev, SMALL_FLOAT_FORMAT)
    fmt, out = model.fmt, model.act_dtype
    spec, inputs, casts = RangeViewSpec(), [], []
    for i in range(sets):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(100 + i), batch, 32768)
        with torch.inference_mode():
            images = range_view_project_batch(torch.from_numpy(p).to(dev), spec,
                                              torch.from_numpy(v).to(dev))
        x, layers = small_float_layers(model, images)
        casts.append(x)
        inputs.append(layers)
    with torch.inference_mode():
        for layers in inputs[:2]:
            got = small_float_forward(layers, fmt, out)
            want = small_float_forward(layers, fmt, out, small_float.conv_epilogue_reference)
            assert all(map(small_float.same_bits, got, want)), (
                "small_float epilogue differs from its plain version")
        fns = {"new": lambda ls: small_float_forward(ls, fmt, out),
               "plain": lambda ls: small_float_forward(
                   ls, fmt, out, small_float.conv_epilogue_reference)}
        if fmt.torch_dtype is not None:
            fns["yardstick"] = lambda ls: small_float_yardstick(ls, fmt.torch_dtype)
        call = time_turns(fns, inputs, time_ms)
        dev_t = time_turns(fns, inputs, lambda fn, xs: (
            _queued_by_layer if fn is fns["plain"] else queued_ms)(fn, xs))
        cast_fns = {"cast": lambda x: small_float.cast(x, fmt, out=out),
                    "cast_plain": lambda x: small_float.cast_reference(x, fmt, out=out)}
        if fmt.torch_dtype is not None:  # one PyTorch call computing the same cast
            cast_fns["cast_library"] = lambda x: x.to(fmt.torch_dtype)
        if old is not None:
            old_cast = _old_small_float_cast(old)
            for x in casts:
                assert small_float.same_bits(old_cast(x, fmt, out),
                                             small_float.cast(x, fmt, out=out))
            cast_fns["cast_old"] = lambda x: old_cast(x, fmt, out)
        cast_t = time_turns(cast_fns, casts, lambda fn, xs: queued_each(fn, xs))
        tiny = (torch.ones(1, 1, 1, 8, dtype=out, device=dev), torch.zeros(1, device=dev))
        for _ in range(20):
            small_float.conv_epilogue(*tiny, fmt, out=out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            small_float.conv_epilogue(*tiny, fmt, out=out)
        host_us = (time.perf_counter() - t0) / 200 * 1e6  # the card keeps up: host-paced
        torch.cuda.synchronize()
    layers = inputs[0]
    bound = small_float_bound_ms([y for y, _, _ in layers] + [b for _, b, _ in layers],
                                 small_float_forward(layers, fmt, out))
    return [{"shape": f"{batch} x 32 x 1801, 8 layers, {fmt.name}", "kernel": "small_float",
             "elements": sum(y.numel() for y, _, _ in layers), "bound_ms": bound,
             "wrapper_host_us": host_us,
             "input_cast_shape": tuple(casts[0].shape),
             "input_cast_bound_ms": small_float_bound_ms(casts[:1], [casts[0].to(out)]),
             **{f"{k}_device_ms": v for k, v in cast_t.items()},
             **{f"{k}_call_ms": v for k, v in call.items()},
             **{f"{k}_device_ms": v for k, v in dev_t.items()}}]


@contextlib.contextmanager
def recorded_backwards(into: list):
    """While open, every call of the small-float backward
    (`small_float.conv_epilogue_backward`, the epilogues' and the casts'
    `round_grad`) appends its arguments (grads, saved, fmt, relu, out,
    bias) to `into`."""
    from tpufusion_torch.ops import small_float

    real = small_float.conv_epilogue_backward

    def backward(grads, saved, fmt, relu, out=None, bias=True):
        into.append((list(grads), saved, fmt, relu, out, bias))
        return real(grads, saved, fmt, relu, out, bias)

    small_float.conv_epilogue_backward = backward
    try:
        yield into
    finally:
        small_float.conv_epilogue_backward = real


def small_float_step_backwards(model, batch, spec, loss_cfg, yaw_frame: str) -> list:
    """The backward's calls (`recorded_backwards`) of one train step of a
    small-float direct-head `model` on `batch` (a points batch on its
    device)."""
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import make_train_step

    from tpufusion_torch.config import TrainConfig

    step = make_train_step(spec, loss_cfg, TrainConfig(augment=False), head="direct",
                           yaw_frame=yaw_frame, device=next(model.parameters()).device)
    calls: list = []
    with recorded_backwards(calls):
        step(model, Adam(model.parameters(), 1e-3), batch)
    return calls


def small_float_backward(calls, plain: bool = False):
    """The recorded backward calls again, through the kernel's wrapper or
    its plain version (on the same device)."""
    from tpufusion_torch.ops import small_float

    fn = (small_float.conv_epilogue_backward_reference if plain
          else small_float.conv_epilogue_backward)
    return [fn(*call) for call in calls]


def small_float_calls(sets: int = 2, batch: int = 32) -> list:
    """The backward's calls (`recorded_backwards`) of `sets` train steps of
    the asset in SMALL_FLOAT_FORMAT at `batch` x 32 x 1801 (beam scans)."""
    import numpy as np

    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch.config import LossConfig
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch

    dev = torch.device("cuda", 0)
    model, dcfg = _asset_fcn(dev, SMALL_FLOAT_FORMAT)
    model.train()
    calls_sets = []
    for i in range(sets):
        p, gt, v = synthesize_beam_scan_batch(np.random.default_rng(200 + i), batch, 32768)
        b = {"points": p, "valid": v, **{k: gt[k] for k in ("center", "size", "yaw")}}
        b = {k: torch.from_numpy(x).to(dev) for k, x in b.items()}
        calls_sets.append(small_float_step_backwards(
            model, b, RangeViewSpec(), LossConfig(weight_bb=1.0), dcfg.direct_yaw_frame))
    return calls_sets


def small_float_backward_rows(sets: int = 2, batch: int = 32, calls_sets=None,
                              old=None) -> list[dict]:
    """The small-float backward's row at the trainer's shapes: the calls of
    one train step of the asset in SMALL_FLOAT_FORMAT at `batch` x 32 x
    1801 (beam scans; 8 epilogues with their bias gradients, 9 no-bias
    roundings), or `calls_sets` (such steps' calls, already held to the
    plain version): the kernel's device time over a step's calls and over
    each call; on the largest call (the first, deconv6b's epilogue) the
    kernel's device time, and the kernel and its plain version on the
    card between CUDA events (the plain version's reduce is a Python loop
    of launches: host-paced, not queued; timed once); each beside the
    bound of the bytes its calls read and write once. Without
    `calls_sets` the first set is checked bit for bit against the plain
    version on the CPU first. With `old` (an earlier library,
    `_build_old`), its backward in the same turns over a step's calls
    (`step_old`) and on the largest call (`old`), held to the new one's
    bits first."""
    from tpufusion_torch.ops import small_float

    fmt_name = SMALL_FLOAT_FORMAT
    if calls_sets is None:
        calls_sets = small_float_calls(sets, batch)
        for grads, saved, fmt, relu, out, bias in calls_sets[0]:
            assert small_float.backward_against_plain(grads, saved, fmt, relu, out, bias)[2], (
                "small_float backward differs from its plain version")
    else:
        fmt_name = calls_sets[0][0][2].name
    calls = calls_sets[0]

    def bound_of(cs):
        outs = small_float_backward(cs)
        ins = [t for c in cs for t in c[0] + ([c[1]] if c[1] is not None else [])]
        return small_float_bound_ms(ins, [t for o in outs for t in o if t is not None])

    # the step's calls; the largest (the first: deconv6b's epilogue) alone
    # for the plain version, whose reduce loops on the host
    largest = [calls[0]]
    call = time_turns({"new": small_float_backward}, [largest],
                      lambda fn, xs: time_ms(fn, xs, warmup=0))
    call["plain"] = time_ms(lambda c: small_float_backward(c, plain=True), [largest], warmup=0)
    fns = {"new": small_float_backward}
    steps = {"step": small_float_backward}
    if old is not None:
        old_bwd = _old_small_float_backward(old)
        for c in calls:
            got, want = old_bwd(*c), small_float.conv_epilogue_backward(*c)
            assert all(w is None if g is None else small_float.same_bits(g, w)
                       for g, w in zip(got, want)), "the earlier backward differs from the new"
        fns["old"] = lambda cs: [old_bwd(*c) for c in cs]
        steps["step_old"] = lambda cs: [old_bwd(*c) for c in cs]
    dev_t = time_turns(fns, [largest], queued_ms)
    step_t = time_turns(steps, calls_sets, queued_ms)
    per_call = [queued_ms(small_float_backward, [[c]]) for c in calls]
    epilogues = [c for c in calls if c[5]]
    b = calls[0][0][0].shape[0]
    return [{"shape": f"{b} x 32 x 1801, one train step, {fmt_name}",
             "kernel": "small_float_backward", "calls": len(calls),
             "epilogue_calls": len(epilogues),
             "elements": sum(c[0][0].numel() for c in epilogues),
             "call_shape": tuple(calls[0][0][0].shape), "bound_ms": bound_of(largest),
             "step_bound_ms": bound_of(calls), "per_call_device_ms": per_call,
             "per_call_shapes": [tuple(c[0][0].shape) + (len(c[0]),) for c in calls],
             **{f"{k}_call_ms": v for k, v in call.items()},
             **{f"{k}_device_ms": v for k, v in (dev_t | step_t).items()}}]


def small_float_reduce_rows(calls_sets) -> list[dict]:
    """The bias gradient's reduce alone (`small_float.bias_grad`, the
    segments' maps and their composition) on the cotangents of a train
    step's epilogue calls (`recorded_backwards` sets, already held to the
    plain version): each reduce first held bit for bit to its plain
    version on the CPU, then the kernel's device time over a step's
    reduces and on the largest (the first, deconv6b's), the plain version
    on the card on the largest between CUDA events (a Python loop of a
    step's launches a window element: host-paced, timed once), each
    beside the bound of the bytes they read and write once."""
    from tpufusion_torch.ops import small_float

    fmt = calls_sets[0][0][2]
    sets = [[small_float.conv_epilogue_backward(*c)[0] for c in cs if c[5]] for cs in calls_sets]
    for g in sets[0]:
        assert small_float.same_bits(small_float.bias_grad(g, fmt).cpu(),
                                     small_float.bias_grad_reference(g.cpu(), fmt)), (
            "the reduce differs from its plain version")

    def reduce(gs):
        return [small_float.bias_grad(g, fmt) for g in gs]

    def bound(gs):
        return small_float_bound_ms(gs, [torch.empty(g.shape[1]) for g in gs])

    largest = [sets[0][0]]
    dev_t = time_turns({"new": reduce}, [largest], queued_ms)
    step_t = time_turns({"step": reduce}, sets, queued_ms)
    plain = time_ms(lambda gs: [small_float.bias_grad_reference(g, fmt) for g in gs], [largest],
                    warmup=0)
    return [{"shape": f"{tuple(largest[0].shape)}, {fmt.name}", "kernel": "small_float_reduce",
             "reduces": len(sets[0]), "elements": sum(g.numel() for g in sets[0]),
             "bound_ms": bound(largest), "step_bound_ms": bound(sets[0]),
             "plain_call_ms": plain, "per_reduce_shapes": [tuple(g.shape) for g in sets[0]],
             **{f"{k}_device_ms": v for k, v in (dev_t | step_t).items()}}]


REDUCE_MARKS = (32, 128, 512, 2048)  # steps into a segment at which its distinct codes are counted


def reduce_distinct_codes(g: torch.Tensor, fmt, sms: int, marks=REDUCE_MARKS) -> dict:
    """What the reduce's segments carry on a cotangent g (B, C, H, W) of
    the format's values: each chain (a channel's first-level window,
    `small_float.xla_sum_levels`) cut into `small_float.reduce_segments`
    runs for a card of `sms` multiprocessors (here equal runs of the
    padded window, its padding skipped), every one of the format's codes
    carried through each run by the add table, as the kernel's segments
    carry them -> {"chains", "segments", "steps" (a run's elements, the
    mean), "nonzero_steps" (of them, the mean share that adds a nonzero
    value), "distinct": {k: the mean, least and most distinct codes a run
    holds after k of its elements, for each k of `marks` below its
    length, and "end"}}. Computed with torch ops on g's device."""
    from tpufusion_torch.ops import small_float as sf

    n = sf._n_codes(fmt)
    table = sf.add_table(fmt).reshape(-1).to(g.device)
    levels = sf.xla_sum_levels((g.shape[0], g.shape[2], g.shape[3]))
    segments = sf.reduce_segments(levels, g.shape[1], sms)
    codes = sf.encode(sf._f32(g), fmt).permute(1, 0, 2, 3)
    windows = levels[0]
    pads = [(lo, w * count - size - lo) for (w, count, lo), size in zip(windows, codes.shape[1:])]
    codes = torch.nn.functional.pad(codes, [p for lo_hi in pads[::-1] for p in lo_hi],
                                    value=sf._PAD)
    c = codes.shape[0]
    (wb, cb, _), (wh, ch, _), (ww, cw, _) = windows
    rows = codes.reshape(c, cb, wb, ch, wh, cw, ww).permute(0, 1, 3, 5, 2, 4, 6)
    rows = rows.reshape(c * cb * ch * cw, wb * wh * ww)
    run = -(-rows.shape[1] // segments)
    rows = torch.nn.functional.pad(rows, (0, run * segments - rows.shape[1]), value=sf._PAD)
    runs = rows.reshape(-1, segments, run).reshape(-1, run)  # (chains x segments, run)
    zeros = sf.encode(torch.tensor([0.0, -0.0]), fmt).tolist()
    real = runs != sf._PAD
    nonzero = real & (runs != zeros[0]) & (runs != zeros[1])
    state = torch.arange(n, device=g.device).expand(runs.shape[0], n).clone()

    def distinct():
        d = 1 + (state.sort(dim=1).values.diff(dim=1) != 0).sum(dim=1)
        return {"mean": float(d.float().mean()), "min": int(d.min()), "max": int(d.max())}

    out = {}
    for k in range(run):
        if k in marks:
            out[k] = distinct()
        x = runs[:, k:k + 1]  # a zero or a padded place: skipped, as the kernel skips it
        state = torch.where(nonzero[:, k:k + 1], table[state * n + x.clamp(min=0)], state)
    out["end"] = distinct()
    return {"chains": rows.shape[0], "segments": segments,
            "steps": float(real.sum(dim=1).float().mean()),
            "nonzero_steps": float(nonzero.sum() / real.sum().clamp(min=1)), "distinct": out}


def _asset_fcn(dev, dtype: str):
    """The shipped asset's FCN in `dtype` on `dev` and its DecodeConfig."""
    import dataclasses

    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import asset_configs, load_state_npz

    asset = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
    mcfg, dcfg = asset_configs(asset)
    model = FCN(dataclasses.replace(mcfg, dtype=dtype))
    load_state_npz(asset, model)
    return model.to(dev).eval(), dcfg


def dsmem_probe() -> str:
    """Builds and runs probes/dsmem_min64.cu; returns what it prints."""
    from tpufusion_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    exe = os.path.join(_build.BUILD_DIR, "dsmem_min64")
    src = os.path.join(_HERE, "probes", "dsmem_min64.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-o", exe, src],
                   check=True, capture_output=True, text=True)
    return subprocess.run([exe], check=True, capture_output=True, text=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", help="directory with the earlier design's .cu sources")
    ap.add_argument("--sets", type=int, default=12, help="distinct batches per timing")
    ap.add_argument("--kernels",
                    default="exact,cc,packed,encode,encode_direct,decode_direct,corner_vote,"
                            "small_float,small_float_backward,small_float_reduce",
                    help="which kernels' rows: exact and cc need --old-csrc")
    ap.add_argument("--dsmem-probe", action="store_true",
                    help="also build and run probes/dsmem_min64.cu")
    ap.add_argument("--decode-clusters", default="",
                    help="comma-separated cluster widths of the direct decode to time beside it")
    ap.add_argument("--decode-dtypes", default="float32",
                    help="the direct decode's head outputs: float32, and bfloat16 and / or "
                         "float16 (float32,bfloat16,float16) to time those instances and "
                         "their plain versions in the same turns")
    ap.add_argument("--out", help="write the card and the rows here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[{card}]")
    if args.dsmem_probe:
        print(dsmem_probe(), end="")
    kernels = tuple(args.kernels.split(","))
    old = _build_old(args.old_csrc) if args.old_csrc else None
    rows = ab(old, args.sets, kernels) if old is not None or "packed" in kernels else []
    if "encode" in kernels:
        rows += encode_rows(args.sets)
    if "encode_direct" in kernels:
        rows += encode_direct_rows(args.sets)
    if "decode_direct" in kernels:
        clusters = tuple(int(c) for c in args.decode_clusters.split(",") if c)
        dtypes = args.decode_dtypes.split(",")
        if not set(dtypes) <= {"float32", "bfloat16", "float16"} or "float32" not in dtypes:
            raise SystemExit(f"--decode-dtypes: float32[,bfloat16][,float16], got "
                             f"{args.decode_dtypes}")
        rows += decode_direct_rows(args.sets, old=old, clusters=clusters,
                                   low=tuple(getattr(torch, d) for d in dtypes if d != "float32"))
    if "corner_vote" in kernels:
        rows += corner_vote_rows(min(args.sets, 6), old=old)
    if "small_float" in kernels:
        rows += small_float_rows(min(args.sets, 4), old=old)
    if "small_float_backward" in kernels or "small_float_reduce" in kernels:
        calls = small_float_calls(min(args.sets, 2))
        if "small_float_backward" in kernels:
            rows += small_float_backward_rows(calls_sets=calls, old=old)
        if "small_float_reduce" in kernels:
            rows += small_float_reduce_rows(calls)
    if args.out:  # before the print, which a row's odd field must not cost
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    for r in rows:
        names = [k[: -len("_device_ms")] for k in r
                 if k.endswith("_device_ms") and isinstance(r[k], float)]
        times = ", ".join(
            f"{k} {r[f'{k}_device_ms'] * 1e3:.2f} us device"
            + (f" / {r[f'{k}_call_ms'] * 1e3:.2f} us a call" if f"{k}_call_ms" in r else "")
            for k in names)
        plans = "".join(f"; {k} {r[k]}" for k in ("plan_16", "plan_8") if k in r)
        lows = "".join(f"; {tag} bound {r[f'bound_ms_{tag}'] * 1e3:.3f} us"
                       for tag in LOW_TAGS.values() if f"bound_ms_{tag}" in r)
        print(f"{r['kernel']} {r['shape']}: {times}; bound {r['bound_ms'] * 1e3:.2f} us, "
              f"new at {r['bound_ms'] / r['new_device_ms']:.1%} of it{plans}{lows} [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
