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
image stores alone). `--kernels` picks among exact, cc and packed. With
`--out FILE` the rows are also written there as JSON.

    python -m tpufusion_torch.kernel_bench --dsmem-probe

builds and runs `probes/dsmem_min64.cu`, which checks whether atomics on
distributed shared memory are exact on this card.
"""

from __future__ import annotations

import argparse
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
    if the profile holds no device record."""
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
    rows = {e.key: e.device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    if not any(rows.values()):
        raise RuntimeError("torch.profiler returned no device record of the calls")
    return rows


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
    return lib


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


def ab(old_csrc: str | None, sets: int = 12, kernels=("exact", "cc", "packed")) -> list[dict]:
    from tpufusion_torch.ops import cc, components, projection

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _build_old(old_csrc) if old_csrc else None
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
    ap.add_argument("--kernels", default="exact,cc,packed",
                    help="which kernels' rows: exact and cc need --old-csrc")
    ap.add_argument("--dsmem-probe", action="store_true",
                    help="also build and run probes/dsmem_min64.cu")
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
    rows = ab(args.old_csrc, args.sets, kernels) if args.old_csrc or "packed" in kernels else []
    for r in rows:
        names = [k[: -len("_device_ms")] for k in r if k.endswith("_device_ms")]
        times = ", ".join(
            f"{k} {r[f'{k}_device_ms'] * 1e3:.2f} us device / {r[f'{k}_call_ms'] * 1e3:.2f} us a call"
            for k in names)
        plans = "".join(f"; {k} {r[k]}" for k in ("plan_16", "plan_8") if k in r)
        print(f"{r['kernel']} {r['shape']}: {times}; bound {r['bound_ms'] * 1e3:.2f} us, "
              f"new at {r['bound_ms'] / r['new_device_ms']:.1%} of it{plans} [{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
