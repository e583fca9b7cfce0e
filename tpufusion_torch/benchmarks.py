"""Serving benchmark configs 1-3 (counterpart of `tpufusion/benchmarks.py`).

  1. single velodyne frame: BEV + cylindrical projection + FCN forward
  2. 64-frame chunk replay: projection + FCN + tracklet box decode
  3. camera + lidar fused: calibration paints camera channels onto the BEV
     before the BEV FCN, plus the late-fusion net (camera + lidar + radar)
     with the shipped asset `fusion_net.npz`

Config 5 is driven by `chip_smoke.py`; config 4 needs a trained state and
waits for the training slice.

Each config builds its step and its inputs (numpy beam scans made from
seeds) and returns the reference's result dict plus the device it ran on.
On the card a config is timed between CUDA events over distinct inputs
after a warm-up call, and reports its peak device memory and, from one
more pass over the same inputs, the step's device time (the kernels' own
durations) and its share of the time between the events; asked for the
CPU (the tests do, at small sizes) it is timed on the host clock and says
so. The FCN weights are drawn from a seed unless the caller passes a
model; the fusion net's are the asset's, and a missing or mismatched asset
raises.

Run: python -m tpufusion_torch.benchmarks [--configs 1,2,3] [--device cuda]
— the card's name and power limit, then one JSON line per config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT, BevSpec, ModelConfig
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry.bev import bev_rasterize_batch
from tpufusion_torch.geometry.camera import paint_bev, paint_table, synthetic_camera
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.kernel_bench import device_ms
from tpufusion_torch.models.fcn import FCN, uniform_init_
from tpufusion_torch.models.fusion import FusionNet
from tpufusion_torch.models.io import fusion_from_asset
from tpufusion_torch.predict import make_e2e_step

CFG = DEFAULT
SPEC = CFG.range_view
# config 3's BEV: density + height, painted camera as the third channel
FUSED_BEV = BevSpec(with_height_channel=True, with_intensity_channel=False)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's `name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_fcn(cfg: ModelConfig, seed: int, device) -> FCN:
    """A bf16 FCN of `cfg` with kernels drawn from `seed` and the
    reference benchmark's background-leaning softmax (deconv6a bias
    [2, -2], a trained net's sparsity)."""
    model = FCN(dataclasses.replace(cfg, dtype="bfloat16"), in_channels=3)
    uniform_init_(model, seed)
    with torch.no_grad():
        model.deconv6a.bias.copy_(torch.tensor([2.0, -2.0]))
    return model.to(device).eval()


def point_sets(n_sets: int, batch: int, n_points: int, device):
    """Beam-structured scan batches on `device`: [(points, valid), ...]."""
    sets = []
    for i in range(n_sets):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(i), batch, n_points)
        sets.append((torch.from_numpy(p).to(device), torch.from_numpy(v).to(device)))
    return sets


def measure(fn, argsets: list[tuple], reps: int, device) -> tuple[float, dict]:
    """(mean seconds per call over len(argsets) * reps calls after one
    warm-up call, {"timer": ..., "peak_device_mib": ...,
    "resident_before_mib": ..., "device_ms_per_call": ..., "device_busy":
    ...}). On the card: CUDA events and the allocator's peak, beside what
    was allocated before the timed calls (the inputs, the weights, the
    caller's own tensors); then one more pass over `argsets` under
    torch.profiler for the device time a call (`kernel_bench.device_ms`)
    and its share of the events' time a call. On the CPU: the host
    clock."""
    device = torch.device(device)
    fn(*argsets[0])
    n = reps * len(argsets)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            for a in argsets:
                fn(*a)
        return (time.perf_counter() - t0) / n, {"timer": "host clock"}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device) / 2**20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for a in argsets:
            fn(*a)
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    ms = start.elapsed_time(end) / n
    busy_ms = device_ms(lambda a: fn(*a), argsets)
    return ms * 1e-3, {
        "timer": "CUDA events", "peak_device_mib": round(peak, 1),
        "resident_before_mib": round(resident, 1),
        "device_ms_per_call": round(busy_ms, 3), "device_busy": round(busy_ms / ms, 3)}


def _where(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def make_config1_step(model: FCN, device: torch.device | str = "cuda"):
    """fn(points (B, N, 4), valid (B, N)) -> (FCN output on the range
    view, BEV raster)."""
    model.to(device).eval()

    @torch.inference_mode()
    def fn(points, valid):
        images = range_view_project_batch(points, SPEC, valid)
        bev = bev_rasterize_batch(points, CFG.bev, valid)
        return model(images), bev

    return fn


def config1_single_frame(
    device: torch.device | str = "cuda",
    model: FCN | None = None,
    n_points: int = 32768,
    n_sets: int = 6,
    reps: int = 3,
) -> dict:
    """BEV + range projection + FCN forward, single frame."""
    model = model if model is not None else seeded_fcn(CFG.model, 0, device)
    fn = make_config1_step(model, device)
    dt, how = measure(fn, point_sets(n_sets, 1, n_points, device), reps, device)
    return {
        "config": 1,
        "metric": "single-frame BEV+range+FCN forward",
        "value": round(dt * 1e3, 3),
        "unit": "ms/frame",
        "fps": round(1.0 / dt, 1),
        "device": _where(device),
        **how,
    }


def config2_replay(
    device: torch.device | str = "cuda",
    model: FCN | None = None,
    batch: int = 64,
    n_points: int = 32768,
    n_sets: int = 6,
    reps: int = 2,
) -> dict:
    """64-frame chunk through projection + FCN + pose decode (the
    reference's step: the corner decode of a seeded corner head)."""
    model = model if model is not None else seeded_fcn(CFG.model, 0, device)
    fn = make_e2e_step(model, SPEC, CFG.decode, head="corner", device=device)
    dt, how = measure(fn, point_sets(n_sets, batch, n_points, device), reps, device)
    return {
        "config": 2,
        "metric": f"{batch}-frame replay projection+FCN+decode",
        "value": round(batch / dt, 1),
        "unit": "frames/s/chip",
        "ms_per_chunk": round(dt * 1e3, 1),
        "device": _where(device),
        **how,
    }


def fuse_bev(points, valid, cam_img, table, bev_spec: BevSpec = FUSED_BEV):
    """Config 3's BEV FCN input (B, ny, nx - 2, 3): the BEV raster with
    the camera painted through `table` as its third channel, width-major,
    cropped 1199 -> 1197 so the FCN's widths round-trip."""
    bev = bev_rasterize_batch(points, bev_spec, valid)  # (B, nx, ny, 2)
    fused = torch.cat([bev, paint_bev(cam_img, table)[..., None]], dim=-1)
    return fused.transpose(1, 2)[:, :, : bev_spec.nx - 2, :]


def make_config3_step(
    bev_fcn: FCN,
    fusion: FusionNet,
    device: torch.device | str = "cuda",
    bev_spec: BevSpec = FUSED_BEV,
    camera=None,
):
    """fn(points (B, N, 4), valid (B, N), cam_img (B, Hc, Wc, 1), radar
    (B, 2)) -> (seg, centroid, rz): the camera painted onto the BEV
    through the calibration table (built once, on the host, kept on the
    device), the fused raster through the BEV FCN, and the late-fusion
    net. `camera` defaults to the reference benchmark's forward-facing
    pinhole at 1368 x 512."""
    camera = camera if camera is not None else synthetic_camera(1368, 512, 1400.0)
    table = paint_table(camera, bev_spec, device)
    bev_fcn.to(device).eval()
    fusion.to(device).eval()

    @torch.inference_mode()
    def fn(points, valid, cam_img, radar):
        seg = bev_fcn(fuse_bev(points, valid, cam_img, table, bev_spec))
        lidar_img = range_view_project_batch(points, SPEC, valid)
        centroid, rz = fusion(cam_img, lidar_img, radar)
        return seg, centroid, rz

    return fn


def config3_inputs(device, batch: int = 8, n_points: int = 32768, n_sets: int = 6):
    """Config 3's distinct inputs on `device`: [(points, valid, cam_img
    (B, 512, 1368, 1) uniform noise, radar (B, 2)), ...], as the
    reference benchmark draws them."""
    cam_cfg = CFG.camera
    rng = np.random.default_rng(7)
    args = []
    for p, v in point_sets(n_sets, batch, n_points, device):
        cam_img = rng.uniform(0, 1, (batch, cam_cfg.height, cam_cfg.width, 1))
        radar = rng.uniform(-1, 1, (batch, 2))
        args.append((
            p, v,
            torch.from_numpy(cam_img.astype(np.float32)).to(device),
            torch.from_numpy(radar.astype(np.float32)).to(device),
        ))
    return args


def fusion_asset_path() -> str:
    """The shipped fusion asset (the reference package's assets folder)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "tpufusion", "assets", "fusion_net.npz")


def config3_fused(
    device: torch.device | str = "cuda",
    bev_fcn: FCN | None = None,
    fusion: FusionNet | None = None,
    batch: int = 8,
    n_points: int = 32768,
    n_sets: int = 6,
    reps: int = 3,
) -> dict:
    """Camera channels painted onto the BEV, the fused tensor through an
    FCN forward, plus the late-fusion net forward, in one timed step."""
    if bev_fcn is None:
        bev_fcn = seeded_fcn(ModelConfig(), 1, device)
    weights = "caller's net"
    if fusion is None:
        fusion = fusion_from_asset(fusion_asset_path(), device)
        weights = "trained asset"
    fn = make_config3_step(bev_fcn, fusion, device)
    args = config3_inputs(device, batch, n_points, n_sets)
    dt, how = measure(fn, args, reps, device)
    return {
        "config": 3,
        "metric": f"camera-painted BEV + FCN + fusion-net forward (batch {batch})",
        "value": round(dt * 1e3 / batch, 3),
        "unit": "ms/frame",
        "fps": round(batch / dt, 1),
        "fusion_weights": weights,
        "device": _where(device),
        **how,
    }


CONFIGS = {1: config1_single_frame, 2: config2_replay, 3: config3_fused}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(card_line(), flush=True)
    for c in [int(x) for x in args.configs.split(",")]:
        log(f"running config {c} ...")
        print(json.dumps(CONFIGS[c](device=args.device)), flush=True)


if __name__ == "__main__":
    main()
