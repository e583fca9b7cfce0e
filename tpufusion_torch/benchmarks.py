"""Benchmark configs 1-5 (counterpart of `tpufusion/benchmarks.py`).

  1. single velodyne frame: BEV + cylindrical projection + FCN forward
  2. 64-frame chunk replay: projection + FCN + tracklet box decode
  3. camera + lidar fused: calibration paints camera channels onto the BEV
     before the BEV FCN, plus the late-fusion net (camera + lidar + radar)
     with the shipped asset `fusion_net.npz`
  4. full evaluation at batch 32: predict -> CSV -> tracklet XML -> pose /
     IoU scoring against the generator's ground truth, with the shipped
     detector asset or, when the caller asks for it, a detector
     quick-trained in the benchmark; with the reference's companion rows:
     the wide-yaw asset on its oriented-ellipse scenes (`wide_yaw`) and
     the mixed-family asset on circle, ellipse and box scenes
     (`mixed_family`)
  5. Waymo scale: 64-beam clouds of 131,072 points through the asset's
     top-4 decode, then a 16-frame two-vehicle sequence tracked by
     `PoseTracker`, and the oriented row: ellipse vehicles heading along
     their velocity, the wide-yaw asset, tracked in the physical frame

Each config builds its step and its inputs (numpy beam scans made from
seeds) and returns the reference's result dict plus the device it ran on.
On the card a config is timed between CUDA events over distinct inputs
after a warm-up call, and reports its peak device memory and, from one
more pass over the same inputs, the step's device time (the kernels' own
durations) and its share of the time between the events; asked for the
CPU (the tests do, at small sizes) it is timed on the host clock and says
so. The FCN weights are drawn from a seed unless the caller passes a
model; the fusion net's and the detector assets' are the shipped ones,
and a missing or mismatched asset raises: the reference's companion rows
drop themselves on any fault, these do not.

Run: python -m tpufusion_torch.benchmarks [--configs 1,2,3,4,5] [--device cuda]
— the card's name and power limit, then one JSON line per config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpufusion_torch.config import (
    DEFAULT,
    BevSpec,
    DecodeConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from tpufusion_torch.data.synthetic import (
    synthesize_beam_scan_batch,
    synthesize_beam_tracking_sequence,
)
from tpufusion_torch.eval.scoring import orbit_to_physical, score_multi_poses, score_poses
from tpufusion_torch.eval.submission import generate_submission, write_predictions_csv
from tpufusion_torch.geometry.bev import bev_rasterize_batch
from tpufusion_torch.geometry.camera import paint_bev, paint_table, synthetic_camera
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.kernel_bench import device_ms
from tpufusion_torch.models.fcn import FCN, uniform_init_
from tpufusion_torch.models.fusion import FusionNet
from tpufusion_torch.models.io import asset_configs, fusion_from_asset, load_state_npz
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.tracker import PoseTracker, track_quality_metrics
from tpufusion_torch.tools.detector_envelope import base_condition_from_meta
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.stats import population_weights
from tpufusion_torch.train.train_step import make_train_step

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


def point_sets(n_sets: int, batch: int, n_points: int, device, n_beams: int = 32,
               seed0: int = 0):
    """Beam-structured scan batches on `device`: [(points, valid), ...],
    the i-th from numpy seed seed0 + i."""
    sets = []
    for i in range(n_sets):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(seed0 + i), batch, n_points,
                                             n_beams=n_beams)
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


def detector_asset_path(name: str = "synthetic_detector.npz") -> str:
    """A shipped detector asset (the reference package's assets folder)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "tpufusion", "assets", name)


def asset_model(path: str) -> tuple[FCN, DecodeConfig, str]:
    """(model, decode config, head) of a detector asset: its FCN in bf16
    with the head and widths its json names, its weights, and the decode
    thresholds of its json. Any fault raises."""
    mcfg, dcfg = asset_configs(path)
    model = FCN(dataclasses.replace(mcfg, dtype="bfloat16"), in_channels=3)
    load_state_npz(path, model)
    return model, dcfg, mcfg.head


def decode_for_resolution(dcfg: DecodeConfig, meta: dict | None, n_points: int) -> DecodeConfig:
    """An asset's decode overrides for the calibrated resolution nearest
    `n_points` (its json's `decode_per_resolution` table, {points per
    frame: {field: value}}) over `dcfg`; no table, `dcfg` unchanged."""
    table = (meta or {}).get("decode_per_resolution") or {}
    if not table:
        return dcfg
    key = min(table, key=lambda k: abs(int(k) - n_points))
    return dataclasses.replace(dcfg, **table[key])


def _rounded(v, nd: int = 3) -> float | None:
    """A metric rounded, or None where it is absent (never a NaN, which
    json.dumps would write as a token JSON parsers refuse)."""
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return None
    return round(v, nd)


def _protocol_scores(fn, n_points: int, seed_base: int, scene_kw: dict, frames: int,
                     batch: int, device) -> dict:
    """The accuracy protocol of config 4's companion rows: `frames` scenes
    of `scene_kw` from numpy seeds seed_base, seed_base + 1, ... in
    batches of `batch`, through the e2e step `fn`, scored in the orbit
    frame."""
    poses, truths = [], []
    for i in range(frames // batch):
        pts, gt, valid = synthesize_beam_scan_batch(
            np.random.default_rng(seed_base + i), batch, n_points, **scene_kw)
        p, _ = fn(torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device))
        poses.append(p.cpu().numpy())
        truths.append(np.concatenate([gt["center"], gt["yaw"][:, None], gt["size"]], axis=1))
    scores = score_poses(np.concatenate(poses), np.concatenate(truths), pose_frame="orbit")
    return {
        "detection_rate": scores["detection_rate"],
        "mean_iou": _rounded(scores["mean_iou"]),
        "recall@iou0.25": scores["recall@iou0.25"],
        "mean_xy_err": _rounded(scores.get("mean_xy_err")),
        "mean_yaw_err": _rounded(scores.get("mean_yaw_err")),
    }


def _companion_asset_eval(name: str, protocol, device) -> dict:
    """Config 4's companion scaffolding: the named asset's e2e step handed
    with its json to `protocol`, which returns the row. A missing or
    unreadable asset raises (the reference drops the row)."""
    path = detector_asset_path(name)
    with open(path + ".json") as f:
        meta = json.load(f)
    model, dcfg, head = asset_model(path)
    out = protocol(meta, make_e2e_step(model, SPEC, dcfg, head=head, device=device))
    out["asset"] = name
    return out


def mixed_family_eval(device: torch.device | str = "cuda", frames: int = 128,
                      batch: int = 32) -> dict:
    """The mixed-family asset (dual yaw codec, the boundary gated per
    cluster) on each surface family in turn: circle scenes at yaw cap
    min(max_yaw, 0.05), as trained, ellipse and box scenes at the asset's
    max_yaw."""
    def protocol(meta, fn):
        n_points = int(meta.get("n_points", 32768))
        max_yaw = float(meta.get("max_yaw", 0.45))
        per_family = {}
        for fam, surface in (("beam", "circle"), ("beam-ellipse", "ellipse"), ("beam-box", "box")):
            fam_yaw = min(max_yaw, 0.05) if fam == "beam" else max_yaw
            per_family[fam] = _protocol_scores(
                fn, n_points, 4100, dict(max_yaw=fam_yaw, vehicle_surface=surface),
                frames, batch, device)
        cross = float(np.mean([f["mean_iou"] for f in per_family.values()]))
        return {"max_yaw": max_yaw, "cross_family_mean_iou": round(cross, 3),
                "per_family": per_family}

    return _companion_asset_eval("synthetic_detector_mixed.npz", protocol, device)


def wide_yaw_eval(device: torch.device | str = "cuda", frames: int = 128,
                  batch: int = 32) -> dict:
    """The wide-yaw asset (oriented-ellipse scenes, the local yaw codec)
    on its own training distribution, from its json: the large-yaw regime
    the flagship's reference-like scenes (rz ~ 0) leave out."""
    def protocol(meta, fn):
        scene_kw = base_condition_from_meta(meta)
        n_points = scene_kw.pop("n_points")
        out = _protocol_scores(fn, n_points, 4000, scene_kw, frames, batch, device)
        out["max_yaw"] = scene_kw.get("max_yaw")
        out["scenes"] = meta.get("scenes")
        return out

    return _companion_asset_eval("synthetic_detector_yaw.npz", protocol, device)


def quick_trained_model(
    device: torch.device | str = "cuda",
    n_points: int = 32768,
    n_batches: int = 8,
    steps_per_batch: int = 15,
    batch: int = 32,
) -> tuple[FCN, DecodeConfig, str]:
    """(model, decode config, head) of a detector trained inside the
    benchmark, as the reference does when it has no asset: the default
    ModelConfig (corner head) in bf16, Adam 3e-3, the loss balanced by
    `population_weights` of one scene batch, `n_batches` distinct scene
    batches of `batch` x `n_points` points for `steps_per_batch` steps
    each, no augmentation. The scenes come from numpy seeds 42, 43, ...
    and the initial weights from torch seed 0."""
    device = torch.device(device)
    model = FCN(dataclasses.replace(CFG.model, dtype="bfloat16"), in_channels=3, seed=0).to(device)
    opt = Adam(model.parameters(), 3e-3)
    _, gt, _ = synthesize_beam_scan_batch(np.random.default_rng(42), batch, n_points)
    stats = population_weights(gt["center"], gt["size"], gt["yaw"], SPEC, device=device)
    step = make_train_step(
        SPEC,
        LossConfig(obj_to_bkg_ratio=stats["positive_to_negative_ratio"],
                   avg_obj_size=stats["average_area"]),
        TrainConfig(batch_size=batch, augment=False), device=device,
    )
    for i in range(n_batches):
        pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(42 + i), batch, n_points)
        scene = {"points": pts, "valid": valid, **gt}
        scene = {k: torch.from_numpy(v).to(device) for k, v in scene.items()}
        for _ in range(steps_per_batch):
            step(model, opt, scene)
    return model.eval(), CFG.decode, "corner"


def config4_full_eval(
    device: torch.device | str = "cuda",
    weights: str = "asset",
    frames: int = 128,
    batch: int = 32,
    n_points: int = 32768,
    reps: int = 3,
    quick_train: dict | None = None,
    companion_frames: int | None = None,
) -> dict:
    """Full evaluation: predict -> CSV -> tracklet XML -> pose / IoU
    scoring against the generator's ground truth.

    weights="asset" (the default) loads the shipped detector asset, in
    bf16 with the head and the decode thresholds its json names, and
    raises on any fault; weights="quick_train" trains a detector here
    first (`quick_trained_model(device, **quick_train)`). The reference
    falls back from the first to the second silently; here the caller
    chooses.

    The device phase (the e2e step over the pre-staged batches) is timed
    as every other config; the host artifact phase (CSV, tracklet XML,
    scoring) is timed apart, on the host clock. The companion rows
    `wide_yaw` and `mixed_family` run the same accuracy protocol on
    `companion_frames` scenes (default `frames`) a family. They always
    use the shipped wide-yaw and mixed assets, whatever `weights` is;
    companion_frames=0 leaves them out of the row."""
    device = torch.device(device)
    if weights == "asset":
        model, dcfg, head = asset_model(detector_asset_path())
    elif weights == "quick_train":
        model, dcfg, head = quick_trained_model(device, n_points, **(quick_train or {}))
    else:
        raise ValueError(f"weights must be 'asset' or 'quick_train', got {weights!r}")
    fn = make_e2e_step(model, SPEC, dcfg, head=head, device=device)

    sets, truths = [], []
    for i in range(frames // batch):
        # max_yaw ~ 0: under the orbit-origin corner convention a large yaw
        # makes the pose target unobservable for axis-aligned clusters
        pts, gt, valid = synthesize_beam_scan_batch(
            np.random.default_rng(1000 + i), batch, n_points, max_yaw=0.05)
        sets.append((torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device)))
        truths.append(np.concatenate([gt["center"], gt["yaw"][:, None], gt["size"]], axis=1))
    truth = np.concatenate(truths)  # (F, 7) tx ty tz rz l w h
    dt_dev, how = measure(fn, sets, reps, device)
    poses = np.concatenate([fn(*s)[0].cpu().numpy() for s in sets])  # one drain, not timed
    ts = (np.arange(len(poses)) * 100_000_000 + 1).tolist()
    size = {"l": 4.2, "w": 1.6, "h": 1.5}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        csv_path = os.path.join(d, "pred.csv")
        write_predictions_csv(poses, ts, csv_path)
        generate_submission(csv_path, ts, size, os.path.join(d, "sub.xml"))
    scores = score_poses(poses, truth, pose_frame="orbit")
    # the challenge fed the obstacle's metadata l/w/h into the tracklets,
    # never the decoded box: score that flow too
    found = ~np.all(poses[:, :3] == 0.0, axis=1)
    sub = poses.copy()
    sub[found, 4:7] = [size["l"], size["w"], size["h"]]
    sub_scores = score_poses(sub, truth, pose_frame="orbit")
    host_dt = time.perf_counter() - t0
    cframes = companion_frames if companion_frames is not None else frames
    row = {
        "config": 4,
        "metric": f"full eval: predict+XML+scoring, {len(poses)} frames @ batch {batch}",
        "value": round(batch / dt_dev, 1),
        "unit": "frames/s/chip (device)",
        "weights": weights,
        "head": head,
        "host_artifacts_ms_total": round(host_dt * 1e3, 1),
        "host_artifacts_ms_per_frame": round(host_dt * 1e3 / len(poses), 3),
        "detection_rate": scores["detection_rate"],
        "mean_iou": _rounded(scores["mean_iou"]),
        "recall@iou0.25": scores["recall@iou0.25"],
        "mean_xy_err": _rounded(scores.get("mean_xy_err")),
        "submission_mean_iou": _rounded(sub_scores["mean_iou"]),
        "submission_recall@iou0.25": sub_scores["recall@iou0.25"],
        "device": _where(device),
        **how,
    }
    if cframes:
        row["wide_yaw"] = wide_yaw_eval(device, cframes, batch)
        row["mixed_family"] = mixed_family_eval(device, cframes, batch)
    return row


def _tracking_row(poses: np.ndarray, found: np.ndarray, gt: dict, physical: bool) -> dict:
    """Tracking quality and per-box scores of a decoded sequence. With
    `physical`, poses and ground truth are turned into the physical frame
    before tracking: constant velocity holds for physical positions, not
    orbit tuples, where a yaw error would pass for motion."""
    track_poses, gt_centers = poses, gt["center"]
    if physical:
        track_poses = orbit_to_physical(poses)
        truth = np.concatenate([gt["center"], gt["yaw"][..., None], gt["size"]], axis=-1)
        gt_centers = orbit_to_physical(truth)[..., :3]
    trails = PoseTracker(dt=0.1).run_multi(track_poses, found)
    quality = track_quality_metrics(trails, gt_centers)
    boxes = score_multi_poses(poses, found, gt["center"], gt["yaw"], gt["size"], pose_frame="orbit")
    boxes = {k: None if isinstance(v, float) and np.isnan(v) else v for k, v in boxes.items()}
    return {
        "tracks": len(trails),
        "vehicles_tracked": f"{quality['vehicles_tracked']}/{quality['vehicles_total']}",
        "spurious_tracks": quality["spurious_tracks"],
        "id_switches": quality["id_switches"],
        "fragmentation": quality["fragmentation"],
        "track_coverage": quality["coverage"],
        "tracked_frames": len({f for trail in trails.values() for f, _ in trail}),
        **boxes,
    }


def oriented_tracking_eval(device: torch.device | str = "cuda", frames: int = 16,
                           n_points: int = 32768) -> dict:
    """Config 5's oriented row: two vehicles rendered as ellipses heading
    along their velocity (`synthesize_beam_tracking_sequence(oriented=
    True)`, numpy seed 88), decoded top-4 by the wide-yaw asset and
    tracked in the physical frame."""
    path = detector_asset_path("synthetic_detector_yaw.npz")
    model, dcfg, head = asset_model(path)
    fn = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head=head, device=device)
    pts, gt, valid = synthesize_beam_tracking_sequence(
        np.random.default_rng(88), frames, n_points, n_vehicles=2, oriented=True)
    p, fd = fn(torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device))
    row = _tracking_row(p.cpu().numpy(), fd.cpu().numpy(), gt, physical=True)
    return {"asset": os.path.basename(path), **row}


def config5_waymo_scale(
    device: torch.device | str = "cuda",
    batch: int = 16,
    n_points: int = 131072,
    n_beams: int = 64,
    n_sets: int = 4,
    reps: int = 3,
    track_frames: int = 16,
    track_points: int = 32768,
) -> dict:
    """Waymo-scale clouds (64 beams x 2,048 azimuths = 131,072 points)
    through the shipped asset's top-4 decode, timed as every config; then
    a coherent `track_frames`-frame sequence of two vehicles on
    constant-velocity paths (numpy seed 77) at the asset's training
    density, decoded top-4 and tracked on the host, with per-box scores;
    and the oriented row (`oriented_tracking_eval`)."""
    device = torch.device(device)
    model, dcfg, head = asset_model(detector_asset_path())
    fn = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head=head, device=device)
    dt, how = measure(fn, point_sets(n_sets, batch, n_points, device, n_beams), reps, device)
    # tracking quality at the detector's training density: denser clouds
    # quadruple the clutter and spawn clusters the asset never saw
    pts, gt, valid = synthesize_beam_tracking_sequence(
        np.random.default_rng(77), track_frames, track_points, n_vehicles=2)
    p, fd = fn(torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device))
    p, fd = p.cpu().numpy(), fd.cpu().numpy()
    return {
        "config": 5,
        "metric": f"Waymo-scale {n_points}-pt clouds + top-4 decode + tracking",
        "value": round(batch / dt, 1),
        "unit": "frames/s/chip",
        "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "detections": int(fd.sum()),
        **_tracking_row(p, fd, gt, physical=False),
        "device": _where(device),
        **how,
        "oriented": oriented_tracking_eval(device, track_frames, track_points),
    }


CONFIGS = {1: config1_single_frame, 2: config2_replay, 3: config3_fused, 4: config4_full_eval,
           5: config5_waymo_scale}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(card_line(), flush=True)
    for c in [int(x) for x in args.configs.split(",")]:
        log(f"running config {c} ...")
        print(json.dumps(CONFIGS[c](device=args.device)), flush=True)


if __name__ == "__main__":
    main()
