#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpufusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds both CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card, drives the lidar serving
path at full geometry (32 x 1801 range view, 32,768-point beam scans)
with the shipped detector asset through the entry points a user calls
(`LidarPipeline.predict_position`, `make_e2e_step`), holds its answer
against the committed JAX golden (tests/data/torch_port_golden.npz), and
times the path, each stage and each kernel with CUDA events.

Every phase asserts; a failure raises, so the exit code is non-zero and
the final line is never printed. Without a CUDA device it exits non-zero
at once. The last three lines are a JSON object with the per-kernel
results, the card's `name, power.limit` as nvidia-smi reports them, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 64  # frames per batch on the e2e path
N_POINTS = 32768  # points per frame
REQUESTS = 8  # single-frame requests the server answers
TIMED_BATCHES = 12  # distinct batches per timing
POSE_TOL = 1e-3  # card vs JAX-on-CPU golden (CUDA atan2f/sinf/cosf ulps)
HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "tpufusion", "assets", "synthetic_detector.npz")
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_golden.npz")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def time_pair(kernel, plain, inputs) -> tuple[float, float]:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain) on the same inputs; the mean of each pair."""
    p1 = time_ms(plain, inputs)
    k1 = time_ms(kernel, inputs)
    k2 = time_ms(kernel, inputs)
    p2 = time_ms(plain, inputs)
    return (k1 + k2) / 2, (p1 + p2) / 2


def wrapped_pose_diff(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| per element, yaw (column 3) as an angle: the
    reference's pi-symmetry tie-break may return yaw or yaw + 2 pi."""
    d = got.astype(np.float64) - want
    d[..., 3] = (d[..., 3] + np.pi) % (2 * np.pi) - np.pi
    return np.abs(d)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from tpufusion_torch import RangeViewSpec, _build
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import decode_batch_direct, heat_mask
    from tpufusion_torch.geometry.range_view import (
        _frame_pixels_keys,
        range_view_project_batch,
    )
    from tpufusion_torch.ops import cc, components, projection
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.serve.pipeline import LidarPipeline

    # -- phase 0: device ---------------------------------------------------
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0 device: {card} | {name} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"  cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}; "
        "setting both False: the FCN runs in float32, as its golden")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = RangeViewSpec()

    # -- phase 1: build ----------------------------------------------------
    lib_path = _build.library_path()
    if os.path.exists(lib_path):  # build from the sources, every run
        os.remove(lib_path)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    sources = [os.path.relpath(s, HERE) for s in _build._sources()]
    log(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS[:2])} (sm_90a) "
        f"{' '.join(sources)} -> {os.path.relpath(lib_path, HERE)} "
        f"in {build_s:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -- phase 2: z-buffer kernel vs its plain version ---------------------
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((4, 8192, 4)) * 20).astype(np.float32)
    pts[:, 4096:4608] = pts[:, :512]  # exact-key collision ties
    pts[0, 5] = np.nan
    valid = rng.random((4, 8192)) > 0.1
    scan_pts, scan_gt, scan_valid = synthesize_beam_scan_batch(
        np.random.default_rng(0), BATCH, N_POINTS
    )
    proj_err = 0.0
    for label, p, v in (("proj_check 4x8192", pts, valid),
                        (f"beam scans {BATCH}x{N_POINTS}", scan_pts, scan_valid)):
        args = _frame_pixels_keys(
            torch.from_numpy(p).to(dev), spec, torch.from_numpy(v).to(dev)
        )
        before = projection.LAUNCHES
        got = projection.nearest_wins_image(*args, spec)
        want = projection.nearest_wins_image_reference(*args, spec)
        torch.cuda.synchronize()
        assert projection.LAUNCHES == before + 1, "z-buffer kernel not launched"
        same = torch.equal(got, want)
        proj_err = max(proj_err, float((got - want).abs().max()))
        log(f"phase 2 z-buffer {label}: bit-identical to plain = {same}, "
            f"max |diff| = {proj_err}")
        assert same, f"z-buffer kernel differs from its plain version ({label})"

    # -- phase 3: CC kernel vs the plain sweeps ----------------------------
    pipe = LidarPipeline.from_asset(ASSET, dev)
    model, dcfg = pipe.model, pipe.cfg.decode
    crng = np.random.default_rng(7)
    synth = []
    for density in (0.0, 0.05, 0.4):
        m = crng.random((spec.height, spec.width)) < density
        m[10:20, 1700:] = True  # a blob across the azimuth seam
        m[10:20, :100] = True
        synth.append(m)
    with torch.inference_mode():
        scan_imgs = range_view_project_batch(
            torch.from_numpy(scan_pts).to(dev), spec,
            torch.from_numpy(scan_valid).to(dev),
        )
        heat = heat_mask(model(scan_imgs)[..., 1], dcfg)
    cc_err = 0
    for label, mask in (("densities 0/0.05/0.4 + seam blob",
                         torch.from_numpy(np.stack(synth)).to(dev)),
                        (f"asset heat masks x{BATCH}", heat)):
        before = cc.LAUNCHES
        got = cc.connected_components_with_bbox(mask, dcfg.max_cc_iters, dcfg.cc_impl)
        _, sweeps = components.propagate(components.init_state(mask), mask, 4096)
        want = components.connected_components_with_bbox(mask, 4096)
        torch.cuda.synchronize()
        assert cc.LAUNCHES == before + 1, "CC kernel not launched"
        assert int(sweeps.max()) < 4096, "plain sweeps did not converge"
        same = torch.equal(got[0], want[0]) and all(
            torch.equal(g[mask], w[mask]) for g, w in zip(got[1:], want[1:])
        )
        cc_err = max(cc_err, int((got[0] - want[0]).abs().max()), *(
            int((g[mask] - w[mask]).abs().max()) if mask.any() else 0
            for g, w in zip(got[1:], want[1:])
        ))
        sw = sweeps.tolist()
        log(f"phase 3 CC {label}: labels + foreground extents equal = {same}; "
            f"plain sweeps per frame: max {max(sw)}, mean {np.mean(sw):.1f}, "
            f"frames over the decode's cap {dcfg.max_cc_iters}: "
            f"{sum(s > dcfg.max_cc_iters for s in sw)}"
            + (f" ({sw})" if len(sw) <= 8 else ""))
        assert same, f"CC kernel differs from the plain sweeps ({label})"

    # -- phase 4: the main path --------------------------------------------
    step = make_e2e_step(model, spec, dcfg)
    req_pts, req_gt, req_valid = synthesize_beam_scan_batch(
        np.random.default_rng(1), REQUESTS, N_POINTS
    )
    requests = [req_pts[i][req_valid[i]] for i in range(REQUESTS)]
    projection.LAUNCHES = 0
    cc.LAUNCHES = 0
    answers = [pipe.predict_position(r) for r in requests]
    poses, found = step(scan_pts, scan_valid)
    torch.cuda.synchronize()
    launches = {"nearest_wins_image": projection.LAUNCHES,
                "connected_components_with_bbox": cc.LAUNCHES}
    log(f"phase 4 main path: {REQUESTS} server requests + one batch of "
        f"{BATCH}x{N_POINTS}; kernel launches {launches}")
    for k, n in launches.items():
        assert n > 0, f"the main path never launched {k}"
    poses_np, found_np = poses.cpu().numpy(), found.cpu().numpy()
    req_poses = np.stack([a[0] for a in answers])
    req_found = np.array([a[1] for a in answers])
    assert poses_np.shape == (BATCH, 7) and found_np.shape == (BATCH,)
    assert np.isfinite(poses_np).all() and np.isfinite(req_poses).all()
    xy = np.linalg.norm(poses_np[:, :2] - scan_gt["center"][:, :2], axis=1)[found_np]
    req_xy = np.linalg.norm(req_poses[:, :2] - req_gt["center"][:, :2], axis=1)[req_found]
    log(f"  batch: found {int(found_np.sum())}/{BATCH}, xy error median "
        f"{np.median(xy):.3f} m, max {xy.max():.3f} m; requests: found "
        f"{int(req_found.sum())}/{REQUESTS}, xy error median {np.median(req_xy):.3f} m")
    assert found_np.mean() >= 0.9 and req_found.mean() >= 0.75, "detector misses"
    assert np.median(xy) < 1.0, "poses far from the scenes' ground truth"

    with np.load(GOLDEN) as z:
        g_pts, g_valid, g_found, g_poses, g_sha = (
            z["points"], z["valid"], z["found"], z["poses"], z["image_sha256"])
    gp, gf = step(g_pts, g_valid)
    diff = wrapped_pose_diff(gp.cpu().numpy(), g_poses)
    with torch.inference_mode():
        g_imgs = range_view_project_batch(
            torch.from_numpy(g_pts).to(dev), spec, torch.from_numpy(g_valid).to(dev)
        ).cpu().numpy()
    same_img = sum(
        hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() == s
        for im, s in zip(g_imgs, g_sha)
    )
    log(f"  JAX golden ({len(g_found)} frames): found {gf.cpu().numpy().tolist()} "
        f"vs {g_found.tolist()}, largest pose difference {diff.max():.3e} "
        f"(tolerance {POSE_TOL}), images with JAX's sha256: {same_img}/{len(g_sha)}")
    assert np.array_equal(gf.cpu().numpy(), g_found), "found differs from JAX"
    assert diff.max() < POSE_TOL, "poses differ from JAX"

    # -- phase 5: times on the card ----------------------------------------
    batches = []
    for i in range(TIMED_BATCHES):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(100 + i), BATCH, N_POINTS)
        batches.append((torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)))
    torch.cuda.reset_peak_memory_stats()
    e2e_ms = time_ms(lambda pv: step(*pv), batches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    with torch.inference_mode():
        images = [range_view_project_batch(p, spec, v) for p, v in batches]
        preds = [model(im) for im in images]
        masks = [heat_mask(pr[..., 1], dcfg) for pr in preds]
        zargs = [_frame_pixels_keys(p, spec, v) for p, v in batches]
        proj_ms = time_ms(lambda pv: range_view_project_batch(pv[0], spec, pv[1]), batches)
        fcn_ms = time_ms(model, images)
        dec_ms = time_ms(lambda ip: decode_batch_direct(ip[1], ip[0], spec, dcfg),
                         list(zip(images, preds)))
        k1_ms, k1_plain = time_pair(
            lambda a: projection.nearest_wins_image(*a, spec),
            lambda a: projection.nearest_wins_image_reference(*a, spec), zargs)
        k2_ms, k2_plain = time_pair(
            lambda m: cc.connected_components_with_bbox(m, dcfg.max_cc_iters),
            lambda m: components.connected_components_with_bbox(m, dcfg.max_cc_iters),
            masks)
    for r in requests[:3]:
        pipe.predict_position(r)  # warm-up
    lat = []
    for r in requests * 13:  # 104 samples: >= 10 beyond the p90
        t0 = time.perf_counter()
        pipe.predict_position(r)  # returns host numpy: the request is done
        lat.append((time.perf_counter() - t0) * 1e3)
    where = f"[{card}]"
    log(f"phase 5 times, CUDA events, mean over {TIMED_BATCHES} distinct "
        f"batches of {BATCH}x{N_POINTS} after warm-up {where}")
    log(f"  e2e: {e2e_ms:.3f} ms/batch = {BATCH * 1e3 / e2e_ms:.1f} frames/s; "
        f"peak device memory {peak_mb:.0f} MiB {where}")
    log(f"  stages: projection {proj_ms:.3f} ms, FCN {fcn_ms:.3f} ms, decode "
        f"{dec_ms:.3f} ms (CC inside the decode {k2_ms:.3f} ms) {where}")
    log(f"  z-buffer kernel {k1_ms:.4f} ms vs plain {k1_plain:.4f} ms; "
        f"CC kernel {k2_ms:.4f} ms vs plain {k2_plain:.4f} ms {where}")
    log(f"  single-frame request (host clock, {len(lat)} requests): p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms {where}")

    kernels = [
        {"name": "nearest_wins_image", "route": "cuda",
         "source": "tpufusion_torch/csrc/nearest_wins.cu",
         "replaces": "tpufusion/ops/pallas_projection.py:146",
         "launches": launches["nearest_wins_image"], "max_abs_err": proj_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "connected_components_with_bbox", "route": "cuda",
         "source": "tpufusion_torch/csrc/components.cu",
         "replaces": "tpufusion/ops/pallas_cc.py:102",
         "launches": launches["connected_components_with_bbox"],
         "max_abs_err": cc_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
