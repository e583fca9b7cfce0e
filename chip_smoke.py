#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpufusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It builds both CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card (phases 2-3: real inputs
and the adversarial ones of `tpufusion_torch/ops/parity_inputs.py`, which
aim at the CC's strip borders and the z-buffer's cluster), and drives the
lidar detector's serving paths at full geometry (32 x 1801 range view) through
the entry points a user calls, each with the kernels' launch counts set
to 0 before it and read after it:

  phases 4-5   the float32 direct path with the shipped detector asset
               (`LidarPipeline.predict_position`, `make_e2e_step`,
               batch 64 x 32,768-point beam scans)
  phase 6      the asset's FCN in bf16 against JAX's bf16 FCN and
               against float32
  phase 7      config 5: bf16, top-4, batch 16 x 131,072 points (64
               beams), and a 16-frame two-vehicle sequence through
               `PoseTracker.run_multi`
  phase 8      the corner decode (`decode_batch`, `decode_batch_multi`,
               with the process's float32 matmuls set to TF32),
               a corner head end to end, and bench.py's corner row (bf16,
               batch 64 x 32,768)
  phase 9      the mixed-family and wide-yaw assets, top-4
  phase 10     times of config 5, the corner row, the bf16 FCN, both
               kernels at 131,072 points per frame, the tracker

Every answer is held against the committed JAX goldens
(tests/data/torch_port_golden.npz, tests/data/torch_port_golden_multi.npz);
times are CUDA events over distinct inputs, and for the kernels also
device time (the kernels' own durations, torch.profiler).

Every phase asserts; a failure raises, so the exit code is non-zero and
the final line is never printed. Without a CUDA device it exits non-zero
at once. The last three lines are a JSON object with the per-kernel
results (launches on the driven paths, largest difference from the plain
version, and at 64 x 32,768 the kernel's, the plain version's and the
library yardstick's device time in turns, and the kernel's time a call,
beside the kernel's bound: its bytes at 3.35 TB/s,
`tpufusion_torch/kernel_bench.py`), the card's
`name, power.limit` as nvidia-smi reports them, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tpufusion_torch.kernel_bench import (
    cc_bound_ms,
    device_ms,
    scatter_amin_yardstick,
    time_ms,
    time_turns,
    zbuffer_bound_ms,
)

BATCH = 64  # frames per batch on the e2e path and the corner row
N_POINTS = 32768  # points per frame
REQUESTS = 8  # single-frame requests the server answers
TIMED_BATCHES = 12  # distinct batches per timing
C5_BATCH = 16  # config 5: frames per batch
C5_POINTS = 131072  # config 5: points per frame (64 beams x 2,048 azimuths)
C5_BEAMS = 64
C5_TIMED = 6  # config 5: distinct batches per timing
TRACK_FRAMES = 16  # config 5's tracking sequence (two vehicles, 32,768 points)
SWEEP_CAP = 16384  # plain CC sweeps: the serpentines need ~9,000 to converge
# card vs JAX-on-CPU golden (CUDA atan2f/sinf/cosf ulps), poses from the
# bf16 FCN included: they read 3.8e-6 on an H100, and rounding each bf16
# convolution once instead of twice (a fault) moves them 3.7e-3
POSE_TOL = 1e-3
HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "tpufusion", "assets")
ASSET = os.path.join(ASSETS, "synthetic_detector.npz")
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_golden.npz")
GOLDEN_MULTI = os.path.join(HERE, "tests", "data", "torch_port_golden_multi.npz")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def drive(label: str, fn, totals: dict[str, int]):
    """Runs one serving path with both kernels' launch counts set to 0,
    asserts that it launched each, and adds its counts to `totals`."""
    from tpufusion_torch.ops import cc, projection

    projection.LAUNCHES = 0
    cc.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {"nearest_wins_image": projection.LAUNCHES,
              "connected_components_with_bbox": cc.LAUNCHES}
    log(f"  {label}: kernel launches {counts}")
    for k, n in counts.items():
        assert n > 0, f"{label} never launched {k}"
        totals[k] += n
    return out


def check_poses(label: str, poses, found, want_poses, want_found) -> float:
    """Asserts `found` equals the golden's and the poses are within POSE_TOL
    (yaw as an angle); returns the largest difference."""
    from tpufusion_torch._golden import wrapped_pose_diff

    got_f = found.cpu().numpy()
    diff = float(wrapped_pose_diff(poses, want_poses).max())
    log(f"  {label}: found {got_f.astype(int).tolist()} (JAX "
        f"{want_found.astype(int).tolist()}), largest pose difference "
        f"{diff:.3e} (tolerance {POSE_TOL:.3e})")
    assert np.array_equal(got_f, want_found), f"{label}: found differs from JAX"
    assert diff < POSE_TOL, f"{label}: poses differ from JAX"
    return diff


def asset_fcn(path: str, dtype: str, dev):
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import asset_configs, load_state_npz

    mcfg, dcfg = asset_configs(path)
    model = FCN(dataclasses.replace(mcfg, dtype=dtype))
    load_state_npz(path, model)
    return model.to(dev).eval(), dcfg


def phase_bf16(dev, spec, g, gm):
    """Phase 6: the asset's FCN in bf16 against JAX's bf16 FCN (the
    golden's sample, on its three two-vehicle frames) and against the
    float32 FCN on all five golden frames. Returns ({dtype: model}, the
    asset's DecodeConfig)."""
    from tpufusion_torch._golden import (
        BF16_PROB_ATOL,
        BF16_REG_ATOL,
        BF16_REG_DIFFER_SHARE,
        bf16_fcn_readings,
    )
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.predict import make_e2e_step

    models = {}
    for dt in ("float32", "bfloat16"):
        models[dt], dcfg = asset_fcn(ASSET, dt, dev)
    pts = np.concatenate([g["points"], gm["multi_points"]])
    valid = np.concatenate([g["valid"], gm["multi_valid"]])
    conv_dtypes = []
    hook = models["bfloat16"].conv1.register_forward_hook(
        lambda m, i, o: conv_dtypes.append(o.dtype))
    with torch.inference_mode():
        images = range_view_project_batch(
            torch.from_numpy(pts).to(dev), spec, torch.from_numpy(valid).to(dev))
        out32 = models["float32"](images)
        out16 = models["bfloat16"](images)
    hook.remove()
    assert conv_dtypes == [torch.bfloat16], f"the bf16 FCN's conv1 returned {conv_dtypes}"
    assert out16.dtype == torch.float32 and out16.shape == out32.shape
    dp = float((out16[..., :2] - out32[..., :2]).abs().max())
    dr = float((out16[..., 2:] - out32[..., 2:]).abs().max())
    found = {dt: make_e2e_step(m, spec, dcfg)(pts, valid)[1].cpu().numpy()
             for dt, m in models.items()}
    log(f"phase 6 bf16 FCN ({len(pts)} golden frames): conv1 output dtype "
        f"{conv_dtypes[0]}; bf16 vs float32 largest difference: probability "
        f"{dp:.4e}, regression {dr:.4e}; found float32 "
        f"{found['float32'].astype(int).tolist()}, bf16 {found['bfloat16'].astype(int).tolist()}")
    assert np.isfinite(out16.cpu().numpy()).all()
    assert np.array_equal(found["float32"], found["bfloat16"]), "bf16 flips found"
    jp, jr, n_diff, n = bf16_fcn_readings(
        out16[len(g["points"]):].cpu().numpy(), gm["bf16_fcn_prob"], gm["bf16_fcn_reg"])
    log(f"  bf16 FCN vs JAX's bf16 FCN (3 two-vehicle frames): probability "
        f"{jp:.4e} (tolerance {BF16_PROB_ATOL:.4e}), sampled regression "
        f"{jr:.4e} (tolerance {BF16_REG_ATOL:.4e}), {n_diff} of {n} sampled "
        f"regression outputs differ (at most {BF16_REG_DIFFER_SHARE:.0%})")
    assert jp <= BF16_PROB_ATOL and jr <= BF16_REG_ATOL, "bf16 FCN differs from JAX's"
    assert n_diff <= BF16_REG_DIFFER_SHARE * n, "bf16 FCN rounds unlike JAX's"
    return models, dcfg


def phase_config5(dev, spec, gm, models, dcfg, totals):
    """Phase 7: config 5 (bf16, top-4, 16 x 131,072 points at 64 beams,
    then the tracker on a 16-frame two-vehicle sequence). Returns the
    step and the sequence's (poses, found) on the host."""
    from tpufusion_torch.eval.scoring import score_multi_poses
    from tpufusion_torch.data.synthetic import (
        synthesize_beam_scan_batch,
        synthesize_beam_tracking_sequence,
    )
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.serve.tracker import PoseTracker, track_quality_metrics

    step = make_e2e_step(models["bfloat16"], spec, dcfg, max_obstacles=4)
    pts, gt, valid = synthesize_beam_scan_batch(
        np.random.default_rng(500), C5_BATCH, C5_POINTS, n_beams=C5_BEAMS)
    seq, sgt, svalid = synthesize_beam_tracking_sequence(
        np.random.default_rng(77), TRACK_FRAMES, N_POINTS, n_vehicles=2)

    def path():
        poses, found = step(pts, valid)
        sp, sf = step(seq, svalid)
        sp, sf = sp.cpu().numpy(), sf.cpu().numpy()
        return poses, found, sp, sf, PoseTracker(dt=0.1).run_multi(sp, sf)

    log(f"phase 7 config 5: bf16 FCN, top-4, {C5_BATCH} x {C5_POINTS} points "
        f"({C5_BEAMS} beams), then {TRACK_FRAMES} frames x {N_POINTS} points "
        "of two vehicles through PoseTracker.run_multi")
    poses, found, sp, sf, trails = drive("config 5", path, totals)
    poses, found = poses.cpu().numpy(), found.cpu().numpy()
    assert poses.shape == (C5_BATCH, 4, 7) and found.shape == (C5_BATCH, 4)
    assert np.isfinite(poses).all() and np.isfinite(sp).all()
    xy = np.linalg.norm(poses[:, 0, :2] - gt["center"][:, :2], axis=1)[found[:, 0]]
    quality = track_quality_metrics(trails, sgt["center"])
    scores = score_multi_poses(sp, sf, sgt["center"], sgt["yaw"], sgt["size"],
                               pose_frame="orbit")
    log(f"  131,072-point batch: largest cluster found {int(found[:, 0].sum())}/"
        f"{C5_BATCH}, xy error median {np.median(xy):.3f} m; detections per "
        f"frame {found.sum(axis=1).tolist()}")
    log(f"  tracking: {len(trails)} confirmed tracks; track_quality_metrics {quality}")
    log(f"  score_multi_poses {scores}")
    assert found[:, 0].mean() >= 0.75 and np.median(xy) < 1.0, "config 5 misses"
    assert len(trails) >= 1, "no confirmed track"
    for tag, model in (("bf16", models["bfloat16"]), ("f32", models["float32"])):
        gp, gf = make_e2e_step(model, spec, dcfg, max_obstacles=4)(
            gm["multi_points"], gm["multi_valid"])
        check_poses(f"JAX golden, top-4 {tag} (3 two-vehicle frames)", gp, gf,
                    gm[f"direct_{tag}_poses"], gm[f"direct_{tag}_found"])
    return step, sp, sf


def phase_corner(dev, spec, gm, batches, totals):
    """Phase 8: the corner decode on the golden's label-encoded outputs,
    a corner head end to end, bench.py's corner row. Returns the corner
    row's step and its FCN."""
    from tpufusion_torch import DecodeConfig, ModelConfig
    from tpufusion_torch._golden import load_npz
    from tpufusion_torch.decode.decode import decode_batch, decode_batch_multi
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.io import asset_configs, fcn_from_arrays
    from tpufusion_torch.predict import make_e2e_step

    with torch.inference_mode():
        images = range_view_project_batch(
            torch.from_numpy(gm["multi_points"][:2]).to(dev), spec,
            torch.from_numpy(gm["multi_valid"][:2]).to(dev))
        y = torch.from_numpy(gm["corner_ypred"]).to(dev)
        # the process's float32 matmuls in TF32: the decode pins full
        # float32 for its own and must not change them
        torch.set_float32_matmul_precision("high")
        log("phase 8 corner decode on label-encoded corner outputs "
            "(2 two-vehicle frames), float32 matmul precision 'high' (TF32)")
        for case, cfg in (("corner", DecodeConfig()),
                          ("corner_k64", DecodeConfig(max_candidates=64))):
            out = decode_batch(y, images, spec, cfg)
            check_poses(f"decode_batch, max_candidates {cfg.max_candidates}",
                        out["pose"], out["found"], gm[f"{case}_poses"],
                        gm[f"{case}_found"])
            over = out["vote_overflow"].cpu().numpy()
            log(f"    vote_overflow {over.tolist()} (JAX {gm[f'{case}_overflow'].tolist()})")
            assert np.array_equal(over, gm[f"{case}_overflow"]), "vote_overflow differs"
        out = decode_batch_multi(y, images, spec, DecodeConfig(), 4)
        check_poses("decode_batch_multi k=4", out["poses"], out["found"],
                    gm["corner_multi_poses"], gm["corner_multi_found"])
        over = out["vote_overflow"].cpu().numpy()
        assert np.array_equal(over, gm["corner_multi_overflow"]), "vote_overflow differs"
        assert torch.get_float32_matmul_precision() == "high"
        torch.set_float32_matmul_precision("highest")

    mcfg, dcfg = asset_configs(ASSET)
    hcfg = dataclasses.replace(mcfg, head="corner")
    harrays = {k: v for k, v in load_npz(ASSET).items()
               if not k.startswith(("deconv5b/", "deconv6b/"))}
    for name in ("deconv5b", "deconv6b"):
        harrays[f"{name}/kernel"] = gm[f"hybrid/{name}/kernel"]
        harrays[f"{name}/bias"] = np.zeros(hcfg.num_corner_outputs, np.float32)
    for tag, dtype, k in (("k1", "float32", 1), ("k4", "float32", 4),
                          ("bf16_k4", "bfloat16", 4)):
        model = fcn_from_arrays(harrays, dataclasses.replace(hcfg, dtype=dtype)).to(dev)
        hp, hf = make_e2e_step(model, spec, dcfg, max_obstacles=k, head="corner")(
            gm["multi_points"], gm["multi_valid"])
        check_poses(f"corner head on the asset's trunk, e2e {tag}", hp, hf,
                    gm[f"hybrid_{tag}_poses"], gm[f"hybrid_{tag}_found"])

    barrays = {k.split("/", 1)[1]: v for k, v in gm.items() if k.startswith("bench_corner/")}
    cmodel = fcn_from_arrays(
        barrays, dataclasses.replace(ModelConfig(), dtype="bfloat16")).to(dev)
    cstep = make_e2e_step(cmodel, spec, DecodeConfig(), head="corner")
    bp, bf = cstep(gm["multi_points"], gm["multi_valid"])
    check_poses("bench.py corner row FCN (bf16, seeded init), 3 golden frames",
                bp, bf, gm["bench_corner_poses"], gm["bench_corner_found"])
    cp, cf = drive(f"corner row, batch {len(batches[0][0])} x {N_POINTS}",
                   lambda: cstep(*batches[0]), totals)
    assert cp.shape == (len(batches[0][0]), 7) and torch.isfinite(cp).all()
    return cstep, cmodel


def phase_assets(dev, spec, gm):
    """Phase 9: the mixed-family asset (auto yaw and fit gates) and the
    wide-yaw asset, top-4, float32, on the golden's circle and ellipse
    frames."""
    from tpufusion_torch.predict import make_e2e_step

    pts = np.concatenate([gm["multi_points"], gm["ell_points"]])
    valid = np.concatenate([gm["multi_valid"], gm["ell_valid"]])
    log("phase 9 other assets, top-4, float32 (3 two-vehicle + 2 ellipse frames)")
    for tag, name in (("mixed", "synthetic_detector_mixed.npz"),
                      ("yaw", "synthetic_detector_yaw.npz")):
        model, dcfg = asset_fcn(os.path.join(ASSETS, name), "float32", dev)
        poses, found = make_e2e_step(model, spec, dcfg, max_obstacles=4)(pts, valid)
        check_poses(f"{name} (yaw {dcfg.direct_yaw_frame}, fit {dcfg.fit_boundary})",
                    poses, found, gm[f"{tag}_poses"], gm[f"{tag}_found"])


def kernel_turns(spec, zargs, masks, dcfg) -> dict:
    """Both kernels timed in turns with their plain versions (and the
    z-buffer with its library yardstick, `scatter_reduce_` "amin" into a
    filled grid) on distinct inputs, as device time (the kernels' own
    durations) and as time a call (CUDA events, the host's launch work
    included), beside their bounds from the same inputs:
    {"z": {...}, "cc": {...}}, times in ms, "<fn>_call" for a call's."""
    from tpufusion_torch.ops import cc, components, projection

    p = spec.height * spec.width
    yard = [scatter_amin_yardstick(*a[:3], p) for a in zargs]
    zfns = {
        "kernel": lambda i: projection.nearest_wins_image(*zargs[i], spec),
        "plain": lambda i: projection.nearest_wins_image_reference(*zargs[i], spec),
        "library": lambda i: yard[i](),
    }
    cfns = {
        "kernel": lambda m: cc.connected_components_with_bbox(m, dcfg.max_cc_iters),
        "plain": lambda m: components.connected_components_with_bbox(m, dcfg.max_cc_iters),
    }
    out = {}
    for name, fns, inputs in (("z", zfns, list(range(len(zargs)))), ("cc", cfns, masks)):
        out[name] = time_turns(fns, inputs, device_ms)
        out[name].update({f"{k}_call": v for k, v in time_turns(fns, inputs).items()})
    out["z"]["bound"] = float(np.mean([zbuffer_bound_ms(*a[:3], p) for a in zargs]))
    out["cc"]["bound"] = float(np.mean([cc_bound_ms(m) for m in masks]))
    return out


def turns_line(t: dict) -> str:
    z, c = t["z"], t["cc"]
    return (f"device time (a call): z-buffer kernel {z['kernel']:.4f} ({z['kernel_call']:.4f}) "
            f"ms, plain {z['plain']:.4f} ({z['plain_call']:.4f}) ms, library scatter_reduce_ "
            f"{z['library']:.4f} ({z['library_call']:.4f}) ms, bound {z['bound']:.4f} ms, "
            f"kernel at {z['bound'] / z['kernel']:.1%} of it; CC kernel {c['kernel']:.4f} "
            f"({c['kernel_call']:.4f}) ms, plain {c['plain']:.4f} ({c['plain_call']:.4f}) ms, "
            f"bound {c['bound']:.4f} ms, kernel at {c['bound'] / c['kernel']:.1%} of it")


def phase_times(dev, spec, models, dcfg, c5_step, cstep, cmodel, seq, batches,
                images64, card):
    """Phase 10: times on the card, CUDA events over distinct inputs."""
    from tpufusion_torch import DecodeConfig
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import (
        decode_batch_direct,
        decode_batch_multi,
        heat_mask,
    )
    from tpufusion_torch.geometry.range_view import (
        _frame_pixels_keys,
        range_view_project_batch,
    )
    from tpufusion_torch.ops import cc, components, projection
    from tpufusion_torch.serve.tracker import PoseTracker

    where = f"[{card}]"
    sets = []
    for i in range(C5_TIMED):
        p, _, v = synthesize_beam_scan_batch(
            np.random.default_rng(600 + i), C5_BATCH, C5_POINTS, n_beams=C5_BEAMS)
        sets.append((torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c5_ms = time_ms(lambda pv: c5_step(*pv), sets)
    c5_peak = torch.cuda.max_memory_allocated() / 2**20
    with torch.inference_mode():
        c5_images = [range_view_project_batch(p, spec, v) for p, v in sets]
        c5_preds = [models["bfloat16"](im) for im in c5_images]
        masks = [heat_mask(pr[..., 1], dcfg) for pr in c5_preds]
        zargs = [_frame_pixels_keys(p, spec, v) for p, v in sets]
        proj_ms = time_ms(lambda pv: range_view_project_batch(pv[0], spec, pv[1]), sets)
        dec_ms = time_ms(lambda ip: decode_batch_direct(ip[1], ip[0], spec, dcfg, 4),
                         list(zip(c5_images, c5_preds)))
        fcn = {}
        for label, imgs in (("c5", c5_images), ("64", images64)):
            for dt in ("float32", "bfloat16", "bfloat16", "float32"):  # in turns
                fcn.setdefault((label, dt), []).append(time_ms(models[dt], imgs))
        fcn = {k: sum(v) / len(v) for k, v in fcn.items()}
        # both kernels against their plain versions at config 5's shapes
        z_same = torch.equal(projection.nearest_wins_image(*zargs[0], spec),
                             projection.nearest_wins_image_reference(*zargs[0], spec))
        got = cc.connected_components_with_bbox(masks[0], dcfg.max_cc_iters)
        want = components.connected_components_with_bbox(masks[0], 4096)
        fg = masks[0]
        cc_same = torch.equal(got[0], want[0]) and all(
            torch.equal(a[fg], b[fg]) for a, b in zip(got[1:], want[1:]))
        log(f"phase 10 parity at {C5_POINTS} points per frame: z-buffer "
            f"bit-identical {z_same}; CC labels + extents equal {cc_same}")
        assert z_same and cc_same, "a kernel differs from its plain version"
        zt = kernel_turns(spec, zargs, masks, dcfg)
        torch.cuda.reset_peak_memory_stats()
        corner_ms = time_ms(lambda pv: cstep(*pv), batches)
        corner_peak = torch.cuda.max_memory_allocated() / 2**20
        cpred = cmodel(images64[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**20
        decode_batch_multi(cpred, images64[0], spec, DecodeConfig(), 4)
        torch.cuda.synchronize()
        multi_peak = torch.cuda.max_memory_allocated() / 2**20 - base
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        PoseTracker(dt=0.1).run_multi(*seq)
    track_ms = (time.perf_counter() - t0) * 1e3 / (reps * len(seq[0]))

    b64 = len(batches[0][0])
    log(f"  times, CUDA events, mean over distinct batches after warm-up {where}")
    log(f"  config 5 (bf16, top-4, {C5_BATCH} x {C5_POINTS}, {C5_TIMED} batches): "
        f"{c5_ms:.3f} ms/batch = {C5_BATCH * 1e3 / c5_ms:.1f} frames/s; stages: "
        f"projection {proj_ms:.3f} ms, bf16 FCN {fcn[('c5', 'bfloat16')]:.3f} ms, "
        f"top-4 decode {dec_ms:.3f} ms; peak device memory {c5_peak:.0f} MiB {where}")
    log(f"  corner row (bf16 corner FCN + corner vote, {b64} x {N_POINTS}, "
        f"{len(batches)} batches): {corner_ms:.3f} ms/batch = "
        f"{b64 * 1e3 / corner_ms:.1f} frames/s; peak device memory "
        f"{corner_peak:.0f} MiB; decode_batch_multi k=4 at batch {b64} needs "
        f"{multi_peak:.0f} MiB above its inputs {where}")
    log(f"  FCN float32 vs bf16: {b64} x 32 x 1801 {fcn[('64', 'float32')]:.3f} vs "
        f"{fcn[('64', 'bfloat16')]:.3f} ms; {C5_BATCH} x 32 x 1801 (131,072-point "
        f"frames) {fcn[('c5', 'float32')]:.3f} vs {fcn[('c5', 'bfloat16')]:.3f} ms {where}")
    log(f"  at {C5_POINTS} points per frame ({C5_BATCH} frames): {turns_line(zt)} {where}")
    log(f"  tracker (host, PoseTracker.run_multi, {len(seq[0])} frames x top-4, "
        f"{reps} runs): {track_ms:.4f} ms/frame")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from tpufusion_torch import RangeViewSpec, _build
    from tpufusion_torch._golden import load_npz, wrapped_pose_diff
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import decode_batch_direct, heat_mask
    from tpufusion_torch.geometry.range_view import (
        _frame_pixels_keys,
        range_view_project_batch,
    )
    from tpufusion_torch.ops import cc, components, parity_inputs, projection
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
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}; "
        "setting False / 'highest': the FCN runs in float32, as its golden")
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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
    for b, n, kinds in parity_inputs.ZBUFFER_SHAPES:
        args = [torch.from_numpy(a).to(dev) for a in parity_inputs.zbuffer_args(
            b, n, spec.height * spec.width, kinds=kinds)]
        got = projection.nearest_wins_image(*args, spec)
        want = projection.nearest_wins_image_reference(*args, spec)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        proj_err = max(proj_err, float((got - want).abs().max()))
        log(f"phase 2 z-buffer adversarial {b}x{n} ({', '.join(kinds)}): "
            f"bit-identical to plain = {same}")
        assert same, f"z-buffer kernel differs from its plain version ({b}x{n} {kinds})"

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
    cases = [("densities 0/0.05/0.4 + seam blob", torch.from_numpy(np.stack(synth)).to(dev)),
             (f"asset heat masks x{BATCH}", heat)] + [
        (f"adversarial x{b} ({', '.join(parity_inputs.cc_frames()) if b > 1 else 'serpentine'})",
         torch.from_numpy(parity_inputs.cc_batch(b)).to(dev))
        for b in parity_inputs.CC_BATCHES]
    for label, mask in cases:
        before = cc.LAUNCHES
        got = cc.connected_components_with_bbox(mask, dcfg.max_cc_iters, dcfg.cc_impl)
        _, sweeps = components.propagate(components.init_state(mask), mask, SWEEP_CAP)
        want = components.connected_components_with_bbox(mask, SWEEP_CAP)
        torch.cuda.synchronize()
        assert cc.LAUNCHES == before + 1, "CC kernel not launched"
        assert int(sweeps.max()) < SWEEP_CAP, "plain sweeps did not converge"
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
        kt = kernel_turns(spec, zargs, masks, dcfg)
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
        f"{dec_ms:.3f} ms (CC inside the decode {kt['cc']['kernel_call']:.3f} ms a call) {where}")
    log(f"  {turns_line(kt)} {where}")
    log(f"  single-frame request (host clock, {len(lat)} requests): p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms {where}")

    # -- phases 6-10: the rest of the serving path -------------------------
    totals = dict(launches)  # launches over every path the script drives
    g, gm = load_npz(GOLDEN), load_npz(GOLDEN_MULTI)
    models, adcfg = phase_bf16(dev, spec, g, gm)
    c5_step, seq_poses, seq_found = phase_config5(dev, spec, gm, models, adcfg, totals)
    cstep, cmodel = phase_corner(dev, spec, gm, batches, totals)
    phase_assets(dev, spec, gm)
    phase_times(dev, spec, models, adcfg, c5_step, cstep, cmodel,
                (seq_poses, seq_found), batches, images, card)

    z, c = kt["z"], kt["cc"]
    kernels = [
        {"name": "nearest_wins_image", "route": "cuda",
         "source": "tpufusion_torch/csrc/nearest_wins.cu",
         "replaces": "tpufusion/ops/pallas_projection.py:146",
         "launches": totals["nearest_wins_image"], "max_abs_err": proj_err,
         "ms": z["kernel"], "plain_ms": z["plain"], "bound_ms": z["bound"],
         "bound_by": "bytes", "library_ms": z["library"], "call_ms": z["kernel_call"]},
        {"name": "connected_components_with_bbox", "route": "cuda",
         "source": "tpufusion_torch/csrc/components.cu",
         "replaces": "tpufusion/ops/pallas_cc.py:102",
         "launches": totals["connected_components_with_bbox"],
         "max_abs_err": cc_err, "ms": c["kernel"], "plain_ms": c["plain"],
         "bound_ms": c["bound"], "bound_by": "bytes", "library_ms": None,
         "call_ms": c["kernel_call"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
