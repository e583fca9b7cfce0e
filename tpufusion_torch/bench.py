"""End-to-end benchmark on the card (counterpart of the repo-root
`bench.py`): lidar frames/s of the fused range-view projection + FCN +
pose decode step, `predict.make_e2e_step`.

Rows, each over the same `n_sets` distinct beam-scan batches (numpy seeds
0, 1, ...; `benchmarks.point_sets`), timed between CUDA events after a
warm-up call (`benchmarks.measure`):
  headline  the flagship geometry (`entry.FLAGSHIP`: direct head, width
            2, linear regression) in bf16, kernels drawn from seed 0 and
            the deconv6a bias [2, -2] of a trained net's sparsity
            (`benchmarks.seeded_fcn`), decoded at `DEFAULT.decode`; with
            the step's device ms, busy share and peak memory. The port's
            seed-0 kernels are not JAX's for the same seed, so the
            first batch's found count and share of heat pixels at or
            above min_prob go to stderr beside it.
  live      the shipped detector asset `synthetic_detector.npz` at its
            json's decode and head (`benchmarks.asset_model`); frames
            with detections cost the decode more than empty ones. A
            missing or broken asset raises: the reference's quick-training
            fall-back is not copied.
  corner    the default ModelConfig (the corner head) in bf16 from seed
            0 with the same bias, through the corner-vote decode (passed
            explicitly: the port's make_e2e_step defaults to "direct")
  p50       the headline step on one frame: 12 one-frame slices after a
            warm-up slice, host clock, a readback a call

Left out: the reference's `packed` row (a TPU-only projection; the
port's `geometry/range_view.py` raises for it) and `vs_baseline`, the
ratio to a TPU target: no TPU figure is the port's baseline.

Run: python -m tpufusion_torch.bench [--device cuda] [--batch 64]
[--points 32768] [--sets 24] — one JSON line on stdout, the details (the
card's name and power limit first) on stderr. It runs on the card unless
asked for the CPU; without a card the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from tpufusion_torch.benchmarks import (
    CFG,
    SPEC,
    asset_model,
    card_line,
    detector_asset_path,
    log,
    measure,
    point_sets,
    seeded_fcn,
)
from tpufusion_torch.config import ModelConfig
from tpufusion_torch.decode.decode import heat_mask
from tpufusion_torch.entry import FLAGSHIP
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.predict import make_e2e_step

BATCH = 64
N_POINTS = 32768  # 32 beams x 1024 azimuth steps, ~ an HDL-32E revolution
N_SETS = 24
LATENCY_CALLS = 12
NEAR_PROB = 1e-4


def heat_readings(model, points, valid, dcfg, spec=SPEC) -> tuple[float, int]:
    """What `model` makes of one batch: (the share of its heat-mask pixels,
    the foreground probabilities within NEAR_PROB of min_prob, which a
    last-bit difference from the reference could flip)."""
    with torch.inference_mode():
        prob = model(range_view_project_batch(points, spec, valid))[..., 1]
        near = int(((prob - dcfg.min_prob).abs() < NEAR_PROB).sum())
        return float(heat_mask(prob, dcfg).float().mean()), near


def _p50_latency_ms(step, sets, batch: int) -> float:
    """Median ms of a one-frame call with its readback (host clock), over
    LATENCY_CALLS slices after a warm-up on a slice the loop never uses."""
    ones = []
    for i in range(LATENCY_CALLS + 1):
        p, v = sets[i % len(sets)]
        ones.append((p[i % batch : i % batch + 1], v[i % batch : i % batch + 1]))
    step(*ones[LATENCY_CALLS])[0].cpu()
    lats = []
    for p, v in ones[:LATENCY_CALLS]:
        t0 = time.perf_counter()
        step(p, v)[0].cpu()
        lats.append(time.perf_counter() - t0)
    return float(np.percentile(lats, 50) * 1e3)


def run(device: torch.device | str = "cuda", batch: int = BATCH, n_points: int = N_POINTS,
        n_sets: int = N_SETS) -> dict:
    """The four rows on `device` -> the JSON line's dict."""
    device = torch.device(device)
    torch.empty(0, device=device)  # without a card, raise here
    where = card_line() if device.type == "cuda" else "cpu"
    log(f"device: {where}")
    sets = point_sets(n_sets, batch, n_points, device)

    model = seeded_fcn(dataclasses.replace(CFG.model, **FLAGSHIP), 0, device)
    step = make_e2e_step(model, SPEC, CFG.decode, head="direct", device=device)
    found = int(step(*sets[0])[1].sum())
    share, near = heat_readings(model, *sets[0], CFG.decode)
    dt, how = measure(step, sets, 1, device)
    fps = batch / dt
    log(f"headline (bf16 flagship, seed 0): {fps:.1f} frames/s ({dt * 1e3:.3f} ms/batch of "
        f"{batch}); {how}; first batch: found {found}/{batch}, heat pixels >= min_prob "
        f"{CFG.decode.min_prob}: {share:.4%}, probabilities within {NEAR_PROB:g} of it: {near}")

    amodel, adcfg, ahead = asset_model(detector_asset_path())
    live = make_e2e_step(amodel, SPEC, adcfg, head=ahead, device=device)
    det = int(live(*sets[0])[1].sum())
    live_dt, live_how = measure(live, sets, 1, device)
    log(f"with live detections, shipped asset ({det}/{batch} frames, min_prob "
        f"{adcfg.min_prob}, head {ahead}): {batch / live_dt:.1f} frames/s; {live_how}")

    cmodel = seeded_fcn(ModelConfig(), 0, device)
    corner = make_e2e_step(cmodel, SPEC, CFG.decode, head="corner", device=device)
    corner_dt, corner_how = measure(corner, sets, 1, device)
    log(f"corner-vote parity decode: {batch / corner_dt:.1f} frames/s; {corner_how}")

    p50 = _p50_latency_ms(step, sets, batch)
    log(f"single-frame p50 latency (host clock, a readback a call): {p50:.3f} ms")
    return {
        "metric": "lidar frames/s end-to-end (projection+FCN+decode), tpufusion_torch on "
                  f"{device.type}",
        "value": round(fps, 1),
        "unit": "frames/s",
        "p50_latency_ms": round(p50, 3),
        "fps_with_live_detections": round(batch / live_dt, 1),
        "fps_corner_parity_decode": round(batch / corner_dt, 1),
        "batch": batch,
        "points_per_frame": n_points,
        "device_ms": how.get("device_ms_per_call"),
        "busy": how.get("device_busy"),
        "peak_device_mib": how.get("peak_device_mib"),
        "device": where,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--points", type=int, default=N_POINTS)
    ap.add_argument("--sets", type=int, default=N_SETS)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.batch, args.points, args.sets)), flush=True)


if __name__ == "__main__":
    main()
