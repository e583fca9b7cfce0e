"""Operating-envelope sweep for a detector asset (counterpart of
`tpufusion/tools/detector_envelope.py`).

Config 4's protocol measures one operating condition, the asset's
training distribution. This tool measures how the asset degrades away
from it: clutter density x2 / x4, beam dropout 0.3, sweep resolution
(16k / 65k points per revolution), yaw range, varied vehicle sizes, the
oriented-ellipse and box vehicle surfaces, and the four distance
quartiles of the training distribution. Each condition is 128 fixed
frames (numpy seeds 999, 1000, ...; the reference draws the same
distributions from `jax.random`) through the asset's end-to-end step
(`predict.make_e2e_step`, the direct head, its decode operating point
for the condition's resolution: `benchmarks.decode_for_resolution`).
The anchor comes from the asset's own json (`base_condition_from_meta`).

    python -m tpufusion_torch.tools.detector_envelope [--asset PATH] [--device cuda]

Prints one row per condition and a JSON tail. The asset is loaded by
`benchmarks.asset_model`, which raises on any fault (the reference falls
back to a detector quick-trained in the benchmark).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tpufusion_torch.config import DEFAULT
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.eval.scoring import score_poses
from tpufusion_torch.predict import make_e2e_step


def run_condition(model, dcfg, head, n_batches=4, batch=32, seed=999, device="cuda",
                  **scene_kw) -> tuple[dict, np.ndarray, dict]:
    """n_batches x batch fixed frames under one scene condition -> (scores,
    poses (F, 7), {"truth": (F, 7)}), scored in the orbit frame."""
    if head != "direct":
        raise ValueError("detector_envelope decodes through the direct-pose head; "
                         f"the asset reports head={head!r}")
    step = make_e2e_step(model, DEFAULT.range_view, dcfg, head="direct", device=device)
    preds_all, truth_all = [], []
    for b in range(n_batches):
        pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(seed + b), batch,
                                                    **scene_kw)
        poses, _ = step(pts, valid)
        preds_all.append(poses.cpu().numpy())
        truth_all.append(np.concatenate([gt["center"], gt["yaw"][:, None], gt["size"]], axis=1))
    preds, truth = np.concatenate(preds_all), np.concatenate(truth_all)
    return score_poses(preds, truth, pose_frame="orbit"), preds, {"truth": truth}


def base_condition_from_meta(meta: dict) -> dict:
    """Scene kwargs of an asset's training distribution, from its json
    metadata. Missing fields fall back to the flagship's base (32k points,
    max_yaw 0.05, circle surface). A "mixed" asset anchors on the circle
    family, whose yaw cap is min(max_yaw, 0.05): yaw is unobservable on a
    rotationally symmetric surface."""
    base_kw = dict(
        n_points=int(meta.get("n_points", 32768)),
        max_yaw=float(meta.get("max_yaw", 0.05)),
    )
    scenes = str(meta.get("scenes", "beam"))
    if scenes.endswith("ellipse"):
        base_kw["vehicle_surface"] = "ellipse"
    elif scenes.endswith("box"):
        base_kw["vehicle_surface"] = "box"
    elif scenes == "mixed":
        base_kw["max_yaw"] = min(base_kw["max_yaw"], 0.05)
    return base_kw


def conditions(base_kw: dict) -> list[tuple[str, dict]]:
    """The envelope's 14 (name, scene kwargs) conditions around `base_kw`."""
    return [
        ("trained distribution", dict(**base_kw)),
        ("clutter x2", dict(**base_kw, n_clutter=48)),
        ("clutter x4", dict(**base_kw, n_clutter=96)),
        ("dropout 0.3", dict(**base_kw, dropout=0.3)),
        ("sparse sweep (16k pts)", dict(**{**base_kw, "n_points": 16384})),
        ("dense sweep (65k pts)", dict(**{**base_kw, "n_points": 65536})),
        ("varied sizes", dict(**base_kw, vary_size=True)),
        ("yaw +-0.2", dict(**{**base_kw, "max_yaw": 0.2})),
        ("yaw +-0.4", dict(**{**base_kw, "max_yaw": 0.4})),
        # the oriented-ellipse surface, where yaw is observable from geometry
        ("ellipse yaw 0", dict(**{**base_kw, "max_yaw": 0.0, "vehicle_surface": "ellipse"})),
        ("ellipse yaw +-0.2", dict(**{**base_kw, "max_yaw": 0.2, "vehicle_surface": "ellipse"})),
        ("ellipse yaw +-0.4", dict(**{**base_kw, "max_yaw": 0.4, "vehicle_surface": "ellipse"})),
        # the true l x w rectangle: the L-shaped silhouette no fit parameterizes
        ("box yaw 0", dict(**{**base_kw, "max_yaw": 0.0, "vehicle_surface": "box"})),
        ("box yaw +-0.4", dict(**{**base_kw, "max_yaw": 0.4, "vehicle_surface": "box"})),
    ]


def _row(sc: dict) -> dict:
    return {"det": sc["detection_rate"], "iou": round(sc["mean_iou"], 3),
            "r25": round(sc["recall@iou0.25"], 3), "xy": round(sc["mean_xy_err"], 3)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--asset", default=None,
                    help="detector asset npz (default: the shipped flagship)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # benchmarks imports this module (base_condition_from_meta)
    from tpufusion_torch.benchmarks import asset_model, decode_for_resolution, detector_asset_path

    asset_path = args.asset or detector_asset_path()
    model, dcfg, head = asset_model(asset_path)
    with open(asset_path + ".json") as f:
        meta = json.load(f)
    # the anchor is the asset's own training distribution (its json)
    base_kw = base_condition_from_meta(meta)
    rows = {}
    base_preds = base_truth = None
    for name, kw in conditions(base_kw):
        # the asset's per-resolution operating point, where its json has one
        cond_dcfg = decode_for_resolution(dcfg, meta, kw.get("n_points", base_kw["n_points"]))
        sc, preds, extra = run_condition(model, cond_dcfg, head, n_batches=args.eval_batches,
                                         batch=args.batch, device=args.device, **kw)
        if name == "trained distribution":
            base_preds, base_truth = preds, extra["truth"]
        rows[name] = _row(sc)
        print(f"{name:<26} det {rows[name]['det']:.2f} iou {rows[name]['iou']:.3f} "
              f"r25 {rows[name]['r25']:.2f} xy {rows[name]['xy']:.2f}", flush=True)

    # distance-quartile breakdown on the trained distribution
    dist = np.linalg.norm(base_truth[:, :2], axis=1)
    qs = np.quantile(dist, [0, 0.25, 0.5, 0.75, 1.0])
    for lo, hi in zip(qs[:-1], qs[1:]):
        sel = (dist >= lo) & (dist <= hi)
        key = f"range {lo:.0f}-{hi:.0f} m"
        rows[key] = _row(score_poses(base_preds[sel], base_truth[sel], pose_frame="orbit"))
        print(f"{key:<26} det {rows[key]['det']:.2f} iou {rows[key]['iou']:.3f} "
              f"r25 {rows[key]['r25']:.2f} xy {rows[key]['xy']:.2f}", flush=True)

    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
