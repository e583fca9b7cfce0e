"""Tune a detector asset's decode operating point on held-out scenes
(counterpart of `tpufusion/tools/tune_detector_asset.py`).

An asset ships with the operating point it was validated at (its json's
"decode", applied by `benchmarks.asset_model`). This tool sweeps
min_prob x min_bbox_area x center mode (4 x 4 x 7 for the direct head)
on the fixed protocol batches, prepared once (scenes, range view and FCN
forward) and decoded at every point; confirms the winner on a disjoint
seed set; with `--per_resolution` re-sweeps the thresholds (down to
min_prob 0.05) at each listed sweep resolution with the winning center
fixed, for the json's `decode_per_resolution` table
(`benchmarks.decode_for_resolution`); and rewrites the asset json,
keeping every key it does not set. A mixed-family asset is tuned on each
family at its training yaw cap and scored by the mean.

    python -m tpufusion_torch.tools.tune_detector_asset [--asset PATH] [--device cuda]

`--asset` defaults to the port trainer's output
(`tpufusion_torch/assets/synthetic_detector.npz`). The JAX package's
assets may be read (`--no-write`) but never rewritten: the tool raises
before any sweep when `--write` would rewrite a json under `tpufusion/`;
copy the asset out of it first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from tpufusion_torch.benchmarks import asset_model
from tpufusion_torch.config import DEFAULT
from tpufusion_torch.data.synthetic import surface_fit_params
from tpufusion_torch.tools import refuse_reference_path
from tpufusion_torch.tools.train_synthetic_detector import (
    ASSET,
    FAMILIES,
    evaluate,
    family_max_yaw,
    mean_over_families,
    prepare_eval_batches,
)

PROBS = (0.5, 0.7, 0.8, 0.9)
AREAS = (8.0, 12.0, 20.0, 40.0)
# the reference tuner's order, not the trainer's: the first of equal scores wins
CENTERS = ("fit", "consensus", "silhouette", "surface", "head", "geometric", "backproject")
# sparse sweeps need far lower thresholds: the classifier's confidence
# scales with per-pixel occupancy, not with object presence
RESOLUTION_PROBS = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.8, 0.9)
RESOLUTION_AREAS = (8.0, 20.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--asset", default=ASSET)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n_points", type=int, default=32768)
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--confirm_seed", type=int, default=5999,
                    help="disjoint seed base for the confirmation eval")
    ap.add_argument("--write", action=argparse.BooleanOptionalAction, default=True,
                    help="rewrite the asset json with the winner")
    ap.add_argument("--per_resolution", default="",
                    help="comma list of points-per-frame resolutions to calibrate separately "
                         "(e.g. 16384,32768,65536): each re-sweeps min_prob x min_bbox_area with "
                         "the winning center fixed; written to the json's decode_per_resolution")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the sweep and returns {"rows", "best", "confirmation",
    "per_resolution", "prepared" (the protocol batches, one list a
    family), "prepared_per_resolution" ({points: the same})}."""
    args = parse_args(argv)
    if args.write:
        refuse_reference_path(args.asset + ".json",
                              "copy the asset (.npz and .json) out of it, or pass --no-write")
    with open(args.asset + ".json") as f:
        meta = json.load(f)
    model, _, head = asset_model(args.asset)
    spec = DEFAULT.range_view
    scenes = meta.get("scenes", "beam")
    max_yaw = meta.get("max_yaw", 0.05)

    # the yaw-channel codec is a property of the weights, not of the
    # operating point: evaluate (and rewrite) with the frame the asset was
    # trained with
    yaw_frame = meta.get("decode", {}).get("direct_yaw_frame", "global")
    boundary_default, scale_default = surface_fit_params(scenes)
    fit_boundary = meta.get("decode", {}).get("fit_boundary", boundary_default)
    fit_scale = meta.get("decode", {}).get("fit_surface_scale", scale_default)
    base_decode = dataclasses.replace(
        DEFAULT.decode, direct_yaw_frame=yaw_frame,
        fit_boundary=fit_boundary, fit_surface_scale=fit_scale,
    )
    modes = CENTERS if head == "direct" else (None,)
    # a mixed-family asset tunes on the per-family protocol it was
    # selected by; the trainer's scene function would give "mixed" the
    # uniform-clutter scenes
    families = list(FAMILIES) if scenes == "mixed" else [scenes]

    def fam_yaw(fam):
        return family_max_yaw(fam, max_yaw)

    def prepare_all(n_points, seed=999):
        return {
            f: prepare_eval_batches(model, spec, args.batch, n_points, seed=seed,
                                    max_yaw=fam_yaw(f), scenes=f,
                                    n_batches=args.eval_batches, device=args.device)
            for f in families
        }

    def eval_mean(dcfg, center, n_points, prepared=None, seed=999):
        per_fam = [
            evaluate(model, spec, dcfg, args.batch, n_points, seed=seed, max_yaw=fam_yaw(f),
                     head=head, scenes=f, center=center, n_batches=args.eval_batches,
                     prepared=None if prepared is None else prepared[f], device=args.device)
            for f in families
        ]
        return mean_over_families(per_fam)

    prepared = prepare_all(args.n_points)
    rows = []
    for mp in PROBS:
        for ar in AREAS:
            dcfg = dataclasses.replace(base_decode, min_prob=mp, min_bbox_area=ar)
            for mode in modes:
                ev = eval_mean(dcfg, mode, args.n_points, prepared=prepared)
                rows.append({"min_prob": mp, "min_bbox_area": ar, "center": mode, **ev})
                print(f"p>={mp} area>={ar} {mode or '-':<11} det {ev['det']:.2f} "
                      f"iou {ev['mean_iou']:.3f} r25 {ev['recall_iou25']:.2f} "
                      f"xy {ev['xy_err']:.2f} score {ev['score']:.3f}", flush=True)

    best = max(rows, key=lambda r: r["score"])
    print("\nbest on protocol:", json.dumps(best))
    dcfg = dataclasses.replace(base_decode, min_prob=best["min_prob"],
                               min_bbox_area=best["min_bbox_area"])
    confirm = eval_mean(dcfg, best["center"], args.n_points, seed=args.confirm_seed)
    print("confirmation (disjoint seeds):", json.dumps(confirm))

    # per resolution: the winning center is a property of the weights, the
    # detection threshold one of the input density; record only the
    # thresholds
    per_res, prepared_res = {}, {}
    if args.per_resolution:
        for npts in (int(c) for c in args.per_resolution.split(",")):
            prepared_res[npts] = prep_r = prepare_all(npts)
            rrows = []
            for mp in RESOLUTION_PROBS:
                for ar in RESOLUTION_AREAS:
                    dr = dataclasses.replace(base_decode, min_prob=mp, min_bbox_area=ar)
                    ev = eval_mean(dr, best["center"], npts, prepared=prep_r)
                    rrows.append({"min_prob": mp, "min_bbox_area": ar, **ev})
            rbest = max(rrows, key=lambda r: r["score"])
            dr = dataclasses.replace(base_decode, min_prob=rbest["min_prob"],
                                     min_bbox_area=rbest["min_bbox_area"])
            rconf = eval_mean(dr, best["center"], npts, seed=args.confirm_seed)
            per_res[str(npts)] = {"min_prob": rbest["min_prob"],
                                  "min_bbox_area": rbest["min_bbox_area"]}
            print(f"resolution {npts}: min_prob {rbest['min_prob']} "
                  f"area {rbest['min_bbox_area']} det {rbest['det']:.2f} "
                  f"iou {rbest['mean_iou']:.3f} (confirm det {rconf['det']:.2f} "
                  f"iou {rconf['mean_iou']:.3f})", flush=True)

    if args.write:
        meta["decode"] = {"min_prob": best["min_prob"], "min_bbox_area": best["min_bbox_area"]}
        if best["center"]:
            meta["decode"]["direct_center"] = best["center"]
        if head == "direct":
            meta["decode"]["direct_yaw_frame"] = yaw_frame
            meta["decode"]["fit_boundary"] = fit_boundary
            meta["decode"]["fit_surface_scale"] = fit_scale
        step = meta.get("best", {}).get("step")
        meta["best"] = {k: best[k] for k in ("det", "xy_err", "within2m", "mean_iou",
                                             "recall_iou25", "yaw_err", "score") if k in best}
        meta["best"]["center"] = best["center"]
        meta["best"]["step"] = step
        meta["confirmation"] = confirm
        if per_res:
            meta["decode_per_resolution"] = per_res
        with open(args.asset + ".json", "w") as f:
            json.dump(meta, f)
        print("asset json updated ->", args.asset + ".json")
    return {"rows": rows, "best": best, "confirmation": confirm, "per_resolution": per_res,
            "prepared": prepared, "prepared_per_resolution": prepared_res}


if __name__ == "__main__":
    main()
