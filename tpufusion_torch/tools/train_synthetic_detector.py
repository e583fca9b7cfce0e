"""Train the synthetic-scene detector asset (counterpart of
`tpufusion/tools/train_synthetic_detector.py`).

The FCN (by default the width-2 direct-pose head with a linear regression
output) trains on an endless stream of fresh synthetic scenes, one batch a
step, and the weights that score best on fixed held-out scenes are written
as an asset: the `.npz` that `models.io.load_state_npz` of either package
reads, and the `.json` that `benchmarks.asset_model` reads (the model's
geometry and the decode operating point it was validated at). Each
held-out evaluation decodes the direct head with all seven center
estimators and ships the winner.

As in the reference: Adam under a linear warmup and a cosine decay to 3 %
of the lr (`train.optim.warmup_cosine_decay_schedule`: the first update
runs at lr 0), the class-balanced loss with its background weight boosted
(`--w1_boost`), `--scenes mixed` cycling circle, ellipse and box scenes
step by step and selecting by the mean score over the three families with
the dual yaw codec, `--clutter_mix` / `--points_mix` cycling clutter
counts and sweep resolutions, and `--init_from` warm-starting from an
asset. Scenes are drawn with numpy from the reference's seed numbers
(`numpy.random.default_rng(seed)` where it has `jax.random.PRNGKey(seed)`):
the same distributions, not the same bits. The held-out forward runs the
model in eval mode under `torch.inference_mode()`.

    python -m tpufusion_torch.tools.train_synthetic_detector [--steps 3000] [--device cuda]

The asset goes to `tpufusion_torch/assets/synthetic_detector.npz` (+ .json)
unless `--out` names another path outside the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT, LossConfig, TrainConfig
from tpufusion_torch.data.synthetic import (
    surface_fit_params,
    synthesize_beam_scan_batch,
    synthesize_points_batch,
)
from tpufusion_torch.decode.decode import decode_batch, decode_batch_direct
from tpufusion_torch.eval.scoring import orbit_to_physical, score_poses
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import load_state_npz, save_state_npz
from tpufusion_torch.tools import ASSETS, refuse_reference_path
from tpufusion_torch.train.optim import Adam, warmup_cosine_decay_schedule
from tpufusion_torch.train.stats import population_weights
from tpufusion_torch.train.train_step import make_train_step

ASSET = os.path.join(ASSETS, "synthetic_detector.npz")
# the direct head's center estimators, in the order the trainer evaluates them
CENTER_MODES = ("fit", "consensus", "silhouette", "surface", "geometric", "head", "backproject")
FAMILIES = ("beam", "beam-ellipse", "beam-box")  # what --scenes mixed cycles through


def _synth(scenes, rng, batch, n_points, max_yaw, vary_size=False, n_clutter=24):
    """(points, gt, valid) for any scene family (valid=None for the
    uniform clutter of any name not starting "beam", "mixed" included).
    "beam-ellipse" renders oriented-ellipse vehicles (yaw observable),
    "beam-box" true l x w rectangles, "beam" the rotationally symmetric
    circle surface."""
    if scenes.startswith("beam"):
        if scenes.endswith("ellipse"):
            surface = "ellipse"
        elif scenes.endswith("box"):
            surface = "box"
        else:
            surface = "circle"
        return synthesize_beam_scan_batch(
            rng, batch, n_points, max_yaw=max_yaw, vary_size=vary_size,
            n_clutter=n_clutter, vehicle_surface=surface,
        )
    pts, gt = synthesize_points_batch(rng, batch, n_points, max_yaw=max_yaw, vary_size=vary_size)
    return pts, gt, None


def prepare_eval_batches(model, spec, batch=32, n_points=32768, seed=999, max_yaw=0.05,
                         scenes="beam", n_batches=1, device="cuda"):
    """Synthesize, project and forward the fixed eval batches (numpy
    seeds seed, seed + 1, ...) once: [(predictions, images, gt), ...],
    the tensors on `device` (the card unless the caller asks for "cpu").
    The decode operating point touches none of this, so a sweep over
    operating points reuses the prepared batches."""
    device = torch.device(device)
    model.to(device).eval()
    prepared = []
    with torch.inference_mode():
        for b in range(n_batches):
            pts, gt, valid = _synth(scenes, np.random.default_rng(seed + b), batch, n_points,
                                    max_yaw)
            ok = None if valid is None else torch.from_numpy(valid).to(device)
            images = range_view_project_batch(torch.from_numpy(pts).to(device), spec, ok)
            prepared.append((model(images), images, gt))
    return prepared


@torch.inference_mode()
def decode_prepared(prepared, spec, dcfg, head="corner", center=None):
    """Prepared batches through the head's decode -> (poses (F, 7),
    found (F,), gt {center, yaw, size}) as numpy, in the orbit frame."""
    poses, found = [], []
    for preds, images, _ in prepared:
        if head == "direct":
            out = decode_batch_direct(preds, images, spec, dcfg, 1, center)
            poses.append(out["poses"][:, 0].cpu().numpy())
            found.append(out["found"][:, 0].cpu().numpy())
        else:
            out = decode_batch(preds, images, spec, dcfg)
            poses.append(out["pose"].cpu().numpy())
            found.append(out["found"].cpu().numpy())
    gt = {k: np.concatenate([g[k] for _, _, g in prepared]) for k in ("center", "yaw", "size")}
    return np.concatenate(poses), np.concatenate(found), gt


def detection_scores(poses, found, gt) -> dict:
    """The held-out scores of decoded frames, every error in the physical
    frame: detection rate, mean xy error and share within 2 m of the
    detected frames, mean IoU, recall at IoU 0.25, yaw error, and the
    selection score det * (within2m + recall@0.25 + 2 IoU)."""
    truth = np.concatenate([gt["center"], np.asarray(gt["yaw"])[:, None], gt["size"]], axis=1)
    po_phys, truth_phys = orbit_to_physical(poses), orbit_to_physical(truth)
    d = np.linalg.norm(po_phys[:, :2] - truth_phys[:, :2], axis=1)
    det = float(found.mean())
    within2 = float((d < 2.0)[found].mean()) if found.any() else 0.0
    err = float(d[found].mean()) if found.any() else float("nan")
    sc = score_poses(po_phys, truth_phys)
    return {"det": det, "xy_err": err, "within2m": within2,
            "mean_iou": float(sc["mean_iou"]),
            "recall_iou25": float(sc["recall@iou0.25"]),
            "yaw_err": float(sc.get("mean_yaw_err", float("nan"))),
            "score": det * (within2 + float(sc["recall@iou0.25"])
                            + 2.0 * float(sc["mean_iou"]))}


def evaluate(model, spec, dcfg, batch=32, n_points=32768, seed=999, max_yaw=0.05,
             head="corner", scenes="beam", center=None, n_batches=1, prepared=None,
             device="cuda"):
    """Held-out eval on `n_batches` fixed seed batches (seed, seed + 1,
    ...), or on `prepared` ones (`prepare_eval_batches`, `model` then
    unused) -> `detection_scores`."""
    if prepared is None:
        prepared = prepare_eval_batches(model, spec, batch, n_points, seed, max_yaw, scenes,
                                        n_batches, device)
    return detection_scores(*decode_prepared(prepared, spec, dcfg, head, center))


def family_max_yaw(fam: str, max_yaw: float) -> float:
    """A family's yaw cap: the circle family keeps the near-zero yaw where
    its pose task is well posed."""
    return min(max_yaw, 0.05) if fam == "beam" else max_yaw


def mean_over_families(per_fam: list[dict]) -> dict:
    """One family's scores as they are; several families' as their mean,
    by which a mixed-family asset is selected and tuned."""
    if len(per_fam) == 1:
        return per_fam[0]
    return {k: float(np.mean([e[k] for e in per_fam])) for k in per_fam[0]}


def resolve_yaw_frame(yaw_frame: str, scenes: str) -> str:
    """"auto" -> the codec the scene family's surface supports: "local"
    for oriented surfaces (ellipse, box), "global" for rotationally
    symmetric ones, "both" (the dual-codec head, decoded through the
    per-cluster gate) for mixed-family training."""
    if yaw_frame != "auto":
        return yaw_frame
    if scenes == "mixed":
        return "both"
    if scenes.endswith("ellipse") or scenes.endswith("box"):
        return "local"
    return "global"


def deployment_decode(base, min_prob: float, min_bbox_area: float, scenes: str = "beam"):
    """The asset's decode operating point: the thresholds it was validated
    at, and the "fit" center's boundary model of the scene family's
    vehicle surface (`surface_fit_params`)."""
    boundary, scale = surface_fit_params(scenes)
    return dataclasses.replace(
        base, min_prob=min_prob, min_bbox_area=min_bbox_area,
        fit_boundary=boundary, fit_surface_scale=scale,
    )


def loss_config(args, stats: dict, yaw_frame: str) -> LossConfig:
    """The tool's loss: class balance from the population statistics with
    the background weight boosted w1_boost times, and on the direct head
    the sin/cos yaw channels weighted yaw_weight (2 channels, 4 for the
    dual codec) inside the joint regression L2."""
    n_yaw_ch = 4 if yaw_frame == "both" else 2
    return LossConfig(
        obj_to_bkg_ratio=stats["positive_to_negative_ratio"] * args.w1_boost,
        avg_obj_size=stats["average_area"],
        weight_bb=args.weight_bb,
        reg_target_norm_clip=args.reg_clip,
        reg_channel_weights=(
            (1.0,) * 6 + (args.yaw_weight,) * n_yaw_ch
            if args.head == "direct" and args.yaw_weight != 1.0
            else None
        ),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n_points", type=int, default=32768)
    ap.add_argument("--eval_every", type=int, default=200)
    # 4 x 32 fixed seed batches = 128 held-out frames, config 4's protocol
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=ASSET)
    # the class-balanced loss makes over-painting the boundary nearly
    # free; the boost keeps the positive region to the footprint
    ap.add_argument("--w1_boost", type=float, default=20.0)
    ap.add_argument("--eval_min_prob", type=float, default=0.9)
    ap.add_argument("--eval_min_bbox_area", type=float, default=20.0)
    # yaw ~ 0: the orbit-origin convention makes yaw unobservable for
    # axis-aligned clusters (data/synthetic.py)
    ap.add_argument("--max_yaw", type=float, default=0.05)
    ap.add_argument("--weight_bb", type=float, default=1.0)
    ap.add_argument("--reg_activation", default="linear")
    ap.add_argument("--reg_clip", type=float, default=15.0)
    ap.add_argument("--width_mult", type=int, default=2)
    ap.add_argument("--head", default="direct")
    ap.add_argument("--vary_size", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--scenes", choices=("beam", "beam-ellipse", "beam-box", "mixed", "uniform"),
                    default="beam")
    ap.add_argument("--yaw_weight", type=float, default=1.0,
                    help="direct head: weight of the sin/cos yaw channels in the regression L2")
    ap.add_argument("--yaw_frame", choices=("auto", "local", "global", "both"), default="auto")
    ap.add_argument("--init_from", default=None,
                    help="warm-start weights from an existing asset npz")
    ap.add_argument("--clutter_mix", default="24",
                    help="comma list of per-step clutter counts to cycle through (beam scenes)")
    ap.add_argument("--points_mix", default="",
                    help="comma list of per-step sweep resolutions to cycle through, e.g. "
                         "16384,32768,65536; empty = --n_points only. The held-out eval "
                         "stays at --n_points.")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Trains, writes the best asset, and returns the best evaluation."""
    args = parse_args(argv)
    refuse_reference_path(args.out, "pass --out a path outside it (the default is "
                          "tpufusion_torch/assets/synthetic_detector.npz)")
    device = torch.device(args.device)
    cfg = DEFAULT
    spec = cfg.range_view
    yaw_frame = resolve_yaw_frame(args.yaw_frame, args.scenes)
    families = list(FAMILIES) if args.scenes == "mixed" else [args.scenes]

    def fam_max_yaw(fam):
        return family_max_yaw(fam, args.max_yaw)

    model = FCN(
        dataclasses.replace(cfg.model, dtype="bfloat16",
                            reg_output_activation=args.reg_activation,
                            width_multiplier=args.width_mult,
                            head=args.head,
                            yaw_codec="dual" if yaw_frame == "both" else "single"),
        in_channels=3, seed=0,
    )
    if args.init_from:
        load_state_npz(args.init_from, model)
        print(f"warm-started from {args.init_from}", flush=True)
    model.to(device)
    warmup = min(50, max(1, args.steps // 10))
    opt = Adam(model.parameters(), args.lr)
    warmup_cosine_decay_schedule(opt, args.lr, warmup, args.steps, args.lr * 0.03)

    _, gt, _ = _synth(families[0], np.random.default_rng(42), args.batch, args.n_points,
                      fam_max_yaw(families[0]))
    stats = population_weights(gt["center"], gt["size"], gt["yaw"], spec, device=device)
    step = make_train_step(
        spec, loss_config(args, stats, yaw_frame),
        TrainConfig(batch_size=args.batch, augment=args.head != "direct"),
        head=args.head, yaw_frame=yaw_frame, device=device,
    )
    dcfg = dataclasses.replace(
        deployment_decode(cfg.decode, args.eval_min_prob, args.eval_min_bbox_area,
                          scenes=args.scenes),
        # the dual ("both") head decodes through the per-cluster gate ("auto")
        direct_yaw_frame="auto" if yaw_frame == "both" else yaw_frame,
    )

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    best = {"score": -1.0}
    generator = torch.Generator(device=device).manual_seed(7)
    t0 = time.time()
    clutter_mix = [int(c) for c in args.clutter_mix.split(",")]
    points_mix = [int(c) for c in args.points_mix.split(",")] if args.points_mix else [args.n_points]
    modes = CENTER_MODES if args.head == "direct" else (None,)
    for s in range(1, args.steps + 1):
        fam = families[s % len(families)]
        p, g, vmask = _synth(
            fam, np.random.default_rng(100_000 + s), args.batch, points_mix[s % len(points_mix)],
            fam_max_yaw(fam), vary_size=args.vary_size,
            n_clutter=clutter_mix[s % len(clutter_mix)],
        )
        batch = {"points": p, "center": g["center"], "size": g["size"], "yaw": g["yaw"]}
        if vmask is not None:
            batch["valid"] = vmask
        loss, _ = step(model, opt, batch, generator)
        if s % args.eval_every == 0 or s == args.steps:
            # which center estimator wins flips as the head trains:
            # evaluate all of them and ship the winner in the asset json
            fam_prepared = {
                f: prepare_eval_batches(model, spec, args.batch, args.n_points,
                                        max_yaw=fam_max_yaw(f), scenes=f,
                                        n_batches=args.eval_batches, device=device)
                for f in families
            }

            def _eval_mode(m):
                per_fam = [evaluate(model, spec, dcfg, head=args.head, center=m,
                                    prepared=fam_prepared[f]) for f in families]
                mean = mean_over_families(per_fam)
                if len(per_fam) > 1:
                    mean["per_family"] = {
                        f: {"mean_iou": e["mean_iou"], "det": e["det"],
                            "recall_iou25": e["recall_iou25"],
                            "xy_err": e["xy_err"], "yaw_err": e["yaw_err"]}
                        for f, e in zip(families, per_fam)
                    }
                return mean

            evs = {m: _eval_mode(m) for m in modes}
            mode = max(evs, key=lambda m: evs[m]["score"])
            ev = evs[mode]
            print(
                f"step {s}: loss {float(loss):.3f} det {ev['det']:.2f} "
                f"xy_err {ev['xy_err']:.2f} within2m {ev['within2m']:.2f} "
                f"iou {ev['mean_iou']:.2f} r25 {ev['recall_iou25']:.2f} "
                f"[{mode}" + "".join(f" {m}:{evs[m]['score']:.2f}" for m in evs)
                + f"] ({time.time() - t0:.0f}s)", flush=True,
            )
            if ev["score"] > best["score"]:
                best = {**ev, "step": s, "center": mode}
                save_state_npz(args.out, model)
                _write_asset_json(args, best)
    _write_asset_json(args, best)
    print("best:", best, "->", args.out)
    return best


def _write_asset_json(args, best):
    """The asset's json, as the reference's trainer writes it: the best
    evaluation, the training settings, the decode operating point (and on
    the direct head its yaw frame and fit boundary) and the model's
    geometry."""
    decode = {"min_prob": args.eval_min_prob,
              "min_bbox_area": args.eval_min_bbox_area}
    if "center" in best and best["center"]:
        decode["direct_center"] = best["center"]
    yaw_frame = resolve_yaw_frame(args.yaw_frame, args.scenes)
    if args.head == "direct":
        decode["direct_yaw_frame"] = "auto" if yaw_frame == "both" else yaw_frame
        boundary, scale = surface_fit_params(args.scenes)
        decode["fit_boundary"] = boundary
        decode["fit_surface_scale"] = scale
    model_json = {"reg_output_activation": args.reg_activation,
                  "width_multiplier": args.width_mult,
                  "head": args.head}
    if yaw_frame == "both":
        model_json["yaw_codec"] = "dual"
    with open(args.out + ".json", "w") as f:
        json.dump({"best": best, "steps": args.steps,
                   "scenes": args.scenes,
                   "max_yaw": args.max_yaw,
                   **({"points_mix": args.points_mix}
                      if args.points_mix else {}),
                   "batch": args.batch, "n_points": args.n_points,
                   "w1_boost": args.w1_boost,
                   "weight_bb": args.weight_bb,
                   "decode": decode,
                   "model": model_json},
                  f)


if __name__ == "__main__":
    main()
