"""The port's detector trainer tool (`tpufusion_torch/tools/
train_synthetic_detector.py`) and its schedule against the JAX package's,
on the CPU.

The same numpy inputs go through both tools: where the reference draws
its own scenes (`_synth`, from `jax.random`), the test puts the port's
numpy scenes in its place inside the reference tool's namespace. Sizes
are small: the range view of `RangeViewSpec(res_h_deg=1.8)` (32 x 201)
for the held-out eval and the step, a few frames; the trainer's `main`
runs at its own 32 x 1801 range view for 2 steps of 2 frames.

Tolerances: the asset json byte-equal; the schedule exact in the warmup
and after the decay, and within one float32 ulp of the peak (2**-23 lr)
on the cosine, whose float32 cos XLA computes to within an ulp of the
correctly rounded one the port uses; Adam's parameters within 1e-6 after
each update; one train step within `_golden.train_case_limits`
("direct_f32"); the held-out scores' detection rate equal, the others
within 1e-4; an asset's float32 forward in JAX within 1e-4 of the port's.
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import tpufusion.config as jax_config
from tests.torch_golden import (
    ASSET,
    asset_configs,
    jax_forward,
    jax_model_from_arrays,
    jax_prepared,
    label_prepared,
    random_arrays,
    range_view_inputs,
    to_jax_config,
    to_port_config,
)
from tpufusion.geometry import encoding as jax_encoding
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion.models import io as jax_io
from tpufusion.models.fcn import FCN as JaxFCN
from tpufusion.models.losses import weighted_pose_loss as jax_loss
from tpufusion.tools import train_synthetic_detector as ref
from tpufusion.train import train_step as jax_train_step
from tpufusion_torch import _golden, benchmarks
from tpufusion_torch.config import DEFAULT, DecodeConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.models import io as models_io
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.tools import train_synthetic_detector as port
from tpufusion_torch.train.optim import Adam, warmup_cosine_decay_schedule, warmup_cosine_value
from tpufusion_torch.train.stats import population_weights
from tpufusion_torch.train.train_step import make_train_step

SMALL = RangeViewSpec(res_h_deg=1.8)  # 32 x 201
SCORE_ATOL = 1e-4


def _seed_of(key) -> int:
    """The seed s of jax.random.PRNGKey(s) (s < 2**32)."""
    return int(np.asarray(jax.random.key_data(key))[-1])


def _numpy_synth(scenes, key, batch, n_points, max_yaw, vary_size=False, n_clutter=24):
    """The reference tool's `_synth` drawing the port's numpy scenes from
    the key's seed number."""
    pts, gt, valid = port._synth(scenes, np.random.default_rng(_seed_of(key)), batch, n_points,
                                 max_yaw, vary_size, n_clutter)
    return pts, gt, valid


# -- small pieces -----------------------------------------------------------------------

@pytest.mark.parametrize("scenes", ["beam", "beam-ellipse", "beam-box", "mixed", "uniform"])
def test_yaw_frame_and_deployment_decode_match(scenes):
    for yaw_frame in ("auto", "local", "global", "both"):
        assert port.resolve_yaw_frame(yaw_frame, scenes) == ref.resolve_yaw_frame(yaw_frame, scenes)
    base = DecodeConfig(min_prob=0.3, direct_center="fit")
    for mp, area in ((0.9, 20.0), (0.5, 8.0)):
        got = port.deployment_decode(base, mp, area, scenes)
        want = ref.deployment_decode(to_jax_config(base), mp, area, scenes)
        assert got == to_port_config(want)


def test_scene_families_reach_their_generators():
    """"beam-*" names pick the ray-caster's surface; any other name,
    "mixed" included, falls through to the uniform clouds, as in the
    reference (its tuner evaluates a mixed asset family by family)."""
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch, synthesize_points_batch

    pts, gt, valid = port._synth("beam-box", np.random.default_rng(3), 2, 1024, 0.3)
    want = synthesize_beam_scan_batch(np.random.default_rng(3), 2, 1024, max_yaw=0.3,
                                      vehicle_surface="box")
    np.testing.assert_array_equal(pts, want[0])
    np.testing.assert_array_equal(valid, want[2])
    pts, gt, valid = port._synth("mixed", np.random.default_rng(3), 2, 1024, 0.3)
    assert valid is None
    np.testing.assert_array_equal(pts, synthesize_points_batch(np.random.default_rng(3), 2, 1024,
                                                               max_yaw=0.3)[0])


def _json_args(**kw):
    base = dict(eval_min_prob=0.9, eval_min_bbox_area=20.0, yaw_frame="auto", scenes="beam",
                head="direct", reg_activation="linear", width_mult=2, steps=3000, max_yaw=0.05,
                points_mix="", batch=32, n_points=32768, w1_boost=20.0, weight_bb=1.0)
    return argparse.Namespace(**{**base, **kw})


_BEST = {"det": 0.96875, "xy_err": 0.31234567, "within2m": 1.0, "mean_iou": 0.6789,
         "recall_iou25": 0.953125, "yaw_err": float("nan"), "score": 2.9, "step": 400,
         "center": "fit"}
JSON_CASES = {
    "flagship": ({}, _BEST),
    "ellipse_points_mix": ({"scenes": "beam-ellipse", "points_mix": "16384,32768,65536",
                            "max_yaw": 0.45}, _BEST),
    "box": ({"scenes": "beam-box"}, {**_BEST, "center": "consensus"}),
    "mixed": ({"scenes": "mixed", "max_yaw": 0.45},
              {**_BEST, "per_family": {"beam": {"mean_iou": 0.7, "det": 1.0}}}),
    "both_on_circle": ({"yaw_frame": "both"}, _BEST),
    "corner": ({"head": "corner", "reg_activation": "relu", "width_mult": 1},
               {**_BEST, "center": None}),
    "uniform_no_center": ({"scenes": "uniform"}, {"score": -1.0}),
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_asset_json_is_byte_equal(case, tmp_path):
    kw, best = JSON_CASES[case]
    out = {}
    for tag, mod in (("port", port), ("ref", ref)):
        args = _json_args(out=str(tmp_path / f"{tag}.npz"), **kw)
        mod._write_asset_json(args, dict(best))
        out[tag] = (tmp_path / f"{tag}.npz.json").read_bytes()
    assert out["port"] == out["ref"]
    meta = json.loads(out["port"])
    if kw.get("head", "direct") == "direct":
        assert meta["decode"]["direct_yaw_frame"] == port.resolve_yaw_frame(
            kw.get("yaw_frame", "auto"), kw.get("scenes", "beam")).replace("both", "auto")


# -- the schedule -----------------------------------------------------------------------

@pytest.mark.parametrize("lr, steps", [(1e-3, 3000), (1e-3, 4), (3e-3, 37), (2e-4, 2)])
def test_warmup_cosine_schedule_matches_optax(lr, steps):
    """The tool's schedule, every step from 0 to steps + 3: the warmup
    (starting at lr 0), the cosine over steps - warmup and the absolute
    end value held after."""
    warmup = min(50, max(1, steps // 10))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.03)
    want = np.asarray([sched(jnp.int32(n)) for n in range(steps + 4)], np.float32)
    got = np.asarray([warmup_cosine_value(n, lr, warmup, steps, lr * 0.03)
                      for n in range(steps + 4)], np.float32)
    assert got[0] == want[0] == 0.0
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    np.testing.assert_array_equal(got[steps:], want[steps:])
    assert got[-1] == pytest.approx(lr * 0.03, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23 * lr)


def test_adam_under_the_schedule_matches_optax():
    """Three updates of Adam under the schedule (warmup 1 of 4 steps) on
    identical gradients: the first at lr 0 moves nothing, as in optax."""
    lr, steps = 1e-3, 4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 1, steps, lr * 0.03)
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (4,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    tx = optax.adam(sched)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = Adam(tparams, lr)
    warmup_cosine_decay_schedule(opt, lr, 1, steps, lr * 0.03)
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        for t, x in zip(tparams, g):
            t.grad = torch.from_numpy(x.copy())
        opt.step()
        for a, t in zip(params, tparams):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0, atol=1e-6)
        if i == 0:
            for a, p in zip(tparams, p0):
                np.testing.assert_array_equal(a.detach().numpy(), p)
    assert opt.count == 3


# -- the tool's loss configuration and one step ---------------------------------------------

class _Captured(Exception):
    pass


def _reference_loss_config(monkeypatch, argv):
    """The LossConfig the reference tool's `main` hands make_train_step
    (its scenes the port's numpy ones), and the port's stats on the same
    scenes."""
    seen = {}

    def capture(spec, loss_cfg, train_cfg, **kw):
        seen.update(loss=loss_cfg, train=train_cfg, **kw)
        raise _Captured

    monkeypatch.setattr(ref, "_synth", _numpy_synth)
    monkeypatch.setattr(ref, "make_train_step", capture)
    with pytest.raises(_Captured):
        ref.main(argv)
    return seen


STEP_CASES = {  # argv of the tool, the yaw frame it resolves to
    "global": (["--yaw_weight", "3"], "global"),
    "dual": (["--yaw_weight", "3", "--scenes", "mixed"], "both"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_step_of_the_tools_loss_matches_the_reference(case, monkeypatch):
    """The tool's loss (w1_boost x the population ratio, --yaw_weight 3 as
    reg_channel_weights, the clip, the direct head with the global or the
    dual codec): the reference tool's LossConfig and train config equal
    the port's; then one step of each on the same batch and weights (the
    schedule's first update, at lr 0), held to train_case_limits."""
    extra, yaw_frame = STEP_CASES[case]
    argv = ["--batch", "2", "--n_points", "2048", "--steps", "10"] + extra
    seen = _reference_loss_config(monkeypatch, argv)
    args = port.parse_args(argv + ["--device", "cpu"])
    fam = "beam" if args.scenes == "mixed" else args.scenes
    _, gt, _ = port._synth(fam, np.random.default_rng(42), 2, 2048, 0.05)
    stats = population_weights(gt["center"], gt["size"], gt["yaw"], DEFAULT.range_view,
                               device="cpu")
    loss_cfg = port.loss_config(args, stats, yaw_frame)
    want_cfg = to_port_config(seen["loss"])
    assert dataclasses.replace(want_cfg, obj_to_bkg_ratio=0.0, avg_obj_size=0.0) == \
        dataclasses.replace(loss_cfg, obj_to_bkg_ratio=0.0, avg_obj_size=0.0)
    assert loss_cfg.obj_to_bkg_ratio == pytest.approx(want_cfg.obj_to_bkg_ratio, rel=1e-6)
    assert loss_cfg.avg_obj_size == pytest.approx(want_cfg.avg_obj_size, rel=1e-6)
    assert loss_cfg.reg_channel_weights == (1.0,) * 6 + (3.0,) * (4 if yaw_frame == "both" else 2)
    assert seen["head"] == "direct" and seen["yaw_frame"] == yaw_frame
    assert to_port_config(seen["train"]) == TrainConfig(batch_size=2, augment=False)

    mcfg = dataclasses.replace(DEFAULT.model, head="direct", reg_output_activation="linear",
                               width_multiplier=2, yaw_codec="dual" if yaw_frame == "both" else "single")
    arrays = random_arrays(FCN(mcfg), seed=5)
    pts, gt, valid = port._synth("beam", np.random.default_rng(8), 4, 4096, 0.05)
    batch = {"points": pts, "valid": valid, **gt}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 10, 3e-5)

    # the reference: its train step (optax.adam under the schedule), and the
    # gradient of the loss that step differentiates
    jspec, jcfg = to_jax_config(SMALL), to_jax_config(loss_cfg)
    jmodel = jax_model_from_arrays(mcfg, arrays)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    images = jax_project(jbatch["points"], jspec, jbatch["valid"])
    labels = jax_encoding.encode_direct_label_batch(
        jbatch["center"], jbatch["size"], jbatch["yaw"], images, jspec, yaw_frame=yaw_frame)
    grads = nnx.jit(lambda m: nnx.grad(lambda m: jax_loss(m(images, train=True), labels, jcfg))(m))(
        jax_model_from_arrays(mcfg, arrays))
    want_grads = {f"{a}/{b}": np.asarray(g, np.float32)
                  for a, leaves in nnx.to_pure_dict(grads).items() for b, g in leaves.items()}
    jopt = nnx.Optimizer(jmodel, optax.adam(sched), wrt=nnx.Param)
    jstep = jax_train_step.make_train_step(
        jspec, jcfg, to_jax_config(TrainConfig(batch_size=4, augment=False)), head="direct",
        yaw_frame=yaw_frame)
    want_loss, want_metrics = jstep(jmodel, jopt, jbatch, jax.random.PRNGKey(0))

    model = FCN(mcfg)
    models_io.load_arrays(model, arrays)
    opt = Adam(model.parameters(), 1e-3)
    warmup_cosine_decay_schedule(opt, 1e-3, 1, 10, 3e-5)
    step = make_train_step(SMALL, loss_cfg, TrainConfig(batch_size=4, augment=False),
                           head="direct", yaw_frame=yaw_frame, device="cpu")
    got_loss, got_metrics = step(model, opt, batch)
    got_grads = {n.replace(".", "/"): p.grad.numpy() for n, p in model.named_parameters()}

    limits = _golden.train_case_limits("direct_f32")
    assert abs(float(got_loss) - float(want_loss)) <= limits["loss_rel"] * abs(float(want_loss))
    assert sorted(got_grads) == sorted(want_grads)
    rel = {k: float(np.abs(g - want_grads[k]).max() / max(np.abs(want_grads[k]).max(), 1e-30))
           for k, g in got_grads.items()}
    assert max(rel.values()) <= limits["grad_rel"], rel
    for k in ("precision", "recall", "reg_mse"):
        assert float(got_metrics[k]) == pytest.approx(float(want_metrics[k]), rel=1e-4, abs=1e-6)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(getattr(model.norm, stat).numpy(),
                                   np.asarray(getattr(jmodel.norm, stat)[...]),
                                   rtol=1e-6, atol=limits["stats_abs"])
    # the first update runs at lr 0 in both: no parameter moved
    after = models_io.state_arrays(model)
    jafter = {f"{a}/{b}": np.asarray(v) for a, leaves in
              nnx.to_pure_dict(nnx.state(jmodel, nnx.Param)).items() for b, v in leaves.items()}
    for k, v in jafter.items():
        np.testing.assert_array_equal(after[k], arrays[k])
        np.testing.assert_array_equal(v, arrays[k])


# -- the held-out eval ------------------------------------------------------------------

EVAL_CASES = [("direct", m) for m in port.CENTER_MODES] + [("corner", None)]


@pytest.fixture(scope="module")
def shared_prepared():
    return {head: label_prepared(5, 1, 6, SMALL, head=head) for head in ("direct", "corner")}


@pytest.mark.parametrize("head, center", EVAL_CASES, ids=[f"{h}-{c}" for h, c in EVAL_CASES])
def test_evaluate_matches_on_shared_prepared_batches(head, center, shared_prepared):
    """`evaluate(prepared=...)` of both tools on the same prepared batches
    (label-derived maps of 6 seeded frames at 32 x 201): every center mode
    of the direct head with the flagship's decode config, and the corner
    head."""
    if head == "direct":
        _, dcfg = asset_configs()
        dcfg = dataclasses.replace(dcfg, min_bbox_area=2.0)
    else:
        dcfg = DecodeConfig(min_bbox_area=2.0)
    prepared = shared_prepared[head]
    want = ref.evaluate(None, None, to_jax_config(SMALL), to_jax_config(dcfg), head=head,
                        center=center, prepared=jax_prepared(prepared))
    got = port.evaluate(None, SMALL, dcfg, head=head, center=center, prepared=prepared)
    assert sorted(got) == sorted(want)
    assert got["det"] == want["det"] and want["det"] >= 0.5
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SCORE_ATOL, err_msg=k)


def test_prepare_eval_batches_projects_and_forwards_the_seeded_scenes():
    model = FCN(dataclasses.replace(DEFAULT.model, head="direct", width_multiplier=2,
                                    reg_output_activation="linear"), seed=0)
    prepared = port.prepare_eval_batches(model, SMALL, batch=2, n_points=2048, seed=7,
                                         scenes="beam-box", n_batches=2, device="cpu")
    assert len(prepared) == 2
    for b, (preds, images, gt) in enumerate(prepared):
        pts, want_gt, valid = port._synth("beam-box", np.random.default_rng(7 + b), 2, 2048, 0.05)
        np.testing.assert_array_equal(gt["center"], want_gt["center"])
        assert images.shape == (2, 32, 201, 3) and preds.shape == (2, 32, 201, 10)
        with torch.no_grad():
            np.testing.assert_array_equal(preds.numpy(), model(images).numpy())


# -- the trainer end to end ---------------------------------------------------------------

def test_trainer_main_writes_an_asset_the_reference_loads(tmp_path):
    """`main` on the CPU (2 steps of 2 frames at 512 and 1,024 points, the
    held-out eval at 1,024): the asset and its json are written where
    --out says; the npz loads into a JAX FCN of the json's geometry through
    the reference's own loader, and that FCN's float32 forward equals the
    port's within 1e-4."""
    out = str(tmp_path / "det.npz")
    best = port.main(["--steps", "2", "--batch", "2", "--n_points", "1024",
                      "--points_mix", "512,1024", "--eval_batches", "1", "--device", "cpu",
                      "--out", out])
    assert best["step"] == 2 and best["center"] in port.CENTER_MODES
    meta = json.load(open(out + ".json"))
    assert meta["model"] == {"reg_output_activation": "linear", "width_multiplier": 2,
                             "head": "direct"}
    assert meta["points_mix"] == "512,1024" and meta["best"]["step"] == 2
    model, dcfg, head = benchmarks.asset_model(out)
    assert head == "direct" and dcfg.direct_center == best["center"]

    shipped = np.load(ASSET)
    written = np.load(out)
    assert sorted(written.files) == sorted(shipped.files)
    for k in shipped.files:
        assert written[k].shape == shipped[k].shape and written[k].dtype == shipped[k].dtype, k

    jcfg = dataclasses.replace(jax_config.ModelConfig(), **meta["model"])
    jmodel = JaxFCN(jcfg, in_channels=3, rngs=nnx.Rngs(1))
    jax_io.load_state_npz(out, jmodel)
    images = range_view_inputs(3, 2, 201)
    port_model = FCN(dataclasses.replace(DEFAULT.model, **meta["model"]))
    models_io.load_state_npz(out, port_model)
    with torch.no_grad():
        got = port_model.eval()(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, jax_forward(jmodel, images), rtol=0, atol=1e-4)


def test_trainer_refuses_to_write_into_the_jax_package():
    with pytest.raises(ValueError, match="JAX package"):
        port.main(["--out", os.path.join(os.path.dirname(ASSET), "x.npz"), "--device", "cpu"])
