"""The port's operating-point tuner, envelope sweep and oracle arms
(`tpufusion_torch/tools/{tune_detector_asset,detector_envelope,
fit_oracle_sensitivity}.py`) against the JAX package's tools, on the CPU.

Where a comparison is about the tool's own logic (the sweep and the json
rewrite, the condition list), both tools run under the same stubs inside
their module namespaces, so the scores are a fixed function of the
operating point and the scenes; where it is about what the tool computes
(a condition's poses, the oracle's four arms), both run on the same numpy
scenes or prepared batches (`tests/torch_golden.py::label_prepared`).

Tolerances: the rewritten jsons byte-equal; a condition's poses within
1e-4 (yaw as an angle) and its scores within 1e-4, detections equal; the
oracle's rows, rounded to 4 decimals by both tools, within 2e-4 (1e-4 and
half a unit of the rounding on each side), detection rates equal.
"""

import dataclasses
import json
import os
import shutil
import zlib

import jax
import numpy as np
import pytest
from flax import nnx

import tpufusion.tools.detector_envelope as ref_envelope
import tpufusion.tools.fit_oracle_sensitivity as ref_oracle
import tpufusion.tools.train_synthetic_detector as ref_trainer
import tpufusion.tools.tune_detector_asset as ref_tuner
from tests.torch_golden import (
    ASSET,
    MIXED_ASSET,
    YAW_ASSET,
    asset_configs,
    jax_asset_model,
    jax_prepared,
    label_prepared,
    port_asset_model,
    to_jax_config,
    to_port_config,
    wrapped_pose_diff,
)
from tpufusion.config import DEFAULT as JAX_DEFAULT
from tpufusion_torch.config import DEFAULT, RangeViewSpec
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.tools import detector_envelope as envelope
from tpufusion_torch.tools import fit_oracle_sensitivity as oracle
from tpufusion_torch.tools import tune_detector_asset as tuner

SMALL = RangeViewSpec(res_h_deg=1.8)  # 32 x 201
POSE_ATOL = 1e-4
SCORE_ATOL = 1e-4
ROUNDED_ATOL = 2e-4


def _copy_asset(src: str, dst_dir) -> str:
    dst = os.path.join(dst_dir, os.path.basename(src))
    os.makedirs(dst_dir, exist_ok=True)
    for ext in ("", ".json"):
        shutil.copyfile(src + ext, dst + ext)
    return dst


# -- the tuner ----------------------------------------------------------------------------

def _scores(dcfg, n_points, seed, scenes, center) -> dict:
    """Fixed pseudo-random scores of an operating point on a scene set."""
    key = repr((round(dcfg.min_prob, 6), dcfg.min_bbox_area, center, seed, n_points, scenes,
                dcfg.direct_yaw_frame, dcfg.fit_boundary, dcfg.fit_surface_scale))
    v = np.random.default_rng(zlib.crc32(key.encode())).uniform(0.0, 1.0, 6)
    return {"det": float(v[0]), "xy_err": float(3 * v[1]), "within2m": float(v[2]),
            "mean_iou": float(v[3]), "recall_iou25": float(v[4]), "yaw_err": float(v[5]),
            "score": float(v[0] * (v[2] + v[4] + 2 * v[3]))}


def _stub_tuner(monkeypatch, module, calls, takes_state):
    """The sweep's prepare / evaluate replaced by `_scores`; `calls`
    records each evaluation's (n_points, seed, scenes, prepared's key)."""
    def prepare(*args, **kw):
        n_points = args[4 if takes_state else 3]
        return ("prepared", n_points, kw["seed"], kw["scenes"])

    def evaluate(*args, **kw):
        dcfg, n_points = args[3 if takes_state else 2], args[5 if takes_state else 4]
        prepared = kw["prepared"]
        if prepared is not None:
            assert prepared == ("prepared", n_points, kw["seed"], kw["scenes"])
        calls.append((n_points, kw["seed"], kw["scenes"], prepared is not None))
        return _scores(dcfg, n_points, kw["seed"], kw["scenes"], kw["center"])

    monkeypatch.setattr(module, "prepare_eval_batches", prepare)
    monkeypatch.setattr(module, "evaluate", evaluate)


@pytest.mark.parametrize("asset", [ASSET, MIXED_ASSET], ids=["flagship", "mixed"])
def test_both_tuners_write_equal_jsons(asset, tmp_path, monkeypatch):
    """The 4 x 4 x 7 sweep, the confirmation on seeds 5999, and the
    per-resolution pass at 16,384 and 32,768 points, with the same scores
    in both tools: the rewritten jsons are byte-equal and keep every key
    the tuner does not set."""
    calls = {"port": [], "ref": []}
    paths = {tag: _copy_asset(asset, tmp_path / tag) for tag in calls}
    _stub_tuner(monkeypatch, tuner, calls["port"], takes_state=False)
    _stub_tuner(monkeypatch, ref_tuner, calls["ref"], takes_state=True)
    extra = ["--per_resolution", "16384,32768", "--eval_batches", "1"]
    out = tuner.main(["--asset", paths["port"], "--device", "cpu"] + extra)
    ref_tuner.main(["--asset", paths["ref"]] + extra)
    assert calls["port"] == calls["ref"]
    families = 3 if asset == MIXED_ASSET else 1
    assert len(calls["port"]) == families * (4 * 4 * 7 + 1 + 2 * (8 * 2 + 1))
    got, want = (open(paths[t] + ".json", "rb").read() for t in ("port", "ref"))
    assert got == want
    before, after = json.load(open(asset + ".json")), json.loads(got)
    kept = set(before) - {"decode", "best", "confirmation", "decode_per_resolution"}
    assert kept and all(after[k] == before[k] for k in kept)
    assert sorted(after["decode_per_resolution"]) == ["16384", "32768"]
    assert out["best"] == max(out["rows"], key=lambda r: r["score"])


def test_tuner_never_rewrites_a_json_of_the_jax_package(monkeypatch):
    """--write (the default) on an asset under tpufusion/ raises before any
    sweep; --no-write reads it and leaves it as it was."""
    def fail(*a, **k):
        raise AssertionError("the sweep started")

    monkeypatch.setattr(tuner, "prepare_eval_batches", fail)
    with pytest.raises(ValueError, match="copy the asset"):
        tuner.main(["--asset", ASSET, "--device", "cpu"])
    calls = []
    _stub_tuner(monkeypatch, tuner, calls, takes_state=False)
    before = open(ASSET + ".json", "rb").read()
    tuner.main(["--asset", ASSET, "--no-write", "--eval_batches", "1", "--device", "cpu"])
    assert calls and open(ASSET + ".json", "rb").read() == before


# -- the envelope ---------------------------------------------------------------------------

def _numpy_scenes(key, batch, **kw):
    """The reference's synthesize_beam_scan_batch drawing the port's numpy
    scenes from the key's seed number."""
    seed = int(np.asarray(jax.random.key_data(key))[-1])
    return synthesize_beam_scan_batch(np.random.default_rng(seed), batch, **kw)


def test_run_condition_matches_the_reference_on_shared_scenes(monkeypatch):
    """One condition (ellipse vehicles, clutter x2, yaw +-0.2 at 32,768
    points), 2 batches of 3 frames through the flagship's float32 FCN and
    its decode at the full 32 x 1801 range view."""
    monkeypatch.setattr(ref_envelope, "synthesize_beam_scan_batch", _numpy_scenes)
    _, dcfg = asset_configs()
    kw = dict(n_points=32768, max_yaw=0.2, vehicle_surface="ellipse", n_clutter=48)
    graphdef, state = nnx.split(jax_asset_model())
    want_sc, want_poses, want_extra = ref_envelope.run_condition(
        graphdef, state, to_jax_config(dcfg), "direct", n_batches=2, batch=3, seed=41, **kw)
    got_sc, got_poses, got_extra = envelope.run_condition(
        port_asset_model(), dcfg, "direct", n_batches=2, batch=3, seed=41, device="cpu", **kw)
    np.testing.assert_array_equal(got_extra["truth"], want_extra["truth"])
    found = ~np.all(want_poses[:, :3] == 0, axis=1)
    np.testing.assert_array_equal(~np.all(got_poses[:, :3] == 0, axis=1), found)
    assert found.sum() >= 4
    assert float(wrapped_pose_diff(got_poses, want_poses).max()) <= POSE_ATOL
    assert sorted(got_sc) == sorted(want_sc) and got_sc["detection_rate"] == want_sc["detection_rate"]
    for k in want_sc:
        np.testing.assert_allclose(got_sc[k], want_sc[k], rtol=0, atol=SCORE_ATOL, err_msg=k)
    with pytest.raises(ValueError, match="direct-pose head"):
        envelope.run_condition(None, dcfg, "corner")


def _fake_condition(kw, n):
    """Fixed pseudo-random (scores, poses, {"truth"}) of a condition."""
    r = np.random.default_rng(zlib.crc32(repr(sorted(kw.items())).encode()))
    truth = np.concatenate([r.uniform(-30, 30, (n, 2)), np.full((n, 1), -0.7),
                            r.uniform(-0.4, 0.4, (n, 1)), np.tile([4.2, 1.6, 1.5], (n, 1))], 1)
    poses = truth + r.normal(0, 0.3, truth.shape)
    poses[::5] = 0.0  # misses
    sc = {"detection_rate": float(r.uniform()), "mean_iou": float(r.uniform()),
          "recall@iou0.25": float(r.uniform()), "mean_xy_err": float(r.uniform())}
    return sc, poses.astype(np.float32), {"truth": truth.astype(np.float32)}


@pytest.mark.parametrize("asset", [ASSET, MIXED_ASSET, YAW_ASSET],
                         ids=["flagship", "mixed", "wide_yaw"])
def test_envelope_runs_the_references_conditions(asset, monkeypatch):
    """Both mains under a stubbed run_condition: the same 14 conditions in
    the same order, each with the same decode config (the asset's json and
    its per-resolution table), and equal rows, the distance quartiles
    included."""
    calls = {"port": [], "ref": []}
    _, dcfg = asset_configs(asset)

    def record(tag, n_model_args, convert):
        def run(*args, n_batches=4, batch=32, seed=999, **kw):
            cond_dcfg, head = args[n_model_args:]
            kw.pop("device", None)
            calls[tag].append((dict(kw), convert(cond_dcfg), n_batches, batch, seed, head))
            return _fake_condition(kw, n_batches * batch)
        return run

    monkeypatch.setattr(envelope, "run_condition", record("port", 1, lambda c: c))
    monkeypatch.setattr(ref_envelope, "run_condition", record("ref", 2, to_port_config))
    monkeypatch.setattr(ref_envelope, "_load_asset",
                        lambda path: (None, None, to_jax_config(dcfg), "direct"))
    argv = ["--asset", asset, "--batch", "8", "--eval_batches", "2"]
    got = envelope.main(argv + ["--device", "cpu"])
    want = ref_envelope.main(argv)
    assert len(calls["port"]) == 14 and calls["port"] == calls["ref"]
    assert got == want and len(got) == 18


# -- the oracle arms ------------------------------------------------------------------------

def test_oracle_arms_match_the_reference(monkeypatch):
    """The four arms of both tools on the same prepared batches (the mixed
    asset's decode config, label-derived dual-codec maps of 6 box scenes
    at yaw +-0.4 on the 32 x 201 range view): the same four decode
    configs, and the same rows."""
    _, dcfg = asset_configs(MIXED_ASSET)
    dcfg = dataclasses.replace(dcfg, min_bbox_area=2.0)
    prepared = label_prepared(17, 1, 6, SMALL, yaw_frame="both", scenes="beam-box", max_yaw=0.4)
    seen = {"port": [], "ref": []}

    def recording(tag, evaluate, convert):
        def run(*args, **kw):
            seen[tag].append(convert(args[3 if tag == "ref" else 2]))
            return evaluate(*args, **kw)
        return run

    def port_prepare(model, spec, batch, **kw):
        assert spec == SMALL and batch == 6 and kw["scenes"] == "beam-box"
        assert kw["max_yaw"] == 0.4 and kw["seed"] == 999 and kw["n_batches"] == 1
        return prepared

    monkeypatch.setattr(oracle, "DEFAULT", DEFAULT.replace(range_view=SMALL))
    monkeypatch.setattr(oracle, "asset_model", lambda path: (None, dcfg, "direct"))
    monkeypatch.setattr(oracle, "prepare_eval_batches", port_prepare)
    monkeypatch.setattr(oracle, "evaluate", recording("port", oracle.evaluate, lambda c: c))
    monkeypatch.setattr(ref_oracle, "DEFAULT", JAX_DEFAULT.replace(range_view=to_jax_config(SMALL)))
    monkeypatch.setattr(ref_envelope, "_load_asset",
                        lambda path: (None, None, to_jax_config(dcfg), "direct"))
    monkeypatch.setattr(ref_trainer, "prepare_eval_batches",
                        lambda *a, **k: jax_prepared(prepared))
    monkeypatch.setattr(ref_trainer, "evaluate",
                        recording("ref", ref_trainer.evaluate, to_port_config))
    argv = ["--asset", MIXED_ASSET, "--batch", "6", "--eval_batches", "1"]
    got = oracle.main(argv + ["--device", "cpu"])
    want = ref_oracle.main(argv)
    assert seen["port"] == seen["ref"] == list(oracle.arms(dcfg).values())
    assert list(got) == list(want) == ["fit:box", "fit:ellipse", "fit:circle", "consensus"]
    for arm in want:
        assert got[arm]["det"] == want[arm]["det"] and want[arm]["det"] >= 0.5
        for k in want[arm]:
            np.testing.assert_allclose(got[arm][k], want[arm][k], rtol=0, atol=ROUNDED_ATOL,
                                       err_msg=f"{arm} {k}")
