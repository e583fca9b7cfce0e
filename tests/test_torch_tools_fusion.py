"""The port's fusion training tool and camera bench (`tpufusion_torch/
tools/{train_fusion_synthetic,bench_camera_full}.py`) against the JAX
package's tools, on the CPU.

Tolerances: the held-out errors of the shipped fusion asset (float32)
within 1e-4 of the reference tool's on the same frames; the camera
dataset bit-equal (numpy in both tools: the same seed gives the same
bits). The tools' `main`s run at a few frames of the full 512 x 1368
camera.
"""

import json
import os

import numpy as np
import pytest
import torch
from flax import nnx

import tpufusion.config as jax_config
import tpufusion.tools.bench_camera_full as ref_camera
import tpufusion.tools.train_fusion_synthetic as ref_fusion
from tests.torch_golden import FUSION_ASSET, to_jax_config
from tpufusion.models.fusion import FusionNet as JaxFusionNet
from tpufusion.models.io import load_state_npz as jax_load_state_npz
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.data.synthetic import build_fusion_dataset
from tpufusion_torch.models.io import fusion_from_asset
from tpufusion_torch.tools import bench_camera_full as camera
from tpufusion_torch.tools import train_fusion_synthetic as fusion

ERR_ATOL = 1e-4


def test_fusion_evaluate_matches_the_reference():
    """Both tools' `evaluate` of the shipped fusion_net.npz (float32) on 3
    held-out frames made by the port's generator."""
    data = build_fusion_dataset(3, seed=12, n_points=8192, device="cpu")
    data = {k: data[k] for k in ("cam", "lidar", "radar", "centroid", "rz")}
    meta = json.load(open(FUSION_ASSET + ".json"))
    jnet = JaxFusionNet(
        lidar_model=jax_config.ModelConfig(),
        camera_model=jax_config.ModelConfig(vertical_stride=2, use_regression=False),
        camera=jax_config.CameraConfig(), lidar_pool=tuple(meta["lidar_pool"]),
        cam_pool=tuple(meta["cam_pool"]), rngs=nnx.Rngs(0))
    jax_load_state_npz(FUSION_ASSET, jnet)
    rows = np.arange(3)
    want = ref_fusion.evaluate(jnet, data, rows)
    got = fusion.evaluate(fusion_from_asset(FUSION_ASSET, "cpu", "float32"), data, rows, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ERR_ATOL, err_msg=k)
    assert got["xy_err"] < 3.0  # the trained net sees the vehicles


def test_the_dataset_cache_is_never_the_references(tmp_path, monkeypatch):
    """The same frames, seed, range view and camera give the two tools'
    caches other file names (the reference's holds jax.random's scenes),
    so neither loads the other's; the port reloads its own."""
    spec = RangeViewSpec()
    assert repr(spec) == repr(to_jax_config(spec)) and repr(fusion.CAM) == repr(ref_fusion.CAM)
    cache = tmp_path / "cache"
    build = ref_fusion.build_dataset

    def reference(n_frames, seed, spec, cache_dir=None):  # no generation: only the file name
        if cache_dir is None:
            return {"cam": np.zeros((n_frames, 1), np.float32)}
        return build(n_frames, seed, spec, cache_dir)

    monkeypatch.setattr(ref_fusion, "build_dataset", reference)
    ref_fusion.build_dataset(2, 11, to_jax_config(spec), cache_dir=str(cache))
    (ref_name,) = os.listdir(cache)
    data = fusion.build_dataset(2, 11, spec, cache_dir=str(cache), device="cpu")
    port_path = fusion.cache_path(str(cache), 2, 11, spec)
    assert sorted(os.listdir(cache)) == sorted([ref_name, os.path.basename(port_path)])
    assert os.path.basename(port_path) != ref_name
    assert ref_name.startswith("fusion_ds_2_11_") and os.path.basename(port_path).startswith(
        "fusion_ds_2_11_")
    again = fusion.build_dataset(2, 11, spec, cache_dir=str(cache), device="cpu")
    assert sorted(again) == sorted(data) == sorted(fusion._KEYS)
    for k in data:
        np.testing.assert_array_equal(again[k], data[k])
    assert data["cam"].shape == (2, 512, 1368, 1) and data["lidar"].shape == (2, 32, 1801, 3)


def test_fusion_main_trains_both_variants_and_writes_the_asset(tmp_path):
    """4 training and 2 held-out frames, 1 epoch at batch 2: both variants,
    the float16 fused asset `fusion_from_asset` loads, the json the
    reference writes; a rerun of one variant merges into it."""
    out, cache = str(tmp_path / "fusion.npz"), str(tmp_path / "cache")
    argv = ["--train_frames", "4", "--eval_frames", "2", "--epochs", "1", "--batch", "2",
            "--out", out, "--cache_dir", cache, "--device", "cpu"]
    results = fusion.main(argv)
    assert sorted(results) == ["fused", "lidar_only", "radar_range_noise"]
    with np.load(out) as z:
        assert all(z[k].dtype == np.float16 for k in z.files if "kernel" in k)
    meta = json.load(open(out + ".json"))
    assert meta["camera"]["width"] == 1368 and meta["lidar_pool"] == [2, 8]
    assert meta["cam_pool"] == [8, 8] and meta["epochs"] == 1
    net = fusion_from_asset(out, "cpu")
    assert net.cam_branch.dense1.kernel.shape == (21888, 96)
    fused = meta["results"]["fused"]
    fusion.main(argv + ["--variants", "lidar_only"])
    assert json.load(open(out + ".json"))["results"]["fused"] == fused
    with pytest.raises(ValueError, match="JAX package"):
        fusion.main(["--out", os.path.join(os.path.dirname(FUSION_ASSET), "x.npz")])


def test_camera_dataset_is_bit_equal_to_the_references():
    frames, labels = camera.build_camera_dataset(3, seed=31)
    want_frames, want_labels = ref_camera.build_camera_dataset(3, seed=31)
    assert frames.shape == (3, 512, 1368, 1) and labels.shape == (3, 512, 1368, 2)
    np.testing.assert_array_equal(frames, want_frames)
    np.testing.assert_array_equal(labels, want_labels)
    assert labels[..., 1].sum() > 0


def test_bench_camera_full_runs_on_the_cpu():
    """Two frames, batch 1: the timed steps (host clock here) and one
    convergence step; the row says where it ran."""
    torch.manual_seed(0)
    out = camera.main(["--frames", "2", "--batch", "1", "--steps", "1", "--timing_batches", "1",
                       "--device", "cpu"])
    assert out["timer"] == "host clock" and out["device"] == "cpu" and "top_kernels" not in out
    assert out["steps"] == 1 and np.isfinite(out["loss_first"]) and out["ms_per_step"] > 0
