"""The port's CLI (`tpufusion_torch/cli.py`: extract, train, predict,
submit, score) against the JAX package's, and a short real chain on the CPU.

Both CLIs parse the same command lines into the same arguments (the port
adds `--device`). Both `train` subcommands run on one extracted dataset
with `Trainer` replaced by a stub in this file (no package file changes):
the config (as a dict) and the arrays each hands its `Trainer` are equal,
for the lidar source with either head and for `--source camera`. Then the
port's chain runs for real through `tools/rehearse_bag_pipeline.py`: a bag
of 8 beam scans -> extract -> train (1 epoch, batch 4) -> predict ->
submit -> score at 32 x 1801 on the CPU; its submission XML carries every
frame. Tolerance: none (equal configs, equal arrays, equal parsed
arguments).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import tpufusion.cli as jax_cli
import tpufusion_torch.cli as port_cli
from tpufusion_torch.data.etl import extract_bag_dataset, load_extracted
from tpufusion_torch.eval.tracklet_xml import parse_tracklet_xml
from tpufusion_torch.tools import rehearse_bag_pipeline

_CAMERA_YAML = """
image_width: 1368
image_height: 1096
camera_matrix: {rows: 3, cols: 3, data: [1384.6, 0.0, 697.8, 0.0, 1393.5, 544.2, 0.0, 0.0, 1.0]}
distortion_coefficients: {rows: 1, cols: 5, data: [-0.152, 0.097, 0.002, -0.001, 0.0]}
rectification_matrix: {rows: 3, cols: 3, data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]}
projection_matrix: {rows: 3, cols: 4, data: [1300.1, 0.0, 700.2, 0.0, 0.0, 1350.5, 541.9, 0.0, 0.0, 0.0, 1.0, 0.0]}
"""
_LIDAR2CAM_YAML = """
translation: {data: [0.3, -0.1, -0.4]}
euler_rotations: {data: [-1.55, 0.02, -1.58]}
"""

_ARGVS = {
    "train": ["train", "--train_file", "r.csv"],
    "train (every flag)": ["train", "--train_file", "r.csv", "--val_file", "v.csv", "--dir_prefix", "p",
                           "--outdir", "o", "--batch_size", "3", "--epochs", "2", "--lr", "0.5",
                           "--lr_schedule", "cosine", "--lr_decay_steps", "9", "--resume",
                           "--source", "camera", "--head", "direct", "--camera_yaml", "c.yaml",
                           "--extrinsic_yaml", "e.yaml", "--crop_top", "12"],
    "predict": ["predict", "ds"],
    "predict (every flag)": ["predict", "ds", "--checkpoint", "ck", "--output_dir", "o",
                             "--batch_size", "5", "--head", "direct"],
    "submit": ["submit", "p.csv", "c.csv", "o.xml", "--l", "4", "--w", "2", "--h", "1.5"],
    "submit (offset)": ["submit", "p.csv", "c.csv", "o.xml", "--l", "4", "--w", "2", "--h", "1.5",
                        "--offset", "0.1", "0.2", "0.3"],
    "score": ["score", "p.csv", "t.csv"],
    "score (every flag)": ["score", "p.csv", "t.csv", "--l", "4", "--w", "2", "--h", "1",
                           "--pose_frame", "physical"],
    "extract": ["extract", "x.bag", "ds"],
    "extract (every flag)": ["extract", "x.bag", "ds", "--tracklet", "t.xml", "--camera_yaml", "c",
                             "--extrinsic_yaml", "e", "--crop_top", "1", "--crop_bottom", "9",
                             "--no-streaming", "--png"],
}


def _parsed(cli, argv, monkeypatch):
    seen = {}
    name = argv[0]
    monkeypatch.setattr(cli, f"_cmd_{name}", lambda args: seen.update(vars(args)))
    cli.main(argv)
    seen.pop("fn")
    return seen


@pytest.mark.parametrize("case", sorted(_ARGVS))
def test_the_parser_keeps_the_reference_flags_and_defaults(case, monkeypatch):
    argv = _ARGVS[case]
    got = _parsed(port_cli, argv, monkeypatch)
    want = _parsed(jax_cli, argv, monkeypatch)
    device = got.pop("device", None)
    assert got == want
    if argv[0] in ("train", "predict", "extract"):  # the subcommands that run tensors
        assert device == "cuda"
        assert _parsed(port_cli, argv + ["--device", "cpu"], monkeypatch)["device"] == "cpu"
    else:
        assert device is None


class _StubTrainer:
    """Records what a CLI hands its trainer, and trains nothing."""

    calls: list = []

    def __init__(self, cfg, model=None, outdir="./runs/default", in_channels=3, **kw):
        self.record = {"cfg": dataclasses.asdict(cfg), "outdir": outdir,
                       "in_channels": in_channels, "resumed": False}
        _StubTrainer.calls.append(self.record)

    def resume(self):
        self.record["resumed"] = True
        return False

    def fit(self, train_pipe, val_pipe=None, epochs=None):
        self.record["train"] = {k: np.asarray(v) for k, v in train_pipe.data.items()}
        self.record["val"] = None if val_pipe is None else {
            k: np.asarray(v) for k, v in val_pipe.data.items()}
        self.record["batch_size"] = train_pipe.batch_size


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A registry of one extracted bag (6 beam scans, a camera stream, a
    tracklet) and the calibration YAMLs."""
    d = tmp_path_factory.mktemp("cli")
    meta = rehearse_bag_pipeline.synthesize_bag(str(d / "scene.bag"), 6, 4096, seed=3,
                                                cam_hw=(64, 80))
    extract_bag_dataset(str(d / "scene.bag"), str(d / "ds"), tracklet_xml=meta["gt_xml"],
                        crop=(10, 42), device="cpu")
    (d / "registry.csv").write_text("ds,meta.csv\n")
    (d / "meta.csv").write_text("l,w,h\n4.2,1.6,1.5\n")
    (d / "cam.yaml").write_text(_CAMERA_YAML)
    (d / "l2c.yaml").write_text(_LIDAR2CAM_YAML)
    return d


_TRAIN_CASES = {
    "lidar, corner head, a validation set": ["--val_file", "registry.csv"],
    "lidar, direct head, cosine, resume": ["--head", "direct", "--lr_schedule", "cosine",
                                           "--lr_decay_steps", "7", "--resume"],
    "camera source": ["--source", "camera", "--camera_yaml", "cam.yaml",
                      "--extrinsic_yaml", "l2c.yaml", "--crop_top", "10"],
}


@pytest.mark.parametrize("case", sorted(_TRAIN_CASES))
def test_train_hands_the_reference_config_and_arrays_to_its_trainer(dataset, case, monkeypatch):
    import tpufusion.train.trainer as jax_trainer
    import tpufusion_torch.train.trainer as port_trainer

    argv = ["train", "--train_file", str(dataset / "registry.csv"), "--dir_prefix", str(dataset),
            "--outdir", "run", "--batch_size", "4", "--epochs", "3", "--lr", "0.002"]
    argv += [str(dataset / a) if a.endswith((".csv", ".yaml")) else a for a in _TRAIN_CASES[case]]
    monkeypatch.setattr(jax_trainer, "Trainer", _StubTrainer)
    monkeypatch.setattr(port_trainer, "Trainer", _StubTrainer)
    _StubTrainer.calls = []
    jax_cli.main(argv)
    port_cli.main(argv + ["--device", "cpu"])
    want, got = _StubTrainer.calls
    for k in ("train", "val"):
        g, w = got.pop(k), want.pop(k)
        assert (g is None) == (w is None)
        if w is not None:
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got == want
    assert got["cfg"]["train"]["batch_size"] == 4 and got["in_channels"] == (
        1 if case == "camera source" else 3)


@pytest.mark.parametrize("head", ["direct", "corner"])
def test_the_port_chain_runs_on_the_cpu(tmp_path, head, capsys):
    """extract -> train (1 epoch) -> predict -> submit -> score through the
    port's CLI, at 32 x 1801, 8 frames, batch 4."""
    summary = rehearse_bag_pipeline.main(
        ["--frames", "8", "--n_points", "4096", "--epochs", "1", "--batch", "4", "--head", head,
         "--device", "cpu", "--workdir", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    poses = parse_tracklet_xml(str(tmp_path / "submission.xml"))[0].poses
    assert summary["submission_poses"] == len(poses) == 8
    assert all(np.isfinite([p[k] for k in ("tx", "ty", "tz", "rz")]).all() for p in poses)
    images = load_extracted(str(tmp_path / "ds"))["images"]
    assert images.shape == (8, 32, 1801, 3)
    ckpts = os.listdir(tmp_path / "run" / "ckpt")
    assert ckpts and all(c.startswith("ckpt_") and c.endswith(".pt") for c in ckpts)
    assert set(summary["score"]) >= {"detection_rate", "mean_iou", "mean_xy_err"}
    assert summary["timings_s"].keys() == {"setup", "synthesize_bag", "extract", "train", "predict",
                                           "submit", "score"}
    for r in summary["rss_mib"].values():
        assert r["rss_peak_mib"] >= r["rss_start_mib"] >= r["unshared_start_mib"] > 0
        assert r["rss_peak_mib"] >= r["unshared_peak_mib"] >= r["unshared_start_mib"]
