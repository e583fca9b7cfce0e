"""The CLI's seven host-tool subcommands (calibrate, diff, analyze,
overlay_radar, crops, edges, view) against the JAX CLI's: both `cli.main`s
on the same files, their stdout JSON, their exit codes and the files they
write compared. Tolerance: none (the same numpy, scipy, cv2 and
matplotlib calls on the same inputs); `view` prints its ephemeral port,
which is masked.
"""

import csv
import json
import re

import cv2
import numpy as np
import pytest
import yaml

from tests.conftest import synthetic_cloud
from tpufusion import cli as jax_cli
from tpufusion_torch import cli as port_cli
from tpufusion_torch.geometry.camera import synthetic_camera


def _run(main, argv, capsys):
    """(exit code, stdout) of one cli.main."""
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    return code, capsys.readouterr().out


def _both(argv_of, capsys, tmp_path):
    """Runs both CLIs, each with its own output directory under tmp_path;
    returns {tag: (code, stdout, {file name: bytes})}."""
    out = {}
    for tag, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = tmp_path / f"out_{tag}"
        d.mkdir(parents=True)
        code, stdout = _run(main, argv_of(str(d)), capsys)
        files = {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}
        out[tag] = (code, stdout.replace(str(d), "OUT"), files)
    return out


def _camera_frames(tmp_path, n=3, seed=3):
    rng = np.random.default_rng(seed)
    np.savez(tmp_path / "camera_frames.npz", images=rng.integers(0, 120, (n, 512, 1368), np.uint8),
             timestamps=np.arange(n, dtype=np.int64) * 1000 + 10)
    return str(tmp_path / "camera_frames.npz")


def test_calibrate_subcommand_matches_jax(tmp_path, capsys):
    cam = synthetic_camera(640, 480, 500.0)
    true = np.array([0.2, -0.1, 0.3, 0.4, -0.2, 0.1])
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-3, 3, 10), rng.uniform(-2, 2, 10), rng.uniform(4, 12, 10)], 1)
    truth = synthetic_camera(640, 480, 500.0)
    truth.set_extrinsic_from_euler(true[:3], true[3:])
    uvs = truth.project_lidar_to_pixels(pts)
    (tmp_path / "cam.yaml").write_text(yaml.dump({
        "image_width": 640, "image_height": 480, "camera_matrix": {"data": cam.K.ravel().tolist()},
        "distortion_coefficients": {"data": [0.0] * 5},
        "rectification_matrix": {"data": np.eye(3).ravel().tolist()},
        "projection_matrix": {"data": cam.P.ravel().tolist()}}))
    settings = {"points": pts.tolist(), "uvs": uvs.tolist(),
                "bounds": [[-1, 1]] * 6}  # the reference's order: t then r
    (tmp_path / "s.json").write_text(json.dumps(settings) + "\n// trailing comment\n")
    res = _both(lambda d: ["calibrate", str(tmp_path / "s.json"), str(tmp_path / "cam.yaml")],
                capsys, tmp_path)
    assert res["port"] == res["jax"]
    report = json.loads(res["port"][1])
    assert report["accepted"] and report["error_px"] < 30.0


def _write_ts(d, name, values):
    d.mkdir(exist_ok=True)
    (d / name).write_text("timestamp\n" + "\n".join(map(str, values)) + "\n")


def test_diff_subcommand_matches_jax(tmp_path, capsys):
    ts = (np.arange(20) * 100_000_000).tolist()
    for name, lidar in (("a", ts), ("b", ts), ("c", ts[:-1])):
        _write_ts(tmp_path / name, "lidar_timestamps.csv", lidar)
        _write_ts(tmp_path / name, "camera_timestamps.csv", ts[::2])
    same = _both(lambda d: ["diff", str(tmp_path / "a"), str(tmp_path / "b")], capsys, tmp_path / "x")
    assert same["port"] == same["jax"] and same["port"][0] == 0 and same["port"][1] == ""
    differ = _both(lambda d: ["diff", str(tmp_path / "a"), str(tmp_path / "c"), "--rel_tol", "0.01"],
                   capsys, tmp_path / "y")
    assert differ["port"] == differ["jax"] and differ["port"][0] == 1
    assert differ["port"][1].startswith("lidar count 20 19")


def test_analyze_subcommand_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    with open(tmp_path / "poses.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["timestamp", "tx", "ty", "tz", "rx", "ry", "rz"])
        for i in range(40):
            w.writerow([i, *rng.uniform(-40, 40, 2).round(4), -0.7, 0, 0, 0.1])
    res = _both(lambda d: ["analyze", str(tmp_path / "poses.csv"), "--output", f"{d}/gt.png"],
                capsys, tmp_path)
    assert res["port"] == res["jax"]
    assert json.loads(res["port"][1]) == {"frames": 40, "plot": "OUT/gt.png"}
    assert list(res["port"][2]) == ["gt.png"]


def test_overlay_radar_subcommand_matches_jax(tmp_path, capsys):
    frames = _camera_frames(tmp_path)
    with open(tmp_path / "radar.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["timestamp", "range", "angle", "rate", "status"])
        w.writeheader()
        for ts, rng_m, angle in ((5, 15.0, 0.0), (1008, 25.0, -2.0), (1015, 12.0, 3.0), (2400, 8.0, 1.0)):
            w.writerow({"timestamp": ts, "range": rng_m, "angle": angle, "rate": 0.0, "status": 3})
    res = _both(lambda d: ["overlay_radar", frames, str(tmp_path / "radar.csv"), d, "--crop_top", "256"],
                capsys, tmp_path)
    assert res["port"] == res["jax"]
    assert json.loads(res["port"][1])["frames"] == 3 and len(res["port"][2]) == 3


def test_crops_subcommand_matches_jax(tmp_path, capsys):
    frames = _camera_frames(tmp_path, seed=4)
    with open(tmp_path / "poses.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["timestamp", "tx", "ty", "tz", "rx", "ry", "rz"])
        w.writerow([10, 12.0, 1.0, -0.7, 0, 0, 0])
        w.writerow([1010, 0.0, 0.0, 0.0, 0, 0, 0])  # no detection
        w.writerow([2010, 20.0, -2.0, -0.7, 0, 0, 0.3])
    res = _both(lambda d: ["crops", frames, str(tmp_path / "poses.csv"), d, "--crop_top", "256",
                           "--tag", "run 1"], capsys, tmp_path)
    assert res["port"] == res["jax"]
    assert sorted(res["port"][2]) == ["Car_run-1_00000.jpg", "Car_run-1_00002.jpg"]


def test_edges_subcommand_matches_jax(tmp_path, capsys):
    img = np.random.default_rng(5).integers(0, 60, (64, 96), np.uint8)
    img[20:40, 20:60] = 255
    cv2.imwrite(str(tmp_path / "in.png"), img)
    res = _both(lambda d: ["edges", str(tmp_path / "in.png"), f"{d}/edges.png", "--t1", "80"],
                capsys, tmp_path)
    assert res["port"] == res["jax"] and res["port"][0] == 0
    missing = _both(lambda d: ["edges", str(tmp_path / "none.png"), f"{d}/e.png"], capsys,
                    tmp_path / "m")
    assert missing["port"][0] == missing["jax"][0] == 1


def test_edges_subcommand_reports_an_unreadable_input_as_the_reference(tmp_path):
    for main in (jax_cli.main, port_cli.main):
        with pytest.raises(SystemExit, match="cannot read"):
            main(["edges", str(tmp_path / "none.png"), str(tmp_path / "e.png")])


def test_view_subcommand_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(6)
    pts = np.stack([synthetic_cloud(rng, n=2048) for _ in range(2)])
    np.savez(tmp_path / "raw.npz", points=pts)
    res = _both(lambda d: ["view", str(tmp_path / "raw.npz"), "--port", "0", "--rate", "1000"]
                + (["--device", "cpu"] if d.endswith("out_port") else []), capsys, tmp_path)
    masked = {k: (c, re.sub(r"localhost:\d+", "localhost:PORT", out), f)
              for k, (c, out, f) in res.items()}
    assert masked["port"] == masked["jax"]
    assert masked["port"][0] == 0 and "(2 frames at 1000.0 Hz)" in masked["port"][1]


def test_subcommands_and_flags_are_the_references():
    """Every subcommand of the JAX CLI, each with the reference's flags and
    defaults; the port adds `--device` where tensors run."""
    def parsers(main):
        import argparse

        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            for action in self._actions:
                if isinstance(action, argparse._SubParsersAction):
                    for name, sub in action.choices.items():
                        seen[name] = {a.dest: (a.default, a.option_strings, a.nargs, a.type)
                                      for a in sub._actions if a.dest != "help"}
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main(["--help"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    want, got = parsers(jax_cli.main), parsers(port_cli.main)
    assert sorted(got) == sorted(want)
    for name in want:
        extra = {k: v for k, v in got[name].items() if k not in want[name]}
        assert {k: got[name][k] for k in want[name]} == want[name], name
        assert set(extra) <= {"device"}, name
        if "device" in extra:
            assert extra["device"][0] == "cuda"
    assert {n for n in got if "device" in got[n]} == {"train", "predict", "extract", "view"}
