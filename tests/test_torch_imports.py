"""The port stands alone: it imports nothing of the JAX package.

`tpufusion_torch` and `chip_smoke.py` run on a machine without JAX, and
keep their own copies of what they need from the JAX package (the config
dataclasses, the numpy tracker and scoring). These tests hold the port to
that and hold each copy equal to its original. Tolerance for the scoring:
1e-6 (the copy runs the same float64 numpy code, so it reads 0).
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tpufusion.config as jax_config
import tpufusion_torch.config as port_config
from tests.torch_golden import REPO, to_jax_config, to_port_config
from tpufusion.eval import scoring as jax_scoring
from tpufusion_torch.eval import scoring as port_scoring

PORT_DIR = os.path.join(REPO, "tpufusion_torch")
CONFIG_CLASSES = sorted(
    name for name, obj in vars(port_config).items()
    if dataclasses.is_dataclass(obj) and obj.__module__ == port_config.__name__
)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _is_jax_package(module: str | None) -> bool:
    return module is not None and (module == "tpufusion" or module.startswith("tpufusion."))


def test_importing_every_port_module_loads_no_jax_package():
    """In a fresh interpreter, import every module of tpufusion_torch:
    neither tpufusion nor jax nor flax is loaded."""
    code = textwrap.dedent(
        """
        import pkgutil, sys
        import tpufusion_torch
        names = [m.name for m in pkgutil.walk_packages(tpufusion_torch.__path__, "tpufusion_torch.")]
        for name in names:
            __import__(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("tpufusion", "jax", "flax"))
        assert not bad, bad
        print("IMPORTED", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split("IMPORTED")[1]) >= 20


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_never_imports_the_jax_package(path):
    """AST scan: no `import tpufusion...`, no `from tpufusion... import`,
    and no importlib / __import__ / exec loading of other files."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not _is_jax_package(alias.name), (path, node.lineno)
                assert alias.name.split(".")[0] not in ("importlib", "runpy"), (path, node.lineno)
        elif isinstance(node, ast.ImportFrom):
            assert not _is_jax_package(node.module), (path, node.lineno)
            assert (node.module or "").split(".")[0] not in ("importlib", "runpy"), (path, node.lineno)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id not in ("__import__", "exec"), (path, node.lineno)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_has_the_reference_fields_and_defaults(name):
    port_cls, jax_cls = getattr(port_config, name), getattr(jax_config, name)
    got = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(port_cls)]
    want = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(jax_cls)]
    # nested defaults are instances of each package's own class: compare by value
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (field, _, g, gf), (_, _, w, wf) in zip(got, want):
        if dataclasses.is_dataclass(w):
            assert to_port_config(w) == g, field
        else:
            assert g == w and gf == wf, field
    assert port_cls.__dataclass_params__.frozen and jax_cls.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [{}, {"res_h_deg": 1.8}, {"res_v_deg": 2.0, "vfov_lo_deg": -25.0}])
def test_range_view_spec_derived_values_match(kw):
    port, ref = port_config.RangeViewSpec(**kw), jax_config.RangeViewSpec(**kw)
    for prop in ("res_v_rad", "res_h_rad", "x_min", "y_min", "x_max", "y_max", "width", "height"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    bev_p, bev_j = port_config.BevSpec(), jax_config.BevSpec()
    assert (bev_p.nx, bev_p.ny) == (bev_j.nx, bev_j.ny)


def test_default_pipeline_config_round_trips():
    """DEFAULT and PipelineConfig.replace match, and the converters each
    way give the other package's classes with equal values."""
    assert to_port_config(jax_config.DEFAULT) == port_config.DEFAULT
    assert to_jax_config(port_config.DEFAULT) == jax_config.DEFAULT
    dcfg = port_config.DecodeConfig(min_prob=0.8)
    changed = port_config.DEFAULT.replace(decode=dcfg)
    assert type(changed.decode) is port_config.DecodeConfig and changed.decode.min_prob == 0.8
    assert type(to_jax_config(changed).decode) is jax_config.DecodeConfig
    assert to_jax_config(changed) == jax_config.DEFAULT.replace(decode=to_jax_config(dcfg))


def _poses(seed, frames=12, k=4, vehicles=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-30, 30, (frames, vehicles, 3))
    yaws = rng.uniform(-np.pi, np.pi, (frames, vehicles))
    sizes = np.tile([4.2, 1.6, 1.5], (frames, vehicles, 1)) + rng.normal(0, 0.1, (frames, vehicles, 3))
    poses = np.zeros((frames, k, 7))
    poses[:, :vehicles, :3] = centers + rng.normal(0, 0.8, centers.shape)
    poses[:, :vehicles, 3] = yaws + rng.normal(0, 0.3, yaws.shape)
    poses[:, :vehicles, 4:] = sizes
    poses[:, vehicles:] = rng.uniform(-30, 30, (frames, k - vehicles, 7))  # clutter
    found = rng.random((frames, k)) < 0.8
    return poses.astype(np.float32), found, centers, yaws, sizes


@pytest.mark.parametrize("pose_frame", ["orbit", "physical"])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_multi_poses_matches_the_reference(seed, pose_frame):
    poses, found, centers, yaws, sizes = _poses(seed)
    got = port_scoring.score_multi_poses(poses, found, centers, yaws, sizes, pose_frame=pose_frame)
    want = jax_scoring.score_multi_poses(poses, found, centers, yaws, sizes, pose_frame=pose_frame)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert want["box_recall"] > 0


def test_scoring_helpers_match_the_reference():
    poses, *_ = _poses(2)
    flat = poses.reshape(-1, 7)
    for fn in ("orbit_to_physical", "physical_to_orbit"):
        np.testing.assert_allclose(
            getattr(port_scoring, fn)(poses), getattr(jax_scoring, fn)(poses), rtol=0, atol=1e-6
        )
    for a, b in zip(flat[:-1], flat[1:]):
        assert abs(port_scoring.box_iou_3d(a, b) - jax_scoring.box_iou_3d(a, b)) <= 1e-6
        assert port_scoring.pose_errors(a, b) == jax_scoring.pose_errors(a, b)
    same = flat[0].copy()
    assert port_scoring.box_iou_3d(same, same) == pytest.approx(1.0)
