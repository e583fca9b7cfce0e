"""The reference's five projection methods in the port against JAX.

`PipelineConfig.projection_method` is a user's setting, and the JAX
package runs five values of it: "exact" (a 2-key sort), "pallas" (its
Pallas kernel, here in interpret mode), "scatter" (a two-pass
scatter-min), "sort16" (a packed-key sort within 2**15 points) and
"packed" (the throughput mode whose quantized key may give a near tie to
the lower index). The same numpy inputs go through JAX's
`range_view_project_batch` (eager) and the port's, on the CPU, where the
port's wrappers run their kernels' plain versions:

- every method on the bench golden's beam scans (N = 32,768), the
  reference's own `synthetic_cloud`s (seeds 0-2, 17,184 points) with and
  without its 1,024 jittered duplicates, clouds with NaN and inf points and
  padding at N = 32,769 (idx_bits 16), and 2 frames of 131,072 points;
  "sort16" raises AssertionError in both past 2**15 points;
- "packed" differs from "exact" in the same pixels as in JAX, and in at
  least one (beam scans alone cannot tell them apart, so a port that
  routed "packed" to the exact kernel fails here);
- the three functions of `ops/scatter.py` against JAX's on the same (pix,
  L2, valid), one frame and a batch;
- the shipped asset's `make_e2e_step(method="packed")`, and
  `LidarPipeline` / `ReplayHarness` with `projection_method="packed"` (on
  a corner head: JAX's server and replay drop `head`, so they decode the
  corner vote), against JAX;
- `make_e2e_step`'s default head is the reference's "corner";
- the packed golden (tests/data/torch_port_golden_packed.npz) is current;
- the packed wrapper never runs its plain version on a device tensor, and
  the A/B tool runs every method.

Tolerance: none for images (integer winner rules, the pixel arithmetic
bit for bit); POSE_ATOL (1e-4) on poses, `found` exactly; the default-head
step within the goldens' 1e-3.
"""

import functools
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_cloud
from tests.make_torch_port_golden import (
    PROJECTION_METHODS,
    golden_packed_arrays,
    hybrid_corner_arrays,
    jax_method_images,
    jax_packed_step,
)
from tests.torch_golden import (
    GOLDEN_BENCH,
    GOLDEN_PACKED,
    POSE_ATOL,
    asset_configs,
    jax_model_from_arrays,
    load_npz,
    port_asset_model,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.geometry import range_view as jrv
from tpufusion.ops import scatter as jscatter
from tpufusion_torch import RangeViewSpec
from tpufusion_torch._golden import near_tie_sets
from tpufusion_torch.config import DEFAULT
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry import range_view as trv
from tpufusion_torch.models.io import fcn_from_arrays
from tpufusion_torch.ops import parity_inputs, projection
from tpufusion_torch.ops import scatter as tscatter
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.pipeline import LidarPipeline
from tpufusion_torch.serve.replay import ReplayHarness
from tpufusion_torch.tools import bench_projection_ab

SPEC = RangeViewSpec()
JSPEC = to_jax_config(SPEC)
DEFAULT_HEAD_ATOL = 1e-3  # the goldens' pose limit (chip_smoke.POSE_TOL)


def _reference_clouds(dups: bool):
    """tests/test_geometry.py's packed-divergence inputs: synthetic_cloud
    seeds 0-2 (16,384 points and an 800-point vehicle), with its 1,024
    duplicates jittered by up to 1e-4 relative when `dups`."""
    frames = []
    for seed in range(3):
        r = np.random.default_rng(seed)
        pts = synthetic_cloud(r, n=16384, with_vehicle_at=(10.0, 2.0, -0.7)).astype(np.float32)
        if dups:
            dup = pts[:1024].copy()
            dup[:, :3] *= (1.0 + r.uniform(-1e-4, 1e-4, (1024, 1))).astype(np.float32)
            pts = np.concatenate([pts, dup], axis=0)
        frames.append(pts)
    return np.stack(frames), None


def _bench_frames():
    g = load_npz(GOLDEN_BENCH)
    return g["points"], g["valid"]


def _config5_frames():
    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(5), 2, 131072, n_beams=64)
    return pts, valid


INPUTS = {
    "bench_golden_32768": _bench_frames,
    "synthetic_cloud": lambda: _reference_clouds(False),
    "synthetic_cloud_near_ties": lambda: _reference_clouds(True),
    "nan_and_padding_32769": lambda: parity_inputs.nan_clouds(2, 32769, seed=4),
    "config5_131072": _config5_frames,
}


@functools.lru_cache(maxsize=None)
def _inputs(name: str):
    return INPUTS[name]()


@functools.lru_cache(maxsize=None)
def _jax_image(name: str, method: str) -> np.ndarray:
    points, valid = _inputs(name)
    return np.asarray(jrv.range_view_project_batch(
        jnp.asarray(points), JSPEC, None if valid is None else jnp.asarray(valid), method))


def _port_image(name: str, method: str) -> np.ndarray:
    points, valid = _inputs(name)
    return trv.range_view_project_batch(
        torch.from_numpy(points), SPEC, None if valid is None else torch.from_numpy(valid),
        method).numpy()


def _differing_pixels(images: dict) -> np.ndarray:
    return (images["packed"] != images["exact"]).any(axis=-1)


@pytest.mark.parametrize("method", PROJECTION_METHODS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_each_method_matches_jax(name, method):
    points, _ = _inputs(name)
    if method == "sort16" and points.shape[1] > 2**15:  # the reference's limit
        with pytest.raises(AssertionError, match="15 bits"):
            _jax_image(name, method)
        with pytest.raises(AssertionError, match="15 bits"):
            _port_image(name, method)
        return
    got, want = _port_image(name, method), _jax_image(name, method)
    assert got.shape == want.shape == (len(points), SPEC.height, SPEC.width, 3)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["synthetic_cloud", "synthetic_cloud_near_ties",
                                  "nan_and_padding_32769"])
def test_packed_differs_from_exact_where_jax_does(name):
    """JAX reads 4 / 5 / 5 pixels on the plain clouds and 259 / 264 / 270
    with the duplicates; the port the same pixels, in every frame."""
    want = _differing_pixels({m: _jax_image(name, m) for m in ("exact", "packed")})
    got = _differing_pixels({m: _port_image(name, m) for m in ("exact", "packed")})
    np.testing.assert_array_equal(got, want)
    assert want.sum(axis=(1, 2)).min() > 0, want.sum(axis=(1, 2))
    if name == "synthetic_cloud":
        assert want.sum(axis=(1, 2)).tolist() == [4, 5, 5]


def _scatter_args(batch: int):
    """JAX's (pix, l2, valid) of the near-tie clouds, a NaN point and a
    validity mask included."""
    points, _ = _inputs("synthetic_cloud_near_ties")
    points = points[:batch].copy()
    points[0, 7] = np.nan
    valid = np.random.default_rng(9).random(points.shape[:2]) > 0.1
    out = []
    for b in range(batch):
        pts = jnp.asarray(points[b])
        ok = jnp.all(jnp.isfinite(pts), axis=1) & jnp.asarray(valid[b])
        row, col, l2 = jrv.project_to_pixels(pts, JSPEC)
        out.append((np.asarray(row * SPEC.width + col), np.asarray(l2), np.asarray(ok)))
    return [np.stack(a) for a in zip(*out)]


@pytest.mark.parametrize("fn", ["nearest_wins_scatter", "nearest_wins_sort16",
                                "nearest_wins_scatter_packed"])
def test_scatter_functions_match_jax(fn):
    pix, l2, ok = _scatter_args(3)
    p = SPEC.height * SPEC.width
    want_w, want_o = (np.asarray(a) for a in jax.vmap(
        lambda a, b, c: getattr(jscatter, fn)(a, b, c, p))(pix, l2, ok))
    got_w, got_o = getattr(tscatter, fn)(*map(torch.from_numpy, (pix, l2, ok)), p)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    one_w, one_o = getattr(tscatter, fn)(*(torch.from_numpy(a[1]) for a in (pix, l2, ok)), p)
    np.testing.assert_array_equal(one_w.numpy(), want_w[1])
    np.testing.assert_array_equal(one_o.numpy(), want_o[1])
    if fn != "nearest_wins_scatter_packed":  # the exact rule: the sort's winners
        ref = jax.vmap(lambda a, b, c: jscatter.nearest_wins_sort(a, b, c, p))(pix, l2, ok)
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref[0]))


@pytest.mark.parametrize("case", ["points", "pixels"])
def test_sort16_refuses_where_jax_does(case):
    """Past 2**15 points, or a view of more than 2**16 - 1 pixels (a
    64-beam sensor's 63 x 1801 = 113,463), both packages assert."""
    spec = RangeViewSpec(res_v_deg=0.665) if case == "pixels" else SPEC
    n = 32769 if case == "points" else 4096
    points = (np.random.default_rng(2).standard_normal((1, n, 4)) * 20).astype(np.float32)
    with pytest.raises(AssertionError):
        jrv.range_view_project_batch(jnp.asarray(points), to_jax_config(spec), None, "sort16")
    with pytest.raises(AssertionError):
        trv.range_view_project_batch(torch.from_numpy(points), spec, None, "sort16")
    pix = torch.zeros((1, n), dtype=torch.int32)
    with pytest.raises(AssertionError):
        tscatter.nearest_wins_sort16(pix, pix.float(), pix == 0, spec.height * spec.width)
    assert spec.height * spec.width == (113463 if case == "pixels" else 57632)


@pytest.fixture(scope="module")
def near_tie_jax():
    """The packed golden's frame sets and JAX's answers on them: every
    method's images, and the asset's packed step on the long set."""
    bench = load_npz(GOLDEN_BENCH)
    sets = near_tie_sets(bench["points"], bench["valid"])
    images = {k: jax_method_images(*pv) for k, pv in sets.items()}
    return sets, images, jax_packed_step(*sets[""])


def test_packed_step_matches_jax(near_tie_jax):
    """The shipped asset's direct step with method="packed" on the
    near-tie frames (33,792 points a frame)."""
    sets, _, (want_poses, want_found) = near_tie_jax
    poses, found = make_e2e_step(port_asset_model(), SPEC, asset_configs()[1], "packed",
                                 head="direct", device="cpu")(*sets[""])
    np.testing.assert_array_equal(found.numpy(), want_found)
    assert want_found.all()
    assert wrapped_pose_diff(poses, want_poses).max() <= POSE_ATOL


def test_golden_packed_file_is_current(near_tie_jax):
    """The committed golden equals a fresh one: JAX's images under every
    method on both near-tie sets, and its packed step."""
    _, images, step = near_tie_jax
    fresh, golden = golden_packed_arrays(images, step), load_npz(GOLDEN_PACKED)
    assert sorted(fresh) == sorted(golden)
    for key, want in golden.items():
        if key == "packed_step_poses":
            assert wrapped_pose_diff(fresh[key], want).max() <= POSE_ATOL
        else:
            np.testing.assert_array_equal(fresh[key], want, err_msg=key)
    assert golden["packed_exact_pixels"].min() > 0 and golden["short_packed_exact_pixels"].min() > 0
    assert bool(golden["sort16_refused"]) and "short_sort16_sha256" in golden


def _corner_models():
    """A corner head on the shipped asset's trunk (the multi golden's
    hybrid), in both frameworks, with the asset's decode config."""
    mcfg, arrays = hybrid_corner_arrays()
    return (mcfg, asset_configs()[1], fcn_from_arrays(arrays, mcfg, device="cpu"),
            jax_model_from_arrays(mcfg, arrays))


def _packed_near_tie_clouds(n_frames: int) -> np.ndarray:
    """The near-tie frames with their invalid points set to NaN (the
    server and replay take unmasked clouds; a NaN point is invalid)."""
    bench = load_npz(GOLDEN_BENCH)
    points, valid = near_tie_sets(bench["points"][:n_frames], bench["valid"][:n_frames])[""]
    return np.where(valid[..., None], points, np.float32(np.nan))


@pytest.mark.parametrize("path", ["LidarPipeline", "ReplayHarness"])
def test_server_and_replay_with_packed_projection_match_jax(path):
    from tpufusion.serve.pipeline import LidarPipeline as JaxLidarPipeline
    from tpufusion.serve.replay import ReplayHarness as JaxReplayHarness

    mcfg, dcfg, model, jmodel = _corner_models()
    cfg = DEFAULT.replace(model=mcfg, decode=dcfg, projection_method="packed")
    clouds = _packed_near_tie_clouds(2)
    n = clouds.shape[1]
    if path == "LidarPipeline":
        port, ref = (LidarPipeline(cfg=cfg, model=model, max_points=n, device="cpu"),
                     JaxLidarPipeline(to_jax_config(cfg), jmodel, max_points=n))
        got = [port.predict_position(c[np.isfinite(c).all(-1)]) for c in clouds]
        want = [ref.predict_position(c[np.isfinite(c).all(-1)]) for c in clouds]
        poses, found = np.stack([g[0] for g in got]), np.array([g[1] for g in got])
        want_poses, want_found = np.stack([w[0] for w in want]), np.array([w[1] for w in want])
    else:
        poses, found, _ = ReplayHarness(cfg, model, chunk=2, device="cpu").run(clouds)
        want_poses, want_found, _ = JaxReplayHarness(to_jax_config(cfg), jmodel, chunk=2).run(clouds)
    np.testing.assert_array_equal(found, want_found)
    assert want_found.any()
    assert wrapped_pose_diff(poses[found], want_poses[found]).max() <= POSE_ATOL


def test_make_e2e_step_default_head_is_the_references():
    """Both packages' make_e2e_step default to the corner vote, and decode
    the same seeded corner-head parameters alike when called without
    `head`."""
    from flax import nnx

    from tpufusion.predict import make_e2e_step as jax_make_e2e_step

    for fn in (make_e2e_step, jax_make_e2e_step):
        assert inspect.signature(fn).parameters["head"].default == "corner"
    _, dcfg, model, jmodel = _corner_models()
    points, valid = _bench_frames()
    points, valid = points[:2], valid[:2]
    poses, found = make_e2e_step(model, SPEC, dcfg, device="cpu")(points, valid)
    graphdef, state = nnx.split(jmodel)
    want_poses, want_found = jax_make_e2e_step(graphdef, JSPEC, to_jax_config(dcfg))(
        state, jnp.asarray(points), jnp.asarray(valid))
    want_poses, want_found = np.asarray(want_poses), np.asarray(want_found)
    np.testing.assert_array_equal(found.numpy(), want_found)
    assert want_found.any()
    assert wrapped_pose_diff(poses[found], want_poses[want_found]).max() <= DEFAULT_HEAD_ATOL


def test_packed_wrapper_never_runs_plain_on_a_device_tensor():
    """Only a CPU tensor reaches the plain version: a tensor on any other
    device goes to the kernel's checks and raises, with no fallback."""
    points, valid = parity_inputs.nan_clouds(1, 4096)
    pix, key, ok, payload = trv._frame_pixels_keys(
        torch.from_numpy(points), SPEC, torch.from_numpy(valid))
    before = projection.PACKED_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        projection.nearest_wins_packed_image(
            pix.to("meta"), key.to("meta"), ok.to("meta"), payload.to("meta"), SPEC)
    assert projection.PACKED_LAUNCHES == before
    got = projection.nearest_wins_packed_image(pix, key, ok, payload, SPEC)
    want = projection.nearest_wins_packed_image_reference(pix, key, ok, payload, SPEC)
    assert torch.equal(got, want) and projection.PACKED_LAUNCHES == before


def test_bench_projection_ab_runs_every_method(capsys):
    """The A/B tool on the CPU at a small size: a JSON line a method and
    stage with the reference's keys, then the summary."""
    results = bench_projection_ab.main(
        ["--device", "cpu", "--batch", "2", "--n_points", "2048", "--sets", "2", "--reps", "1",
         "--methods", ",".join(PROJECTION_METHODS), "--e2e"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [(r["stage"], r["method"]) for r in lines[:-1]] == [
        (stage, m) for stage in ("projection", "e2e") for m in PROJECTION_METHODS]
    for row in lines[:-1]:
        assert {"stage", "method", "ms_per_chunk", "frames_per_s"} <= set(row)
        assert row["ms_per_chunk"] > 0 and row["device_ms"] is None  # the card's reading
    assert lines[-1] == {"probe": "projection_ab", "results": results}
    assert sorted(results) == sorted(PROJECTION_METHODS + tuple(f"e2e_{m}" for m in PROJECTION_METHODS))

