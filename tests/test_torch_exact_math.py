"""The port's float32 pixel arithmetic against eager JAX's, bit for bit.

`tpufusion_torch/ops/libm_f32.py` reproduces what eager JAX computes on
this CPU: the host libm's fdlibm `atan2f` (which XLA calls for
`jnp.arctan2`), XLA's asin expansion, IEEE division, and XLA's flush of
subnormals. The range view's and the label encode's pixels
(`ops/pixels.py`'s plain versions, the CUDA kernel's reference) are built
from it. Tolerance: none. Every check compares bit patterns (NaN against
NaN where both are NaN). The reference's atan2 is the host's libm: where
one differs, the message says whether ctypes' `atan2f` of this libm
agrees with JAX there, so that a drift of the libm is told apart from one
of the port. Inputs are made from seeds with numpy.
"""

import ast
import ctypes
import ctypes.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_golden import REPO, to_jax_config
from tpufusion.geometry import boxes as jboxes
from tpufusion.geometry import range_view as jrv
from tpufusion_torch import RangeViewSpec
from tpufusion_torch.geometry import boxes as tboxes
from tpufusion_torch.geometry import range_view as trv
from tpufusion_torch.ops import parity_inputs, pixels
from tpufusion_torch.ops.libm_f32 import asin_f32, atan2_f32, sqrt_f32

SPECS = {"32 rows": RangeViewSpec(), "63 rows": RangeViewSpec(res_v_deg=0.665)}
N_PAIRS = 4_000_000


def _differ(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Where two float32 arrays differ in their bits (both NaN: equal)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return (got.view(np.int32) != want.view(np.int32)) & ~(np.isnan(got) & np.isnan(want))


def _libm_note(y: np.ndarray, x: np.ndarray, want: np.ndarray) -> str:
    """Whether this host's libm atan2f agrees with JAX on the pairs (first 20)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.atan2f.restype = ctypes.c_float
    libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    host = np.array([libm.atan2f(float(a), float(b)) for a, b in zip(y[:20], x[:20])], np.float32)
    return (f"{len(y)} pairs differ, e.g. (y, x) = {list(zip(y[:3], x[:3]))}; this libm's "
            f"atan2f agrees with JAX on {int((~_differ(host, want[:20])).sum())} of the "
            f"first {len(host)} of them")


def _check_atan2(y: np.ndarray, x: np.ndarray) -> None:
    got = atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.arctan2(y, x))
    bad = _differ(got, want)
    assert not bad.any(), _libm_note(y[bad], x[bad], want[bad])


def _seeded_pairs(regime: str):
    rng = np.random.default_rng(0 if regime == "uniform" else 1)
    if regime == "uniform":
        return (rng.uniform(-80, 80, N_PAIRS).astype(np.float32),
                rng.uniform(-80, 80, N_PAIRS).astype(np.float32))
    y = rng.uniform(-0.5, 0.5, N_PAIRS)  # asin's argument: x = 1 + sqrt(1 - y^2)
    return y.astype(np.float32), (1 + np.sqrt(1 - y * y)).astype(np.float32)


@pytest.mark.parametrize("regime", ["uniform", "asin argument"])
def test_atan2_matches_jax_on_seeded_pairs(regime):
    _check_atan2(*_seeded_pairs(regime))


def test_atan2_matches_jax_on_the_edge_grid():
    """Every pair of +-0, +-inf, NaN, subnormals, +-1 and fdlibm's |y/x|
    breakpoints, 2^+-60 and their neighbours; and quotients one ulp either
    side of each breakpoint with x != 1."""
    v = parity_inputs.pixel_edge_values()
    yy, xx = (a.ravel() for a in np.meshgrid(v, v, indexing="ij"))
    q = parity_inputs.pixel_fixed_points()[-180:]  # the quotient points: (x, y, z)
    _check_atan2(np.concatenate([yy, q[:, 1]]), np.concatenate([xx, q[:, 0]]))


def test_asin_matches_jax():
    rng = np.random.default_rng(2)
    v = parity_inputs.pixel_edge_values()
    near = np.float32([1.0, -1.0, 0.5, -0.5, 1e-40, -1e-40])
    x = np.concatenate([rng.uniform(-1, 1, 1_000_000).astype(np.float32), v, near,
                        np.nextafter(near, np.float32(0)), np.nextafter(near, np.float32(2))])
    got = asin_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.arcsin(x))
    bad = _differ(got, want)
    assert not bad.any(), f"{bad.sum()} differ, e.g. asin({x[bad][:3]}) = {got[bad][:3]}, JAX {want[bad][:3]}"


def test_sqrt_f32_is_correctly_rounded():
    """torch's CPU sqrt is not correctly rounded in float32 or float64;
    sqrt_f32 is, against numpy's, on every binade and the edge values."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(N_PAIRS) ** 2 * 10.0 ** rng.integers(-40, 38, N_PAIRS)).astype(np.float32)
    x = np.concatenate([x, np.abs(parity_inputs.pixel_edge_values())])
    got = sqrt_f32(torch.from_numpy(x)).numpy()
    assert not _differ(got, np.sqrt(x)).any()


def _lidar_points(n: int = N_PAIRS) -> np.ndarray:
    """Lidar-like points: range U(2, 80) m, azimuth U(-pi, pi), elevation
    U(-26, 3) degrees (numpy default_rng(3))."""
    rng = np.random.default_rng(3)
    r = rng.uniform(2, 80, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.radians(rng.uniform(-26, 3, n))
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], -1).astype(np.float32)


@pytest.mark.parametrize("name", list(SPECS))
def test_project_to_pixels_matches_jax_on_lidar_points(name):
    """Rows, columns and L2 keys of 4,000,000 points. torch.atan2 /
    torch.asin put 3 rows of the 32-row view and 5 of the 63-row view
    elsewhere."""
    spec, pts = SPECS[name], _lidar_points()
    row, col, l2 = trv.project_to_pixels(torch.from_numpy(pts), spec)
    jrow, jcol, jl2 = jrv.project_to_pixels(jnp.asarray(pts), to_jax_config(spec))
    for what, got, want in (("rows", row, jrow), ("columns", col, jcol)):
        bad = got.numpy() != np.asarray(want)
        assert not bad.any(), f"{bad.sum()} {what} differ, e.g. at {pts[bad][:3].tolist()}"
    assert not _differ(l2.numpy(), np.asarray(jl2)).any()


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("name", list(SPECS))
def test_pixels_and_keys_match_jax_on_adversarial_points(name, channels):
    """`_frame_pixels_keys` against JAX's: pixel ids (0 where invalid),
    keys (INT32_MAX where invalid) and validity, on fdlibm's edge values,
    points on pixel borders, NaN / inf in each channel, invalid and
    duplicate points; the payload against JAX's (zeros where invalid)."""
    spec, jspec = SPECS[name], to_jax_config(SPECS[name])
    pts, valid = parity_inputs.pixel_points(spec, batch=2, n=32768, channels=channels)
    pix, key, ok, payload = trv._frame_pixels_keys(torch.from_numpy(pts), spec,
                                                  torch.from_numpy(valid))
    for b in range(len(pts)):
        _, jpix, jkey = jrv._frame_pixels_keys(jnp.asarray(pts[b]), jspec, jnp.asarray(valid[b]))
        jok = np.isfinite(pts[b]).all(-1) & valid[b]
        np.testing.assert_array_equal(ok[b].numpy(), jok)
        np.testing.assert_array_equal(pix[b].numpy(), np.asarray(jpix))
        np.testing.assert_array_equal(key[b].numpy(), np.asarray(jkey))
        x, y, z = (jnp.asarray(pts[b, :, i]) for i in range(3))
        inten = pts[b, :, 3] if channels > 3 else np.zeros_like(pts[b, :, 0])
        want = np.stack([np.asarray(jnp.sqrt(x * x + y * y)), pts[b, :, 2], inten], -1)
        want = np.where(jok[:, None], want, np.float32(0))
        assert not _differ(payload[b].numpy(), want).any()


@pytest.mark.parametrize("name", list(SPECS))
def test_range_view_matches_jax_on_adversarial_points(name):
    spec = SPECS[name]
    pts, valid = parity_inputs.pixel_points(spec, batch=2, n=32768)
    got = trv.range_view_project_batch(torch.from_numpy(pts), spec, torch.from_numpy(valid))
    want = jrv.range_view_project_batch(jnp.asarray(pts), to_jax_config(spec), jnp.asarray(valid))
    assert not _differ(got.numpy(), np.asarray(want)).any()


def test_project_2d_matches_jax_on_seeded_corners():
    """The label encode's map: the corners and centers of 4,096 seeded
    boxes (sorted_projected_corners' inputs), and every edge value."""
    rng = np.random.default_rng(5)
    n = 4096
    center = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                       rng.uniform(-2.5, 0.5, n)], -1).astype(np.float32)
    size = np.stack([rng.uniform(3, 6, n), rng.uniform(1.5, 2.5, n),
                     rng.uniform(1.2, 2.0, n)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    corners = np.asarray(jboxes.box_corners_3d(center[:, None], size[:, None], yaw[:, None]))
    xyz = np.concatenate([corners.reshape(-1, 3), center, parity_inputs.pixel_fixed_points()])
    for spec in SPECS.values():
        jcol, jrow = jboxes.project_2d(xyz[:, 0], xyz[:, 1], xyz[:, 2], to_jax_config(spec))
        col, row = tboxes.project_2d(*(torch.from_numpy(np.ascontiguousarray(xyz[:, i]))
                                       for i in range(3)), spec)
        np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
        np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    got = tboxes.project_2d(torch.tensor(3.0), torch.tensor(-0.0), torch.tensor(0.5), SPECS["32 rows"])
    assert got[0].shape == () and got[1].shape == ()


def _two_call_sorted_corners(center, size, yaw, spec):
    """`sorted_projected_corners` as it was written before the corners and
    the center shared one project_2d call: two calls."""
    corners = tboxes.box_corners_3d(center, size, yaw)
    ccol, crow = tboxes.project_2d(corners[..., 0], corners[..., 1], corners[..., 2], spec)
    pcol, prow = tboxes.project_2d(center[..., 0], center[..., 1], center[..., 2], spec)
    d = sqrt_f32((ccol - pcol[..., None]).to(torch.float32) ** 2
                 + (crow - prow[..., None]).to(torch.float32) ** 2)
    order = torch.argsort(d, dim=-1, stable=True)
    both = torch.stack([ccol, crow], dim=-1)
    return torch.gather(both, -2, order[..., None].expand(both.shape))


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_sorted_projected_corners_in_one_call_is_the_two_call_form(spec_name):
    """The corners and the center go through project_2d in one call (one
    kernel launch on the card): bit for bit the two calls' result and
    JAX's, on 4,096 seeded boxes and on a (4, 8) batch of them."""
    spec = SPECS[spec_name]
    rng = np.random.default_rng(7)
    n = 4096
    center = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                       rng.uniform(-2.5, 0.5, n)], -1).astype(np.float32)
    size = np.stack([rng.uniform(3, 6, n), rng.uniform(1.5, 2.5, n),
                     rng.uniform(1.2, 2.0, n)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    jspec = to_jax_config(spec)
    want = jax.jit(jax.vmap(lambda c, s, y: jboxes.sorted_projected_corners(c, s, y, jspec)))(
        center, size, yaw)
    for shape in ((n,), (4, n // 4)):
        args = [torch.from_numpy(a.reshape(*shape, *a.shape[1:])) for a in (center, size, yaw)]
        got = tboxes.sorted_projected_corners(*args, spec)
        assert torch.equal(got, _two_call_sorted_corners(*args, spec))
        np.testing.assert_array_equal(got.reshape(n, 8, 2).numpy(), np.asarray(want))


def test_pixel_wrappers_never_run_plain_on_a_device_tensor():
    """Only a CPU tensor reaches the plain versions: a tensor on any other
    device goes to the kernel's checks and raises, with no fallback."""
    spec = SPECS["32 rows"]
    pts = torch.zeros((2, 16, 4), device="meta")
    before = (pixels.LAUNCHES, pixels.LAUNCHES_2D)
    with pytest.raises(ValueError, match="CUDA"):
        pixels.project_points(pts, None, spec)
    with pytest.raises(ValueError, match="CUDA"):
        pixels.project_2d(pts[..., 0], pts[..., 1], pts[..., 2], spec)
    assert (pixels.LAUNCHES, pixels.LAUNCHES_2D) == before


def _calls(path: str) -> set[str]:
    with open(os.path.join(REPO, "tpufusion_torch", path)) as f:
        tree = ast.parse(f.read())
    return {ast.unparse(n.func) for n in ast.walk(tree) if isinstance(n, ast.Call)}


@pytest.mark.parametrize("path", ["geometry/range_view.py", "geometry/boxes.py",
                                  "ops/pixels.py", "ops/libm_f32.py"])
def test_the_pixel_path_calls_no_library_trigonometry(path):
    """No torch.atan2 / torch.asin on the range view's or project_2d's
    path, and no division by a Python number in the plain versions."""
    calls = _calls(path)
    assert not calls & {"torch.atan2", "torch.asin", "torch.arctan2", "torch.arcsin"}, calls
    if not path.startswith("ops/"):
        return
    with open(os.path.join(REPO, "tpufusion_torch", path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            right = node.right.operand if isinstance(node.right, ast.UnaryOp) else node.right
            assert not isinstance(right, (ast.Constant, ast.Attribute)), (
                path, node.lineno, ast.unparse(node))
