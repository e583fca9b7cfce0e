"""Golden tests: the port's range-view projection against JAX.

Tolerance: none. The z-buffer's winner rule is exact integer logic, and the
pixel ids, keys and payload use correctly rounded float32 math, so every
image must be bit-identical to JAX "exact" (and to "pallas", its kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_cloud
from tests.torch_golden import jax_beam_scans, to_jax_config
from tpufusion.geometry import range_view as jrv
from tpufusion.ops.scatter import nearest_wins_sort
from tpufusion_torch import RangeViewSpec, _build
from tpufusion_torch.geometry import range_view as trv
from tpufusion_torch.ops import projection
from tpufusion_torch.ops.libm_f32 import sqrt_f32
from tpufusion_torch.ops.scatter import _sortable_bits, nearest_wins_reference

SPEC = RangeViewSpec()
JSPEC = to_jax_config(SPEC)  # the JAX side gets its own config classes


def _proj_check_inputs():
    """The inputs of tests/test_tpu_hardware.py's _PROJ_CHECK: 4 x 8192
    Gaussian clouds with exact-key ties, a NaN point and a validity mask."""
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((4, 8192, 4)) * 20).astype(np.float32)
    pts[:, 4096:4608] = pts[:, :512]  # exact-key collision ties
    pts[0, 5] = np.nan
    valid = rng.random((4, 8192)) > 0.1
    return pts, valid


def _tied_clouds():
    """test_geometry.py's pallas-projection inputs: 3 frames of 8192 + 512
    duplicated points, a NaN, and a validity mask."""
    frames = []
    for seed in range(3):
        r = np.random.default_rng(seed)
        pts = synthetic_cloud(r, n=8192, with_vehicle_at=(10.0, 2.0, -0.7))
        frames.append(np.concatenate([pts, pts[:512]], axis=0).astype(np.float32))
    batch = np.stack(frames)
    batch[0, 7] = np.nan
    valid = np.random.default_rng(9).random(batch.shape[:2]) > 0.1
    return batch, valid


def _port(points, valid=None):
    return trv.range_view_project_batch(
        torch.from_numpy(points),
        SPEC,
        None if valid is None else torch.from_numpy(valid),
    ).numpy()


def _jax(points, valid, method):
    return np.asarray(
        jrv.range_view_project_batch(
            jnp.asarray(points), JSPEC, jnp.asarray(valid), method
        )
    )


def test_plain_zbuffer_matches_nearest_wins_sort():
    """Same pixel ids and keys in: the same winner and occupancy out, with
    exact ties, a NaN point and a mask."""
    batch, valid = _tied_clouds()
    num_pixels = SPEC.height * SPEC.width
    pix_t, key_t, ok_t = [], [], []
    for b in range(len(batch)):
        pts = jnp.asarray(batch[b])
        ok = jnp.all(jnp.isfinite(pts), axis=1) & jnp.asarray(valid[b])
        row, col, l2 = jrv.project_to_pixels(pts, JSPEC)
        pix = row * SPEC.width + col
        want_w, want_o = nearest_wins_sort(pix, l2, ok, num_pixels)
        pix_t.append(np.array(pix))
        key_t.append(np.array(l2).view(np.int32))
        ok_t.append(np.array(ok))
        got_w, got_o = nearest_wins_reference(
            torch.from_numpy(pix_t[-1])[None],
            torch.from_numpy(key_t[-1])[None],
            torch.from_numpy(ok_t[-1])[None],
            num_pixels,
        )
        np.testing.assert_array_equal(got_o[0].numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(got_w[0].numpy(), np.asarray(want_w))
    # batched call == per-frame calls
    got_w, got_o = nearest_wins_reference(
        torch.from_numpy(np.stack(pix_t)), torch.from_numpy(np.stack(key_t)),
        torch.from_numpy(np.stack(ok_t)), num_pixels,
    )
    for b in range(len(batch)):
        single = nearest_wins_reference(
            torch.from_numpy(pix_t[b])[None], torch.from_numpy(key_t[b])[None],
            torch.from_numpy(ok_t[b])[None], num_pixels,
        )
        assert torch.equal(got_w[b], single[0][0])
        assert torch.equal(got_o[b], single[1][0])


def test_sortable_bits_orders_like_floats():
    x = torch.tensor([0.0, 1e-30, 0.5, 1.0, 3.0, 1e30, float("inf")])
    bits = _sortable_bits(x)
    assert torch.equal(torch.argsort(bits), torch.arange(len(x)))


def test_projection_matches_jax_exact_on_proj_check_inputs():
    pts, valid = _proj_check_inputs()
    np.testing.assert_array_equal(_port(pts, valid), _jax(pts, valid, "exact"))


def test_projection_matches_jax_exact_on_beam_scans():
    pts, valid = jax_beam_scans(0, 4)
    np.testing.assert_array_equal(_port(pts, valid), _jax(pts, valid, "exact"))


def test_projection_matches_jax_pallas_interpret():
    """JAX's Pallas kernel (interpret mode on the CPU) at the sizes
    test_geometry.py runs it: batched with ties/NaN/mask, and one frame of
    odd N."""
    batch, valid = _tied_clouds()
    np.testing.assert_array_equal(_port(batch, valid), _jax(batch, valid, "pallas"))
    odd = batch[1:2, :4097]
    np.testing.assert_array_equal(
        _port(odd),
        np.asarray(jrv.range_view_project(jnp.asarray(odd[0]), JSPEC, None, "pallas"))[None],
    )


def test_sqrt_f32_is_correctly_rounded():
    rng = np.random.default_rng(5)
    v = (rng.random(1 << 20) * 4000.0).astype(np.float32)
    want = np.sqrt(v)  # numpy's float32 sqrt is IEEE correctly rounded
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(v)).numpy(), want)


@pytest.mark.parametrize("method", ["packed", "scatter", "sort16"])
def test_tpu_only_methods_raise(method):
    pts, valid = _proj_check_inputs()
    with pytest.raises(NotImplementedError):
        trv.range_view_project_batch(
            torch.from_numpy(pts), SPEC, torch.from_numpy(valid), method
        )


def test_unknown_method_raises():
    pts, _ = _proj_check_inputs()
    with pytest.raises(ValueError):
        trv.range_view_project_batch(torch.from_numpy(pts), SPEC, None, "nope")


def test_pallas_method_is_the_exact_contract():
    pts, valid = _proj_check_inputs()
    a = trv.range_view_project_batch(torch.from_numpy(pts), SPEC, torch.from_numpy(valid), "pallas")
    np.testing.assert_array_equal(a.numpy(), _port(pts, valid))


def test_wrapper_never_runs_plain_on_a_device_tensor():
    """Only a CPU tensor reaches the plain version: a tensor on any other
    device goes to the kernel's checks and raises, with no fallback."""
    pts, valid = _proj_check_inputs()
    pix, key, ok, payload = trv._frame_pixels_keys(
        torch.from_numpy(pts), SPEC, torch.from_numpy(valid)
    )
    before = projection.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        projection.nearest_wins_image(
            pix.to("meta"), key.to("meta"), ok.to("meta"), payload.to("meta"), SPEC
        )
    assert projection.LAUNCHES == before


def test_build_raises_without_nvcc():
    """No fallback: where nvcc is missing the build raises."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    if shutil.which("nvcc") or CUDA_HOME:
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
