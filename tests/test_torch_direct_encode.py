"""The direct head's label encode: the port's plain version against JAX's
`encode_direct_label` / `encode_direct_label_batch`, the wrapper of the
fused kernel (`tpufusion_torch/ops/label_encode.py::encode_direct_label`)
on the CPU, the tables the kernel reads, the kernel's order of operations,
and `parity_inputs.face_inputs`' returns on and beside the dilated box
faces.

The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py), held there bit for bit to the plain version; here the
plain version is held to JAX. Tolerance: the footprint channels equal,
the rest within LABEL_ATOL (1e-5, the codec tests' limit: JAX contracts
the rotation in an einsum and takes XLA's sin and cos, the port rounds
the rotation term by term and takes torch's).

The frames: beam scans projected into the view (their boxes' surface
returns; 32 beams at 32 rows, 64 at 63), then test_torch_train's poses
over random images, half on the 360-degree seam. The face returns sit
within an ulp of the mask's `<=` under torch's arithmetic, where XLA's
cos and sin may round the other way: they are held to the plain
version's own geometry, not to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_label_encode import SPECS, _boxes
from tests.test_torch_train import LABEL_ATOL, _images, t
from tests.torch_golden import to_jax_config
from tpufusion.geometry import encoding as jax_encoding
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry import encoding
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.ops import label_encode, parity_inputs

FOOTPRINTS = label_encode.FOOTPRINTS
YAW_FRAMES = label_encode.YAW_FRAMES


def _frames(spec, n_scan=4, n_pose=4, seed=0):
    """(center, size, yaw, image) numpy: n_scan beam scans with their boxes,
    then n_pose seam and all-round poses over random images."""
    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(seed), n_scan, 4096,
                                                n_beams=64 if spec.height == 63 else 32)
    img = range_view_project_batch(t(pts), spec, t(valid)).numpy()
    c, s, y = _boxes(n_pose, seed=seed + 1)
    return (np.concatenate([gt["center"], c]), np.concatenate([gt["size"], s]),
            np.concatenate([gt["yaw"], y]), np.concatenate([img, _images(n_pose, spec, seed + 2)]))


def _assert_label(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])  # the footprint
    np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)


def _jax_batch(frames, spec, **kw):
    return np.asarray(jax_encoding.encode_direct_label_batch(
        *(jnp.asarray(a) for a in frames), to_jax_config(spec), **kw))


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("yaw_frame", YAW_FRAMES)
@pytest.mark.parametrize("footprint", FOOTPRINTS)
def test_plain_direct_encode_matches_jax(footprint, yaw_frame, spec_name):
    """`encode_direct_label_reference` against JAX's
    `encode_direct_label_batch`, each footprint and yaw frame, at 32 and 63
    rows: the footprint equal, the rest within LABEL_ATOL; the surface has
    returns in it."""
    spec = SPECS[spec_name]
    frames = _frames(spec)
    kw = {"footprint": footprint, "yaw_frame": yaw_frame}
    want = _jax_batch(frames, spec, **kw)
    got = encoding.encode_direct_label_reference(*(t(a) for a in frames), spec, **kw).numpy()
    assert got.shape[-1] == label_encode.direct_channels(yaw_frame)
    _assert_label(got, want)
    assert want[:4, ..., 1].sum() > 0, "no footprint pixel on the beam scans"


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=["one_frame", "batch", "two_batches"])
def test_direct_encode_takes_any_leading_shape(lead):
    """The wrapper on the CPU (the plain version) at leading shapes (),
    (B,) and (2, B) against JAX's encode_direct_label, vmapped as the
    leading shape asks; encode_direct_label_batch against JAX's."""
    spec = SPECS["32_rows"]
    jspec = to_jax_config(spec)
    n = int(np.prod(lead, dtype=int))
    c, s, y, img = _frames(spec, n_scan=n, n_pose=0, seed=5)
    c, s, y = c.reshape(lead + (3,)), s.reshape(lead + (3,)), y.reshape(lead)
    img = img.reshape(lead + img.shape[1:])
    fn = lambda c_, s_, y_, im: jax_encoding.encode_direct_label(  # noqa: E731
        c_, s_, y_, im, jspec, "surface", "both")
    for _ in lead:
        fn = jax.vmap(fn)
    want = np.asarray(fn(*(jnp.asarray(a) for a in (c, s, y, img))))
    got = encoding.encode_direct_label(t(c), t(s), t(y), t(img), spec, yaw_frame="both").numpy()
    _assert_label(got, want)
    if len(lead) == 1:
        want_b = _jax_batch((c, s, y, img), spec)
        _assert_label(encoding.encode_direct_label_batch(t(c), t(s), t(y), t(img), spec).numpy(),
                      want_b)


def test_the_wrapper_sends_cpu_tensors_to_the_plain_version_and_refuses_unknown_values():
    spec = SPECS["32_rows"]
    c, s, y, img = (t(a) for a in _frames(spec, n_scan=2, n_pose=2, seed=7))
    before = label_encode.LAUNCHES_DIRECT
    for footprint in FOOTPRINTS:
        for yaw_frame in YAW_FRAMES:
            got = label_encode.encode_direct_label(c, s, y, img, spec, footprint, yaw_frame)
            want = encoding.encode_direct_label_reference(c, s, y, img, spec, footprint, yaw_frame)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (footprint,
                                                                                yaw_frame)
    assert label_encode.LAUNCHES_DIRECT == before  # no kernel on the CPU
    for fn in (label_encode.encode_direct_label, encoding.encode_direct_label):
        with pytest.raises(ValueError, match="unknown footprint"):
            fn(c, s, y, img, spec, "outer_rect")
        with pytest.raises(ValueError, match="unknown yaw_frame"):
            fn(c, s, y, img, spec, "surface", "polar")
    with pytest.raises(ValueError, match="unknown yaw_frame"):  # the plain version's own check
        encoding.encode_direct_label_reference(c, s, y, img, spec, "surface", "polar")


@pytest.mark.parametrize("spec", [RangeViewSpec(), SPECS["32_rows"], RangeViewSpec(res_v_deg=0.665)],
                         ids=["32x1801", "32x201", "63x1801"])
def test_the_cached_theta_table_is_pixel_angles(spec):
    """`label_encode.pixel_theta` (the kernel's table of W floats) is every
    row of pixel_angles' theta bit for bit, made once and shared."""
    theta, _ = encoding.pixel_angles(spec, device="cpu")
    table = label_encode.pixel_theta(spec, "cpu")
    assert table.shape == (spec.width,) and table.dtype == torch.float32
    assert torch.equal(table.expand(spec.height, -1).view(torch.int32), theta.view(torch.int32))
    assert label_encode.pixel_theta(spec, "cpu") is table


@pytest.mark.parametrize("yaw_frame", YAW_FRAMES)
@pytest.mark.parametrize("footprint", FOOTPRINTS)
def test_the_kernels_order_of_operations_is_the_plain_versions(footprint, yaw_frame):
    """The label computed op by op as the kernel computes it, from its
    tables (torch's cos and sin of each column and row, the theta row) and
    its per-frame constants, equals the plain version bit for bit: c_phys
    and the half sizes per frame, the surface test (rel = p - c_phys, qx =
    c rel0 + s rel1, qy = (-s) rel0 + c rel1, |q| <= half, d > 0) or the
    plain rect, dc = R^T (c_phys - p) term by term, sin / cos of the
    rounded yaw + theta, and every channel times the 0/1 mask."""
    spec = SPECS["32_rows"]
    c, s, y, img = (t(a) for a in _frames(spec, seed=9))
    want = encoding.encode_direct_label_reference(c, s, y, img, spec, footprint, yaw_frame)
    ct, st, cp, sp = label_encode.pixel_trig(spec, "cpu")
    theta = label_encode.pixel_theta(spec, "cpu")
    out = []
    for i in range(len(y)):
        cy, sy = torch.cos(y[i]), torch.sin(y[i])
        cphys = [cy * c[i, 0] - sy * c[i, 1], sy * c[i, 0] + cy * c[i, 1], c[i, 2]]
        half = [s[i, j] * 0.5 + 0.25 for j in range(3)]
        d, h = img[i, ..., 0], img[i, ..., 1]
        p = [d * ct, -d * st, h]
        if footprint == "surface":
            rel = [p[j] - cphys[j] for j in range(3)]
            qx, qy = cy * rel[0] + sy * rel[1], -sy * rel[0] + cy * rel[1]
            m = ((qx.abs() <= half[0]) & (qy.abs() <= half[1]) & (rel[2].abs() <= half[2])
                 & (d > 0)).float()
        else:
            m = want[i, ..., 1]
        cols, rows = (ct, st), (cp[:, None], sp[:, None])
        r = [[cols[0] * rows[0], -cols[1] + 0.0, cols[0] * rows[1] + 0.0],
             [cols[1] * rows[0] + 0.0, cols[0], cols[1] * rows[1] + 0.0],
             [-rows[1] + 0.0, torch.zeros(()), rows[0]]]
        v = [cphys[j] - p[j] for j in range(3)]
        dc = [v[0] * r[0][j] + v[1] * r[1][j] + v[2] * r[2][j] for j in range(3)]
        ch = [1.0 - m, m, *(x * m for x in dc), *(s[i, j] * m for j in range(3))]
        if yaw_frame != "global":
            ang = y[i] + theta
            ch += [torch.sin(ang) * m, torch.cos(ang) * m]
        if yaw_frame != "local":
            ch += [sy * m, cy * m]
        out.append(torch.stack([x.expand(spec.height, spec.width) for x in ch], -1))
    got = torch.stack(out)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(want[..., 1].sum()) > 0


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_face_returns_sit_on_and_outside_the_dilated_faces(spec_name):
    """`parity_inputs.face_inputs` on the CPU: every "out" return's box-frame
    coordinate is above the half size and its mask 0; on the top and bottom
    faces every "on" return's coordinate equals the half size exactly, on
    the entry and exit faces most do (the rest are the nearest value
    inside), and nearly all of them are in the mask. At yaw 0 and +-pi,
    the seam among the boxes."""
    spec = SPECS[spec_name]
    center, size, yaw, image, case = parity_inputs.face_inputs(spec, 9, seed=11)
    pi32 = float(np.float32(np.pi))
    assert set(yaw.tolist()) == {0.0, pi32, -pi32}
    c, s, y, img = (t(a) for a in (center, size, yaw, image))
    mask = encoding.box_surface_mask(c, s, y, img, spec).numpy()
    cy, sy = torch.cos(y)[:, None, None], torch.sin(y)[:, None, None]
    rel = encoding.pixel_points(img, spec) - encoding._physical_center(c, y)[:, None, None, :]
    q = torch.stack([cy * rel[..., 0] + sy * rel[..., 1], -sy * rel[..., 0] + cy * rel[..., 1],
                     rel[..., 2]], -1).abs().numpy()
    half = (s / 2.0 + 0.25)[:, None, None, :].numpy()
    exact = (q == half).any(-1)
    above = (q > half).any(-1)
    for code, name in enumerate(parity_inputs.FACE_CASES):
        sel = case == code
        assert sel.sum() > 100, name
        if name.endswith("out"):
            assert above[sel].all() and not mask[sel].any(), name
        elif name.endswith("on"):
            assert mask[sel].mean() > 0.9, name
            assert exact[sel].mean() > (0.99 if name[0] in "tb" else 0.4), name
        else:
            assert mask[sel].all(), name
    # the wrapper's surface footprint on them is the mask (the plain version on the CPU)
    got = encoding.encode_direct_label(c, s, y, img, spec)
    np.testing.assert_array_equal(got[..., 1].numpy(), mask)
