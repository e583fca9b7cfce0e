"""The dtype guard: every public decode entry point of the port on a bf16
and on a float16 head output against its JAX counterpart on the same
array (CPU).

Inputs: the multi golden's label-encoded corner outputs of two
two-vehicle frames (`corner_ypred`) rounded to the dtype, with the port's
range views of those frames; and the bf16 golden's frames with the
shipped asset's FCN output in the dtype
(`tests/data/torch_port_golden_bf16.npz`, `torch_port_golden_f16.npz`).

Each entry point must answer where JAX answers (no raise), with the
output types JAX gives (the port's int64 / JAX's int32 counted as a
difference), `found` equal, integer and boolean outputs equal, and
poses, 3D centroids, corners and areas within POSE_TOL (1e-3 in bf16,
1e-4 in float16; yaw as an angle). The float8 dtypes are not covered:
the port's FCN does not run them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_golden import (
    GOLDEN_BF16,
    GOLDEN_F16,
    GOLDEN_MULTI,
    asset_configs,
    load_npz,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.decode import decode as jd
from tpufusion_torch import DecodeConfig, RangeViewSpec
from tpufusion_torch._golden import from_bf16_bits, from_f16_bits
from tpufusion_torch.decode import decode as td
from tpufusion_torch.geometry.range_view import range_view_project_batch

POSE_TOL = 1e-3
F16_POSE_TOL = 1e-4  # float16 reads 3.8e-6 (a bf16 sum is a coarser step)
SPEC = RangeViewSpec()
POSE_KEYS = ("pose", "poses")


@pytest.fixture(scope="module")
def heads():
    """{dtype: {"corner": (y_pred, images), "direct": (y_pred, images)}}
    for torch.bfloat16 and torch.float16: float32 numpy arrays, the
    outputs holding values of the dtype."""
    gm, gb, gf = load_npz(GOLDEN_MULTI), load_npz(GOLDEN_BF16), load_npz(GOLDEN_F16)
    images = range_view_project_batch(torch.from_numpy(gm["multi_points"][:2]), SPEC,
                                      torch.from_numpy(gm["multi_valid"][:2])).numpy()
    corner = torch.from_numpy(gm["corner_ypred"])
    return {dt: {"corner": (corner.to(dt).float().numpy(), images),
                 "direct": (direct, gb["images"])}
            for dt, direct in ((torch.bfloat16, from_bf16_bits(gb["asset_bits"])),
                               (torch.float16, from_f16_bits(gf["asset_bits"])))}


def _direct_cfg(center=None):
    cfg = asset_configs()[1]
    return cfg if center is None else dataclasses.replace(cfg, direct_center=center)


# name: (head, port function, JAX function, static argnums of the JAX
# function, arguments after the inputs, frame (None: the batch))
CASES = {
    "find_obstacle": ("direct", td.find_obstacle, jd.find_obstacle, (1,), (DecodeConfig(),), 0),
    "find_obstacles_topk": ("direct", td.find_obstacles_topk, jd.find_obstacles_topk, (1, 2),
                            (DecodeConfig(), 4), 0),
    "decode_frame": ("corner", td.decode_frame, jd.decode_frame, (2, 3), (SPEC, DecodeConfig()),
                     0),
    "decode_frame_multi": ("corner", td.decode_frame_multi, jd.decode_frame_multi, (2, 3, 4),
                           (SPEC, DecodeConfig(), 4), 1),
    "decode_batch": ("corner", td.decode_batch, jd.decode_batch, (2, 3),
                     (SPEC, DecodeConfig()), None),
    "decode_batch_multi": ("corner", td.decode_batch_multi, jd.decode_batch_multi, (2, 3, 4),
                           (SPEC, DecodeConfig(), 4), None),
    "decode_frame_direct": ("direct", td.decode_frame_direct, jd.decode_frame_direct,
                            (2, 3, 4, 5), (SPEC, _direct_cfg(), 2, None), 0),
    **{f"decode_batch_direct_{c}": ("direct", td.decode_batch_direct, jd.decode_batch_direct,
                                    (2, 3, 4, 5), (SPEC, _direct_cfg(c), 2, None), None)
       for c in td._CENTERS},
}


def _jax_args(args):
    return tuple(to_jax_config(a) if isinstance(a, (DecodeConfig, RangeViewSpec)) else a
                 for a in args)


def _outputs(out) -> dict:
    return dict(out) if isinstance(out, dict) else dict(enumerate(out))


def _entry_point_matches_jax(heads, name, dtype, tol):
    head, port_fn, jax_fn, static, args, frame = CASES[name]
    y, images = heads[dtype][head]
    if frame is not None:
        y, images = y[frame], images[frame]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    if port_fn in (td.find_obstacle, td.find_obstacles_topk):
        port_in = (torch.from_numpy(y[..., 1]).to(dtype),)
        jax_in = (jnp.asarray(y[..., 1]).astype(jdt),)
    else:
        port_in = (torch.from_numpy(y).to(dtype), torch.from_numpy(images))
        jax_in = (jnp.asarray(y).astype(jdt), jnp.asarray(images))
    want = _outputs(jax.jit(jax_fn, static_argnums=static)(*jax_in, *_jax_args(args)))
    got = _outputs(port_fn(*port_in, *args))
    assert sorted(got, key=str) == sorted(want, key=str), name
    found = [k for k in got if k == "found" or k == 3]
    assert found and bool(np.asarray(want[found[0]]).any()), f"{name}: JAX finds nothing"
    for key, w in want.items():
        w, g = np.asarray(w), got[key]
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, (name, key, g.dtype, w.dtype)
        g = g.float().numpy() if g.dtype in (torch.bfloat16, torch.float16) else g.numpy()
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {key}")
        elif key in POSE_KEYS:
            diff = float(wrapped_pose_diff(g, w).max())
            assert diff <= tol, (name, key, diff)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_entry_point_on_a_bf16_output_matches_jax(heads, name):
    _entry_point_matches_jax(heads, name, torch.bfloat16, POSE_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_entry_point_on_a_float16_output_matches_jax(heads, name):
    _entry_point_matches_jax(heads, name, torch.float16, F16_POSE_TOL)
