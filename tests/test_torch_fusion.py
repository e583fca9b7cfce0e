"""The port's fusion path against the JAX package on the same numpy inputs:
the FCN's feature tap in the camera and BEV geometries, FusionNet with
weights carried from a JAX FusionNet through save_state_npz, the shipped
fusion asset on one full-size frame, config 3's whole step, and
predict_fusion's CSV.

Tolerances. 1e-5 on the float32 feature maps and on (centroid, rz) at
the small size in either dtype (they read 3e-8; JAX's own float32 and
bf16 nets are 1.1e-5 apart there). With the shipped asset on a full-size
frame (outputs of ~20 m summed over a 21,888-wide dense layer): centroid
2e-4 in either dtype (reads 1e-6; JAX's float32 and bf16 nets are 5.5e-4
apart on that frame), rz FUSION_RZ_ATOL. On the golden's 8 frames:
F32_FUSION_ATOL, BF16_FUSION_ATOL and FUSION_RZ_ATOL of
tpufusion_torch/_golden.py, whose comments say why.
"""

import csv
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import tpufusion.config as jax_config
from tests import make_torch_port_golden as maker
from tests.torch_golden import (
    FUSION_ASSET,
    GOLDEN_FUSION,
    load_npz,
    jax_apply,
    jax_model_from_arrays,
    jax_module_from_arrays,
    random_arrays,
)
from tpufusion.geometry import bev as jax_bev
from tpufusion.geometry import camera as jax_camera
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion.models import fusion as jax_fusion
from tpufusion.models.io import load_state_npz as jax_load_state_npz
from tpufusion.models.io import save_state_npz
from tpufusion.train import fusion_trainer as jax_trainer
from tpufusion_torch import benchmarks
from tpufusion_torch import _golden
from tpufusion_torch._golden import BF16_FUSION_ATOL, F32_FUSION_ATOL, FUSION_RZ_ATOL
from tpufusion_torch.geometry.bev import bev_rasterize_batch
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.config import BevSpec, CameraConfig, ModelConfig
from tpufusion_torch.data.synthetic import build_fusion_dataset, synthesize_beam_scan_batch
from tpufusion_torch.geometry import camera as port_camera
from tpufusion_torch.models import fusion as port_fusion
from tpufusion_torch.models.fcn import FCN, uniform_init_
from tpufusion_torch.models.io import fcn_from_arrays, fusion_from_asset, load_arrays
from tpufusion_torch.serve import fusion as port_serve

F32_ATOL = 1e-5
ASSET_ATOL = 2e-4  # the shipped asset on one full-size frame, either dtype
SMALL_CAMERA = CameraConfig(width=136, height=64)
CAMERA_MODEL = ModelConfig(vertical_stride=2, use_regression=False)


@pytest.mark.parametrize(
    "name,mcfg,shape",
    [
        ("camera", CAMERA_MODEL, (2, 64, 200, 1)),  # conv1 width 51, crop5 = 1
        ("bev", ModelConfig(), (2, 36, 205, 3)),  # conv1 width 52, crop5 = 0
        ("lidar", ModelConfig(), (1, 32, 201, 3)),  # conv1 width 51, crop5 = 1
    ],
)
def test_fcn_features_and_forward_match_jax(name, mcfg, shape):
    """FCN.features (the pre-softmax deconv6a map) and the forward in the
    camera geometry (vertical stride 2, no regression branch, one input
    channel) and the BEV's."""
    port = FCN(mcfg, in_channels=shape[-1])
    arrays = random_arrays(port, seed=3)
    load_arrays(port, arrays)
    x = np.random.default_rng(4).uniform(-1, 2, shape).astype(np.float32)
    jmodel = jax_model_from_arrays(mcfg, arrays, in_channels=shape[-1])
    want_feat = jax_apply(jmodel, lambda m, v: m.features(v, train=False), x)
    want_out = jax_apply(jmodel, lambda m, v: m(v, train=False), x)
    with torch.inference_mode():
        feat = port.eval().features(torch.from_numpy(x)).numpy()
        out = port(torch.from_numpy(x)).numpy()
    assert feat.shape == want_feat.shape == (*shape[:3], 2)
    assert out.shape == want_out.shape
    assert np.abs(want_feat).max() > 0.1
    np.testing.assert_allclose(feat, want_feat, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=F32_ATOL)


def test_fcn_features_leave_in_the_compute_dtype():
    port = FCN(dataclasses.replace(CAMERA_MODEL, dtype="bfloat16"), in_channels=1).eval()
    uniform_init_(port, 0)
    with torch.inference_mode():
        feat = port.features(torch.rand(1, 64, 200, 1))
    assert feat.dtype == torch.bfloat16 and feat.shape == (1, 64, 200, 2)


class _Pair(nnx.Module):
    """Two nnx modules as one, so one jit takes both states."""

    def __init__(self, first, second):
        self.first, self.second = first, second


def _jax_fusion(dtype, lidar_pool, cam_pool, camera=SMALL_CAMERA):
    def build():
        return jax_fusion.FusionNet(
            lidar_model=jax_config.ModelConfig(dtype=dtype),
            camera_model=jax_config.ModelConfig(
                vertical_stride=2, use_regression=False, dtype=dtype),
            camera=jax_config.CameraConfig(width=camera.width, height=camera.height),
            lidar_pool=lidar_pool, cam_pool=cam_pool, rngs=nnx.Rngs(2),
        )
    return build


def _port_fusion(dtype, lidar_pool, cam_pool, camera=SMALL_CAMERA):
    return port_fusion.FusionNet(
        lidar_model=ModelConfig(dtype=dtype),
        camera_model=dataclasses.replace(CAMERA_MODEL, dtype=dtype),
        camera=camera, lidar_pool=lidar_pool, cam_pool=cam_pool,
    )


def _small_asset(tmp_path, dtype, lidar_pool, cam_pool, seed=6):
    """A JAX FusionNet at the small camera size holding seeded arrays,
    written with save_state_npz plus the asset's json. Returns (the JAX
    net, the asset's path)."""
    arrays = random_arrays(_port_fusion(dtype, lidar_pool, cam_pool), seed)
    jnet = jax_module_from_arrays(_jax_fusion(dtype, lidar_pool, cam_pool), arrays)
    path = str(tmp_path / "fusion_small.npz")
    save_state_npz(path, jnet)
    meta = {"lidar_pool": list(lidar_pool), "cam_pool": list(cam_pool),
            "camera": {"width": SMALL_CAMERA.width, "height": SMALL_CAMERA.height}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return jnet, path


def _fusion_inputs(seed, batch, camera=SMALL_CAMERA, n_points=4096):
    rng = np.random.default_rng(seed)
    pts, _, valid = synthesize_beam_scan_batch(rng, batch, n_points)
    lidar = np.array(jax_project(jnp.asarray(pts), jax_config.RangeViewSpec(),
                                 jnp.asarray(valid), "exact"))
    cam = rng.uniform(0, 1, (batch, camera.height, camera.width, 1)).astype(np.float32)
    radar = np.stack([rng.uniform(5, 30, batch), rng.uniform(-0.4, 0.4, batch)], -1)
    return pts, valid, cam, lidar, radar.astype(np.float32)


def _jax_forward(jnet, cam, lidar, radar):
    return jax_apply(jnet, lambda m, c, l, r: m(c, l, r, train=False), cam, lidar, radar)


def _port_forward(net, cam, lidar, radar):
    with torch.inference_mode():
        c, r = net(torch.from_numpy(cam), torch.from_numpy(lidar), torch.from_numpy(radar))
    return c.numpy(), r.numpy()


# an odd pool: 1801 // 8 and 136 // 8 drop a remainder (VALID pooling)
@pytest.mark.parametrize("lidar_pool,cam_pool", [((2, 8), (8, 8)), ((3, 7), (5, 3))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_net_matches_jax_through_save_state_npz(tmp_path, dtype, lidar_pool, cam_pool):
    jnet, path = _small_asset(tmp_path, dtype, lidar_pool, cam_pool)
    net = fusion_from_asset(path, "cpu", dtype)
    assert net.lidar_pool == lidar_pool and net.cam_pool == cam_pool
    _, _, cam, lidar, radar = _fusion_inputs(8, 3)
    want_c, want_r = _jax_forward(jnet, cam, lidar, radar)
    got_c, got_r = _port_forward(net, cam, lidar, radar)
    assert got_c.shape == (3, 3) and got_r.shape == (3, 1) and got_c.dtype == np.float32
    assert np.abs(want_c).max() > 0.05
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("lidar_pool,cam_pool", [((2, 8), (8, 8)), ((3, 7), (5, 3))])
def test_float16_fusion_net_matches_jax(tmp_path, lidar_pool, cam_pool):
    """FusionNet over float16 FCNs (float16 features through the max-pools
    and the branches, the radar in float32), one forward step against
    JAX's float16 net at the small size: within 2.5e-7 (reads 6e-8; JAX's
    own float32 net lies 6.9e-7 to 1.7e-6 from its float16 net)."""
    jnet, path = _small_asset(tmp_path, "float16", lidar_pool, cam_pool)
    net = fusion_from_asset(path, "cpu", "float16")
    assert net.lidar_fcn.compute_dtype == net.camera_fcn.compute_dtype == torch.float16
    _, _, cam, lidar, radar = _fusion_inputs(8, 3)
    want_c, want_r = _jax_forward(jnet, cam, lidar, radar)
    got_c, got_r = _port_forward(net, cam, lidar, radar)
    assert got_c.dtype == got_r.dtype == np.float32 and np.abs(want_c).max() > 0.05
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=2.5e-7)


def test_fcn_features_leave_in_float16():
    port = FCN(dataclasses.replace(CAMERA_MODEL, dtype="float16"), in_channels=1).eval()
    uniform_init_(port, 0)
    with torch.inference_mode():
        feat = port.features(torch.rand(1, 64, 200, 1))
    assert feat.dtype == torch.float16 and feat.shape == (1, 64, 200, 2)


def test_fusion_net_without_lidar_pool_matches_jax():
    """The reference's default geometry: camera pooled (4, 1), the raw
    32 x 1801 x 2 lidar map into its dense layer."""
    port = _port_fusion("float32", None, (4, 1))
    arrays = random_arrays(port, seed=7)
    load_arrays(port, arrays)
    jnet = jax_module_from_arrays(_jax_fusion("float32", None, (4, 1)), arrays)
    assert port.lidar_branch.dense1.kernel.shape == (32 * 1801 * 2, 96)
    _, _, cam, lidar, radar = _fusion_inputs(9, 2)
    want_c, want_r = _jax_forward(jnet, cam, lidar, radar)
    got_c, got_r = _port_forward(port.eval(), cam, lidar, radar)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=F32_ATOL)


def test_flatten_order_is_height_width_channel():
    """dense1 must meet the pooled map in flax's NHWC order: a kernel
    that picks one (row, column, channel) entry reads that entry."""
    net = _port_fusion("float32", (2, 8), (8, 8)).eval()
    uniform_init_(net.camera_fcn, 1)
    _, _, cam, lidar, radar = _fusion_inputs(10, 1)
    with torch.inference_mode():
        feat = port_fusion._max_pool_nhwc(
            net.camera_fcn.features(torch.from_numpy(cam)), (8, 8))
        assert feat.shape == (1, 8, 17, 2)
        row, col, ch = 5, 11, 1
        net.cam_branch.dense1.kernel[(row * 17 + col) * 2 + ch, 0] = 1.0
        picked = net.cam_branch.dense1(feat.reshape(1, -1))[0, 0]
    assert picked == feat[0, row, col, ch] != 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shipped_fusion_asset_matches_jax_on_a_full_size_frame(dtype):
    """fusion_net.npz (float16 arrays) at 512 x 1368 on one generated
    fusion frame: the net the reference's fused benchmark builds."""
    data = build_fusion_dataset(1, seed=12, n_points=8192, device="cpu")
    meta = json.load(open(FUSION_ASSET + ".json"))
    jnet = _jax_fusion(dtype, tuple(meta["lidar_pool"]), tuple(meta["cam_pool"]),
                       CameraConfig())()
    jax_load_state_npz(FUSION_ASSET, jnet)
    want_c, want_r = _jax_forward(jnet, data["cam"], data["lidar"], data["radar"])
    net = fusion_from_asset(FUSION_ASSET, "cpu", dtype)
    assert net.cam_branch.dense1.kernel.shape == (21888, 96)
    assert net.lidar_branch.dense1.kernel.shape == (7200, 96)
    assert net.cam_branch.dense1.kernel.dtype == torch.float32
    got_c, got_r = _port_forward(net, data["cam"], data["lidar"], data["radar"])
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=ASSET_ATOL)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=FUSION_RZ_ATOL)
    # the trained net sees the vehicle: within a few metres of the truth
    assert np.linalg.norm(got_c[0, :2] - data["centroid"][0, :2]) < 3.0


def test_fusion_from_asset_raises_on_a_mismatched_or_unreadable_asset(tmp_path):
    _, path = _small_asset(tmp_path, "float32", (2, 8), (8, 8))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.load(open(path + ".json"))

    def write(name, arrs, m):
        p = str(tmp_path / name)
        np.savez(p, **arrs)
        with open(p + ".json", "w") as f:
            json.dump(m, f)
        return p

    missing = {k: v for k, v in arrays.items() if k != "rz_head/out/bias"}
    with pytest.raises(ValueError, match="mismatch"):
        fusion_from_asset(write("missing.npz", missing, meta), "cpu")
    with pytest.raises(ValueError, match="shape"):  # other pools: another dense1
        fusion_from_asset(write("pools.npz", arrays, {**meta, "cam_pool": [4, 4]}), "cpu")
    with pytest.raises(KeyError):
        fusion_from_asset(write("nopool.npz", arrays, {"cam_pool": [8, 8]}), "cpu")
    bad = tmp_path / "garbage.npz"
    bad.write_bytes(b"not an npz")
    (tmp_path / "garbage.npz.json").write_text(json.dumps(meta))
    with pytest.raises(Exception):
        fusion_from_asset(str(bad), "cpu")
    with pytest.raises(FileNotFoundError):
        fusion_from_asset(str(tmp_path / "absent.npz"), "cpu")


def test_config3_step_matches_jax(tmp_path):
    """Config 3's whole step (BEV + painted camera + BEV FCN, range view
    + fusion net) at batch 2 against the reference benchmark's fn, with a
    small camera and float32 nets: seg within 1e-5, (centroid, rz) within
    1e-5, the fused BEV input bit-identical apart from the density."""
    jnet, path = _small_asset(tmp_path, "float32", (2, 8), (8, 8))
    net = fusion_from_asset(path, "cpu", "float32")
    bev_port = FCN(ModelConfig(), in_channels=3)
    bev_arrays = random_arrays(bev_port, seed=11)
    load_arrays(bev_port, bev_arrays)
    bev_jax = jax_model_from_arrays(ModelConfig(), bev_arrays)
    pts, valid, cam, _, radar = _fusion_inputs(13, 2)
    pts[:, :, :2] *= 2.5  # spread the scan over more of the +-120 m grid

    cams = [m.synthetic_camera(SMALL_CAMERA.width, SMALL_CAMERA.height, 140.0)
            for m in (port_camera, jax_camera)]
    spec = BevSpec(with_height_channel=True, with_intensity_channel=False)
    jspec = jax_config.BevSpec(with_height_channel=True, with_intensity_channel=False)
    nx, ny, (hc, wc) = spec.nx, spec.ny, (SMALL_CAMERA.height, SMALL_CAMERA.width)
    vv = np.broadcast_to(np.arange(hc, dtype=np.float32)[:, None, None], (hc, wc, 1))
    uu = np.broadcast_to(np.arange(wc, dtype=np.float32)[None, :, None], (hc, wc, 1))
    v_t = jnp.asarray(jax_camera.rgb_onto_bev(vv, cams[1], nx, ny)[..., 0].astype(np.int32))
    u_t = jnp.asarray(jax_camera.rgb_onto_bev(uu, cams[1], nx, ny)[..., 0].astype(np.int32))
    ok_t = jnp.asarray(
        jax_camera.rgb_onto_bev(np.ones((hc, wc, 1), np.float32), cams[1], nx, ny)[..., 0] > 0)
    assert int(ok_t.sum()) > 500

    def jax_fn(models, points, valid, cam_img, radar):  # the reference benchmark's fn
        bev_fcn, fusion = models.first, models.second
        bev = jax_bev.bev_rasterize_batch(points, jspec, valid)
        painted = jnp.where(ok_t, cam_img[:, v_t, u_t, 0], 0.0)
        fused = jnp.concatenate([bev, painted[..., None]], axis=-1)
        fused = jnp.swapaxes(fused, 1, 2)[:, :, : nx - 2, :]
        seg = bev_fcn(fused, train=False)
        lidar_img = jax_project(points, jax_config.RangeViewSpec(), valid, "exact")
        centroid, rz = fusion(cam_img, lidar_img, radar, train=False)
        return seg, centroid, rz, fused

    want = jax_apply(_Pair(bev_jax, jnet), jax_fn, pts, valid, cam, radar)
    fn = benchmarks.make_config3_step(bev_port, net, "cpu", spec, cams[0])
    seg, centroid, rz = fn(*(torch.from_numpy(a) for a in (pts, valid, cam, radar)))
    assert seg.shape == (2, 180, 1197, 26) and want[0].shape == seg.shape
    np.testing.assert_allclose(seg.numpy(), want[0], rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(centroid.numpy(), want[1], rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(rz.numpy(), want[2], rtol=0, atol=F32_ATOL)
    assert (want[3][..., 2] != 0).sum() > 500  # painted cells reach the FCN


def test_predict_fusion_csv_matches_jax_row_by_row(tmp_path):
    """5 frames at batch 2 (the last batch padded), three sensor streams
    joined by build_fusion_batches in both packages: same timestamps,
    zeros in the same columns, centroid and rz within 1e-5."""
    jnet, path = _small_asset(tmp_path, "float32", (2, 8), (8, 8))
    net = fusion_from_asset(path, "cpu", "float32")
    _, _, cam, lidar, radar = _fusion_inputs(14, 5)
    lidar_ts = 1_490_000_000_000 + np.arange(7) * 100_000
    cam_ts = lidar_ts[[0, 2, 3, 5, 6]] + 7_000
    radar_ts = lidar_ts[:6] + 3_000
    rng = np.random.default_rng(15)
    lidar7 = np.concatenate([lidar, lidar[:2]])[rng.permutation(7)]
    radar6 = np.concatenate([radar, radar[:1]])
    poses = rng.uniform(-10, 10, (5, 4)).astype(np.float32)
    args = (cam, cam_ts, poses, lidar7, lidar_ts, radar6, radar_ts)
    jdata = jax_trainer.build_fusion_batches(*args)
    pdata = port_serve.build_fusion_batches(*args)
    assert sorted(jdata) == sorted(pdata)
    for k in jdata:
        np.testing.assert_array_equal(pdata[k], jdata[k])
    jcsv, pcsv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jax_trainer.predict_fusion(jnet, jdata, cam_ts.tolist(), jcsv, batch_size=2)
    port_serve.predict_fusion(net, pdata, cam_ts.tolist(), pcsv, batch_size=2, device="cpu")
    with open(jcsv) as f:
        want = list(csv.DictReader(f))
    with open(pcsv) as f:
        reader = csv.DictReader(f)
        got = list(reader)
        assert tuple(reader.fieldnames) == port_serve.CSV_FIELDS
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["timestamp"] == w["timestamp"]
        for k in ("rx", "ry", "l", "w", "h"):
            assert g[k] == w[k] == "0.0"
        for k in ("tx", "ty", "tz", "rz"):
            assert abs(float(g[k]) - float(w[k])) <= F32_ATOL, (k, g[k], w[k])
    assert len({g["tx"] for g in got}) == 5  # the padding rows are not written


# -- the committed golden the card is held against ---------------------------

@pytest.fixture(scope="module")
def committed():
    return load_npz(GOLDEN_FUSION)


def test_golden_fusion_file_is_current(committed):
    """tests/data/torch_port_golden_fusion.npz equals what the JAX package
    and the port's generators compute now (rerun
    tests/make_torch_port_golden.py if not)."""
    fresh = maker.golden_fusion_arrays()
    assert sorted(committed) == sorted(fresh)
    for k, v in fresh.items():
        if k == "bev_values":
            np.testing.assert_allclose(committed[k], v, rtol=0, atol=1e-4, err_msg=k)
        elif k.startswith("fusion_f32_"):
            np.testing.assert_allclose(committed[k], v, rtol=0, atol=1e-4, err_msg=k)
        elif k.startswith("fusion_bf16_"):  # XLA's bf16 rounding may vary by CPU
            atol = FUSION_RZ_ATOL if k.endswith("_rz") else BF16_FUSION_ATOL
            np.testing.assert_allclose(committed[k], v, rtol=0, atol=atol, err_msg=k)
        elif k == "seg_prob":
            np.testing.assert_allclose(
                committed[k], v, rtol=0, atol=_golden.BF16_SEG_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(committed[k], v, err_msg=k)
    assert os.path.getsize(GOLDEN_FUSION) < 1_500_000
    # the stated limits are well inside JAX's own float32-vs-bf16 gap, so
    # a net that ran in the wrong dtype cannot meet them
    gap = np.abs(fresh["fusion_f32_centroid"] - fresh["fusion_bf16_centroid"]).max()
    gap_rz = np.abs(fresh["fusion_f32_rz"] - fresh["fusion_bf16_rz"]).max()
    assert gap > 5 * max(BF16_FUSION_ATOL, F32_FUSION_ATOL) and gap_rz > 5 * FUSION_RZ_ATOL


def test_bev_matches_the_committed_golden(committed):
    """The card's check, on the CPU: JAX's non-zero cells, exact but for
    the density."""
    spec = BevSpec()
    got = bev_rasterize_batch(
        torch.from_numpy(committed["bev_points"]), spec, torch.from_numpy(committed["bev_valid"])
    ).numpy()
    want = _golden.dense_cells(committed["bev_index"], committed["bev_values"], got.shape)
    np.testing.assert_array_equal(_golden.sparse_cells(got)[0], committed["bev_index"])
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    pts, valid = _golden.bev_golden_inputs(spec)  # the recipe gives the stored inputs here
    np.testing.assert_array_equal(pts, committed["bev_points"])
    np.testing.assert_array_equal(valid, committed["bev_valid"])


@pytest.fixture(scope="module")
def golden_frames(committed):
    """The golden's fusion frames: stored points, masks and radar, the
    camera made again from the seed and held to the stored digests."""
    data = _golden.fusion_golden_data("cpu")
    np.testing.assert_array_equal(data["cam_sha256"], committed["fusion_cam_sha256"])
    np.testing.assert_array_equal(data["points"], committed["fusion_points"])
    pts = torch.from_numpy(committed["fusion_points"])
    valid = torch.from_numpy(committed["fusion_valid"])
    return pts, valid, torch.from_numpy(data["cam"]), torch.from_numpy(committed["fusion_radar"])


@pytest.mark.parametrize("tag,dtype,atol", [
    ("f32", "float32", F32_FUSION_ATOL), ("bf16", "bfloat16", BF16_FUSION_ATOL)])
def test_fusion_asset_matches_the_committed_golden(committed, golden_frames, tag, dtype, atol):
    pts, valid, cam, radar = golden_frames
    net = fusion_from_asset(FUSION_ASSET, "cpu", dtype)
    with torch.inference_mode():
        centroid, rz = net(cam, range_view_project_batch(pts, valid=valid), radar)
    np.testing.assert_allclose(
        centroid.numpy(), committed[f"fusion_{tag}_centroid"], rtol=0, atol=atol)
    np.testing.assert_allclose(
        rz.numpy(), committed[f"fusion_{tag}_rz"], rtol=0, atol=FUSION_RZ_ATOL)


def test_config3_seg_matches_the_committed_golden(committed, golden_frames):
    """Config 3's seg at full width (512 x 1368 camera, 1199 x 180 BEV,
    bf16 BEV FCN with the golden's seeded weights) on 2 golden frames."""
    pts, valid, cam, radar = (t[: _golden.SEG_FRAMES] for t in golden_frames)
    arrays = {k.split("/", 1)[1]: v for k, v in committed.items() if k.startswith("bev_fcn/")}
    bev_fcn = fcn_from_arrays(arrays, ModelConfig(dtype="bfloat16"), device="cpu")
    fusion = fusion_from_asset(FUSION_ASSET, "cpu")
    seg, _, _ = benchmarks.make_config3_step(bev_fcn, fusion, "cpu")(pts, valid, cam, radar)
    assert seg.shape == (2, 180, 1197, 26)
    worst, share = _golden.seg_readings(seg.numpy(), committed["seg_prob"])
    assert worst <= _golden.BF16_SEG_ATOL and share <= _golden.BF16_SEG_DIFFER_SHARE, (worst, share)
