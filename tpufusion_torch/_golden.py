"""Helpers for holding the port against the committed JAX goldens
(tests/data/torch_port_golden*.npz): used by chip_smoke.py, the golden
tests and the card's tests. numpy at import; the input recipes of the
fusion golden import the port's generators where they are called.
"""

from __future__ import annotations

import numpy as np

# bf16 FCN against JAX's bf16 FCN: both round each layer's output to
# bf16 (8 significant bits, a relative step of 2**-8), so an output may
# differ by a step where the two float32 accumulations straddle a
# rounding boundary. Probabilities come from the softmax in float32 of
# bf16 logits: 2**-8. Regression outputs reach |x| < 8, where a bf16 step
# is 2**-5: two steps, 2**-4.
BF16_PROB_ATOL = 2.0**-8
BF16_REG_ATOL = 2.0**-4
# the float32 FCN's two softmax probabilities against JAX's float32 FCN
FCN_PROB_ATOL = 1e-5
# Such steps are rare: at most this share of the regression outputs may
# differ at all. Measured on the golden frames: 0.06 % on the CPU, 0.58 %
# on an H100 (cuDNN sums in another order than XLA); rounding each
# convolution once instead of twice (a fused bias epilogue) moves 51 %.
BF16_REG_DIFFER_SHARE = 0.05
# The fusion golden (torch_port_golden_fusion.npz). Its lidar points, masks
# and radar rows are stored; the 8 camera frames (22 MB) are made again
# from FUSION_SEED by `fusion_golden_data` and held to stored digests.
FUSION_SEED = 41
FUSION_FRAMES = 8
FUSION_POINTS = 4096  # points per golden frame (the timed run uses 32,768)
BEV_SEED = 42
SEG_STRIDE = 17  # config 3's seg: foreground probability at every 17th pixel
SEG_FRAMES = 2
# Config 3's seg comes from a seeded BEV FCN whose two bf16 logits reach
# |x| < 4 (a bf16 step of 2**-6 there). A logit a step apart moves the
# softmax by at most a quarter of the step, both logits by half of it;
# 2**-6 leaves room for two steps each. Such steps are rare: at most
# BF16_SEG_DIFFER_SHARE of the sampled probabilities may differ by more
# than float32 noise (1e-6). The port reads 4.4e-3 and 0.06 % on the CPU.
BF16_SEG_ATOL = 2.0**-6
BF16_SEG_DIFFER_SHARE = 0.05
# Fusion net against JAX's on the golden's frames. The limits sit between
# what the port reads and what a wrong dtype would move: JAX's own bf16
# net differs from its float32 net on these frames by 1.01e-2 in the
# centroid (metres, up to ~30) and 9.9e-5 in rz (radians; the golden keeps
# both answers), so a port that ran the "bf16" net in float32, or rounded
# once more or less than JAX does, is a gap away and fails all three.
# float32 centroid: cuDNN and cuBLAS sum in another order than XLA on the
# CPU; the port reads 2.9e-6 on the CPU and 3.8e-6 on an H100.
F32_FUSION_ATOL = 1e-4
# bf16 centroid against JAX's bf16: both round every conv output to bf16
# at the same places; the port reads 5.7e-6 on the CPU and 3.8e-6 on an
# H100. A tenth of JAX's float32-vs-bf16 gap.
BF16_FUSION_ATOL = 1e-3
# rz, either dtype: reads 4.5e-8 on the CPU and 3.0e-8 on an H100. A
# tenth of JAX's float32-vs-bf16 gap in rz.
FUSION_RZ_ATOL = 1e-5
# The tall golden (torch_port_golden_tall.npz): a 64-beam sensor's range
# view. RangeViewSpec(res_v_deg=TALL_RES_V_DEG) is 63 x 1801; the frames
# are the port's numpy beam scans from TALL_SEED at TALL_BEAMS beams, and
# are stored (numpy's trigonometry may differ by ulps between CPUs).
TALL_RES_V_DEG = 0.665
TALL_BEAMS = 64
TALL_SEED = 3
TALL_FRAMES = 4
TALL_POINTS = 32768
# the multi golden keeps JAX's bf16 foreground probability at every pixel
# and its regression outputs at every FCN_REG_STRIDE-th pixel of a frame
FCN_REG_STRIDE = 17
# The bench golden (torch_port_golden_bench.npz): bench.py's headline net
# on BENCH_FRAMES of JAX's beam scans from PRNGKey(BENCH_SEED), 32,768
# points a frame, and JAX's __graft_entry__.entry() on its own example.
BENCH_SEED = 0
BENCH_FRAMES = 4
# The headline's seeded flagship against JAX's on JAX's range views: the
# sampled probabilities within FCN_PROB_ATOL in float32 and BF16_PROB_ATOL
# in bf16. JAX's own float32 net is within 1.7e-3 of its bf16 net, inside
# BF16_PROB_ATOL, but differs at 99 % of the samples, so in bf16 at most
# BF16_FLAGSHIP_DIFFER_SHARE of them may differ by more than float32 noise
# (1e-6). An H100 reads 1.5e-8 and 0 % in bf16, 2.8e-7 in float32.
BF16_FLAGSHIP_DIFFER_SHARE = 0.05
# The card's range view of the same points is the CPU's, which is eager
# JAX's, bit for bit: the pixel kernel (csrc/pixels.cu) computes the
# reference's own float32 atan2 and asin, IEEE division and no FMA, and
# the z-buffer kernel is bit-identical to its plain version. Before it,
# torch's atan2 / asin and a division by a Python number (a multiply by
# the float32 reciprocal on the card) moved 42 pixels over the bench
# golden's 4 frames and 1 on frame 0 of entry()'s example on an H100,
# which moved that frame's pose 0.078 m. So no pixel may differ over the
# golden's frames or on a frame of the example, and entry()'s poses are
# held on all 4 of its frames.
BENCH_VIEW_MOVED_MAX = 0
ENTRY_VIEW_MOVED_MAX = 0
ENTRY_POSE_FRAMES_MIN = 4


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def wrapped_pose_diff(got, want: np.ndarray) -> np.ndarray:
    """|got - want| per element, yaw (column 3) as an angle: the
    reference's pi-symmetry tie-break in the fit may return yaw or
    yaw + 2 pi. `got` is numpy or a tensor."""
    if hasattr(got, "detach"):
        got = got.detach().cpu().numpy()
    d = np.asarray(got, np.float64) - want
    d[..., 3] = (d[..., 3] + np.pi) % (2 * np.pi) - np.pi
    return np.abs(d)


def fcn_golden_sample(out: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An FCN output (B, H, W, 2 + reg) -> what the golden keeps of it:
    (foreground probability (B, H, W), regression at every
    FCN_REG_STRIDE-th pixel (B, n, reg))."""
    b = out.shape[0]
    reg = out[..., 2:].reshape(b, -1, out.shape[-1] - 2)
    return out[..., 1], reg[:, ::FCN_REG_STRIDE]


def flagship_prob_sample(out: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An FCN output (B, H, W, 2 + reg) -> what the bench golden keeps of
    it: (the foreground probability at every FCN_REG_STRIDE-th pixel of a
    frame (B, n), its largest value a frame (B,))."""
    prob = out[..., 1].reshape(out.shape[0], -1)
    return prob[:, ::FCN_REG_STRIDE], prob.max(axis=1)


def bf16_fcn_readings(out: np.ndarray, want_prob: np.ndarray, want_reg: np.ndarray):
    """The port's bf16 FCN output against the golden's JAX bf16 sample:
    (largest probability difference, largest regression difference,
    regression outputs that differ at all, regression outputs)."""
    prob, reg = fcn_golden_sample(out)
    dr = np.abs(reg - want_reg)
    return (
        float(np.abs(prob - want_prob).max()),
        float(dr.max()),
        int((dr > 0).sum()),
        dr.size,
    )


def sparse_cells(raster: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A (B, nx, ny, C) raster -> (flat (B, nx, ny) index of every cell
    with a non-zero channel, int64, and those cells' values (n, C))."""
    flat = raster.reshape(-1, raster.shape[-1])
    index = np.flatnonzero((flat != 0).any(axis=1))
    return index.astype(np.int64), flat[index]


def dense_cells(index: np.ndarray, values: np.ndarray, shape) -> np.ndarray:
    """The inverse of `sparse_cells`: the raster of `shape`."""
    out = np.zeros((int(np.prod(shape[:-1])), shape[-1]), values.dtype)
    out[index] = values
    return out.reshape(shape)


def seg_golden_sample(seg: np.ndarray) -> np.ndarray:
    """An FCN output (B, H, W, 2 + reg) -> the foreground probability at
    every SEG_STRIDE-th pixel of a frame, (B, n)."""
    return seg[..., 1].reshape(seg.shape[0], -1)[:, ::SEG_STRIDE]


def seg_readings(seg: np.ndarray, want_prob: np.ndarray) -> tuple[float, float]:
    """Config 3's seg against the golden's sample: (largest difference,
    share of the sampled probabilities that differ by more than 1e-6)."""
    d = np.abs(seg_golden_sample(seg) - want_prob)
    return float(d.max()), float((d > 1e-6).mean())


def bev_golden_inputs(spec) -> tuple[np.ndarray, np.ndarray]:
    """(points (3, 4096, 4), valid (3, 4096)) the BEV golden is made of:
    two beam scans stretched over the +-120 m grid and past it, and the
    edge-case cloud. The golden stores them (numpy's trigonometry may
    differ by ulps between machines)."""
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.ops.parity_inputs import bev_edge_cloud

    scans, _, svalid = synthesize_beam_scan_batch(np.random.default_rng(BEV_SEED), 2, 4096)
    scans[:, :, :2] *= 3.0
    edge, evalid = bev_edge_cloud(spec)
    return np.concatenate([scans, edge[None]]), np.concatenate([svalid, evalid[None]])


def fusion_golden_data(device) -> dict[str, np.ndarray]:
    """The fusion golden's frames made again from FUSION_SEED
    (`data.synthetic.build_fusion_dataset`, the range view projected on
    `device`), plus "cam_sha256", each camera frame's digest."""
    import hashlib

    from tpufusion_torch.data.synthetic import build_fusion_dataset

    data = build_fusion_dataset(FUSION_FRAMES, FUSION_SEED, n_points=FUSION_POINTS, device=device)
    data["cam_sha256"] = np.array(
        [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest() for f in data["cam"]])
    return data


# -- the train golden (tests/data/torch_port_golden_train.npz) ----------------
# One train step of the reference on TRAIN_FRAMES frames x TRAIN_POINTS points
# from the port's numpy generator (TRAIN_SEED): a digest of the inputs, the
# labels' foreground pixels, the loss, the metrics, every gradient tensor and
# the BatchNorm statistics after the step, for each of TRAIN_CASES; and one
# fusion step (dropout off) on the fusion golden's frames.
TRAIN_SEED = 51
TRAIN_FRAMES = 4
TRAIN_POINTS = 32768
TRAIN_LR = 1e-3
TRAIN_SHIFT_SEED = 5  # jax.random.PRNGKey of the corner case's roll shifts
LABEL_STRIDE = 5  # the golden keeps every 5th foreground pixel's label values
# the shipped asset's direct head; a corner head on its trunk (the multi
# golden's hybrid/* kernels) with the roll augmentation; the direct head in bf16
TRAIN_CASES = {
    "direct_f32": {"head": "direct", "dtype": "float32", "augment": False},
    "corner_f32": {"head": "corner", "dtype": "float32", "augment": True},
    "direct_bf16": {"head": "direct", "dtype": "bfloat16", "augment": False},
}
# Limits of a card's step against the reference's step on the CPU (float32):
# the loss relative, each gradient tensor relative to its largest entry, the
# running statistics absolute, label values absolute. An H100 reads 1.1e-6,
# 1.0e-5 (direct) / 1.2e-5 (corner), 3.8e-6 and 4.8e-7 / 1.9e-6; the port on
# the CPU 1.2e-6, 1.4e-5 / 5.2e-6, 3.8e-6 and 8.3e-7 / 1.9e-6. In bf16 the
# card reads 3.2e-3 for the kernels and 2.0e-2 for the conv biases, the CPU
# 4.5e-3 and 2.0e-2.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STATS_ATOL = 1e-5
TRAIN_LABEL_ATOL = 1e-4
# bf16: kernels' gradients pass through bf16 convolutions on both sides (a
# relative step of 2**-8 an element). A conv bias's gradient is a sum of bf16
# values over every pixel of the batch: torch sums it in float32 and rounds
# once; XLA on the CPU, where the golden is made, keeps bf16 partial sums, so
# the reference's own bf16 bias gradients lie up to 0.30 of a tensor's largest
# entry from its float32 ones while its kernels' lie within 0.04 (ROADMAP
# Queue 3). A bf16 conv bias gradient is therefore held to the nearer of the
# reference's bf16 and float32 gradients.
BF16_TRAIN_LOSS_RTOL = 2.0**-8
BF16_TRAIN_GRAD_RTOL = 2.0**-6
BF16_TRAIN_BIAS_GRAD_RTOL = 2.0**-4
FUSION_GRAD_STRIDE = 257  # the golden keeps every 257th entry of a large gradient
# The fusion step on the fusion golden's 8 frames. float32: the lidar frames
# hold 4,096 points, so the height channel is nearly constant (the fill value)
# and flax's float32 E[x^2] - E[x]^2 loses digits in the reference itself: its
# lidar-FCN gradients lie 4.5e-3 from a float64 run of the same step, the
# port's 3e-6 (ROADMAP Queue 3). Hence two limits.
FUSION_TRAIN_LOSS_RTOL = {"f32": 1e-4, "bf16": 2.0**-8}
FUSION_TRAIN_GRAD_RTOL = {"f32": 1e-3, "bf16": 2.0**-6}
FUSION_TRAIN_LIDAR_FCN_GRAD_RTOL = {"f32": 1e-2, "bf16": 2.0**-6}
# bf16 conv biases, against the nearer of the reference's two gradients: they
# read 9.2e-2 on the CPU and an H100, where the reference's own two lie 0.30 apart
FUSION_TRAIN_BF16_BIAS_GRAD_RTOL = 2.0**-2


def _sha256(*arrays: np.ndarray) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def train_golden_inputs() -> dict[str, np.ndarray]:
    """The train golden's batch made again from TRAIN_SEED: points, valid,
    center, size, yaw, and "sha256", the digest the golden holds."""
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch

    pts, gt, valid = synthesize_beam_scan_batch(
        np.random.default_rng(TRAIN_SEED), TRAIN_FRAMES, TRAIN_POINTS)
    batch = {"points": pts, "valid": valid, **gt}
    batch["sha256"] = np.array(_sha256(*(batch[k] for k in ("points", "valid", "center", "size", "yaw"))))
    return batch


def hybrid_corner_arrays(asset_arrays: dict, multi_golden: dict, nreg: int = 24) -> dict:
    """The asset's trunk with the multi golden's corner regression branch
    (hybrid/deconv5b, hybrid/deconv6b; zero biases)."""
    arrays = {k: v for k, v in asset_arrays.items()
              if not k.startswith(("deconv5b/", "deconv6b/"))}
    for name in ("deconv5b", "deconv6b"):
        arrays[f"{name}/kernel"] = multi_golden[f"hybrid/{name}/kernel"]
        arrays[f"{name}/bias"] = np.zeros(nreg, np.float32)
    return arrays


def sparse_labels(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A label batch (B, H, W, C) -> (flat index of every foreground pixel,
    the label values at every LABEL_STRIDE-th of them)."""
    flat = labels.reshape(-1, labels.shape[-1])
    index = np.flatnonzero(flat[:, 1] > 0.5).astype(np.int64)
    return index, flat[index[::LABEL_STRIDE]]


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 values that are exact in bf16 -> their upper 16 bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any(), "not exact in bf16"
    return (bits >> 16).astype(np.uint16)


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def grad_sample(g: np.ndarray) -> np.ndarray:
    """What the golden keeps of a fusion gradient: all of a small tensor,
    every FUSION_GRAD_STRIDE-th entry of a large one."""
    flat = np.asarray(g, np.float32).reshape(-1)
    return flat if flat.size <= 4096 else flat[::FUSION_GRAD_STRIDE]


def _train_case_setup(case: str, asset_path: str, multi_golden: dict, batch: dict, device,
                      shifts=None):
    """(model, tensors, spec, head, yaw_frame, augment) of a TRAIN_CASES entry."""
    import dataclasses

    import torch

    from tpufusion_torch.config import RangeViewSpec
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import asset_configs, load_arrays

    what = TRAIN_CASES[case]
    mcfg, dcfg = asset_configs(asset_path)
    arrays = load_npz(asset_path)
    if what["head"] == "corner":
        arrays = hybrid_corner_arrays(arrays, multi_golden)
    model = FCN(dataclasses.replace(mcfg, head=what["head"], dtype=what["dtype"]))
    load_arrays(model, arrays)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
               for k in ("points", "valid", "center", "size", "yaw")}
    if shifts is not None:
        tensors["shifts"] = torch.from_numpy(np.asarray(shifts, np.int64)).to(device)
    return model.to(device), tensors, RangeViewSpec(), what["head"], dcfg.direct_yaw_frame, what["augment"]


def port_case_labels(case: str, asset_path: str, multi_golden: dict, batch: dict, device,
                     shifts=None) -> np.ndarray:
    """The labels the port's train step of `case` trains on (encoded from
    the projected points, rolled by `shifts` where the case augments)."""
    from tpufusion_torch.data.augment import roll_frame
    from tpufusion_torch.train.train_step import encode_batch

    _, tensors, spec, head, yaw_frame, augment = _train_case_setup(
        case, asset_path, multi_golden, batch, device, shifts)
    images, labels = encode_batch(tensors, spec, head, yaw_frame)
    if augment:
        _, labels = roll_frame(images, labels, tensors["shifts"])
    return labels.cpu().numpy()


def port_train_case(case: str, asset_path: str, multi_golden: dict, batch: dict, device,
                    shifts=None) -> dict:
    """One `make_train_step` call of the port for a TRAIN_CASES entry, on
    `batch` (numpy, as `train_golden_inputs` makes it) moved to `device`:
    {"loss", "precision", "recall", "reg_mse", "grads" {key: array},
    "norm_mean", "norm_var"} as numpy. One projection: one z-buffer launch."""
    from tpufusion_torch.config import LossConfig, TrainConfig
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import make_train_step

    model, tensors, spec, head, yaw_frame, augment = _train_case_setup(
        case, asset_path, multi_golden, batch, device, shifts)
    step = make_train_step(
        spec, LossConfig(), TrainConfig(batch_size=TRAIN_FRAMES, augment=augment),
        head=head, yaw_frame=yaw_frame, device=device)
    _, metrics = step(model, Adam(model.parameters(), TRAIN_LR), tensors)
    out = {k: float(v) for k, v in metrics.items()}
    out["grads"] = {n.replace(".", "/"): p.grad.cpu().numpy() for n, p in model.named_parameters()}
    out["norm_mean"] = model.norm.mean.cpu().numpy()
    out["norm_var"] = model.norm.var.cpu().numpy()
    return out


def label_readings(labels: np.ndarray, golden: dict, case: str) -> tuple[bool, float]:
    """(the foreground pixels equal the golden's, the largest difference of
    the sampled label values)."""
    index, values = sparse_labels(labels)
    if not np.array_equal(index, golden[f"{case}/label_index"]):
        return False, float("inf")
    return True, float(np.abs(values - golden[f"{case}/label_values"]).max())


def train_case_readings(got: dict, golden: dict, case: str) -> dict[str, float]:
    """A port step (`port_train_case`) against the golden's: {"loss_rel",
    "grad_rel" (the worst kernel or BatchNorm tensor, relative to the
    golden tensor's largest entry), "bias_grad_rel", "worst_grad" (its
    key), "stats_abs", "metrics_abs"}."""
    bf16 = TRAIN_CASES[case]["dtype"] == "bfloat16"
    out = {"loss_rel": abs(got["loss"] - float(golden[f"{case}/loss"]))
           / abs(float(golden[f"{case}/loss"]))}
    def golden_grad(which: str, key: str) -> np.ndarray:
        want = golden[f"{which}/grad/{key}"]
        return from_bf16_bits(want) if want.dtype == np.uint16 else want

    def rel_to(which: str, key: str, g: np.ndarray) -> float:
        want = golden_grad(which, key)
        return float(np.abs(g - want).max() / max(float(np.abs(want).max()), 1e-30))

    rel = {key: rel_to(case, key, g) for key, g in got["grads"].items()}
    conv_bias = {k: v for k, v in rel.items() if k.endswith("/bias") and not k.startswith("norm/")}
    if bf16:  # the nearer of the reference's bf16 and float32 gradients
        f32_case = next(c for c, w in TRAIN_CASES.items()
                        if w["dtype"] == "float32" and w["head"] == TRAIN_CASES[case]["head"])
        conv_bias = {k: min(v, rel_to(f32_case, k, got["grads"][k])) for k, v in conv_bias.items()}
    rest = {k: v for k, v in rel.items() if k not in conv_bias}
    out["worst_grad"] = max(rest, key=rest.get)
    out["grad_rel"] = rest[out["worst_grad"]]
    out["bias_grad_rel"] = max(conv_bias.values())
    out["stats_abs"] = float(max(
        np.abs(got["norm_mean"] - golden[f"{case}/norm_mean"]).max(),
        np.abs(got["norm_var"] - golden[f"{case}/norm_var"]).max()))
    out["metrics_abs"] = float(max(
        abs(got[k] - float(golden[f"{case}/{k}"])) for k in ("precision", "recall", "reg_mse")))
    return out


def train_case_limits(case: str) -> dict[str, float]:
    """The limits `train_case_readings` is held to for `case`."""
    if TRAIN_CASES[case]["dtype"] == "bfloat16":
        return {"loss_rel": BF16_TRAIN_LOSS_RTOL, "grad_rel": BF16_TRAIN_GRAD_RTOL,
                "bias_grad_rel": BF16_TRAIN_BIAS_GRAD_RTOL, "stats_abs": TRAIN_STATS_ATOL}
    return {"loss_rel": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_RTOL,
            "bias_grad_rel": TRAIN_GRAD_RTOL, "stats_abs": TRAIN_STATS_ATOL}


def port_fusion_step(asset_path: str, dtype: str, data: dict, lidar, device) -> dict:
    """Loss and gradients of one fusion train step's forward and backward
    (train=True, dropout off) of the shipped fusion asset in `dtype` on
    `data` (cam, radar, centroid, rz; numpy) and the projected `lidar`
    images: {"loss", "grads" {key: array}, "stats" {key: array}}."""
    import torch

    from tpufusion_torch.models.fusion import fusion_loss
    from tpufusion_torch.models.io import fusion_from_asset

    net = fusion_from_asset(asset_path, device, dtype)
    net.cam_branch.rate = net.lidar_branch.rate = 0.0
    put = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    out = net(put(data["cam"]), put(lidar), put(data["radar"]), train=True)
    loss = fusion_loss(out, (put(data["centroid"]), put(data["rz"])))
    loss.backward()
    # the lidar FCN's regression branch is not on the features' path: no
    # gradient here, zeros in the reference
    return {
        "loss": float(loss.detach()),
        "grads": {n.replace(".", "/"): (torch.zeros_like(p) if p.grad is None else p.grad)
                  .cpu().numpy() for n, p in net.named_parameters()},
        "stats": {k.replace(".", "/"): v.cpu().numpy() for k, v in net.state_dict().items()
                  if k.endswith(("norm.mean", "norm.var"))},
    }


def fusion_step_readings(got: dict, golden: dict, tag: str) -> dict:
    """A port fusion step against the golden's sample: {"loss_rel",
    "grad_rel" (the worst tensor's sampled entries relative to the golden
    tensor's largest entry, the lidar FCN and bf16 conv biases apart),
    "worst_grad", "lidar_fcn_grad_rel", "bias_grad_rel" (bf16: conv biases
    against the nearer of the reference's bf16 and float32 gradients),
    "stats_abs", "over" (the tensors over their limit)}."""
    want_loss = float(golden[f"fusion_{tag}/loss"])

    def rel_to(which: str, key: str, g: np.ndarray) -> float:
        scale = max(float(golden[f"fusion_{which}/grad_max/{key}"]), 1e-30)
        return float(np.abs(grad_sample(g) - golden[f"fusion_{which}/grad/{key}"]).max() / scale)

    groups: dict[str, dict[str, float]] = {"rest": {}, "lidar_fcn": {}, "bias": {}}
    limits = {"rest": FUSION_TRAIN_GRAD_RTOL[tag], "lidar_fcn": FUSION_TRAIN_LIDAR_FCN_GRAD_RTOL[tag],
              "bias": FUSION_TRAIN_BF16_BIAS_GRAD_RTOL}
    for key, g in got["grads"].items():
        conv_bias = "_fcn/" in key and key.endswith("/bias") and "/norm/" not in key
        if tag == "bf16" and conv_bias:
            groups["bias"][key] = min(rel_to("bf16", key, g), rel_to("f32", key, g))
        else:
            groups["lidar_fcn" if key.startswith("lidar_fcn/") else "rest"][key] = rel_to(tag, key, g)
    worst = max(groups["rest"], key=groups["rest"].get)
    stats = max(float(np.abs(v - golden[f"fusion_{tag}/stats/{k}"]).max())
                for k, v in got["stats"].items())
    return {
        "loss_rel": abs(got["loss"] - want_loss) / abs(want_loss),
        "grad_rel": groups["rest"][worst], "worst_grad": worst,
        "lidar_fcn_grad_rel": max(groups["lidar_fcn"].values()),
        "bias_grad_rel": max(groups["bias"].values(), default=0.0),
        "stats_abs": stats,
        "over": sorted(k for name, group in groups.items() for k, v in group.items()
                       if v > limits[name]),
    }


# The viewer golden (torch_port_golden_viewer.npz): what cv2.imencode(".jpg",
# frame, [IMWRITE_JPEG_QUALITY, 88]) writes for two seeded BGR frames at
# the sizes the live viewer pushes (a range view, a BEV). The frames are
# made again from VIEWER_SEED (integer draws: the same on every machine)
# and held to the stored digests.
VIEWER_SEED = 61
VIEWER_SHAPES = ((32, 1801, 3), (1199, 180, 3))
VIEWER_QUALITY = 88


def viewer_golden_frames() -> list[np.ndarray]:
    """The viewer golden's uint8 frames: per channel an integer ramp
    wrapped at 256 (sharp edges and smooth runs) plus seeded noise."""
    rng = np.random.default_rng(VIEWER_SEED)
    frames = []
    for h, w, c in VIEWER_SHAPES:
        rows, cols = np.mgrid[:h, :w]
        ramp = (rows * 5 + cols * 3)[..., None] * np.arange(1, c + 1) % 256
        noise = rng.integers(-20, 21, (h, w, c))
        frames.append(np.clip(ramp + noise, 0, 255).astype(np.uint8))
    return frames


def viewer_frame_digest(frame: np.ndarray) -> str:
    return _sha256(frame)
