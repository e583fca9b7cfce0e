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
# The packed golden (torch_port_golden_packed.npz): the reference's
# projection methods on near-tie frames. Beam scans alone cannot tell the
# packed rule from the exact one (no pixel differs on the bench golden's
# frames), so each of the bench golden's frames gets its first
# NEAR_TIE_DUPS points repeated at its end, each repeat's coordinates
# scaled by 1 + U(-NEAR_TIE_JITTER, NEAR_TIE_JITTER) from NEAR_TIE_SEED:
# the same direction (so the same pixel) at an L2 a few hundred ulps away,
# which the packed key's dropped low bits cannot see (as the reference's
# tests/test_geometry.py makes its near ties). 32,768 + 1,024 points a
# frame: idx_bits 16. That is over sort16's 2**15 points, where the
# reference asserts; so the golden also holds every method on the recipe
# applied to each frame's first NEAR_TIE_SHORT - NEAR_TIE_DUPS points
# (NEAR_TIE_SHORT a frame: idx_bits 15, within sort16's limits).
NEAR_TIE_SEED = 14
NEAR_TIE_DUPS = 1024
NEAR_TIE_JITTER = 1e-4
NEAR_TIE_SHORT = 32768


# The direct decode kernel (csrc/decode_direct.cu) against its plain
# version (decode.decode_direct_clusters_reference): found equal; poses
# within DIRECT_KERNEL_ATOL (yaw as an angle), except on the adversarial
# inputs (parity_inputs.cluster_inputs), whose lanes with a bbox window of
# more than DIRECT_KERNEL_WIDE_WINDOW pixels are held to
# DIRECT_KERNEL_WIDE_ATOL (their float32 sums over tens of thousands of
# pixels run in another order); a lane whose plain version sits within
# DIRECT_KERNEL_NEAR (relative) of a threshold a tie could flip is
# counted and exempt.
DIRECT_KERNEL_ATOL = 1e-4
DIRECT_KERNEL_WIDE_ATOL = 1e-3
DIRECT_KERNEL_WIDE_WINDOW = 4096
DIRECT_KERNEL_NEAR = 1e-5
# A bf16 or float16 head output rounds sums of its products (or values)
# to its type; the plain version's margins hold each such sum's distance
# from a rounding midpoint of that type relative to the sum of its terms'
# magnitudes ("rounded", "rounded_surface"), inf where its float64 sum is
# exact in any order. Both versions sum in float64 and round once to
# float32, so where a float64 sum is not exact their float32 sums differ
# by a float32 step at most: a sum within DIRECT_KERNEL_ROUNDED_NEAR of a
# midpoint may round the other way, and its lane (a step of a size in the
# head's type: 1.8e-2 m in bf16, 3.9e-3 m in float16 on a 4.5 m length)
# is exempt.
DIRECT_KERNEL_ROUNDED_NEAR = 2.0**-22
_DIRECT_NEAR_BY_KEY = {"rounded": DIRECT_KERNEL_ROUNDED_NEAR,
                       "rounded_surface": DIRECT_KERNEL_ROUNDED_NEAR}


def direct_margins(margins: dict) -> list:
    """The plain version's margins ({key: (B, k)}), each in units of
    DIRECT_KERNEL_NEAR over its own limit: a lane is near a threshold
    where the smallest of them is below DIRECT_KERNEL_NEAR."""
    return [m * (DIRECT_KERNEL_NEAR / _DIRECT_NEAR_BY_KEY.get(key, DIRECT_KERNEL_NEAR))
            for key, m in margins.items()]


def direct_kernel_readings(got_poses, got_found, want_poses, want_found, windows,
                           margins, adversarial: bool = False) -> dict:
    """The contract's readings on (B, k) lanes (numpy): "found_equal" on
    the lanes not near a threshold, "near" (such lanes), "diff" and
    "diff_wide" (the largest pose difference on the other lanes with a
    window up to / beyond DIRECT_KERNEL_WIDE_WINDOW pixels) and "ok": the
    wide lanes are held to DIRECT_KERNEL_WIDE_ATOL only where
    `adversarial`, else to DIRECT_KERNEL_ATOL like the rest."""
    near = np.asarray(margins) < DIRECT_KERNEL_NEAR
    wide = np.asarray(windows) > DIRECT_KERNEL_WIDE_WINDOW
    diff = wrapped_pose_diff(got_poses, want_poses).max(axis=-1)
    keep = ~near
    found_equal = bool(np.array_equal(np.asarray(got_found)[keep], np.asarray(want_found)[keep]))
    d_small = float(diff[keep & ~wide].max(initial=0.0))
    d_wide = float(diff[keep & wide].max(initial=0.0))
    return {"found_equal": found_equal, "near": int(near.sum()), "diff": d_small,
            "diff_wide": d_wide,
            "ok": found_equal and d_small <= DIRECT_KERNEL_ATOL and d_wide <= (
                DIRECT_KERNEL_WIDE_ATOL if adversarial else DIRECT_KERNEL_ATOL)}


# The corner vote kernel (csrc/corner_vote.cu) against its plain version
# (decode.corner_vote_reference). The two sum the Gram products and the
# corners' 3-term rotations in other orders, so a pair whose d2 lies near
# 1e-9 or max_bbox_dist^2 may count in one and not the other. A lane is
# decided where no flip of its undecided pairs (d2 within CORNER_PAIR_REL
# of a threshold, relative to the larger of it and sq_i + sq_j) or of a
# near test within CORNER_NEAR_REL of a corner's size can change its
# winner set. ok and overflow equal on every voted lane; on the decided
# ones the winner sets equal, the box within CORNER_KERNEL_ATOL, and the
# pose (yaw as an angle) within CORNER_KERNEL_ATOL. The two boxes, one
# winner set summed in two orders, still differ in the last bits, and on
# some lanes the reference's pose formula throws that far: an atan2 at its
# branch cut, l and w divided by a cos(yaw) near 0, a box too small for a
# yaw. A lane is pose-sensitive where its box's coordinates moved by
# CORNER_POSE_STEP of its largest (a float32 step of it or half of one)
# move its pose by more than half of CORNER_KERNEL_ATOL; there the pose is
# held to the plain version's formula on the kernel's own box instead, and
# its difference from the plain pose is reported. Undecided and
# pose-sensitive lanes are counted.
CORNER_KERNEL_ATOL = 1e-4
CORNER_PAIR_REL = 1e-5
CORNER_NEAR_REL = 1e-6
CORNER_POSE_STEP = 2.0**-23


def corner_decided(counts, undecided, near_undecided) -> np.ndarray:
    """(B, n) bool: the lanes whose winner set no flip of an undecided
    pair or near test can change (numpy of the plain version's readings:
    counts, undecided pairs and near_undecided (B, n, K)). Each
    candidate's count may move by its undecided pairs u: a lone winner w
    stays where c_w - u_w exceeds every other valid c_i + u_i; tied
    winners stay where none of them has an undecided pair and every other
    valid c_i + u_i is below them."""
    counts, undecided = np.asarray(counts, np.int64), np.asarray(undecided, np.int64)
    valid = counts >= 0
    win = valid & (counts == counts.max(axis=-1, keepdims=True))
    lo = np.where(win, counts - undecided, np.iinfo(np.int64).max).min(axis=-1)
    hi = np.where(valid & ~win, counts + undecided, np.iinfo(np.int64).min).max(axis=-1)
    single = win.sum(axis=-1) == 1
    steady = np.where(win, undecided, 0).max(axis=-1, initial=0) == 0
    return (hi < lo) & (single | steady) & ~np.asarray(near_undecided).any(axis=-1)


def corner_kernel_readings(got: dict, want: dict, readings: dict, lanes) -> dict:
    """The contract's readings on (B, n) lanes, numpy: `got` and `want`
    hold "pose", "box", "ok", "overflow" and "counts" (B, n, K; the
    kernel's only on the real slots), `got` also "box_pose" (the plain
    version's pose formula on the kernel's box), `readings` the plain
    version's, `lanes` the voted lanes (the kernel writes zeros and False
    on the others). Returns "lanes" (voted), "undecided" (voted, not
    decided), "sensitive" (decided and pose-sensitive), "ok_equal" and
    "overflow_equal" (every voted lane), "masked_zero" (the others all
    zero), "winners_equal" (decided lanes), "diff" (the largest box or
    held pose difference there), "diff_sensitive" (the largest pose
    difference on the sensitive lanes, reported) and "ok"."""
    lanes = np.asarray(lanes, bool)
    real = np.asarray(readings["slots"]) >= 0
    decided = lanes & corner_decided(readings["counts"], readings["undecided"],
                                     readings["near_undecided"])
    sensitive = decided & np.asarray(readings["pose_sensitive"], bool)

    def winners(counts):
        counts = np.where(real, np.asarray(counts), -1)
        return (counts >= 0) & (counts == counts.max(axis=-1, keepdims=True))

    same = (winners(got["counts"]) == winners(want["counts"])).all(axis=-1)
    pose = wrapped_pose_diff(np.asarray(got["pose"]), np.asarray(want["pose"])).max(axis=-1)
    own = wrapped_pose_diff(np.asarray(got["pose"]), np.asarray(got["box_pose"])).max(axis=-1)
    box = np.abs(np.asarray(got["box"], np.float64) - want["box"]).max(axis=(-2, -1))
    held = np.maximum(box, np.where(sensitive, own, pose))
    out = {
        "lanes": int(lanes.sum()), "undecided": int((lanes & ~decided).sum()),
        "sensitive": int(sensitive.sum()),
        "ok_equal": bool((np.asarray(got["ok"]) == want["ok"])[lanes].all()),
        "overflow_equal": bool((np.asarray(got["overflow"]) == want["overflow"])[lanes].all()),
        "masked_zero": bool(not np.asarray(got["ok"])[~lanes].any()
                            and not np.asarray(got["overflow"])[~lanes].any()
                            and not np.asarray(got["pose"])[~lanes].any()
                            and not np.asarray(got["box"])[~lanes].any()),
        "winners_equal": bool(same[decided].all()),
        "diff": float(held[decided].max(initial=0.0)),
        "diff_sensitive": float(pose[sensitive].max(initial=0.0)),
    }
    out["ok"] = (out["ok_equal"] and out["overflow_equal"] and out["masked_zero"]
                 and out["winners_equal"] and out["diff"] <= CORNER_KERNEL_ATOL)
    return out


# tests/data/torch_port_golden_bf16.npz: the direct decode of a bf16 head
# output. The inputs are the multi golden's first two-vehicle frame and its
# first ellipse frame (JAX's range views), the shipped and the mixed
# assets' JAX FCN outputs rounded to bf16 (stored as their bits); the
# answers JAX decode_batch_direct's at k BF16_DECODE_K for each case: (the
# FCN, the DecodeConfig fields changed from its asset's own, or None for
# DecodeConfig()).
BF16_DECODE_K = 2
BF16_DECODE_FCNS = {"asset": "synthetic_detector.npz", "mixed": "synthetic_detector_mixed.npz"}
BF16_DECODE_CASES = {
    "backproject_local": ("asset", None),
    "fit_circle_global": ("asset", {}),
    "fit_ellipse_local": ("asset", {"fit_boundary": "ellipse", "fit_surface_scale": 0.9,
                                    "direct_yaw_frame": "local"}),
    "fit_auto_auto": ("mixed", {}),
    "head_global": ("asset", {"direct_center": "head"}),
    "head_local": ("asset", {"direct_center": "head", "direct_yaw_frame": "local"}),
    "silhouette_global": ("asset", {"direct_center": "silhouette"}),
}


# tests/data/torch_port_golden_f16.npz: the float16 configuration. The
# direct decode of a float16 head output on the bf16 golden's frames (the
# two assets' JAX FCN outputs rounded to float16, stored as their bits):
# JAX decode_batch_direct at k F16_DECODE_K and at k 1 for each case, the
# bf16 cases and the kernel's other centers; JAX's float16 FCN sample on
# the multi golden's three two-vehicle frames (`fcn_golden_sample`, the
# regression as float16 bits); and JAX make_e2e_step(head="direct",
# max_obstacles=F16_E2E_K) with the shipped asset in float16 on them.
F16_DECODE_K = 2
F16_E2E_K = 4
F16_DECODE_CASES = {
    **BF16_DECODE_CASES,
    "geometric_global": ("asset", {"direct_center": "geometric"}),
    "surface_global": ("asset", {"direct_center": "surface"}),
    "consensus_global": ("asset", {"direct_center": "consensus"}),
}
# The float16 FCN against JAX's float16 FCN: both round each layer's
# output to float16 (11 significant bits), so an output may differ by a
# step where the two float32 accumulations straddle a rounding boundary.
# Regression outputs reach |x| < 16 (8.4 with the mixed asset), where a
# step is 2**-7: two steps, 2**-6. The port reads one step at [4, 8),
# 2**-8, on the golden frames (CPU, both assets) and on the card. A
# float16 step of the regression is about JAX's own float16-vs-float32
# gap (4.5e-3), so what tells a float16 net from a wrong one is the share
# of regression outputs that differ at all: at most F16_REG_DIFFER_SHARE.
# The CPU reads 1.3 % and 0.7 % (shipped and mixed asset, the golden
# frames) and 1.1 % on the float16 golden's sample, an H100 6.6 % there
# (cuDNN sums in another order than XLA); rounding each convolution once
# instead of twice (a fused bias epilogue) moves 49 % and the float32 net
# 100 %. The probabilities come from the softmax in float32 of float16
# logits: the port reads 5.7e-5 to 1.5e-4 on the CPU and 2.1e-4 on an
# H100; F16_PROB_ATOL, 2**-9, is a quarter of a float16 step of a logit
# in [8, 16), and the bf16 net (7.3e-3) fails it.
F16_PROB_ATOL = 2.0**-9
F16_REG_ATOL = 2.0**-6
F16_REG_DIFFER_SHARE = 0.15


# tests/data/torch_port_golden_f8.npz: the small-float configurations
# (ops/small_float.py FORMATS, the names JAX's FCN runs in ml_dtypes'
# formats). For each format, JAX's FCN with the shipped asset on the
# multi golden's first F8_FRAMES two-vehicle frames, sampled at every
# FCN_REG_STRIDE-th pixel (`small_float_sample`): its features' codes
# ("<format>_features", uint8) and the foreground probability
# ("<format>_prob"); and JAX make_e2e_step(head="direct", max_obstacles=
# F8_E2E_K) with the asset in each of F8_E2E_FORMATS on the three frames
# ("e2e_<format>_{poses,found}"). On the CPU the port equals every sample
# code for code (a NaN's sign included) and every probability within
# F8_PROB_ATOL (it reads 2.3e-10: the softmax's own order). On the card
# cuDNN sums each convolution in another order than XLA, and a float32
# sum a step apart can round to another float16 and then another code:
# at least F8_FEATURES_SAME of the sampled codes must be JAX's there.
F8_FRAMES = 2
F8_E2E_K = 4
F8_E2E_FORMATS = ("float8_e4m3fn", "float8_e5m2")
F8_PROB_ATOL = 1e-7
F8_FEATURES_SAME = 0.99


# tests/data/torch_port_golden_f8_grad.npz (tests/make_torch_port_golden.py
# f8_grad): F8_GRAD_FRAMES beam scans of the port's numpy generator
# (`synthesize_beam_scan_batch`, seed F8_GRAD_SEED; "points", "valid",
# "center", "size", "yaw") and, for each format, JAX's loss and gradients
# of the shipped asset's FCN in that format on their full-width range
# views (train=True, the direct head's labels in the asset's yaw frame,
# LossConfig(**F8_GRAD_LOSS): the asset was trained with weight_bb 1):
# "<format>/loss" and "<format>/<layer>/<param>". On the CPU the port's
# first step gives every small-float gradient bit for bit and the input
# norm's within F8_GRAD_NORM_RTOL of its largest entry. On the card the
# dgrad and wgrad are cuDNN's float32 convolutions (TF32 off), whose sums
# run in another order than XLA's: a sum at a midpoint of float16 can
# round the other way and land a code apart. There at least F8_GRAD_SAME
# of each layer's gradient values must equal JAX's and every value lie
# within F8_GRAD_STEPS step of the format of JAX's. chip_smoke.py phase 1h
# read every value equal in float8_e4m3fn on an NVIDIA H100 80GB HBM3,
# 700.00 W (golden_grad_same 1.0, golden_grad_steps 0, PERF.md); the
# limits leave a layer of n values n // 1000 flips of one step: none in
# a bias or in conv1's 600-value kernel.
def format_steps(got: np.ndarray, want: np.ndarray, fmt) -> np.ndarray:
    """How many of the small-float format `fmt`'s values lie between got
    and want, element by element (0 where both are NaN, 2**20 where one
    alone is)."""
    import torch

    from tpufusion_torch.ops.small_float import encode

    def ordinal(v):
        c = encode(torch.from_numpy(np.ascontiguousarray(v, np.float32)), fmt)
        m = c & ~fmt.sign_bit
        return torch.where((c & fmt.sign_bit) != 0, -m, m).numpy()

    nan_g, nan_w = np.isnan(got), np.isnan(want)
    steps = np.abs(ordinal(got) - ordinal(want))
    return np.where(nan_g & nan_w, 0, np.where(nan_g | nan_w, 1 << 20, steps))


F8_GRAD_SEED = 24
F8_GRAD_FRAMES = 2
F8_GRAD_LOSS = {"weight_bb": 1.0}
F8_GRAD_NORM_RTOL = 1e-4
F8_GRAD_SAME = 0.999
F8_GRAD_STEPS = 1


# tests/data/torch_port_golden_f8_mesh.npz (tests/make_torch_port_golden.py
# f8_mesh): JAX's train step (`make_train_step(..., mesh=...)`) of the
# flagship FCN in F8_MESH_NAME without its input norm (`f8_mesh_config`,
# the weights of `FCN(..., seed=F8_MESH_SEED)`) on each mesh of
# F8_MESH_LAYOUTS (ranks, spatial ranks) over the virtual CPU devices, on
# F8_MESH_FRAMES beam scans at 32 x 201 (`f8_mesh_inputs`: the port's
# range views and direct labels, made on the host), LossConfig(
# **F8_GRAD_LOSS), optax's SGD at a rate of 1, so that each parameter's
# move is its gradient: "<layout>/loss" and "<layout>/<layer>/<param>",
# the gradient as the format's codes (uint8). XLA's partitioned program
# rounds and combines a small float's gradient where its mesh puts it, so
# each layout's gradients differ from one device's. The port on the CPU
# gives every code. On the card the dgrads are cuDNN's float32 sums in
# another order than XLA's, so there, as for the one-process golden, at
# least F8_GRAD_SAME of each tensor's values must equal JAX's and none lie
# more than F8_GRAD_STEPS step of the format off. (The transposed
# convolutions' wgrads run without cuDNN, `models/fcn.py::_GradConv`: with
# cuDNN, 29 of deconv5a's 17,600 kernel gradient values read 1-2 steps off
# on data x 2 on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md.)
F8_MESH_NAME = "float8_e4m3fn"
F8_MESH_SEED = 25
F8_MESH_FRAMES = 4
F8_MESH_POINTS = 4096
F8_MESH_LAYOUTS = {"data2": (2, 1), "spatial2": (2, 2), "2x2": (4, 2)}


def f8_mesh_config(name: str = F8_MESH_NAME, norm: bool = False):
    """The flagship FCN (direct head, width 2, linear regression output)
    computing in `name`, with or without its input norm."""
    import dataclasses

    from tpufusion_torch.config import ModelConfig

    return dataclasses.replace(ModelConfig(), head="direct", width_multiplier=2,
                               reg_output_activation="linear", dtype=name, batch_norm=norm)


def f8_mesh_inputs() -> tuple[np.ndarray, np.ndarray]:
    """(images (F8_MESH_FRAMES, 32, 201, 3), labels (..., 10)), float32:
    the port's range views and direct-head labels of F8_MESH_FRAMES beam
    scans (numpy seed F8_MESH_SEED), computed on the host's CPU."""
    import torch

    from tpufusion_torch.config import RangeViewSpec
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.encoding import encode_direct_label_batch
    from tpufusion_torch.geometry.range_view import range_view_project_batch

    spec = RangeViewSpec(res_h_deg=1.8)
    points, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(F8_MESH_SEED),
                                                   F8_MESH_FRAMES, F8_MESH_POINTS)
    with torch.no_grad():
        images = range_view_project_batch(torch.from_numpy(points), spec, torch.from_numpy(valid))
        labels = encode_direct_label_batch(*(torch.from_numpy(gt[k]) for k in ("center", "size",
                                                                                 "yaw")),
                                           images, spec)
    return images.numpy(), labels.numpy()


def f8_mesh_readings(grads: dict, loss: float, golden: dict, layout: str) -> dict:
    """A port step's gradients ({"<layer>.<param>": array}) and loss on
    `layout` against the mesh golden: {"same" (the smallest share of a
    tensor's values equal to JAX's), "worst" (that tensor), "steps" (the
    most steps of the format any value lies off), "loss_rel"}."""
    import torch

    from tpufusion_torch.ops.small_float import FORMATS, decode

    fmt = FORMATS[F8_MESH_NAME]
    same, worst, steps = 1.0, None, 0
    for name, g in grads.items():
        want = decode(torch.from_numpy(golden[f"{layout}/{name.replace('.', '/')}"]), fmt).numpy()
        n = format_steps(np.asarray(g, np.float32), want, fmt)
        if float((n == 0).mean()) < same or worst is None:
            same, worst = float((n == 0).mean()), name
        steps = max(steps, int(n.max()))
    want_loss = float(golden[f"{layout}/loss"])
    return {"same": same, "worst": worst, "steps": steps,
            "loss_rel": abs(loss - want_loss) / abs(want_loss)}


def small_float_sample(features_codes: np.ndarray, out: np.ndarray):
    """A small-float FCN's features as codes (B, H, W, 2) and its output
    (B, H, W, 2 + reg) -> what the f8 golden keeps: (the codes at every
    FCN_REG_STRIDE-th pixel (B, n, 2), the foreground probability there
    (B, n))."""
    b = out.shape[0]
    codes = np.asarray(features_codes, np.uint8).reshape(b, -1, 2)[:, ::FCN_REG_STRIDE]
    return codes, out[..., 1].reshape(b, -1)[:, ::FCN_REG_STRIDE]


def small_float_readings(codes: np.ndarray, prob: np.ndarray, want_codes: np.ndarray,
                         want_prob: np.ndarray) -> tuple[float, float, bool]:
    """(share of the sampled feature codes equal to the golden's, largest
    probability difference where both are finite, whether the NaN
    probabilities sit where the golden's do)."""
    nan, want_nan = np.isnan(prob), np.isnan(want_prob)
    both = ~nan & ~want_nan
    dp = float(np.abs(prob[both] - want_prob[both]).max()) if both.any() else 0.0
    return float((codes == want_codes).mean()), dp, bool(np.array_equal(nan, want_nan))


def fcn_sample_readings(out: np.ndarray, want_prob: np.ndarray, want_reg: np.ndarray):
    """The port's low-precision FCN output against a golden's sample of
    JAX's in the same dtype: (largest probability difference, largest
    regression difference, regression outputs that differ at all,
    regression outputs)."""
    prob, reg = fcn_golden_sample(out)
    dr = np.abs(reg - want_reg)
    return (
        float(np.abs(prob - want_prob).max()),
        float(dr.max()),
        int((dr > 0).sum()),
        dr.size,
    )


def bf16_decode_case(name: str, assets_dir: str, cases: dict = BF16_DECODE_CASES):
    """(FCN key, the port's DecodeConfig) of a BF16_DECODE_CASES (or
    `cases`) entry."""
    import dataclasses
    import os

    from tpufusion_torch.config import DecodeConfig
    from tpufusion_torch.models.io import asset_configs

    fcn, fields = cases[name]
    if fields is None:
        return fcn, DecodeConfig()
    _, dcfg = asset_configs(os.path.join(assets_dir, BF16_DECODE_FCNS[fcn]))
    return fcn, dataclasses.replace(dcfg, **fields)


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def near_tie_frames(points: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, N, 4) points and (B, N) validity -> the same frames with their
    first NEAR_TIE_DUPS points repeated and jittered at the end (B, N +
    NEAR_TIE_DUPS), the repeats as valid as their originals."""
    rng = np.random.default_rng(NEAR_TIE_SEED)
    dup = np.array(points[:, :NEAR_TIE_DUPS], np.float32)
    scale = 1.0 + rng.uniform(-NEAR_TIE_JITTER, NEAR_TIE_JITTER, (len(points), NEAR_TIE_DUPS, 1))
    dup[..., :3] *= scale.astype(np.float32)
    return (np.concatenate([points, dup], axis=1),
            np.concatenate([valid, valid[:, :NEAR_TIE_DUPS]], axis=1))


def near_tie_sets(points: np.ndarray, valid: np.ndarray) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """The packed golden's two frame sets from the bench golden's frames:
    {"": the near-tie frames, "short_": the same recipe on the first
    NEAR_TIE_SHORT - NEAR_TIE_DUPS points}, keyed by their prefix in the
    golden."""
    cut = NEAR_TIE_SHORT - NEAR_TIE_DUPS
    return {"": near_tie_frames(points, valid),
            "short_": near_tie_frames(points[:, :cut], valid[:, :cut])}


def frames_digest(points: np.ndarray, valid: np.ndarray) -> str:
    """sha256 of float32 points and bool validity, bytes in that order."""
    import hashlib

    h = hashlib.sha256(np.ascontiguousarray(points, np.float32).tobytes())
    h.update(np.ascontiguousarray(valid, bool).tobytes())
    return h.hexdigest()


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


def f16_bits(a: np.ndarray) -> np.ndarray:
    """float32 values that are exact in float16 -> their float16 bits."""
    h = np.asarray(a, np.float32).astype(np.float16)
    assert np.array_equal(h.astype(np.float32), np.asarray(a, np.float32)), "not exact in float16"
    return h.view(np.uint16)


def from_f16_bits(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, np.uint16).view(np.float16).astype(np.float32)


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
