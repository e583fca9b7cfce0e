"""Typed configuration tree of the port: its own copy of the dataclasses
of `tpufusion/config.py`, with the same names, fields, types and defaults
(`tests/test_torch_imports.py` holds the two equal), so the port imports
nothing of the JAX package. The field comments are shortened; the
reference file explains each choice in full.

Frozen dataclasses, so configs are hashable and compare by value.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class RangeViewSpec:
    """Cylindrical 360-degree range-view geometry: 1.33 deg vertical and
    0.2 deg horizontal resolution over (-30.67, 10.67) deg of elevation,
    a 32 x 1801 image."""

    res_v_deg: float = 1.33
    res_h_deg: float = 0.2
    vfov_lo_deg: float = -30.67
    vfov_hi_deg: float = 10.67
    min_height: float = -2.0
    max_height: float = 2.0

    @property
    def res_v_rad(self) -> float:
        return self.res_v_deg * math.pi / 180.0

    @property
    def res_h_rad(self) -> float:
        return self.res_h_deg * math.pi / 180.0

    @property
    def x_min(self) -> float:
        return -360.0 / self.res_h_deg / 2.0  # azimuth-pixel origin, -900

    @property
    def y_min(self) -> float:
        return self.vfov_lo_deg / self.res_v_deg  # elevation origin, ~ -23.06

    @property
    def x_max(self) -> int:
        return int(360.0 / self.res_h_deg)  # 1800

    @property
    def y_max(self) -> int:
        return int(abs(self.vfov_lo_deg - self.vfov_hi_deg) / self.res_v_deg)  # 31

    @property
    def width(self) -> int:
        return self.x_max + 1  # 1801

    @property
    def height(self) -> int:
        return self.y_max + 1  # 32


@dataclass(frozen=True)
class BevSpec:
    """Bird's-eye-view rasterization grid (+-120 m, MV3D log density)."""

    max_range: float = 120.0
    res_x: float = 0.2
    res_y: float = 1.33
    density_log_base: float = 64.0
    with_height_channel: bool = True
    with_intensity_channel: bool = True

    def _nbins(self, res: float) -> int:
        n_edges = int(math.ceil((2.0 * self.max_range - 1e-12) / res))
        return n_edges - 1

    @property
    def nx(self) -> int:
        return self._nbins(self.res_x)

    @property
    def ny(self) -> int:
        return self._nbins(self.res_y)


@dataclass(frozen=True)
class ModelConfig:
    """FCN encoder-decoder geometry."""

    num_classes: int = 2
    num_corner_outputs: int = 24  # 8 corners x xyz
    use_regression: bool = True
    vertical_stride: int = 1  # 1 for lidar, 2 for camera
    batch_norm: bool = True  # feature-wise BN on the input
    sample_wise_bn: bool = False  # per-pixel-position BN variant
    dtype: str = "float32"  # compute dtype of the conv stack
    reg_output_activation: str = "relu"  # "linear" for signed targets
    head: str = "corner"  # "corner" (24-dim field) or "direct" (pose head)
    width_multiplier: int = 1  # channel multiplier of the conv trunk
    yaw_codec: str = "single"  # "dual": local and global sin/cos pairs


@dataclass(frozen=True)
class LossConfig:
    """Class-balanced weighted loss."""

    use_w1: bool = True
    use_w2: bool = True
    obj_to_bkg_ratio: float = 0.00016
    avg_obj_size: float = 1000.0
    weight_bb: float = 0.01
    loss_scaler: float = 1000.0
    reg_target_norm_clip: float | None = None
    reference_compat: bool = False
    reg_channel_weights: tuple[float, ...] | None = None
    epsilon: float = 1e-7


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    epochs: int = 100
    learning_rate: float = 1e-3
    k_negative_sample_ratio_weight: float = 4.0
    augment: bool = True
    seed: int = 0
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 5
    log_every_steps: int = 10
    grad_accum_steps: int = 1
    divergence_check_every: int = 25
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_final_fraction: float = 0.01


@dataclass(frozen=True)
class DecodeConfig:
    """Pose decode thresholds and modes."""

    min_prob: float = 0.5
    min_bbox_area: float = 100.0
    min_heat: float = 2.0
    max_bbox_dist: float = 5.0
    range_offset: float = 0.75  # nearest-surface -> centroid correction
    margin_x: int = 100  # candidate scan margins around the 2D bbox
    margin_y: int = 2
    far_delta: tuple[float, float, float] = (9.0, 3.0, 3.0)
    max_candidates: int = 2048  # corner-vote budget (overflow reported)
    vote_window: int = 512
    max_cc_iters: int = 128  # bounds the plain CC sweeps only
    cc_impl: str = "auto"  # any value runs the CUDA kernel on the card
    direct_center: str = "backproject"  # geometric, surface, head, fit, silhouette
    fit_boundary: str = "ellipse"  # box, circle, auto
    fit_surface_scale: float = 0.9
    fit_boundary_oriented: str = "ellipse"
    fit_symmetric_scale: float = 0.8
    direct_yaw_frame: str = "local"  # global, auto


@dataclass(frozen=True)
class CameraConfig:
    """Camera input geometry."""

    width: int = 1368
    height: int = 512
    channels: int = 1
    crop_top: int = 430
    crop_bottom: int = 942


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip execution."""

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    n_devices: int = 0  # 0 = use all available
    n_spatial: int = 1  # 1 = pure data parallelism


@dataclass(frozen=True)
class PipelineConfig:
    """Root config."""

    range_view: RangeViewSpec = RangeViewSpec()
    bev: BevSpec = BevSpec()
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    decode: DecodeConfig = DecodeConfig()
    camera: CameraConfig = CameraConfig()
    mesh: MeshConfig = MeshConfig()
    max_points: int = 65536  # fixed per-frame point budget
    projection_method: str = "exact"  # the reference's nearest-wins rule

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = PipelineConfig()
