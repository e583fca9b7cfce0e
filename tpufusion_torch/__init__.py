"""tpufusion_torch — the PyTorch + CUDA port of tpufusion for NVIDIA Hopper.

The JAX package `tpufusion/` is the reference; this package mirrors its
module layout and names so each function has a findable counterpart, and
its tests hold the two to the same numpy inputs. Plain tensor code is
PyTorch; each of the reference's Pallas kernels is a CUDA C++ kernel
under `csrc/`, built for sm_90a at first use (`_build.py`) and launched
through a wrapper that takes the plain PyTorch version only for tensors
that lie on the CPU.

The port does everything the JAX package does: every public function
and class of `tpufusion/` has its counterpart here
(`tests/test_torch_imports.py` holds it to that; the exceptions are
named: the TPU-only scatter variants and probes, and renames). The
lidar detector's path, raw
points -> range view -> FCN (float32 or bf16) -> direct, top-K or corner
decode -> poses (`predict.make_e2e_step`, `serve.pipeline.LidarPipeline`),
the chunked replay server (`serve.replay.ReplayHarness`), the tracker
(`serve.tracker`), the bird's-eye view and the camera paint table
(`geometry.bev`, `geometry.camera`), the camera + lidar + radar fusion
net and its inference loop (`models.fusion`, `models.io.fusion_from_asset`,
`serve.fusion.predict_fusion`), the serving benchmarks (`benchmarks`,
configs 1-4), scoring and the submission writers (`eval`), numpy
generators (`data.synthetic`) to feed them where JAX is not installed,
and training: the label codecs (`geometry.encoding`), the roll
augmentation (`data.augment`), the class-balanced loss (`models.losses`),
the detector trainer (`train.trainer.Trainer`, `train.train_step`,
`data.pipeline.BatchPipeline`, `train.checkpoint`), the fusion trainer
(`train.fusion_trainer.train_fusion`) and the optimizer pieces with
optax's semantics (`train.optim`); data x spatial meshes
(`parallel.mesh`: torch.distributed, BatchNorm over the global batch, the
FCN's width sharded with `parallel.halo`'s exchanges;
`parallel.dryrun.dryrun_multichip`); the Keras importer
(`tools.import_keras`); and the offline drive: bags read and written
(`data.rosbag_reader`, with the native codec of `native`), the dataset
ETL (`data.etl`), `predict.predict_dataset_dir`, the CLI's extract,
train, predict, submit and score (`cli`) and their rehearsal
(`tools.rehearse_bag_pipeline`); the live viewer and its numpy JPEG
encoder (`serve.viewer`, `serve.jpeg`), the host tools (`tools.visualize`,
`tools.crops`, `tools.calibrate`, `tools.analyze`, `tools.datadiff`,
`tools.invariant_mask`) and the CLI's other seven subcommands (calibrate,
diff, analyze, overlay_radar, crops, edges, view); and the single-frame
entry points (`geometry.range_view_project`, `ops.connected_components`,
`decode.decode_frame`, `decode_frame_multi`, `decode_frame_direct`). cv2,
matplotlib and yaml are imported where a host tool uses them, and raise
ImportError on a host without them.

Every entry point takes `device` and defaults to "cuda": it moves its
model to the card and its inputs follow; without a card it raises. The
tests pass device="cpu".

Subpackages
-----------
geometry   range-view projection, pixel angles/points, box corners and
           rects, label codecs, BEV rasterizer, camera model and paint table
ops        nearest-wins z-buffer and connected components (kernel wrappers
           + plain versions), the BEV's count / max scatters
models     FCN (lidar, camera and BEV geometries; inference and training
           mode), FusionNet, the losses and metrics, npz weights in and out
train      optimizer pieces, train / eval steps, trainers, checkpoints,
           population statistics, PR curves
decode     direct-pose decode, corner vote, top-K
serve      single-frame server facade, replay server, fusion inference
           loop, multi-frame tracker, the live viewer (`serve.viewer`) and
           its baseline JPEG encoder (`serve.jpeg`, integer numpy)
eval       pose scoring, prediction CSV, tracklet XML, interpolation
data       numpy synthetic scenes (uniform clouds, beam-structured scans
           with circle, ellipse or box vehicles) and fusion frames,
           the join of the three sensor streams into fusion samples,
           timestamp alignment, radar tracks, the roll augmentation, the
           batch pipeline; ROS bags, LZ4, the dataset ETL, the registry
native     the bag reader's host codec (PointCloud2 unpack, LZ4) in C,
           built with cc at first use, loaded with ctypes
utils      logging
parallel   data x spatial meshes, their collectives and halo exchanges, the
           multi-rank dry run
tools      the detector trainer and its held-out eval, the operating-point
           tuner, the envelope and oracle sweeps, the fusion trainer, the
           full-size camera bench (their assets go to
           tpufusion_torch/assets/), the Keras importer, the bag ->
           submission rehearsal; the renders and overlays (`visualize`),
           crops, the extrinsic calibration, the GT analyzer, the dataset
           diff, the invariant mask
benchmarks configs 1-5
cli        extract, train, predict, submit, score, view; calibrate, diff,
           analyze, overlay_radar, crops, edges

The package imports nothing of the JAX package: it keeps its own copy of
the configuration dataclasses (`config.py`) and of the numpy modules it
needs (the tracker, the scoring, the camera model, the alignment, the
radar tracks, the submission writers, the bag reader, the registry, the
logging, the host tools), and `tests/test_torch_imports.py`
holds it to that.
"""

from tpufusion_torch.config import (  # noqa: F401
    DecodeConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
)
