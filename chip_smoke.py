#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpufusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--training-only]

It builds the CUDA kernels from the checkout's sources, holds each
against its plain PyTorch version on the card (phases 1b-3: real inputs
and the adversarial ones of `tpufusion_torch/ops/parity_inputs.py`, which
aim at fdlibm's branches and the pixel borders (the pixel kernel, bit for
bit, the plain version run on the CPU and on the card), at the CC's tile
borders at 32, 33, 63, 64 and 128 rows (batches 1
and 16; 64 in the cuda tests) and at 24,001 columns, and at the z-buffer's
cluster at 32 x 1801 and 63 x 1801), and drives the
lidar detector's serving paths at full geometry (32 x 1801 range view) through
the entry points a user calls, each with the kernels' launch counts set
to 0 before it and read after it, and then the training paths:

  phase 1b     the pixel kernel (`csrc/pixels.cu`: the range view's
               pixel ids, keys and payload, and project_2d) bit for bit
               its plain version on the main path's beam scans, config
               5's, the 63-row view's, and adversarial points
  phase 1c     the fused label encode (`csrc/label_encode.cu`) bit for
               bit its plain version at a train batch of 32 frames, 32
               and 63 rows, every footprint method: beam scans with their
               boxes, seam boxes, boxes all round, an image with no
               return, degenerate boxes; its device time in turns with
               the plain version (the composition it replaced), beside
               its bound
  phase 1d     the direct head's fused label encode (`csrc/label_encode.cu`,
               `tf_encode_direct_label`) bit for bit its plain version at
               32 frames, 32 and 63 rows, both footprints and all three
               yaw frames, on the same sets and on returns exactly on and
               one step outside the dilated box faces; its device time in
               turns with the plain version, 10 and 12 channels, beside
               its bound
  phase 1e     the direct head's per-cluster decode (`csrc/decode_direct.cu`,
               `tf_decode_direct`) against its plain version (found equal,
               poses within 1e-4, `_golden.direct_kernel_readings`) on the
               driven direct paths' inputs (the headline's flagship, whose
               random weights find no lane, the three assets, config 5's
               top-4, phase 25's 63 rows; no lane near a threshold, some
               lane found but the flagship's) and, with 1e-3 on bbox
               windows over 4,096 pixels, on every
               `parity_inputs.cluster_inputs` kind
               with every center, boundary and yaw frame at 32 and 63 rows,
               10 and 12 channels, and on `parity_inputs.crafted_lanes`
               (one-pixel windows, rows straddling a lane's CTAs, windows
               past every CTA's stage), each call twice, bit-identical;
               its device time in turns with the plain version at 64 x 32
               x 1801 (k 1), config 5's 16 frames (k 4) and 64 x 63 x
               1801, beside its bound and an empty kernel. A bf16 head
               output (the kernel's bf16 instance): the assets' driven
               outputs rounded to bf16 under the same contract (no lane near
               a threshold or a bf16 rounding midpoint), a probability of
               exactly bf16(0.7) at min_prob 0.7 (`parity_inputs.
               threshold_inputs`), and `decode_batch_direct` driven on the
               live asset's bf16 output and on the bf16 golden
               (`tests/data/torch_port_golden_bf16.npz`: found equal, poses
               within POSE_TOL of JAX's), its launches counted. A float16
               head output (the float16 instance) likewise: the driven
               outputs rounded to float16, a probability of exactly
               float16(0.8) at min_prob 0.8, `decode_batch_direct` on the
               live asset's float16 output and on the float16 golden
               (`tests/data/torch_port_golden_f16.npz`, every kernel
               center and silhouette at k 2 and 1: poses within 1e-4 of
               JAX's, each held to the plain version), and
               `make_e2e_step` with the asset's FCN in float16
  phase 1f     the corner head's vote (`csrc/corner_vote.cu`,
               `tf_corner_vote`) against its plain version
               (`_golden.corner_kernel_readings`: ok and overflow equal,
               and on the decided lanes the winner sets equal and pose and
               box within 1e-4) on the lanes the driven corner paths vote
               (phase 8's golden frames at K 2048 and 64, the hybrid
               corner head's k1 / k4 / bf16_k4 steps, the corner row's
               batches, config 2's replay chunks; no undecided lane), on
               frames that vote no lane beside frames that do (zeros, and
               the idle frames unread), and on every
               `parity_inputs.corner_inputs` kind at 32 and 63 rows
               (undecided lanes counted); each call twice, bit-identical;
               its device time in turns with
               the plain version at `kernel_bench.CORNER_SHAPES`, beside
               its bound (the larger of its bytes and its FP32 FMAs)
  phase 1g     the small floats (`csrc/small_float.cu`: the epilogue
               and the direct casts of the FCN in the nine formats of
               `ops/small_float.py`) bit for bit their plain version in
               every format and mode on every float16 pattern and seeded
               float32 values with the formats' edges, the direct cast
               (its vector design: Hopper's fp8 conversion for e4m3fn and
               e5m2) on every float32 bit pattern in the nine formats
               against the plain version on the card, and at the main
               path's shapes (float8_e4m3fn, 64 x 32 x 1801); each
               layer's float16 convolution against its float32 one
               rounded to float16; the asset's FCN in every format
               against the f8 golden (tests/data/torch_port_golden_f8.npz,
               feature codes and probabilities); `make_e2e_step` in
               float8_e4m3fn at 64 x 32,768, `LidarPipeline` in it on
               single frames, and the step in float8_e4m3fn and
               float8_e5m2 on the golden's frames against JAX's; the
               epilogue's device time in turns with its plain version and
               torch's cast chain, and the input cast's with its plain
               version and x.to(torch.float8_e4m3fn), beside their bounds
  phase 1h     training in the small floats (`csrc/small_float.cu`'s
               backward: a layer's cotangents summed at XLA's rounding
               points, relu's select, the bias gradient's reduce in
               XLA's windows, and a dgrad's or wgrad's rounding) bit for
               bit its plain version in every format on
               `parity_inputs.small_float_backward_cases` and on the
               calls of a train step at 2 and 32 frames; the reduce alone
               (its segment-map design) on adversarial windows
               (`parity_inputs.small_float_reduce_inputs`); `Trainer.fit`
               with the asset in float8_e4m3fn at 32 x 1801 held to the
               f8 gradient golden (tests/data/torch_port_golden_f8_grad.npz,
               JAX's gradients) at its first step, then an epoch on phase
               16's scene batches, its checkpoint resumed; a
               float8_e8m0fnu step (a NaN loss) aborting without a
               checkpoint and restoring one; the backward's device time
               beside its plain version and its bound
  phases 4-5   the float32 direct path with the shipped detector asset
               (`LidarPipeline.predict_position`, `make_e2e_step`,
               batch 64 x 32,768-point beam scans)
  phase 6      the asset's FCN in bf16 and in float16 against JAX's FCN
               in the same dtype (the multi and float16 goldens'
               samples) and against float32, `found` equal
  phase 7      config 5: bf16, top-4, batch 16 x 131,072 points (64
               beams), and a 16-frame two-vehicle sequence through
               `PoseTracker.run_multi`
  phase 8      the corner decode (`decode_batch`, `decode_batch_multi`,
               with the process's float32 matmuls set to TF32),
               a corner head end to end, and bench.py's corner row (bf16,
               batch 64 x 32,768)
  phase 9      the mixed-family and wide-yaw assets, top-4
  phase 10     times of config 5, the corner row, the FCN in float32,
               bf16 and float16, both
               kernels at 131,072 points per frame, the tracker
  phase 11     the BEV rasterizer on the card against the CPU and JAX's
               cells (beam scans and the edge-case cloud)
  phase 12     config 1: one frame x 32,768 points through range view +
               BEV + bf16 FCN (`benchmarks.config1_single_frame`)
  phase 13     config 3 at full width: batch 8 x 32,768 points, camera
               512 x 1368 painted onto the 1199 x 180 BEV, the bf16 BEV
               FCN and the late-fusion net with the shipped
               `fusion_net.npz` (`benchmarks.config3_fused`,
               `serve.fusion.predict_fusion`)
  phase 14     the replay server (`serve.replay.ReplayHarness`, chunk 64,
               270 frames, a pinned ring of 2) against `make_e2e_step`,
               then the prediction CSV, the tracklet XML and the scoring

  phase 15     one train step (`train.train_step.make_train_step`) against
               the reference's on 4 x 32,768 points: the asset's direct
               head in float32 and bf16, and a corner head rolled by the
               reference's shifts (labels, loss, metrics, every gradient
               tensor, the BatchNorm statistics after the step)
  phase 16     `train.trainer.Trainer.fit` at full width: 4 scene batches
               of 32 x 32,768 points through `BatchPipeline`, 2 epochs, a
               checkpoint, `resume()` into a fresh trainer, one more
               epoch; the default widths in bf16 with the corner head and
               the asset's direct-head geometry in float32; no host sync
               in the step loop; the step's time and its split
  phase 17     `train.fusion_trainer.train_fusion` at full width (camera
               512 x 1368, pools (2, 8) / (8, 8), bf16 FCNs, 32 frames,
               batch 8), unlocked and locked, and one fusion step against
               the reference's loss and gradients
  phase 18     config 4 (`benchmarks.config4_full_eval`): 128 frames at
               batch 32 x 32,768 with the shipped asset, CSV -> tracklet
               XML -> scoring, and its companion rows (the wide-yaw asset
               on ellipse scenes, the mixed-family asset on circle,
               ellipse and box scenes, 32 frames a family here, 128 in the
               benchmark's default, both kernels held on one batch of
               each family first); then with a
               detector quick-trained here at a reduced depth, without
               the companion rows (they use the shipped assets whatever
               the weights: the first run drove them)

  phase 19     data parallelism (`parallel/mesh.py`): (a) a mesh of one
               over NCCL: the mesh train step (bf16 default widths, corner
               head, roll) bit for bit the plain step at 32 x 32,768, no
               host sync in 8 profiled steps, the two steps timed in turns
               and the gradient all-reduce alone; (b) two ranks on the one
               card over gloo run `parallel.dryrun.dryrun_multichip`'s four
               phases at full geometry (32 x 1801, 32,768 points a frame),
               each held against one process, each rank holding both
               kernels against their plain versions on its own points;
               (c) the same on two ranks of the one card laid out as 1
               data x 2 spatial: the FCN width-sharded with halo
               exchanges (`parallel/halo.py`), the halo's columns and ms a
               step printed; in (b) and (c) the dry run's float8_e4m3fn
               case (`dryrun.small_float_phase`): the f8 mesh golden's
               step on that mesh, every rank's gradients held to JAX's
               same-mesh step (tests/data/torch_port_golden_f8_mesh.npz)
  phase 20     config 5 (`benchmarks.config5_waymo_scale`): 16 x 131,072
               points (64 beams) through the asset's top-4 decode, the
               two-vehicle sequence through the tracker, and the oriented
               row (the wide-yaw asset, ellipse vehicles, the physical
               frame); both kernels held on its clouds first
  phase 21     host-sync calls in 8 profiled steps of the direct f32 step,
               configs 1, 3 and 5 (the serving paths' host scalars)
  phase 22     the offline drive: (a) a 64-frame lz4 bag at the rehearsal's
               defaults (`tools.rehearse_bag_pipeline.synthesize_bag`:
               32,768-point beam scans, a 1096 x 1368 mono8 camera, radar
               tracks, a GT tracklet); (b) `data.etl.extract_bag_dataset`
               in RAM and streaming with the BEV: the two layouts equal,
               the z-buffer kernel bit-identical to plain on each batch of
               the bag's own NaN-padded clouds, the BEVs against the CPU's,
               the native codec (`tpufusion_torch/native/`) against its
               plain versions on the bag's payloads, with their MB/s;
               (c) `rehearse_bag_pipeline.main` through the port's CLI
               (extract -> train 40 epochs -> predict -> submit -> score):
               64 of 64 submission poses, `cli predict`'s CSV equal to
               `predict_images` of the restored checkpoint, the CC kernel
               against the plain sweeps on that model's heat masks
  phase 23     the training and tuning tools (`tpufusion_torch/tools/`), each
               through its main at full width: (a) the operating-point
               tuner on a copy of the shipped asset (32 frames, 4 x 4 x 7
               points, the confirmation, the 16,384-point pass), its row
               at the asset's operating point against `make_e2e_step` on
               the same frames, the CC kernel on its heat masks at every
               min_prob it sweeps, both kernels timed at the tools' shapes
               (32 x 32,768 points, 32 x 32 x 1801 masks); (b) the trainer
               warm-started from the asset, 4 steps at 16,384 / 32,768
               points, 2 evals, the asset it writes loaded back; (c) the
               envelope (14 conditions of 8 frames and the distance
               quartiles) and the oracle's four arms on the mixed asset,
               the z-buffer on the envelope's ellipse, box, 16,384- and
               65,536-point clouds; (d) the fusion tool at the 512 x 1368
               camera (16 + 8 frames, 1 epoch, both variants), its asset
               loaded by `fusion_from_asset`; (e) the camera bench at
               batch 8 with its five longest device kernels
  phase 24     the last modules, run with none of cv2, matplotlib or yaml:
               (a) the single-frame entry points on one 32,768-point frame
               (`range_view_project` against its batch row and the CPU,
               `decode_frame_direct` with the shipped asset against
               `decode_batch_direct`'s row, `decode_frame` and
               `decode_frame_multi` on a seeded default-width corner FCN,
               `connected_components` on the asset's heat mask against the
               plain sweeps, a 64-row mask labelled equal to the plain
               sweeps, one CC launch); (b) `view_dataset` on a
               raw points npz of 4 frames with a `.pt` checkpoint, the pushed
               windows captured, one z-buffer launch a frame; (c) the
               LiveViewer over HTTP on 127.0.0.1; (d) the port's JPEG
               encoder byte-equal to the viewer golden's cv2 bytes, its ms
               an encode; (e) calibrate, datadiff on phase 22's dir, the
               invariant mask, the polar histogram, the crop box, `cli diff`
               and `cli view` in subprocesses, and the subcommands that
               need cv2, matplotlib or yaml raising ImportError
  phase 25     a 64-beam sensor's 63 x 1801 range view
               (`RangeViewSpec(res_v_deg=0.665)`, two row tiles of the CC
               kernel): (a) the shipped asset's float32 direct step at
               64 x 32,768 points against the port on the CPU and the
               JAX golden tests/data/torch_port_golden_tall.npz, its
               found rate, xy error and times beside phase 5's; (b) config
               5's bf16 top-4 step at 16 x 131,072 points against the CPU;
               (c) the CC kernel on 64 x 63 x 1801 heat masks and on them
               with their rows doubled (64 x 128 x 1801), and the z-buffer
               into 63 x 1801, each beside its bound
  phase 26     the repo's headline (`tpufusion_torch/bench.py`, the
               counterpart of the root `bench.py`, and `entry.py`, of
               `__graft_entry__.py`): (a) `bench.run` at its defaults
               (the bf16 seed-0 flagship at 64 x 32,768 over 24 sets, the
               live asset, the corner row, the single-frame p50) with the
               headline's split and both kernels on its first batch; (b)
               the flagship step with bench.py's JAX weights against
               tests/data/torch_port_golden_bench.npz in bf16 and float32,
               the card's range views of its frames equal to JAX's;
               (c) `entry()`'s fn with JAX's entry state against JAX's
               answer on all 4 frames; (d) `python -m
               tpufusion_torch.bench --sets 2`
  phase 27     the reference's other projection methods: (a) the packed
               z-buffer kernel (`csrc/nearest_wins_packed.cu`, the
               reference's quantized-key `nearest_wins_scatter_packed`)
               bit for bit its plain version on the bench golden's beam
               scans, the near-tie frames, NaN / inf clouds with padding at
               32,768 and 32,769 points and the adversarial z-buffer inputs
               with near ties at 32,768, 32,769 and 131,072 points and into
               63 x 1801, and the edges of its grid in the cluster's shared
               memory (points on the CTAs' slice boundaries, every pixel
               occupied, the ragged last slice at 63 rows, a 690 x 1801
               image in two bands); (b) every method's range views of the near-tie
               frames against tests/data/torch_port_golden_packed.npz
               (sha256, the pixels "packed" moves off "exact"; "scatter",
               "sort16" and "pallas" equal "exact"; "sort16" refusing
               33,792 points as the reference does); (c) `LidarPipeline`,
               `ReplayHarness` and the asset's step with the packed
               projection against the CPU and the golden; (d) the packed
               kernel, the exact one, `scatter_reduce_` of the int32 packs
               + the gather, and the plain version in turns at 64 x 32,768
               and 16 x 131,072 and at 64 x 32,768 into 63 x 1801, beside
               their bound; the A/B tool
               (`tools.bench_projection_ab --methods exact,packed --e2e`)
               and phase 26's packed row

The pixel and z-buffer kernels run on every path that projects points
(one pixel launch a z-buffer launch, exact or packed, which `drive`
asserts; the packed one only where a path asks for method "packed",
bench.py's packed row and phase 27); configs 1
and 3 and the train steps decode nothing, so the CC kernel is not on
theirs; the label encode of a corner head's train or eval step launches
the fused label-encode kernel once (the roll's rect still launches
project_2d), a direct head's the direct label-encode kernel once. Every
call of `decode_batch_direct` at a center other than "silhouette"
launches the direct decode kernel once: the direct paths name it in
`drive`'s `expect`, and a corner path or one that decodes nothing must
not launch it. Phases 12 and 13 hold the z-buffer
kernel against its plain version on their own points (1 x 32,768 and the
8 x 32,768 camera-wedge scans) before they drive the path.

Every answer is held against the committed JAX goldens
(tests/data/torch_port_golden.npz, torch_port_golden_multi.npz,
torch_port_golden_fusion.npz, torch_port_golden_train.npz,
torch_port_golden_tall.npz, torch_port_golden_bench.npz), and the
viewer's JPEG bytes against torch_port_golden_viewer.npz (cv2's);
times are CUDA events over distinct inputs, and for the kernels also
device time (the calls queued behind a `torch.cuda._sleep`, then timed
between CUDA events, `kernel_bench.queued_ms`).

With --training-only it builds the kernels and runs phases 15-18 alone
(about a minute; their times then stand without the earlier phases'
tensors on the card) and prints no kernels line; --sync-counts runs
phase 21 alone (it uses only entry points an earlier tree of the port
has too, so the same script counts a parent commit's syncs).

Every phase asserts; a failure raises, so the exit code is non-zero and
the final line is never printed. Without a CUDA device it exits non-zero
at once. The last three lines are a JSON object with the per-kernel
results (launches on the driven paths, largest difference from the plain
version, and at 64 x 32,768 the kernel's, the plain version's and the
library yardstick's device time in turns (the plain CC's time a call: it
reads a flag back each sweep), and the kernel's time a call,
beside the kernel's bound: its bytes at 3.35 TB/s,
`tpufusion_torch/kernel_bench.py`; and phase 25's device times and
bounds at 63 and 128 rows; for the pixel kernel also the torch
composition it replaced and the whole projection with each, and
project_2d at a train batch's label points; for the label encodes their
plain versions' at 32 and 63 rows), the card's
`name, power.limit` as nvidia-smi reports them, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tpufusion_torch.benchmarks import card_line
from tpufusion_torch.kernel_bench import (
    CORNER_SHAPES,
    DECODE_SHAPES,
    cc_bound_ms,
    device_ms,
    packed_amin_yardstick,
    queued_each,
    queued_ms,
    scatter_amin_yardstick,
    time_ms,
    time_turns,
    zbuffer_bound_ms,
)

BATCH = 64  # frames per batch on the e2e path and the corner row
N_POINTS = 32768  # points per frame
REQUESTS = 8  # single-frame requests the server answers
TIMED_BATCHES = 12  # distinct batches per timing
C5_BATCH = 16  # config 5: frames per batch
C5_POINTS = 131072  # config 5: points per frame (64 beams x 2,048 azimuths)
C5_BEAMS = 64
C5_TIMED = 6  # config 5: distinct batches per timing
TRACK_FRAMES = 16  # config 5's tracking sequence (two vehicles, 32,768 points)
SWEEP_CAP = 16384  # plain CC sweeps: the serpentines need ~9,000 to converge
# phase 3: a 32-row mask of 376 column tiles, 12,000 border pairs to merge
WIDE_COLUMNS = 24001
# card vs JAX-on-CPU golden (CUDA atan2f/sinf/cosf ulps), poses from the
# bf16 FCN included: they read 3.8e-6 on an H100, and rounding each bf16
# convolution once instead of twice (a fault) moves them 3.7e-3
POSE_TOL = 1e-3
F16_POSE_TOL = 1e-4  # a float16 head output's decode against JAX's (the CPU reads 3.8e-6)
HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "tpufusion", "assets")
ASSET = os.path.join(ASSETS, "synthetic_detector.npz")
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_golden.npz")
GOLDEN_MULTI = os.path.join(HERE, "tests", "data", "torch_port_golden_multi.npz")
GOLDEN_FUSION = os.path.join(HERE, "tests", "data", "torch_port_golden_fusion.npz")
GOLDEN_TRAIN = os.path.join(HERE, "tests", "data", "torch_port_golden_train.npz")
GOLDEN_VIEWER = os.path.join(HERE, "tests", "data", "torch_port_golden_viewer.npz")
GOLDEN_TALL = os.path.join(HERE, "tests", "data", "torch_port_golden_tall.npz")
GOLDEN_F16 = os.path.join(HERE, "tests", "data", "torch_port_golden_f16.npz")
GOLDEN_F8 = os.path.join(HERE, "tests", "data", "torch_port_golden_f8.npz")
GOLDEN_F8_GRAD = os.path.join(HERE, "tests", "data", "torch_port_golden_f8_grad.npz")
GOLDEN_F8_MESH = os.path.join(HERE, "tests", "data", "torch_port_golden_f8_mesh.npz")
GOLDEN_BENCH = os.path.join(HERE, "tests", "data", "torch_port_golden_bench.npz")
GOLDEN_PACKED = os.path.join(HERE, "tests", "data", "torch_port_golden_packed.npz")
GOLDEN_BF16 = os.path.join(HERE, "tests", "data", "torch_port_golden_bf16.npz")
TRAIN_BATCH = 32  # frames per train batch (phases 16 and 18)
TRAIN_SCENE_BATCHES = 4  # phase 16: distinct scene batches in the dataset
FUSION_TRAIN_FRAMES = 32  # phase 17
C4_FRAMES = 128  # config 4
# config 4's companion rows, frames a family: the benchmark's default is
# C4_FRAMES; here fewer, to keep the script's time
C4_COMPANION_FRAMES = 32
C4_COMPANIONS = 4  # companion protocols: wide yaw, then circle, ellipse, box
DP_RANKS = 2  # phase 19 (b): ranks sharing the one card over gloo
SPATIAL_RANKS = 2  # phase 19 (c): a 1 x 2 spatial mesh on the one card over gloo
SYNC_STEPS = 8  # phase 21: profiled steps a path
# phase 22, the offline drive at the rehearsal's defaults (64 frames of
# N_POINTS, 40 epochs at batch 16); extract_bag_dataset's batch is its own
# default, 32, as in the CLI
DRIVE_FRAMES = 64
DRIVE_EPOCHS = 40
DRIVE_TRAIN_BATCH = 16
DRIVE_BATCH = 32
DRIVE_PLAIN_CHUNKS = 4  # lz4 chunks decoded by the pure-Python decoder too
FUSION_ASSET = os.path.join(ASSETS, "fusion_net.npz")
# phase 23, the tools: their default batch, the tuner's per-resolution pass
# and the trainer's second sweep resolution, the envelope's batch
TOOL_BATCH = 32
TOOL_SPARSE = 16384
ENVELOPE_BATCH = 8
VIEW_FRAMES = 4  # phase 24: frames of the raw points npz view_dataset replays
JPEG_REPS = 10  # phase 24: encodes a frame for the JPEG encoder's time
# phase 24: datadiff's tolerance; one timestamp of phase 22's 64 is 1.6 %,
# under the default 5 %
DIFF_REL_TOL = 0.01
C3_BATCH = 8  # config 3: frames per batch
TALL_TIMED = 6  # phase 25: distinct 63-row batches per timing
HEADLINE_SPLIT = 6  # phase 26: the headline's first batches, timed stage by stage
REPLAY_FRAMES = 270  # the replay server: 4 chunks of 64 and a partial one
REPLAY_CHUNK = 64
# benchmarks.measure at its defaults: a warm-up and 6 inputs x 3 between the
# events, then a warm-up and the 6 inputs once more for the device time
MEASURE_CALLS = 1 + 6 * 3 + 1 + 6
# the port's kernels, by the names of the kernels line; a driven path's
# `expect` names those it must launch
KERNELS = ("project_points", "project_2d", "nearest_wins_image", "connected_components_with_bbox",
           "nearest_wins_packed_image", "encode_label", "encode_direct_label", "decode_direct",
           "corner_vote", "small_float", "small_float_cast", "small_float_backward",
           "small_float_reduce")
SERVING = ("project_points", "nearest_wins_image", "connected_components_with_bbox")
RANGE_VIEW = SERVING[:2]  # a path that projects points and decodes nothing
CC_ONLY = SERVING[2:]  # a decode of a view or a mask it is given
PACKED = ("project_points", "nearest_wins_packed_image", "connected_components_with_bbox")
DRIVE_COUNTS = KERNELS[2:4]  # the counts `drive` returns: the exact z-buffer's and the CC's
DIRECT = SERVING + ("decode_direct",)  # a path that decodes with the direct head
CORNER = SERVING + ("corner_vote",)  # a path that decodes with the corner head
DIRECT_TRAIN = DIRECT + ("encode_direct_label",)  # a direct head's training with its evals
SMALL_FLOAT = ("small_float", "small_float_cast")  # a small-float forward: its input's cast
SMALL_FLOAT_TRAIN = ("small_float_backward", "small_float_reduce")  # its backward: bias gradients
PACKED_TIMED = 4  # phase 27: distinct input sets a shape for the packed kernel's times
PIXEL_SETS = 4  # phase 5: distinct batches for the pixel kernel's times
DECODE_SETS = 4  # phase 1e: distinct batches a shape for the direct decode's times
CORNER_SETS = 4  # phase 1f: distinct batches a shape for the corner vote's times
CAST_CHUNK = 1 << 26  # phase 1g: float32 patterns a chunk of the cast's exhaustive check
# phase 1g: the chunks also cast as an NHWC input of 1 x 16 x (CAST_CHUNK // 48) x 3 (their
# first patterns: 2.0, 2^121 (up to inf and NaN), -2.0, -2^121 (up to -inf and -NaN))
NHWC_CHUNKS = (0x40000000, 0x7C000000, 0xC0000000, 0xFC000000)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Prints a line; a phase's first line also says when it started (s
    since the script began)."""
    if msg.startswith("phase "):
        msg += f" [at {time.perf_counter() - _T0:.0f} s]"
    print(msg, flush=True)


def _reset_launches() -> None:
    from tpufusion_torch.ops import (
        cc,
        corner_vote,
        decode_direct,
        label_encode,
        pixels,
        projection,
        small_float,
    )

    pixels.LAUNCHES = pixels.LAUNCHES_2D = projection.LAUNCHES = cc.LAUNCHES = 0
    projection.PACKED_LAUNCHES = label_encode.LAUNCHES = label_encode.LAUNCHES_DIRECT = 0
    decode_direct.LAUNCHES = corner_vote.LAUNCHES = small_float.LAUNCHES = 0
    small_float.CAST_LAUNCHES = small_float.BACKWARD_LAUNCHES = small_float.REDUCE_LAUNCHES = 0


def _launches() -> dict[str, int]:
    from tpufusion_torch.ops import (
        cc,
        corner_vote,
        decode_direct,
        label_encode,
        pixels,
        projection,
        small_float,
    )

    return {"project_points": pixels.LAUNCHES, "project_2d": pixels.LAUNCHES_2D,
            "nearest_wins_image": projection.LAUNCHES,
            "connected_components_with_bbox": cc.LAUNCHES,
            "nearest_wins_packed_image": projection.PACKED_LAUNCHES,
            "encode_label": label_encode.LAUNCHES,
            "encode_direct_label": label_encode.LAUNCHES_DIRECT,
            "decode_direct": decode_direct.LAUNCHES, "corner_vote": corner_vote.LAUNCHES,
            "small_float": small_float.LAUNCHES,
            "small_float_cast": small_float.CAST_LAUNCHES,
            "small_float_backward": small_float.BACKWARD_LAUNCHES,
            "small_float_reduce": small_float.REDUCE_LAUNCHES}


def drive(label: str, fn, totals: dict[str, int], expect=SERVING):
    """Runs one path with every kernel's launch count set to 0, asserts
    that it launched each kernel of `expect` (the kernels on that path),
    the packed z-buffer and the direct decode and corner vote kernels only
    if `expect` names them (a corner path launches no direct decode, a
    direct path no corner vote, a path that decodes nothing neither), and
    that each range
    view went through the pixel kernel (as many pixel launches as z-buffer
    launches, exact and packed), and adds its counts to `totals`.
    Returns (fn's result, the exact z-buffer's and the CC's counts)."""
    _reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _launches()
    log(f"  {label}: kernel launches {counts}")
    for k, n in counts.items():
        assert n > 0 or k not in expect, f"{label} never launched {k}"
        totals[k] += n
    assert counts["nearest_wins_packed_image"] == 0 or "nearest_wins_packed_image" in expect, (
        f"{label} launched the packed z-buffer")
    assert counts["decode_direct"] == 0 or "decode_direct" in expect, (
        f"{label} launched the direct decode kernel")
    assert counts["corner_vote"] == 0 or "corner_vote" in expect, (
        f"{label} launched the corner vote kernel")
    assert counts["small_float"] == 0 or "small_float" in expect, (
        f"{label} launched the small-float kernel")
    for k in ("small_float_cast", "small_float_reduce"):
        assert counts[k] == 0 or k in expect, f"{label} launched {k}"
    assert counts["small_float_backward"] == 0 or "small_float_backward" in expect, (
        f"{label} launched the small-float backward")
    assert counts["project_points"] == (
        counts["nearest_wins_image"] + counts["nearest_wins_packed_image"]), (
        f"{label}: a range view without the pixel kernel")
    return out, {k: counts[k] for k in DRIVE_COUNTS}


def _abs_err(got, want) -> float:
    """The largest |got - want| over two tensors or tuples of them (None
    skipped): 0 where both are NaN or the same infinity, inf where one
    alone is NaN."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g is None:
            continue
        g, w = g.cpu().double(), w.cpu().double()
        if not torch.equal(g.isnan(), w.isnan()):
            return float("inf")
        d = (g - w).abs()[~((g == w) | g.isnan())]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def _same_bits(got, want) -> bool:
    """Bit-identical tensors (a float's bits, so -0.0 is not 0.0)."""
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.shape == want.shape and torch.equal(got, want)


def check_pixels(label: str, points, valid, spec) -> int:
    """Holds the pixel kernel against its plain version on the same (B, N,
    C) points, run on the CPU and on the card: every output bit-identical,
    one launch. Returns the largest integer difference (0)."""
    from tpufusion_torch.ops import pixels

    with torch.inference_mode():
        before = pixels.LAUNCHES
        got = pixels.project_points(points, valid, spec)
        torch.cuda.synchronize()
        assert pixels.LAUNCHES == before + 1, "pixel kernel not launched"
        want = pixels.project_points_reference(points.cpu(), None if valid is None else valid.cpu(),
                                               spec)
        card = pixels.project_points_reference(points, valid, spec)
    same = all(_same_bits(g, w) for g, w in zip(got, want))
    card_same = all(_same_bits(c, w) for c, w in zip(card, want))
    err = max(int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got[:3], want[:3]))
    log(f"  pixel kernel on {label} ({' x '.join(map(str, points.shape))}, "
        f"{'no mask' if valid is None else 'masked'}, {spec.height} rows): bit-identical to "
        f"plain = {same}, plain on the card = plain on the CPU: {card_same}; ok "
        f"{int(got[2].sum())} of {got[2].numel()}")
    assert same, f"pixel kernel differs from its plain version ({label})"
    assert card_same, f"the plain version on the card differs from the CPU's ({label})"
    return err


def check_project_2d(label: str, xyz, spec) -> int:
    """Holds project_2d's kernel against its plain version on (n, 3)
    coordinates on the card, run on the CPU and on the card. Returns the
    largest difference (0)."""
    from tpufusion_torch.ops import pixels

    x, y, z = (xyz[:, i].contiguous() for i in range(3))
    before = pixels.LAUNCHES_2D
    got = pixels.project_2d(x, y, z, spec)
    torch.cuda.synchronize()
    assert pixels.LAUNCHES_2D == before + 1, "project_2d kernel not launched"
    want = pixels.project_2d_reference(x.cpu(), y.cpu(), z.cpu(), spec)
    card = pixels.project_2d_reference(x, y, z, spec)
    same = all(_same_bits(g, w) for g, w in zip(got, want))
    card_same = all(_same_bits(c, w) for c, w in zip(card, want))
    log(f"  project_2d kernel on {label} ({len(xyz)} points, {spec.height} rows): "
        f"bit-identical to plain = {same}, plain on the card = plain on the CPU: {card_same}")
    assert same, f"project_2d kernel differs from its plain version ({label})"
    assert card_same, f"project_2d's plain version on the card differs from the CPU's ({label})"
    return max(int((g.cpu() - w).abs().max()) for g, w in zip(got, want))


def phase_pixels(dev, spec, scans) -> tuple[int, int]:
    """Phase 1b: the pixel kernel (`csrc/pixels.cu`) against its plain
    versions: `tf_project_points` on the main path's beam scans (BATCH x
    N_POINTS), config 5's C5_BATCH x C5_POINTS (64 beams), the 63-row
    spec, and the adversarial points of `parity_inputs.pixel_points` (C =
    3 and 4, masked and not); `tf_project_2d` on seeded box corners and
    the adversarial coordinates. Returns the largest difference of each."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.boxes import box_corners_3d
    from tpufusion_torch.ops import parity_inputs

    t0 = time.perf_counter()
    tall = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
    log("phase 1b pixel kernel (tf_project_points, tf_project_2d) against its plain "
        "version, bit for bit")
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    c5, _, c5v = synthesize_beam_scan_batch(np.random.default_rng(600), C5_BATCH, C5_POINTS,
                                            n_beams=C5_BEAMS)
    t63, _, t63v = synthesize_beam_scan_batch(np.random.default_rng(3), BATCH, N_POINTS,
                                              n_beams=TALL_BEAMS)
    cases = [("the main path's beam scans", on(scans[0]), on(scans[1]), spec),
             ("config 5's beam scans", on(c5), on(c5v), spec),
             (f"{TALL_BEAMS}-beam scans", on(t63), on(t63v), tall)]
    for s_ in (spec, tall):
        for channels in (4, 3):
            p, v = parity_inputs.pixel_points(s_, batch=4, n=N_POINTS, channels=channels)
            cases.append((f"adversarial points, C = {channels}", on(p), on(v), s_))
        cases.append(("adversarial points", on(p), None, s_))
    err = max(check_pixels(label, p, v, s_) for label, p, v, s_ in cases)
    rng = np.random.default_rng(5)
    n = 4096
    center = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                       rng.uniform(-2.5, 0.5, n)], -1).astype(np.float32)
    size = np.stack([rng.uniform(3, 6, n), rng.uniform(1.5, 2.5, n),
                     rng.uniform(1.2, 2.0, n)], -1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    corners = box_corners_3d(on(center)[:, None], on(size)[:, None], on(yaw)[:, None])
    err_2d = max(max(check_project_2d("seeded box corners", corners.reshape(-1, 3), s_),
                     check_project_2d("adversarial coordinates",
                                      on(parity_inputs.pixel_fixed_points()), s_))
                 for s_ in (spec, tall))
    log(f"  phase 1b took {time.perf_counter() - t0:.1f} s")
    return err, err_2d


def pixel_turns(spec, sets) -> dict:
    """The pixel kernel's device time (`queued_ms`) and time a call on
    distinct (points, valid) batches, in turns with the torch composition
    it replaced, and its plain version's on the card, beside its bound;
    and the whole projection (pixels + z-buffer) with the kernel and with
    that composition. project_2d at a train batch's labels (TRAIN_BATCH
    boxes: 8 corners and a center each). Times in ms."""
    from tpufusion_torch.kernel_bench import (
        empty_kernel,
        pixels_bound_ms,
        project_2d_bound_ms,
        torch_pixels_composition,
        torch_project_2d_composition,
    )
    from tpufusion_torch.ops import pixels, projection

    idx = list(range(len(sets)))
    fns = {
        "kernel": lambda i: pixels.project_points(*sets[i], spec),
        "composition": lambda i: torch_pixels_composition(*sets[i], spec),
    }
    plain = {"plain": lambda i: pixels.project_points_reference(*sets[i], spec)}
    t = time_turns(fns, idx, queued_ms)
    t.update(time_turns(plain, idx, queued_each))
    t.update({f"{k}_call": v for k, v in time_turns({**fns, **plain}, idx).items()})
    views = {
        "view": lambda i: projection.nearest_wins_image(*pixels.project_points(*sets[i], spec), spec),
        "view_before": lambda i: projection.nearest_wins_image(
            *torch_pixels_composition(*sets[i], spec), spec),
    }
    t.update(time_turns(views, idx, queued_ms))
    t["bound"] = float(np.mean([pixels_bound_ms(*a) for a in sets]))
    dev = sets[0][0].device
    labels = [torch.randn((TRAIN_BATCH * 9, 3), generator=torch.Generator().manual_seed(i)).mul(
        20).to(dev) for i in idx]
    xyz = [tuple(c[:, j].contiguous() for j in range(3)) for c in labels]
    fns2 = {"kernel": lambda i: pixels.project_2d(*xyz[i], spec),
            "plain": lambda i: pixels.project_2d_reference(*xyz[i], spec)}
    t2 = time_turns(fns2, idx, queued_each)
    t2.update({f"{k}_call": v for k, v in time_turns(fns2, idx).items()})
    floor = {"kernel_q": fns2["kernel"],
             "composition": lambda i: torch_project_2d_composition(*xyz[i], spec),
             "empty": empty_kernel}
    t2.update(time_turns(floor, idx, queued_ms))
    t2["composition_call"] = time_turns({"c": floor["composition"]}, idx)["c"]
    t2["bound"] = project_2d_bound_ms(TRAIN_BATCH * 9)
    assert all(v > 0 for d in (t, t2) for v in d.values()), f"a time not measured: {t} {t2}"
    return {"points": t, "2d": t2}


def pixel_line(t: dict) -> str:
    p, q = t["points"], t["2d"]
    return (f"pixel kernel device time (a call): {p['kernel']:.4f} ({p['kernel_call']:.4f}) ms, "
            f"bound {p['bound']:.4f} ms, kernel at {p['bound'] / p['kernel']:.1%} of it; plain "
            f"on the card {p['plain']:.4f} ({p['plain_call']:.4f}) ms; the torch composition it "
            f"replaced {p['composition']:.4f} ({p['composition_call']:.4f}) ms; the projection "
            f"(pixels + z-buffer) {p['view']:.4f} ms, with the composition {p['view_before']:.4f} "
            f"ms; project_2d at {TRAIN_BATCH * 9} label points {q['kernel']:.4f} "
            f"({q['kernel_call']:.4f}) ms, plain {q['plain']:.4f} ({q['plain_call']:.4f}) ms, "
            f"bound {q['bound']:.6f} ms; in turns queued together: project_2d {q['kernel_q']:.4f} "
            f"ms, the torch composition it replaced {q['composition']:.4f} "
            f"({q['composition_call']:.4f}) ms, an empty kernel {q['empty']:.4f} ms (the launch "
            f"floor)")


def check_label_encode(label: str, args, spec) -> float:
    """Holds the fused label-encode kernel against its plain version on the
    card, every footprint method, on (center, size, yaw, image): bit for
    bit, one launch a call and no project_2d launch. Returns the largest
    difference (0)."""
    from tpufusion_torch.geometry.encoding import encode_label_reference
    from tpufusion_torch.ops import label_encode, pixels

    err, fg = 0.0, {}
    for method in label_encode.METHODS:
        before = (label_encode.LAUNCHES, pixels.LAUNCHES_2D)
        got = label_encode.encode_label(*args, spec, method)
        torch.cuda.synchronize()
        assert (label_encode.LAUNCHES, pixels.LAUNCHES_2D) == (before[0] + 1, before[1]), (
            "encode_label: not one kernel launch")
        want = encode_label_reference(*args, spec, method)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))  # on the card: 192 MB
        err = max(err, float((got - want).abs().nan_to_num(0.0).max()))
        fg[method] = int(want[..., 1].sum())
        assert same, f"encode_label kernel differs from its plain version ({label}, {method})"
    log(f"  encode_label on {label} ({' x '.join(map(str, args[3].shape))}): bit-identical to "
        f"plain for {', '.join(label_encode.METHODS)}; footprint pixels {fg}")
    return err


def phase_label_encode(dev, scans) -> tuple[float, dict]:
    """Phase 1c: the fused label-encode kernel (`csrc/label_encode.cu`)
    against its plain version at a train batch (TRAIN_BATCH frames) at 32
    and 63 rows: the main path's beam scans with their boxes, then
    `parity_inputs.label_inputs`' seam boxes, boxes all round, an image
    with no return and degenerate boxes; then its device time in turns
    with the plain version (the composition it replaced) beside its bound.
    Returns (largest difference, times at each height)."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.encoding import encode_label_reference
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.kernel_bench import label_encode_bound_ms
    from tpufusion_torch.ops import label_encode, parity_inputs

    t0 = time.perf_counter()
    log(f"phase 1c fused label encode (tf_encode_label) against its plain version, bit for "
        f"bit, at {TRAIN_BATCH} frames")
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    err, times = 0.0, {}
    for spec, beams, rows in ((RangeViewSpec(), 32, 32),
                              (RangeViewSpec(res_v_deg=TALL_RES_V_DEG), TALL_BEAMS, 63)):
        if rows == 32:
            pts, gt, valid = scans
            pts, valid = pts[:TRAIN_BATCH], valid[:TRAIN_BATCH]
            gt = {k: v[:TRAIN_BATCH] for k, v in gt.items()}
        else:
            pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(16), TRAIN_BATCH,
                                                        N_POINTS, n_beams=beams)
        with torch.inference_mode():
            images = range_view_project_batch(on(pts), spec, on(valid))
        boxes = [on(gt[k]) for k in ("center", "size", "yaw")]
        err = max(err, check_label_encode(f"{beams}-beam scans, {rows} rows", boxes + [images],
                                          spec))
        for kind in parity_inputs.LABEL_KINDS:
            args = [on(a) for a in parity_inputs.label_inputs(spec, TRAIN_BATCH, kind, seed=rows)]
            err = max(err, check_label_encode(f"{kind} boxes, {rows} rows", args, spec))
        sets = [[on(a) for a in parity_inputs.label_inputs(spec, TRAIN_BATCH, seed=1600 + i)]
                for i in range(PIXEL_SETS)]
        fns = {"kernel": lambda a: label_encode.encode_label(*a, spec),
               "plain": lambda a: encode_label_reference(*a, spec)}
        with torch.inference_mode():
            t = time_turns(fns, sets, lambda fn, xs: (
                queued_ms if fn is fns["kernel"] else queued_each)(fn, xs))
            t.update({f"{k}_call": v for k, v in time_turns(fns, sets).items()})
        t["bound"] = float(np.mean([label_encode_bound_ms(*a) for a in sets]))
        assert all(v > 0 for v in t.values()), f"a time not measured: {t}"
        times[rows] = t
        log(f"  encode_label at {TRAIN_BATCH} x {rows} x {spec.width}: kernel {t['kernel']:.4f} "
            f"({t['kernel_call']:.4f}) ms, bound {t['bound']:.4f} ms, kernel at "
            f"{t['bound'] / t['kernel']:.1%} of it; plain (the composition it replaced) "
            f"{t['plain']:.4f} ({t['plain_call']:.4f}) ms")
    log(f"  phase 1c took {time.perf_counter() - t0:.1f} s")
    return err, times


def check_direct_encode(label: str, args, spec) -> float:
    """Holds the direct head's label-encode kernel against its plain
    version on the card, each footprint and yaw frame, on (center, size,
    yaw, image): bit for bit, one launch a call and no project_2d or
    corner launch. Returns the largest difference (0)."""
    from tpufusion_torch.geometry.encoding import encode_direct_label_reference
    from tpufusion_torch.ops import label_encode, pixels

    def count():
        return label_encode.LAUNCHES_DIRECT, pixels.LAUNCHES_2D, label_encode.LAUNCHES

    err, fg = 0.0, {}
    for footprint in label_encode.FOOTPRINTS:
        for yaw_frame in label_encode.YAW_FRAMES:
            before = count()
            got = label_encode.encode_direct_label(*args, spec, footprint, yaw_frame)
            torch.cuda.synchronize()
            assert count() == (before[0] + 1, before[1], before[2]), (
                "encode_direct_label: not one kernel launch")
            want = encode_direct_label_reference(*args, spec, footprint, yaw_frame)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            err = max(err, float((got - want).abs().nan_to_num(0.0).max()))
            fg[f"{footprint}/{yaw_frame}"] = int(want[..., 1].sum())
            assert same, (f"encode_direct_label kernel differs from its plain version ({label}, "
                          f"{footprint}, {yaw_frame})")
    log(f"  encode_direct_label on {label} ({' x '.join(map(str, args[3].shape))}): "
        f"bit-identical to plain for every footprint and yaw frame; footprint pixels {fg}")
    return err


def phase_direct_encode(dev, scans) -> tuple[float, dict]:
    """Phase 1d: the direct head's label-encode kernel
    (`csrc/label_encode.cu::tf_encode_direct_label`) against its plain
    version at a train batch (TRAIN_BATCH frames) at 32 and 63 rows, both
    footprints and all three yaw frames: the main path's beam scans with
    their boxes, then every `parity_inputs.label_inputs` kind (seam, all
    round, no return, degenerate, and returns on and one step outside the
    dilated box faces); then its device time in turns with the plain
    version (the composition it replaced) at 10 and 12 channels beside
    its bound. Returns (largest difference, times by (rows, yaw frame))."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.encoding import encode_direct_label_reference
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.kernel_bench import DIRECT_TIMED, direct_encode_bound_ms
    from tpufusion_torch.ops import label_encode, parity_inputs

    t0 = time.perf_counter()
    log(f"phase 1d direct label encode (tf_encode_direct_label) against its plain version, bit "
        f"for bit, at {TRAIN_BATCH} frames")
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    err, times = 0.0, {}
    for spec, beams, rows in ((RangeViewSpec(), 32, 32),
                              (RangeViewSpec(res_v_deg=TALL_RES_V_DEG), TALL_BEAMS, 63)):
        if rows == 32:
            pts, gt, valid = scans
            pts, valid = pts[:TRAIN_BATCH], valid[:TRAIN_BATCH]
            gt = {k: v[:TRAIN_BATCH] for k, v in gt.items()}
        else:
            pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(16), TRAIN_BATCH,
                                                        N_POINTS, n_beams=beams)
        with torch.inference_mode():
            images = range_view_project_batch(on(pts), spec, on(valid))
        boxes = [on(gt[k]) for k in ("center", "size", "yaw")]
        err = max(err, check_direct_encode(f"{beams}-beam scans, {rows} rows", boxes + [images],
                                           spec))
        for kind in parity_inputs.LABEL_KINDS:
            args = [on(a) for a in parity_inputs.label_inputs(spec, TRAIN_BATCH, kind, seed=rows)]
            err = max(err, check_direct_encode(f"{kind} boxes, {rows} rows", args, spec))
        sets = [[on(a) for a in parity_inputs.label_inputs(spec, TRAIN_BATCH, seed=1700 + i)]
                for i in range(PIXEL_SETS)]
        for footprint, yaw_frame in DIRECT_TIMED:
            fns = {"kernel": lambda a: label_encode.encode_direct_label(*a, spec, footprint,
                                                                         yaw_frame),
                   "plain": lambda a: encode_direct_label_reference(*a, spec, footprint,
                                                                    yaw_frame)}
            with torch.inference_mode():
                t = time_turns(fns, sets, lambda fn, xs: (
                    queued_ms if fn is fns["kernel"] else queued_each)(fn, xs))
                t.update({f"{k}_call": v for k, v in time_turns(fns, sets).items()})
            channels = label_encode.direct_channels(yaw_frame)
            t["bound"] = float(np.mean([direct_encode_bound_ms(*a, channels) for a in sets]))
            assert all(v > 0 for v in t.values()), f"a time not measured: {t}"
            times[rows, yaw_frame] = t
            log(f"  encode_direct_label ({footprint}, {yaw_frame}: {channels} channels) at "
                f"{TRAIN_BATCH} x {rows} x {spec.width}: kernel {t['kernel']:.4f} "
                f"({t['kernel_call']:.4f}) ms, bound {t['bound']:.4f} ms, kernel at "
                f"{t['bound'] / t['kernel']:.1%} of it; plain (the composition it replaced) "
                f"{t['plain']:.4f} ({t['plain_call']:.4f}) ms")
    log(f"  phase 1d took {time.perf_counter() - t0:.1f} s")
    return err, times


def phase_decode_direct(dev) -> tuple[float, dict, int, dict]:
    """Phase 1e: the direct decode kernel (`csrc/decode_direct.cu`)
    against its plain version (`decode_direct_clusters_reference`) on the
    inputs of the driven direct paths (the headline's flagship and
    DecodeConfig's default, the three shipped assets in bf16 at their
    operating points at k 1 and 4 (the two ellipse-fit assets' top-4 at 16
    frames only), on 64 x 32,768 beam scans, config 5's 16 x 131,072
    points, and both at phase 25's 63 rows), each held to the contract
    with no lane near a threshold, then on every `parity_inputs.
    cluster_inputs` kind at 32 and 63 rows, 10 and 12 channels, with every
    center, boundary and yaw frame (a lane near a threshold counted and
    exempt); the same driven outputs rounded to bf16 and to float16, the
    bf16 and float16 threshold pixels, and `decode_batch_direct` driven on
    bf16 and float16 outputs (the live asset's, the goldens' against
    JAX's answers) and `make_e2e_step` with the asset's FCN in float16;
    then its device
    time in turns with the plain version at `kernel_bench.DECODE_SHAPES`
    beside its bound and an empty kernel. Returns (largest pose
    difference, times by shape, near lanes, the driven calls' launches)."""
    from tpufusion_torch import DecodeConfig, RangeViewSpec
    from tpufusion_torch._golden import (
        BF16_DECODE_CASES,
        BF16_DECODE_K,
        F16_DECODE_CASES,
        F16_DECODE_K,
        TALL_BEAMS,
        TALL_RES_V_DEG,
        bf16_decode_case,
        from_bf16_bits,
        from_f16_bits,
        load_npz,
        wrapped_pose_diff,
    )
    from tpufusion_torch.benchmarks import CFG, asset_model, point_sets, seeded_fcn
    from tpufusion_torch.decode import decode as td
    from tpufusion_torch.entry import FLAGSHIP
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.kernel_bench import decode_direct_rows
    from tpufusion_torch.ops import decode_direct, parity_inputs

    t0 = time.perf_counter()
    log("phase 1e direct decode (tf_decode_direct) against its plain version")
    err, near = 0.0, 0
    driven = dict.fromkeys(KERNELS, 0)
    bf16, f16 = torch.bfloat16, torch.float16

    def held(label, y_pred, images, spec, cfg, k, strict=True, empty=False):
        """strict: a driven path's inputs, every lane within the 1e-4 limit
        and none near a threshold, and some lane found unless `empty`;
        else the adversarial clusters (wide windows at 1e-3, near lanes
        counted and exempt)."""
        nonlocal err, near
        r = decode_direct.against_plain(y_pred, images, spec, cfg, k, adversarial=not strict)
        err = max(err, r["diff"], r["diff_wide"])
        near += r["near"]
        if strict or not r["ok"] or r["near"]:
            log(f"  {label} ({cfg.direct_center}, {cfg.fit_boundary}, {cfg.direct_yaw_frame}, "
                f"k {k}): {r}")
        assert r["ok"], f"decode_direct differs from its plain version ({label})"
        assert not strict or r["near"] == 0, f"{label}: a lane near a threshold"
        assert not strict or empty or r["found"] > 0, f"{label}: no lane found"

    assets = {n: asset_model(os.path.join(ASSETS, n)) for n in (
        "synthetic_detector.npz", "synthetic_detector_yaw.npz", "synthetic_detector_mixed.npz")}
    tall = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
    for spec, beams, frames, n_points in ((RangeViewSpec(), 32, BATCH, N_POINTS),
                                          (RangeViewSpec(), C5_BEAMS, C5_BATCH, C5_POINTS),
                                          (tall, TALL_BEAMS, BATCH, N_POINTS),
                                          (tall, TALL_BEAMS, C5_BATCH, C5_POINTS)):
        (p, v), = point_sets(1, frames, n_points, dev, n_beams=beams, seed0=1900 + beams)
        with torch.inference_mode():
            images = range_view_project_batch(p, spec, v)
            shape = f"{frames} x {spec.height} x {spec.width}"
            if beams == 32:  # the headline's flagship at DecodeConfig's default
                # its random weights find no lane: this checks only an empty decode
                flagship = seeded_fcn(dataclasses.replace(CFG.model, **FLAGSHIP), 0, dev)
                held(f"the headline's flagship (finds no lane: an empty decode), {shape}",
                     flagship(images), images, spec, CFG.decode, 1, empty=True)
            for name, (model, dcfg, _) in assets.items():
                y_pred = model.to(dev).eval()(images)
                # the plain 37-heading fits hold (B, k, 37, H, W) tensors:
                # top-4 of the ellipse assets at config 5's 16 frames only
                oriented = name != "synthetic_detector.npz"
                for k in (1,) if oriented and frames > C5_BATCH else (1, 4):
                    held(f"{name}, {shape}", y_pred, images, spec, dcfg, k)
                    held(f"{name} in bf16, {shape}", y_pred.to(bf16), images, spec, dcfg, k)
                    held(f"{name} in float16, {shape}", y_pred.to(f16), images, spec, dcfg, k)
                if name == "synthetic_detector.npz":
                    held(f"{name}, {shape}", y_pred, images, spec, DecodeConfig(), 4)
                    held(f"{name} in bf16, {shape}", y_pred.to(bf16), images, spec,
                         DecodeConfig(), 4)
                    held(f"{name} in float16, {shape}", y_pred.to(f16), images, spec,
                         DecodeConfig(), 4)
    n_cases = 0
    for spec in (RangeViewSpec(), RangeViewSpec(res_v_deg=TALL_RES_V_DEG)):
        for channels in (10, 12):
            options = parity_inputs.cluster_decode_options(channels)
            for kind in parity_inputs.CLUSTER_KINDS:
                y_pred, images = (torch.from_numpy(a).to(dev) for a in parity_inputs.cluster_inputs(
                    spec, kind, batch=4, seed=spec.height + channels, channels=channels))
                for name, fields in options.items():
                    held(f"clusters {kind}, {spec.height} rows, {channels} channels, {name}",
                         y_pred, images, spec, DecodeConfig(**fields), 4, strict=False)
                    n_cases += 1
    log(f"  the adversarial clusters: {n_cases} cases held, lanes near a threshold (exempt) "
        f"{near}; largest pose difference over every input {err:.3e}")
    # hand-made windows the heat mask never makes: one pixel, rows that
    # straddle the lane's CTAs, 20 rows x the frame's width (past every
    # CTA's stage), clusters with no m or no return; two calls bit-identical
    n_crafted = 0
    for spec in (RangeViewSpec(), RangeViewSpec(res_v_deg=TALL_RES_V_DEG)):
        for channels in (10, 12):
            y_pred, images, *comps, root, found = (
                torch.from_numpy(a).to(dev) for a in parity_inputs.crafted_lanes(
                    spec, batch=4, seed=spec.height, channels=channels))
            for name, fields in parity_inputs.cluster_decode_options(channels).items():
                r = decode_direct.lanes_against_plain(y_pred, images, comps, root, found, spec,
                                                      DecodeConfig(**fields), adversarial=True)
                err = max(err, r["diff"], r["diff_wide"])
                near += r["near"]
                if not r["ok"] or r["near"]:
                    log(f"  crafted lanes, {spec.height} rows, {channels} channels, {name}: {r}")
                assert r["ok"] and r["repeatable"], f"decode_direct on crafted lanes ({name})"
                assert r["windows"] == 20 * spec.width
                n_crafted += 1
    log(f"  the crafted lanes: {n_crafted} cases held (one-pixel, straddling and "
        f"{20 * RangeViewSpec().width}-pixel windows), every call repeatable bit for bit; "
        f"largest pose difference {err:.3e}")
    # a probability of exactly bf16(0.7) at min_prob 0.7 (float16(0.8) at
    # 0.8) counts where a step below it does not, in the kernel as in its
    # plain version
    spec = RangeViewSpec()
    for dtype in ("bfloat16", "float16"):
        min_prob = parity_inputs.THRESHOLDS[dtype][0]
        y, images, _ = parity_inputs.threshold_inputs(spec, dtype=dtype)
        y = torch.from_numpy(y).to(dev).to(getattr(torch, dtype))
        images = torch.from_numpy(images).to(dev)
        for name, fields in parity_inputs.cluster_decode_options(10).items():
            cfg = DecodeConfig(**dict(fields, min_prob=min_prob))
            held(f"a {dtype} probability at min_prob {min_prob}, {name}", y, images, spec, cfg,
                 4)
            with torch.inference_mode():
                poses = td.decode_batch_direct(y, images, spec, cfg, 4)["poses"]
            assert not torch.equal(poses[0], poses[1]), (
                f"{name}: the {dtype} pixel at the threshold was dropped")
        log(f"  a {dtype} probability of exactly {parity_inputs.THRESHOLDS[dtype][1]} at "
            f"min_prob {min_prob}: counted in {len(parity_inputs.cluster_decode_options(10))} "
            "cases, kernel as plain")
    # decode_batch_direct driven on bf16 and float16 outputs: the live
    # asset's on a 64-frame batch, and the goldens' against JAX's answers;
    # make_e2e_step with the asset's FCN in float16 (whose float32 output
    # the kernel's float32 instance decodes)
    model, dcfg, _ = assets["synthetic_detector.npz"]
    (p, v), = point_sets(1, BATCH, N_POINTS, dev, seed0=1933)
    with torch.inference_mode():
        images = range_view_project_batch(p, spec, v)
        y_live = model(images)
    for dtype in (bf16, f16):
        y_pred = y_live.to(dtype)
        with torch.inference_mode():
            out, _ = drive(f"decode_batch_direct on the live asset's {dtype} output, "
                           f"{BATCH} frames",
                           lambda: td.decode_batch_direct(y_pred, images, spec, dcfg, 1), driven,
                           expect=CC_ONLY + ("decode_direct",))
        assert out["poses"].dtype == torch.float32 and bool(out["found"].any())
    from tpufusion_torch.predict import make_e2e_step

    f16_model, _ = asset_fcn(ASSET, "float16", dev)
    f16_step = make_e2e_step(f16_model, spec, dcfg, head="direct", device=dev)
    (poses, found), _ = drive(f"make_e2e_step with the asset's FCN in float16, {BATCH} frames",
                              lambda: f16_step(p, v), driven, expect=DIRECT)
    with torch.inference_mode():
        want = td.decode_batch_direct(f16_model(images), images, spec, dcfg, 1)
    assert torch.equal(found, want["found"][:, 0]) and bool(found.any())
    golden_err = 0.0
    gb, gh = load_npz(GOLDEN_BF16), load_npz(GOLDEN_F16)
    images = torch.from_numpy(gb["images"]).to(dev)
    runs = []  # (case, the golden's dtype, the golden, its key, k, tolerance, config, y_pred)
    for name in BF16_DECODE_CASES:
        fcn, cfg = bf16_decode_case(name, ASSETS)
        y_pred = torch.from_numpy(from_bf16_bits(gb[f"{fcn}_bits"])).to(dev).to(bf16)
        runs.append((name, "bf16", gb, name, BF16_DECODE_K, POSE_TOL, cfg, y_pred))
    for name in F16_DECODE_CASES:
        fcn, cfg = bf16_decode_case(name, ASSETS, F16_DECODE_CASES)
        y_pred = torch.from_numpy(from_f16_bits(gh[f"{fcn}_bits"])).to(dev).to(f16)
        runs += [(name, "float16", gh, name, F16_DECODE_K, F16_POSE_TOL, cfg, y_pred),
                 (name, "float16", gh, f"{name}_k1", 1, F16_POSE_TOL, cfg, y_pred)]
    for name, tag, gold, key, k, tol, cfg, y_pred in runs:
        expect = CC_ONLY + (() if cfg.direct_center == "silhouette" else ("decode_direct",))
        with torch.inference_mode():
            out, _ = drive(f"decode_batch_direct on the {tag} golden, {key}",
                           lambda: td.decode_batch_direct(y_pred, images, spec, cfg, k),
                           driven, expect=expect)
        d = float(wrapped_pose_diff(out["poses"].cpu().numpy(), gold[f"{key}_poses"]).max())
        same = np.array_equal(out["found"].cpu().numpy(), gold[f"{key}_found"])
        golden_err = max(golden_err, d)
        log(f"  the {tag} golden, {key}: found equal {same}, poses {d:.3e} from JAX's "
            f"(tolerance {tol:.0e})")
        assert same and d <= tol, f"the {tag} golden, {key}: the card differs from JAX"
        if tag == "float16" and k == F16_DECODE_K and cfg.direct_center != "silhouette":
            held(f"the float16 golden, {name}", y_pred, images, spec, cfg, k)
    log(f"  bf16 and float16: the driven decodes' launches {driven}; the goldens within "
        f"{golden_err:.3e}")
    # the aten ops a call dispatches after the CC, kernel against plain, on
    # the live asset's first 64-frame batch (a dispatch mode counts them:
    # torch.profiler is kept out of this process's early phases)
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    model, dcfg, _ = assets["synthetic_detector.npz"]
    (p, v), = point_sets(1, BATCH, N_POINTS, dev, seed0=1932)
    with torch.inference_mode():
        images = range_view_project_batch(p, RangeViewSpec(), v)
        y_pred = model(images)
        comps = td._heat_components(y_pred[..., 1], dcfg)
        root, found, *_ = td._topk_roots(*comps, dcfg, 1)
        ops = {}
        for label, fn in (("kernel", decode_direct.decode_direct_clusters),
                          ("plain", td.decode_direct_clusters_reference)):
            with OpCount() as count:
                fn(y_pred, images, *comps, root, found, RangeViewSpec(), dcfg, dcfg.direct_center)
            ops[label] = count.n
    log(f"  aten ops dispatched a call after the CC (the live asset, fit circle global, {BATCH} frames, "
        f"k 1): kernel path {ops['kernel']}, plain version {ops['plain']}")
    times = {}
    for row in decode_direct_rows(DECODE_SETS):
        times[row["shape"]] = row
        log(f"  decode_direct at {row['shape']}: kernel {row['new_device_ms']:.4f} "
            f"({row['new_call_ms']:.4f}) ms, plain (the composition it replaced) "
            f"{row['plain_device_ms']:.4f} ({row['plain_call_ms']:.4f}) ms, empty kernel "
            f"{row['empty_device_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_bytes']:.0f} B needed, {row['window_pixels']:.0f} window pixels, "
            f"{row['found_lanes']:.1f} found lanes "
            f"a set), kernel at {row['bound_ms'] / row['new_device_ms']:.1%} of it")
    assert set(times) == {s[0] for s in DECODE_SHAPES}
    log(f"  phase 1e took {time.perf_counter() - t0:.1f} s")
    return err, times, near, driven


def phase_corner_vote(dev, gm) -> tuple[float, dict, dict]:
    """Phase 1f: the corner vote kernel (`csrc/corner_vote.cu`) against its
    plain version (`corner_vote_reference`), held to
    `_golden.corner_kernel_readings`, on the lanes the driven corner paths
    vote: phase 8's golden corner frames at K 2048 and 64 (k 1 and 4), the
    hybrid corner head's k1 / k4 / bf16_k4 steps on the golden's frames,
    the corner row's batches and config 2's replay chunks (both the seeded
    corner FCN, which brings no lane to stage 2), none undecided; then every
    `parity_inputs.corner_inputs` kind at 32 and 63 rows, K 64 and 2048
    (undecided lanes counted); then its device time in turns with the plain
    version at `kernel_bench.CORNER_SHAPES` beside its bound. Returns
    (largest pose or box difference, times by shape, lane counts)."""
    from tpufusion_torch import DecodeConfig, RangeViewSpec
    from tpufusion_torch._golden import TALL_RES_V_DEG
    from tpufusion_torch.benchmarks import CFG, point_sets, seeded_fcn
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.kernel_bench import corner_fcn, corner_vote_rows
    from tpufusion_torch.ops import corner_vote, parity_inputs

    t0 = time.perf_counter()
    log("phase 1f corner vote (tf_corner_vote) against its plain version")
    spec = RangeViewSpec()
    lanes = {"voted": 0, "decided": 0, "undecided": 0, "sensitive": 0,
             "adversarial_undecided": 0}
    err = sensitive_err = 0.0

    def held(label, y, images, cfg, k):
        nonlocal err, sensitive_err
        bbox, c3, stage2 = corner_vote.corner_lanes(y, images, spec, cfg, k)
        r = corner_vote.against_plain(y, images, bbox, c3, stage2, spec, cfg)
        log(f"  {label} (K {cfg.max_candidates}, k {k}): {r}")
        err = max(err, r["diff"])
        lanes["voted"] += r["lanes"]
        lanes["decided"] += r["lanes"] - r["undecided"]
        lanes["undecided"] += r["undecided"]
        lanes["sensitive"] += r["sensitive"]
        sensitive_err = max(sensitive_err, r["diff_sensitive"])
        assert r["ok"], f"corner_vote differs from its plain version ({label})"
        assert r["undecided"] == 0, f"{label}: an undecided lane on a driven path"

    with torch.inference_mode():
        images = range_view_project_batch(
            torch.from_numpy(gm["multi_points"][:2]).to(dev), spec,
            torch.from_numpy(gm["multi_valid"][:2]).to(dev))
        y = torch.from_numpy(gm["corner_ypred"]).to(dev)
        for cfg in (DecodeConfig(), DecodeConfig(max_candidates=64)):
            for k in (1, 4):
                held("phase 8's golden corner frames", y, images, cfg, k)
        pts = torch.from_numpy(gm["multi_points"]).to(dev)
        valid = torch.from_numpy(gm["multi_valid"]).to(dev)
        images = range_view_project_batch(pts, spec, valid)
        for tag, dtype, k in (("k1", "float32", 1), ("k4", "float32", 4),
                              ("bf16_k4", "bfloat16", 4)):
            hybrid, hcfg = corner_fcn("hybrid", dev, dtype)
            held(f"the hybrid corner head's {tag} step, {len(pts)} golden frames",
                 hybrid(images), images, hcfg, k)
        row = seeded_fcn(CFG.model, 0, dev)
        for label, seed0 in (("the corner row's batch", 100), ("config 2's replay chunk", 0)):
            for i, (p, v) in enumerate(point_sets(2, BATCH, N_POINTS, dev, seed0=seed0)):
                im = range_view_project_batch(p, spec, v)
                held(f"{label} {i}, {BATCH} x {N_POINTS}", row(im), im, CFG.decode, 1)
        # frames that vote no lane beside frames that do: zeros there, and
        # nothing of those frames read (NaN and an all-positive map change
        # nothing)
        from tpufusion_torch.decode.decode import _positives

        for kind in ("ties", "budget", "random"):
            arrays = parity_inputs.corner_inputs(spec, kind, batch=8, seed=11)
            y, im, bbox, c3, voted = (torch.from_numpy(a).to(dev) for a in arrays)
            voted[1::2] = False
            r = corner_vote.against_plain(y, im, bbox, c3, voted, spec, CFG.decode)
            assert r["ok"] and r["zeros"], f"corner_vote with idle frames ({kind}): {r}"
            pos = _positives(y[..., 1], CFG.decode)
            want = corner_vote.corner_vote_lanes(y, im, bbox, c3, voted, spec, CFG.decode, pos)
            y[1::2], pos[1::2] = float("nan"), True
            got = corner_vote.corner_vote_lanes(y, im, bbox, c3, voted, spec, CFG.decode, pos)
            assert all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
                       for g, w in zip(got, want)), f"an idle frame was read ({kind})"
            log(f"  idle frames beside voting ones ({kind}, 8 frames, 4 idle): {r}; the idle "
                f"frames' y_pred and map unread")
        n_cases = 0
        for rows_spec in (spec, RangeViewSpec(res_v_deg=TALL_RES_V_DEG)):
            for kind in parity_inputs.CORNER_KINDS:
                arrays = parity_inputs.corner_inputs(rows_spec, kind, batch=4,
                                                     seed=rows_spec.height)
                y, im, bbox, c3, voted = (torch.from_numpy(a).to(dev) for a in arrays)
                for k in (64, 2048):
                    cfg = DecodeConfig(max_candidates=k)
                    r = corner_vote.against_plain(y, im, bbox, c3, voted, rows_spec, cfg)
                    log(f"  corner_inputs {kind}, {rows_spec.height} rows, K {k}: {r}")
                    assert r["ok"], f"corner_vote differs from its plain version ({kind})"
                    err = max(err, r["diff"])
                    lanes["adversarial_undecided"] += r["undecided"]
                    n_cases += 1
    log(f"  driven lanes: {lanes['voted']} voted, {lanes['decided']} decided, "
        f"{lanes['undecided']} undecided, {lanes['sensitive']} pose-sensitive (the plain pose "
        f"formula held on the kernel's box; their pose against the plain pose "
        f"{sensitive_err:.3e}); the adversarial inputs: {n_cases} cases, undecided "
        f"lanes (counted, exempt) {lanes['adversarial_undecided']}; largest pose or box "
        f"difference {err:.3e}")
    times = {}
    for r in corner_vote_rows(CORNER_SETS):
        times[r["shape"]] = r
        log(f"  corner_vote at {r['shape']}: kernel {r['new_device_ms']:.4f} "
            f"({r['new_call_ms']:.4f}) ms, plain (the composition it replaced) "
            f"{r['plain_device_ms']:.4f} ({r['plain_call_ms']:.4f}) ms, empty kernel "
            f"{r['empty_device_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
            f"({r['bound_bytes']:.0f} B, {r['bound_fmas']:.4g} FMAs, {r['voted_lanes']:.1f} voted "
            f"lanes, {r['candidates']:.1f} candidates a set), kernel at "
            f"{r['bound_ms'] / r['new_device_ms']:.1%} of it; undecided / pose-sensitive lanes "
            f"in its check {r['undecided_lanes']} / {r['sensitive_lanes']}")
    log(f"  phase 1f took {time.perf_counter() - t0:.1f} s")
    return err, times, lanes


def phase_small_float(dev, spec, gm, scans) -> tuple[dict, dict]:
    """Phase 1g: the small floats (`csrc/small_float.cu`, both modes)
    against the plain version (`ops/small_float.py`, run on the CPU) bit
    for bit in every format: every float16 pattern and seeded float32
    values with the formats' edges (`parity_inputs.small_float_inputs`),
    the direct casts into each output, the epilogue with and without
    relu, float32 and float16 in; then on
    the card at the main path's shapes (the asset in float8_e4m3fn at 64 x
    32 x 1801: the input cast, each kernel's cast and each layer's
    epilogue, the plain version on the card); the float32 against the
    float16 convolution (`fcn.SMALL_FLOAT_CONV`'s choice): each layer's
    raw output on the same inputs, float16 against float32's rounded to
    float16, and after the epilogue; the asset's FCN in every format
    against the f8 golden (`tests/data/torch_port_golden_f8.npz`), at
    least F8_FEATURES_SAME of the feature codes JAX's in each; `make_e2e_step`
    in float8_e4m3fn at 64 x 32,768 through `drive`, `LidarPipeline` in it
    on REQUESTS single frames against the step's answers, and the step in
    each of F8_E2E_FORMATS on the golden's frames (found equal, poses
    within POSE_TOL); the epilogue's device
    time in turns with its plain version and torch's cast chain
    (`kernel_bench.small_float_rows`). Returns (its readings, the driven
    launches)."""
    from tpufusion_torch._golden import (
        F8_E2E_FORMATS,
        F8_E2E_K,
        F8_FEATURES_SAME,
        F8_FRAMES,
        load_npz,
        small_float_readings,
        small_float_sample,
        wrapped_pose_diff,
    )
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.kernel_bench import small_float_layers, small_float_rows
    from tpufusion_torch.models import fcn
    from tpufusion_torch.ops import parity_inputs
    from tpufusion_torch.ops import small_float as sf
    from tpufusion_torch.predict import make_e2e_step

    t0 = time.perf_counter()
    log("phase 1g small floats (tf_small_float_epilogue, tf_small_float_cast) against their "
        "plain version")
    out: dict = {"err": 0.0}
    patterns, values = parity_inputs.small_float_inputs(seed=23)
    f16 = torch.from_numpy(patterns.view(np.float16))
    sets = {"every float16 pattern": f16, "every float16 pattern as float32": f16.float(),
            "float32 values": torch.from_numpy(values)}
    brng = np.random.default_rng(5)
    biases = {"edge biases": torch.tensor([0.0, -0.0, float("inf"), float("nan"), 448.0, 1e-3,
                                           -2.5, 3.4e38]),
              "seeded biases": torch.from_numpy(brng.normal(0, 1, 8).astype(np.float32))}
    n_checks = n_elems = 0

    def held(label, got, want):
        nonlocal n_checks, n_elems
        got = got.cpu()
        if not sf.same_bits(got, want):
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[want.element_size()]
            g, w = got.reshape(-1).view(ints), want.reshape(-1).view(ints)
            bad = torch.nonzero(g != w).reshape(-1)
            log(f"  {label}: {bad.numel()} of {w.numel()} differ, first at "
                f"{bad[:8].tolist()}: kernel {g[bad[:8]].tolist()}, plain {w[bad[:8]].tolist()}")
            raise AssertionError(f"small_float differs from its plain version ({label})")
        n_checks += 1
        n_elems += want.numel()

    for fmt in sf.FORMATS.values():
        outs = (torch.float32, torch.uint8) + ((torch.float16,) if fmt.via_f16 else ())
        for label, x in sets.items():
            xd = x.to(dev)
            for o in outs:
                held(f"{fmt.name} cast, {label}, {o}", sf.cast(xd, fmt, o),
                     sf.cast_reference(x, fmt, o))
            y = x[: x.numel() // 16 * 16].view(2, 8, -1, 1)
            yd = y.to(dev)
            for blabel, b in biases.items():
                for relu in (False, True):
                    for o in outs[:1] + outs[2:]:
                        held(f"{fmt.name} epilogue, {label}, {blabel}, relu {relu}, {o}",
                             sf.conv_epilogue(yd, b.to(dev), fmt, relu, out=o),
                             sf.conv_epilogue_reference(y, b, fmt, relu, out=o))
    log(f"  every format and mode against the plain version on the CPU: {n_checks} checks, "
        f"{n_elems} elements, bit for bit")

    # the direct cast on every float32 bit pattern, in every format, against
    # the plain version on the card: the codes and the carrier's values
    t1, n_nhwc = time.perf_counter(), 0
    for fmt in sf.FORMATS.values():
        for start in range(0, 1 << 32, CAST_CHUNK):
            x = torch.arange(start, start + CAST_CHUNK, dtype=torch.int64, device=dev).to(
                torch.int32).view(torch.float32)
            codes = sf.encode(x, fmt)
            for o, want in ((torch.uint8, codes.to(torch.uint8)),
                            (fmt.carrier, sf._to(sf.decode(codes, fmt), fmt.carrier))):
                got = sf.cast(x, fmt, o)
                if not sf.same_bits(got, want):
                    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[want.element_size()]
                    bad = torch.nonzero(got.view(ints) != want.view(ints)).reshape(-1)[:8]
                    log(f"  {fmt.name} cast into {o}: float32 patterns "
                        f"{[hex(int(v) & 0xFFFFFFFF) for v in x.view(torch.int32)[bad]]}: kernel "
                        f"{got.view(ints)[bad].tolist()}, plain {want.view(ints)[bad].tolist()}")
                    raise AssertionError(f"the {fmt.name} cast differs from its plain version")
            if start in NHWC_CHUNKS:  # the same patterns as an NHWC input (the FCN's layout)
                xn = x[: CAST_CHUNK // 48 * 48].view(1, 16, -1, 3).permute(0, 3, 1, 2)
                cn = sf.encode(xn, fmt)
                for o, want in ((torch.uint8, cn.to(torch.uint8)),
                                (fmt.carrier, sf._to(sf.decode(cn, fmt), fmt.carrier))):
                    assert sf.same_bits(sf.cast(xn, fmt, o), want.contiguous()), (
                        f"the {fmt.name} cast of an NHWC input into {o} differs from its plain "
                        "version")
                n_nhwc += xn.numel()
            del x, codes
    out["cast_patterns"] = 1 << 32
    log(f"  the direct cast on every float32 bit pattern (2^32, chunks of {CAST_CHUNK}) in the 9 "
        f"formats, into the codes and the carrier, and {len(NHWC_CHUNKS)} chunks a format as NHWC "
        f"inputs ({n_nhwc} casts, the tiled transpose): bit for bit the plain version on the card "
        f"({time.perf_counter() - t1:.1f} s)")

    # the main path's shapes: the asset in float8_e4m3fn at 64 frames
    model, dcfg = asset_fcn(ASSET, "float8_e4m3fn", dev)
    fmt = model.fmt
    p, v = (torch.from_numpy(a).to(dev) for a in scans)
    raw_inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: raw_inputs.append((m, a[0])))
             for m in model.modules() if isinstance(m, fcn._Layer)]
    with torch.inference_mode():
        images = range_view_project_batch(p, spec, v)
    x, layers = small_float_layers(model, images)
    for h in hooks:
        h.remove()
    with torch.inference_mode():
        assert sf.same_bits(sf.cast(x, fmt, out=model.act_dtype),
                            sf.cast_reference(x, fmt, out=model.act_dtype)), (
            "the input cast differs from its plain version")
        for m in model.modules():
            if isinstance(m, fcn._Layer):
                k = m.kernel.detach()
                assert sf.same_bits(sf.cast(k, fmt, out=model.act_dtype),
                                    sf.cast_reference(k, fmt, out=model.act_dtype)), (
                    "a kernel's cast differs from its plain version")
        elems = 0
        for i, (y, b, relu) in enumerate(layers):
            got = sf.conv_epilogue(y, b, fmt, relu, out=model.act_dtype)
            want = sf.conv_epilogue_reference(y, b, fmt, relu, out=model.act_dtype)
            assert sf.same_bits(got, want), f"the epilogue of layer {i} differs from plain"
            elems += y.numel()
    log(f"  at the main path's shapes ({fmt.name}, {BATCH} x 32 x 1801): the input cast "
        f"{tuple(x.shape)}, the 8 kernels' casts and the 8 epilogues ({elems} elements) bit for "
        f"bit the plain version on the card")
    out["epilogue_elements"] = elems

    # float32 against float16 convolutions on the same layer inputs
    diff16 = diff_fmt = total = 0
    per_layer = []
    with torch.inference_mode():
        for (m, xin), (_, b, relu) in zip(raw_inputs, layers):
            y32 = m.raw(xin.float())
            y16 = m.raw(xin.half())
            d = int((y16.view(torch.int16) != y32.half().view(torch.int16)).sum())
            e32 = sf.conv_epilogue(y32, b, fmt, relu, out=torch.float32)
            e16 = sf.conv_epilogue(y16, b, fmt, relu, out=torch.float32)
            df = int((e16.view(torch.int32) != e32.view(torch.int32)).sum())
            diff16, diff_fmt, total = diff16 + d, diff_fmt + df, total + y32.numel()
            per_layer.append(d)
    out.update(conv16_raw_differ=diff16, conv16_fmt_differ=diff_fmt, conv_outputs=total)
    log(f"  float16 convolutions (float32 accumulation) against float32's rounded to "
        f"float16, the same inputs: {diff16} of {total} raw outputs differ (by layer "
        f"{per_layer}); after the epilogue {diff_fmt} differ; SMALL_FLOAT_CONV is "
        f"{fcn.SMALL_FLOAT_CONV}")

    # the asset's FCN in every format against the f8 golden
    g8 = load_npz(GOLDEN_F8)
    with torch.inference_mode():
        gimages = range_view_project_batch(
            torch.from_numpy(gm["multi_points"][:F8_FRAMES]).to(dev), spec,
            torch.from_numpy(gm["multi_valid"][:F8_FRAMES]).to(dev))
    for name, f in sf.FORMATS.items():
        m, _ = asset_fcn(ASSET, name, dev)
        with torch.inference_mode():
            y = m(gimages)
            feats = m.features(gimages)
            codes = feats.view(torch.uint8) if feats.element_size() == 1 else sf.cast(
                feats, f, out=torch.uint8)
        same, dp, nan_ok = small_float_readings(
            *small_float_sample(codes.cpu().numpy(), y.cpu().numpy()),
            g8[f"{name}_features"], g8[f"{name}_prob"])
        log(f"  {name} FCN vs JAX's ({F8_FRAMES} golden frames, every 17th pixel): feature "
            f"codes equal {same:.4%} (at least {F8_FEATURES_SAME:.0%}), largest probability "
            f"difference {dp:.3e}, NaN probabilities where JAX's: {nan_ok}, features "
            f"{feats.dtype}")
        out[f"{name}_features_same"], out[f"{name}_prob_diff"] = same, dp
        if same < 1.0:
            got_c = small_float_sample(codes.cpu().numpy(), y.cpu().numpy())[0]
            want_c = g8[f"{name}_features"]
            pairs, counts = np.unique(np.stack([want_c[got_c != want_c],
                                                got_c[got_c != want_c]], 1), axis=0,
                                      return_counts=True)
            top = np.argsort(-counts)[:4]
            log(f"    the differing codes, JAX's -> the card's: " + ", ".join(
                f"{pairs[i][0]:#04x} -> {pairs[i][1]:#04x} x{counts[i]}" for i in top))
        assert same >= F8_FEATURES_SAME and nan_ok, f"the {name} FCN differs from JAX's"

    # the main path in float8_e4m3fn, and the golden's steps
    driven = dict.fromkeys(KERNELS, 0)
    step = make_e2e_step(model, spec, dcfg, head="direct", device=dev)
    f32, _ = asset_fcn(ASSET, "float32", dev)
    (poses, found), _ = drive(f"make_e2e_step with the asset's FCN in {fmt.name}, "
                              f"{BATCH} x {N_POINTS}", lambda: step(p, v), driven,
                              expect=DIRECT + SMALL_FLOAT)
    found32 = make_e2e_step(f32, spec, dcfg, head="direct", device=dev)(p, v)[1]
    assert bool(torch.isfinite(poses).all()) and found.shape == (BATCH,)
    agree = float((found == found32).float().mean())
    log(f"  found {int(found.sum())}/{BATCH} ({fmt.name}) vs {int(found32.sum())}/{BATCH} "
        f"(float32), the same frame by frame on {agree:.1%}")
    assert found.float().mean() >= 0.9, f"the {fmt.name} step misses"
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.serve.pipeline import LidarPipeline

    pipe = LidarPipeline(cfg=DEFAULT.replace(model=model.cfg, decode=dcfg), model=model,
                         max_points=N_POINTS, device=dev)
    frames = [scans[0][i][scans[1][i]] for i in range(REQUESTS)]
    answers, _ = drive(f"LidarPipeline in {fmt.name}, {REQUESTS} requests",
                       lambda: [pipe.predict_position(f) for f in frames], driven,
                       expect=DIRECT + SMALL_FLOAT)
    req = np.stack([a[0] for a in answers])
    req_found = np.array([a[1] for a in answers])
    assert np.array_equal(req_found, found[:REQUESTS].cpu().numpy())
    req_diff = float(wrapped_pose_diff(req, poses[:REQUESTS].cpu().numpy())[req_found].max())
    log(f"  LidarPipeline ({fmt.name}, {REQUESTS} requests) against the step's lanes: found "
        f"equal, largest pose difference {req_diff:.3e}")
    assert req_diff < POSE_TOL, "the server's answers differ from the step's"
    for name in F8_E2E_FORMATS:
        m, _ = asset_fcn(ASSET, name, dev)
        gstep = make_e2e_step(m, spec, dcfg, max_obstacles=F8_E2E_K, head="direct", device=dev)
        (gp, gf), _ = drive(f"make_e2e_step in {name}, the golden's frames, k {F8_E2E_K}",
                            lambda: gstep(gm["multi_points"], gm["multi_valid"]), driven,
                            expect=DIRECT + SMALL_FLOAT)
        want_found = g8[f"e2e_{name}_found"]
        diff = float(wrapped_pose_diff(gp.cpu().numpy(), g8[f"e2e_{name}_poses"])[
            want_found].max())
        log(f"  {name} step vs JAX's: found {gf.cpu().numpy().astype(int).tolist()} vs "
            f"{want_found.astype(int).tolist()}, largest pose difference {diff:.3e} "
            f"(tolerance {POSE_TOL})")
        assert np.array_equal(gf.cpu().numpy(), want_found), f"{name}: found differs from JAX"
        assert diff < POSE_TOL, f"{name}: poses differ from JAX's"
        out["pose_diff"] = max(out.get("pose_diff", 0.0), diff)

    row = small_float_rows(4, BATCH)[0]
    out["row"] = row
    log(f"  the epilogue at {row['shape']} ({row['elements']} elements a forward): kernel "
        f"{row['new_device_ms']:.4f} ({row['new_call_ms']:.4f}) ms, plain "
        f"{row['plain_device_ms']:.4f} ({row['plain_call_ms']:.4f}) ms, torch's cast chain "
        f"{row.get('yardstick_device_ms', float('nan')):.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"by bytes; kernel at {row['bound_ms'] / row['new_device_ms']:.1%} of it; the input "
        f"cast {row['input_cast_shape']} {row['cast_device_ms']:.4f} ms (plain "
        f"{row['cast_plain_device_ms']:.4f}), bound {row['input_cast_bound_ms']:.4f} ms; the "
        f"wrapper's host time {row['wrapper_host_us']:.1f} us a call")
    log(f"  phase 1g took {time.perf_counter() - t0:.1f} s")
    return out, driven


def _grad_readings(grads: dict, golden: dict, name: str, fmt) -> dict:
    """A step's gradients against the f8 gradient golden's `name` part:
    each convolution's share of values equal to JAX's and its largest
    distance in steps of the format; the input norm's largest difference
    relative to its largest entry."""
    from tpufusion_torch._golden import format_steps

    out = {}
    for k, got in grads.items():
        want = golden[f"{name}/{k.replace('.', '/')}"]
        if k.startswith("norm."):
            out[k] = ("rel", float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))
        else:
            steps = format_steps(got, want, fmt)
            out[k] = ("steps", float((steps == 0).mean()), int(steps.max()))
    return out


def phase_small_float_backward(dev, spec) -> tuple[dict, dict]:
    """Phase 1h: the small-float backward (`csrc/small_float.cu`,
    `tf_small_float_backward`: the epilogue's gradient with its bias
    gradient's reduce, and the no-bias rounding of a dgrad or wgrad) bit
    for bit its plain version (`ops/small_float.py`, run on the CPU) in
    every format (into its carrier, and float32 in float8_e4m3fn; the
    cuda tests take every output): `parity_inputs.small_float_backward_cases`
    (one to three cotangents, float16 and float32, a strided view, with
    and without relu; every float16 pattern, the formats' edges, +-0 and
    NaNs of both signs; windows with padding, over the batch, a second
    level) and the no-bias mode on every float16 pattern and the float32
    edges; then `Trainer.fit` with the shipped asset in float8_e4m3fn at
    32 x 1801: its first step on the f8 gradient golden's two beam scans
    (`tests/data/torch_port_golden_f8_grad.npz`) held to JAX's gradients
    (F8_GRAD_SAME of each convolution's values equal, none more than
    F8_GRAD_STEPS steps of the format off, the input norm's within
    F8_GRAD_NORM_RTOL x 100), the backward's calls of that step and of a
    step at TRAIN_BATCH frames bit for bit their plain version, then an
    epoch on phase 16's scene batches (TRAIN_SCENE_BATCHES steps of
    TRAIN_BATCH) through `drive`, its checkpoint resumed; one
    float8_e8m0fnu step (its loss a NaN): the trainer aborts
    with no checkpoint and restores one it has; the asset's step in
    float16 and float8_e4m3fn and its split (`step_times`); the backward's
    device time at a train step's calls and at its largest beside its
    plain version and its bound (`kernel_bench.small_float_backward_rows`).
    Returns (its readings, the driven launches)."""
    import tempfile

    from tpufusion_torch._golden import (
        F8_GRAD_FRAMES,
        F8_GRAD_LOSS,
        F8_GRAD_NORM_RTOL,
        F8_GRAD_SAME,
        F8_GRAD_STEPS,
        load_npz,
    )
    from tpufusion_torch.config import DEFAULT, LossConfig, TrainConfig
    from tpufusion_torch.data.pipeline import BatchPipeline
    from tpufusion_torch.kernel_bench import (
        recorded_backwards,
        reduce_distinct_codes,
        small_float_backward_rows,
        small_float_reduce_rows,
    )
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import asset_configs, load_state_npz
    from tpufusion_torch.ops import parity_inputs
    from tpufusion_torch.ops import small_float as sf
    from tpufusion_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    log("phase 1h small-float backward (tf_small_float_backward) against its plain version; "
        "Trainer.fit in float8_e4m3fn against the JAX golden")
    out: dict = {"err": 0.0}
    n_checks = 0
    for fmt in sf.FORMATS.values():  # the carrier, float32 too in the main path's format
        outs = (fmt.carrier,) + ((torch.float32,) if fmt.name == "float8_e4m3fn" else ())
        for shape in parity_inputs.SMALL_FLOAT_BACKWARD_SHAPES:
            for label, grads, saved, relu in parity_inputs.small_float_backward_cases(shape, dev):
                for o in outs:
                    got, want, same = sf.backward_against_plain(grads, saved, fmt, relu, o)
                    out["err"] = max(out["err"], _abs_err(got, want))
                    if not same:
                        log(f"  {fmt.name} {shape} {label} {o}: bias kernel {got[1].tolist()}, "
                            f"plain {want[1].tolist()}")
                        raise AssertionError(f"small_float backward differs from its plain "
                                             f"version ({fmt.name}, {shape}, {label}, {o})")
                    n_checks += 1
        patterns, values = parity_inputs.small_float_inputs(seed=31)
        for a in (patterns.view(np.float16), values):
            x = torch.from_numpy(a).view(1, 1, 1, -1)
            for o in (torch.float32,) + ((torch.float16,) if fmt.via_f16 else ()):
                got, want = sf.round_grad(x.to(dev), fmt, o).cpu(), sf.round_grad(x, fmt, o)
                out["err"] = max(out["err"], _abs_err(got, want))
                assert sf.same_bits(got, want), (
                    f"the no-bias rounding differs from its plain version ({fmt.name})")
                n_checks += 1
    log(f"  every format, case and output against the plain version on the CPU: {n_checks} "
        f"checks, bit for bit ({time.perf_counter() - t0:.1f} s)")
    # the reduce alone on adversarial windows: NaN, +-inf, overflowing sums,
    # subnormals, the zeros it skips, every code; odd window lengths with
    # padding, windows over the batch, a second level, one column
    n_reduce = 0
    for fmt in sf.FORMATS.values():
        for shape in parity_inputs.SMALL_FLOAT_REDUCE_SHAPES:
            x = torch.from_numpy(parity_inputs.small_float_reduce_inputs(fmt, shape))
            wide = torch.zeros(*shape[:3], 2 * shape[3])
            wide[..., ::2] = x
            for dtype in (torch.float32, fmt.carrier):
                for t in (x.to(dtype), wide.to(dtype)[..., ::2]):
                    got = sf.bias_grad(t.to(dev), fmt).cpu()
                    want = sf.bias_grad_reference(t, fmt)
                    out["err"] = max(out["err"], _abs_err((got,), (want,)))
                    if not sf.same_bits(got, want):
                        log(f"  {fmt.name} {shape} {dtype}: reduce {got.tolist()}, plain "
                            f"{want.tolist()}")
                        raise AssertionError(f"the reduce differs from its plain version "
                                             f"({fmt.name}, {shape})")
                    n_reduce += 1
    out["reduce_checks"] = n_reduce
    log(f"  the reduce alone (tf_small_float_bias_grad) on adversarial windows: {n_reduce} "
        f"checks in the 9 formats, bit for bit the plain version on the CPU")

    g8 = load_npz(GOLDEN_F8_GRAD)
    amcfg, adcfg = asset_configs(ASSET)
    driven = dict.fromkeys(KERNELS, 0)
    expect = RANGE_VIEW + ("encode_direct_label",) + SMALL_FLOAT + SMALL_FLOAT_TRAIN

    def trainer_for(name, outdir, batch_size):
        cfg = DEFAULT.replace(
            model=dataclasses.replace(amcfg, dtype=name), decode=adcfg,
            loss=LossConfig(**F8_GRAD_LOSS),
            train=TrainConfig(batch_size=batch_size, epochs=1, learning_rate=3e-3,
                              augment=False, seed=0, divergence_check_every=1))
        model = FCN(cfg.model)
        load_state_npz(ASSET, model)
        return Trainer(cfg, model=model, outdir=outdir, device=dev)

    def recording(trainer, into: dict):
        """The trainer's first step records its gradients and the
        backward's calls into `into`."""
        real = trainer.train_step

        def step(model, opt, batch, gen=None):
            if into:
                return real(model, opt, batch, gen)
            calls: list = []
            with recorded_backwards(calls):
                res = real(model, opt, batch, gen)
            into["calls"] = calls
            into["grads"] = {k: p.grad.detach().cpu().numpy()
                             for k, p in model.named_parameters()}
            into["loss"] = float(res[0])
            return res

        trainer.train_step = step

    name = "float8_e4m3fn"
    fmt = sf.FORMATS[name]
    golden_data = {k: g8[k] for k in ("points", "valid", "center", "size", "yaw")}

    def held(tag, rec):
        readings = _grad_readings(rec["grads"], g8, name, fmt)
        want_loss = float(g8[f"{name}/loss"])
        dl = abs(rec["loss"] - want_loss) / abs(want_loss)
        worst = min(r[1] for r in readings.values() if r[0] == "steps")
        steps = max(r[2] for r in readings.values() if r[0] == "steps")
        norm = max(r[1] for r in readings.values() if r[0] == "rel")
        log(f"  {tag}: loss {rec['loss']:.7g} vs JAX's {want_loss:.7g} (relative "
            f"{dl:.2e}); convolutions' gradients equal JAX's: least share {worst:.4%}, "
            f"largest distance {steps} steps; the norm's within {norm:.2e} of its largest")
        log("    " + ", ".join(f"{k} {r[1]:.4f}/{r[2]}" if r[0] == "steps" else
                               f"{k} {r[1]:.1e}" for k, r in readings.items()))
        return dl, worst, steps, norm

    with tempfile.TemporaryDirectory() as outdir:
        trainer = trainer_for(name, outdir, F8_GRAD_FRAMES)
        first: dict = {}
        recording(trainer, first)
        pipe = BatchPipeline(golden_data, F8_GRAD_FRAMES, shuffle=False, seed=0, device=dev)
        drive(f"Trainer.fit in {name}, the golden's {F8_GRAD_FRAMES} frames at 32 x 1801",
              lambda: trainer.fit(pipe), driven, expect=expect)
        dl, worst, steps, norm = held("the first step vs the f8 gradient golden", first)
        out.update(golden_loss_rel=dl, golden_grad_same=worst, golden_grad_steps=steps,
                   golden_norm_rel=norm)
        assert dl < 1e-3 and worst >= F8_GRAD_SAME and steps <= F8_GRAD_STEPS, (
            "the card's first step is off JAX's gradients")
        assert norm <= 100 * F8_GRAD_NORM_RTOL, "the norm's gradients are off JAX's"
        elems = 0
        for grads, saved, f, relu, o, bias in first["calls"]:
            got, want, same = sf.backward_against_plain(grads, saved, f, relu, o, bias)
            out["err"] = max(out["err"], _abs_err(got, want))
            assert same, "the backward differs from its plain version on the step's cotangents"
            elems += grads[0].numel()
        log(f"  the step's {len(first['calls'])} backward calls ({elems} elements) bit for "
            f"bit their plain version")

        data = scene_batches()
        main: dict = {}
        recording(trainer, main)
        pipe16 = BatchPipeline(data, TRAIN_BATCH, seed=0, device=dev)
        hist, _ = drive(f"Trainer.fit in {name}, phase 16's {TRAIN_SCENE_BATCHES} scene batches "
                        f"of {TRAIN_BATCH}", lambda: trainer.fit(pipe16), driven, expect=expect)
        losses = hist.batch["loss"]
        log(f"    step losses {[round(x, 4) for x in losses]}; checkpoints "
            f"{trainer.ckpt.steps()}")
        assert len(losses) == 1 + TRAIN_SCENE_BATCHES and np.isfinite(losses).all()
        assert trainer.ckpt.latest_step() == 1 + TRAIN_SCENE_BATCHES
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
        t1 = time.perf_counter()
        elems = 0
        for grads, saved, f, relu, o, bias in main["calls"]:
            got, want, same = sf.backward_against_plain(grads, saved, f, relu, o, bias)
            out["err"] = max(out["err"], _abs_err(got, want))
            assert same, "the backward differs from its plain version at the train batch's shapes"
            elems += grads[0].numel()
        log(f"  a {TRAIN_BATCH}-frame step's {len(main['calls'])} backward calls ({elems} "
            f"elements) bit for bit their plain version ({time.perf_counter() - t1:.1f} s)")
        out["main_calls"], out["main_elements"] = len(main["calls"]), elems
        fresh = trainer_for(name, outdir, TRAIN_BATCH)
        assert fresh.resume() and fresh.step == trainer.step
        assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(),
                                                     trainer.model.parameters()))
        log(f"  resumed at step {fresh.step}: the parameters equal")
        batches = list(pipe16.epoch())
        for dtype in ("float16", name):
            with tempfile.TemporaryDirectory() as tdir:
                t = trainer_for(dtype, tdir, TRAIN_BATCH)
                row = step_times(t, batches, spec, t.cfg.loss, "direct",
                                 adcfg.direct_yaw_frame)
            out.setdefault("steps", {}).setdefault(dtype, []).append(row)
            log(f"    the asset's {dtype} step over {len(batches)} scene batches of "
                f"{TRAIN_BATCH}: {json.dumps(row)} [{card_line()}]")

    for with_ckpt in (False, True):
        with tempfile.TemporaryDirectory() as outdir:
            trainer = trainer_for("float8_e8m0fnu", outdir, F8_GRAD_FRAMES)
            if with_ckpt:
                trainer.ckpt.save(0, trainer.model, trainer.optimizer)
            before = [p.detach().clone() for p in trainer.model.parameters()]
            pipe = BatchPipeline(golden_data, F8_GRAD_FRAMES, shuffle=False, seed=0, device=dev)
            hist, _ = drive(f"Trainer.fit in float8_e8m0fnu, {'a' if with_ckpt else 'no'} "
                            "checkpoint", lambda: trainer.fit(pipe), driven, expect=expect)
            finite = trainer._params_finite()
            log(f"  float8_e8m0fnu ({'with' if with_ckpt else 'without'} a checkpoint): "
                f"recorded losses {hist.batch['loss']}, step {trainer.step}, checkpoints "
                f"{trainer.ckpt.steps()}, finite weights {finite}")
            assert hist.batch["loss"] == [] and finite == with_ckpt
            assert trainer.ckpt.steps() == ([0] if with_ckpt else [])
            if with_ckpt:
                assert all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(),
                                                             before))

    row = small_float_backward_rows(calls_sets=[main["calls"]])[0]
    out["row"] = row
    red = out["reduce_row"] = small_float_reduce_rows([main["calls"]])[0]
    log(f"  the reduce alone at a {TRAIN_BATCH}-frame step's {red['reduces']} bias gradients "
        f"({red['elements']} elements): {red['step_device_ms']:.4f} ms, bound "
        f"{red['step_bound_ms']:.4f} ms by bytes; its largest {red['shape']}: "
        f"{red['new_device_ms']:.4f} ms, plain {red['plain_call_ms']:.1f} ms (between events, "
        f"host-paced), bound {red['bound_ms']:.4f} ms")
    t1, sms = time.perf_counter(), torch.cuda.get_device_properties(dev).multi_processor_count
    codes = out["reduce_codes"] = [
        {"shape": tuple(c[0][0].shape), **reduce_distinct_codes(sf.conv_epilogue_backward(*c)[0],
                                                                c[2], sms)}
        for c in main["calls"] if c[5]]
    log(f"  what the reduce's segments carry on those cotangents, all "
        f"{sf._n_codes(main['calls'][0][2])} start codes through each run "
        f"(`reduce_distinct_codes`, {time.perf_counter() - t1:.1f} s): " + "; ".join(
            f"{r['shape']}: {r['chains']} chains x {r['segments']} runs of {r['steps']:.0f} "
            f"steps, {r['nonzero_steps']:.2%} nonzero, distinct codes "
            + ", ".join(f"{k}: {v['mean']:.1f} (least {v['min']})"
                        for k, v in r["distinct"].items()) for r in codes))
    log(f"  the backward at {row['shape']} ({row['calls']} calls, {row['elements']} "
        f"elements in its epilogues): kernel {row['step_device_ms']:.4f} ms, bound "
        f"{row['step_bound_ms']:.4f} ms by bytes; its largest call {row['call_shape']}: "
        f"kernel {row['new_device_ms']:.4f} ms ({row['new_call_ms']:.4f} a call), plain "
        f"{row['plain_call_ms']:.1f} ms (between events, host-paced), bound "
        f"{row['bound_ms']:.4f} ms; kernel at {row['bound_ms'] / row['new_device_ms']:.1%} of it")
    log("    by call (shape, cotangents: device ms): " + ", ".join(
        f"{shape}: {ms:.3f}" for shape, ms in zip(row["per_call_shapes"],
                                                  row["per_call_device_ms"])))
    log(f"  phase 1h took {time.perf_counter() - t0:.1f} s")
    return out, driven


def check_zbuffer(label: str, points, valid, spec) -> None:
    """Holds the z-buffer kernel against its plain version on a path's
    own (B, N) points: bit-identical, or the run fails."""
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys
    from tpufusion_torch.ops import projection

    with torch.inference_mode():
        args = _frame_pixels_keys(points, spec, valid)
        got = projection.nearest_wins_image(*args, spec)
        want = projection.nearest_wins_image_reference(*args, spec)
    same = torch.equal(got, want)
    log(f"  z-buffer kernel on {label} ({points.shape[0]} x {points.shape[1]} points): "
        f"bit-identical to plain = {same}")
    assert same, f"z-buffer kernel differs from its plain version ({label})"


def check_cc(label: str, mask) -> None:
    """Holds the CC kernel against the plain sweeps on a path's own
    (B, H, W) heat masks: equal labels and foreground extents."""
    from tpufusion_torch.ops import cc, components

    mask = mask.contiguous()
    with torch.inference_mode():
        got = cc.connected_components_with_bbox(mask)
        _, sweeps = components.propagate(components.init_state(mask), mask, SWEEP_CAP)
        want = components.connected_components_with_bbox(mask, SWEEP_CAP)
    same = torch.equal(got[0], want[0]) and all(
        torch.equal(g[mask], w[mask]) for g, w in zip(got[1:], want[1:]))
    log(f"  CC kernel on {label} ({mask.shape[0]} masks): equal to the plain sweeps = {same} "
        f"(sweeps {int(sweeps.max())})")
    assert int(sweeps.max()) < SWEEP_CAP and same, f"CC kernel differs from the plain sweeps ({label})"


def check_both(label: str, model, dcfg, points, valid, spec) -> None:
    """Both kernels against their plain versions on a path's points and on
    `model`'s heat masks of them."""
    from tpufusion_torch.decode.decode import heat_mask
    from tpufusion_torch.geometry.range_view import range_view_project_batch

    check_zbuffer(label, points, valid, spec)
    with torch.inference_mode():
        heat = heat_mask(model(range_view_project_batch(points, spec, valid))[..., 1], dcfg)
    check_cc(label, heat)


def check_poses(label: str, poses, found, want_poses, want_found) -> float:
    """Asserts `found` equals the golden's and the poses are within POSE_TOL
    (yaw as an angle); returns the largest difference."""
    from tpufusion_torch._golden import wrapped_pose_diff

    got_f = found.cpu().numpy()
    diff = float(wrapped_pose_diff(poses, want_poses).max())
    log(f"  {label}: found {got_f.astype(int).tolist()} (JAX "
        f"{want_found.astype(int).tolist()}), largest pose difference "
        f"{diff:.3e} (tolerance {POSE_TOL:.3e})")
    assert np.array_equal(got_f, want_found), f"{label}: found differs from JAX"
    assert diff < POSE_TOL, f"{label}: poses differ from JAX"
    return diff


def asset_fcn(path: str, dtype: str, dev):
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.models.io import asset_configs, load_state_npz

    mcfg, dcfg = asset_configs(path)
    model = FCN(dataclasses.replace(mcfg, dtype=dtype))
    load_state_npz(path, model)
    return model.to(dev).eval(), dcfg


def phase_bf16(dev, spec, g, gm):
    """Phase 6: the asset's FCN in bf16 against JAX's bf16 FCN (the
    golden's sample, on its three two-vehicle frames) and in float16
    against JAX's float16 FCN (the float16 golden's sample, the same
    frames), each against the float32 FCN on all five golden frames, its
    convolutions in its own dtype and `found` equal to float32's. Returns
    ({dtype: model}, the asset's DecodeConfig)."""
    from tpufusion_torch._golden import (
        BF16_PROB_ATOL,
        BF16_REG_ATOL,
        BF16_REG_DIFFER_SHARE,
        F16_PROB_ATOL,
        F16_REG_ATOL,
        F16_REG_DIFFER_SHARE,
        fcn_sample_readings,
        from_f16_bits,
        load_npz,
    )
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.predict import make_e2e_step

    gf16 = load_npz(GOLDEN_F16)
    samples = {  # JAX's sample of its FCN in the dtype and the limits
        "bfloat16": ("bf16", gm["bf16_fcn_prob"], gm["bf16_fcn_reg"], BF16_PROB_ATOL,
                     BF16_REG_ATOL, BF16_REG_DIFFER_SHARE),
        "float16": ("float16", gf16["fcn_prob"], from_f16_bits(gf16["fcn_reg_bits"]),
                    F16_PROB_ATOL, F16_REG_ATOL, F16_REG_DIFFER_SHARE)}
    models = {}
    for dt in ("float32", *samples):
        models[dt], dcfg = asset_fcn(ASSET, dt, dev)
    pts = np.concatenate([g["points"], gm["multi_points"]])
    valid = np.concatenate([g["valid"], gm["multi_valid"]])
    conv_dtypes = {dt: [] for dt in samples}
    hooks = [models[dt].conv1.register_forward_hook(
        lambda m, i, o, dt=dt: conv_dtypes[dt].append(o.dtype)) for dt in samples]
    with torch.inference_mode():
        images = range_view_project_batch(
            torch.from_numpy(pts).to(dev), spec, torch.from_numpy(valid).to(dev))
        outs = {dt: m(images) for dt, m in models.items()}
    for h in hooks:
        h.remove()
    found = {dt: make_e2e_step(m, spec, dcfg, head="direct", device=dev)(
                 pts, valid)[1].cpu().numpy()
             for dt, m in models.items()}
    out32 = outs["float32"]
    for dt, (tag, want_prob, want_reg, prob_atol, reg_atol, share) in samples.items():
        out = outs[dt]
        assert conv_dtypes[dt] == [getattr(torch, dt)], (
            f"the {tag} FCN's conv1 returned {conv_dtypes[dt]}")
        assert out.dtype == torch.float32 and out.shape == out32.shape
        dp = float((out[..., :2] - out32[..., :2]).abs().max())
        dr = float((out[..., 2:] - out32[..., 2:]).abs().max())
        log(f"phase 6 {tag} FCN ({len(pts)} golden frames): conv1 output dtype "
            f"{conv_dtypes[dt][0]}; {tag} vs float32 largest difference: probability "
            f"{dp:.4e}, regression {dr:.4e}; found float32 "
            f"{found['float32'].astype(int).tolist()}, {tag} {found[dt].astype(int).tolist()}")
        assert np.isfinite(out.cpu().numpy()).all()
        assert np.array_equal(found["float32"], found[dt]), f"{tag} flips found"
        jp, jr, n_diff, n = fcn_sample_readings(
            out[len(g["points"]):].cpu().numpy(), want_prob, want_reg)
        log(f"  {tag} FCN vs JAX's {tag} FCN (3 two-vehicle frames): probability "
            f"{jp:.4e} (tolerance {prob_atol:.4e}), sampled regression "
            f"{jr:.4e} (tolerance {reg_atol:.4e}), {n_diff} of {n} sampled "
            f"regression outputs differ (at most {share:.0%})")
        assert jp <= prob_atol and jr <= reg_atol, f"{tag} FCN differs from JAX's"
        assert n_diff <= share * n, f"{tag} FCN rounds unlike JAX's"
    return models, dcfg


def phase_config5(dev, spec, gm, models, dcfg, totals):
    """Phase 7: config 5 (bf16, top-4, 16 x 131,072 points at 64 beams,
    then the tracker on a 16-frame two-vehicle sequence). Returns the
    step and the sequence's (poses, found) on the host."""
    from tpufusion_torch.eval.scoring import score_multi_poses
    from tpufusion_torch.data.synthetic import (
        synthesize_beam_scan_batch,
        synthesize_beam_tracking_sequence,
    )
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.serve.tracker import PoseTracker, track_quality_metrics

    step = make_e2e_step(models["bfloat16"], spec, dcfg, max_obstacles=4, head="direct", device=dev)
    pts, gt, valid = synthesize_beam_scan_batch(
        np.random.default_rng(500), C5_BATCH, C5_POINTS, n_beams=C5_BEAMS)
    seq, sgt, svalid = synthesize_beam_tracking_sequence(
        np.random.default_rng(77), TRACK_FRAMES, N_POINTS, n_vehicles=2)

    def path():
        poses, found = step(pts, valid)
        sp, sf = step(seq, svalid)
        sp, sf = sp.cpu().numpy(), sf.cpu().numpy()
        return poses, found, sp, sf, PoseTracker(dt=0.1).run_multi(sp, sf)

    log(f"phase 7 config 5: bf16 FCN, top-4, {C5_BATCH} x {C5_POINTS} points "
        f"({C5_BEAMS} beams), then {TRACK_FRAMES} frames x {N_POINTS} points "
        "of two vehicles through PoseTracker.run_multi")
    (poses, found, sp, sf, trails), _ = drive("config 5", path, totals, expect=DIRECT)
    poses, found = poses.cpu().numpy(), found.cpu().numpy()
    assert poses.shape == (C5_BATCH, 4, 7) and found.shape == (C5_BATCH, 4)
    assert np.isfinite(poses).all() and np.isfinite(sp).all()
    xy = np.linalg.norm(poses[:, 0, :2] - gt["center"][:, :2], axis=1)[found[:, 0]]
    quality = track_quality_metrics(trails, sgt["center"])
    scores = score_multi_poses(sp, sf, sgt["center"], sgt["yaw"], sgt["size"],
                               pose_frame="orbit")
    log(f"  131,072-point batch: largest cluster found {int(found[:, 0].sum())}/"
        f"{C5_BATCH}, xy error median {np.median(xy):.3f} m; detections per "
        f"frame {found.sum(axis=1).tolist()}")
    log(f"  tracking: {len(trails)} confirmed tracks; track_quality_metrics {quality}")
    log(f"  score_multi_poses {scores}")
    assert found[:, 0].mean() >= 0.75 and np.median(xy) < 1.0, "config 5 misses"
    assert len(trails) >= 1, "no confirmed track"
    for tag, model in (("bf16", models["bfloat16"]), ("f32", models["float32"])):
        gp, gf = make_e2e_step(model, spec, dcfg, max_obstacles=4, head="direct", device=dev)(
            gm["multi_points"], gm["multi_valid"])
        check_poses(f"JAX golden, top-4 {tag} (3 two-vehicle frames)", gp, gf,
                    gm[f"direct_{tag}_poses"], gm[f"direct_{tag}_found"])
    return step, sp, sf


def phase_corner(dev, spec, gm, batches, totals):
    """Phase 8: the corner decode on the golden's label-encoded outputs,
    a corner head end to end, bench.py's corner row. Returns the corner
    row's step and its FCN."""
    from tpufusion_torch import DecodeConfig, ModelConfig
    from tpufusion_torch._golden import load_npz
    from tpufusion_torch.decode.decode import (
        corner_vote_reference,
        decode_batch,
        decode_batch_multi,
    )
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.io import asset_configs, fcn_from_arrays
    from tpufusion_torch.ops.corner_vote import corner_lanes
    from tpufusion_torch.predict import make_e2e_step

    with torch.inference_mode():
        images = range_view_project_batch(
            torch.from_numpy(gm["multi_points"][:2]).to(dev), spec,
            torch.from_numpy(gm["multi_valid"][:2]).to(dev))
        y = torch.from_numpy(gm["corner_ypred"]).to(dev)
        # the process's float32 matmuls in TF32: the decode pins full
        # float32 for its own and must not change them
        torch.set_float32_matmul_precision("high")
        log("phase 8 corner decode on label-encoded corner outputs "
            "(2 two-vehicle frames), float32 matmul precision 'high' (TF32)")
        for case, cfg in (("corner", DecodeConfig()),
                          ("corner_k64", DecodeConfig(max_candidates=64))):
            out = decode_batch(y, images, spec, cfg)
            check_poses(f"decode_batch, max_candidates {cfg.max_candidates}",
                        out["pose"], out["found"], gm[f"{case}_poses"],
                        gm[f"{case}_found"])
            over = out["vote_overflow"].cpu().numpy()
            log(f"    vote_overflow {over.tolist()} (JAX {gm[f'{case}_overflow'].tolist()})")
            assert np.array_equal(over, gm[f"{case}_overflow"]), "vote_overflow differs"
        out = decode_batch_multi(y, images, spec, DecodeConfig(), 4)
        check_poses("decode_batch_multi k=4", out["poses"], out["found"],
                    gm["corner_multi_poses"], gm["corner_multi_found"])
        over = out["vote_overflow"].cpu().numpy()
        assert np.array_equal(over, gm["corner_multi_overflow"]), "vote_overflow differs"
        # the plain version's Gram product, pinned to full float32 under TF32
        bbox, c3, stage2 = corner_lanes(y, images, spec, DecodeConfig(), 4)
        pose, _, ok, _ = corner_vote_reference(y, images, bbox, c3, spec, DecodeConfig())
        ok = ok & stage2
        check_poses("corner_vote_reference (the plain version) on decode_batch_multi's lanes",
                    torch.where(ok[..., None], pose, 0.0), ok, gm["corner_multi_poses"],
                    gm["corner_multi_found"])
        assert torch.get_float32_matmul_precision() == "high"
        torch.set_float32_matmul_precision("highest")

    mcfg, dcfg = asset_configs(ASSET)
    hcfg = dataclasses.replace(mcfg, head="corner")
    harrays = {k: v for k, v in load_npz(ASSET).items()
               if not k.startswith(("deconv5b/", "deconv6b/"))}
    for name in ("deconv5b", "deconv6b"):
        harrays[f"{name}/kernel"] = gm[f"hybrid/{name}/kernel"]
        harrays[f"{name}/bias"] = np.zeros(hcfg.num_corner_outputs, np.float32)
    for tag, dtype, k in (("k1", "float32", 1), ("k4", "float32", 4),
                          ("bf16_k4", "bfloat16", 4)):
        model = fcn_from_arrays(harrays, dataclasses.replace(hcfg, dtype=dtype), device=dev)
        hp, hf = make_e2e_step(model, spec, dcfg, max_obstacles=k, head="corner", device=dev)(
            gm["multi_points"], gm["multi_valid"])
        check_poses(f"corner head on the asset's trunk, e2e {tag}", hp, hf,
                    gm[f"hybrid_{tag}_poses"], gm[f"hybrid_{tag}_found"])

    barrays = {k.split("/", 1)[1]: v for k, v in gm.items() if k.startswith("bench_corner/")}
    cmodel = fcn_from_arrays(
        barrays, dataclasses.replace(ModelConfig(), dtype="bfloat16"), device=dev)
    cstep = make_e2e_step(cmodel, spec, DecodeConfig(), head="corner", device=dev)
    bp, bf = cstep(gm["multi_points"], gm["multi_valid"])
    check_poses("bench.py corner row FCN (bf16, seeded init), 3 golden frames",
                bp, bf, gm["bench_corner_poses"], gm["bench_corner_found"])
    (cp, cf), _ = drive(f"corner row, batch {len(batches[0][0])} x {N_POINTS}",
                        lambda: cstep(*batches[0]), totals, expect=CORNER)
    assert cp.shape == (len(batches[0][0]), 7) and torch.isfinite(cp).all()
    return cstep, cmodel


def phase_assets(dev, spec, gm):
    """Phase 9: the mixed-family asset (auto yaw and fit gates) and the
    wide-yaw asset, top-4, float32, on the golden's circle and ellipse
    frames."""
    from tpufusion_torch.predict import make_e2e_step

    pts = np.concatenate([gm["multi_points"], gm["ell_points"]])
    valid = np.concatenate([gm["multi_valid"], gm["ell_valid"]])
    log("phase 9 other assets, top-4, float32 (3 two-vehicle + 2 ellipse frames)")
    for tag, name in (("mixed", "synthetic_detector_mixed.npz"),
                      ("yaw", "synthetic_detector_yaw.npz")):
        model, dcfg = asset_fcn(os.path.join(ASSETS, name), "float32", dev)
        poses, found = make_e2e_step(model, spec, dcfg, max_obstacles=4, head="direct",
                                     device=dev)(pts, valid)
        check_poses(f"{name} (yaw {dcfg.direct_yaw_frame}, fit {dcfg.fit_boundary})",
                    poses, found, gm[f"{tag}_poses"], gm[f"{tag}_found"])


def kernel_turns(spec, zargs, masks, dcfg) -> dict:
    """Both kernels timed in turns with their plain versions (and the
    z-buffer with its library yardstick, `scatter_reduce_` "amin" into a
    filled grid) on distinct inputs, as device time (`queued_ms`: the
    calls queued behind a sleep, between CUDA events) and as time a call
    (`time_ms`, the host's launch work included), beside their bounds
    from the same inputs: {"z": {...}, "cc": {...}}, times in ms,
    "<fn>_call" for a call's. The plain CC reads a flag back after each
    sweep, so its calls cannot be queued: its "plain" is a call's time."""
    from tpufusion_torch.ops import cc, components, projection

    p = spec.height * spec.width
    yard = [scatter_amin_yardstick(*a[:3], p) for a in zargs]
    zfns = {
        "kernel": lambda i: projection.nearest_wins_image(*zargs[i], spec),
        "plain": lambda i: projection.nearest_wins_image_reference(*zargs[i], spec),
        "library": lambda i: yard[i](),
    }
    cfns = {
        "kernel": lambda m: cc.connected_components_with_bbox(m, dcfg.max_cc_iters),
        "plain": lambda m: components.connected_components_with_bbox(m, dcfg.max_cc_iters),
    }
    idx = list(range(len(zargs)))
    z = time_turns(zfns, idx, queued_ms)
    z.update({f"{k}_call": v for k, v in time_turns(zfns, idx).items()})
    calls = time_turns(cfns, masks)
    c = {"kernel": queued_ms(cfns["kernel"], masks), "kernel_call": calls["kernel"],
         "plain": calls["plain"]}
    z["bound"] = float(np.mean([zbuffer_bound_ms(*a[:3], p) for a in zargs]))
    c["bound"] = float(np.mean([cc_bound_ms(m) for m in masks]))
    assert all(v > 0 for t in (z, c) for v in t.values()), f"a time not measured: {z} {c}"
    return {"z": z, "cc": c}


def turns_line(t: dict) -> str:
    z, c = t["z"], t["cc"]
    return (f"device time (a call): z-buffer kernel {z['kernel']:.4f} ({z['kernel_call']:.4f}) "
            f"ms, plain {z['plain']:.4f} ({z['plain_call']:.4f}) ms, library scatter_reduce_ "
            f"{z['library']:.4f} ({z['library_call']:.4f}) ms, bound {z['bound']:.4f} ms, "
            f"kernel at {z['bound'] / z['kernel']:.1%} of it; CC kernel {c['kernel']:.4f} "
            f"({c['kernel_call']:.4f}) ms, plain ({c['plain']:.4f}: a call, a readback a sweep) "
            f"ms, bound {c['bound']:.4f} ms, kernel at {c['bound'] / c['kernel']:.1%} of it")


def phase_times(dev, spec, models, dcfg, c5_step, cstep, cmodel, seq, batches,
                images64, card):
    """Phase 10: times on the card, CUDA events over distinct inputs."""
    from tpufusion_torch import DecodeConfig
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import (
        decode_batch_direct,
        decode_batch_multi,
        heat_mask,
    )
    from tpufusion_torch.geometry.range_view import (
        _frame_pixels_keys,
        range_view_project_batch,
    )
    from tpufusion_torch.ops import cc, components, projection
    from tpufusion_torch.serve.tracker import PoseTracker

    where = f"[{card}]"
    sets = []
    for i in range(C5_TIMED):
        p, _, v = synthesize_beam_scan_batch(
            np.random.default_rng(600 + i), C5_BATCH, C5_POINTS, n_beams=C5_BEAMS)
        sets.append((torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c5_ms = time_ms(lambda pv: c5_step(*pv), sets)
    c5_peak = torch.cuda.max_memory_allocated() / 2**20
    with torch.inference_mode():
        c5_images = [range_view_project_batch(p, spec, v) for p, v in sets]
        c5_preds = [models["bfloat16"](im) for im in c5_images]
        masks = [heat_mask(pr[..., 1], dcfg) for pr in c5_preds]
        zargs = [_frame_pixels_keys(p, spec, v) for p, v in sets]
        proj_ms = time_ms(lambda pv: range_view_project_batch(pv[0], spec, pv[1]), sets)
        dec_ms = time_ms(lambda ip: decode_batch_direct(ip[1], ip[0], spec, dcfg, 4),
                         list(zip(c5_images, c5_preds)))
        fcn = {}
        for label, imgs in (("c5", c5_images), ("64", images64)):
            for dt in ("float32", "bfloat16", "float16", "float16", "bfloat16",
                       "float32"):  # in turns
                fcn.setdefault((label, dt), []).append(time_ms(models[dt], imgs))
        fcn = {k: sum(v) / len(v) for k, v in fcn.items()}
        # both kernels against their plain versions at config 5's shapes
        z_same = torch.equal(projection.nearest_wins_image(*zargs[0], spec),
                             projection.nearest_wins_image_reference(*zargs[0], spec))
        got = cc.connected_components_with_bbox(masks[0], dcfg.max_cc_iters)
        want = components.connected_components_with_bbox(masks[0], 4096)
        fg = masks[0]
        cc_same = torch.equal(got[0], want[0]) and all(
            torch.equal(a[fg], b[fg]) for a, b in zip(got[1:], want[1:]))
        log(f"phase 10 parity at {C5_POINTS} points per frame: z-buffer "
            f"bit-identical {z_same}; CC labels + extents equal {cc_same}")
        assert z_same and cc_same, "a kernel differs from its plain version"
        zt = kernel_turns(spec, zargs, masks, dcfg)
        torch.cuda.reset_peak_memory_stats()
        corner_ms = time_ms(lambda pv: cstep(*pv), batches)
        corner_peak = torch.cuda.max_memory_allocated() / 2**20
        cpred = cmodel(images64[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**20
        decode_batch_multi(cpred, images64[0], spec, DecodeConfig(), 4)
        torch.cuda.synchronize()
        multi_peak = torch.cuda.max_memory_allocated() / 2**20 - base
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        PoseTracker(dt=0.1).run_multi(*seq)
    track_ms = (time.perf_counter() - t0) * 1e3 / (reps * len(seq[0]))

    b64 = len(batches[0][0])
    log(f"  times, CUDA events, mean over distinct batches after warm-up {where}")
    log(f"  config 5 (bf16, top-4, {C5_BATCH} x {C5_POINTS}, {C5_TIMED} batches): "
        f"{c5_ms:.3f} ms/batch = {C5_BATCH * 1e3 / c5_ms:.1f} frames/s; stages: "
        f"projection {proj_ms:.3f} ms, bf16 FCN {fcn[('c5', 'bfloat16')]:.3f} ms, "
        f"top-4 decode {dec_ms:.3f} ms; peak device memory {c5_peak:.0f} MiB {where}")
    log(f"  corner row (bf16 corner FCN + corner vote, {b64} x {N_POINTS}, "
        f"{len(batches)} batches): {corner_ms:.3f} ms/batch = "
        f"{b64 * 1e3 / corner_ms:.1f} frames/s; peak device memory "
        f"{corner_peak:.0f} MiB; decode_batch_multi k=4 at batch {b64} needs "
        f"{multi_peak:.0f} MiB above its inputs {where}")
    log(f"  FCN float32 vs bf16 vs float16: {b64} x 32 x 1801 {fcn[('64', 'float32')]:.3f} vs "
        f"{fcn[('64', 'bfloat16')]:.3f} vs {fcn[('64', 'float16')]:.3f} ms; {C5_BATCH} x 32 x "
        f"1801 (131,072-point frames) {fcn[('c5', 'float32')]:.3f} vs "
        f"{fcn[('c5', 'bfloat16')]:.3f} vs {fcn[('c5', 'float16')]:.3f} ms {where}")
    log(f"  at {C5_POINTS} points per frame ({C5_BATCH} frames): {turns_line(zt)} {where}")
    log(f"  tracker (host, PoseTracker.run_multi, {len(seq[0])} frames x top-4, "
        f"{reps} runs): {track_ms:.4f} ms/frame")


def bev_check(label: str, got, want) -> float:
    """Asserts two (B, nx, ny, C) rasters hold the same cells, with the
    max channels bit-identical and the density within 1e-4 (of 255);
    returns the density's largest difference."""
    same_cells = np.array_equal(got[..., 0] > 0, want[..., 0] > 0)
    same_max = np.array_equal(got[..., 1:], want[..., 1:])
    dd = float(np.abs(got[..., 0] - want[..., 0]).max())
    log(f"  {label}: occupied cells equal = {same_cells} ({int((want[..., 0] > 0).sum())}), "
        f"height + intensity bit-identical = {same_max}, density max |diff| = {dd:.3e} "
        "(tolerance 1e-4)")
    assert same_cells and same_max and dd <= 1e-4, f"BEV differs ({label})"
    return dd


def phase_bev(dev, gf, scan_pts, scan_valid):
    """Phase 11: bev_rasterize_batch on the card against the same function
    on the CPU and against the golden's JAX cells."""
    from tpufusion_torch._golden import dense_cells
    from tpufusion_torch.config import BevSpec
    from tpufusion_torch.geometry.bev import bev_rasterize_batch
    from tpufusion_torch.ops.parity_inputs import bev_edge_cloud

    spec = BevSpec()
    log(f"phase 11 BEV {spec.nx} x {spec.ny} x 3 (density, max height, max intensity)")
    with torch.inference_mode():
        for label, p, v in ((f"beam scans {len(scan_pts)}x{scan_pts.shape[1]}, card vs CPU",
                             scan_pts, scan_valid),
                            ("golden frames (2 stretched scans + edge-case cloud), card vs CPU",
                             gf["bev_points"], gf["bev_valid"])):
            pt, vt = torch.from_numpy(p), torch.from_numpy(v)
            got = bev_rasterize_batch(pt.to(dev), spec, vt.to(dev)).cpu().numpy()
            bev_check(label, got, bev_rasterize_batch(pt, spec, vt).numpy())
    want = dense_cells(gf["bev_index"], gf["bev_values"], got.shape)
    bev_check("golden frames, card vs JAX's cells", got, want)
    # why geometry/bev.py divides by a tensor: with a Python number as the
    # divisor torch multiplies by its reciprocal on the card
    edge, _ = bev_edge_cloud(spec, n=65536)
    moved = {}
    for axis, res in (("x", spec.res_x), ("y", spec.res_y)):
        v = torch.from_numpy(edge[:, "xy".index(axis)]).to(dev)
        d = v[torch.isfinite(v)] + spec.max_range
        by_tensor = torch.floor(d / torch.tensor(res, dtype=torch.float32, device=dev))
        moved[axis] = (int((torch.floor(d / res) != by_tensor).sum()), d.numel())
    log("  a Python-number divisor on this card would move "
        + ", ".join(f"{m} of {n} edge-cloud {a} values" for a, (m, n) in moved.items())
        + " into another bin (the tensor divisor: 0 against the CPU, above)")


def phase_config1(dev, gm, card, totals):
    """Phase 12: config 1, one frame a step through range view + BEV +
    the bf16 FCN of the reference benchmark (seeded init, deconv6a bias
    [2, -2]: the golden's bench_corner weights)."""
    from tpufusion_torch import ModelConfig, benchmarks
    from tpufusion_torch.geometry.bev import bev_rasterize_batch
    from tpufusion_torch.models.io import fcn_from_arrays

    arrays = {k.split("/", 1)[1]: v for k, v in gm.items() if k.startswith("bench_corner/")}
    model = fcn_from_arrays(arrays, ModelConfig(dtype="bfloat16"), device=dev)
    log(f"phase 12 config 1: 1 x {N_POINTS} points, range view + BEV + bf16 FCN")
    (p, v), = benchmarks.point_sets(1, 1, N_POINTS, dev)
    check_zbuffer("config 1's frame", p, v, benchmarks.SPEC)
    (preds, bev), counts = drive("one step", lambda: benchmarks.make_config1_step(model, dev)(p, v),
                                 totals, expect=RANGE_VIEW)
    assert counts == {"nearest_wins_image": 1, "connected_components_with_bbox": 0}
    assert preds.shape == (1, 32, 1801, 26) and bev.shape == (1, 1199, 180, 3)
    assert torch.isfinite(preds).all() and preds.dtype == torch.float32
    with torch.inference_mode():
        bev_check("the step's BEV, card vs CPU", bev.cpu().numpy(),
                  bev_rasterize_batch(p.cpu(), valid=v.cpu()).numpy())
    row, counts = drive("config1_single_frame (warm-up + 6 distinct frames x 3 timed, "
                        "then warm-up + 6 for the device time)",
                        lambda: benchmarks.config1_single_frame(dev, model), totals,
                        expect=RANGE_VIEW)
    assert counts["nearest_wins_image"] == MEASURE_CALLS, "config 1: one z-buffer launch a step"
    log(f"  {json.dumps(row)} [{card}]")
    return row


def phase_config3(dev, gf, card, totals):
    """Phase 13: config 3. The fusion net (float32, bf16) and the seg
    output against JAX on the golden's frames, then the full-width step,
    predict_fusion's CSV, and the times."""
    import csv
    import tempfile

    from tpufusion_torch import ModelConfig, _golden, benchmarks
    from tpufusion_torch.data.synthetic import build_fusion_dataset
    from tpufusion_torch.geometry.bev import bev_rasterize_batch
    from tpufusion_torch.geometry.camera import paint_bev, paint_table, synthetic_camera
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.io import fcn_from_arrays, fusion_from_asset
    from tpufusion_torch.serve.fusion import predict_fusion

    log(f"phase 13 config 3: camera 512 x 1368 painted onto the BEV + bf16 BEV FCN + "
        f"FusionNet ({os.path.relpath(FUSION_ASSET, HERE)})")
    data = _golden.fusion_golden_data(dev)
    same_cam = np.array_equal(data["cam_sha256"], gf["fusion_cam_sha256"])
    log(f"  golden frames: {len(data['cam'])} camera frames made again from seed "
        f"{_golden.FUSION_SEED}, digests equal the golden's = {same_cam}")
    assert same_cam, "the regenerated camera frames are not the golden's"
    pts = torch.from_numpy(gf["fusion_points"]).to(dev)
    valid = torch.from_numpy(gf["fusion_valid"]).to(dev)
    cam = torch.from_numpy(data["cam"]).to(dev)
    radar = torch.from_numpy(gf["fusion_radar"]).to(dev)
    nets = {}
    with torch.inference_mode():
        lidar = range_view_project_batch(pts, valid=valid)
        for tag, dtype, atol in (("f32", "float32", _golden.F32_FUSION_ATOL),
                                 ("bf16", "bfloat16", _golden.BF16_FUSION_ATOL)):
            nets[tag] = fusion_from_asset(FUSION_ASSET, dev, dtype)
            centroid, rz = nets[tag](cam, lidar, radar)
            dc = float(np.abs(centroid.cpu().numpy() - gf[f"fusion_{tag}_centroid"]).max())
            dr = float(np.abs(rz.cpu().numpy() - gf[f"fusion_{tag}_rz"]).max())
            log(f"  FusionNet {dtype} vs JAX's {dtype} on the golden frames: centroid "
                f"{dc:.4e} (tolerance {atol:.1e}), rz {dr:.4e} (tolerance "
                f"{_golden.FUSION_RZ_ATOL:.1e})")
            assert dc <= atol and dr <= _golden.FUSION_RZ_ATOL, (
                f"the {dtype} fusion net differs from JAX's")
    gap_c = float(np.abs(gf["fusion_f32_centroid"] - gf["fusion_bf16_centroid"]).max())
    gap_r = float(np.abs(gf["fusion_f32_rz"] - gf["fusion_bf16_rz"]).max())
    log(f"  (JAX's own float32 vs bf16 on these frames: centroid {gap_c:.4e}, rz {gap_r:.4e})")

    arrays = {k.split("/", 1)[1]: v for k, v in gf.items() if k.startswith("bev_fcn/")}
    bev_fcn = fcn_from_arrays(arrays, ModelConfig(dtype="bfloat16"), device=dev)
    step = benchmarks.make_config3_step(bev_fcn, nets["bf16"], dev)
    n = _golden.SEG_FRAMES
    seg, _, _ = step(pts[:n], valid[:n], cam[:n], radar[:n])
    worst, share = _golden.seg_readings(seg.cpu().numpy(), gf["seg_prob"])
    log(f"  seg vs JAX's on {n} golden frames (every {_golden.SEG_STRIDE}th pixel): largest "
        f"difference {worst:.4e} (tolerance {_golden.BF16_SEG_ATOL:.4e}), {share:.2%} differ "
        f"(at most {_golden.BF16_SEG_DIFFER_SHARE:.0%})")
    assert worst <= _golden.BF16_SEG_ATOL and share <= _golden.BF16_SEG_DIFFER_SHARE

    # full width: 8 x 32,768 points with rendered camera frames and radar
    full = build_fusion_dataset(C3_BATCH, 300, device=dev)
    args = [torch.from_numpy(full[k]).to(dev) for k in ("points", "valid", "cam", "radar")]
    check_zbuffer("config 3's camera-wedge scans", args[0], args[1], benchmarks.SPEC)
    (seg, centroid, rz), counts = drive(
        f"one step, batch {C3_BATCH} x {N_POINTS}", lambda: step(*args), totals,
        expect=RANGE_VIEW)
    assert counts == {"nearest_wins_image": 1, "connected_components_with_bbox": 0}
    assert seg.shape == (C3_BATCH, 180, 1197, 26) and centroid.shape == (C3_BATCH, 3)
    assert rz.shape == (C3_BATCH, 1)
    assert all(torch.isfinite(t).all() for t in (seg, centroid, rz))
    centroid, rz = centroid.cpu().numpy(), rz.cpu().numpy()
    xy = np.linalg.norm(centroid[:, :2] - full["centroid"][:, :2], axis=1)
    log(f"  trained fusion net on {C3_BATCH} generated scenes: xy error median "
        f"{np.median(xy):.3f} m, max {xy.max():.3f} m; rz error mean "
        f"{np.abs(rz - full['rz']).mean():.4f} rad")
    assert np.median(xy) < 2.0, "the fusion net misses the vehicles"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fusion_predictions.csv")
        n_rows = C3_BATCH - 3  # a padded last batch
        sub = {k: full[k][:n_rows] for k in ("cam", "lidar", "radar")}
        predict_fusion(nets["bf16"], sub, full["timestamps"][:n_rows].tolist(), path,
                       batch_size=C3_BATCH, device=dev)
        with open(path) as f:
            rows = list(csv.DictReader(f))
    assert [int(r["timestamp"]) for r in rows] == full["timestamps"][:n_rows].tolist()
    back = np.array([[float(r[k]) for k in ("tx", "ty", "tz", "rz")] for r in rows], np.float32)
    want = np.concatenate([centroid, rz], axis=1)[:n_rows]
    dcsv = float(np.abs(back - want).max())
    log(f"  predict_fusion: {len(rows)} rows (one batch of {C3_BATCH}, padded) read back; "
        f"largest difference from the step's (centroid, rz) {dcsv:.3e}")
    assert dcsv <= 1e-5 and all(float(r[k]) == 0.0 for r in rows for k in ("rx", "ry", "l", "w", "h"))

    row, counts = drive("config3_fused (warm-up + 6 distinct batches x 3 timed, then "
                        "warm-up + 6 for the device time)",
                        lambda: benchmarks.config3_fused(dev, bev_fcn, nets["bf16"]), totals,
                        expect=RANGE_VIEW)
    assert counts["nearest_wins_image"] == MEASURE_CALLS, "config 3: one z-buffer launch a step"
    log(f"  {json.dumps(row)} [{card}]")

    # stage times over the same kind of distinct inputs
    sets = benchmarks.config3_inputs(dev, C3_BATCH, N_POINTS, 6)
    fusion, spec = nets["bf16"], benchmarks.FUSED_BEV
    table = paint_table(synthetic_camera(1368, 512, 1400.0), spec, dev)
    with torch.inference_mode():
        fused = [benchmarks.fuse_bev(p, v, c, table, spec) for p, v, c, _ in sets]
        images = [range_view_project_batch(p, valid=v) for p, v, _, _ in sets]
        ms = {
            "BEV": time_ms(lambda a: bev_rasterize_batch(a[0], spec, a[1]), sets),
            "paint": time_ms(lambda a: paint_bev(a[2], table), sets),
            "BEV FCN": time_ms(bev_fcn, fused),
            "projection": time_ms(lambda a: range_view_project_batch(a[0], valid=a[1]), sets),
            "camera FCN features": time_ms(lambda a: fusion.camera_fcn.features(a[2]), sets),
            "lidar FCN features": time_ms(fusion.lidar_fcn.features, images),
            "fusion net (both FCNs, pools, dense layers, heads)": time_ms(
                lambda ai: fusion(ai[0][2], ai[1], ai[0][3]), list(zip(sets, images))),
        }
    log("  stages, ms a batch of 8: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" [{card}]")
    return row


def phase_replay(dev, card, totals):
    """Phase 14: the replay server on 270 stored frames (chunk 64, a
    pinned ring of 2) against make_e2e_step on the same frames, then the
    prediction CSV, the tracklet XML and the scoring."""
    import tempfile

    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.eval.scoring import score_poses
    from tpufusion_torch.eval.submission import generate_submission, write_predictions_csv
    from tpufusion_torch.eval.tracklet_xml import parse_tracklet_xml
    from tpufusion_torch.models.io import asset_configs
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.serve.replay import ReplayHarness

    mcfg, dcfg = asset_configs(ASSET)
    cfg = DEFAULT.replace(model=mcfg, decode=dcfg)
    model, _ = asset_fcn(ASSET, "float32", dev)
    frames, truths = [], []
    for i, lo in enumerate(range(0, REPLAY_FRAMES, REPLAY_CHUNK)):
        p, gt, _ = synthesize_beam_scan_batch(
            np.random.default_rng(900 + i), min(REPLAY_CHUNK, REPLAY_FRAMES - lo), N_POINTS)
        frames.append(p)
        truths.append(np.concatenate([gt["center"], gt["yaw"][:, None], gt["size"]], axis=1))
    points, truth = np.concatenate(frames), np.concatenate(truths)
    harness = ReplayHarness(cfg, model, chunk=REPLAY_CHUNK, host_ring=2, device=dev)
    log(f"phase 14 replay server: {REPLAY_FRAMES} stored frames x {N_POINTS} points, chunk "
        f"{REPLAY_CHUNK}, host_ring 2, head {mcfg.head!r}")
    (poses, founds, stats), counts = drive("ReplayHarness.run", lambda: harness.run(points), totals,
                                           expect=DIRECT)
    n_chunks = -(-REPLAY_FRAMES // REPLAY_CHUNK)
    assert counts["nearest_wins_image"] == n_chunks + 1, "one z-buffer launch a chunk + warm-up"
    assert all(host.is_pinned() for host, _, _ in harness._ring), "the ring is not pinned"
    assert poses.shape == (REPLAY_FRAMES, 7) and founds.shape == (REPLAY_FRAMES,)
    step = make_e2e_step(model, cfg.range_view, dcfg, head=mcfg.head, device=dev)
    want_p, want_f = [], []
    for lo in range(0, REPLAY_FRAMES, REPLAY_CHUNK):
        chunk = points[lo : lo + REPLAY_CHUNK]
        pad = REPLAY_CHUNK - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        p, f = step(chunk)
        want_p.append(p.cpu().numpy()[: REPLAY_CHUNK - pad])
        want_f.append(f.cpu().numpy()[: REPLAY_CHUNK - pad])
    want_p, want_f = np.concatenate(want_p), np.concatenate(want_f)
    dp = float(np.abs(poses - want_p).max())
    log(f"  against make_e2e_step on the same frames: found equal = "
        f"{np.array_equal(founds, want_f)} ({int(founds.sum())}/{REPLAY_FRAMES}), largest "
        f"pose difference {dp:.3e}")
    assert np.array_equal(founds, want_f) and dp <= 1e-5, "the replay server's poses differ"
    log(f"  LatencyStats.summary(): {json.dumps(stats.summary())} (host clock a chunk, "
        f"readback included) [{card}]")

    ts = (1_490_000_000_000 + np.arange(REPLAY_FRAMES) * 100_000).tolist()
    size = {"l": 4.2, "w": 1.6, "h": 1.5}
    with tempfile.TemporaryDirectory() as d:
        csv_path, xml_path = os.path.join(d, "pred.csv"), os.path.join(d, "sub.xml")
        write_predictions_csv(poses, ts, csv_path)
        generate_submission(csv_path, ts, size, xml_path)
        tracklets = parse_tracklet_xml(xml_path)
    assert len(tracklets) == 1 and len(tracklets[0].poses) == REPLAY_FRAMES
    assert (tracklets[0].l, tracklets[0].w, tracklets[0].h) == (4.2, 1.6, 1.5)
    back = np.array([[q[k] for k in ("tx", "ty", "tz", "rz")] for q in tracklets[0].poses])
    dx = float(np.abs(back - poses[:, :4]).max())
    scores = score_poses(poses, truth, pose_frame="orbit")
    log(f"  CSV -> tracklet XML -> parsed: {len(tracklets[0].poses)} poses, largest "
        f"difference from the served poses {dx:.2e} (the XML keeps 6 decimals)")
    log(f"  score_poses vs the generator's truth: {json.dumps(scores)}")
    assert dx <= 1e-5, "the submission does not carry the served poses"
    assert scores["detection_rate"] >= 0.9 and scores["mean_xy_err"] < 1.0, "the server misses"
    return stats.summary()


def phase_train_golden(dev, spec, gm, gt, totals):
    """Phase 15: one train step of each TRAIN_CASES entry on the train
    golden's frames against the reference's."""
    from tpufusion_torch import _golden

    batch = _golden.train_golden_inputs()
    same = str(batch["sha256"]) == str(gt["inputs_sha256"])
    log(f"phase 15 train step against the reference: {_golden.TRAIN_FRAMES} x "
        f"{_golden.TRAIN_POINTS} points from seed {_golden.TRAIN_SEED}, digest equals the "
        f"golden's = {same}")
    assert same, "the regenerated train frames are not the golden's"
    check_zbuffer("the train golden's frames", torch.from_numpy(batch["points"]).to(dev),
                  torch.from_numpy(batch["valid"]).to(dev), spec)
    readings = {}
    for case, what in _golden.TRAIN_CASES.items():
        shifts = gt.get(f"{case}/shifts")
        labels = _golden.port_case_labels(case, ASSET, gm, batch, dev, shifts)
        pixels_equal, label_abs = _golden.label_readings(labels, gt, case)
        got, counts = drive(
            f"train step {case} (head {what['head']}, {what['dtype']}"
            + (f", rolled by {shifts.tolist()}" if shifts is not None else "") + ")",
            lambda: _golden.port_train_case(case, ASSET, gm, batch, dev, shifts),
            totals, expect=RANGE_VIEW + (("encode_label",) if what["head"] == "corner"
                                         else ("encode_direct_label",)))
        assert counts == {"nearest_wins_image": 1, "connected_components_with_bbox": 0}, (
            "a train step launches the z-buffer once and never the CC")
        assert _launches()["encode_label"] == (what["head"] == "corner"), (
            "a corner head's step encodes its labels in one kernel launch")
        assert _launches()["encode_direct_label"] == (what["head"] == "direct"), (
            "a direct head's step encodes its labels in one kernel launch")
        r = _golden.train_case_readings(got, gt, case)
        lim = _golden.train_case_limits(case)
        readings[case] = r
        log(f"    foreground pixels equal = {pixels_equal}, label values {label_abs:.3e} "
            f"(limit {_golden.TRAIN_LABEL_ATOL:.0e}); loss {got['loss']:.6f} vs "
            f"{float(gt[case + '/loss']):.6f}: relative {r['loss_rel']:.3e} (limit "
            f"{lim['loss_rel']:.1e}); worst gradient tensor {r['worst_grad']} "
            f"{r['grad_rel']:.3e} of its largest entry (limit {lim['grad_rel']:.1e}), conv "
            f"biases {r['bias_grad_rel']:.3e} (limit {lim['bias_grad_rel']:.1e}); running "
            f"stats {r['stats_abs']:.3e} (limit {lim['stats_abs']:.0e}); metrics "
            f"{r['metrics_abs']:.3e}")
        assert pixels_equal and label_abs <= _golden.TRAIN_LABEL_ATOL, f"{case}: labels differ"
        for k, v in lim.items():
            assert r[k] <= v, f"{case}: {k} {r[k]:.3e} over {v:.3e}"
        assert r["metrics_abs"] <= 1e-3, f"{case}: metrics differ"
    return readings


def _sync_events(prof) -> dict[str, int]:
    """Calls that make the host wait for the card, counted in a profile.
    The profiler itself synchronizes the device once when it stops; that
    one call is left out."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "aten::item", "aten::_local_scalar_dense")
    counts = {e.key: e.count for e in prof.key_averages() if e.key in names}
    counts["cudaDeviceSynchronize"] = counts.get("cudaDeviceSynchronize", 0) - 1
    return {k: n for k, n in counts.items() if n > 0}


def scene_batches() -> dict:
    """Phase 16's dataset: TRAIN_SCENE_BATCHES x TRAIN_BATCH beam scans of
    N_POINTS with their boxes, as numpy."""
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch

    parts = [synthesize_beam_scan_batch(np.random.default_rng(1600 + i), TRAIN_BATCH, N_POINTS)
             for i in range(TRAIN_SCENE_BATCHES)]
    data = {"points": np.concatenate([p for p, _, _ in parts]),
            "valid": np.concatenate([v for _, _, v in parts])}
    for k in ("center", "size", "yaw"):
        data[k] = np.concatenate([gt[k] for _, gt, _ in parts])
    return data


def phase_trainer(dev, spec, card, totals):
    """Phase 16: Trainer.fit at full width, a checkpoint, resume, and the
    step's time and split."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tpufusion_torch.config import DEFAULT, LossConfig, ModelConfig, TrainConfig
    from tpufusion_torch.data.pipeline import BatchPipeline
    from tpufusion_torch.geometry.encoding import (
        encode_direct_label_reference,
        encode_label_reference,
    )
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.io import asset_configs
    from tpufusion_torch.train.stats import population_weights
    from tpufusion_torch.train.trainer import Trainer

    data = scene_batches()
    stats = population_weights(data["center"], data["size"], data["yaw"], spec, device=dev)
    loss_cfg = LossConfig(obj_to_bkg_ratio=stats["positive_to_negative_ratio"],
                          avg_obj_size=stats["average_area"])
    log(f"phase 16 Trainer.fit: {TRAIN_SCENE_BATCHES} scene batches of {TRAIN_BATCH} x "
        f"{N_POINTS} points ({len(data['points'])} frames), BatchPipeline batch {TRAIN_BATCH}, "
        f"2 epochs + a checkpoint + resume + 1 epoch; population_weights {stats}")
    amcfg, adcfg = asset_configs(ASSET)
    runs = (("default widths, corner head, bf16, roll augmentation",
             ModelConfig(dtype="bfloat16"), DEFAULT.decode, True),
            ("the asset's geometry (width 2, direct head), float32", amcfg, adcfg, False))
    rows = {}
    for tag, mcfg, dcfg, augment in runs:
        cfg = DEFAULT.replace(
            model=mcfg, decode=dcfg, loss=loss_cfg,
            train=TrainConfig(batch_size=TRAIN_BATCH, epochs=2, learning_rate=3e-3,
                              augment=augment, seed=0))
        with tempfile.TemporaryDirectory() as outdir:
            trainer = Trainer(cfg, outdir=outdir, device=dev)
            pipe = BatchPipeline(data, TRAIN_BATCH, seed=0, device=dev)
            assert pipe._dev is not None, "the dataset should be device-resident"
            expect = RANGE_VIEW + (("encode_label",) if mcfg.head == "corner"
                                   else ("encode_direct_label",))
            hist, counts = drive(f"fit, {tag}", lambda: trainer.fit(pipe), totals, expect=expect)
            steps = 2 * TRAIN_SCENE_BATCHES
            assert counts == {"nearest_wins_image": steps, "connected_components_with_bbox": 0}
            losses = hist.batch["loss"]
            first, last = hist.epoch["loss"]
            log(f"    step losses {[round(x, 3) for x in losses]}; epoch means {first:.4f} -> "
                f"{last:.4f}; checkpoints {trainer.ckpt.steps()}")
            assert len(losses) == steps and np.isfinite(losses).all(), "a loss is not finite"
            assert last < first, "the mean loss did not fall"
            assert trainer.ckpt.latest_step() == steps
            assert os.path.exists(os.path.join(outdir, "pr_curve.csv"))
            assert os.path.exists(os.path.join(outdir, "metrics.jsonl"))

            resumed = Trainer(cfg, outdir=outdir, device=dev)
            assert resumed.resume() and resumed.step == steps
            moments = all(
                torch.equal(trainer.optimizer.state[a][m], resumed.optimizer.state[b][m])
                for a, b in zip(trainer.model.parameters(), resumed.model.parameters())
                for m in ("mu", "nu"))
            same_rng = torch.equal(trainer.generator.get_state(), resumed.generator.get_state())
            probe = {k: torch.from_numpy(v[:TRAIN_BATCH]).to(dev) for k, v in data.items()}
            la, _ = trainer.train_step(trainer.model, trainer.optimizer, probe, trainer.generator)
            lb, _ = resumed.train_step(resumed.model, resumed.optimizer, probe, resumed.generator)
            log(f"    resume: step {resumed.step}, optimizer count {resumed.optimizer.count}, "
                f"moments equal = {moments}, generator state equal = {same_rng}; next step's "
                f"loss {float(la):.6f} (uninterrupted) vs {float(lb):.6f} (resumed)")
            assert moments and same_rng and float(la) == float(lb), "resume is not exact"
            hist2, _ = drive("one more epoch after resume",
                             lambda: resumed.fit(pipe, epochs=1), totals, expect=expect)
            assert np.isfinite(hist2.batch["loss"]).all() and resumed.step == steps + TRAIN_SCENE_BATCHES

            # no host sync in the step loop: 8 steps, the pipeline's gathers included
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    for b in pipe.epoch():
                        trainer.train_step(trainer.model, trainer.optimizer, b, trainer.generator)
            syncs = _sync_events(prof)
            torch.cuda.synchronize()
            log(f"    8 profiled steps (2 epochs of the pipeline): host-sync calls {syncs or 'none'} "
                "(stream / device / event synchronize, aten::item)")
            assert not syncs, "the step loop waits for the card"

            # times: the step and its parts over 8 distinct batches
            batches = [b for _ in range(2) for b in pipe.epoch()]
            head, yaw_frame = mcfg.head, dcfg.direct_yaw_frame
            rows[tag] = step_times(trainer, batches, spec, loss_cfg, head, yaw_frame)
            with torch.no_grad():
                with_images = [dict(b, images=range_view_project_batch(
                    b["points"], spec, b["valid"])) for b in batches]
                # the composition the fused kernel replaced
                plain = (encode_label_reference if head == "corner" else functools.partial(
                    encode_direct_label_reference, yaw_frame=yaw_frame))
                rows[tag]["label_encode_plain_ms"] = round(time_ms(
                    lambda b: plain(b["center"], b["size"], b["yaw"], b["images"], spec),
                    with_images), 3)
            log(f"    times over {len(batches)} distinct batches of {TRAIN_BATCH} x {N_POINTS}: "
                f"{json.dumps(rows[tag])} [{card}]")
    return rows


def step_times(trainer, batches, spec, loss_cfg, head: str, yaw_frame: str) -> dict:
    """A trainer's step over `batches` (CUDA events; device ms by
    `device_ms`) and its parts: the projection, the label encode, the
    forward with its loss, the backward, the optimizer; peak memory."""
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.losses import weighted_pose_loss
    from tpufusion_torch.train.train_step import encode_batch

    model, opt, gen = trainer.model, trainer.optimizer, trainer.generator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**20
    step_ms = time_ms(lambda b: trainer.train_step(model, opt, b, gen), batches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    busy_ms = device_ms(lambda b: trainer.train_step(model, opt, b, gen), batches)
    with torch.no_grad():
        images = [range_view_project_batch(b["points"], spec, b["valid"]) for b in batches]
        with_images = [dict(b, images=im) for b, im in zip(batches, images)]
        labels = [encode_batch(b, spec, head, yaw_frame)[1] for b in with_images]
        proj_ms = time_ms(
            lambda b: range_view_project_batch(b["points"], spec, b["valid"]), batches)
        enc_ms = time_ms(lambda b: encode_batch(b, spec, head, yaw_frame), with_images)
    pairs = list(zip(images, labels))

    def forward(il):
        return weighted_pose_loss(model(il[0], train=True), il[1], loss_cfg)

    def forward_backward(il):
        opt.zero_grad(set_to_none=True)
        forward(il).backward()

    fwd_ms = time_ms(forward, pairs)
    fb_ms = time_ms(forward_backward, pairs)
    opt_ms = time_ms(lambda _: opt.step(), batches)
    return {"ms_per_step": round(step_ms, 3),
            "frames_per_s": round(len(images[0]) * 1e3 / step_ms, 1),
            "device_ms_per_step": round(busy_ms, 3),
            "device_busy": round(busy_ms / step_ms, 3),
            "projection_ms": round(proj_ms, 3), "label_encode_ms": round(enc_ms, 3),
            "forward_ms": round(fwd_ms, 3), "backward_ms": round(fb_ms - fwd_ms, 3),
            "optimizer_ms": round(opt_ms, 3), "peak_device_mib": round(peak, 1),
            "resident_before_mib": round(resident, 1)}


def phase_fusion_train(dev, gf, gt, card, totals):
    """Phase 17: train_fusion at full width, unlocked and locked, and one
    fusion step against the reference's loss and gradients."""
    from tpufusion_torch import ModelConfig, _golden
    from tpufusion_torch.data.synthetic import build_fusion_dataset
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.fusion import FusionNet, init_fusion_
    from tpufusion_torch.train.fusion_trainer import train_fusion

    log(f"phase 17 fusion training: camera 512 x 1368 x 1, pools (2, 8) / (8, 8), bf16 FCNs, "
        f"{FUSION_TRAIN_FRAMES} frames x {N_POINTS} points, batch {C3_BATCH}")
    data, counts = drive(
        "build_fusion_dataset", lambda: build_fusion_dataset(FUSION_TRAIN_FRAMES, 700, device=dev),
        totals, expect=RANGE_VIEW)
    net = FusionNet(
        lidar_model=ModelConfig(dtype="bfloat16"),
        camera_model=ModelConfig(vertical_stride=2, use_regression=False, dtype="bfloat16"),
        lidar_pool=(2, 8), cam_pool=(8, 8))
    init_fusion_(net, 0)
    steps = FUSION_TRAIN_FRAMES // C3_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    losses = train_fusion(net, data, epochs=2, batch_size=C3_BATCH, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    more = train_fusion(net, data, epochs=2, batch_size=C3_BATCH, seed=1, device=dev)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / (2 * steps)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"    nothing locked: epoch mean losses {[round(x, 4) for x in losses + more]} "
        f"({steps} steps an epoch); first 2 epochs {first_s:.2f} s (cuDNN's first calls "
        f"included), then {warm_ms:.3f} ms a step (host clock, one loss readback a step); "
        f"peak device memory {peak:.0f} MiB, {resident:.0f} MiB resident before [{card}]")
    assert np.isfinite(losses + more).all(), "a fusion loss is not finite"
    assert more[-1] < losses[0], "the fusion loss did not fall"
    before = {k: v.clone() for k, v in net.state_dict().items()}
    locked = train_fusion(net, data, epochs=1, batch_size=C3_BATCH, lock_lidar=True,
                          lock_camera=True, seed=2, device=dev)
    after = net.state_dict()
    fcn_params = [k for k, _ in net.named_parameters() if k.startswith(("lidar_fcn.", "camera_fcn."))]
    unchanged = all(torch.equal(before[k], after[k]) for k in fcn_params)
    moved = [k for k, _ in net.named_parameters()
             if k not in fcn_params and not torch.equal(before[k], after[k])]
    stats_moved = not torch.equal(before["lidar_fcn.norm.mean"], after["lidar_fcn.norm.mean"])
    log(f"    both FCNs locked: loss {locked[0]:.4f}; {len(fcn_params)} FCN parameters "
        f"bit-unchanged = {unchanged}; {len(moved)} branch and head parameters moved; the locked "
        f"FCNs' BatchNorm running stats moved = {stats_moved} (they run with train=True, as in "
        "the reference)")
    heads = [k for k, _ in net.named_parameters() if "_head." in k]
    assert unchanged and set(heads) <= set(moved), "locking: the FCNs moved or a head did not"
    assert stats_moved and np.isfinite(locked).all()

    gdata = _golden.fusion_golden_data(dev)
    assert np.array_equal(gdata["cam_sha256"], gf["fusion_cam_sha256"])
    gdata["radar"] = gf["fusion_radar"]
    with torch.no_grad():
        lidar = range_view_project_batch(torch.from_numpy(gf["fusion_points"]).to(dev),
                                         valid=torch.from_numpy(gf["fusion_valid"]).to(dev))
    readings = {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        got = _golden.port_fusion_step(FUSION_ASSET, dtype, gdata, lidar, dev)
        r = _golden.fusion_step_readings(got, gt, tag)
        readings[tag] = r
        log(f"    one {dtype} step (train=True, dropout off) on the fusion golden's "
            f"{len(gdata['cam'])} frames: loss {got['loss']:.6f} vs {float(gt[f'fusion_{tag}/loss']):.6f}, "
            f"relative {r['loss_rel']:.3e} (limit {_golden.FUSION_TRAIN_LOSS_RTOL[tag]:.1e}); "
            f"gradients relative to each tensor's largest entry: worst {r['worst_grad']} "
            f"{r['grad_rel']:.3e} (limit {_golden.FUSION_TRAIN_GRAD_RTOL[tag]:.1e}), the lidar "
            f"FCN's {r['lidar_fcn_grad_rel']:.3e} (limit "
            f"{_golden.FUSION_TRAIN_LIDAR_FCN_GRAD_RTOL[tag]:.1e}), bf16 conv biases "
            f"{r['bias_grad_rel']:.3e} (limit {_golden.FUSION_TRAIN_BF16_BIAS_GRAD_RTOL:.1e}); "
            f"BatchNorm stats {r['stats_abs']:.3e}"
            + (f"; over the limit: {r['over']}" if r["over"] else ""))
        assert r["loss_rel"] <= _golden.FUSION_TRAIN_LOSS_RTOL[tag], f"fusion {dtype}: loss differs"
        assert not r["over"], f"fusion {dtype}: gradients differ"
        assert r["stats_abs"] <= 1e-4, f"fusion {dtype}: BatchNorm statistics differ"
    return {"ms_per_step": warm_ms, "peak_device_mib": peak, **readings}


def phase_config4(dev, spec, card, totals):
    """Phase 18: config 4 with the shipped asset, then with a detector
    quick-trained here at a reduced depth."""
    from tpufusion_torch import benchmarks
    from tpufusion_torch.predict import make_e2e_step

    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch

    batches = C4_FRAMES // TRAIN_BATCH
    companion = C4_COMPANIONS * (C4_COMPANION_FRAMES // TRAIN_BATCH)
    calls = 1 + batches * 3 + 1 + 2 * batches + companion
    log(f"phase 18 config 4: {C4_FRAMES} frames at batch {TRAIN_BATCH} x {N_POINTS}, "
        "CSV -> tracklet XML -> score_poses; the companion rows at "
        f"{C4_COMPANION_FRAMES} frames a family (the benchmark's default: {C4_FRAMES})")
    families = (("wide_yaw (ellipse, max_yaw 0.45)", "synthetic_detector_yaw.npz", 4000, "ellipse", 0.45),
                ("mixed_family circle", "synthetic_detector_mixed.npz", 4100, "circle", 0.05),
                ("mixed_family ellipse", "synthetic_detector_mixed.npz", 4100, "ellipse", 0.45),
                ("mixed_family box", "synthetic_detector_mixed.npz", 4100, "box", 0.45))
    for label, name, seed, surface, max_yaw in families:
        model, dcfg, _ = benchmarks.asset_model(benchmarks.detector_asset_path(name))
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(seed), TRAIN_BATCH, N_POINTS,
                                             max_yaw=max_yaw, vehicle_surface=surface)
        check_both(f"{label}'s first batch", model.to(dev).eval(), dcfg,
                   torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev), spec)
    row, counts = drive(
        f"config4_full_eval(weights='asset') ({calls} e2e steps: warm-up, {batches} batches x 3 "
        f"timed, warm-up + {batches} for the device time, {batches} drained, {companion} in the "
        "companion rows)",
        lambda: benchmarks.config4_full_eval(dev, frames=C4_FRAMES, batch=TRAIN_BATCH,
                                             companion_frames=C4_COMPANION_FRAMES), totals,
        expect=DIRECT)
    assert counts == {"nearest_wins_image": calls, "connected_components_with_bbox": calls}, (
        "config 4: both kernels once a step")
    log(f"  {json.dumps(row)} [{card}]")
    assert row["detection_rate"] >= 0.9 and row["recall@iou0.25"] >= 0.8, "config 4 misses"
    assert row["mean_xy_err"] < 1.0 and row["submission_recall@iou0.25"] >= 0.8
    wide, mixed = row["wide_yaw"], row["mixed_family"]
    assert wide["detection_rate"] >= 0.9 and wide["recall@iou0.25"] >= 0.5, "wide-yaw row misses"
    assert all(f["detection_rate"] >= 0.9 for f in mixed["per_family"].values()), "a family misses"

    depth = {"n_batches": 2, "steps_per_batch": 5}
    (model, dcfg, head), counts = drive(
        f"quick_trained_model at a reduced depth ({depth}; the default is 8 x 15)",
        lambda: benchmarks.quick_trained_model(dev, N_POINTS, **depth), totals,
        expect=RANGE_VIEW)
    assert counts["nearest_wins_image"] == 10, "one z-buffer launch a train step"
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    (p, v), = benchmarks.point_sets(1, TRAIN_BATCH, N_POINTS, dev)
    poses, found = make_e2e_step(model, spec, dcfg, head=head, device=dev)(p, v)
    log(f"    weights finite = {finite}; the {head} decode of its output on one batch: poses "
        f"finite = {bool(torch.isfinite(poses).all())}, found {int(found.sum())}/{TRAIN_BATCH}")
    assert finite and poses.shape == (TRAIN_BATCH, 7) and torch.isfinite(poses).all()
    qrow, counts = drive(
        f"config4_full_eval(weights='quick_train', {depth}, reps=1, no companion rows: "
        "they use the shipped assets, driven above)",
        lambda: benchmarks.config4_full_eval(
            dev, "quick_train", frames=C4_FRAMES, batch=TRAIN_BATCH, reps=1, quick_train=depth,
            companion_frames=0), totals, expect=CORNER)
    log(f"  {json.dumps(qrow)} (reduced depth: 2 scene batches x 5 steps) [{card}]")
    assert qrow["weights"] == "quick_train" and qrow["head"] == "corner"
    assert "wide_yaw" not in qrow and "mixed_family" not in qrow
    return row


def phase_data_parallel(dev, spec, card, totals):
    """Phase 19: (a) a mesh of one over NCCL against the plain step, bit
    for bit, with no host sync; (b) two gloo ranks on the one card through
    dryrun_multichip's four phases at full geometry; (c) the same four
    phases on a 1 x 2 spatial mesh."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpufusion_torch.config import LossConfig, MeshConfig, ModelConfig, TrainConfig
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.parallel import dryrun
    from tpufusion_torch.parallel.mesh import average_gradients, make_mesh
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import make_train_step

    log(f"phase 19 data parallelism: (a) a mesh of one over NCCL, {TRAIN_BATCH} x {N_POINTS} "
        "points, bf16 default widths, corner head + roll")
    mesh = make_mesh(MeshConfig(n_devices=1), device=dev)  # a group of one, NCCL
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's wgrad may sum in another order a call
    try:
        batches = []
        for i in range(TRAIN_SCENE_BATCHES):
            p, gt, v = synthesize_beam_scan_batch(np.random.default_rng(1900 + i), TRAIN_BATCH, N_POINTS)
            batches.append({k: torch.from_numpy(a).to(dev) for k, a in {"points": p, "valid": v, **gt}.items()})
        tcfg = TrainConfig(batch_size=TRAIN_BATCH, augment=True)
        mcfg = ModelConfig(dtype="bfloat16")

        def run(mesh_or_none, steps):
            model = FCN(mcfg, seed=0).to(dev)
            opt, gen = Adam(model.parameters(), 3e-3), torch.Generator(device=dev).manual_seed(0)
            step = make_train_step(spec, LossConfig(), tcfg, mesh=mesh_or_none, device=dev)
            outs = [step(model, opt, batches[i % len(batches)], gen) for i in range(steps)]
            state = {**{f"grad/{n}": p.grad for n, p in model.named_parameters()},
                     **{f"param/{n}": p.detach() for n, p in model.named_parameters()},
                     **{f"buffer/{n}": b for n, b in model.named_buffers()},
                     **{f"loss{i}": loss for i, (loss, _) in enumerate(outs)},
                     **{f"{k}{i}": m for i, (_, ms) in enumerate(outs) for k, m in ms.items()}}
            return state, (model, opt, gen, step)

        plain, (pm, po, pg, pstep) = run(None, len(batches))
        again, _ = run(None, len(batches))
        meshed, (mm, mo, mg, mstep) = run(mesh, len(batches))
        control = all(torch.equal(plain[k], again[k]) for k in plain)
        differ = [k for k in plain if not torch.equal(plain[k], meshed[k])]
        log(f"  {len(batches)} steps each: the plain step run twice bit-identical = {control}; "
            f"the mesh step against it: {len(plain) - len(differ)} of {len(plain)} tensors "
            f"(loss, metrics, gradients, parameters, BatchNorm statistics) bit-identical"
            + (f"; differ: {differ[:6]}" if differ else ""))
        assert control and not differ, "the mesh of one is not the plain step"

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(8):
                mstep(mm, mo, batches[i % len(batches)], mg)
        syncs = _sync_events(prof)
        torch.cuda.synchronize()
        log(f"  8 profiled mesh steps: host-sync calls {syncs or 'none'}")
        assert not syncs, "the mesh step waits for the card"

        params = [p for p in mm.parameters()]
        n_floats = sum(p.numel() for p in params)
        order = ("plain", "mesh", "mesh", "plain")
        times = {k: [] for k in ("plain", "mesh")}
        device_times = {k: [] for k in ("plain", "mesh")}
        for which in order:
            model, opt, gen, step = (pm, po, pg, pstep) if which == "plain" else (mm, mo, mg, mstep)
            times[which].append(time_ms(lambda b: step(model, opt, b, gen), batches))
            device_times[which].append(device_ms(lambda b: step(model, opt, b, gen), batches))
        ar_ms = time_ms(lambda _: average_gradients(params, mesh), batches)
        try:
            ar_dev = device_ms(lambda _: average_gradients(params, mesh), batches)
            ar_source = "torch.profiler's device records"
        except RuntimeError as e:  # late in the process the profiler may record no device event
            log(f"  the all-reduce's device time: {e}; taken from the queued calls instead")
            ar_dev = queued_ms(lambda _: average_gradients(params, mesh), batches)
            ar_source = "CUDA events around the calls queued behind a sleep (queued_ms)"
        dp = {"ms_per_step": {k: [round(x, 3) for x in v] for k, v in times.items()},
              "device_ms_per_step": {k: [round(x, 3) for x in v] for k, v in device_times.items()},
              "allreduce_ms": round(ar_ms, 3), "allreduce_device_ms": round(ar_dev, 4),
              "allreduce_device_source": ar_source,
              "allreduce_floats": n_floats, "backend": mesh.backend, "world_size": mesh.world_size}
        log(f"  times in turns {order} over {len(batches)} distinct batches: {json.dumps(dp)} [{card}]")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()

    train = {}
    for label, cfg in (("(b)", MeshConfig(n_devices=DP_RANKS)),
                       ("(c)", MeshConfig(n_devices=SPATIAL_RANKS, n_spatial=SPATIAL_RANKS))):
        n = cfg.n_devices
        log(f"phase 19 {label} {n} ranks on the one card over gloo, mesh {dryrun.mesh_shape(cfg)}: "
            f"dryrun_multichip at 32 x 1801, {2 * n} x {N_POINTS} points (phases 1-3), {n} x {N_POINTS} (phase 4)")
        t0 = time.perf_counter()
        out = dryrun.dryrun_multichip(n, device=dev, backend="gloo", spec=spec, n_points=N_POINTS,
                                      full_points=N_POINTS, timed_steps=3, mesh_cfg=cfg,
                                      small_float_golden=GOLDEN_F8_MESH)
        wall = time.perf_counter() - t0
        phases = ("train", "corner", "flagship", "full_width")
        for r, rank in enumerate(out["ranks"]):
            holds = {ph: rank[ph]["kernels"] for ph in phases}
            log(f"  rank {r}: launches {json.dumps({ph: rank[ph]['launches'] for ph in phases})}; "
                f"kernels against plain on its own points {json.dumps(holds)}")
            assert rank["train"]["launches"] == {
                "project_points": 1, "nearest_wins_image": 1, "connected_components_with_bbox": 0,
                "corner_vote": 0}
            for ph in ("corner", "flagship", "full_width"):
                assert rank[ph]["launches"] == {
                    "project_points": 1, "nearest_wins_image": 1, "connected_components_with_bbox": 1,
                    "corner_vote": int(ph == "corner")}
                assert all(rank[ph]["kernels"][k] for k in ("pixels_equal", "zbuffer_equal", "cc_equal"))
            sfl = rank["small_float"]
            log(f"  rank {r}: the f8 mesh golden's step ({sfl['layout']}): gradients equal to JAX's "
                f"same-mesh step: at least {sfl['same']:.4%} of each tensor (the least: "
                f"{sfl['worst']}); at most {sfl['steps']} steps off, loss "
                f"{sfl['loss']:.6g} ({sfl['loss_rel']:.2e} relative); launches {sfl['launches']}; "
                f"3 more steps {sfl['ms_per_step']:.3f} ms a step (host clock) [{card}]")
            assert all(sfl["launches"][k] > 0 for k in dryrun.SMALL_FLOAT_KERNELS), sfl["launches"]
        tr = train[label] = out["ranks"][0]["train"]
        tr["small_float"] = out["ranks"][0]["small_float"]
        if cfg.n_spatial > 1:
            halo = tr["halo"]
            log(f"  halo exchanges of one train step: {halo['calls']} forward, {halo['columns']} columns "
                f"received, {halo['grad_columns']} gradient columns returned (32 x 1801, each rank the "
                f"row's {2 * cfg.n_spatial} frames); "
                f"alone, forward and backward: {tr['halo_ms']:.3f} ms a step (host clock) [{card}]")
        log(f"  sharded train step {tr['ms_per_step']:.3f} ms (its gloo gradient all-reduce alone "
            f"{tr['allreduce_ms']:.3f} ms) vs one process {tr['one_process_ms_per_step']:.3f} ms "
            f"(host clock, 3 steps, the card synchronized); the whole dry run {wall:.1f} s [{card}]")
        for k, v in out["launches"].items():
            totals[k] += v
        log(f"  kernel launches over the ranks' sharded calls: {out['launches']}")
    return dp, train


def phase_config5_bench(dev, spec, card, totals):
    """Phase 20: benchmarks.config5_waymo_scale with its oriented row;
    both kernels held on its clouds first."""
    from tpufusion_torch import benchmarks
    from tpufusion_torch.data.synthetic import synthesize_beam_tracking_sequence

    log(f"phase 20 config 5 (benchmarks.config5_waymo_scale): {C5_BATCH} x {C5_POINTS} points "
        f"({C5_BEAMS} beams), the asset's top-4 decode, {TRACK_FRAMES} tracked frames, the oriented row")
    model, dcfg, _ = benchmarks.asset_model(benchmarks.detector_asset_path())
    (p, v), = benchmarks.point_sets(1, C5_BATCH, C5_POINTS, dev, C5_BEAMS)
    check_both("config 5's first batch", model.to(dev).eval(), dcfg, p, v, spec)
    ymodel, ydcfg, _ = benchmarks.asset_model(
        benchmarks.detector_asset_path("synthetic_detector_yaw.npz"))
    seq, _, sv = synthesize_beam_tracking_sequence(np.random.default_rng(88), TRACK_FRAMES, N_POINTS,
                                                   oriented=True)
    check_both("the oriented sequence", ymodel.to(dev).eval(), ydcfg, torch.from_numpy(seq).to(dev),
               torch.from_numpy(sv).to(dev), spec)
    calls = 1 + 4 * 3 + 1 + 4 + 2  # measure's warm-up, 4 sets x 3, device pass; two sequences
    row, counts = drive(f"config5_waymo_scale ({calls} e2e steps)",
                        lambda: benchmarks.config5_waymo_scale(dev), totals, expect=DIRECT)
    assert counts == {"nearest_wins_image": calls, "connected_components_with_bbox": calls}
    log(f"  {json.dumps(row)} [{card}]")
    assert row["detections"] >= TRACK_FRAMES and row["tracks"] >= 1, "config 5 tracks nothing"
    assert row["box_recall"] >= 0.75 and row["oriented"]["box_recall"] >= 0.5, "config 5 misses"
    return row


def phase_host_syncs(dev, spec, card) -> dict:
    """Phase 21: host-sync calls in SYNC_STEPS profiled steps (after a
    warm-up) of the direct f32 step, config 1, config 3 and config 5, each
    on one input set (the count does not depend on the data)."""
    from torch.profiler import ProfilerActivity, profile

    from tpufusion_torch import ModelConfig, benchmarks
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.models.io import fusion_from_asset
    from tpufusion_torch.predict import make_e2e_step

    def scans(batch, points, beams=32):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(2100), batch, points, n_beams=beams)
        return [(torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev))]

    f32, dcfg = asset_fcn(ASSET, "float32", dev)
    bf16, _ = asset_fcn(ASSET, "bfloat16", dev)
    c3 = benchmarks.make_config3_step(benchmarks.seeded_fcn(ModelConfig(), 1, dev),
                                      fusion_from_asset(benchmarks.fusion_asset_path(), dev), dev)
    paths = {
        f"direct f32, {BATCH} x {N_POINTS}": (
            make_e2e_step(f32, spec, dcfg, head="direct", device=dev), scans(BATCH, N_POINTS)),
        f"config 1, 1 x {N_POINTS}": (benchmarks.make_config1_step(
            benchmarks.seeded_fcn(ModelConfig(), 0, dev), dev), scans(1, N_POINTS)),
        f"config 3, {C3_BATCH} x {N_POINTS} + camera": (c3, benchmarks.config3_inputs(dev, C3_BATCH, N_POINTS, 1)),
        f"config 5, {C5_BATCH} x {C5_POINTS}, top-4": (make_e2e_step(
            bf16, spec, dcfg, max_obstacles=4, head="direct", device=dev),
            scans(C5_BATCH, C5_POINTS, C5_BEAMS)),
    }
    counts = {}
    log(f"phase 21 host-sync calls in {SYNC_STEPS} profiled steps after a warm-up "
        "(stream / device / event synchronize, aten::item)")
    for label, (fn, inputs) in paths.items():
        fn(*inputs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SYNC_STEPS):
                fn(*inputs[0])
        counts[label] = _sync_events(prof)
        torch.cuda.synchronize()
        log(f"  host-sync calls, {label}: {counts[label] or 'none'} [{card}]")
    return counts


def _native_against_plain(bag: str) -> dict:
    """The bag's payloads through the native codec and its plain versions:
    every cloud unpacked both ways (equal arrays), every lz4 chunk decoded
    natively and the first DRIVE_PLAIN_CHUNKS by the pure-Python decoder
    (equal bytes), every chunk re-encoded natively to its bytes in the bag.
    Returns the MB/s of each, host clock."""
    from tpufusion_torch.data import lz4
    from tpufusion_torch.data.rosbag_reader import (
        BagReader,
        _iter_file_records,
        parse_pointcloud2,
    )

    raws = [m.raw for m in BagReader(bag).read_messages(topics=["/velodyne_points"])]
    t = time.perf_counter()
    native = [parse_pointcloud2(r) for r in raws]
    t_native = time.perf_counter() - t
    t = time.perf_counter()
    plain = [parse_pointcloud2(r, use_native=False) for r in raws]
    t_plain = time.perf_counter() - t
    assert all(np.array_equal(a, b) for a, b in zip(native, plain)), "native unpack differs from numpy's"

    with open(bag, "rb") as f:
        f.readline()
        chunks = [(h, d) for h, d in _iter_file_records(f) if h.get("op", b"\x00")[0] == 0x05]
    assert all(h["compression"] == b"lz4" for h, _ in chunks)
    t = time.perf_counter()
    raw_chunks = [lz4.lz4_frame_decompress(d, int.from_bytes(h["size"], "little")) for h, d in chunks]
    t_lz4 = time.perf_counter() - t
    sample = chunks[:DRIVE_PLAIN_CHUNKS]
    t = time.perf_counter()
    plain_chunks = [lz4.lz4_frame_decompress_reference(d, int.from_bytes(h["size"], "little"))
                    for h, d in sample]
    t_lz4_plain = time.perf_counter() - t
    assert plain_chunks == raw_chunks[: len(sample)], "native lz4 decode differs from the plain one"
    assert all(lz4.lz4_frame_compress(r) == d for r, (_, d) in zip(raw_chunks, chunks)), (
        "native lz4 re-encode differs from the bag's bytes")
    cloud_mb = sum(len(r) for r in raws) / 1e6
    lz4_mb = sum(len(r) for r in raw_chunks) / 1e6
    sample_mb = sum(len(r) for r in plain_chunks) / 1e6
    return {"clouds": len(raws), "cloud_mb": cloud_mb, "unpack_native_mb_s": cloud_mb / t_native,
            "unpack_plain_mb_s": cloud_mb / t_plain, "chunks": len(chunks), "chunk_mb": lz4_mb,
            "lz4_native_mb_s": lz4_mb / t_lz4, "plain_chunks": len(sample),
            "lz4_plain_mb_s": sample_mb / t_lz4_plain}


def phase_offline_drive(dev, spec, card, totals, work):
    """Phase 22: the offline drive, its files under `work` (phase 24 reads
    the extracted dir `work/inram`). (a) a bag at the rehearsal's defaults;
    (b) extract_bag_dataset in RAM and streaming with the BEV, the layouts
    equal, the z-buffer on each batch of the bag's own NaN-padded clouds,
    the BEV against the CPU's, the native codec against its plain versions
    on the bag's payloads; (c) the rehearsal through the CLI, its predict
    CSV against predict_images of the restored checkpoint and the CC on
    that model's heat masks."""
    import filecmp
    import math

    from tpufusion_torch.config import DEFAULT, BevSpec
    from tpufusion_torch.data.etl import (
        extract_bag_dataset,
        load_camera_extracted,
        load_extracted,
    )
    from tpufusion_torch.data.rosbag_reader import extract_bag_points
    from tpufusion_torch.decode.decode import heat_mask
    from tpufusion_torch.eval.submission import write_predictions_csv
    from tpufusion_torch.geometry.bev import bev_rasterize_batch
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.predict import predict_images
    from tpufusion_torch.tools import rehearse_bag_pipeline as rehearse
    from tpufusion_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    log(f"phase 22 the offline drive: a {DRIVE_FRAMES}-frame lz4 bag of {N_POINTS}-point beam "
        "scans, a 1096 x 1368 mono8 camera and radar tracks -> extract (in RAM, streaming) -> "
        "the CLI's extract, train, predict, submit, score")
    bag = os.path.join(work, "scene.bag")
    t = time.perf_counter()
    meta = rehearse.synthesize_bag(bag, DRIVE_FRAMES, N_POINTS, seed=11)
    log(f"  (a) synthesize_bag: {meta['bag_bytes'] / 1e6} MB ({meta['cloud_bytes'] / 1e6} MB "
        f"of clouds) written in {time.perf_counter() - t:.3f} s (host clock)")

    bev = BevSpec()
    dirs = {"in RAM": os.path.join(work, "inram"), "streaming": os.path.join(work, "stream")}
    launches = math.ceil(DRIVE_FRAMES / DRIVE_BATCH)
    reports = {}
    for mode, out in dirs.items():
        t = time.perf_counter()
        reports[mode], counts = drive(
            f"(b) extract_bag_dataset {mode}, with BevSpec(), batch {DRIVE_BATCH}",
            lambda: extract_bag_dataset(bag, out, tracklet_xml=meta["gt_xml"], bev=bev,
                                        streaming=mode == "streaming", batch=DRIVE_BATCH,
                                        device=dev),
            totals, expect=RANGE_VIEW)
        s = time.perf_counter() - t
        log(f"    {s:.3f} s, {DRIVE_FRAMES / s:.3f} frames/s (host clock) [{card}]")
        assert counts["nearest_wins_image"] == launches, "one z-buffer launch a batch"
    assert reports["streaming"].pop("streaming") is True and reports["in RAM"] == reports["streaming"]
    a, b = (load_extracted(d) for d in dirs.values())
    ca, cb = (load_camera_extracted(d) for d in dirs.values())
    bev_a = np.load(os.path.join(dirs["in RAM"], "bev_frames.npz"))["images"]
    bev_b = np.load(os.path.join(dirs["streaming"], "bev_frames.npy"))
    csvs = ("lidar_timestamps.csv", "camera_timestamps.csv", "obs_poses_interp_transform.csv",
            "obs_poses_camera.csv", os.path.join("radar", "radar_tracks.csv"))
    same = {
        "lidar_frames": np.array_equal(a["images"], b["images"]),
        "timestamps": np.array_equal(a["timestamps"], b["timestamps"]),
        "bev_frames": np.array_equal(bev_a, bev_b),
        "camera_frames": np.array_equal(ca["images"], cb["images"]),
        "csvs": all(filecmp.cmp(*(os.path.join(d, c) for d in dirs.values()), shallow=False)
                    for c in csvs),
    }
    log(f"    in RAM vs streaming equal: {same}; {a['images'].shape} range views, "
        f"{bev_a.shape} BEVs, {ca['images'].shape} camera frames")
    assert all(same.values()), f"the streaming layout differs from the in-RAM one: {same}"
    assert a["images"].shape == (DRIVE_FRAMES, 32, 1801, 3) and np.isfinite(a["images"]).all()

    clouds, _ = extract_bag_points(bag)  # (F, Nmax, 4), NaN past each cloud's end
    for lo in range(0, DRIVE_FRAMES, DRIVE_BATCH):
        check_zbuffer(f"the bag's NaN-padded clouds {lo}:{lo + DRIVE_BATCH}",
                      torch.from_numpy(clouds[lo:lo + DRIVE_BATCH]).to(dev), None, spec)
    with torch.inference_mode():
        want = bev_rasterize_batch(torch.from_numpy(clouds), bev).numpy()
    bev_check("(b) the extracted BEVs (card) vs the CPU's", bev_a, want)
    codec = _native_against_plain(bag)
    log(f"    native codec vs plain on the bag's payloads (host clock): {json.dumps(codec)}")

    workdir = os.path.join(work, "rehearse")
    args = ["--device", str(dev), "--workdir", workdir, "--frames", str(DRIVE_FRAMES),
            "--n_points", str(N_POINTS), "--epochs", str(DRIVE_EPOCHS),
            "--batch", str(DRIVE_TRAIN_BATCH)]
    summary, counts = drive(
        f"(c) rehearse_bag_pipeline.main({args[:2]} + the rehearsal's defaults): the CLI's "
        f"extract, train ({DRIVE_EPOCHS} epochs, batch {DRIVE_TRAIN_BATCH}, direct head), "
        "predict, submit, score", lambda: rehearse.main(args), totals, expect=DIRECT_TRAIN)
    assert counts == {"nearest_wins_image": launches,
                      "connected_components_with_bbox": math.ceil(DRIVE_FRAMES / DRIVE_TRAIN_BATCH)}, (
        "the CLI: a z-buffer launch an extract batch, a CC launch a predict batch")
    log(f"    stages (s, host clock): {json.dumps(summary['timings_s'])}; total "
        f"{summary['total_s']:.3f} s [{card}]")
    log(f"    host RSS (MiB) a stage, start / peak: {json.dumps(summary['rss_mib'])}")
    log(f"    score: {json.dumps(summary['score'])}; submission poses "
        f"{summary['submission_poses']}/{DRIVE_FRAMES}")
    assert summary["submission_poses"] == DRIVE_FRAMES

    cfg = DEFAULT.replace(model=dataclasses.replace(
        DEFAULT.model, head="direct", reg_output_activation="linear"))
    model = FCN(cfg.model, 3)
    CheckpointManager(os.path.join(workdir, "run", "ckpt")).restore(model, device=dev)
    ds = os.path.join(workdir, "ds")
    data = load_extracted(ds)
    poses, found = predict_images(model, data["images"], cfg, DRIVE_TRAIN_BATCH, dev)
    mine = os.path.join(work, "predict_images.csv")
    write_predictions_csv([tuple(p) for p in poses], list(map(int, data["timestamps"])), mine)
    cli_csv = os.path.join(workdir, "pred", "objects_obs1_lidar_predictions.csv")
    same_csv = filecmp.cmp(mine, cli_csv, shallow=False)
    log(f"    cli predict's CSV equals predict_images of the restored checkpoint: {same_csv} "
        f"(found {int(found.sum())}/{DRIVE_FRAMES})")
    assert same_csv, "cli predict differs from predict_images"
    with torch.inference_mode():
        images = torch.from_numpy(np.array(data["images"])).to(dev)
        heat = heat_mask(model.eval()(images)[..., 1], cfg.decode)
    check_cc("the CLI-trained model's heat masks", heat)
    log(f"  phase 22 took {time.perf_counter() - t_phase:.3f} s (host clock) [{card}]")
    return summary


def phase_tools(dev, spec, card, totals):
    """Phase 23: the training and tuning tools at full width, each through
    its `main` as a user runs it, outputs in a temporary directory. (a) the
    tuner on a copy of the shipped asset, its row at the asset's operating
    point against make_e2e_step on the same frames, the CC kernel on its
    heat masks at every min_prob it sweeps, both kernels timed at the
    tools' shapes; (b) the trainer warm-started from the asset; (c) the
    envelope and the oracle arms, the z-buffer on the envelope's surfaces
    and resolutions; (d) the fusion tool at the full camera; (e) the camera
    bench with its five longest kernels."""
    import shutil
    import tempfile

    from tpufusion_torch import benchmarks
    from tpufusion_torch._golden import wrapped_pose_diff
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import heat_mask
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys
    from tpufusion_torch.models.io import fusion_from_asset
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.tools import bench_camera_full as camera_bench
    from tpufusion_torch.tools import detector_envelope as envelope
    from tpufusion_torch.tools import fit_oracle_sensitivity as oracle
    from tpufusion_torch.tools import train_fusion_synthetic as fusion_tool
    from tpufusion_torch.tools import train_synthetic_detector as trainer
    from tpufusion_torch.tools import tune_detector_asset as tuner

    t_phase = time.perf_counter()
    dev_arg = ["--device", str(dev)]
    log(f"phase 23 the training and tuning tools at full width (32 x 1801, {TOOL_BATCH} x "
        f"{N_POINTS}-point frames, the width-2 direct head), each through its main")
    with tempfile.TemporaryDirectory(prefix="tools_") as work:
        # -- (a) the tuner on a copy of the shipped asset --------------------------
        asset = os.path.join(work, "tuned", os.path.basename(ASSET))
        os.makedirs(os.path.dirname(asset))
        for ext in ("", ".json"):
            shutil.copyfile(ASSET + ext, asset + ext)
        with open(ASSET + ".json") as f:
            before = json.load(f)
        args = ["--asset", asset, "--eval_batches", "1", "--per_resolution", str(TOOL_SPARSE)]
        t = time.perf_counter()
        sweep_points = len(tuner.PROBS) * len(tuner.AREAS) * len(tuner.CENTERS)
        res_points = len(tuner.RESOLUTION_PROBS) * len(tuner.RESOLUTION_AREAS)
        out, counts = drive(
            f"(a) tune_detector_asset.main({' '.join(args[2:])}): {sweep_points} operating points "
            f"on {TOOL_BATCH} frames, the confirmation, {res_points} at {TOOL_SPARSE} points",
            lambda: tuner.main(args + dev_arg), totals, expect=DIRECT)
        log(f"    {time.perf_counter() - t:.3f} s (host clock) [{card}]")
        assert counts == {"nearest_wins_image": 4,
                          "connected_components_with_bbox": sweep_points + res_points + 2}, (
            "the tuner: a z-buffer launch a prepared batch, a CC launch a decode")
        best = {k: out["best"][k] for k in ("min_prob", "min_bbox_area", "center", "det",
                                             "mean_iou", "recall_iou25", "xy_err", "score")}
        log(f"    winner {json.dumps(best)}; confirmation (seeds 5999) "
            f"{json.dumps(out['confirmation'])}; per resolution {json.dumps(out['per_resolution'])}")
        with open(asset + ".json") as f:
            after = json.load(f)
        kept = set(before) - {"decode", "best", "confirmation", "decode_per_resolution"}
        assert kept and all(after[k] == before[k] for k in kept), "the rewrite lost a key"
        log(f"    the rewritten json keeps {sorted(kept)}")

        model, dcfg, _ = benchmarks.asset_model(ASSET)
        op = (dcfg.min_prob, dcfg.min_bbox_area, dcfg.direct_center)
        row = next(r for r in out["rows"] if (r["min_prob"], r["min_bbox_area"], r["center"]) == op)
        pts, gt, valid = trainer._synth("beam", np.random.default_rng(999), TOOL_BATCH, N_POINTS,
                                        0.05)
        poses, found = make_e2e_step(model, spec, dcfg, head="direct", max_obstacles=1,
                                     device=dev)(pts, valid)
        poses, found = poses.cpu().numpy(), found.cpu().numpy()
        protocol = out["prepared"]["beam"]
        sweep_poses, sweep_found, sweep_gt = trainer.decode_prepared(
            protocol, spec, dcfg, "direct", dcfg.direct_center)
        diff = float(wrapped_pose_diff(poses, sweep_poses).max())
        want = trainer.detection_scores(poses, found, gt)
        score_diff = max(abs(row[k] - want[k]) for k in want if not np.isnan(want[k]))
        log(f"    the sweep's row at the asset's operating point {op} against make_e2e_step("
            f"head='direct', max_obstacles=1) on the same {TOOL_BATCH} frames: found equal = "
            f"{np.array_equal(found, sweep_found)} ({int(found.sum())}/{TOOL_BATCH}), largest "
            f"pose difference {diff:.3e} (tolerance 1e-4), scores within {score_diff:.3e}")
        assert np.array_equal(sweep_gt["center"], gt["center"]) and np.array_equal(found, sweep_found)
        assert diff <= 1e-4 and score_diff <= 1e-4 and row["det"] == want["det"]

        prob = protocol[0][0][..., 1]
        sparse = out["prepared_per_resolution"][TOOL_SPARSE]["beam"][0][0][..., 1]
        with torch.inference_mode():
            masks = {p: heat_mask(prob, dataclasses.replace(dcfg, min_prob=p)) for p in tuner.PROBS}
            for p in tuner.RESOLUTION_PROBS:
                check_cc(f"the tuner's heat masks at {TOOL_SPARSE} points, min_prob {p}",
                         heat_mask(sparse, dataclasses.replace(dcfg, min_prob=p)))
        for p, mask in masks.items():
            check_cc(f"the tuner's heat masks at {N_POINTS} points, min_prob {p}", mask)

        # both kernels at the tools' shapes: the protocol, confirmation and a
        # trainer step's frames; the tuner's masks at its four thresholds
        sets = [(pts, valid)]
        for seed in (5999, 100_001):
            p, _, v = trainer._synth("beam", np.random.default_rng(seed), TOOL_BATCH, N_POINTS, 0.05)
            sets.append((p, v))
        with torch.inference_mode():
            zargs = [_frame_pixels_keys(torch.from_numpy(p).to(dev), spec, torch.from_numpy(v).to(dev))
                     for p, v in sets]
            kt = kernel_turns(spec, zargs, list(masks.values()), dcfg)
        log(f"  kernels at the tools' shapes ({TOOL_BATCH} x {N_POINTS} points, {len(zargs)} "
            f"batches; {TOOL_BATCH} x 32 x 1801 heat masks at min_prob {list(masks)}): "
            f"{turns_line(kt)} [{card}]")

        # -- (b) the trainer, warm-started from the shipped asset --------------------
        out_asset = os.path.join(work, "trained", "synthetic_detector.npz")
        args = ["--init_from", ASSET, "--steps", "4", "--eval_every", "2", "--eval_batches", "1",
                "--points_mix", f"{TOOL_SPARSE},{N_POINTS}", "--out", out_asset]
        t = time.perf_counter()
        trained, counts = drive(
            f"(b) train_synthetic_detector.main({' '.join(args[2:-2])}), batch and width at their "
            "defaults", lambda: trainer.main(args + dev_arg), totals, expect=DIRECT_TRAIN)
        log(f"    {time.perf_counter() - t:.3f} s (host clock) [{card}]; best "
            f"{json.dumps({k: trained[k] for k in ('step', 'center', 'det', 'mean_iou', 'score')})}")
        modes = len(trainer.CENTER_MODES)
        assert counts == {"nearest_wins_image": 4 + 2, "connected_components_with_bbox": 2 * modes}, (
            "the trainer: a z-buffer launch a step and an eval, a CC launch a center mode an eval")
        assert os.path.exists(out_asset) and os.path.exists(out_asset + ".json")
        benchmarks.asset_model(out_asset)  # raises on any fault
        with np.load(ASSET) as shipped, np.load(out_asset) as written:
            same = sorted(shipped.files) == sorted(written.files) and all(
                written[k].shape == shipped[k].shape and written[k].dtype == shipped[k].dtype
                for k in shipped.files)
        log(f"    the written asset loads (benchmarks.asset_model) and has the shipped asset's "
            f"keys, shapes and dtypes: {same}")
        assert same, "the trained asset's layout differs from the shipped one"
        p, _, v = trainer._synth("beam", np.random.default_rng(100_002), TOOL_BATCH, TOOL_SPARSE,
                                 0.05, vary_size=True)
        check_zbuffer(f"the trainer's {TOOL_SPARSE}-point batch (step 2)",
                      torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev), spec)

        # -- (c) the envelope and the oracle arms ------------------------------------
        args = ["--batch", str(ENVELOPE_BATCH), "--eval_batches", "1"]
        t = time.perf_counter()
        rows, counts = drive(f"(c) detector_envelope.main({' '.join(args)})",
                             lambda: envelope.main(args + dev_arg), totals, expect=DIRECT)
        log(f"    {time.perf_counter() - t:.3f} s (host clock) [{card}]; {json.dumps(rows)}")
        assert counts == {"nearest_wins_image": 14, "connected_components_with_bbox": 14}
        assert len(rows) == 18 and rows["trained distribution"]["det"] >= 0.75
        kw = dict(envelope.conditions(envelope.base_condition_from_meta(before)))
        for name in ("sparse sweep (16k pts)", "dense sweep (65k pts)", "ellipse yaw +-0.2",
                     "box yaw +-0.4"):
            p, _, v = synthesize_beam_scan_batch(np.random.default_rng(999), ENVELOPE_BATCH,
                                                 **kw[name])
            check_zbuffer(f"the envelope's {name!r}", torch.from_numpy(p).to(dev),
                          torch.from_numpy(v).to(dev), spec)
        args = ["--asset", os.path.join(ASSETS, "synthetic_detector_mixed.npz"), "--batch",
                str(ENVELOPE_BATCH), "--eval_batches", "1"]
        arms, counts = drive(f"(c) fit_oracle_sensitivity.main(the mixed asset, {' '.join(args[2:])})",
                             lambda: oracle.main(args + dev_arg), totals, expect=DIRECT)
        log(f"    {json.dumps(arms)}")
        assert counts == {"nearest_wins_image": 1, "connected_components_with_bbox": 4}
        assert all(a["det"] >= 0.75 for a in arms.values()), "an oracle arm misses"

        # -- (d) the fusion tool at the full 512 x 1368 camera -----------------------
        fout = os.path.join(work, "fusion", "fusion_net.npz")
        args = ["--train_frames", "16", "--eval_frames", "8", "--epochs", "1", "--batch", "8",
                "--out", fout, "--cache_dir", os.path.join(work, "fusion_cache")]
        t = time.perf_counter()
        results, counts = drive(f"(d) train_fusion_synthetic.main({' '.join(args[:8])}), both "
                                "variants", lambda: fusion_tool.main(args + dev_arg), totals,
                                expect=RANGE_VIEW)
        log(f"    {time.perf_counter() - t:.3f} s (host clock) [{card}]; {json.dumps(results)}")
        assert counts == {"nearest_wins_image": 2, "connected_components_with_bbox": 0}, (
            "the fusion tool: a z-buffer launch a dataset")
        assert sorted(results) == ["fused", "lidar_only", "radar_range_noise"]
        fusion_from_asset(fout, dev)  # raises on any fault
        log("    models.io.fusion_from_asset loads the written float16 asset")

        # -- (e) the camera bench -----------------------------------------------------
        args = ["--batch", "8", "--steps", "4", "--frames", "16", "--timing_batches", "2"]
        cam, counts = drive(f"(e) bench_camera_full.main({' '.join(args)})",
                            lambda: camera_bench.main(args + dev_arg), totals, expect=())
        assert not any(counts.values()), "the camera bench runs neither kernel"
        log(f"    camera-FCN train step at batch 8, 512 x 1368: {cam['ms_per_step']} ms "
            f"({cam['frames_per_sec']} frames/s; device {cam['device_ms_per_call']} ms a step, "
            f"busy {cam['device_busy']}; peak {cam['peak_device_mib']} MiB) [{card}]")
        for k in cam["top_kernels"]:
            log(f"      {k['share']:.1%} {k['ms']:.4f} ms  {k['name'][:140]}")
        assert np.isfinite(cam["loss_last"])
    log(f"  phase 23 took {time.perf_counter() - t_phase:.3f} s (host clock) [{card}]")


def _sof0_size(jpeg_bytes: bytes) -> tuple[int, int]:
    """(height, width) of a baseline JPEG's SOF0 segment."""
    i = jpeg_bytes.index(b"\xff\xc0")
    return (int.from_bytes(jpeg_bytes[i + 5:i + 7], "big"),
            int.from_bytes(jpeg_bytes[i + 7:i + 9], "big"))


def _cli(*args, timeout=300) -> subprocess.CompletedProcess:
    """`python -m tpufusion_torch.cli <args>` in a subprocess from the repo root."""
    return subprocess.run([sys.executable, "-m", "tpufusion_torch.cli", *args], cwd=HERE,
                          capture_output=True, text=True, timeout=timeout)


def phase_viewer(dev, spec, card, totals, extracted):
    """Phase 24: the last modules of the port, run with none of cv2,
    matplotlib or yaml. (a) the single-frame entry points (range view,
    connected components, the three frame decodes) against their batch
    rows and the plain versions, a 64-row mask labelled equal to the plain
    sweeps in one CC launch; (b) view_dataset
    on a raw points npz with a checkpoint, the pushed frames captured;
    (c) the LiveViewer over HTTP; (d) the JPEG encoder against the viewer
    golden's bytes; (e) the host tools that need no cv2 and the CLI's diff
    and view in subprocesses, the subcommands that need a missing package
    raising ImportError; (f) both kernels against their plain versions on
    the phase's inputs. `extracted` is phase 22's in-RAM dataset dir."""
    import pkgutil
    import shutil
    import urllib.error
    import urllib.request

    from tpufusion_torch import cli
    from tpufusion_torch._golden import load_npz, viewer_golden_frames
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.data.etl import load_camera_extracted, load_extracted
    from tpufusion_torch.data.registry import load_pose_csv
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import (
        decode_batch,
        decode_batch_direct,
        decode_batch_multi,
        decode_frame,
        decode_frame_direct,
        decode_frame_multi,
        heat_mask,
    )
    from tpufusion_torch.geometry.camera import synthetic_camera
    from tpufusion_torch.geometry.range_view import range_view_project, range_view_project_batch
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.ops import components, parity_inputs
    from tpufusion_torch.ops.components import connected_components
    from tpufusion_torch.serve import viewer
    from tpufusion_torch.serve.jpeg import encode_jpeg
    from tpufusion_torch.tools import analyze, calibrate, crops, datadiff, invariant_mask
    from tpufusion_torch.tools.visualize import render_range_view
    from tpufusion_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    installed = {m.name for m in pkgutil.iter_modules()}
    log("phase 24 the viewer, the host tools and the single-frame entry points "
        f"(on this host: {', '.join(f'{p} {p in installed}' for p in ('cv2', 'matplotlib', 'yaml'))})")
    zbuffer_only = {"nearest_wins_image": 1, "connected_components_with_bbox": 0}
    cc_only = {"nearest_wins_image": 0, "connected_components_with_bbox": 1}

    # -- (a) the single-frame entry points ---------------------------------------------
    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(24), 1, N_POINTS)
    p0, v0 = torch.from_numpy(pts[0]).to(dev), torch.from_numpy(valid[0]).to(dev)
    with torch.inference_mode():
        img, counts = drive(f"(a) range_view_project, one {N_POINTS}-point frame",
                            lambda: range_view_project(p0, spec, v0), totals, expect=RANGE_VIEW)
        assert counts == zbuffer_only, counts
        row = range_view_project_batch(p0[None], spec, v0[None])[0]
        plain = range_view_project(torch.from_numpy(pts[0]), spec, torch.from_numpy(valid[0]))
    same = (torch.equal(img, row), torch.equal(img.cpu(), plain))
    log(f"    {tuple(img.shape)}: bit-equal to range_view_project_batch's row {same[0]}, to the "
        f"plain version of the frame on the CPU {same[1]}")
    assert all(same), "range_view_project differs from its batch row or the CPU"
    check_zbuffer("phase 24's single frame", p0[None], v0[None], spec)

    model, dcfg = asset_fcn(ASSET, "float32", dev)
    with torch.inference_mode():
        preds = model(img[None])
        frame_out, counts = drive("(a) decode_frame_direct, the shipped asset at its operating point",
                                  lambda: decode_frame_direct(preds[0], img, spec, dcfg), totals,
                                  expect=CC_ONLY + ("decode_direct",))
        assert counts == cc_only, counts
        batch_out = decode_batch_direct(preds, img[None], spec, dcfg)
        mask = heat_mask(preds[..., 1], dcfg)[0]
        labels, counts = drive("(a) connected_components, the asset's heat mask",
                               lambda: connected_components(mask), totals, expect=CC_ONLY)
        assert counts == cc_only, counts
        want_labels = components.connected_components_reference(mask.cpu(), SWEEP_CAP)
    same = [torch.equal(frame_out[k], batch_out[k][0]) for k in ("poses", "found")]
    log(f"    decode_frame_direct: found {frame_out['found'].tolist()}, pose "
        f"{[round(float(v), 3) for v in frame_out['poses'][0]]}; poses and found equal "
        f"decode_batch_direct's row {all(same)}; connected_components equal to the plain sweeps "
        f"{torch.equal(labels.cpu(), want_labels)} ({int(mask.sum())} heat pixels)")
    assert all(same) and bool(frame_out["found"][0]), "decode_frame_direct differs from its batch row"
    assert torch.equal(labels.cpu(), want_labels), "connected_components differs from the plain sweeps"
    check_cc("the asset's heat mask of phase 24's frame", mask[None])

    corner = FCN(DEFAULT.model, in_channels=3, seed=24).to(dev).eval()
    with torch.inference_mode():
        cpred = corner(img[None])
        one, counts = drive("(a) decode_frame, a seeded default-width corner FCN",
                            lambda: decode_frame(cpred[0], img, spec, DEFAULT.decode), totals,
                            expect=CC_ONLY + ("corner_vote",))
        assert counts == cc_only, counts
        multi, counts = drive("(a) decode_frame_multi(k=4), the same FCN",
                              lambda: decode_frame_multi(cpred[0], img, spec, DEFAULT.decode, 4),
                              totals, expect=CC_ONLY + ("corner_vote",))
        assert counts == cc_only, counts
        rows = decode_batch(cpred, img[None], spec, DEFAULT.decode)
        mrows = decode_batch_multi(cpred, img[None], spec, DEFAULT.decode, 4)
        cmask = heat_mask(cpred[..., 1], DEFAULT.decode)
    same = all(torch.equal(one[k], rows[k][0]) for k in rows) and all(
        torch.equal(multi[k], mrows[k][0]) for k in mrows)
    log(f"    decode_frame found {bool(one['found'])}, decode_frame_multi found "
        f"{multi['found'].tolist()}; every entry equal to the batch decodes' rows {same}")
    assert same and sorted(one) == sorted(rows) and multi["poses"].shape == (4, 7)
    check_cc("the corner FCN's heat mask", cmask)
    tall = torch.from_numpy(parity_inputs.cc_frames(height=64, width=100)["serpentine"]).to(dev)
    labels, counts = drive("(a) connected_components, a 64-row serpentine (2 row tiles)",
                           lambda: connected_components(tall), totals, expect=CC_ONLY)
    assert counts == cc_only, counts
    same = torch.equal(labels.cpu(), components.connected_components_reference(tall.cpu(), SWEEP_CAP))
    log(f"    the 64 x 100 mask's labels equal to the plain sweeps {same}")
    assert same, "connected_components differs from the plain sweeps on a 64-row mask"

    with tempfile.TemporaryDirectory(prefix="viewer_") as work:
        # -- (b) view_dataset on a raw points npz with a checkpoint ----------------------
        vpts, _, vvalid = synthesize_beam_scan_batch(np.random.default_rng(240), VIEW_FRAMES,
                                                     N_POINTS)
        vpts = np.where(vvalid[..., None], vpts, np.nan).astype(np.float32)
        raw = os.path.join(work, "raw.npz")
        np.savez(raw, points=vpts)
        ckpt = os.path.join(work, "ckpt")
        CheckpointManager(ckpt).save(0, FCN(DEFAULT.model, in_channels=3, seed=240))
        pushed, grabbed = [], {}
        orig_push, orig_stop = viewer.LiveViewer.push, viewer.LiveViewer.stop

        def push(self, name, frame):
            orig_push(self, name, frame)
            pushed.append((name, np.array(frame), time.perf_counter()))

        def stop(self):
            grabbed["viewer"] = self  # the windows' last JPEGs stay in _frames
            orig_stop(self)

        viewer.LiveViewer.push, viewer.LiveViewer.stop = push, stop
        try:
            t = time.perf_counter()
            _, counts = drive(f"(b) view_dataset(a raw points npz of {VIEW_FRAMES} x {N_POINTS}, "
                              "a .pt checkpoint of FCN(DEFAULT.model), port 0, rate_hz 1000)",
                              lambda: viewer.view_dataset(raw, ckpt, port=0, rate_hz=1000.0,
                                                          device=dev),
                              totals, expect=RANGE_VIEW)
            wall = time.perf_counter() - t
        finally:
            viewer.LiveViewer.push, viewer.LiveViewer.stop = orig_push, orig_stop
        assert counts == {"nearest_wins_image": VIEW_FRAMES, "connected_components_with_bbox": 0}, (
            "view_dataset: one z-buffer launch a frame")
        names = [n for n, _, _ in pushed]
        assert names == ["bev", "range_view", "class_mask"] * VIEW_FRAMES, names
        views = [f for n, f, _ in pushed if n == "range_view"]
        with torch.inference_mode():
            want = [render_range_view(range_view_project(torch.from_numpy(p), spec).numpy(), spec=spec)
                    for p in vpts]
        same = all(np.array_equal(g, w) for g, w in zip(views, want))
        firsts = [ts for n, _, ts in pushed if n == "bev"]
        steady = (VIEW_FRAMES - 1) / (firsts[-1] - firsts[0])
        log(f"    windows {sorted(set(names))}, each pushed once a frame; the pushed range views "
            f"equal render_range_view of the plain projection: {same}; {VIEW_FRAMES} frames in "
            f"{wall:.3f} s with the restore and the server's start, {steady:.3f} frames/s between "
            f"the first and the last frame (host clock, JPEG encoding included) [{card}]")
        assert same, "view_dataset's range view differs from the plain projection's render"
        check_zbuffer("view_dataset's frames", torch.from_numpy(vpts).to(dev), None, spec)

        # -- (c) the LiveViewer over HTTP ------------------------------------------------
        frames = {n: f for n, f, _ in pushed}
        with viewer.LiveViewer(port=0, host="127.0.0.1") as v:
            for name, frame in frames.items():
                v.push(name, frame)
            base = f"http://127.0.0.1:{v.port}"
            index = urllib.request.urlopen(f"{base}/", timeout=10).read().decode()
            sizes = {}
            for name, frame in frames.items():
                data = urllib.request.urlopen(f"{base}/frame/{name}", timeout=10).read()
                assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9", name
                sizes[name] = _sof0_size(data)
                assert sizes[name] == frame.shape[:2], (name, sizes[name], frame.shape)
                assert name in index, name
            r = urllib.request.urlopen(f"{base}/stream/range_view", timeout=10)
            head = r.read(200)
            r.close()
            assert b"--frame" in head and b"image/jpeg" in head
            try:
                urllib.request.urlopen(f"{base}/frame/nope", timeout=10)
                raise AssertionError("an unknown window answered")
            except urllib.error.HTTPError as e:
                assert e.code == 404, e.code
        log(f"  (c) LiveViewer on 127.0.0.1: / lists {sorted(frames)}; /frame/<w> JPEGs whose SOF0 "
            f"(height, width) are the pushed frames' {sizes}; /stream/range_view yields a --frame "
            "part; an unknown window 404s")

        # -- (d) the JPEG encoder against the golden's bytes ----------------------------
        golden = load_npz(GOLDEN_VIEWER)
        for i, frame in enumerate(viewer_golden_frames()):
            ours = encode_jpeg(frame)
            times = []
            for _ in range(JPEG_REPS):
                t = time.perf_counter()
                encode_jpeg(frame)
                times.append((time.perf_counter() - t) * 1e3)
            same = ours == golden[f"jpeg_{i}"].tobytes()
            log(f"  (d) encode_jpeg {frame.shape}: byte-equal to the golden's cv2 bytes {same} "
                f"({len(ours)} bytes); median {np.median(times):.3f} ms, min {min(times):.3f} ms "
                f"over {JPEG_REPS} encodes (host clock) [{card}]")
            assert same, f"encode_jpeg differs from the golden's bytes for {frame.shape}"
        for name, frame in frames.items():
            times = []
            for _ in range(JPEG_REPS):
                t = time.perf_counter()
                viewer._encode_jpeg(frame)
                times.append((time.perf_counter() - t) * 1e3)
            log(f"      the viewer's {name} render {frame.shape}: median {np.median(times):.3f} ms "
                f"an encode (host clock) [{card}]")
        if "cv2" in installed:  # this host's OpenCV, where it has one
            import cv2

            encoded = list(viewer_golden_frames()) + [f for f in frames.values()]
            same = [encode_jpeg(f) == bytes(cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 88])[1])
                    for f in encoded]
            log(f"      this host's cv2 {cv2.__version__}: its imencode bytes equal encode_jpeg's for "
                f"{sum(same)} of {len(same)} frames (the golden's and the viewer's renders)")

        # -- (e) the host tools that need no cv2, the CLI in subprocesses ----------------
        true = np.array([0.2, -0.1, 0.3, 0.4, -0.2, 0.1])
        crng = np.random.default_rng(241)
        cpts = np.stack([crng.uniform(-3, 3, 12), crng.uniform(-2, 2, 12), crng.uniform(4, 12, 12)], 1)
        truth = synthetic_camera()
        truth.set_extrinsic_from_euler(true[:3], true[3:])
        result = calibrate.calibrate(synthetic_camera(), cpts, truth.project_lidar_to_pixels(cpts),
                                     bounds=[(-1, 1)] * 6, accept_px=0.5, max_restarts=30, seed=1)
        log(f"  (e) calibrate on 12 correspondences of synthetic_camera(): {json.dumps(result)}")
        assert result["accepted"] and result["error_px"] < 0.5

        dropped = os.path.join(work, "dropped")
        shutil.copytree(extracted, dropped)
        with open(os.path.join(dropped, "lidar_timestamps.csv")) as f:
            ts_lines = f.read().splitlines()
        with open(os.path.join(dropped, "lidar_timestamps.csv"), "w") as f:
            f.write("\n".join(ts_lines[:-1]) + "\n")
        n_ts = len(ts_lines) - 1  # the header
        same_diff = datadiff.diff_dirs(extracted, extracted, DIFF_REL_TOL)
        drop_diff = datadiff.diff_dirs(extracted, dropped, DIFF_REL_TOL)
        log(f"      datadiff (rel_tol {DIFF_REL_TOL}): phase 22's dir against itself {same_diff}, "
            f"against a copy with one of its {n_ts} lidar timestamps dropped {drop_diff}")
        assert same_diff == [] and ("lidar", "count", n_ts, n_ts - 1) in drop_diff

        images = load_extracted(extracted)["images"]
        mask = invariant_mask.build_invariant_mask(images)
        assert mask.shape == images.shape[1:] and np.array_equal(
            mask, (images == images[0]).all(axis=0))
        rows = load_pose_csv(os.path.join(extracted, "obs_poses_interp_transform.csv"))
        centers = np.asarray([[r["tx"], r["ty"]] for r in rows])
        hist, _, _ = analyze.polar_histogram(centers)
        cam = synthetic_camera()
        cframes = load_camera_extracted(extracted)["images"]
        box = crops.box_from_pose([15.0, 1.0, -0.7, 0.0, 4.2, 1.6, 1.5], cam, crop_top=430)
        crop = crops.crop_box(cframes[0], box)
        log(f"      build_invariant_mask over {len(images)} range views: {int(mask.sum())} invariant "
            f"values; polar_histogram of {len(rows)} GT centers: {int(hist.sum())} binned; "
            f"box_from_pose {tuple(round(float(v), 2) for v in box)} -> crop_box "
            f"{None if crop is None else crop.shape} of a {cframes.shape[1:]} camera frame")
        assert hist.sum() == np.sum(np.hypot(centers[:, 0], centers[:, 1]) <= 60.0)
        assert crop is not None and crop.size > 0

        codes = [_cli("diff", extracted, extracted, "--rel_tol", str(DIFF_REL_TOL)).returncode,
                 _cli("diff", extracted, dropped, "--rel_tol", str(DIFF_REL_TOL)).returncode]
        log(f"      python -m tpufusion_torch.cli diff: exit {codes[0]} (same dir), {codes[1]} "
            "(a timestamp dropped)")
        assert codes == [0, 1], codes
        t = time.perf_counter()
        proc = _cli("view", raw, "--checkpoint", ckpt, "--device", str(dev), "--port", "0",
                    "--rate", "1000")
        log(f"      python -m tpufusion_torch.cli view <raw npz> --checkpoint --device {dev} "
            f"--port 0 --rate 1000: exit {proc.returncode} in {time.perf_counter() - t:.3f} s "
            f"(host clock); {proc.stdout.strip()}")
        assert proc.returncode == 0, proc.stderr[-2000:]

        needs = {"edges": ("cv2", ["edges", raw, os.path.join(work, "e.png")]),
                 "overlay_radar": ("cv2", ["overlay_radar", os.path.join(extracted, "camera_frames.npz"),
                                           os.path.join(extracted, "radar", "radar_tracks.csv"),
                                           os.path.join(work, "ov")]),
                 "crops": ("cv2", ["crops", os.path.join(extracted, "camera_frames.npz"),
                                   os.path.join(extracted, "obs_poses_camera.csv"),
                                   os.path.join(work, "cr")]),
                 "analyze": ("matplotlib", ["analyze", os.path.join(extracted,
                                                                    "obs_poses_interp_transform.csv"),
                                            "--output", os.path.join(work, "gt.png")]),
                 "calibrate": ("yaml", ["calibrate", os.path.join(work, "s.json"),
                                        os.path.join(work, "cam.yaml")])}
        with open(os.path.join(work, "s.json"), "w") as f:
            json.dump({"points": cpts.tolist(), "uvs": cpts[:, :2].tolist()}, f)
        with open(os.path.join(work, "cam.yaml"), "w") as f:
            f.write("image_width: 1368\n")
        for sub, (package, argv) in needs.items():
            if package in installed:
                log(f"      cli {sub}: {package} is installed here; the ImportError is not checked")
                continue
            try:
                cli.main(argv)
                raise AssertionError(f"cli {sub} ran without {package}")
            except ImportError as e:
                assert package in str(e), (sub, str(e))
                log(f"      cli {sub} without {package}: ImportError({str(e)!r})")
    log(f"  phase 24 took {time.perf_counter() - t_phase:.3f} s (host clock) [{card}]")


def phase_tall(dev, card, totals, p5) -> dict:
    """Phase 25: a 64-beam sensor's 63 x 1801 range view
    (`RangeViewSpec(res_v_deg=0.665)`) through the entry points. (a) the
    shipped asset's float32 direct step at BATCH x N_POINTS against the
    port on the CPU and the tall JAX golden, its found rate and xy error,
    its times beside phase 5's 32-row ones (`p5`); (b) config 5's bf16
    top-4 step at C5_BATCH x C5_POINTS (64 beams) against the CPU; (c) the
    kernels at 63 rows in turns with their plain versions and the
    z-buffer's library yardstick, and the CC alone on the heat masks with
    their rows doubled (64 x 128 x 1801), each beside its bound. Both kernels are held
    bit-identical to plain on the phase's range views and heat masks.
    Returns (c)'s {"cc 63" | "cc 128" | "z 63": (device ms, bound ms)}."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG, load_npz, wrapped_pose_diff
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import decode_batch_direct, heat_mask
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys, range_view_project_batch
    from tpufusion_torch.ops import cc, components
    from tpufusion_torch.predict import make_e2e_step

    t_phase = time.perf_counter()
    spec = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
    assert (spec.height, spec.width) == (63, 1801), (spec.height, spec.width)
    log(f"phase 25 a {TALL_BEAMS}-beam sensor's {spec.height} x {spec.width} range view "
        f"(res_v_deg {TALL_RES_V_DEG}): 2 row tiles of the CC kernel, the 32-row phases' "
        "entry points")

    # -- (a) the direct path ---------------------------------------------------------------
    model, dcfg = asset_fcn(ASSET, "float32", dev)
    cpu_model, _ = asset_fcn(ASSET, "float32", "cpu")
    step = make_e2e_step(model, spec, dcfg, head="direct", device=dev)
    pts, gt, valid = synthesize_beam_scan_batch(
        np.random.default_rng(2500), BATCH, N_POINTS, n_beams=TALL_BEAMS)
    tp, tv = torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)
    check_both(f"{BATCH} x {N_POINTS} {TALL_BEAMS}-beam scans at 63 rows", model, dcfg, tp, tv, spec)
    (poses, found), _ = drive(f"(a) make_e2e_step(head='direct') at 63 x 1801, {BATCH} x "
                              f"{N_POINTS} points", lambda: step(pts, valid), totals,
                              expect=DIRECT)
    poses, found = poses.cpu().numpy(), found.cpu().numpy()
    assert poses.shape == (BATCH, 7) and found.shape == (BATCH,) and np.isfinite(poses).all()
    cpu_poses, cpu_found = make_e2e_step(cpu_model, spec, dcfg, head="direct", device="cpu")(pts, valid)
    diff = float(wrapped_pose_diff(poses, cpu_poses.numpy()).max())
    log(f"    against the port on the CPU: found equal {np.array_equal(found, cpu_found.numpy())}, "
        f"largest pose difference {diff:.3e} (tolerance {POSE_TOL:.3e})")
    assert np.array_equal(found, cpu_found.numpy()), "63 rows: found differs from the CPU"
    assert diff < POSE_TOL, "63 rows: poses differ from the CPU"
    xy = np.linalg.norm(poses[:, :2] - gt["center"][:, :2], axis=1)[found]
    log(f"    batch: found {int(found.sum())}/{BATCH}, xy error median {np.median(xy):.3f} m, "
        f"max {xy.max():.3f} m")
    assert found.mean() >= 0.9 and np.median(xy) < 1.0, "63 rows: the detector misses"
    g = load_npz(GOLDEN_TALL)
    gp, gf = step(g["points"], g["valid"])
    check_poses(f"JAX tall golden ({len(g['found'])} frames)", gp, gf, g["poses"], g["found"])
    check_both("the tall golden's frames", model, dcfg, torch.from_numpy(g["points"]).to(dev),
               torch.from_numpy(g["valid"]).to(dev), spec)

    batches = []
    for i in range(TALL_TIMED):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(2600 + i), BATCH, N_POINTS,
                                             n_beams=TALL_BEAMS)
        batches.append((torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)))
    torch.cuda.reset_peak_memory_stats()
    e2e_ms = time_ms(lambda pv: step(*pv), batches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    with torch.inference_mode():
        images = [range_view_project_batch(p, spec, v) for p, v in batches]
        preds = [model(im) for im in images]
        masks = [heat_mask(pr[..., 1], dcfg) for pr in preds]
        zargs = [_frame_pixels_keys(p, spec, v) for p, v in batches]
        proj_ms = time_ms(lambda pv: range_view_project_batch(pv[0], spec, pv[1]), batches)
        fcn_ms = time_ms(model, images)
        dec_ms = time_ms(lambda ip: decode_batch_direct(ip[1], ip[0], spec, dcfg),
                         list(zip(images, preds)))
        cc_call = time_ms(lambda m: cc.connected_components_with_bbox(m, dcfg.max_cc_iters), masks)
    where = f"[{card}]"
    log(f"  (a) times, CUDA events, mean over {TALL_TIMED} distinct batches of "
        f"{BATCH} x {N_POINTS} after warm-up {where}")
    log(f"    e2e at 63 x 1801: {e2e_ms:.3f} ms/batch = {BATCH * 1e3 / e2e_ms:.1f} frames/s, "
        f"peak device memory {peak_mb:.0f} MiB; at 32 x 1801 (phase 5): {p5['e2e']:.3f} ms, "
        f"{p5['peak_mb']:.0f} MiB {where}")
    log(f"    stages at 63 rows: projection {proj_ms:.3f} ms, FCN {fcn_ms:.3f} ms, decode "
        f"{dec_ms:.3f} ms, CC {cc_call:.4f} ms a call; at 32 rows: {p5['proj']:.3f}, "
        f"{p5['fcn']:.3f}, {p5['dec']:.3f}, {p5['cc_call']:.4f} {where}")

    # -- (b) the top-K path ----------------------------------------------------------------
    bf16, _ = asset_fcn(ASSET, "bfloat16", dev)
    cpu_bf16, _ = asset_fcn(ASSET, "bfloat16", "cpu")
    kstep = make_e2e_step(bf16, spec, dcfg, max_obstacles=4, head="direct", device=dev)
    kpts, _, kvalid = synthesize_beam_scan_batch(
        np.random.default_rng(2501), C5_BATCH, C5_POINTS, n_beams=TALL_BEAMS)
    check_both(f"config 5's {C5_BATCH} x {C5_POINTS} points at 63 rows (bf16 FCN)", bf16, dcfg,
               torch.from_numpy(kpts).to(dev), torch.from_numpy(kvalid).to(dev), spec)
    (kposes, kfound), _ = drive(f"(b) config 5's bf16 top-4 step at 63 x 1801, {C5_BATCH} x "
                                f"{C5_POINTS} points", lambda: kstep(kpts, kvalid), totals,
                                expect=DIRECT)
    cpu_kposes, cpu_kfound = make_e2e_step(cpu_bf16, spec, dcfg, max_obstacles=4,
                                           head="direct", device="cpu")(kpts, kvalid)
    kfound, cpu_kfound = kfound.cpu().numpy(), cpu_kfound.numpy()
    kdiff = float(wrapped_pose_diff(kposes, cpu_kposes.numpy())[kfound].max()) if kfound.any() else 0.0
    log(f"    detections per frame {kfound.sum(axis=1).tolist()}; against the port on the CPU: "
        f"found equal {np.array_equal(kfound, cpu_kfound)}, largest pose difference "
        f"{kdiff:.3e} (tolerance {POSE_TOL:.3e})")
    assert kposes.shape == (C5_BATCH, 4, 7) and kfound[:, 0].mean() >= 0.75, "top-4 misses"
    assert np.array_equal(kfound, cpu_kfound), "63 rows, top-4: found differs from the CPU"
    assert kdiff < POSE_TOL, "63 rows, top-4: poses differ from the CPU"

    # -- (c) the kernels alone -------------------------------------------------------------
    # 128 rows: the heat masks with every row twice and two empty rows, as a
    # 128-beam sensor's blobs would span rows
    masks128 = [torch.cat([m.repeat_interleave(2, dim=1), m.new_zeros((BATCH, 2, spec.width))], 1)
                for m in masks]
    check_cc("the 63-row heat masks with their rows doubled (128 rows)", masks128[0])
    with torch.inference_mode():
        kt = kernel_turns(spec, zargs, masks, dcfg)
        t128 = queued_ms(cc.connected_components_with_bbox, masks128)
        plain128 = time_ms(
            lambda m: components.connected_components_with_bbox(m, dcfg.max_cc_iters), masks128)
    bound128 = float(np.mean([cc_bound_ms(m) for m in masks128]))
    log(f"  (c) {BATCH} x {N_POINTS} points into 63 x 1801 and their heat masks, "
        f"{TALL_TIMED} batches: {turns_line(kt)} {where}")
    log(f"    CC at {BATCH} x 128 x 1801 (the heat masks with their rows doubled): kernel "
        f"{t128:.4f} ms device time, plain ({plain128:.4f}: a call, a readback a sweep) ms, "
        f"bound {bound128:.4f} ms, kernel at {bound128 / t128:.1%} of it; the kernel at 128 "
        f"rows {t128 / kt['cc']['kernel']:.2f}x its 63-row time {where}")
    log(f"  phase 25 took {time.perf_counter() - t_phase:.3f} s (host clock) [{card}]")
    return {"z 63": (kt["z"]["kernel"], kt["z"]["bound"]),
            "cc 63": (kt["cc"]["kernel"], kt["cc"]["bound"]), "cc 128": (t128, bound128)}


def phase_headline(dev, spec, card, totals) -> dict:
    """Phase 26: the repo's headline, `tpufusion_torch/bench.py` and
    `tpufusion_torch/entry.py`. (a) `bench.run` at its defaults (BATCH x
    N_POINTS, 24 sets) under `drive`, every row finite and positive, and
    the headline step's split on its first batches, both kernels
    bit-identical to plain on its first batch (the flagship's and the live
    asset's heat masks); (b) the flagship step with the bench golden's
    weights against JAX's poses and found on its 4 frames in bf16 and
    float32, the card's range views of them within BENCH_VIEW_MOVED_MAX
    pixels of JAX's and the FCN's sampled probability on JAX's; (c)
    `entry()`'s fn with the golden's entry state against JAX's answer on
    its example, at most ENTRY_VIEW_MOVED_MAX pixels of a frame's range
    view unlike JAX's and the poses held on the (at least
    ENTRY_POSE_FRAMES_MIN) frames with none; both kernels on (b)'s and
    (c)'s frames; (d) `python -m tpufusion_torch.bench --sets 2` in a
    subprocess. Returns (a)'s row, with the packed row's frames/s (its
    stderr line) as "packed_fps"."""
    from tpufusion_torch import bench, entry
    from tpufusion_torch._golden import (
        BENCH_VIEW_MOVED_MAX,
        BF16_FLAGSHIP_DIFFER_SHARE,
        BF16_PROB_ATOL,
        ENTRY_POSE_FRAMES_MIN,
        ENTRY_VIEW_MOVED_MAX,
        FCN_PROB_ATOL,
        flagship_prob_sample,
        load_npz,
        wrapped_pose_diff,
    )
    from tpufusion_torch.benchmarks import asset_model, detector_asset_path, point_sets, seeded_fcn
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.decode.decode import decode_batch_direct
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.models.io import fcn_from_arrays, load_arrays
    from tpufusion_torch.predict import make_e2e_step

    t_phase = time.perf_counter()
    dcfg = DEFAULT.decode
    log(f"phase 26 the headline: tpufusion_torch.bench (bf16 flagship, seed 0, at "
        f"min_prob {dcfg.min_prob} / min_bbox_area {dcfg.min_bbox_area}) and entry()")

    # -- (a) bench.run at its defaults -----------------------------------------------------
    err = io.StringIO()  # bench.run's rows on stderr, the packed row's only record
    try:
        with contextlib.redirect_stderr(err):
            row, _ = drive(f"(a) bench.run: {bench.N_SETS} sets of {bench.BATCH} x {bench.N_POINTS} "
                           "points, headline + live + corner + packed + p50", lambda: bench.run(dev),
                           totals, expect=DIRECT + ("nearest_wins_packed_image", "corner_vote"))
    finally:
        for line in err.getvalue().splitlines():
            log(f"    bench.run: {line}")
    packed = [ln for ln in err.getvalue().splitlines() if ln.startswith("packed-projection mode: ")]
    assert len(packed) == 1, "bench.run logged no packed row"
    row["packed_fps"] = float(packed[0].split()[2])  # "packed-projection mode: <fps> frames/s ..."
    for k in ("value", "p50_latency_ms", "fps_with_live_detections", "fps_corner_parity_decode",
              "device_ms", "busy", "peak_device_mib"):
        assert np.isfinite(row[k]) and row[k] > 0, f"bench row {k} = {row[k]}"
    where = f"[{card}]"
    log(f"    headline {row['value']} frames/s ({bench.BATCH * 1e3 / row['value']:.3f} ms a batch), "
        f"device {row['device_ms']} ms a call, busy {row['busy']}, peak {row['peak_device_mib']} "
        f"MiB; live {row['fps_with_live_detections']}, corner {row['fps_corner_parity_decode']} "
        f"frames/s; p50 {row['p50_latency_ms']} ms {where}")
    model = seeded_fcn(dataclasses.replace(DEFAULT.model, **entry.FLAGSHIP), 0, dev)
    sets = point_sets(HEADLINE_SPLIT, BATCH, N_POINTS, dev)  # the headline's first batches
    check_both("the headline's first batch, the bf16 flagship's heat", model, dcfg, *sets[0], spec)
    amodel, adcfg, _ = asset_model(detector_asset_path())  # the live row's net, as bench.run builds it
    check_both("the headline's first batch, the live asset's heat", amodel.to(dev).eval(), adcfg,
               *sets[0], spec)
    share, near = bench.heat_readings(model, *sets[0], dcfg, spec)
    with torch.inference_mode():
        images = [range_view_project_batch(p, spec, v) for p, v in sets]
        preds = [model(im) for im in images]
        proj_ms = time_ms(lambda pv: range_view_project_batch(pv[0], spec, pv[1]), sets)
        fcn_ms = time_ms(model, images)
        dec_ms = time_ms(lambda ip: decode_batch_direct(ip[1], ip[0], spec, dcfg),
                         list(zip(images, preds)))
    log(f"    split on {len(sets)} of its batches: projection {proj_ms:.3f} ms, bf16 FCN "
        f"{fcn_ms:.3f} ms, direct decode {dec_ms:.3f} ms; first batch: heat pixels "
        f"{share:.4%}, probabilities within 1e-4 of min_prob {near} {where}")

    # -- (b) the flagship against the JAX golden -------------------------------------------
    g = load_npz(GOLDEN_BENCH)
    arrays = {k.split("/", 1)[1]: v for k, v in g.items() if k.startswith("flagship/")}
    pts, valid = torch.from_numpy(g["points"]).to(dev), torch.from_numpy(g["valid"]).to(dev)
    # the FCN is held on JAX's range views: the CPU's, eager JAX's bit for bit
    with torch.inference_mode():
        cpu_images = range_view_project_batch(torch.from_numpy(g["points"]), spec,
                                              torch.from_numpy(g["valid"]))
        moved = int((range_view_project_batch(pts, spec, valid).cpu() != cpu_images).any(-1).sum())
    images = cpu_images.to(dev)
    log(f"  (b) the card's range views of the bench golden's frames: {moved} pixels unlike the "
        f"CPU's (at most {BENCH_VIEW_MOVED_MAX})")
    assert moved <= BENCH_VIEW_MOVED_MAX, "the card's range views of the bench golden differ from JAX's"
    for tag, dtype, prob_atol, differ in (("bf16", "bfloat16", BF16_PROB_ATOL, BF16_FLAGSHIP_DIFFER_SHARE),
                                          ("f32", "float32", FCN_PROB_ATOL, 1.0)):
        fmodel = fcn_from_arrays(arrays, dataclasses.replace(DEFAULT.model, dtype=dtype, **entry.FLAGSHIP),
                                 device=dev)
        step = make_e2e_step(fmodel, spec, dcfg, head="direct", device=dev)
        (poses, found), _ = drive(f"(b) the flagship step in {dtype} on the bench golden's "
                                  f"{len(g['points'])} frames", lambda: step(pts, valid), totals,
                                  expect=DIRECT)
        check_poses(f"JAX bench golden, {dtype}", poses, found, g[f"flagship_{tag}_poses"],
                    g[f"flagship_{tag}_found"])
        with torch.inference_mode():
            out = fmodel(images).cpu().numpy()
        prob, prob_max = flagship_prob_sample(out)
        d = np.abs(prob - g[f"flagship_{tag}_prob"])
        dm = float(np.abs(prob_max - g[f"flagship_{tag}_prob_max"]).max())
        share, near = bench.heat_readings(fmodel, pts, valid, dcfg, spec)
        log(f"    FCN's sampled foreground probability vs JAX's: {d.max():.3e}, {(d > 1e-6).mean():.2%} "
            f"of {d.size} differ (at most {differ:.0%}); largest a frame "
            f"{prob_max.round(4).tolist()} vs {g[f'flagship_{tag}_prob_max'].round(4).tolist()} "
            f"(tolerance {prob_atol:.3e}); heat pixels {share:.4%}, within 1e-4 of min_prob {near}")
        assert max(float(d.max()), dm) <= prob_atol, f"the {dtype} flagship FCN differs from JAX's"
        assert (d > 1e-6).mean() <= differ, f"the {dtype} flagship FCN rounds unlike JAX's"
        check_both(f"the bench golden's frames, {dtype} flagship", fmodel, dcfg, pts, valid, spec)

    # -- (c) entry() against JAX's entry() -------------------------------------------------
    fn, (emodel, _) = entry.entry(dev)
    load_arrays(emodel, {k.split("/", 1)[1]: v for k, v in g.items() if k.startswith("entry/")})
    epts = torch.from_numpy(g["entry_points"]).to(dev)
    (ep, ef), _ = drive(f"(c) entry()'s fn with JAX's entry state on its example "
                        f"({epts.shape[0]} x {epts.shape[1]} points, no validity mask)",
                        lambda: fn(emodel, epts), totals, expect=DIRECT)
    share, near = bench.heat_readings(emodel, epts, None, dcfg, spec)
    # the card's FCN and decode on JAX's range views (the CPU's), and the
    # frames whose range view on the card is JAX's
    with torch.inference_mode():
        cpu_views = range_view_project_batch(torch.from_numpy(g["entry_points"]), spec)
        moved = (range_view_project_batch(epts, spec).cpu() != cpu_views).any(-1).sum(dim=(1, 2))
        jviews = cpu_views.to(dev)
        jout = decode_batch_direct(emodel(jviews), jviews, spec, dcfg, 1)
    frame_diff = wrapped_pose_diff(ep, g["entry_poses"]).max(axis=1)
    log(f"    heat pixels {share:.4%}, probabilities within 1e-4 of min_prob {near}; the card's "
        f"range views: pixels unlike the CPU's a frame {moved.tolist()} (at most "
        f"{ENTRY_VIEW_MOVED_MAX}); found "
        f"{ef.cpu().numpy().astype(int).tolist()} (JAX {g['entry_found'].astype(int).tolist()}), "
        f"pose difference a frame {[f'{d:.3e}' for d in frame_diff]}; poses "
        f"{ep.cpu().numpy().round(5).tolist()}")
    check_poses("JAX entry() on JAX's range views (the card's FCN and decode)",
                jout["poses"][:, 0], jout["found"][:, 0], g["entry_poses"], g["entry_found"])
    assert np.array_equal(ef.cpu().numpy(), g["entry_found"]), "entry(): found differs from JAX"
    assert int(moved.max()) <= ENTRY_VIEW_MOVED_MAX, "entry(): the card's range views differ from JAX's"
    held = moved.numpy() == 0
    assert held.sum() >= ENTRY_POSE_FRAMES_MIN, f"entry(): poses held on {held.sum()} frames only"
    assert (frame_diff[held] < POSE_TOL).all(), "entry(): poses differ from JAX"
    check_both("entry()'s example", emodel, dcfg, epts, None, spec)

    # -- (d) the module's command line -----------------------------------------------------
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "tpufusion_torch.bench", "--sets", "2"], cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"python -m tpufusion_torch.bench failed: {out.stderr[-2000:]}"
    sub = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"  (d) python -m tpufusion_torch.bench --sets 2: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s, {sub['value']} frames/s, metric {sub['metric']!r}")
    assert "vs_baseline" not in sub and sub["device"] == card
    log(f"  phase 26 took {time.perf_counter() - t_phase:.3f} s (host clock) [{card}]")
    return row


def check_packed(label: str, args, spec) -> float:
    """Holds the packed z-buffer kernel against its plain version on the
    same (pix, key_bits, valid, payload) on the card: bit-identical, one
    launch. Logs the pixels where the packed rule leaves the exact one.
    Returns the largest difference (0)."""
    from tpufusion_torch.ops import projection

    b, n = args[0].shape
    with torch.inference_mode():
        before = projection.PACKED_LAUNCHES
        got = projection.nearest_wins_packed_image(*args, spec)
        want = projection.nearest_wins_packed_image_reference(*args, spec)
        exact = projection.nearest_wins_image_reference(*args, spec)
        torch.cuda.synchronize()
    assert projection.PACKED_LAUNCHES == before + 1, "packed z-buffer kernel not launched"
    same = _same_bits(got, want)
    moved = int((want != exact).any(-1).sum())
    log(f"  packed z-buffer on {label} ({b} x {n}, idx_bits {max((n - 1).bit_length(), 1)}, "
        f"{spec.height} x {spec.width}): bit-identical to plain = {same}; pixels off the exact "
        f"rule {moved}")
    assert same, f"packed z-buffer kernel differs from its plain version ({label})"
    return float((got - want).abs().max())


def packed_turns(spec, zargs) -> dict:
    """The packed kernel, the exact kernel, the library yardstick
    (`scatter_reduce_` of the int32 packs into a filled grid + the gather)
    and the packed plain version in turns on distinct inputs, as device
    time (`queued_ms`) and as time a call (`time_ms`), beside the bound
    (the z-buffer's bytes at 3.35 TB/s): ms, "<fn>_call" for a call's."""
    from tpufusion_torch.ops import projection

    yard = [packed_amin_yardstick(*a, spec) for a in zargs]
    fns = {
        "kernel": lambda i: projection.nearest_wins_packed_image(*zargs[i], spec),
        "exact": lambda i: projection.nearest_wins_image(*zargs[i], spec),
        "library": lambda i: yard[i](),
        "plain": lambda i: projection.nearest_wins_packed_image_reference(*zargs[i], spec),
    }
    idx = list(range(len(zargs)))
    with torch.inference_mode():
        t = time_turns(fns, idx, queued_ms)
        t.update({f"{k}_call": v for k, v in time_turns(fns, idx).items()})
    p = spec.height * spec.width
    t["bound"] = float(np.mean([zbuffer_bound_ms(*a[:3], p) for a in zargs]))
    assert all(v > 0 for v in t.values()), f"a time not measured: {t}"
    return t


def phase_packed(dev, spec, card, totals, headline: dict) -> dict:
    """Phase 27: the reference's other projection methods. (a) the packed
    z-buffer kernel against its plain version on the bench golden's beam
    scans, both near-tie sets, NaN / inf clouds with padding at 32,768 and
    32,769 points, `parity_inputs.PACKED_SHAPES`, the adversarial
    inputs into 63 x 1801 and `PACKED_EDGE_SETS` (the slice edges of the
    grid in the cluster's shared memory, every pixel occupied, the ragged
    last slice at 63 rows, 690 rows in two bands); (b) every method's range views of the near-tie
    sets on the card against the packed golden's sha256 (JAX's), the
    pixels "packed" moves off "exact" as JAX's, "pallas", "scatter" and
    "sort16" equal to "exact", "sort16" refusing 33,792 points as JAX
    does; (c) the asset's step, `LidarPipeline` and `ReplayHarness` with
    the packed projection on the near-tie frames under `drive`, against
    the CPU and the golden; (d) `packed_turns` at 64 x 32,768 and 16 x
    131,072 into 32 x 1801 and at 64 x 32,768 of 64 beams into 63 x 1801,
    the A/B tool under `drive`, and phase 26's packed row.
    Returns the kernels line's numbers."""
    from tpufusion_torch import RangeViewSpec
    from tpufusion_torch._golden import (
        TALL_RES_V_DEG,
        frames_digest,
        load_npz,
        near_tie_sets,
        wrapped_pose_diff,
    )
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys, range_view_project_batch
    from tpufusion_torch.models.io import asset_configs
    from tpufusion_torch.ops import parity_inputs, projection
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.serve.pipeline import LidarPipeline
    from tpufusion_torch.serve.replay import ReplayHarness
    from tpufusion_torch.tools import bench_projection_ab

    t_phase = time.perf_counter()
    log("phase 27 the reference's projection methods: the packed z-buffer kernel "
        "(csrc/nearest_wins_packed.cu), scatter and sort16 on the exact one, the A/B tool")
    g, bench = load_npz(GOLDEN_PACKED), load_npz(GOLDEN_BENCH)
    sets = near_tie_sets(bench["points"], bench["valid"])

    def pixel_args(points, valid, s=spec):
        with torch.inference_mode():
            return _frame_pixels_keys(torch.from_numpy(points).to(dev), s,
                                      torch.from_numpy(valid).to(dev))

    # -- (a) the packed kernel against its plain version ------------------------------------
    err = 0.0
    clouds = [("the bench golden's beam scans", bench["points"], bench["valid"])]
    clouds += [(f"the near-tie frames{' (short set)' if k else ''}", *pv) for k, pv in sets.items()]
    clouds += [(f"NaN / inf clouds with padding, N = {n}", *parity_inputs.nan_clouds(2, n))
               for n in (32768, 32769)]
    for label, points, valid in clouds:
        err = max(err, check_packed(label, pixel_args(points, valid), spec))
    tall = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
    shapes = [(b, n, k, spec) for b, n, k in parity_inputs.PACKED_SHAPES]
    shapes.append((BATCH, N_POINTS, parity_inputs.PACKED_KINDS, tall))
    # the grid in the cluster's shared memory: slice edges, every pixel, the
    # ragged last slice at 63 rows, 690 rows past one cluster's memory (bands)
    shapes += [(b, n, k, RangeViewSpec(res_v_deg=r)) for b, n, k, r in parity_inputs.PACKED_EDGE_SETS]
    for b, n, kinds, s in shapes:
        args = [torch.from_numpy(a).to(dev) for a in parity_inputs.zbuffer_args(
            b, n, s.height * s.width, kinds=kinds)]
        err = max(err, check_packed(f"adversarial ({', '.join(kinds)})", args, s))

    # -- (b) every method's range views against the golden ----------------------------------
    methods = ("exact", "pallas", "scatter", "sort16", "packed")
    for k, (points, valid) in sets.items():
        assert frames_digest(points, valid) == str(g[f"{k}frames_sha256"]), "near-tie frames moved"
        pts, ok = torch.from_numpy(points).to(dev), torch.from_numpy(valid).to(dev)
        images = {}
        for m in methods:
            if f"{k}{m}_sha256" not in g:  # sort16 past 2**15 points: the reference asserts
                refused = ""
                try:
                    range_view_project_batch(pts, spec, ok, m)
                except AssertionError as e:
                    refused = str(e)
                assert m == "sort16" and bool(g["sort16_refused"]) and refused, f"{m} ran"
                log(f"  (b) {m} on {points.shape[1]} points a frame: refused, as the reference "
                    f"({refused})")
                continue
            with torch.inference_mode():
                images[m] = range_view_project_batch(pts, spec, ok, m).cpu().numpy()
            same = sum(hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() == h
                       for im, h in zip(images[m], g[f"{k}{m}_sha256"]))
            log(f"  (b) {m} on {points.shape[1]} points a frame: images with JAX's sha256 "
                f"{same}/{len(points)}")
            assert same == len(points), f"{m}: the card's range views are not JAX's"
        moved = (images["packed"] != images["exact"]).any(-1).sum((1, 2))
        log(f"  (b) pixels where packed leaves exact: {moved.tolist()} (JAX "
            f"{g[f'{k}packed_exact_pixels'].tolist()})")
        assert moved.tolist() == g[f"{k}packed_exact_pixels"].tolist() and moved.min() > 0
        for m in ("pallas", "scatter", "sort16"):
            if m in images:
                assert _same_bits(torch.from_numpy(images[m]), torch.from_numpy(images["exact"])), m

    # -- (c) the paths, against the CPU and the golden --------------------------------------
    mcfg, dcfg = asset_configs(ASSET)
    cfg = DEFAULT.replace(model=mcfg, decode=dcfg, projection_method="packed")
    model, _ = asset_fcn(ASSET, "float32", dev)
    cpu_model, _ = asset_fcn(ASSET, "float32", "cpu")
    points, valid = sets[""]
    n = points.shape[1]
    want_poses, want_found = g["packed_step_poses"], g["packed_step_found"]

    def held(label, poses, found, cpu_poses, cpu_found):
        poses, found = np.asarray(poses), np.asarray(found)
        cpu_diff = float(wrapped_pose_diff(poses, np.asarray(cpu_poses)).max())
        log(f"    against the CPU: found equal {np.array_equal(found, cpu_found)}, largest pose "
            f"difference {cpu_diff:.3e}")
        assert np.array_equal(found, cpu_found) and cpu_diff < POSE_TOL, f"{label}: not the CPU's"
        check_poses(f"{label} against the packed golden", torch.from_numpy(poses),
                    torch.from_numpy(found), want_poses, want_found)

    step = make_e2e_step(model, spec, dcfg, "packed", head="direct", device=dev)
    (poses, found), _ = drive(f"(c) the asset's make_e2e_step(method='packed') on the near-tie "
                              f"frames ({len(points)} x {n})", lambda: step(points, valid), totals,
                              expect=PACKED + ("decode_direct",))
    cpu = make_e2e_step(cpu_model, spec, dcfg, "packed", head="direct", device="cpu")(points, valid)
    held("make_e2e_step(method='packed')", poses.cpu(), found.cpu(), *cpu)

    requests = [f[v] for f, v in zip(points, valid)]
    pipe = LidarPipeline(cfg=cfg, model=model, max_points=n, device=dev)
    answers, _ = drive(f"(c) LidarPipeline(projection_method='packed', max_points {n}), "
                       f"{len(requests)} requests", lambda: [pipe.predict_position(r) for r in requests],
                       totals, expect=PACKED + ("decode_direct",))
    cpu_pipe = LidarPipeline(cfg=cfg, model=cpu_model, max_points=n, device="cpu")
    cpu_answers = [cpu_pipe.predict_position(r) for r in requests]
    held("LidarPipeline", np.stack([a[0] for a in answers]), np.array([a[1] for a in answers]),
         np.stack([a[0] for a in cpu_answers]), np.array([a[1] for a in cpu_answers]))

    stored = np.where(valid[..., None], points, np.float32(np.nan))  # unmasked clouds: NaN is invalid
    harness = ReplayHarness(cfg, model, chunk=2, host_ring=2, device=dev)
    (rposes, rfound, _), _ = drive(f"(c) ReplayHarness(projection_method='packed', chunk 2, a "
                                   f"pinned ring of 2), {len(stored)} frames",
                                   lambda: harness.run(stored), totals,
                                   expect=PACKED + ("decode_direct",))
    cpu_r = ReplayHarness(cfg, cpu_model, chunk=2, device="cpu").run(stored)
    held("ReplayHarness", rposes, rfound, cpu_r[0], cpu_r[1])

    # -- (d) times: the kernels in turns, the A/B tool, the bench's row ---------------------
    where = f"[{card}]"
    times = {}
    timed = (("64", (BATCH, N_POINTS, 32, spec)), ("16", (C5_BATCH, C5_POINTS, C5_BEAMS, spec)),
             ("63", (BATCH, N_POINTS, C5_BEAMS, tall)))
    for tag, (b, npts, beams, s) in timed:
        zargs = []
        for i in range(PACKED_TIMED):
            p, _, v = synthesize_beam_scan_batch(np.random.default_rng(2700 + i), b, npts, n_beams=beams)
            zargs.append(pixel_args(p, v, s))
        with torch.inference_mode():
            exact = projection.nearest_wins_image_reference(*zargs[0], s)
            moved = int((projection.nearest_wins_packed_image_reference(*zargs[0], s)
                         != exact).any(-1).sum())
        fill = torch.tensor([0.0, s.min_height, 0.0], device=dev)
        log(f"  (d) {b} x {npts} beam scans ({beams} beams) into {s.height} x {s.width}, idx_bits "
            f"{max((npts - 1).bit_length(), 1)}: pixels where the packed rule leaves the exact "
            f"one {moved} of {int((exact != fill).any(-1).sum())} occupied (the first set)")
        t = times[tag] = packed_turns(s, zargs)
        log(f"  (d) {b} x {npts} into {s.height} rows, device time (a call), in turns over "
            f"{PACKED_TIMED} sets: packed "
            f"kernel {t['kernel']:.4f} ({t['kernel_call']:.4f}) ms, exact kernel {t['exact']:.4f} "
            f"({t['exact_call']:.4f}) ms, scatter_reduce_ of the int32 packs + gather "
            f"{t['library']:.4f} ({t['library_call']:.4f}) ms, plain {t['plain']:.4f} "
            f"({t['plain_call']:.4f}) ms; bound {t['bound']:.4f} ms, packed kernel at "
            f"{t['bound'] / t['kernel']:.1%} of it, exact at {t['bound'] / t['exact']:.1%} {where}")
    out = io.StringIO()
    args = ["--methods", "exact,packed", "--e2e"]
    try:
        with contextlib.redirect_stdout(out):
            ab, _ = drive(f"(d) tools.bench_projection_ab {' '.join(args)}",
                          lambda: bench_projection_ab.main(args), totals,
                          expect=PACKED + ("nearest_wins_image", "decode_direct"))
    finally:
        for line in out.getvalue().splitlines():
            log(f"    {line}")
    log(f"  (d) A/B: projection exact {ab['exact']} / packed {ab['packed']} ms a batch, "
        f"e2e exact {ab['e2e_exact']} / packed {ab['e2e_packed']} ms; phase 26's bench.run: "
        f"headline {headline['value']}, packed row {headline['packed_fps']} frames/s {where}")
    log(f"  phase 27 took {time.perf_counter() - t_phase:.3f} s (host clock) [{card}]")
    t64, t16, t63 = times["64"], times["16"], times["63"]
    return {"err": err, "kernel": t64["kernel"], "plain": t64["plain"], "bound": t64["bound"],
            "library": t64["library"], "kernel_call": t64["kernel_call"], "exact": t64["exact"],
            "kernel_131072": t16["kernel"], "bound_131072": t16["bound"],
            "library_131072": t16["library"], "exact_131072": t16["exact"],
            "kernel_63": t63["kernel"], "bound_63": t63["bound"], "library_63": t63["library"],
            "exact_63": t63["exact"]}


def training_phases(dev, spec, gm, gf, card, totals) -> None:
    """Phases 15-18: the train step against the reference, the trainer,
    fusion training, config 4."""
    from tpufusion_torch._golden import load_npz

    gt = load_npz(GOLDEN_TRAIN)
    phase_train_golden(dev, spec, gm, gt, totals)
    phase_trainer(dev, spec, card, totals)
    phase_fusion_train(dev, gf, gt, card, totals)
    phase_config4(dev, spec, card, totals)


def main(argv=()) -> int:
    unknown = [a for a in argv if a not in ("--training-only", "--sync-counts")]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from tpufusion_torch import RangeViewSpec, _build
    from tpufusion_torch._golden import TALL_RES_V_DEG, load_npz, wrapped_pose_diff
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.decode.decode import decode_batch_direct, heat_mask
    from tpufusion_torch.geometry.range_view import (
        _frame_pixels_keys,
        range_view_project_batch,
    )
    from tpufusion_torch.ops import cc, components, parity_inputs, projection
    from tpufusion_torch.predict import make_e2e_step
    from tpufusion_torch.serve.pipeline import LidarPipeline

    # -- phase 0: device ---------------------------------------------------
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"phase 0 device: {card} | {name} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"  cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}; "
        "setting False / 'highest': the FCN runs in float32, as its golden")
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    spec = RangeViewSpec()

    # -- phase 1: build ----------------------------------------------------
    lib_path = _build.library_path()
    if os.path.exists(lib_path):  # build from the sources, every run
        os.remove(lib_path)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    sources = [os.path.relpath(s, HERE) for s in _build._sources()]
    log(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS[:2])} (sm_90a) "
        f"{' '.join(sources)} -> {os.path.relpath(lib_path, HERE)} "
        f"in {build_s:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    if "--sync-counts" in argv:
        phase_host_syncs(dev, spec, card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    if "--training-only" in argv:
        totals = dict.fromkeys(KERNELS, 0)
        training_phases(dev, spec, load_npz(GOLDEN_MULTI), load_npz(GOLDEN_FUSION), card, totals)
        log(f"kernel launches over phases 15-18: {totals}")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0

    # -- phase 2: z-buffer kernel vs its plain version ---------------------
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((4, 8192, 4)) * 20).astype(np.float32)
    pts[:, 4096:4608] = pts[:, :512]  # exact-key collision ties
    pts[0, 5] = np.nan
    valid = rng.random((4, 8192)) > 0.1
    scan_pts, scan_gt, scan_valid = synthesize_beam_scan_batch(
        np.random.default_rng(0), BATCH, N_POINTS
    )
    pix_err, pix2d_err = phase_pixels(dev, spec, (scan_pts, scan_valid))  # phase 1b
    enc_err, enc_times = phase_label_encode(dev, (scan_pts, scan_gt, scan_valid))  # phase 1c
    dir_err, dir_times = phase_direct_encode(dev, (scan_pts, scan_gt, scan_valid))  # phase 1d
    dec_err, dec_times, dec_near, dec_driven = phase_decode_direct(dev)  # phase 1e
    cv_err, cv_times, cv_lanes = phase_corner_vote(dev, load_npz(GOLDEN_MULTI))  # phase 1f
    sfr, sf_driven = phase_small_float(dev, spec, load_npz(GOLDEN_MULTI),
                                       (scan_pts, scan_valid))  # phase 1g
    sbr, sb_driven = phase_small_float_backward(dev, spec)  # phase 1h
    proj_err = 0.0
    for label, p, v in (("proj_check 4x8192", pts, valid),
                        (f"beam scans {BATCH}x{N_POINTS}", scan_pts, scan_valid)):
        args = _frame_pixels_keys(
            torch.from_numpy(p).to(dev), spec, torch.from_numpy(v).to(dev)
        )
        before = projection.LAUNCHES
        got = projection.nearest_wins_image(*args, spec)
        want = projection.nearest_wins_image_reference(*args, spec)
        torch.cuda.synchronize()
        assert projection.LAUNCHES == before + 1, "z-buffer kernel not launched"
        same = torch.equal(got, want)
        proj_err = max(proj_err, float((got - want).abs().max()))
        log(f"phase 2 z-buffer {label}: bit-identical to plain = {same}, "
            f"max |diff| = {proj_err}")
        assert same, f"z-buffer kernel differs from its plain version ({label})"
    for b, n, kinds in parity_inputs.ZBUFFER_SHAPES:
        args = [torch.from_numpy(a).to(dev) for a in parity_inputs.zbuffer_args(
            b, n, spec.height * spec.width, kinds=kinds)]
        got = projection.nearest_wins_image(*args, spec)
        want = projection.nearest_wins_image_reference(*args, spec)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        proj_err = max(proj_err, float((got - want).abs().max()))
        log(f"phase 2 z-buffer adversarial {b}x{n} ({', '.join(kinds)}): "
            f"bit-identical to plain = {same}")
        assert same, f"z-buffer kernel differs from its plain version ({b}x{n} {kinds})"

    tall = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)  # 63 x 1801
    args = [torch.from_numpy(a).to(dev) for a in parity_inputs.zbuffer_args(
        BATCH, N_POINTS, tall.height * tall.width)]
    got = projection.nearest_wins_image(*args, tall)
    want = projection.nearest_wins_image_reference(*args, tall)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    proj_err = max(proj_err, float((got - want).abs().max()))
    log(f"phase 2 z-buffer adversarial {BATCH}x{N_POINTS} into {tall.height} x {tall.width} "
        f"({', '.join(parity_inputs.ZBUFFER_KINDS)}): bit-identical to plain = {same}")
    assert same, "z-buffer kernel differs from its plain version (63 x 1801)"

    # -- phase 3: CC kernel vs the plain sweeps ----------------------------
    pipe = LidarPipeline.from_asset(ASSET, dev)
    model, dcfg = pipe.model, pipe.cfg.decode
    crng = np.random.default_rng(7)
    synth = []
    for density in (0.0, 0.05, 0.4):
        m = crng.random((spec.height, spec.width)) < density
        m[10:20, 1700:] = True  # a blob across the azimuth seam
        m[10:20, :100] = True
        synth.append(m)
    with torch.inference_mode():
        scan_imgs = range_view_project_batch(
            torch.from_numpy(scan_pts).to(dev), spec,
            torch.from_numpy(scan_valid).to(dev),
        )
        heat = heat_mask(model(scan_imgs)[..., 1], dcfg)
    cc_err = 0
    cases = [("densities 0/0.05/0.4 + seam blob", torch.from_numpy(np.stack(synth)).to(dev)),
             (f"asset heat masks x{BATCH}", heat)] + [
        (f"adversarial x{b} ({', '.join(parity_inputs.cc_frames()) if b > 1 else 'serpentine'})",
         torch.from_numpy(parity_inputs.cc_batch(b)).to(dev))
        for b in parity_inputs.CC_BATCHES] + [
        (f"adversarial x{b} at {h} x {spec.width}", torch.from_numpy(
            parity_inputs.cc_batch(b, height=h)).to(dev))
        for h in parity_inputs.CC_HEIGHTS if h != spec.height
        for b in parity_inputs.CC_BATCHES[:2]]  # batch 64 at these heights: the cuda tests
    wide = np.zeros((2, spec.height, WIDE_COLUMNS), bool)
    wide[0, ::2] = True  # 16 rows across 375 column borders: 6,000 links
    wide[1] = crng.random(wide.shape[1:]) < 0.4
    cases.append((f"{spec.height} x {WIDE_COLUMNS}: every other row, and noise of 0.4",
                  torch.from_numpy(wide).to(dev)))
    for label, mask in cases:
        before = cc.LAUNCHES
        got = cc.connected_components_with_bbox(mask, dcfg.max_cc_iters, dcfg.cc_impl)
        _, sweeps = components.propagate(components.init_state(mask), mask, SWEEP_CAP)
        want = components.connected_components_with_bbox(mask, SWEEP_CAP)
        torch.cuda.synchronize()
        assert cc.LAUNCHES == before + 1, "CC kernel not launched"
        assert int(sweeps.max()) < SWEEP_CAP, "plain sweeps did not converge"
        same = torch.equal(got[0], want[0]) and all(
            torch.equal(g[mask], w[mask]) for g, w in zip(got[1:], want[1:])
        )
        cc_err = max(cc_err, int((got[0] - want[0]).abs().max()), *(
            int((g[mask] - w[mask]).abs().max()) if mask.any() else 0
            for g, w in zip(got[1:], want[1:])
        ))
        sw = sweeps.tolist()
        log(f"phase 3 CC {label}: labels + foreground extents equal = {same}; "
            f"plain sweeps per frame: max {max(sw)}, mean {np.mean(sw):.1f}, "
            f"frames over the decode's cap {dcfg.max_cc_iters}: "
            f"{sum(s > dcfg.max_cc_iters for s in sw)}"
            + (f" ({sw})" if len(sw) <= 8 else ""))
        assert same, f"CC kernel differs from the plain sweeps ({label})"

    # -- phase 4: the main path --------------------------------------------
    step = make_e2e_step(model, spec, dcfg, head="direct", device=dev)
    req_pts, req_gt, req_valid = synthesize_beam_scan_batch(
        np.random.default_rng(1), REQUESTS, N_POINTS
    )
    requests = [req_pts[i][req_valid[i]] for i in range(REQUESTS)]
    _reset_launches()
    answers = [pipe.predict_position(r) for r in requests]
    poses, found = step(scan_pts, scan_valid)
    torch.cuda.synchronize()
    launches = _launches()
    log(f"phase 4 main path: {REQUESTS} server requests + one batch of "
        f"{BATCH}x{N_POINTS}; kernel launches {launches}")
    for k in DIRECT:
        assert launches[k] > 0, f"the main path never launched {k}"
    assert launches["project_points"] == launches["nearest_wins_image"], (
        "the main path: a range view without the pixel kernel")
    poses_np, found_np = poses.cpu().numpy(), found.cpu().numpy()
    req_poses = np.stack([a[0] for a in answers])
    req_found = np.array([a[1] for a in answers])
    assert poses_np.shape == (BATCH, 7) and found_np.shape == (BATCH,)
    assert np.isfinite(poses_np).all() and np.isfinite(req_poses).all()
    xy = np.linalg.norm(poses_np[:, :2] - scan_gt["center"][:, :2], axis=1)[found_np]
    req_xy = np.linalg.norm(req_poses[:, :2] - req_gt["center"][:, :2], axis=1)[req_found]
    log(f"  batch: found {int(found_np.sum())}/{BATCH}, xy error median "
        f"{np.median(xy):.3f} m, max {xy.max():.3f} m; requests: found "
        f"{int(req_found.sum())}/{REQUESTS}, xy error median {np.median(req_xy):.3f} m")
    assert found_np.mean() >= 0.9 and req_found.mean() >= 0.75, "detector misses"
    assert np.median(xy) < 1.0, "poses far from the scenes' ground truth"

    with np.load(GOLDEN) as z:
        g_pts, g_valid, g_found, g_poses, g_sha = (
            z["points"], z["valid"], z["found"], z["poses"], z["image_sha256"])
    gp, gf = step(g_pts, g_valid)
    diff = wrapped_pose_diff(gp.cpu().numpy(), g_poses)
    with torch.inference_mode():
        g_imgs = range_view_project_batch(
            torch.from_numpy(g_pts).to(dev), spec, torch.from_numpy(g_valid).to(dev)
        ).cpu().numpy()
    same_img = sum(
        hashlib.sha256(np.ascontiguousarray(im).tobytes()).hexdigest() == s
        for im, s in zip(g_imgs, g_sha)
    )
    log(f"  JAX golden ({len(g_found)} frames): found {gf.cpu().numpy().tolist()} "
        f"vs {g_found.tolist()}, largest pose difference {diff.max():.3e} "
        f"(tolerance {POSE_TOL}), images with JAX's sha256: {same_img}/{len(g_sha)}")
    assert np.array_equal(gf.cpu().numpy(), g_found), "found differs from JAX"
    assert diff.max() < POSE_TOL, "poses differ from JAX"
    assert same_img == len(g_sha), "the card's range views of the golden frames are not JAX's"

    # -- phase 5: times on the card ----------------------------------------
    batches = []
    for i in range(TIMED_BATCHES):
        p, _, v = synthesize_beam_scan_batch(np.random.default_rng(100 + i), BATCH, N_POINTS)
        batches.append((torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev)))
    torch.cuda.reset_peak_memory_stats()
    e2e_ms = time_ms(lambda pv: step(*pv), batches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    with torch.inference_mode():
        images = [range_view_project_batch(p, spec, v) for p, v in batches]
        preds = [model(im) for im in images]
        masks = [heat_mask(pr[..., 1], dcfg) for pr in preds]
        zargs = [_frame_pixels_keys(p, spec, v) for p, v in batches]
        proj_ms = time_ms(lambda pv: range_view_project_batch(pv[0], spec, pv[1]), batches)
        fcn_ms = time_ms(model, images)
        dec_ms = time_ms(lambda ip: decode_batch_direct(ip[1], ip[0], spec, dcfg),
                         list(zip(images, preds)))
        kt = kernel_turns(spec, zargs, masks, dcfg)
        pt = pixel_turns(spec, batches[:PIXEL_SETS])
    for r in requests[:3]:
        pipe.predict_position(r)  # warm-up
    lat = []
    for r in requests * 13:  # 104 samples: >= 10 beyond the p90
        t0 = time.perf_counter()
        pipe.predict_position(r)  # returns host numpy: the request is done
        lat.append((time.perf_counter() - t0) * 1e3)
    where = f"[{card}]"
    log(f"phase 5 times, CUDA events, mean over {TIMED_BATCHES} distinct "
        f"batches of {BATCH}x{N_POINTS} after warm-up {where}")
    log(f"  e2e: {e2e_ms:.3f} ms/batch = {BATCH * 1e3 / e2e_ms:.1f} frames/s; "
        f"peak device memory {peak_mb:.0f} MiB {where}")
    log(f"  stages: projection {proj_ms:.3f} ms, FCN {fcn_ms:.3f} ms, decode "
        f"{dec_ms:.3f} ms (CC inside the decode {kt['cc']['kernel_call']:.3f} ms a call) {where}")
    log(f"  {turns_line(kt)} {where}")
    log(f"  {pixel_line(pt)} {where}")
    log(f"  single-frame request (host clock, {len(lat)} requests): p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms {where}")

    # -- phases 6-10: the rest of the serving path -------------------------
    totals = dict(launches)  # launches over every path the script drives
    for k, n in dec_driven.items():  # phase 1e's bf16 decodes
        totals[k] += n
    for k, n in sf_driven.items():  # phase 1g's small-float steps
        totals[k] += n
    for k, n in sb_driven.items():  # phase 1h's small-float training
        totals[k] += n
    g, gm = load_npz(GOLDEN), load_npz(GOLDEN_MULTI)
    models, adcfg = phase_bf16(dev, spec, g, gm)
    c5_step, seq_poses, seq_found = phase_config5(dev, spec, gm, models, adcfg, totals)
    cstep, cmodel = phase_corner(dev, spec, gm, batches, totals)
    phase_assets(dev, spec, gm)
    phase_times(dev, spec, models, adcfg, c5_step, cstep, cmodel,
                (seq_poses, seq_found), batches, images, card)

    # -- phases 11-14: BEV, configs 1 and 3, the replay server -------------
    gf = load_npz(GOLDEN_FUSION)
    phase_bev(dev, gf, scan_pts, scan_valid)
    phase_config1(dev, gm, card, totals)
    phase_config3(dev, gf, card, totals)
    phase_replay(dev, card, totals)

    # -- phases 15-18: training and config 4 -------------------------------
    training_phases(dev, spec, gm, gf, card, totals)

    # -- phases 19-21: data parallelism, config 5, host syncs --------------
    _, dpt = phase_data_parallel(dev, spec, card, totals)
    phase_config5_bench(dev, spec, card, totals)
    syncs = phase_host_syncs(dev, spec, card)
    assert not any(syncs.values()), f"a serving path synchronizes with the host: {syncs}"

    # -- phases 22-24: the offline drive (bag -> extract -> the CLI), the
    # training and tuning tools, the viewer and the host tools (on phase
    # 22's extracted dir) --------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="offline_drive_") as drive_work:
        phase_offline_drive(dev, spec, card, totals, drive_work)
        phase_tools(dev, spec, card, totals)
        phase_viewer(dev, spec, card, totals, os.path.join(drive_work, "inram"))

    # -- phase 25: a 64-beam sensor's 63 x 1801 range view ------------------
    p5 = {"e2e": e2e_ms, "peak_mb": peak_mb, "proj": proj_ms, "fcn": fcn_ms, "dec": dec_ms,
          "cc_call": kt["cc"]["kernel_call"]}
    tall_times = phase_tall(dev, card, totals, p5)

    # -- phase 26: the repo's headline, bench.py and entry() ---------------
    headline = phase_headline(dev, spec, card, totals)

    # -- phase 27: the reference's other projection methods ----------------
    pk = phase_packed(dev, spec, card, totals, headline)

    assert totals["project_2d"] > 0, "no path launched the project_2d kernel"
    assert totals["nearest_wins_packed_image"] > 0, "no path launched the packed z-buffer"
    assert totals["encode_label"] > 0, "no path launched the label-encode kernel"
    assert totals["encode_direct_label"] > 0, "no path launched the direct label-encode kernel"
    assert totals["decode_direct"] > 0, "no path launched the direct decode kernel"
    assert totals["corner_vote"] > 0, "no path launched the corner vote kernel"
    assert totals["small_float"] > 0, "no path launched the small-float kernel"
    assert totals["small_float_backward"] > 0, "no path launched the small-float backward"
    assert totals["small_float_cast"] > 0, "no path launched the small-float cast"
    assert totals["small_float_reduce"] > 0, "no path launched the small-float reduce"
    assert totals["project_points"] == (
        totals["nearest_wins_image"] + totals["nearest_wins_packed_image"]), (
        "a driven range view without the pixel kernel")
    z, c, px, p2 = kt["z"], kt["cc"], pt["points"], pt["2d"]
    e32, e63 = enc_times[32], enc_times[63]
    d32, d63 = dir_times[32, "local"], dir_times[63, "local"]
    d32b, d63b = dir_times[32, "both"], dir_times[63, "both"]
    dl, dc5, d63r = (dec_times[shape[0]] for shape in DECODE_SHAPES)
    cv = dict(zip(("row", "hybrid", "k4", "63_rows", "full"),
                  (cv_times[shape[0]] for shape in CORNER_SHAPES)))
    kernels = [
        {"name": "project_points", "route": "cuda",
         "source": "tpufusion_torch/csrc/pixels.cu",
         "replaces": "tpufusion/geometry/range_view.py:115",
         "launches": totals["project_points"], "max_abs_err": pix_err,
         "ms": px["kernel"], "plain_ms": px["plain"], "bound_ms": px["bound"],
         "bound_by": "bytes", "library_ms": None, "call_ms": px["kernel_call"],
         "replaced_composition_ms": px["composition"], "view_ms": px["view"],
         "view_ms_before": px["view_before"]},
        {"name": "project_2d", "route": "cuda",
         "source": "tpufusion_torch/csrc/pixels.cu",
         "replaces": "tpufusion/geometry/boxes.py:86",
         "launches": totals["project_2d"], "max_abs_err": pix2d_err,
         "ms": p2["kernel"], "plain_ms": p2["plain"], "bound_ms": p2["bound"],
         "bound_by": "bytes", "library_ms": None, "call_ms": p2["kernel_call"],
         "replaced_composition_ms": p2["composition"], "launch_floor_ms": p2["empty"]},
        {"name": "nearest_wins_image", "route": "cuda",
         "source": "tpufusion_torch/csrc/nearest_wins.cu",
         "replaces": "tpufusion/ops/pallas_projection.py:146",
         "launches": totals["nearest_wins_image"], "max_abs_err": proj_err,
         "ms": z["kernel"], "plain_ms": z["plain"], "bound_ms": z["bound"],
         "bound_by": "bytes", "library_ms": z["library"], "call_ms": z["kernel_call"],
         "ms_63_rows": tall_times["z 63"][0], "bound_ms_63_rows": tall_times["z 63"][1]},
        {"name": "connected_components_with_bbox", "route": "cuda",
         "source": "tpufusion_torch/csrc/components.cu",
         "replaces": "tpufusion/ops/pallas_cc.py:102",
         "launches": totals["connected_components_with_bbox"],
         "max_abs_err": cc_err, "ms": c["kernel"], "plain_ms": c["plain"],
         "bound_ms": c["bound"], "bound_by": "bytes", "library_ms": None,
         "call_ms": c["kernel_call"],
         "ms_63_rows": tall_times["cc 63"][0], "bound_ms_63_rows": tall_times["cc 63"][1],
         "ms_128_rows": tall_times["cc 128"][0], "bound_ms_128_rows": tall_times["cc 128"][1]},
        {"name": "encode_label", "route": "cuda",
         "source": "tpufusion_torch/csrc/label_encode.cu",
         "replaces": "tpufusion/geometry/encoding.py:121",
         "launches": totals["encode_label"], "max_abs_err": enc_err,
         "ms": e32["kernel"], "plain_ms": e32["plain"], "bound_ms": e32["bound"],
         "bound_by": "bytes", "library_ms": None, "call_ms": e32["kernel_call"],
         "plain_call_ms": e32["plain_call"], "ms_63_rows": e63["kernel"],
         "plain_ms_63_rows": e63["plain"], "bound_ms_63_rows": e63["bound"]},
        {"name": "encode_direct_label", "route": "cuda",
         "source": "tpufusion_torch/csrc/label_encode.cu",
         "replaces": "tpufusion/geometry/encoding.py:237",
         "launches": totals["encode_direct_label"], "max_abs_err": dir_err,
         "ms": d32["kernel"], "plain_ms": d32["plain"], "bound_ms": d32["bound"],
         "bound_by": "bytes", "library_ms": None, "call_ms": d32["kernel_call"],
         "plain_call_ms": d32["plain_call"], "ms_63_rows": d63["kernel"],
         "plain_ms_63_rows": d63["plain"], "bound_ms_63_rows": d63["bound"],
         "ms_12_channels": d32b["kernel"], "plain_ms_12_channels": d32b["plain"],
         "bound_ms_12_channels": d32b["bound"], "ms_63_rows_12_channels": d63b["kernel"],
         "plain_ms_63_rows_12_channels": d63b["plain"],
         "bound_ms_63_rows_12_channels": d63b["bound"]},
        {"name": "nearest_wins_packed_image", "route": "cuda",
         "source": "tpufusion_torch/csrc/nearest_wins_packed.cu",
         "replaces": "tpufusion/ops/scatter.py:107",
         "launches": totals["nearest_wins_packed_image"], "max_abs_err": pk["err"],
         "ms": pk["kernel"], "plain_ms": pk["plain"], "bound_ms": pk["bound"],
         "bound_by": "bytes", "library_ms": pk["library"], "call_ms": pk["kernel_call"],
         "exact_kernel_ms": pk["exact"], "ms_131072": pk["kernel_131072"],
         "bound_ms_131072": pk["bound_131072"], "library_ms_131072": pk["library_131072"],
         "exact_kernel_ms_131072": pk["exact_131072"], "ms_63_rows": pk["kernel_63"],
         "bound_ms_63_rows": pk["bound_63"], "library_ms_63_rows": pk["library_63"],
         "exact_kernel_ms_63_rows": pk["exact_63"]},
        {"name": "decode_direct", "route": "cuda",
         "source": "tpufusion_torch/csrc/decode_direct.cu",
         "replaces": "tpufusion/decode/decode.py:1033",
         "launches": totals["decode_direct"], "max_abs_err": dec_err,
         "ms": dl["new_device_ms"], "plain_ms": dl["plain_device_ms"], "bound_ms": dl["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "call_ms": dl["new_call_ms"],
         "plain_call_ms": dl["plain_call_ms"], "launch_floor_ms": dl["empty_device_ms"],
         "ms_config5": dc5["new_device_ms"], "plain_ms_config5": dc5["plain_device_ms"],
         "bound_ms_config5": dc5["bound_ms"], "ms_63_rows": d63r["new_device_ms"],
         "plain_ms_63_rows": d63r["plain_device_ms"], "bound_ms_63_rows": d63r["bound_ms"],
         "near_threshold_lanes_exempt": dec_near},
        {"name": "corner_vote", "route": "cuda",
         "source": "tpufusion_torch/csrc/corner_vote.cu",
         "replaces": "tpufusion/decode/decode.py:240",
         "launches": totals["corner_vote"], "max_abs_err": cv_err,
         "ms": cv["row"]["new_device_ms"], "plain_ms": cv["row"]["plain_device_ms"],
         "bound_ms": cv["row"]["bound_ms"], "bound_by": cv["row"]["bound_by"],
         "library_ms": None, "call_ms": cv["row"]["new_call_ms"],
         "plain_call_ms": cv["row"]["plain_call_ms"],
         "launch_floor_ms": cv["row"]["empty_device_ms"],
         **{f"{key}_{tag}": cv[tag][f"{src}"] for tag in ("hybrid", "k4", "63_rows", "full")
            for key, src in (("ms", "new_device_ms"), ("plain_ms", "plain_device_ms"),
                             ("bound_ms", "bound_ms"))},
         "driven_lanes_voted": cv_lanes["voted"], "driven_lanes_undecided": cv_lanes["undecided"],
         "driven_lanes_pose_sensitive": cv_lanes["sensitive"],
         "adversarial_lanes_undecided": cv_lanes["adversarial_undecided"]},
        {"name": "small_float", "route": "cuda",
         "source": "tpufusion_torch/csrc/small_float.cu",
         "replaces": "tpufusion/models/fcn.py:100",
         "launches": totals["small_float"], "max_abs_err": sfr["err"],
         "ms": sfr["row"]["new_device_ms"], "plain_ms": sfr["row"]["plain_device_ms"],
         "bound_ms": sfr["row"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "call_ms": sfr["row"]["new_call_ms"], "plain_call_ms": sfr["row"]["plain_call_ms"],
         "yardstick_ms": sfr["row"].get("yardstick_device_ms"),
         "input_cast_ms": sfr["row"]["cast_device_ms"],
         "input_cast_plain_ms": sfr["row"]["cast_plain_device_ms"],
         "input_cast_bound_ms": sfr["row"]["input_cast_bound_ms"],
         "wrapper_host_us": sfr["row"]["wrapper_host_us"],
         "epilogue_elements": sfr["row"]["elements"],
         "conv16_raw_differ": sfr["conv16_raw_differ"],
         "conv16_fmt_differ": sfr["conv16_fmt_differ"], "conv_outputs": sfr["conv_outputs"],
         **{k: v for k, v in sfr.items() if k.endswith(("_features_same", "_prob_diff"))},
         "golden_pose_diff": sfr["pose_diff"],
         "input_cast_library_ms": sfr["row"].get("cast_library_device_ms")},
        {"name": "small_float_backward", "route": "cuda",
         "source": "tpufusion_torch/csrc/small_float.cu",
         "replaces": "tpufusion/models/fcn.py:100",
         "launches": totals["small_float_backward"], "max_abs_err": sbr["err"],
         "ms": sbr["row"]["new_device_ms"], "plain_ms": sbr["row"]["plain_call_ms"],
         "bound_ms": sbr["row"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "call_ms": sbr["row"]["new_call_ms"], "shape": sbr["row"]["call_shape"],
         "step_ms": sbr["row"]["step_device_ms"], "step_bound_ms": sbr["row"]["step_bound_ms"],
         "calls_a_step": sbr["row"]["calls"], "epilogue_elements": sbr["row"]["elements"],
         **{k: v for k, v in sbr.items() if k.startswith(("golden_", "main_"))}},
        {"name": "small_float_cast", "route": "cuda",
         "source": "tpufusion_torch/csrc/small_float.cu",
         "replaces": "tpufusion/models/fcn.py:100",
         "launches": totals["small_float_cast"], "max_abs_err": sfr["err"],
         "ms": sfr["row"]["cast_device_ms"], "plain_ms": sfr["row"]["cast_plain_device_ms"],
         "bound_ms": sfr["row"]["input_cast_bound_ms"], "bound_by": "bytes",
         "library_ms": sfr["row"].get("cast_library_device_ms"),
         "shape": sfr["row"]["input_cast_shape"], "float32_patterns_checked": sfr["cast_patterns"]},
        {"name": "small_float_reduce", "route": "cuda",
         "source": "tpufusion_torch/csrc/small_float.cu",
         "replaces": "tpufusion/models/fcn.py:100",
         "launches": totals["small_float_reduce"], "max_abs_err": sbr["err"],
         "ms": sbr["reduce_row"]["new_device_ms"], "plain_ms": sbr["reduce_row"]["plain_call_ms"],
         "bound_ms": sbr["reduce_row"]["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "shape": sbr["reduce_row"]["shape"], "step_ms": sbr["reduce_row"]["step_device_ms"],
         "step_bound_ms": sbr["reduce_row"]["step_bound_ms"],
         "reduces_a_step": sbr["reduce_row"]["reduces"], "adversarial_checks": sbr["reduce_checks"],
         "distinct_codes_at_end": [round(r["distinct"]["end"]["mean"], 1)
                                   for r in sbr["reduce_codes"]],
         "nonzero_steps": [round(r["nonzero_steps"], 4) for r in sbr["reduce_codes"]],
         "mesh": {k: {f: v["small_float"][f] for f in ("layout", "same", "worst", "steps",
                                                         "loss_rel", "ms_per_step")}
                  for k, v in dpt.items()}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
