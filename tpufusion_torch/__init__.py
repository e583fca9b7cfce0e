"""tpufusion_torch — the PyTorch + CUDA port of tpufusion for NVIDIA Hopper.

The JAX package `tpufusion/` is the reference; this package mirrors its
module layout and names so each function has a findable counterpart, and
its tests hold the two to the same numpy inputs. Plain tensor code is
PyTorch; each of the reference's Pallas kernels is a CUDA C++ kernel
under `csrc/`, built for sm_90a at first use (`_build.py`) and launched
through a wrapper that takes the plain PyTorch version only for tensors
that lie on the CPU.

Ported so far: everything that serves. The lidar detector's path, raw
points -> range view -> FCN (float32 or bf16) -> direct, top-K or corner
decode -> poses (`predict.make_e2e_step`, `serve.pipeline.LidarPipeline`),
the chunked replay server (`serve.replay.ReplayHarness`), the tracker
(`serve.tracker`), the bird's-eye view and the camera paint table
(`geometry.bev`, `geometry.camera`), the camera + lidar + radar fusion
net and its inference loop (`models.fusion`, `models.io.fusion_from_asset`,
`serve.fusion.predict_fusion`), the serving benchmarks (`benchmarks`,
configs 1-3), scoring and the submission writers (`eval`), and numpy
generators (`data.synthetic`) to feed them where JAX is not installed.
Training and the tools are not ported yet.

Every entry point takes `device` and defaults to "cuda": it moves its
model to the card and its inputs follow; without a card it raises. The
tests pass device="cpu".

Subpackages
-----------
geometry   range-view projection, pixel angles/points, BEV rasterizer,
           camera model and paint table
ops        nearest-wins z-buffer and connected components (kernel wrappers
           + plain versions), the BEV's count / max scatters
models     FCN inference (lidar, camera and BEV geometries), FusionNet,
           npz weight loading
decode     direct-pose decode, corner vote, top-K
serve      single-frame server facade, replay server, fusion inference
           loop, multi-frame tracker
eval       pose scoring, prediction CSV, tracklet XML, interpolation
data       numpy beam-structured synthetic scans and fusion frames,
           the join of the three sensor streams into fusion samples,
           timestamp alignment, radar tracks
benchmarks serving configs 1-3

The package imports nothing of the JAX package: it keeps its own copy of
the configuration dataclasses (`config.py`) and of the numpy modules it
needs (the tracker, the scoring, the camera model, the alignment, the
radar tracks, the submission writers), and `tests/test_torch_imports.py`
holds it to that.
"""

from tpufusion_torch.config import (  # noqa: F401
    DecodeConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
)
