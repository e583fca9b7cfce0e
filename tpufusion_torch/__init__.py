"""tpufusion_torch — the PyTorch + CUDA port of tpufusion for NVIDIA Hopper.

The JAX package `tpufusion/` is the reference; this package mirrors its
module layout and names so each function has a findable counterpart, and
its tests hold the two to the same numpy inputs. Plain tensor code is
PyTorch; each of the reference's Pallas kernels is a CUDA C++ kernel
under `csrc/`, built for sm_90a at first use (`_build.py`) and launched
through a wrapper that takes the plain PyTorch version only for tensors
that lie on the CPU.

Ported so far: the lidar detector's serving path, raw points -> range
view -> FCN (float32 or bf16) -> direct, top-K or corner decode -> poses
(`predict.make_e2e_step`, `serve.pipeline.LidarPipeline`), the tracker
(`serve.tracker`), top-K scoring (`eval.scoring`), and numpy beam-scan
generators (`data.synthetic`) to feed it where JAX is not installed.

Subpackages
-----------
geometry   range-view projection, pixel angles/points
ops        nearest-wins z-buffer and connected components (kernel wrappers
           + plain versions)
models     FCN inference, npz weight loading
decode     direct-pose decode
serve      single-frame server facade, multi-frame tracker
eval       top-K pose scoring
data       numpy beam-structured synthetic scans

The package imports nothing of the JAX package: it keeps its own copy of
the configuration dataclasses (`config.py`) and of the numpy modules it
needs (the tracker, the scoring), and `tests/test_torch_imports.py` holds
it to that.
"""

from tpufusion_torch.config import (  # noqa: F401
    DecodeConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
)
