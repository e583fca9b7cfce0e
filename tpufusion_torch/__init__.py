"""tpufusion_torch — the PyTorch + CUDA port of tpufusion for NVIDIA Hopper.

The JAX package `tpufusion/` is the reference; this package mirrors its
module layout and names so each function has a findable counterpart, and
its tests hold the two to the same numpy inputs. Plain tensor code is
PyTorch; each of the reference's Pallas kernels is a CUDA C++ kernel
under `csrc/`, built for sm_90a at first use (`_build.py`) and launched
through a wrapper that takes the plain PyTorch version only for tensors
that lie on the CPU.

Ported so far: the lidar serving path, raw points -> range view -> FCN ->
direct-pose decode -> pose (`predict.make_e2e_step`,
`serve.pipeline.LidarPipeline`), and a numpy beam-scan generator
(`data.synthetic`) to feed it where JAX is not installed.

Subpackages
-----------
geometry   range-view projection, pixel angles/points
ops        nearest-wins z-buffer and connected components (kernel wrappers
           + plain versions)
models     FCN inference, npz weight loading
decode     direct-pose decode
serve      single-frame server facade
data       numpy beam-structured synthetic scans

The configuration dataclasses are the reference's own (`tpufusion.config`
imports neither jax nor flax); nothing in this package imports jax.
"""

from tpufusion.config import (  # noqa: F401
    DecodeConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
)
