"""Builds the port's CUDA kernels and loads them with ctypes.

At first use, nvcc compiles every `csrc/*.cu` (with the `csrc/*.cuh`
headers they include) for sm_90a, one process a source, all started
together, and links the objects into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes)
under `tpufusion_torch/_build/`. The library's name carries a hash of
the sources, headers and flags, so an edited source rebuilds and a stale
library is never loaded. There is no fallback: without nvcc, or
when the compiler fails, `load()` raises RuntimeError with its output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # per-kernel registers / shared memory / spills in the log
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output from the build this process ran (or "")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (not on PATH and no CUDA_HOME): the port's CUDA "
        "kernels cannot be built"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpufusion_kernels_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    global build_log
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    sources = _sources()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for obj, src in zip(objs, sources)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
    if all(p.returncode == 0 for p in procs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        procs.append(proc)
        cmds.append(link)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_log = "".join(logs)
    for cmd, proc in zip(cmds, procs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}"
            )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            _lib = _bind(ctypes.CDLL(path))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tf_nearest_wins_image.argtypes = [p, p, p, p, p, p, i, i, i, f, p]
    lib.tf_nearest_wins_image.restype = i
    lib.tf_nearest_wins_packed_image.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    lib.tf_nearest_wins_packed_image.restype = i
    lib.tf_nearest_wins_packed_shape.argtypes = [i, p, p, p, p]
    lib.tf_nearest_wins_packed_shape.restype = i
    lib.tf_components_with_bbox.argtypes = [p, p, p, p, i, i, i, p]
    lib.tf_components_with_bbox.restype = i
    ll = ctypes.c_longlong
    spec = [f, f, f, f, i, i, i]  # res_h, x_min, res_v, y_min, width, height, y_max
    lib.tf_project_points.argtypes = [p, p, p, p, p, p, ll, i, *spec, p]
    lib.tf_project_points.restype = i
    lib.tf_project_2d.argtypes = [p, p, p, p, p, ll, *spec, p]
    lib.tf_project_2d.restype = i
    lib.tf_encode_label.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, *spec, p]
    lib.tf_encode_label.restype = i
    lib.tf_encode_direct_label.argtypes = [p, p, p, p, i, p, p, p, p, p, p, i, i, i, *spec, p]
    lib.tf_encode_direct_label.restype = i
    lib.tf_decode_direct.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, i, i, i, i,
                                     p, p, p, p, p, i, i, i, i, i,
                                     ctypes.POINTER(ctypes.c_float), p, p, p, i]
    lib.tf_decode_direct.restype = i
    lib.tf_corner_vote.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   ctypes.POINTER(ctypes.c_float), p, p, p, p, p, p, p, p, p]
    lib.tf_corner_vote.restype = i
    lib.tf_corner_vote_kernels.argtypes = []
    lib.tf_corner_vote_kernels.restype = ctypes.c_ulonglong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.tf_small_float_epilogue.argtypes = [p, i, p, p, i, i, i, i, ip, i, i, p, i, p]
    lib.tf_small_float_epilogue.restype = i
    lib.tf_small_float_cast.argtypes = [p, i, p, i, i, ll, i, ip, p]
    lib.tf_small_float_cast.restype = i
    lib.tf_small_float_backward.argtypes = [
        ctypes.POINTER(p), ip, ctypes.POINTER(ll), i, p, i, i, p, i, i, i, i, i, p, ip, i, p, i,
        p, i, p, p, ip, i, p]
    lib.tf_small_float_backward.restype = i
    lib.tf_small_float_bias_grad.argtypes = [p, i, ctypes.POINTER(ll), i, i, i, i, p, ip, i, p,
                                             i, p, i, p, p, ip, i, p]
    lib.tf_small_float_bias_grad.restype = i
    lib.tf_error_string.argtypes = [i]
    lib.tf_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.tf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
