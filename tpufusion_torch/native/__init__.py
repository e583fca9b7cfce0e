"""The host codec of the bag reader (counterpart of `tpufusion/native/`):
the fused PointCloud2 field unpack and the LZ4 block / frame codec of
`fastpoints.c`, behind a plain C interface loaded with ctypes.

At first use `cc -O3 -shared -fPIC` compiles `fastpoints.c` into
`tpufusion_torch/_build/`, under a name that hashes the source and the
flags (as `_build.py` names the CUDA library), so an edited source
rebuilds and a stale library is never loaded. There is no fallback: a
failed build raises RuntimeError with the compiler's output (the
reference falls back to numpy and says nothing). The C functions return
integer error codes; the wrappers raise the exception and message the
reference's extension raises for each. The plain versions (the numpy
unpack in `data/rosbag_reader.py`, the pure-Python LZ4 in `data/lz4.py`)
are what the tests hold these against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fastpoints.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CC_FLAGS = ("-O3", "-shared", "-fPIC")
MAX_FIELDS = 16

# fastpoints.c's FP_ERR_* codes -> the reference extension's exceptions
_OUTPUT_FULL = 6
_BAD_BLOCK_SIZE = 14
_ERRORS = {
    1: (ValueError, "too many fields (max 16)"),
    2: (ValueError, "field offset/type exceeds point_step"),
    3: (ValueError, "data shorter than n*point_step"),
    4: (ValueError, "lz4: truncated literal length"),
    5: (ValueError, "lz4: literal run past end of input"),
    _OUTPUT_FULL: (ValueError, "lz4: output exceeds declared size"),
    7: (ValueError, "lz4: truncated match offset"),
    8: (ValueError, "lz4: invalid match offset"),
    9: (ValueError, "lz4: truncated match length"),
    10: (ValueError, "lz4 frame too short"),
    11: (ValueError, "bad lz4 frame magic"),
    12: (ValueError, "unsupported lz4 frame version"),
    13: (ValueError, "lz4: truncated block"),
    _BAD_BLOCK_SIZE: (ValueError, "block_size must be positive"),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    found = shutil.which("cc") or shutil.which("gcc")
    if found is None:
        raise RuntimeError("no C compiler (cc or gcc) on PATH: the native codec cannot be built")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfastpoints_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CC_FLAGS, SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL:
    """The codec library, built on first call; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            _lib = _bind(ctypes.CDLL(path))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    out_len = ctypes.POINTER(ctypes.c_int64)
    lib.fp_unpack.argtypes = [p, i64, i64, i64, p, p, i32, p]
    for name in ("fp_lz4_block_decompress", "fp_lz4_frame_decompress",
                 "fp_lz4_block_compress"):
        getattr(lib, name).argtypes = [p, i64, p, i64, out_len]
    lib.fp_lz4_frame_compress.argtypes = [p, i64, i64, p, i64, p, out_len]
    for name in ("fp_unpack", "fp_lz4_block_decompress", "fp_lz4_frame_decompress",
                 "fp_lz4_block_compress", "fp_lz4_frame_compress"):
        getattr(lib, name).restype = ctypes.c_int
    lib.fp_lz4_block_bound.argtypes = [i64]
    lib.fp_lz4_frame_bound.argtypes = [i64, i64]
    lib.fp_lz4_block_bound.restype = lib.fp_lz4_frame_bound.restype = i64
    return lib


def _raise(err: int) -> None:
    exc, msg = _ERRORS.get(err, (RuntimeError, f"native codec error {err}"))
    raise exc(msg)


def _bytes_of(data) -> np.ndarray:
    """A uint8 view of a bytes-like object (no copy for bytes)."""
    return np.frombuffer(data, np.uint8)


def unpack(data, n: int, point_step: int, offsets, codes) -> np.ndarray:
    """n points of point_step bytes -> (n, len(offsets)) float32 rows; an
    offset < 0 is an absent field, a NaN column."""
    if len(offsets) != len(codes):
        raise ValueError("offsets/codes mismatch")
    if len(offsets) > MAX_FIELDS:
        raise ValueError("too many fields (max 16)")
    src = _bytes_of(data)
    offs = np.ascontiguousarray(offsets, np.int64)
    cods = np.ascontiguousarray(codes, np.int32)
    out = np.empty((n, len(offs)), np.float32)
    err = load().fp_unpack(src.ctypes.data, src.size, n, point_step, offs.ctypes.data,
                           cods.ctypes.data, len(offs), out.ctypes.data)
    if err:
        _raise(err)
    return out


def _decode(fn, data, cap: int, bounded: bool) -> bytes:
    """Runs a decoder into a buffer of `cap` bytes. `bounded`: the cap is a
    declared size, and a longer output raises; otherwise the buffer grows
    and the stream is decoded again."""
    src = _bytes_of(data)
    n = ctypes.c_int64()
    while True:
        out = np.empty(cap, np.uint8)
        err = fn(src.ctypes.data, src.size, out.ctypes.data, cap, ctypes.byref(n))
        if err == _OUTPUT_FULL and not bounded:
            cap *= 4
            continue
        if err:
            _raise(err)
        return out[: n.value].tobytes()


def lz4_block_decompress(data, max_size: int | None = None) -> bytes:
    """One LZ4 block; `max_size` bounds the output (a longer one raises)."""
    if max_size is not None:
        return _decode(load().fp_lz4_block_decompress, data, max_size, True)
    return _decode(load().fp_lz4_block_decompress, data, len(data) * 3 + 64, False)


def lz4_frame_decompress(data, hint: int | None = None) -> bytes:
    """A whole LZ4 frame. A positive `hint` (the bag chunk's declared
    uncompressed size) is the output's hard bound, as in the reference."""
    if hint is not None and hint > 0:
        return _decode(load().fp_lz4_frame_decompress, data, hint, True)
    return _decode(load().fp_lz4_frame_decompress, data, len(data) * 3 + 4096, False)


def lz4_block_compress(data) -> bytes:
    lib = load()
    src = _bytes_of(data)
    cap = lib.fp_lz4_block_bound(src.size)
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64()
    err = lib.fp_lz4_block_compress(src.ctypes.data, src.size, out.ctypes.data, cap,
                                    ctypes.byref(n))
    if err:
        _raise(err)
    return out[: n.value].tobytes()


def lz4_frame_compress(data, block_size: int = 1 << 16) -> bytes:
    lib = load()
    if block_size <= 0:  # before fp_lz4_frame_bound divides by it
        _raise(_BAD_BLOCK_SIZE)
    src = _bytes_of(data)
    cap = lib.fp_lz4_frame_bound(src.size, block_size)
    out = np.empty(cap, np.uint8)
    scratch = np.empty(lib.fp_lz4_block_bound(block_size), np.uint8)
    n = ctypes.c_int64()
    err = lib.fp_lz4_frame_compress(src.ctypes.data, src.size, block_size, out.ctypes.data,
                                    cap, scratch.ctypes.data, ctypes.byref(n))
    if err:
        _raise(err)
    return out[: n.value].tobytes()
