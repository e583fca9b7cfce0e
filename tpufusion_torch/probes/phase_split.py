"""Where the direct decode's and the corner vote's time goes, phase by phase.

    python -m tpufusion_torch.probes.phase_split [--sets 4] [--out FILE]

Builds `probes/phase_stamps.cu` once for `csrc/decode_direct.cu` and once
for `csrc/corner_vote.cu` (the kernel sources with their TF_STAMP hooks
defined), drives each through the port's own wrapper on the inputs of
`kernel_bench` (DECODE_SHAPES and CORNER_SHAPES: the live asset's
clusters, config 5's top-4, 63 rows; the corner row, the corner head on
the asset's trunk, every lane full), and reports, for every launch of a
call: its CTAs, its span on the card's global timer (first CTA's start to
last CTA's end) and, for each phase between two stamps, how many CTAs ran
it and their mean and largest time on the global timer, and their mean
SM cycles (clock64). A call is made once to warm up, then once a set with
the stamps cleared before it. The stamps add a few stores a CTA, so the
spans are the kernels' times plus that. Needs an NVIDIA GPU and nvcc; not
part of the shipped library.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))

# each kernel source's stamps: {launch: (name, [slot names in order])}; a
# phase is named by the slot that ends it
SLOTS = {
    "decode_direct.cu": {
        0: ("decode_direct", ["start", "pass 1 (the slice walked, staged, summed)",
                              "pass 1's cluster exchange", "the lane's scalars", "pass 2",
                              "the seed and the fit's set-up", "pass 3 (the gated points)",
                              "the fit", "the pick and the pose"]),
    },
    "corner_vote.cu": {
        0: ("lists", ["start", "the frame's flags", "the lanes' lists and inverted tiles"]),
        1: ("counts", ["start", "the lane's counts read", "its own tile loaded",
                       "the counts", "the counts written and the ticket", "the winners"]),
    },
}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def build(source: str) -> ctypes.CDLL:
    """The probe library for one kernel source of csrc/, bound like the
    port's own library (its C entry) plus the probe's three entries."""
    from tpufusion_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libtf_probe_{source[:-3]}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f'-DTF_PROBE_SOURCE="{source}"', "-I",
           _build.CSRC, "-shared", "-o", out, os.path.join(_HERE, "phase_stamps.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe of {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    main = _build.load()
    for name in ("tf_decode_direct", "tf_corner_vote", "tf_error_string"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = getattr(main, name).argtypes
            getattr(lib, name).restype = getattr(main, name).restype
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tf_probe_shape.argtypes = [p, p, p]
    lib.tf_probe_read.argtypes = [p, p]
    lib.tf_probe_reset.argtypes = []
    lib.tf_probe_shape.restype = lib.tf_probe_read.restype = lib.tf_probe_reset.restype = i
    return lib


def stamps(lib: ctypes.CDLL) -> tuple[np.ndarray, np.ndarray]:
    """(clock, timer), each (kernels, blocks, slots) uint64, 0 where no CTA
    reached a slot."""
    dims = [ctypes.c_int() for _ in range(3)]
    lib.tf_probe_shape(*(ctypes.byref(d) for d in dims))
    shape = tuple(d.value for d in dims)
    clock, timer = np.zeros(shape, np.uint64), np.zeros(shape, np.uint64)
    torch.cuda.synchronize()
    err = lib.tf_probe_read(clock.ctypes.data, timer.ctypes.data)
    assert err == 0, f"tf_probe_read: CUDA error {err}"
    return clock, timer


def split(source: str, runs: list[tuple[np.ndarray, np.ndarray]]) -> dict:
    """Per launch: CTAs stamped (mean a run), span (µs, mean a run), and
    per phase its CTAs (mean a run), mean and largest µs, mean cycles."""
    out = {}
    for kernel, (name, slots) in SLOTS[source].items():
        spans, ctas, phases = [], [], {}
        for clock, timer in runs:
            c, t = clock[kernel].astype(np.int64), timer[kernel].astype(np.int64)
            active = t[:, 0] > 0
            if not active.any():
                continue
            ctas.append(int(active.sum()))
            last = np.where(t > 0, t, 0).max(axis=1)
            spans.append((last[active].max() - t[active, 0].min()) / 1e3)
            for blk in np.flatnonzero(active):
                reached = np.flatnonzero(t[blk] > 0)
                for a, b in zip(reached[:-1], reached[1:]):
                    phases.setdefault(slots[b], []).append(
                        ((t[blk, b] - t[blk, a]) / 1e3, c[blk, b] - c[blk, a]))
        if not ctas:
            out[name] = {"ctas": 0}
            continue
        runs_n = len(runs)
        out[name] = {
            "ctas": sum(ctas) / runs_n, "span_us": sum(spans) / len(spans),
            "phases": {p: {"ctas": len(v) / runs_n,
                           "mean_us": float(np.mean([u for u, _ in v])),
                           "max_us": float(np.max([u for u, _ in v])),
                           "mean_cycles": float(np.mean([n for _, n in v]))}
                       for p, v in sorted(phases.items(), key=lambda kv: slots.index(kv[0]))}}
    return out


def decode_direct_split(lib, sets: int) -> list[dict]:
    from tpufusion_torch.kernel_bench import DECODE_SHAPES, decode_direct_inputs, using_library
    from tpufusion_torch.ops import decode_direct

    dev = torch.device("cuda", 0)
    rows = []
    for shape in DECODE_SHAPES:
        spec, cfg, _, args = decode_direct_inputs(dev, shape, sets)
        runs = []
        with torch.inference_mode(), using_library(lib):
            call = lambda a: decode_direct.decode_direct_clusters(  # noqa: E731
                *a, spec, cfg, cfg.direct_center)
            call(args[0])
            for a in args:
                assert lib.tf_probe_reset() == 0
                call(a)
                runs.append(stamps(lib))
        rows.append({"source": "decode_direct.cu", "shape": shape[0],
                     **split("decode_direct.cu", runs)})
    return rows


def corner_vote_split(lib, sets: int) -> list[dict]:
    from tpufusion_torch.kernel_bench import CORNER_SHAPES, corner_vote_inputs, using_library
    from tpufusion_torch.ops import corner_vote

    dev = torch.device("cuda", 0)
    rows = []
    for shape in CORNER_SHAPES:
        spec, cfg, args = corner_vote_inputs(dev, shape, sets)
        runs = []
        with torch.inference_mode(), using_library(lib):
            call = lambda a: corner_vote.corner_vote_lanes(  # noqa: E731
                *a[:5], spec, cfg, a[5])
            call(args[0])
            for a in args:
                assert lib.tf_probe_reset() == 0
                call(a)
                runs.append(stamps(lib))
        rows.append({"source": "corner_vote.cu", "shape": shape[0],
                     **split("corner_vote.cu", runs)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sets", type=int, default=4, help="distinct batches a shape")
    ap.add_argument("--kernels", default="decode_direct,corner_vote")
    ap.add_argument("--out", help="also write the card and the rows here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_split needs an NVIDIA GPU")
    card = _card()
    print(f"[{card}]")
    rows = []
    kernels = args.kernels.split(",")
    if "decode_direct" in kernels:
        rows += decode_direct_split(build("decode_direct.cu"), args.sets)
    if "corner_vote" in kernels:
        rows += corner_vote_split(build("corner_vote.cu"), args.sets)
    for r in rows:
        for name, k in r.items():
            if not isinstance(k, dict):
                continue
            if not k["ctas"]:
                print(f"{r['source']} {r['shape']}: {name}: no CTA ran")
                continue
            phases = "; ".join(f"{p} {v['mean_us']:.2f} / {v['max_us']:.2f} us, "
                               f"{v['mean_cycles']:.0f} cycles ({v['ctas']:.0f} CTAs)"
                               for p, v in k["phases"].items())
            print(f"{r['source']} {r['shape']}: {name}: {k['ctas']:.0f} CTAs, span "
                  f"{k['span_us']:.2f} us; mean / largest: {phases} [{card}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
