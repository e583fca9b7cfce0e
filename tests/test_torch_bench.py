"""`tpufusion_torch/bench.py` against the repo-root `bench.py`.

- The headline's net and step: bench.py's flagship (direct head, width 2,
  linear regression; seeded JAX init, deconv6a bias [2, -2]) carried
  across from tests/data/torch_port_golden_bench.npz, through the port's
  `make_e2e_step(head="direct")` at `DEFAULT.decode` on the golden's 4
  beam scans, against JAX's answer in float32 and bf16: `found` exactly,
  poses within POSE_ATOL (1e-4) in float32 and BF16_POSE_ATOL (1e-3) in
  bf16 (tests/torch_golden.py), the FCN's sampled foreground probability
  within FCN_PROB_ATOL (1e-5) and BF16_PROB_ATOL (2**-8), in bf16 at most
  BF16_FLAGSHIP_DIFFER_SHARE (5 %) of it off by more than 1e-6
  (tpufusion_torch/_golden.py). JAX's net marks
  no pixel at min_prob on these frames (its largest probability is
  0.24-0.36), so `found` is all False: the decode's answer on empty masks,
  and the probabilities show the distance to the threshold.
- `bench.main` on the CPU at a small size prints one JSON line with the
  reference's keys but `vs_baseline`, and no packed row.
- The live row has no fall-back: a missing asset raises.
- The bench and entry modules import no jax, and default to the card.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.make_torch_port_golden import golden_flagship_arrays
from tests.torch_golden import (
    BF16_POSE_ATOL,
    BF16_PROB_ATOL,
    FCN_PROB_ATOL,
    GOLDEN_BENCH,
    POSE_ATOL,
    REPO,
    load_npz,
    wrapped_pose_diff,
)
from tpufusion_torch import bench, entry
from tpufusion_torch._golden import BF16_FLAGSHIP_DIFFER_SHARE, flagship_prob_sample
from tpufusion_torch.config import DEFAULT, ModelConfig
from tpufusion_torch.decode.decode import heat_mask
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models.io import fcn_from_arrays
from tpufusion_torch.predict import make_e2e_step

SMALL = ["--device", "cpu", "--batch", "2", "--points", "4096", "--sets", "2"]
KEYS = {"metric", "value", "unit", "p50_latency_ms", "fps_with_live_detections",
        "fps_corner_parity_decode", "batch", "points_per_frame", "device_ms", "busy",
        "peak_device_mib", "device"}
DTYPES = {"f32": ("float32", POSE_ATOL, FCN_PROB_ATOL), "bf16": ("bfloat16", BF16_POSE_ATOL, BF16_PROB_ATOL)}


@pytest.fixture(scope="module")
def golden():
    return load_npz(GOLDEN_BENCH)


def test_golden_bench_file_is_current(golden):
    """The golden's bench.py part equals what the JAX package computes now
    (rerun tests/make_torch_port_golden.py bench if not)."""
    live = golden_flagship_arrays()
    assert sorted(live) == sorted(k for k in golden if not k.startswith("entry"))
    for k, v in live.items():
        if k.endswith("_poses"):
            np.testing.assert_allclose(golden[k], v, rtol=0, atol=1e-6, err_msg=k)
        elif "_prob" in k:  # XLA's bf16 rounding may vary by CPU
            atol = BF16_PROB_ATOL if k.startswith("flagship_bf16") else 1e-6
            np.testing.assert_allclose(golden[k], v, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(golden[k], v, err_msg=k)


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_flagship_step_matches_the_golden(golden, tag):
    dtype, pose_atol, prob_atol = DTYPES[tag]
    arrays = {k.split("/", 1)[1]: v for k, v in golden.items() if k.startswith("flagship/")}
    cfg = dataclasses.replace(DEFAULT.model, dtype=dtype, **entry.FLAGSHIP)
    model = fcn_from_arrays(arrays, cfg, device="cpu")
    poses, found = make_e2e_step(model, DEFAULT.range_view, DEFAULT.decode, head="direct",
                                 device="cpu")(golden["points"], golden["valid"])
    np.testing.assert_array_equal(found.numpy(), golden[f"flagship_{tag}_found"])
    assert wrapped_pose_diff(poses, golden[f"flagship_{tag}_poses"]).max() < pose_atol
    with torch.inference_mode():
        out = model(range_view_project_batch(
            torch.from_numpy(golden["points"]), DEFAULT.range_view, torch.from_numpy(golden["valid"])))
        heat = heat_mask(out[..., 1], DEFAULT.decode)
    prob, prob_max = flagship_prob_sample(out.numpy())
    np.testing.assert_allclose(prob, golden[f"flagship_{tag}_prob"], rtol=0, atol=prob_atol)
    if tag == "bf16":  # rounded as JAX's bf16 net, not its float32 one
        assert (np.abs(prob - golden["flagship_bf16_prob"]) > 1e-6).mean() <= BF16_FLAGSHIP_DIFFER_SHARE
    np.testing.assert_allclose(prob_max, golden[f"flagship_{tag}_prob_max"], rtol=0, atol=prob_atol)
    # as JAX's: no heat pixel, the largest probability well under min_prob
    assert not heat.any() and golden[f"flagship_{tag}_prob_max"].max() < DEFAULT.decode.min_prob


def test_bench_main_prints_one_json_line(capsys):
    bench.main(SMALL)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == KEYS  # no vs_baseline, no packed row
    assert "tpufusion_torch on cpu" in row["metric"] and row["device"] == "cpu"
    assert (row["batch"], row["points_per_frame"]) == (2, 4096)
    for k in ("value", "p50_latency_ms", "fps_with_live_detections", "fps_corner_parity_decode"):
        assert math.isfinite(row[k]) and row[k] > 0, k
    assert row["device_ms"] is None and row["busy"] is None  # the card's readings


def test_live_row_has_no_fallback(monkeypatch, tmp_path):
    """A missing detector asset raises; nothing is trained in its place."""
    monkeypatch.setattr(bench, "detector_asset_path", lambda: str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError):
        bench.run("cpu", 2, 4096, 1)


def test_headline_nets_are_the_references_geometry():
    """The headline's net is the flagship geometry in bf16 with the
    background-leaning bias; the corner row's is the default ModelConfig."""
    from tpufusion_torch.benchmarks import seeded_fcn

    flagship = seeded_fcn(dataclasses.replace(DEFAULT.model, **entry.FLAGSHIP), 0, "cpu")
    assert (flagship.cfg.head, flagship.cfg.width_multiplier, flagship.cfg.dtype) == (
        "direct", 2, "bfloat16")
    assert flagship.deconv6a.bias.tolist() == [2.0, -2.0]
    assert seeded_fcn(ModelConfig(), 0, "cpu").cfg.head == ModelConfig().head == "corner"


@pytest.mark.parametrize("module", ["tpufusion_torch.bench", "tpufusion_torch.entry"])
def test_module_imports_no_jax(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('tpufusion', 'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bench', '__graft_entry__'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("call", ["bench.run", "entry.entry"])
def test_defaults_to_the_card(call):
    """Without `device` each goes to the card and, where there is none,
    raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    fn = {"bench.run": bench.run, "entry.entry": entry.entry}[call]
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
        fn()
