"""The corner head's vote kernel (`csrc/corner_vote.cu`) on the CPU, where
it cannot run: its plain version (`decode.corner_vote_reference`)
against JAX's `corner_vote` (vmapped per lane), a numpy model of the
kernel's algorithm against the plain version on every
`parity_inputs.corner_inputs` kind at K 64 and 2048 and 32 and 63 rows,
the wrapper's dispatch, the inputs themselves, the positives map against
y_pred's flags (and bf16's comparison against JAX's), and the corner
decode, which makes that map once, against JAX's.

The model does what the kernel does, lane by lane: a lane left out gives
zeros (a frame with no voted lane is never read); the candidates are the
product of the window's positive columns and positive rows (the window
clamped to the frame; the flags from the positives map the decode hands
the kernel, `decode._positives`), slot s at column
C[s / |R|] and row R[s mod |R|], the first K; each candidate's corners
are the rotation's single rounded products and a 3-term FMA chain; sq
sums four FMA chains of 6 coordinates pairwise; each pair's Gram product
is a 24-term FMA chain over the real candidates only; the winners' box
is a float64 sum rounded once. FMAs are emulated in float64 (a float32
product is exact there).

Tolerances: the selection (each real slot's pixel, the total, overflow)
exactly; the rest is the kernel's contract with its plain version
(`tpufusion_torch/_golden.py::corner_kernel_readings`): ok and overflow
equal on every voted lane, and on the lanes whose winner set no flip of a
pair within a relative 1e-5 of a count threshold can change (decided
lanes) the winner sets equal and pose and box within 1e-4, yaw as an
angle. Undecided lanes are counted; the kinds made to have them
("duplicates", "threshold") must, and the golden frames must have none.
JAX against the plain version: the same contract (the two sum the Gram
product in other orders too).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_golden import GOLDEN_MULTI, load_npz, to_jax_config, wrapped_pose_diff
from tpufusion.decode import decode as jd
from tpufusion_torch import DecodeConfig, RangeViewSpec, _build
from tpufusion_torch._golden import (
    TALL_RES_V_DEG,
    corner_decided,
    corner_kernel_readings,
)
from tpufusion_torch.decode import decode as td
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.ops import corner_vote, parity_inputs
from tpufusion_torch.ops.label_encode import pixel_trig

F32 = np.float32
SPECS = {32: RangeViewSpec(), 63: RangeViewSpec(res_v_deg=TALL_RES_V_DEG)}
BUDGETS = (64, 2048)
_jax_vote = jax.jit(jax.vmap(jd.corner_vote, in_axes=(0, 0, 0, 0, None, None)),
                    static_argnums=(4, 5))


# ---------------------------------------------------------------------------
# the numpy model of the kernel's algorithm


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def _window(lo, hi, size):
    return int(np.clip(lo, 0, size)), int(np.clip(hi, 0, size))


def _lane(y, im, pos, box, c3, tables, spec, cfg, k):
    """One voted lane, its candidate rows and columns from the frame's
    positives map `pos` (H, W) bool: (pose, box, ok, overflow, counts
    (K,), slots (K,))."""
    h, w = y.shape[:2]
    c0, c1 = _window(box[0] - cfg.margin_x, box[2] + cfg.margin_x, w)
    r0, r1 = _window(box[1] - cfg.margin_y, box[3] + cfg.margin_y, h)
    cols = np.flatnonzero(pos.any(axis=0)[c0:c1]) + c0
    rows = np.flatnonzero(pos.any(axis=1)[r0:r1]) + r0
    total = len(cols) * len(rows)
    n_c = min(total, k)
    counts, slots = np.full(k, -1), np.full(k, -1)
    s = np.arange(n_c)
    cc, rr = cols[s // max(len(rows), 1)], rows[s % max(len(rows), 1)]
    slots[:n_c] = rr * w + cc
    ct, st, cp, sp = (t[i] for t, i in zip(tables, (cc, cc, rr, rr)))
    rot = [[ct * cp, -st, ct * sp], [st * cp, ct, st * sp], [-sp, np.zeros_like(sp), cp]]
    reg = y[rr, cc, 2:26].reshape(n_c, 8, 3)
    d, hgt = im[rr, cc, 0], im[rr, cc, 1]
    p3 = [d * ct, -(d * st), hgt]
    corners = np.zeros((n_c, 8, 3), F32)
    for i in range(3):
        acc = reg[..., 0] * rot[i][0][:, None]
        acc = _fma(reg[..., 1], rot[i][1][:, None], acc)
        acc = _fma(reg[..., 2], rot[i][2][:, None], acc)
        corners[..., i] = acc + p3[i][:, None]
    x = (corners - c3).reshape(n_c, 24)
    valid = (np.abs(corners - c3) <= np.asarray(cfg.far_delta, F32)).all(axis=(1, 2))
    parts = np.zeros((n_c, 4), F32)
    for q in range(24):  # 4 threads a candidate, 6 coordinates each
        parts[:, q // 6] = _fma(x[:, q], x[:, q], parts[:, q // 6])
    sq = (parts[:, 0] + parts[:, 1]) + (parts[:, 2] + parts[:, 3])
    gram = np.zeros((n_c, n_c), F32)
    for q in range(24):
        gram = _fma(x[:, q, None], x[None, :, q], gram)
    d2 = (sq[:, None] + sq[None, :]) - F32(2) * gram
    d2 = np.maximum(d2, F32(0))
    np.fill_diagonal(d2, 0)
    pair = (d2 > F32(1e-9)) & (d2 < F32(cfg.max_bbox_dist**2)) & valid[None, :]
    counts[:n_c] = np.where(valid, pair.sum(axis=1), -1)
    zero = (np.zeros(7, F32), np.zeros((8, 3), F32), False, total > k, counts, slots)
    if not valid.any():
        return zero
    win = counts[:n_c] == counts.max()
    bx = (corners[win].astype(np.float64).sum(axis=0).astype(F32) / F32(win.sum())).astype(F32)
    dx, dy = bx[0:4, 0] - bx[4:8, 0], bx[0:4, 1] - bx[4:8, 1]
    yaw = np.arctan2(dy, dx)
    cos_yaw = np.cos(yaw)
    big = np.abs(cos_yaw) > F32(1e-12)
    safe = np.where(big, cos_yaw, F32(1))
    box_l = np.where(big, dx / safe, dy)
    box_w = np.where(big, (bx[0:4, 1] - bx[2:6, 1]) / safe, bx[0:4, 0] - bx[2:6, 0])
    box_h = np.abs(bx[0:4, 2] - bx[1:5, 2])
    pose = np.concatenate([bx.sum(axis=0) / F32(8), [yaw.sum() / F32(4),
                          np.abs(box_l).sum() / F32(4), np.abs(box_w).sum() / F32(4),
                          box_h.sum() / F32(4)]]).astype(F32)
    return pose, bx, True, total > k, counts, slots


def model_vote(y, im, bbox, c3, lanes, spec, cfg, positives=None) -> dict:
    """The kernel's answer on numpy inputs: pose, box, ok, overflow,
    counts and slots (-1 past the real candidates), zeros on the lanes
    left out; the frames' rows and columns from `positives` (B, H, W) bool,
    as the decode hands the kernel its map (default: y's channel 1 against
    min_prob in float32). A frame with no voted lane is never read."""
    b_, n = bbox.shape[:2]
    k = min(cfg.max_candidates, y.shape[1] * y.shape[2])
    tables = [t.numpy() for t in pixel_trig(spec, "cpu")]
    if positives is None:
        positives = y[..., 1] >= F32(cfg.min_prob)
    out = {"pose": np.zeros((b_, n, 7), F32), "box": np.zeros((b_, n, 8, 3), F32),
           "ok": np.zeros((b_, n), bool), "overflow": np.zeros((b_, n), bool),
           "counts": np.full((b_, n, k), -1), "slots": np.full((b_, n, k), -1)}
    for b in range(b_):
        for j in range(n):
            if lanes[b, j]:
                got = _lane(y[b], im[b], positives[b], bbox[b, j], c3[b, j], tables, spec,
                            cfg, k)
                for key, v in zip(("pose", "box", "ok", "overflow", "counts", "slots"), got):
                    out[key][b, j] = v
    out["box_pose"] = _box_pose(out["box"])
    return out


def _box_pose(box) -> np.ndarray:
    """The plain version's pose formula on a box (B, n, 8, 3), numpy."""
    return td._corner_pose(torch.from_numpy(np.array(box, F32))).numpy()


# ---------------------------------------------------------------------------


def _plain(y, im, bbox, c3, spec, cfg):
    """The plain version with its readings, numpy: (outputs, readings)."""
    readings: dict = {}
    got = td.corner_vote_reference(*(torch.from_numpy(a) for a in (y, im, bbox, c3)), spec, cfg,
                                   readings)
    out = dict(zip(("pose", "box", "ok", "overflow"), (t.numpy() for t in got)))
    readings = {k: v.numpy() for k, v in readings.items()}
    out["counts"] = readings["counts"]
    return out, readings


_INPUTS: dict = {}


def _inputs(kind, rows):
    key = (kind, rows)
    if key not in _INPUTS:
        _INPUTS[key] = parity_inputs.corner_inputs(SPECS[rows], kind, batch=2, seed=rows)
    return _INPUTS[key]


@pytest.mark.parametrize("k", BUDGETS)
@pytest.mark.parametrize("rows", sorted(SPECS))
@pytest.mark.parametrize("kind", parity_inputs.CORNER_KINDS)
def test_kernel_model_matches_the_plain_version(kind, rows, k):
    """Every kind at both budgets and heights: the selection exactly, the
    contract on the voted lanes, zeros on the lane left out."""
    spec, cfg = SPECS[rows], DecodeConfig(max_candidates=k)
    y, im, bbox, c3, lanes = _inputs(kind, rows)
    want, readings = _plain(y, im, bbox, c3, spec, cfg)
    got = model_vote(y, im, bbox, c3, lanes, spec, cfg)
    np.testing.assert_array_equal(got["slots"][lanes], readings["slots"][lanes])
    np.testing.assert_array_equal(got["overflow"][lanes], readings["total"][lanes] > k)
    r = corner_kernel_readings(got, want, readings, lanes)
    print(f"{kind} {rows} rows K {k}: {r}, totals {readings['total'].tolist()}")
    assert r["ok"], r
    assert r["lanes"] == lanes.sum() and not lanes.all()
    if kind in ("duplicates", "threshold"):
        assert r["undecided"] > 0  # made to sit on a threshold
    decided = corner_decided(*(readings[k] for k in ("counts", "undecided", "near_undecided")))
    if kind == "ties":  # the tied groups sit far from both thresholds
        assert decided[:, :2].all()
    if kind == "far":  # no candidate of the second lane is valid
        assert decided[:, 1].all() and not want["ok"][:, 1].any()


def test_budget_totals_and_overflow():
    """"budget" puts 0, 64, 65, 2048 and 2049 candidates in its lanes:
    K 64 overflows from 65 on, K 2048 only at 2049; a lane with none is
    not ok."""
    for rows in sorted(SPECS):
        y, im, bbox, c3, lanes = _inputs("budget", rows)
        for k in BUDGETS:
            want, readings = _plain(y, im, bbox, c3, SPECS[rows], DecodeConfig(max_candidates=k))
            assert (readings["total"] == [0, 64, 65, 2048, 2049]).all()
            np.testing.assert_array_equal(want["overflow"], readings["total"] > k)
            assert not want["ok"][:, 0].any() and want["ok"][:, 1:].all()


def test_edges_clip_the_windows_at_the_frame():
    """"edges" windows reach past column 0 and W - 1 and row 0 and H - 1;
    their candidates touch those borders and never wrap."""
    for rows in sorted(SPECS):
        spec = SPECS[rows]
        y, im, bbox, c3, lanes = _inputs("edges", rows)
        _, readings = _plain(y, im, bbox, c3, spec, DecodeConfig())
        slots = readings["slots"]
        cols, rws = slots % spec.width, slots // spec.width
        real = slots >= 0
        assert (cols[:, 0][real[:, 0]] == 0).any() and (cols[:, 1][real[:, 1]] == spec.width - 1).any()
        assert (rws[:, 2][real[:, 2]] == 0).any() and (rws[:, 3][real[:, 3]] == rows - 1).any()
        assert cols[:, 0][real[:, 0]].max() < 130 and cols[:, 1][real[:, 1]].min() >= spec.width - 130


def test_ties_average_every_tied_group():
    """"ties": two and three equal groups tie (every member a winner), so
    the box is the mean of the groups; the third lane has one group."""
    y, im, bbox, c3, lanes = _inputs("ties", 32)
    _, readings = _plain(y, im, bbox, c3, SPECS[32], DecodeConfig())
    counts, real = readings["counts"], readings["slots"] >= 0
    for j, groups in ((0, 2), (1, 3)):
        size = real[:, j].sum(axis=1) // groups
        assert (counts[:, j] == np.where(real[:, j], size[:, None] - 1, -1)).all()
    assert (real[:, :2].sum(axis=-1) % 6 == 0).all()


# JAX's corner_vote, vmapped per lane as decode_batch runs it, against the
# plain version


def _jax_lanes(y, im, bbox, c3, cfg, spec):
    b_, n = bbox.shape[:2]
    frame = np.repeat(np.arange(b_), n)
    pose, box, ok, over = _jax_vote(jnp.asarray(y[frame]), jnp.asarray(im[frame]),
                                    jnp.asarray(bbox.reshape(-1, 4).astype(np.int32)),
                                    jnp.asarray(c3.reshape(-1, 3)), to_jax_config(spec),
                                    to_jax_config(cfg))
    return {"pose": np.asarray(pose).reshape(b_, n, 7), "box": np.asarray(box).reshape(b_, n, 8, 3),
            "ok": np.asarray(ok).reshape(b_, n), "overflow": np.asarray(over).reshape(b_, n)}


@pytest.mark.parametrize("k", BUDGETS)
@pytest.mark.parametrize("kind", ["budget", "ties", "far", "edges"])
def test_plain_version_matches_jax(kind, k):
    spec, cfg = SPECS[32], DecodeConfig(max_candidates=k)
    y, im, bbox, c3, _ = _inputs(kind, 32)
    want, readings = _plain(y, im, bbox, c3, spec, cfg)
    got = _jax_lanes(y, im, bbox, c3, cfg, spec)
    got["counts"] = readings["counts"]  # JAX keeps its counts: held through pose and box
    got["box_pose"] = _box_pose(got["box"])
    r = corner_kernel_readings(got, want, readings, np.ones(bbox.shape[:2], bool))
    print(f"JAX {kind} K {k}: {r}")
    assert r["ok"], r


@pytest.fixture(scope="module")
def golden_frames():
    """The multi golden's label-encoded corner outputs and their images."""
    gm = load_npz(GOLDEN_MULTI)
    images = range_view_project_batch(torch.from_numpy(gm["multi_points"][:2]), SPECS[32],
                                      torch.from_numpy(gm["multi_valid"][:2]))
    return torch.from_numpy(gm["corner_ypred"]), images


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("k", BUDGETS)
def test_golden_corner_frames(golden_frames, k, n):
    """decode_batch's lanes (n = 1) and decode_batch_multi's (n = 4) on the
    golden's corner frames: the plain version against JAX and the model
    against the plain version, every lane decided."""
    y, images = golden_frames
    spec, cfg = SPECS[32], DecodeConfig(max_candidates=k)
    bbox, c3, stage2 = corner_vote.corner_lanes(y, images, spec, cfg, n)
    args = [t.numpy() for t in (y, images, bbox, c3)]
    want, readings = _plain(*args, spec, cfg)
    lanes = stage2.numpy()
    assert lanes.any()
    jax_out = _jax_lanes(*args, cfg, spec)
    jax_out["counts"] = readings["counts"]
    jax_out["box_pose"] = _box_pose(jax_out["box"])
    for name, got in (("JAX", jax_out), ("model", model_vote(*args, lanes, spec, cfg))):
        r = corner_kernel_readings(got, want, readings, lanes)
        print(f"{name} golden K {k} n {n}: {r}")
        assert r["ok"] and r["undecided"] == 0, (name, r)


# the wrapper


def test_a_cpu_tensor_never_reaches_the_build(golden_frames, monkeypatch):
    """On CPU tensors the wrapper is the plain version bit for bit, with
    every lane voted, and never asks for the kernel library."""
    def refuse():
        raise AssertionError("the CPU path asked for the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    y, images = golden_frames
    spec, cfg = SPECS[32], DecodeConfig()
    bbox, c3, stage2 = corner_vote.corner_lanes(y, images, spec, cfg, 4)
    before = corner_vote.LAUNCHES
    got = corner_vote.corner_vote_lanes(y, images, bbox, c3, stage2, spec, cfg)
    want = td.corner_vote_reference(y, images, bbox, c3, spec, cfg)
    public = td.corner_vote(y, images, bbox, c3, spec, cfg)
    for g, p, w in zip(got, public, want):
        assert torch.equal(g, w) and torch.equal(p, w)
    out = td.decode_batch(y, images, spec, cfg)
    assert corner_vote.LAUNCHES == before and bool(out["found"].all())


def test_bf16_outputs_are_read_in_float32(golden_frames):
    """A bf16 corner output gives the plain version's answer on its float32
    copy: the wrapper converts it as the plain version reads it."""
    y, images = golden_frames
    spec, cfg = SPECS[32], DecodeConfig()
    yb = y.to(torch.bfloat16)
    bbox, c3, stage2 = corner_vote.corner_lanes(yb.float(), images, spec, cfg, 1)
    got = corner_vote.corner_vote_lanes(yb, images, bbox, c3, stage2, spec, cfg)
    want = td.corner_vote_reference(yb.float(), images, bbox, c3, spec, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_wrapper_has_no_fallback():
    """A tensor neither on the CPU nor on the card raises instead of
    running the plain version; the launch path holds no try, and builds
    the library before it launches (a failed build raises: the card's
    test makes it fail)."""
    spec, cfg = SPECS[32], DecodeConfig()
    y = torch.zeros((1, 32, 1801, 26), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        corner_vote.corner_vote_lanes(y, y[..., :3], torch.zeros((1, 1, 4), dtype=torch.long),
                                      torch.zeros((1, 1, 3)), None, spec, cfg)
    path = os.path.join(os.path.dirname(corner_vote.__file__), "corner_vote.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree))
    launch = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                  and n.name == "launch")
    calls = [ast.unparse(n.func) for n in ast.walk(launch) if isinstance(n, ast.Call)]
    assert "_build.load" in calls and "_build.check" in calls


def test_the_decode_votes_only_the_stage2_lanes(golden_frames, monkeypatch):
    """decode_batch and decode_batch_multi hand the wrapper stage 2 as the
    lanes to vote; the public corner_vote votes every lane."""
    seen = []
    wrapper = td.corner_vote_lanes
    monkeypatch.setattr(td, "corner_vote_lanes", lambda *a: seen.append(a[4]) or wrapper(*a))
    y, images = golden_frames
    spec, cfg = SPECS[32], DecodeConfig()
    td.decode_batch(y, images, spec, cfg)
    td.decode_batch_multi(y, images, spec, cfg, 4)
    bbox, c3, stage2 = corner_vote.corner_lanes(y, images, spec, cfg, 4)
    td.corner_vote(y, images, bbox, c3, spec, cfg)
    assert seen[0].shape == (2, 1) and torch.equal(seen[1], stage2) and seen[2] is None
    assert bool(stage2[:, 0].all()) and not bool(stage2[:, 2:].any())


# the positives map the decode hands the kernel


def _frames(source, rows):
    """(y (B, H, W, 26) float32, image) of the golden corner frames (32
    rows) or a `corner_inputs` kind, numpy."""
    if source == "golden":
        gm = load_npz(GOLDEN_MULTI)
        images = range_view_project_batch(torch.from_numpy(gm["multi_points"][:2]), SPECS[32],
                                          torch.from_numpy(gm["multi_valid"][:2]))
        return gm["corner_ypred"], images.numpy()
    y, im, *_ = _inputs(source, rows)
    return y, im


FLAG_CASES = [("golden", 32)] + [(kind, rows) for kind in parity_inputs.CORNER_KINDS
                                 for rows in sorted(SPECS)]


@pytest.mark.parametrize("source, rows", FLAG_CASES)
def test_the_positives_map_gives_the_flags_of_y_pred(source, rows):
    """The map the corner decode makes once (`decode._positives`, the
    comparison its heat mask stamps from) gives every frame the row and
    column flags the plain version takes from y_pred's channel 1, and the
    model fed the map votes what the plain version votes."""
    y, im = _frames(source, rows)
    cfg = DecodeConfig()
    pos = td._positives(torch.from_numpy(y[..., 1]), cfg).numpy()
    want = y[..., 1] >= F32(cfg.min_prob)
    np.testing.assert_array_equal(pos, want)
    np.testing.assert_array_equal(pos.any(axis=1), want.any(axis=1))  # columns
    np.testing.assert_array_equal(pos.any(axis=2), want.any(axis=2))  # rows
    if source != "golden":
        _, _, bbox, c3, lanes = _inputs(source, rows)
        got = model_vote(y, im, bbox, c3, lanes, SPECS[rows], cfg, pos)
        plain, readings = _plain(y, im, bbox, c3, SPECS[rows], cfg)
        r = corner_kernel_readings(got, plain, readings, lanes)
        assert r["ok"], r


@pytest.mark.parametrize("min_prob", [0.5, 0.7, 0.8])
def test_a_bf16_map_compares_in_bf16_as_jax(golden_frames, min_prob):
    """From a bf16 output the map compares in bf16, as JAX's vote and heat
    mask do (0.7 rounds down in bf16, so a value at its rounding passes);
    the plain version votes on that map and reads the regressions in
    float32."""
    y, images = golden_frames
    yb = y.to(torch.bfloat16)
    yb[0, 5, 100:110, 1] = torch.tensor(min_prob, dtype=torch.bfloat16)  # at the threshold
    cfg = DecodeConfig(min_prob=min_prob)
    pos = td._positives(yb[..., 1], cfg).numpy()
    np.testing.assert_array_equal(pos, np.asarray(jnp.asarray(yb.float().numpy()).astype(
        jnp.bfloat16)[..., 1] >= min_prob))
    spec = SPECS[32]
    bbox, c3, _ = corner_vote.corner_lanes(yb.float(), images, spec, cfg, 1)
    got = td.corner_vote_reference(yb, images, bbox, c3, spec, cfg)
    model = model_vote(yb.float().numpy(), images.numpy(), bbox.numpy(), c3.numpy(),
                       np.ones(bbox.shape[:2], bool), spec, cfg, pos)
    readings: dict = {}
    td.corner_vote_reference(yb, images, bbox, c3, spec, cfg, readings)
    want = dict(zip(("pose", "box", "ok", "overflow"), (t.numpy() for t in got)))
    want["counts"] = readings["counts"].numpy()
    r = corner_kernel_readings(model, want, {k: v.numpy() for k, v in readings.items()},
                               np.ones(bbox.shape[:2], bool))
    assert r["ok"], r


@pytest.mark.parametrize("kind", ["ties", "edges", "random"])
def test_a_frame_with_no_voting_lane_gives_zeros(kind):
    """A frame none of whose lanes votes (the kernel's lists launch skips
    it, reading nothing) comes out zeros and False; its neighbour's lanes
    vote as the plain version does, on its own map."""
    y, im, bbox, c3, lanes = _inputs(kind, 32)
    lanes = lanes.copy()
    lanes[-1] = False
    y_bad = y.copy()
    y_bad[-1] = np.nan  # never read
    cfg = DecodeConfig()
    pos = td._positives(torch.from_numpy(y[..., 1]), cfg).numpy()
    got = model_vote(y_bad, im, bbox, c3, lanes, SPECS[32], cfg, pos)
    assert not (got["pose"][-1].any() or got["box"][-1].any() or got["ok"][-1].any()
                or got["overflow"][-1].any())
    plain, readings = _plain(y, im, bbox, c3, SPECS[32], cfg)
    r = corner_kernel_readings(got, plain, readings, lanes)
    assert r["ok"] and r["lanes"] == int(lanes.sum()), r


_jax_decode_batch = jax.jit(jd.decode_batch, static_argnums=(2, 3))
_jax_decode_multi = jax.jit(jd.decode_batch_multi, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("k", BUDGETS)
@pytest.mark.parametrize("fn", ["decode_batch", "decode_batch_multi", "corner_vote"])
def test_the_restructured_corner_decode_matches_jax(golden_frames, fn, k):
    """decode_batch and decode_batch_multi, which make the positives map
    once and hand it from the heat mask to the vote, and the public
    corner_vote, which makes it itself, against JAX's decode_batch,
    decode_batch_multi and corner_vote on the golden corner frames, with a
    third frame whose probabilities are all below min_prob (no cluster, no
    voting lane)."""
    y, images = golden_frames
    y = torch.cat([y, y[:1]])
    y[2, ..., 1] = 0.1
    images = torch.cat([images, images[:1]])
    spec, cfg = SPECS[32], DecodeConfig(max_candidates=k)
    jy, ji = jnp.asarray(y.numpy()), jnp.asarray(images.numpy())
    if fn == "corner_vote":
        bbox, c3, _ = corner_vote.corner_lanes(y, images, spec, cfg, 4)
        got = dict(zip(("pose", "box", "ok", "overflow"),
                       (t.numpy() for t in td.corner_vote(y, images, bbox, c3, spec, cfg))))
        want = _jax_lanes(y.numpy(), images.numpy(), bbox.numpy(), c3.numpy(), cfg, spec)
        np.testing.assert_array_equal(got["ok"], want["ok"])
        np.testing.assert_array_equal(got["overflow"], want["overflow"])
        ok = got["ok"]
        np.testing.assert_allclose(got["box"][ok], want["box"][ok], rtol=0, atol=1e-3)
        assert float(np.abs(wrapped_pose_diff(got["pose"][ok], want["pose"][ok])).max(
            initial=0)) <= 1e-3
        return
    if fn == "decode_batch":
        got = td.decode_batch(y, images, spec, cfg)
        want = _jax_decode_batch(jy, ji, to_jax_config(spec), to_jax_config(cfg))
        poses, key = "pose", "pose"
    else:
        got = td.decode_batch_multi(y, images, spec, cfg, 4)
        want = _jax_decode_multi(jy, ji, to_jax_config(spec), to_jax_config(cfg), 4)
        poses, key = "poses", "poses"
    np.testing.assert_array_equal(got["found"].numpy(), np.asarray(want["found"]))
    np.testing.assert_array_equal(got["vote_overflow"].numpy(), np.asarray(want["vote_overflow"]))
    assert not got["found"][2].any() and not got[poses][2].any()
    diff = wrapped_pose_diff(got[key].numpy(), np.asarray(want[key]))
    assert float(diff.max()) <= 1e-3, float(diff.max())


# the inputs


@pytest.mark.parametrize("kind", parity_inputs.CORNER_KINDS)
def test_corner_inputs_are_seeded_and_shaped(kind):
    for rows in sorted(SPECS):
        spec = SPECS[rows]
        a = parity_inputs.corner_inputs(spec, kind, batch=2, seed=7)
        b = parity_inputs.corner_inputs(spec, kind, batch=2, seed=7)
        c = parity_inputs.corner_inputs(spec, kind, batch=2, seed=8)
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x, z)
        assert not np.array_equal(a[0], c[0])
        y, im, bbox, c3, lanes = a
        n = bbox.shape[1]
        assert y.shape == (2, rows, spec.width, 26) and y.dtype == np.float32
        assert im.shape == (2, rows, spec.width, 3) and im.dtype == np.float32
        assert bbox.shape == (2, n, 4) and bbox.dtype == np.int64
        assert c3.shape == (2, n, 3) and c3.dtype == np.float32
        assert lanes.shape == (2, n) and lanes.dtype == bool and not lanes[1, 0] and lanes[0].all()
        assert y.flags.c_contiguous and np.isfinite(y).all()
    with pytest.raises(ValueError, match="unknown corner kind"):
        parity_inputs.corner_inputs(SPECS[32], "polygon")


def test_decided_lanes_follow_the_counts():
    """corner_decided on hand-made counts: a lone winner stays while its
    count less its undecided pairs beats every other's count plus theirs;
    tied winners only with no undecided pair; a near test that could flip
    leaves a lane undecided."""
    counts = np.array([[[5, 3, -1, 2]], [[5, 4, 1, 0]], [[5, 5, 2, -1]], [[5, 5, 2, -1]],
                       [[-1, -1, -1, -1]]])
    undec = np.array([[[1, 0, 0, 1]], [[1, 1, 0, 0]], [[0, 0, 1, 0]], [[1, 1, 0, 0]],
                      [[0, 0, 0, 0]]])
    none = np.zeros(counts.shape, bool)
    np.testing.assert_array_equal(corner_decided(counts, undec, none)[:, 0],
                                  [True, False, True, False, True])
    near = none.copy()
    near[0, 0, 2] = True
    np.testing.assert_array_equal(corner_decided(counts, undec, near)[:, 0],
                                  [False, False, True, False, True])


@pytest.mark.parametrize("yaw, sensitive", [(0.3, False), (2.0, False), (np.pi / 2 - 1e-4, True),
                                            (1e-7, True)])
def test_pose_sensitive_lanes(yaw, sensitive):
    """A 4.2 x 1.6 x 1.5 box 20 m out: its pose moves past half the
    tolerance under a float32 step of its box only where l and w divide
    by a cos(yaw) near 0 or an atan2 sits on its branch cut."""
    box = torch.from_numpy((parity_inputs._box_corners(yaw) + [20.0, -5.0, 0.5]).astype(F32))
    assert bool(td._pose_moves(box, td._corner_pose(box))) == sensitive
