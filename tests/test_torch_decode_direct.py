"""The direct head's per-cluster decode kernel (`csrc/decode_direct.cu`)
on the CPU, where it cannot run: a numpy model of its walk, held against
its plain version (`decode.decode_direct_clusters_reference`) and against
JAX's `decode_batch_direct`, on the JAX FCN's outputs of two-vehicle and
ellipse frames at 32 and 64-beam 63 rows; the integer key of its
back-projection argmin; and the wrapper's dispatch (a CPU tensor never
reaches the build, "silhouette" goes to the plain version by name).

The model does what the kernel does, lane by lane: a lane that
`_topk_roots` did not find gives zeros; a found lane walks only its root's
CC extents in raster order; its sums are float64 sums of the plain
version's float32 terms, rounded once; the back-projection takes the min
of dx^2 + dy^2 packed with the flat index into 64 bits; the fit runs every
candidate heading of the arm the yaw gate picked on the gated points.

Tolerances: the kernel's contract with its plain version
(`tpufusion_torch/_golden.py::direct_kernel_readings`): `found` exactly;
poses within 1e-4, yaw as an angle, and 1e-3 only on the adversarial
clusters' lanes whose bbox window holds more than 4,096 pixels (the plain
version and the model sum in another order). A lane whose plain version sits within 1e-5 of a
threshold a tie could flip (the plain version's `margins`) would be
exempt; on these inputs there must be none.

A bf16 head output (the FCN outputs rounded to bf16): the plain version
against JAX's decode of the same bf16 array (found, output dtypes, poses
within POSE_TOL, 1e-3, yaw as an angle), at 32 rows against the committed
bf16 golden (`tests/data/torch_port_golden_bf16.npz`) and at 63 rows
against JAX run here; the model, with the bf16 rounding points the kernel
has, against the plain version under the same contract as float32 (a sum
near a bf16 rounding midpoint would be exempt; none may be); and a
probability of exactly bf16(0.7) at min_prob 0.7.

A float16 head output likewise, at F16_POSE_TOL (1e-4) against JAX: at 32
rows against the float16 golden (`tests/data/torch_port_golden_f16.npz`,
every kernel center and silhouette, k 2 and 1), at 63 rows against JAX run
here; the model with float16's rounding points (bf16's, and each op of two
float16 values) against the plain version, and with bf16's points alone
failing it; float16(0.8) at min_prob 0.8; and the float16 midpoint margin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_golden import (
    ASSETS,
    GOLDEN_BF16,
    GOLDEN_F16,
    GOLDEN_MULTI,
    MIXED_ASSET,
    asset_configs,
    jax_asset_model,
    jax_forward,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.decode import decode as jd
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion_torch import DecodeConfig, RangeViewSpec, _build
from tpufusion_torch._golden import (
    BF16_DECODE_CASES,
    BF16_DECODE_FCNS,
    BF16_DECODE_K,
    F16_DECODE_CASES,
    F16_DECODE_K,
    TALL_BEAMS,
    TALL_RES_V_DEG,
    bf16_decode_case,
    direct_kernel_readings,
    direct_margins,
    from_bf16_bits,
    from_f16_bits,
    load_npz,
)
from tpufusion_torch._precision import bf16_round, f16_round, low_round
from tpufusion_torch.data.synthetic import synthesize_beam_multi_vehicle_batch
from tpufusion_torch.decode import decode as td
from tpufusion_torch.ops import decode_direct, parity_inputs
from tpufusion_torch.ops.label_encode import pixel_trig
from tpufusion_torch.ops.libm_f32 import sqrt_f32

F32 = np.float32
BF16 = torch.bfloat16
F16 = torch.float16
POSE_TOL = 1e-3  # the port against JAX on a bf16 head output
F16_POSE_TOL = 1e-4  # ... on a float16 head output (reads 3e-6 at 32 rows)
SPECS = {32: RangeViewSpec(), 63: RangeViewSpec(res_v_deg=TALL_RES_V_DEG)}
_jax_decode = jax.jit(jd.decode_batch_direct, static_argnums=(2, 3, 4))


@pytest.fixture(scope="module")
def inputs():
    """{rows: {"images", "asset", "mixed", "asset_bf16", "mixed_bf16",
    "asset_f16", "mixed_f16"}}: two frames a height (a two-vehicle frame
    and an ellipse frame of the multi golden at 32 rows, the bf16 golden's
    frames; two two-vehicle 64-beam scans at 63), JAX's images and the
    shipped and mixed assets' JAX FCN outputs, and those rounded to bf16
    and to float16 (float32 arrays)."""
    with np.load(GOLDEN_MULTI) as z:
        pts32 = np.concatenate([z["multi_points"][:1], z["ell_points"][:1]])
        valid32 = np.concatenate([z["multi_valid"][:1], z["ell_valid"][:1]])
    pts63, _, valid63 = synthesize_beam_multi_vehicle_batch(
        np.random.default_rng(61), 2, 32768, n_vehicles=2, n_beams=TALL_BEAMS)
    out = {}
    for rows, pts, valid in ((32, pts32, valid32), (63, pts63, valid63)):
        images = np.array(range_view_project_batch(
            jnp.asarray(pts), to_jax_config(SPECS[rows]), jnp.asarray(valid)))
        out[rows] = {"images": images,
                     "asset": jax_forward(jax_asset_model(), images),
                     "mixed": jax_forward(jax_asset_model(MIXED_ASSET), images)}
        for fcn in ("asset", "mixed"):
            out[rows][f"{fcn}_bf16"] = bf16_round(out[rows][fcn])
            out[rows][f"{fcn}_f16"] = f16_round(out[rows][fcn])
    return out


def _asset(**change):
    return dataclasses.replace(asset_configs()[1], **change)


def _mixed(**change):
    return dataclasses.replace(asset_configs(MIXED_ASSET)[1], **change)


# (config, FCN) for every center, boundary and yaw frame the kernel
# covers; "auto" yaw needs the mixed asset's dual-codec head
CASES = {
    "backproject_local": (lambda: DecodeConfig(), "asset"),
    "backproject_global": (lambda: _asset(direct_center="backproject"), "asset"),
    "backproject_auto": (lambda: _mixed(direct_center="backproject"), "mixed"),
    "geometric_global": (lambda: _asset(direct_center="geometric"), "asset"),
    "geometric_auto": (lambda: _mixed(direct_center="geometric"), "mixed"),
    "surface_local": (lambda: _asset(direct_center="surface", direct_yaw_frame="local"), "asset"),
    "consensus_global": (lambda: _asset(direct_center="consensus"), "asset"),
    "consensus_auto": (lambda: _mixed(direct_center="consensus"), "mixed"),
    "head_global": (lambda: _asset(direct_center="head"), "asset"),
    "head_local": (lambda: _asset(direct_center="head", direct_yaw_frame="local"), "asset"),
    "fit_circle_global": (lambda: _asset(), "asset"),
    "fit_circle_auto": (lambda: _mixed(fit_boundary="circle"), "mixed"),
    "fit_ellipse_local": (lambda: _asset(fit_boundary="ellipse", fit_surface_scale=0.9,
                                         direct_yaw_frame="local"), "asset"),
    "fit_box_global": (lambda: _asset(fit_boundary="box", fit_surface_scale=1.0), "asset"),
    "fit_auto_auto": (lambda: _mixed(), "mixed"),
    "fit_auto_box_global": (lambda: _mixed(fit_boundary_oriented="box",
                                           direct_yaw_frame="global"), "mixed"),
}
# the shipped assets' operating points and DecodeConfig's default, also
# against JAX
JAX_CASES = ("backproject_local", "fit_circle_global", "fit_ellipse_local", "fit_auto_auto")


# ---------------------------------------------------------------------------
# the numpy model of the kernel's walk


def _floor_mod(x, y):
    r = np.fmod(F32(x), F32(y))
    return F32(r + F32(y)) if (r != 0 and (r < 0) != (y < 0)) else r


def _sum(v) -> np.float32:
    """The kernel's sum: float64 over float32 terms, rounded once."""
    return F32(np.sum(np.asarray(v, np.float32).astype(np.float64)))


def _push(xyz, yaw, l_, w_):
    x, y = F32(xyz[0]), F32(xyz[1])
    d = F32(np.arctan2(y, x) - yaw)
    p = F32(F32(0.5) * F32(l_ * np.abs(np.cos(d)) + w_ * np.abs(np.sin(d))))
    rho = F32(np.sqrt(F32(x * x + y * y)))
    scale = F32((rho + p) / max(rho, F32(1e-6)))
    return np.array([x * scale, y * scale, xyz[2]], F32)


def _fit(px, py, seed, yaw, l_, w_, boundary, scale, grid):
    """The fit of one lane's gated points: every candidate at once, as the
    kernel's warps run them. Returns (center (3,), yaw)."""
    diag = F32(np.sqrt(F32(l_ * l_ + w_ * w_)))
    head_phi = _floor_mod(yaw, np.pi)
    if boundary == "circle":
        a = b = max(F32(F32(scale * 0.5) * diag), F32(1e-2))
        phis = np.array([head_phi], F32)
    else:
        a = max(F32(F32(F32(scale) * l_) * F32(0.5)), F32(1e-2))
        b = max(F32(F32(F32(scale) * w_) * F32(0.5)), F32(1e-2))
        phis = np.append(grid, head_phi).astype(F32)
    n = len(px)
    nw = max(F32(n), F32(1e-6))
    lam = F32(F32(0.08) * nw)
    c, s = np.cos(phis)[:, None], np.sin(phis)[:, None]
    sx, sy = F32(seed[0]), F32(seed[1])
    mx = np.full(len(phis), sx, F32)
    my = np.full(len(phis), sy, F32)

    def residual(mx, my):
        dx, dy = px[None] - mx[:, None], py[None] - my[:, None]
        u = c * dx + s * dy
        v = -s * dx + c * dy
        if boundary == "box":
            su, sv = np.abs(u) / a, np.abs(v) / b
            r = np.maximum(su, sv) - F32(1)
            act = su >= sv
            gu = np.where(act, np.sign(u) / a, F32(0))
            gv = np.where(act, F32(0), np.sign(v) / b)
        else:
            vx, vy = u / a, v / b
            r = vx * vx + vy * vy - F32(1)
            gu, gv = F32(2) * vx / a, F32(2) * vy / b
        return r, -(c * gu - s * gv), -(s * gu + c * gv)

    def sums(v):
        return v.astype(np.float64).sum(axis=1).astype(F32)

    for _ in range(4):
        r, jx, jy = residual(mx, my)
        jxx, jxy, jyy = sums(jx * jx) + lam, sums(jx * jy), sums(jy * jy) + lam
        bx = sums(jx * r) + lam * (mx - sx)
        by = sums(jy * r) + lam * (my - sy)
        det = jxx * jyy - jxy * jxy
        mx, my = mx - (jyy * bx - jxy * by) / det, my - (jxx * by - jxy * bx) / det
    r, _, _ = residual(mx, my)
    ress = sums(r * r) / nw
    i = int(np.argmin(ress))
    decisive = ress[i] < F32(0.9) * ress[-1]
    j = i if decisive else len(phis) - 1
    ctr, phi = np.array([mx[j], my[j]], F32), phis[j]
    cand = np.array([phi, phi + F32(np.pi), phi - F32(np.pi)], F32)
    off = np.array([abs(_floor_mod(F32(F32(q - yaw) + F32(np.pi)), 2 * np.pi) - F32(np.pi))
                    for q in cand], F32)
    phi = cand[int(np.argmin(off))]
    dc = ctr - seed[:2]
    if n >= 5 and F32(dc[0] * dc[0] + dc[1] * dc[1]) <= F32(4.0):
        return np.array([ctr[0], ctr[1], seed[2]], F32), phi
    return seed, yaw


def _model_lane(y_pred, images, mask, labels, ext, b, r, spec, cfg, center, tables, low):
    """One found lane: (pose (7,) or None when not found, window pixels).
    `low`: y_pred holds a head output of that type (torch.bfloat16 or
    torch.float16; None for float32), rounded where the kernel's instance
    for it rounds (`keep`, and for float16 `op`)."""
    cos_t, sin_t, cos_p, sin_p, grid = tables

    def keep(v):
        if not low:
            return F32(v)
        r = low_round(v, low)
        return r[0] if np.ndim(v) == 0 else r.reshape(np.shape(v))

    def op(v):  # an op of two float16 values runs in float16
        return keep(v) if low == F16 else F32(v)

    tiny = keep(1e-6) if low == F16 else F32(1e-6)

    w_img = y_pred.shape[2]
    ry, rx = divmod(int(r), w_img)
    x0, x1, y0, y1 = (int(e[b, ry, rx]) for e in ext)
    ys, xs = (a.ravel() for a in np.mgrid[y0:y1 + 1, x0:x1 + 1])  # raster order
    d, hh = images[b, ys, xs, 0], images[b, ys, xs, 1]
    yp = y_pred[b, ys, xs]
    valid = (d > 0) & (hh > F32(spec.min_height))
    cluster = mask[b, ys, xs] & (labels[b, ys, xs] == r)
    assert cluster.sum() == (mask[b] & (labels[b] == r)).sum(), "a cluster pixel outside its window"
    cv = cluster & valid
    m = cv & (yp[:, 1] >= keep(cfg.min_prob))
    if not m.any():
        return None, len(xs)
    wgt = yp[m, 1]
    tot = max(keep(_sum(wgt)), tiny)
    lwh = np.array([op(keep(_sum(op(yp[m, 5 + i] * wgt))) / tot) for i in range(3)], F32)
    ct, st = cos_t[xs[m]], sin_t[xs[m]]
    local = (_sum((yp[m, 8] * ct - yp[m, 9] * st) * wgt) / tot,
             _sum((yp[m, 9] * ct + yp[m, 8] * st) * wgt) / tot)
    gi = 10 if y_pred.shape[-1] >= 12 else 8
    glob = tuple(op(keep(_sum(op(yp[m, c] * wgt))) / tot) for c in (gi, gi + 1))
    if cfg.direct_yaw_frame == "local":
        oriented, (sin_m, cos_m) = True, local
    elif cfg.direct_yaw_frame == "global":  # the quotients enter the atan2 rounded
        oriented, (sin_m, cos_m) = False, (keep(glob[0]), keep(glob[1]))
    else:
        len_g = op(F32(keep(keep(glob[0]) ** 2) + keep(keep(glob[1]) ** 2)))
        oriented = F32(local[0] ** 2 + local[1] ** 2) >= len_g
        sin_m, cos_m = local if oriented else glob
    yaw = F32(np.arctan2(sin_m, cos_m))
    if cfg.direct_yaw_frame == "global":
        yaw = keep(yaw)
    p = np.stack([d * cos_t[xs], -d * sin_t[xs], hh], axis=-1)
    if center == "head":
        cp, sp = cos_p[ys[m]], sin_p[ys[m]]
        rot = np.stack([np.stack([ct * cp, -st, ct * sp], -1),
                        np.stack([st * cp, ct, st * sp], -1),
                        np.stack([-sp, np.zeros_like(sp), cp], -1)], -2)
        c_px = (rot @ yp[m, 2:5, None])[..., 0] + p[m]
        c_phys = np.array([_sum(c_px[:, i] * wgt) / tot for i in range(3)], F32)
        c, s = F32(np.cos(-yaw)), F32(np.sin(-yaw))
        if cfg.direct_yaw_frame == "global":  # of the head-typed yaw
            c, s = op(c), op(s)
        ctr = np.array([c * c_phys[0] - s * c_phys[1], s * c_phys[0] + c * c_phys[1],
                        c_phys[2]], F32)
        return np.concatenate([ctr, [yaw], lwh]).astype(F32), len(xs)
    msurf = m & (d <= F32(d[m].min() + F32(4.0)))
    ws = max(keep(_sum(wgt[msurf[m]])), tiny)
    p_mean = np.array([_sum(p[msurf, i] * yp[msurf, 1]) / ws for i in range(3)], F32)
    if center != "surface":  # the back-projection: the packed integer argmin
        cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
        inw = valid & (xs >= x0 + 2) & (xs <= x1 - 2) & (ys >= y0 + 2) & (ys <= y1 - 2)
        keys = (((xs - cx) ** 2 + (ys - cy) ** 2).astype(np.int64) << 32) | (ys * w_img + xs)
        nx, ny = cx, cy
        ok_c = images[b, cy, cx, 0] > 0 and images[b, cy, cx, 1] > F32(spec.min_height)
        if not ok_c and x0 + 2 != 0 and x1 - 2 != 0:
            if inw.any():
                ny, nx = divmod(int(keys[inw].min() & 0xFFFFFFFF), w_img)
            else:
                nx = ny = 0
        if nx == 0 and ny == 0:
            return None, len(xs)
        off = F32(cfg.range_offset if center == "backproject" else 0.0)
        dd = F32(images[b, ny, nx, 0] + off)
        xyz = np.array([dd * cos_t[nx], -dd * sin_t[nx], images[b, ny, nx, 1]], F32)
    l_, w_ = lwh[0], lwh[1]
    if center == "surface":
        xyz = _push(p_mean, yaw, l_, w_)
    elif center in ("consensus", "fit"):
        geo, surf = _push(xyz, yaw, l_, w_), _push(p_mean, yaw, l_, w_)
        e = surf - geo
        xyz = surf if F32(F32(e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]) <= F32(6.25) else geo
    elif center == "geometric":
        xyz = _push(xyz, yaw, l_, w_)
    if center == "fit":
        boundary, scale = cfg.fit_boundary, cfg.fit_surface_scale
        if boundary == "auto":
            boundary, scale = ((cfg.fit_boundary_oriented, scale) if oriented
                               else ("circle", cfg.fit_symmetric_scale))
        diag = F32(np.sqrt(F32(l_ * l_ + w_ * w_)))
        gate = F32(F32(F32(0.5) * diag) + F32(3.0))
        e = p - xyz
        n2 = F32(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
        gated = cv & (d <= F32(d[cv].min() + F32(4.0))) & (n2 <= F32(gate * gate))
        xyz, yaw = _fit(p[gated, 0], p[gated, 1], xyz, yaw, l_, w_, boundary, scale, grid)
    c, s = np.cos(-yaw), np.sin(-yaw)
    ctr = np.array([c * xyz[0] - s * xyz[1], s * xyz[0] + c * xyz[1], xyz[2]], F32)
    return np.concatenate([ctr, [yaw], lwh]).astype(F32), len(xs)


def model_decode(y_pred, images, comps, root, found, spec, cfg, center, low=None):
    """The kernel's answer: (poses (B, k, 7), found (B, k), window pixels
    (B, k)) from numpy inputs; `low`: y_pred (float32) holds values of that
    type (torch.bfloat16 or torch.float16), read by the kernel's instance
    for it."""
    mask, labels, *ext = comps
    tables = [t.numpy() for t in pixel_trig(spec, "cpu")] + [
        td.fit_phi_grid("cpu").numpy()]
    b_, k = root.shape
    poses = np.zeros((b_, k, 7), F32)
    good = np.zeros((b_, k), bool)
    windows = np.zeros((b_, k), np.int64)
    for b in range(b_):
        for j in range(k):
            if not found[b, j]:  # the early-out: zeros, not found
                continue
            pose, windows[b, j] = _model_lane(y_pred, images, mask, labels, ext, b, root[b, j],
                                              spec, cfg, center, tables, low)
            if pose is not None:
                poses[b, j], good[b, j] = pose, True
    return poses, good, windows


# ---------------------------------------------------------------------------


_COMPONENTS: dict = {}


def _lanes(y_pred, cfg, k, dtype=torch.float32):
    """The CC and _topk_roots of the plain version on y_pred in `dtype`:
    (comps, root, found) as torch tensors, cached by what they depend on."""
    key = (y_pred.shape, float(y_pred[..., 1].sum()), cfg.min_prob, cfg.min_heat,
           cfg.min_bbox_area, k, dtype)
    if key not in _COMPONENTS:
        comps = td._heat_components(torch.from_numpy(y_pred[..., 1]).to(dtype), cfg)
        root, found, *_ = td._topk_roots(*comps, cfg, k)
        _COMPONENTS[key] = (comps, root, found)
    return _COMPONENTS[key]


def _reference_found_lanes(y_pred, images, comps, root, found, spec, cfg, center,
                           dtype=torch.float32):
    """The plain version on the found lanes only (each lane is decoded on
    its own; a lane not found is zeros in both) of y_pred in `dtype`, and
    its margins: (poses (B, k, 7), found (B, k), smallest margin (B, k),
    `_golden.direct_margins`' units)."""
    b_, k = root.shape
    n = max(1, int(found.sum(dim=1).max()))
    order = torch.argsort((~found).to(torch.int8), dim=1, stable=True)[:, :n]
    margins: dict = {}
    poses, good = td.decode_direct_clusters_reference(
        torch.from_numpy(y_pred).to(dtype), torch.from_numpy(images), *comps,
        root.gather(1, order), found.gather(1, order), spec, cfg, center, margins)
    out_p = torch.zeros((b_, k, 7))
    out_g = torch.zeros((b_, k), dtype=torch.bool)
    out_m = torch.full((b_, k), np.inf)
    near = torch.stack(direct_margins(margins)).amin(dim=0) if margins else torch.full_like(
        good, np.inf, dtype=torch.float32)
    out_p.scatter_(1, order[..., None].expand(-1, -1, 7), poses)
    out_g.scatter_(1, order, good)
    out_m.scatter_(1, order, near)
    return out_p.numpy(), out_g.numpy(), out_m.numpy()


def _compare(got_p, got_f, want_p, want_f, windows, margins, what, adversarial=False):
    """The kernel's contract (`_golden.direct_kernel_readings`) with no
    lane near a threshold; returns the largest pose difference."""
    r = direct_kernel_readings(got_p, got_f, want_p, want_f, windows, margins, adversarial)
    assert r["ok"] and r["near"] == 0, (what, r)
    return max(r["diff"], r["diff_wide"])


# the ellipse and box arms' plain fits (37 headings over whole frames)
# are the slowest cases on the CPU: at 63 rows only the auto arm's runs
# here, and the ellipse's against JAX (JAX_CASES)
PLAIN_CASES = [(name, rows) for name in sorted(CASES) for rows in sorted(SPECS)
               if rows == 32 or not name.startswith(("fit_box", "fit_ellipse", "fit_auto_box"))]


@pytest.mark.parametrize("name, rows", PLAIN_CASES)
def test_kernel_model_matches_the_plain_version(inputs, name, rows):
    """Every covered center, boundary and yaw frame at k = 4 and k = 1 (the
    first lane of top-4: the same lanes in the same order)."""
    make_cfg, fcn = CASES[name]
    cfg, spec = make_cfg(), SPECS[rows]
    images, y_pred = inputs[rows]["images"], inputs[rows][fcn]
    comps, root, found = _lanes(y_pred, cfg, 4)
    want_p, want_f, margins = _reference_found_lanes(
        y_pred, images, comps, root, found, spec, cfg, cfg.direct_center)
    assert want_f.any()
    np_comps = [c.numpy() for c in comps]
    for k in (4, 1):
        got_p, got_f, windows = model_decode(y_pred, images, np_comps, root[:, :k].numpy(),
                                             found[:, :k].numpy(), spec, cfg, cfg.direct_center)
        diff = _compare(got_p, got_f, want_p[:, :k], want_f[:, :k], windows, margins[:, :k],
                        f"{name} at {rows} rows, k {k}")
        print(f"{name} {rows} rows k {k}: largest pose difference {diff:.3e}, windows "
              f"{windows.tolist()}")


@pytest.mark.parametrize("rows", sorted(SPECS))
@pytest.mark.parametrize("name", JAX_CASES)
def test_kernel_model_matches_jax(inputs, name, rows):
    make_cfg, fcn = CASES[name]
    cfg, spec = make_cfg(), SPECS[rows]
    images, y_pred = inputs[rows]["images"], inputs[rows][fcn]
    want = _jax_decode(jnp.asarray(y_pred), jnp.asarray(images), to_jax_config(spec),
                       to_jax_config(cfg), 4)
    comps, root, found = _lanes(y_pred, cfg, 4)
    got_p, got_f, windows = model_decode(y_pred, images, [c.numpy() for c in comps],
                                         root.numpy(), found.numpy(), spec, cfg,
                                         cfg.direct_center)
    _compare(got_p, got_f, np.asarray(want["poses"]), np.asarray(want["found"]), windows,
             np.full(got_f.shape, np.inf), f"{name} at {rows} rows against JAX")


def test_the_integer_key_keeps_the_sqrts_order_and_ties():
    """The back-projection's plain version takes the first argmin of
    sqrt_f32(dx^2 + dy^2); the kernel that of the integer dx^2 + dy^2. Every
    integer below 1801^2 + 63^2 has its own correctly rounded float32 root,
    in order, so the two pick the same pixel."""
    n = torch.arange(1801**2 + 63**2, dtype=torch.float32)
    assert bool((n[1:] > n[:-1]).all())  # exact in float32
    root = sqrt_f32(n)
    assert bool((root[1:] > root[:-1]).all())


def _one_frame(inputs):
    images, y_pred = inputs[32]["images"][:1], inputs[32]["asset"][:1]
    return torch.from_numpy(y_pred), torch.from_numpy(images)


def test_a_cpu_tensor_never_reaches_the_build(inputs, monkeypatch):
    """The wrapper runs the plain version for CPU tensors, bit for bit,
    and never asks for the kernel library."""
    def refuse():
        raise AssertionError("the CPU path asked for the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    y_pred, images = _one_frame(inputs)
    cfg = _asset()
    before = decode_direct.LAUNCHES
    got = td.decode_batch_direct(y_pred, images, SPECS[32], cfg, 4)
    comps, root, found = _lanes(y_pred.numpy(), cfg, 4)
    want = td.decode_direct_clusters_reference(y_pred, images, *comps, root, found, SPECS[32],
                                               cfg, cfg.direct_center)
    assert decode_direct.LAUNCHES == before
    assert torch.equal(got["poses"].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got["found"], want[1]) and bool(want[1].any())


def test_silhouette_goes_to_the_plain_version_by_name(inputs, monkeypatch):
    """decode_batch_direct sends "silhouette" to the composition on every
    device and every other center to the wrapper, which refuses it."""
    calls = []
    wrapper = td.decode_direct_clusters
    monkeypatch.setattr(td, "decode_direct_clusters",
                        lambda *a: calls.append(a[-1]) or wrapper(*a))
    y_pred, images = _one_frame(inputs)
    for center in td._CENTERS:
        out = td.decode_batch_direct(y_pred, images, SPECS[32], _asset(), 1, center)
        assert bool(out["found"].all()), center
    assert calls == [c for c in td._CENTERS if c != "silhouette"]
    comps, root, found = _lanes(y_pred.numpy(), _asset(), 1)
    with pytest.raises(ValueError, match="silhouette"):
        wrapper(y_pred, images, *comps, root, found, SPECS[32], _asset(), "silhouette")
    assert set(decode_direct.CENTERS) == set(td._CENTERS) - {"silhouette"}


def test_window_pixels_are_the_models_windows(inputs):
    y_pred, images = inputs[32]["asset"], inputs[32]["images"]
    cfg = _asset()
    comps, root, found = _lanes(y_pred, cfg, 4)
    _, _, windows = model_decode(y_pred, images, [c.numpy() for c in comps], root.numpy(),
                                 found.numpy(), SPECS[32], cfg, cfg.direct_center)
    got = decode_direct.window_pixels(*comps[2:], root, found)
    np.testing.assert_array_equal(got.numpy(), windows)
    assert 0 < windows.max() < 4096


@pytest.mark.parametrize("kind", parity_inputs.CLUSTER_KINDS)
def test_kernel_model_on_the_adversarial_clusters(kind):
    """`parity_inputs.cluster_inputs`, which the card's tests hold the
    kernel to: the model against the plain version at k = 4."""
    spec = SPECS[32]
    y_pred, images = parity_inputs.cluster_inputs(spec, kind, batch=2, seed=3)
    for name in ("backproject_local", "fit_circle_global", "consensus_auto"):
        cfg = DecodeConfig(**parity_inputs.cluster_decode_options(12)[name])
        comps, root, found = _lanes(y_pred, cfg, 4)
        want_p, want_f, margins = _reference_found_lanes(
            y_pred, images, comps, root, found, spec, cfg, cfg.direct_center)
        got_p, got_f, windows = model_decode(y_pred, images, [c.numpy() for c in comps],
                                             root.numpy(), found.numpy(), spec, cfg,
                                             cfg.direct_center)
        _compare(got_p, got_f, want_p, want_f, windows, margins, f"{kind}, {name}",
                 adversarial=True)
        if kind not in ("edges", "cars"):
            assert not found[:, -1].any()  # k above the cluster count


@pytest.mark.parametrize("name", ["backproject_local", "head_global", "surface_local",
                                  "fit_circle_global", "fit_ellipse_local", "fit_auto_auto"])
def test_kernel_model_on_the_crafted_lanes(name):
    """`parity_inputs.crafted_lanes`, the hand-made windows the card's
    tests hold the kernel to (one pixel, two rows straddling the lane's
    CTAs, 20 rows x the frame's width past every CTA's stage, a car with a
    hole, clusters with no m or no return): the model against the plain
    version, and the lanes found as made."""
    spec = SPECS[32]
    cfg = DecodeConfig(**parity_inputs.cluster_decode_options(12)[name])
    y_pred, images, *comps, root, found = parity_inputs.crafted_lanes(spec, batch=2, seed=5,
                                                                      channels=12)
    want_p, want_f, margins = _reference_found_lanes(
        y_pred, images, [torch.from_numpy(c) for c in comps], torch.from_numpy(root),
        torch.from_numpy(found), spec, cfg, cfg.direct_center)
    got_p, got_f, windows = model_decode(y_pred, images, comps, root, found, spec, cfg,
                                         cfg.direct_center)
    _compare(got_p, got_f, want_p, want_f, windows, margins, f"crafted lanes, {name}",
             adversarial=True)
    assert windows[0].tolist() == [1, 2 * 700, 20 * spec.width, 0]
    assert want_f[0, :3].all() and not want_f[1, 1:3].any() and want_f[1, 3]


@pytest.mark.parametrize("name", ["fit_circle_global", "head_local", "surface_local",
                                  "backproject_auto"])
def test_the_bound_counts_the_bytes_the_lanes_need(inputs, name):
    """`kernel_bench.decode_direct_bound_bytes` against a count pixel by
    pixel of what each found lane needs: its window's mask, and labels
    where the mask is set, once a frame; the image on its cluster, its
    centroid and, where the centroid is not valid, the shrunk window; the
    probability on its cluster's valid pixels and the center's and yaw
    frame's channels where it passes min_prob; and the lanes' own bytes."""
    from tpufusion_torch.kernel_bench import decode_direct_bound_bytes

    make_cfg, fcn = CASES[name]
    cfg, spec = make_cfg(), SPECS[32]
    images, y_pred = inputs[32]["images"], inputs[32][fcn]
    comps, root, found = _lanes(y_pred, cfg, 4)
    mask, labels, *ext = (c.numpy() for c in comps)
    valid = (images[..., 0] > 0) & (images[..., 1] > spec.min_height)
    center = cfg.direct_center
    channels = 3 + (4 if cfg.direct_yaw_frame == "auto" else 2) + 3 * (center == "head")
    b_, k = root.shape
    want = b_ * k * (1 + 28 + 1) + int(found.sum()) * (8 + 16)
    for b in range(b_):
        cover, image_px = set(), set()
        for j in range(k):
            if not found[b, j]:
                continue
            r = int(root[b, j])
            x0, x1, y0, y1 = (int(e[b].reshape(-1)[r]) for e in ext)
            for y in range(y0, y1 + 1):
                for x in range(x0, x1 + 1):
                    cover.add((y, x))
                    if mask[b, y, x] and labels[b, y, x] == r:
                        image_px.add((y, x))
                        if valid[b, y, x]:
                            want += 4 + 4 * channels * bool(y_pred[b, y, x, 1] >= cfg.min_prob)
            if center in ("backproject", "geometric", "consensus", "fit"):
                cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
                image_px.add((cy, cx))
                if not valid[b, cy, cx] and x0 + 2 != 0 and x1 - 2 != 0:
                    image_px |= {(y, x) for y in range(y0 + 2, y1 - 1)
                                 for x in range(x0 + 2, x1 - 1)}
        want += sum(1 + 4 * bool(mask[b, y, x]) for y, x in cover) + 8 * len(image_px)
    got = decode_direct_bound_bytes(torch.from_numpy(y_pred), torch.from_numpy(images), *comps,
                                    root, found, spec, cfg, center)
    assert got == want and bool(found.any())


# ---------------------------------------------------------------------------
# a bf16 head output


@pytest.mark.parametrize("name, rows", PLAIN_CASES)
def test_bf16_kernel_model_matches_the_plain_version(inputs, name, rows):
    """The model with the kernel's bf16 rounding points against the plain
    version on the same bf16 output, every covered center, boundary and
    yaw frame at k = 4 and k = 1: the float32 contract, no lane near a
    threshold or a bf16 rounding midpoint."""
    make_cfg, fcn = CASES[name]
    cfg, spec = make_cfg(), SPECS[rows]
    images, y_pred = inputs[rows]["images"], inputs[rows][f"{fcn}_bf16"]
    comps, root, found = _lanes(y_pred, cfg, 4, BF16)
    want_p, want_f, margins = _reference_found_lanes(
        y_pred, images, comps, root, found, spec, cfg, cfg.direct_center, BF16)
    assert want_f.any()
    np_comps = [c.numpy() for c in comps]
    for k in (4, 1):
        got_p, got_f, windows = model_decode(y_pred, images, np_comps, root[:, :k].numpy(),
                                             found[:, :k].numpy(), spec, cfg, cfg.direct_center,
                                             low=BF16)
        diff = _compare(got_p, got_f, want_p[:, :k], want_f[:, :k], windows, margins[:, :k],
                        f"bf16 {name} at {rows} rows, k {k}")
        print(f"bf16 {name} {rows} rows k {k}: largest pose difference {diff:.3e}")


def _bf16_against(got: dict, want_poses, want_found, what: str, tol: float = POSE_TOL) -> float:
    """The port's decode of a bf16 (float16) output against JAX's answer:
    the output types JAX gives (float32 poses and areas), found equal,
    poses within POSE_TOL (`tol`; yaw as an angle); returns the largest
    pose difference."""
    assert got["poses"].dtype == torch.float32 and got["areas"].dtype == torch.float32, what
    np.testing.assert_array_equal(got["found"].numpy(), want_found, err_msg=what)
    diff = float(wrapped_pose_diff(got["poses"].numpy(), want_poses).max())
    assert diff <= tol, (what, diff)
    return diff


@pytest.fixture(scope="module")
def golden_bf16():
    return load_npz(GOLDEN_BF16)


def test_the_bf16_golden_holds_these_inputs(inputs, golden_bf16):
    """The bf16 golden's frames and bf16 FCN outputs are the ones JAX
    makes here (32 rows): its answers are JAX's on these inputs."""
    np.testing.assert_array_equal(golden_bf16["images"], inputs[32]["images"])
    for fcn in BF16_DECODE_FCNS:
        np.testing.assert_array_equal(from_bf16_bits(golden_bf16[f"{fcn}_bits"]),
                                      inputs[32][f"{fcn}_bf16"], err_msg=fcn)


@pytest.mark.parametrize("rows", sorted(SPECS))
@pytest.mark.parametrize("name", sorted(BF16_DECODE_CASES))
def test_bf16_decode_matches_jax(inputs, golden_bf16, name, rows):
    """decode_batch_direct on a bf16 output, the shipped assets' operating
    points, DecodeConfig's default, the head center in both yaw frames and
    silhouette, at k 2 and k 1 (JAX's first lane): against the bf16
    golden at 32 rows, against JAX run here at 63."""
    fcn, cfg = bf16_decode_case(name, ASSETS)
    spec = SPECS[rows]
    images, y_pred = inputs[rows]["images"], inputs[rows][f"{fcn}_bf16"]
    if rows == 32:
        want_p, want_f = golden_bf16[f"{name}_poses"], golden_bf16[f"{name}_found"]
    else:
        want = _jax_decode(jnp.asarray(y_pred).astype(jnp.bfloat16), jnp.asarray(images),
                           to_jax_config(spec), to_jax_config(cfg), BF16_DECODE_K)
        assert want["poses"].dtype == jnp.float32 and want["areas"].dtype == jnp.float32
        want_p, want_f = np.asarray(want["poses"]), np.asarray(want["found"])
    assert want_f.any()
    y_t, im_t = torch.from_numpy(y_pred).to(BF16), torch.from_numpy(images)
    diffs = []
    for k in (BF16_DECODE_K, 1):
        got = td.decode_batch_direct(y_t, im_t, spec, cfg, k)
        diffs.append(_bf16_against(got, want_p[:, :k], want_f[:, :k], f"{name} {rows} k {k}"))
    print(f"bf16 {name} at {rows} rows: largest pose difference from JAX {max(diffs):.3e}")


@pytest.mark.parametrize("name", ["backproject_global", "head_local", "fit_circle_global",
                                  "fit_circle_auto"])
def test_bf16_probability_at_the_threshold_counts(name):
    """`parity_inputs.threshold_inputs` at min_prob 0.7: the pixel of
    exactly bf16(0.7) counts in frame 0 and the one a bf16 step below does
    not in frame 1, in JAX, the plain version and the model alike; the
    same values as float32 (0.7f) count in neither frame."""
    make_cfg, _ = CASES[name]
    cfg = dataclasses.replace(make_cfg(), min_prob=parity_inputs.THRESHOLD_MIN_PROB)
    spec = SPECS[32]
    channels = 12 if cfg.direct_yaw_frame == "auto" else 10
    y, images, _ = parity_inputs.threshold_inputs(spec, channels=channels)
    want = _jax_decode(jnp.asarray(y).astype(jnp.bfloat16), jnp.asarray(images),
                       to_jax_config(spec), to_jax_config(cfg), 4)
    got = td.decode_batch_direct(torch.from_numpy(y).to(BF16), torch.from_numpy(images), spec,
                                 cfg, 4)
    _bf16_against(got, np.asarray(want["poses"]), np.asarray(want["found"]), name)
    poses = got["poses"].numpy()
    assert not np.array_equal(poses[0], poses[1]), "the pixel at bf16(0.7) did not count"
    as_f32 = td.decode_batch_direct(torch.from_numpy(y), torch.from_numpy(images), spec, cfg,
                                    4)["poses"]
    assert torch.equal(as_f32[0], as_f32[1]), "a float32 0.7 kept the pixel at 0.69921875"
    comps, root, found = _lanes(y, cfg, 4, BF16)
    want_p, want_f, margins = _reference_found_lanes(y, images, comps, root, found, spec, cfg,
                                                     cfg.direct_center, BF16)
    got_p, got_f, windows = model_decode(y, images, [c.numpy() for c in comps], root.numpy(),
                                         found.numpy(), spec, cfg, cfg.direct_center, low=BF16)
    _compare(got_p, got_f, want_p, want_f, windows, margins, f"threshold {name}")


# ---------------------------------------------------------------------------
# a float16 head output

# the cases whose rounding points differ: every sum and quotient of the
# sizes, the global frame's quotients and yaw, the auto gate's squares,
# the head's cos / sin of a float16 yaw, the surface weight
F16_MODEL_CASES = ("backproject_local", "backproject_auto", "surface_local", "head_global",
                   "head_local", "fit_circle_global", "fit_auto_auto", "consensus_global")


@pytest.mark.parametrize("name", F16_MODEL_CASES)
def test_f16_kernel_model_matches_the_plain_version(inputs, name):
    """The model with the kernel's float16 rounding points (a sum rounded
    as bf16's are, and each op of two float16 values rounded) against the
    plain version on the same float16 output at 32 rows, k = 4 and k = 1:
    the float32 contract, no lane near a threshold or a float16 rounding
    midpoint."""
    make_cfg, fcn = CASES[name]
    cfg, spec = make_cfg(), SPECS[32]
    images, y_pred = inputs[32]["images"], inputs[32][f"{fcn}_f16"]
    comps, root, found = _lanes(y_pred, cfg, 4, F16)
    want_p, want_f, margins = _reference_found_lanes(
        y_pred, images, comps, root, found, spec, cfg, cfg.direct_center, F16)
    assert want_f.any()
    np_comps = [c.numpy() for c in comps]
    for k in (4, 1):
        got_p, got_f, windows = model_decode(y_pred, images, np_comps, root[:, :k].numpy(),
                                             found[:, :k].numpy(), spec, cfg, cfg.direct_center,
                                             low=F16)
        diff = _compare(got_p, got_f, want_p[:, :k], want_f[:, :k], windows, margins[:, :k],
                        f"float16 {name}, k {k}")
        print(f"float16 {name} k {k}: largest pose difference {diff:.3e}")


def test_f16_model_without_the_op_rounding_fails(inputs, monkeypatch):
    """The float16 rounding points are not bf16's: the model with bf16's
    points in float16 (the sums rounded, the products and quotients not)
    misses the plain version's sizes by float16 steps."""
    make_cfg, fcn = CASES["fit_circle_global"]
    cfg, spec = make_cfg(), SPECS[32]
    images, y_pred = inputs[32]["images"], inputs[32][f"{fcn}_f16"]
    comps, root, found = _lanes(y_pred, cfg, 4, F16)
    want_p, want_f, _ = _reference_found_lanes(
        y_pred, images, comps, root, found, spec, cfg, cfg.direct_center, F16)
    monkeypatch.setitem(globals(), "low_round", lambda v, dtype: f16_round(v))
    got_p, got_f, _ = model_decode(y_pred, images, [c.numpy() for c in comps], root.numpy(),
                                   found.numpy(), spec, cfg, cfg.direct_center, low=BF16)
    np.testing.assert_array_equal(got_f, np.asarray(want_f))
    assert np.abs(got_p - np.asarray(want_p))[..., 4:].max() > 1e-4


@pytest.fixture(scope="module")
def golden_f16():
    return load_npz(GOLDEN_F16)


def test_the_f16_golden_holds_these_inputs(inputs, golden_f16):
    """The float16 golden's FCN outputs are the ones JAX makes here on the
    bf16 golden's frames (32 rows): its answers are JAX's on these
    inputs."""
    for fcn in BF16_DECODE_FCNS:
        np.testing.assert_array_equal(from_f16_bits(golden_f16[f"{fcn}_bits"]),
                                      inputs[32][f"{fcn}_f16"], err_msg=fcn)


@pytest.mark.parametrize("name", sorted(F16_DECODE_CASES))
def test_f16_decode_matches_the_golden(inputs, golden_f16, name):
    """decode_batch_direct on a float16 output at every kernel center and
    silhouette, at k 2 and k 1, against the float16 golden's JAX answers
    (32 rows): found, output types, poses within F16_POSE_TOL."""
    fcn, cfg = bf16_decode_case(name, ASSETS, F16_DECODE_CASES)
    images, y_pred = inputs[32]["images"], inputs[32][f"{fcn}_f16"]
    y_t, im_t = torch.from_numpy(y_pred).to(F16), torch.from_numpy(images)
    diffs = []
    for k, tag in ((F16_DECODE_K, name), (1, f"{name}_k1")):
        want_p, want_f = golden_f16[f"{tag}_poses"], golden_f16[f"{tag}_found"]
        assert want_f.any()
        got = td.decode_batch_direct(y_t, im_t, SPECS[32], cfg, k)
        diffs.append(_bf16_against(got, want_p, want_f, f"float16 {name} k {k}", F16_POSE_TOL))
    print(f"float16 {name}: largest pose difference from JAX {max(diffs):.3e}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_f16_decode_matches_jax_at_63_rows(inputs, name):
    """The same on the 64-beam scans (63 rows) against JAX run here, the
    shipped assets' operating points and DecodeConfig's default."""
    make_cfg, fcn = CASES[name]
    cfg, spec = make_cfg(), SPECS[63]
    images, y_pred = inputs[63]["images"], inputs[63][f"{fcn}_f16"]
    want = _jax_decode(jnp.asarray(y_pred).astype(jnp.float16), jnp.asarray(images),
                       to_jax_config(spec), to_jax_config(cfg), F16_DECODE_K)
    assert np.asarray(want["found"]).any()
    got = td.decode_batch_direct(torch.from_numpy(y_pred).to(F16), torch.from_numpy(images),
                                 spec, cfg, F16_DECODE_K)
    diff = _bf16_against(got, np.asarray(want["poses"]), np.asarray(want["found"]),
                         f"float16 {name} at 63 rows", F16_POSE_TOL)
    print(f"float16 {name} at 63 rows: largest pose difference from JAX {diff:.3e}")


@pytest.mark.parametrize("name", ["backproject_global", "fit_circle_auto"])
def test_f16_probability_at_the_threshold_counts(name):
    """`parity_inputs.threshold_inputs` in float16 at min_prob 0.8: the
    pixel of exactly float16(0.8) counts in frame 0 and the one a step
    below does not in frame 1, in JAX, the plain version and the model
    alike; the same values as float32 (0.8f) count in neither frame."""
    make_cfg, _ = CASES[name]
    min_prob = parity_inputs.THRESHOLDS["float16"][0]
    cfg = dataclasses.replace(make_cfg(), min_prob=min_prob)
    spec = SPECS[32]
    channels = 12 if cfg.direct_yaw_frame == "auto" else 10
    y, images, _ = parity_inputs.threshold_inputs(spec, channels=channels, dtype="float16")
    want = _jax_decode(jnp.asarray(y).astype(jnp.float16), jnp.asarray(images),
                       to_jax_config(spec), to_jax_config(cfg), 4)
    got = td.decode_batch_direct(torch.from_numpy(y).to(F16), torch.from_numpy(images), spec,
                                 cfg, 4)
    _bf16_against(got, np.asarray(want["poses"]), np.asarray(want["found"]), name, F16_POSE_TOL)
    poses = got["poses"].numpy()
    assert not np.array_equal(poses[0], poses[1]), "the pixel at float16(0.8) did not count"
    as_f32 = td.decode_batch_direct(torch.from_numpy(y), torch.from_numpy(images), spec, cfg,
                                    4)["poses"]
    assert torch.equal(as_f32[0], as_f32[1]), "a float32 0.8 kept the pixel at 0.7998046875"
    comps, root, found = _lanes(y, cfg, 4, F16)
    want_p, want_f, margins = _reference_found_lanes(y, images, comps, root, found, spec, cfg,
                                                     cfg.direct_center, F16)
    got_p, got_f, windows = model_decode(y, images, [c.numpy() for c in comps], root.numpy(),
                                         found.numpy(), spec, cfg, cfg.direct_center, low=F16)
    _compare(got_p, got_f, want_p, want_f, windows, margins, f"float16 threshold {name}")


def test_midpoint_margin_of_float16_sums():
    """`_midpoint_margin` in float16: a sum one float32 step from a float16
    midpoint is near it (in the normal and the subnormal range), one a
    quarter float16 step away is not, and a sum whose float64 partial sums
    are exact is inf."""
    from tpufusion_torch.decode.decode import _midpoint_margin

    def margin(total, terms):
        t = torch.tensor(terms, dtype=torch.float64)[None]
        return float(_midpoint_margin(torch.tensor([total], dtype=torch.float64), t, (-1,),
                                      F16)[0])

    spread = [2.0**-30, 1.0]  # 2**30 apart: past the 2**42 bound only with the big one
    assert margin(1.0 + 2.0**-30, spread) == np.inf  # exact in float64
    big = [2.0**-40, 2.0**3]
    mid = 8.0 + 2.0**-8  # halfway between float16 8 and 8 + 2**-7
    assert margin(mid + 2.0**-20, big) < 2.0**-22 * 2  # a float32 step above it
    assert margin(8.0 + 2.0**-9, big) > 2.0**-13
    sub = [2.0**-70, 2.0**-20]  # subnormal float16: steps of 2**-24
    assert margin(2.0**-20 + 2.0**-25, sub) == 0.0
    assert margin(2.0**-20 + 2.0**-26, sub) > 2.0**-8
