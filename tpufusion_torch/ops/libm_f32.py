"""The JAX package's float32 `atan2` and `asin`, bit for bit, as plain
torch functions that run on any device.

What the reference computes. `tpufusion/geometry/range_view.py` runs under
eager JAX on the CPU. There XLA lowers `jnp.arctan2` to
`llvm.atan2.v8f32`, which its CPU object calls as the host libm's
`atan2f` (the object file of a dumped op holds an undefined `atan2f`).
glibc 2.36's `atan2f` is fdlibm's float code, `e_atan2f.c` and
`s_atanf.c`, compiled without FMA contraction: a C transcription built
with `-ffp-contract=off` equals `jnp.arctan2` on 4,000,000 seeded pairs,
the same source with `-ffp-contract=fast` differs on 4,958 of them.
`jnp.arcsin` is `chlo.asin`, which XLA expands to
`t = atan2(x, 1 + sqrt((1 - x) * (1 + x)))`, then `t + t`. XLA runs its
CPU code with flush-to-zero and denormals-are-zero set: every float op
reads a subnormal operand as a zero of its sign and writes a subnormal
result as one, while fdlibm's integer tests see the operand's bits as
they came.

How this module reproduces it. Every float op is one IEEE-rounded torch
op between two tensors: no fused op, and no division by a Python number,
which torch on the card does as a multiplication by the float32
reciprocal. Constants are float32 tensors on the operand's device. Each
root goes through `sqrt_f32`. fdlibm's branches are all evaluated for
every element and chosen with `torch.where`, so a branch that divides by
zero is computed but never selected. XLA's flush is `ftz_f32`, applied
where a subnormal can arise (flushing a normal value is a no-op, and each
flush is four more torch ops): the operands of each division and the
quotient, and the argument of asin. Nowhere else in the selected
branches: fdlibm's reduced argument t is 0 or |t| >= 2^-29 (the
reductions cancel exactly, to a multiple of 2^-24), so z = t*t >=
2^-58, w = z*z >= 2^-116, each Horner term w*acc >= 2^-122 and
t*(s1 + s2) >= 2^-89, while every other result stays near a constant of
fdlibm's; the caller flushes the products that a tiny coordinate makes
(`ops/pixels.py`). The kernel `csrc/pixels.cu` transcribes the same code
with the card's `.rn.ftz` instructions, which flush at every op; the
edge-value tests hold both to eager JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpufusion_torch._constants import device_scalar

_SIGN = -0x80000000  # the sign bit of an int32 view
_ABS = 0x7FFFFFFF
_EXP = 0x7F800000  # exponent bits; also +inf
_ONE = 0x3F800000  # 1.0f

# s_atanf.c: atan(0.5), atan(1), atan(1.5), atan(inf) split hi + lo, and
# the odd series in z = x^2. The decimal literals are the source's (its
# hex comment for aT[0] is one ulp off the literal; the literal is what
# the compiler builds).
_ATANHI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e00)
_ATANLO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
       9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
       4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)
# |x| bounds of s_atanf.c's branches: 2^-29, 7/16, 11/16, 19/16, 39/16, 2^25
_TINY_X, _B7_16, _B11_16, _B19_16, _B39_16, _HUGE_X = (
    0x31000000, 0x3EE00000, 0x3F300000, 0x3F980000, 0x401C0000, 0x4C000000)

# e_atan2f.c
_TINY = 1.0e-30
_PI_O_4 = 7.8539818525e-01
_PI_O_2 = 1.5707963705e00
_PI = 3.1415927410e00
_PI_LO = -8.7422776573e-08


def _f32(v: float) -> np.float32:
    return np.float32(v)


# e_atan2f.c's returned constants, each a float32 sum as the C code does it
_PI_T = float(_f32(_PI) + _f32(_TINY))  # pi + tiny
_PI_O_2_T = float(_f32(_PI_O_2) + _f32(_TINY))
_PI_O_4_T = float(_f32(_PI_O_4) + _f32(_TINY))
_3PI_O_4_T = float(_f32(3.0) * _f32(_PI_O_4) + _f32(_TINY))
_PI_O_2_LO = float(_f32(_PI_O_2) + _f32(0.5) * _f32(_PI_LO))  # |y/x| > 2^60
_ATAN_INF = float(_f32(_ATANHI[3]) + _f32(_ATANLO[3]))  # |x| >= 2^25


def sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of float32 `v`, on the CPU and the
    card alike. torch's float32 sqrt on the CPU's AVX-512 path is not
    correctly rounded (it differs from numpy/XLA in ~0.6% of elements,
    and by position in the tensor), and neither is its float64 sqrt
    there: rounding that root to float32 still misses the float32 root in
    ~30 of a million elements, by position and from run to run. So the
    float32 rounding r of the float64 root is checked exactly: the
    midpoints between r and its float32 neighbours have 25 significant
    bits, so their squares are exact in float64, and the root lies on the
    side of each midpoint where v lies of its square."""
    v64 = v.to(torch.float64)
    r = torch.sqrt(v64).to(torch.float32)
    up = torch.nextafter(r, device_scalar(math.inf, torch.float32, r.device))
    down = torch.nextafter(r, device_scalar(0.0, torch.float32, r.device))
    r64 = r.to(torch.float64)
    two = device_scalar(2.0, torch.float64, r.device)
    hi = (r64 + up.to(torch.float64)) / two
    lo = (r64 + down.to(torch.float64)) / two
    return torch.where(v64 > hi * hi, up, torch.where(v64 < lo * lo, down, r))


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.int32)


def _float(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.float32)


def const_f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant `value` (rounded to nearest) on like's device,
    0-d: it broadcasts without changing a shape."""
    return device_scalar(value, torch.float32, like.device)


def ftz_f32(v: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 flushed to a zero of its sign; other values,
    infinities and NaNs as they are."""
    b = _bits(v)
    return _float(torch.where((b & _EXP) == 0, b & _SIGN, b))


def div_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b as XLA divides on the CPU: subnormal operands and a subnormal
    quotient flushed to zeros of their signs."""
    return ftz_f32(ftz_f32(a) / ftz_f32(b))


def neg_f32(v: torch.Tensor) -> torch.Tensor:
    """-v as the sign bit flipped (XLA's negation; no flush)."""
    return _float(_bits(v) ^ _SIGN)


def _pick(masks, values) -> torch.Tensor:
    """values[i] where masks[i] holds first, values[-1] where none does."""
    out = values[-1]
    for m, v in zip(masks[::-1], values[-2::-1]):
        out = torch.where(m, v, out)
    return out


def _horner(w: torch.Tensor, coeffs) -> torch.Tensor:
    """c0 + w*(c1 + w*(c2 + ...)), innermost first, each op rounded."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = c + w * acc
    return acc


def atanf_f32(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's float atan (`s_atanf.c`), float32 in and out."""
    hx = _bits(x)
    ix = hx & _ABS
    one, ax = const_f32(1.0, x), _float(ix)  # ax = fabsf(x)
    two, c15 = const_f32(2.0, x), const_f32(1.5, x)
    # argument reduction of |x| >= 7/16 (branch ids 0-3), every branch on
    # every element
    ids = (ix < _B11_16, ix < _B19_16, ix < _B39_16)
    t = _pick(ids, ((two * ax - one) / (two + ax), (ax - one) / (ax + one),
                    (ax - c15) / (one + c15 * ax),
                    const_f32(-1.0, x) / ax))  # id 3; ax = 0 never reaches it
    reduced = ix >= _B7_16
    t = torch.where(reduced, t, x)  # id -1 keeps the signed argument
    z = t * t
    w = z * z
    at = [const_f32(c, x) for c in _AT]
    s1 = z * _horner(w, at[0::2])  # z*(aT0 + w*(aT2 + ... + w*aT10))
    s2 = w * _horner(w, at[1::2])  # w*(aT1 + w*(aT3 + ... + w*aT9))
    ts = t * (s1 + s2)
    small = t - ts  # id -1: x - x*(s1+s2)
    hi = (_pick(ids, [const_f32(v, x) for v in _ATANHI])
          - ((ts - _pick(ids, [const_f32(v, x) for v in _ATANLO])) - t))
    out = torch.where(reduced, torch.where(hx < 0, neg_f32(hi), hi), small)
    out = torch.where(ix < _TINY_X, x, out)  # |x| < 2^-29: x itself
    atan_inf = const_f32(_ATAN_INF, x)
    out = torch.where(ix >= _HUGE_X, torch.where(hx > 0, atan_inf, neg_f32(atan_inf)), out)
    return torch.where(ix > _EXP, x + x, out)  # NaN


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fdlibm's float atan2 (`e_atan2f.c`) as glibc 2.36 builds it and XLA
    calls it, float32 in and out; y and x of one shape."""
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & _ABS, hy & _ABS
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    k = lambda v: const_f32(v, x)  # noqa: E731
    pi, pi_o_2, zero = k(_PI_T), k(_PI_O_2_T), k(0.0)
    x_is_one = hx == _ONE
    # the general case: atanf(|y/x|), then the quadrant; atan2(y, 1) is
    # atanf(y), so one atanf serves both
    q = div_f32(y, x)
    a = atanf_f32(torch.where(x_is_one, y, _float(_bits(q) & _ABS)))
    kk = (iy - ix) >> 23
    z = torch.where(kk > 60, k(_PI_O_2_LO),
                    torch.where((hx < 0) & (kk < -60), zero, a))
    zl = z - k(_PI_LO)
    neg_y, neg_x = (m & 1) == 1, m >= 2
    out = torch.where(neg_x, torch.where(neg_y, zl - k(_PI), k(_PI) - zl),
                      torch.where(neg_y, neg_f32(z), z))
    signed = lambda v: torch.where(neg_y, neg_f32(v), v)  # noqa: E731
    out = torch.where(iy == _EXP, signed(pi_o_2), out)  # y = +-inf, x finite
    inf_x = torch.where(iy == _EXP, torch.where(neg_x, k(_3PI_O_4_T), k(_PI_O_4_T)),
                        torch.where(neg_x, pi, zero))
    out = torch.where(ix == _EXP, signed(inf_x), out)  # x = +-inf
    out = torch.where(ix == 0, signed(pi_o_2), out)  # x = +-0
    out = torch.where(iy == 0, torch.where(neg_x, signed(pi), y), out)  # y = +-0
    out = torch.where(x_is_one, a, out)
    return torch.where((ix > _EXP) | (iy > _EXP), x + y, out)  # NaN


def asin_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 asin: t = atan2(x, 1 + sqrt((1 - x) * (1 + x))),
    then t + t."""
    one, xd = const_f32(1.0, x), ftz_f32(x)
    t = atan2_f32(x, one + sqrt_f32((one - xd) * (one + xd)))
    return t + t
