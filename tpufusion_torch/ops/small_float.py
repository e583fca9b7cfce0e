"""The small floating-point formats the FCN computes in (ModelConfig.dtype
"float8_*" and "float4_e2m1fn"), their plain rounding, and the wrappers
of their hand-written kernel (`csrc/small_float.cu`).

  FORMATS         the nine formats JAX runs, by name: bits, bias, sign,
                  zero, NaN, infinity and overflow, as ml_dtypes defines
                  them (the port keeps its own table; it imports neither
                  ml_dtypes nor JAX)
  encode / decode float32 <-> a format's codes (int64), plain PyTorch
  round_small_float  x -> the nearest value of the format, as float32:
                  round to nearest, ties to even on the significand
                  (float8_e8m0fnu's is its implicit bit alone, so its
                  ties go up), subnormals kept, NaN and overflow as the
                  format says; `via_f16` rounds to float16 first
  cast            the kernel's direct mode: x -> fmt(x) in the format's
                  carrier dtype (or its codes as uint8)
  conv_epilogue   the kernel's epilogue mode: a convolution's raw output
                  y (NCHW) and the layer's float32 bias ->
                  relu?(fmt(h(fmt(h(y)) + fmt(bias[c])))), h the float16
                  rounding where the format goes through float16

How XLA computes a flax convolution in one of these formats (its
optimized HLO on the CPU): the input, the kernel and the bias are cast
from float32 to the format once, directly; the convolution upcasts its
operands (format -> float16 -> float32) and sums in float32; its result
is rounded twice, float32 -> float16 -> format; the bias add runs in
float16 on the two format values and its sum is rounded float16 ->
format; relu, crops and concatenations are exact. float8_e8m0fnu, which
float16 cannot hold, skips every float16 step, and its relu is a NaN:
max(x, fmt(0)), and 0 is a NaN there. The kernel computes exactly that
chain, element by element, and so does the plain version; the FCN runs
the convolution itself on torch's ops (`models/fcn.py`). NaNs follow
x86, whose rules XLA's CPU code computes by, on any device: a NaN of the
convolution enters the epilogue as the default NaN (negative; cuDNN's
are positive), r + b returns r's NaN, else b's, and inf - inf the default
NaN; every other step keeps a NaN's sign, as ml_dtypes' casts do.

A format's values travel between layers in its carrier dtype: float16,
which holds every value of the eight formats that go through float16,
and float32 for float8_e8m0fnu. For tensors on the CPU the wrappers run
the plain version; for CUDA tensors they call the kernel once (one
launch; a float16 y's first epilogue on a device also launches the build
of the format's code table, `_TABLES`), or raise. Backward is not
ported: the epilogue's autograd Function raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpufusion_torch import _build

LAUNCHES = 0  # kernel launches since import (or since a caller reset it), both modes
OVERFLOWS = ("inf", "nan", "saturate")  # what a value past the largest finite one gives
IN_DTYPES = (torch.float32, torch.float16)  # the kernel's input types, by code
N_PARAMS = 12  # the int parameters the C entry points read from a host array


@dataclasses.dataclass(frozen=True)
class SmallFloat:
    """One small floating-point format, as ml_dtypes defines it.

    Codes are unsigned integers of 1 + ebits + mbits bits (ebits + mbits
    without a sign). Exponent field f > 0 holds (1 + m / 2**mbits) *
    2**(f - bias); f = 0 holds subnormals m * 2**(1 - bias - mbits) where
    `subnormals`, else 2**-bias (float8_e8m0fnu, which has no zero)."""

    name: str
    ebits: int
    mbits: int
    bias: int
    signed: bool  # a sign bit above the exponent
    neg_zero: bool  # a negative zero (the fnuz formats have none)
    subnormals: bool  # without: float32's exponent field (bias 127), no zero
    max_code: int  # the largest finite value's code
    has_nan: bool
    nan_code: int  # what NaN gives (float4_e2m1fn, which has no NaN: its -0)
    nan_signed: bool  # a negative NaN flips nan_code's sign bit
    inf_code: int  # +inf's code, -1 where the format has no infinity
    overflow: str  # what overflow and infinities give: OVERFLOWS
    torch_name: str | None  # torch's dtype of this name, where torch has one

    @property
    def sign_bit(self) -> int:
        return 1 << (self.ebits + self.mbits) if self.signed else 0

    @property
    def via_f16(self) -> bool:
        """XLA rounds through float16 where float16 holds every value."""
        return self.min_exp >= -24 and self.max_value <= 65504.0

    @property
    def min_exp(self) -> int:
        """log2 of the smallest positive value."""
        return 1 - self.bias - self.mbits if self.subnormals else -self.bias

    @property
    def carrier(self) -> torch.dtype:
        return torch.float16 if self.via_f16 else torch.float32

    @property
    def max_value(self) -> float:
        f, m = self.max_code >> self.mbits, self.max_code & ((1 << self.mbits) - 1)
        return (1 + m / 2**self.mbits) * 2.0 ** (f - self.bias)

    @property
    def torch_dtype(self) -> torch.dtype | None:
        return getattr(torch, self.torch_name, None) if self.torch_name else None

    def params(self) -> tuple[int, ...]:
        """The kernel's N_PARAMS int parameters (csrc/small_float.cu's
        `Fmt`, in order)."""
        return (self.ebits, self.mbits, self.bias, self.sign_bit, int(self.neg_zero),
                int(self.subnormals), self.max_code, int(self.has_nan),
                self.nan_code, int(self.nan_signed), self.inf_code,
                OVERFLOWS.index(self.overflow))


def _fmt(name, e, m, bias, max_code, nan_code, inf_code=-1, *, signed=True, neg_zero=True,
         subnormals=True, has_nan=True, nan_signed=True, overflow="nan",
         torch_name=None) -> SmallFloat:
    return SmallFloat(name, e, m, bias, signed, neg_zero, subnormals, max_code, has_nan,
                      nan_code, nan_signed, inf_code, overflow, torch_name)


FORMATS: dict[str, SmallFloat] = {f.name: f for f in (
    # fn: no infinity, NaN is all ones (either sign), overflow is NaN
    _fmt("float8_e4m3fn", 4, 3, 7, 0x7E, 0x7F, torch_name="float8_e4m3fn"),
    # IEEE-like: infinity and NaNs in the top exponent, overflow is infinity
    _fmt("float8_e5m2", 5, 2, 15, 0x7B, 0x7E, 0x7C, overflow="inf", torch_name="float8_e5m2"),
    _fmt("float8_e3m4", 3, 4, 3, 0x6F, 0x78, 0x70, overflow="inf"),
    _fmt("float8_e4m3", 4, 3, 7, 0x77, 0x7C, 0x78, overflow="inf"),
    # fnuz: no infinity, no negative zero, NaN is the negative zero's code
    _fmt("float8_e4m3fnuz", 4, 3, 8, 0x7F, 0x80, neg_zero=False, nan_signed=False,
         torch_name="float8_e4m3fnuz"),
    _fmt("float8_e5m2fnuz", 5, 2, 16, 0x7F, 0x80, neg_zero=False, nan_signed=False,
         torch_name="float8_e5m2fnuz"),
    _fmt("float8_e4m3b11fnuz", 4, 3, 11, 0x7F, 0x80, neg_zero=False, nan_signed=False),
    # powers of two: no sign, no zero (0 and negatives are NaN), float32's
    # exponent
    _fmt("float8_e8m0fnu", 8, 0, 127, 0xFE, 0xFF, signed=False, neg_zero=False,
         nan_signed=False, subnormals=False, torch_name="float8_e8m0fnu"),
    # no infinity, no NaN: overflow saturates, NaN gives -0 (+0 if negative)
    _fmt("float4_e2m1fn", 2, 1, 1, 0x07, 0x08, overflow="saturate", has_nan=False),
)}


def encode(x: torch.Tensor, fmt: SmallFloat) -> torch.Tensor:
    """float32 or float16 (any shape) -> the format's codes (int64), plain
    PyTorch on the float32 bits: ml_dtypes' conversion, code for code."""
    x = _f32(x)
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    a = bits & 0x7FFFFFFF
    nan, inf, zero = a > 0x7F800000, a == 0x7F800000, a == 0
    if fmt.subnormals:
        mant, ex = torch.frexp(torch.where(nan | inf | zero, torch.ones_like(x), x.abs()))
        m24 = (mant * 2.0**24).to(torch.int64)  # the significand, [2**23, 2**24)
        e = ex.to(torch.int64) - 1
        emin = 1 - fmt.bias
        t = torch.clamp(e, min=emin)  # the exponent the result is quantised at
        shift = torch.clamp(23 - fmt.mbits + t - e, max=30)
        odd = torch.bitwise_right_shift(m24, shift) & 1
        half = torch.bitwise_left_shift(torch.ones_like(shift), shift - 1)
        q = torch.bitwise_right_shift(m24 + half - 1 + odd, shift)
        code = ((t - emin) << fmt.mbits) + q
    else:  # float32's exponent field: ml_dtypes rounds float32's bits to
        # nearest, ties to even, the kept LSB being the implicit bit where
        # mbits is 0 (so float32 normals' ties go up, subnormals' down)
        shift = 23 - fmt.mbits
        lsb = ((a | ((a >= 0x800000).to(torch.int64) << 23)) >> shift) & 1
        code = (a + (1 << (shift - 1)) - 1 + lsb) >> shift
    code = torch.where(zero, 0, code)
    over = (code > fmt.max_code) | inf
    sign = torch.where(neg, fmt.sign_bit, 0)
    nan_code = sign ^ fmt.nan_code if fmt.nan_signed else fmt.nan_code
    if fmt.overflow == "inf":
        over_code = sign | fmt.inf_code
    elif fmt.overflow == "saturate":
        over_code = sign | fmt.max_code
    else:
        over_code = nan_code
    if fmt.signed:
        signed = code | sign
        out = signed if fmt.neg_zero else torch.where(code == 0, code, signed)
    else:
        out = torch.where(neg | zero, nan_code, code)
    out = torch.where(over, over_code, out)
    return torch.where(nan, nan_code, out)


def _nan(neg: torch.Tensor) -> torch.Tensor:
    """float32 quiet NaNs, negative where `neg`."""
    return torch.where(neg, -0x400000, 0x7FC00000).to(torch.int32).view(torch.float32)


def decode(codes: torch.Tensor, fmt: SmallFloat) -> torch.Tensor:
    """The format's codes (any integer dtype) -> their values as float32,
    built from float32's bits; a NaN code gives a NaN with its sign where
    the format's NaNs carry one."""
    c = codes.to(torch.int64)
    neg = (c & fmt.sign_bit) != 0
    mag = c & ~fmt.sign_bit
    field, m = mag >> fmt.mbits, mag & ((1 << fmt.mbits) - 1)
    fe = field - fmt.bias + 127
    sig = (1 << 23) | (m << (23 - fmt.mbits))
    bits = torch.where(fe >= 1, (fe.clamp(min=0) << 23) | (sig & 0x7FFFFF),
                       sig >> (1 - fe).clamp(0, 31))
    if fmt.inf_code >= 0:
        bits = torch.where(mag == fmt.inf_code, 0x7F800000, bits)
    v = bits.to(torch.int32).view(torch.float32)
    if fmt.subnormals:  # field 0: m 2**(1 - bias - mbits), exact
        v = torch.where(field == 0, m.to(torch.float32) * 2.0 ** (1 - fmt.bias - fmt.mbits), v)
    v = torch.where(neg, -v, v)
    if fmt.has_nan:
        nan = ((mag > fmt.max_code) & (mag != fmt.inf_code)) | (c == fmt.nan_code)
        v = torch.where(nan, _nan(neg & fmt.nan_signed), v)
    return v


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (a NaN's sign and payload
    included)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()])))


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x as float32; a float16 NaN as float32's quiet NaN of its sign (a
    conversion on the card may drop it)."""
    if x.dtype != torch.float16:
        return x.to(torch.float32)
    bits = x.view(torch.int16)
    return torch.where((bits & 0x7FFF) > 0x7C00, _nan(bits < 0), x.to(torch.float32))


def _h(x: torch.Tensor, via_f16: bool) -> torch.Tensor:
    """float32 x, rounded to float16 with `via_f16`; a NaN keeps its sign."""
    x = _f32(x)
    return torch.where(torch.isnan(x), x, x.to(torch.float16).to(torch.float32)) if via_f16 else x


def _to(v: torch.Tensor, out: torch.dtype) -> torch.Tensor:
    """float32 values of a format as `out`, a NaN as float16's quiet NaN
    of its sign (what torch's CPU conversion gives, on any device)."""
    if out != torch.float16:
        return v.to(out)
    nan = torch.where(torch.signbit(v), -0x200, 0x7E00).to(torch.int16).view(torch.float16)
    return torch.where(torch.isnan(v), nan, v.to(torch.float16))


def round_small_float(x: torch.Tensor, fmt: SmallFloat, via_f16: bool = False) -> torch.Tensor:
    """x -> fmt(x) as float32 (fmt(f16(x)) with `via_f16`): the plain
    version of the kernel's rounding."""
    return decode(encode(_h(x, via_f16), fmt), fmt)


def relu_small_float(s: torch.Tensor, fmt: SmallFloat) -> torch.Tensor:
    """jax.nn.relu on a format's values: max(s, fmt(0)), NaN propagating,
    -0 giving +0 (float8_e8m0fnu has no zero: fmt(0) is a NaN, and so is
    every output)."""
    if not fmt.signed:  # float8_e8m0fnu: fmt(0) is its NaN
        return torch.full_like(s, float("nan"))
    return torch.where((s > 0) | torch.isnan(s), s, 0.0)


def conv_epilogue_reference(y: torch.Tensor, bias: torch.Tensor, fmt: SmallFloat,
                            relu: bool, out: torch.dtype | None = None) -> torch.Tensor:
    """The epilogue's plain version: y (B, C, H, W) float32 or float16,
    bias (C,) float32 -> the layer's output in `out` (fmt's carrier
    dtype by default)."""
    h = fmt.via_f16
    y = _f32(y)
    default_nan = _nan(torch.ones_like(y, dtype=torch.bool))  # x86's, negative
    r = round_small_float(torch.where(torch.isnan(y), default_nan, y), fmt, h)
    b = round_small_float(bias.detach(), fmt).view(-1, 1, 1)
    total = r + b
    total = torch.where(torch.isnan(total), torch.where(
        torch.isnan(r), r, torch.where(torch.isnan(b), b, default_nan)), total)
    s = round_small_float(total, fmt, h)
    return _to(relu_small_float(s, fmt) if relu else s, out or fmt.carrier)


OUT_DTYPES = (torch.float32, torch.float16, torch.uint8)  # the kernel's outputs, by code


def cast_reference(x: torch.Tensor, fmt: SmallFloat, out: torch.dtype | None = None
                   ) -> torch.Tensor:
    """The direct mode's plain version, on any device: fmt(x) as `out`
    (float32, float16 = fmt's carrier, the default, or uint8 codes)."""
    out = _out_dtype(fmt, out)
    x = _f32(x.detach())
    if out == torch.uint8:
        return encode(x, fmt).to(torch.uint8)
    return _to(round_small_float(x, fmt), out)


def _out_dtype(fmt: SmallFloat, out: torch.dtype | None) -> torch.dtype:
    out = out or fmt.carrier
    if out not in OUT_DTYPES or (out == torch.float16 and not fmt.via_f16):
        raise ValueError(f"{fmt.name} cannot be written as {out}")
    return out


def _launch(what: str, fn: str, dev: torch.device, *args) -> None:
    global LAUNCHES
    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    LAUNCHES += 1


def _check_input(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in IN_DTYPES:
        raise ValueError(f"{name} must be float32 or float16, got {t.dtype}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} must hold fewer than 2**31 elements, got {t.numel()}")


def cast(x: torch.Tensor, fmt: SmallFloat, out: torch.dtype | None = None) -> torch.Tensor:
    """fmt(x) of a float32 or float16 tensor as `out`: float32, float16
    (fmt's carrier, the default) or uint8 (the codes). The plain version
    on the CPU, one launch of the kernel's direct mode for CUDA tensors.
    Not differentiable."""
    out = _out_dtype(fmt, out)
    if x.device.type == "cpu":
        return cast_reference(x, fmt, out)
    _check_input("x", x)
    x = x.detach().contiguous()
    res = torch.empty(x.shape, dtype=out, device=x.device)
    if x.numel():
        _launch("small_float cast", "tf_small_float_cast", x.device, x.data_ptr(),
                IN_DTYPES.index(x.dtype), res.data_ptr(), OUT_DTYPES.index(out), x.numel(),
                _params(fmt))
    return res


@functools.lru_cache(maxsize=None)
def _params(fmt: SmallFloat):
    return (ctypes.c_int * N_PARAMS)(*fmt.params())


def _epilogue(y: torch.Tensor, bias: torch.Tensor, fmt: SmallFloat, relu: bool,
              out: torch.dtype | None) -> torch.Tensor:
    out = _out_dtype(fmt, out)
    if out == torch.uint8:
        raise ValueError("the epilogue writes values, not codes")
    if y.device.type == "cpu":
        return conv_epilogue_reference(y, bias, fmt, relu, out)
    _check_input("y", y)
    if y.dim() != 4:
        raise ValueError(f"y must be (B, C, H, W), got {tuple(y.shape)}")
    b, c, h, w = y.shape
    bias = bias.detach().to(torch.float32).contiguous()
    if tuple(bias.shape) != (c,) or bias.device != y.device:
        raise ValueError(f"bias must be ({c},) on {y.device}, got {tuple(bias.shape)} on "
                         f"{bias.device}")
    y = y.contiguous()
    res = torch.empty(y.shape, dtype=out, device=y.device)
    if y.numel():
        key = (fmt.name, y.device)
        table = None
        if y.dtype == torch.float16 and fmt.via_f16:  # the table kernel's input
            table = _TABLES.get(key)
            if table is None:
                table = torch.empty(TABLE_BYTES, dtype=torch.uint8, device=y.device)
        _launch("small_float epilogue", "tf_small_float_epilogue", y.device, y.data_ptr(),
                IN_DTYPES.index(y.dtype), bias.data_ptr(), res.data_ptr(),
                OUT_DTYPES.index(out), b * c, c, h * w, _params(fmt), int(fmt.via_f16),
                int(relu), None if table is None else table.data_ptr(),
                int(table is not None and key not in _TABLES))
        if table is not None:
            _TABLES[key] = table  # built by this launch or an earlier one
    return res


# (format, device) -> the format's float16 code table on the device, which
# the table kernel reads; built by the first epilogue launch that needs it
_TABLES: dict = {}
TABLE_BYTES = 1 << 16  # one code a float16 bit pattern


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, fmt, relu, out):
        return _epilogue(y, bias, fmt, relu, out)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("training an FCN in a small floating-point format is not "
                                  "ported yet (no backward through the rounding epilogue)")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, fmt: SmallFloat, relu: bool = False,
                  out: torch.dtype | None = None) -> torch.Tensor:
    """A convolution's raw output y (B, C, H, W), float32 or float16 (a
    float16 y is taken as XLA's first rounding, f16(y)), and the layer's
    float32 bias (C,) -> relu?(fmt(h(fmt(h(y)) + fmt(bias)))) as `out`
    (float32, or float16 = fmt's carrier, the default): the plain version
    on the CPU, one kernel launch for CUDA tensors. Its backward raises
    NotImplementedError (autograd records it only where a gradient could
    flow: inference skips the Function's host cost)."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return _Epilogue.apply(y, bias, fmt, relu, out)
    return _epilogue(y, bias, fmt, relu, out)
