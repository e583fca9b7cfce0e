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
                  rounding where the format goes through float16;
                  differentiable, one alias of its output a consumer
  conv_epilogue_backward  the kernel's backward: the cotangents of a
                  layer's output, each rounded fmt(h(g)) and summed in
                  order, each sum rounded; relu's select; the bias
                  gradient reduced in XLA's order (`xla_sum_levels`),
                  every partial sum rounded to the format
  bias_grad       that reduce alone, on any values of the format (a
                  mesh's block of a layer's cotangent, `models/fcn.py`)
  sum_in_order    the ranks' values of a gradient combined as XLA's CPU
                  all-reduce combines a small float's
  round_grad      its no-bias mode: a dgrad's or wgrad's fmt(h(g))
  cast_for_conv   `cast` of a convolution's operand, whose backward is
                  `round_grad` (`cast`'s is the direct mode: XLA's
                  transposed convert)

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
of the format's code table, `_TABLES`), or raise. LAUNCHES counts the
forward's launches, CAST_LAUNCHES the direct casts among them; the
backward counts its launches apart (BACKWARD_LAUNCHES, and
REDUCE_LAUNCHES those that reduce a bias gradient); its first reduce on a
device in a format also builds the format's add table (`_ADD_TABLES`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpufusion_torch import _build

LAUNCHES = 0  # forward launches since import (or since a caller reset it): epilogue and cast
CAST_LAUNCHES = 0  # the direct casts among them
BACKWARD_LAUNCHES = 0  # backward launches (with its no-bias mode, and the reduce alone), apart
REDUCE_LAUNCHES = 0  # the bias gradient's reduces among them
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


def _launch(what: str, fn: str, dev: torch.device, *args, reduce: bool = False) -> None:
    global LAUNCHES, CAST_LAUNCHES, BACKWARD_LAUNCHES, REDUCE_LAUNCHES
    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, what)
    if fn in ("tf_small_float_backward", "tf_small_float_bias_grad"):
        BACKWARD_LAUNCHES += 1
        REDUCE_LAUNCHES += int(reduce)
    else:
        LAUNCHES += 1
        CAST_LAUNCHES += int(fn.startswith("tf_small_float_cast"))


def _check_input(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {t.device}")
    if t.dtype not in IN_DTYPES:
        raise ValueError(f"{name} must be float32 or float16, got {t.dtype}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} must hold fewer than 2**31 elements, got {t.numel()}")


CAST_MAX_CHANNELS = 64  # a channels-last input the kernel transposes (else copied first)


def _cast(x: torch.Tensor, fmt: SmallFloat, out: torch.dtype) -> torch.Tensor:
    if x.device.type == "cpu":
        return cast_reference(x, fmt, out)
    _check_input("x", x)
    x = x.detach()
    res = torch.empty(x.shape, dtype=out, device=x.device)
    if not x.numel():
        return res
    if x.is_contiguous():
        shape = 1, x.numel(), 1
    elif (x.dim() == 4 and x.shape[1] <= CAST_MAX_CHANNELS
          and x.is_contiguous(memory_format=torch.channels_last)):
        shape = x.shape[0], x.shape[2] * x.shape[3], x.shape[1]  # NHWC: (B, H W, C)
    else:
        return _cast(x.contiguous(), fmt, out)
    _launch("small_float cast", "tf_small_float_cast", x.device, x.data_ptr(),
            IN_DTYPES.index(x.dtype), res.data_ptr(), OUT_DTYPES.index(out), *shape,
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
    """The epilogue, returned as `uses` aliases of one output: one for
    each consumer, so that each consumer's cotangent reaches `backward`
    apart (None where a consumer is not on the graph) and they are summed
    in XLA's order, each sum rounded to the format."""

    @staticmethod
    def forward(ctx, y, bias, fmt, relu, out, uses, bias_block):
        ctx.set_materialize_grads(False)
        if relu and not fmt.signed:  # its relu is a NaN: keep the sum relu selects on
            s = _epilogue(y, bias, fmt, False, out)
            res = torch.full_like(s, float("nan"))
            ctx.save_for_backward(s)
        else:
            res = _epilogue(y, bias, fmt, relu, out)
            ctx.save_for_backward(res if relu else None)
        ctx.fmt, ctx.relu, ctx.y_dtype = fmt, relu, y.dtype
        ctx.bias_grad, ctx.bias_block = bias.requires_grad, bias_block
        return tuple([res] + [res.view_as(res) for _ in range(uses - 1)])

    @staticmethod
    def backward(ctx, *grads):
        grads = [g for g in grads if g is not None]
        (saved,) = ctx.saved_tensors
        if not grads:
            return (None,) * 7
        block = ctx.bias_block if ctx.bias_grad else None
        gy, gb = conv_epilogue_backward(grads, saved, ctx.fmt, ctx.relu, out=ctx.y_dtype,
                                        bias=ctx.bias_grad and block is None)
        if block is not None:
            gb = bias_grad(block(gy), ctx.fmt)
        return gy, gb, None, None, None, None, None


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, fmt: SmallFloat, relu: bool = False,
                  out: torch.dtype | None = None, uses: int = 1, bias_block=None):
    """A convolution's raw output y (B, C, H, W), float32 or float16 (a
    float16 y is taken as XLA's first rounding, f16(y)), and the layer's
    float32 bias (C,) -> relu?(fmt(h(fmt(h(y)) + fmt(bias)))) as `out`
    (float32, or float16 = fmt's carrier, the default): the plain version
    on the CPU, one kernel launch for CUDA tensors. Where a gradient can
    flow it returns `uses` aliases of the output (a tuple where `uses` >
    1), one a consumer, in the order their cotangents are summed
    (`conv_epilogue_backward`); autograd records nothing otherwise
    (inference skips the Function's host cost). `bias_block` given (a
    rank's layout on a mesh: the cotangent of y -> the block its bias
    gradient reduces), the bias gradient is `bias_grad` of that block."""
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        res = _Epilogue.apply(y, bias, fmt, relu, out, uses, bias_block)
        return res[0] if uses == 1 else res
    res = _epilogue(y, bias, fmt, relu, out)
    return res if uses == 1 else (res,) * uses


# -- backward --------------------------------------------------------------
#
# XLA's gradient of the same layer (its optimized HLO on the CPU): each
# consumer's cotangent of a layer's output arrives as a convolution's
# float32 result (the next layer's dgrad), rounded f32 -> h -> format, or
# as format values (the output's transposed convert f32 -> format,
# direct); the cotangents of an output that feeds several consumers are
# added in float16 in the order JAX's backward pass meets them, each sum
# rounded to the format; relu's cotangent selects that sum where the
# forward's value (the sum relu took) is > 0, else fmt(0) (a NaN in
# float8_e8m0fnu); the bias gradient is a reduce of that cotangent over
# batch, height and width whose every partial sum is rounded to the
# format, in the order the CPU's TreeReductionRewriter gives (windows of
# 32 along each reduced dimension over 32, padded evenly at both ends,
# again until none is over 32; the elements of a window in row-major
# (batch, height, width) order), then format -> float32; the dgrad and
# wgrad are float32 convolutions rounded f32 -> h -> format, and the
# casts of the input and the kernel transpose into plain converts.

XLA_WINDOW = 32  # the CPU's TreeReductionRewriter's window
_PAD = -1  # a padded position of a window: skipped, as XLA's reduce-window skips it
MAX_GRADS = 3  # the cotangents one backward launch sums (the FCN's c1 has three consumers)
# (format, device) -> the format's add table on the device (`add_table`'s
# codes as uint8, x-major: [x, acc]), built by the first launch that needs it
_ADD_TABLES: dict = {}
_COUNTERS: dict = {}  # device -> the reduce's count of finished CTAs (back to 0 at its end)
SEGMENT_WARPS = 16  # the reduce's segments aim at this many warps an SM
_SMS: dict = {}  # device -> its multiprocessors


def xla_sum_levels(dims: tuple[int, ...]) -> list[tuple[tuple[int, int, int], ...]]:
    """The windows XLA's CPU reduces `dims` (the reduced sizes, major to
    minor) through: one level a rewrite, each dimension's (window, count,
    low padding); the last level's windows are whole dimensions (a plain
    reduce)."""
    levels = []
    dims = tuple(dims)
    while True:
        if all(n <= XLA_WINDOW for n in dims):
            levels.append(tuple((n, 1, 0) for n in dims))
            return levels
        level = []
        for n in dims:
            w = min(n, XLA_WINDOW)
            count = -(-n // w)
            level.append((w, count, (count * w - n) // 2))
        levels.append(tuple(level))
        dims = tuple(c for _, c, _ in level)


def _n_codes(fmt: SmallFloat) -> int:
    return 1 << (fmt.ebits + fmt.mbits + int(fmt.signed))


def _nan_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b in float32 with x86's NaNs: a's NaN, else b's, else (inf -
    inf) the default NaN."""
    total = a + b
    default = _nan(torch.ones_like(a, dtype=torch.bool))
    first = torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, default))
    return torch.where(torch.isnan(total), first, total)


@functools.lru_cache(maxsize=None)
def add_table(fmt: SmallFloat) -> torch.Tensor:
    """The codes of fmt(h(a + b)) for every pair (a, b) of the format's
    codes, (n, n) int64: the step of the bias gradient's reduce, whose
    initial value is fmt(0) (a NaN in float8_e8m0fnu, so its every bias
    gradient is one, as XLA's)."""
    n = _n_codes(fmt)
    v = decode(torch.arange(n), fmt)
    return encode(_h(_nan_add(v.view(-1, 1).expand(n, n), v.view(1, -1).expand(n, n)),
                     fmt.via_f16), fmt)


def bias_grad_reference(g: torch.Tensor, fmt: SmallFloat) -> torch.Tensor:
    """XLA's bias gradient of a layer: g (B, C, H, W), the cotangent of
    the convolution's output (the format's values, float32 or float16)
    -> (C,) float32, reduced over batch, height and width through
    `xla_sum_levels`, every partial sum rounded to the format."""
    n = _n_codes(fmt)
    table = add_table(fmt).reshape(-1).to(g.device)
    c = g.shape[1]
    codes = encode(_f32(g), fmt).permute(1, 0, 2, 3)  # (C, B, H, W)
    for windows in xla_sum_levels(tuple(codes.shape[1:])):
        pads = [(lo, w * count - size - lo) for (w, count, lo), size in zip(windows,
                                                                            codes.shape[1:])]
        codes = torch.nn.functional.pad(codes, [p for lo_hi in pads[::-1] for p in lo_hi],
                                        value=_PAD)
        (wb, cb, _), (wh, ch, _), (ww, cw, _) = windows
        rows = codes.reshape(c, cb, wb, ch, wh, cw, ww).permute(0, 1, 3, 5, 2, 4, 6)
        rows = rows.reshape(c * cb * ch * cw, wb * wh * ww)
        acc = encode(torch.zeros(rows.shape[0], device=g.device), fmt)  # the initial fmt(0)
        for k in range(rows.shape[1]):
            x = rows[:, k]
            acc = torch.where(x == _PAD, acc, table[acc * n + x.clamp(min=0)])
        codes = acc.view(c, cb, ch, cw)
    return decode(codes.reshape(c), fmt)


def bias_grad(g: torch.Tensor, fmt: SmallFloat) -> torch.Tensor:
    """`bias_grad_reference`'s contract: the plain version on the CPU, one
    launch of the kernel's reduce for a CUDA g (B, C, H, W) of the
    format's values (float32 or float16, any strides), counted in
    BACKWARD_LAUNCHES."""
    if g.device.type == "cpu":
        return bias_grad_reference(g, fmt)
    _check_input("g", g)
    if g.dim() != 4:
        raise ValueError(f"g must be (B, C, H, W), got {tuple(g.shape)}")
    b, c, hh, w = g.shape
    gb = torch.empty(c, dtype=torch.float32, device=g.device)
    if g.numel():
        levels = xla_sum_levels((b, hh, w))
        flat = [v for level in levels for dim in level for v in dim]
        r = _Reduce(fmt, g.device, levels, c)
        _launch("small_float bias gradient", "tf_small_float_bias_grad", g.device, g.data_ptr(),
                IN_DTYPES.index(g.dtype), (ctypes.c_longlong * 4)(*g.stride()), b, c, hh, w,
                gb.data_ptr(), (ctypes.c_int * len(flat))(*flat), len(levels), *r.args(),
                _params(fmt), int(fmt.via_f16), reduce=True)
        r.done()
    return gb


def sum_in_order(parts, fmt: SmallFloat) -> torch.Tensor:
    """Rank values of one gradient combined as XLA's CPU all-reduce
    combines a small float's (its partitioned program carries them in
    float16): parts[0] + parts[1] + ..., in order, each sum rounded to
    float16 (float32 for float8_e8m0fnu), x86's NaNs, then the total
    rounded to the format (`cast`: one launch for CUDA tensors), as
    float32."""
    acc = _f32(parts[0])
    for p in parts[1:]:
        acc = _h(_nan_add(acc, _f32(p)), fmt.via_f16)
    return cast(acc, fmt, out=torch.float32)


def conv_epilogue_backward_reference(grads, saved: torch.Tensor | None, fmt: SmallFloat,
                                     relu: bool, out: torch.dtype | None = None,
                                     bias: bool = True):
    """The backward's plain version. `grads`: the cotangents of one
    layer's output, (B, C, H, W) each, float32 or float16, any strides,
    in the order XLA sums them (a convolution's raw result, or the
    format's values); `saved`: the forward's output where `relu` (the sum
    relu took, for a format without zero) -> (the cotangent of the
    convolution's output in `out` (fmt's carrier by default), the bias
    gradient (C,) float32, or None without `bias`)."""
    h = fmt.via_f16
    acc = None
    for g in grads:
        t = round_small_float(g, fmt, h)
        acc = t if acc is None else round_small_float(_nan_add(acc, t), fmt, h)
    if relu:
        acc = torch.where(_f32(saved) > 0, acc, round_small_float(torch.zeros(()), fmt))
    gb = bias_grad_reference(acc, fmt) if bias else None
    return _to(acc, out or fmt.carrier), gb


def conv_epilogue_backward(grads, saved: torch.Tensor | None, fmt: SmallFloat, relu: bool,
                           out: torch.dtype | None = None, bias: bool = True):
    """The epilogue's backward (`conv_epilogue_backward_reference`'s
    contract): the plain version on the CPU, one launch of the kernel's
    backward for CUDA tensors (at most three cotangents)."""
    out = _out_dtype(fmt, out)
    if out == torch.uint8:
        raise ValueError("the backward writes values, not codes")
    grads = list(grads)
    if not grads or len(grads) > MAX_GRADS:
        raise ValueError(f"the backward sums 1 to {MAX_GRADS} cotangents, got {len(grads)}")
    shape = tuple(grads[0].shape)
    if len(shape) != 4 or any(tuple(g.shape) != shape for g in grads):
        raise ValueError(f"the cotangents must be one (B, C, H, W) shape, got "
                         f"{[tuple(g.shape) for g in grads]}")
    if relu and (saved is None or tuple(saved.shape) != shape):
        raise ValueError("relu's backward needs the forward's output of the cotangents' shape")
    if all(g.device.type == "cpu" for g in grads):
        return conv_epilogue_backward_reference(grads, saved, fmt, relu, out, bias)
    dev = grads[0].device
    for i, g in enumerate(grads):
        _check_input(f"grads[{i}]", g)
        if g.device != dev:
            raise ValueError(f"grads[{i}] is on {g.device}, not {dev}")
    if relu:
        _check_input("saved", saved)
        saved = saved.contiguous()
    b, c, hh, w = shape
    res = torch.empty(shape, dtype=out, device=dev)
    gb = torch.empty(c, dtype=torch.float32, device=dev) if bias else None
    if res.numel():
        ptrs = (ctypes.c_void_p * MAX_GRADS)(*[g.data_ptr() for g in grads])
        kinds = (ctypes.c_int * MAX_GRADS)(*[IN_DTYPES.index(g.dtype) for g in grads])
        strides = (ctypes.c_longlong * (4 * MAX_GRADS))(*[s for g in grads for s in g.stride()])
        levels = xla_sum_levels((b, hh, w)) if bias else []
        flat = [v for level in levels for dim in level for v in dim]
        lv = (ctypes.c_int * max(len(flat), 1))(*flat)
        r = _Reduce(fmt, dev, levels, c) if bias else None
        _launch("small_float backward", "tf_small_float_backward", dev, ptrs, kinds, strides,
                len(grads), None if saved is None else saved.data_ptr(),
                IN_DTYPES.index(saved.dtype) if relu else 0, int(relu), res.data_ptr(),
                OUT_DTYPES.index(out), b, c, hh, w,
                None if gb is None else gb.data_ptr(), lv, len(levels),
                *(r.args() if r else (None, 0, None, 0, None, None)), _params(fmt),
                int(fmt.via_f16), reduce=r is not None)
        if r:
            r.done()
    return res, gb


def reduce_segments(levels, channels: int, sms: int) -> int:
    """The runs the reduce cuts each chain (a channel's first-level window
    of `levels`, `xla_sum_levels`) into, whole (b, h) rows each: enough
    that chains x segments give each of `sms` multiprocessors
    SEGMENT_WARPS warps, at most a window's rows."""
    (wb, cb, _), (wh, ch, _), (_, cw, _) = levels[0]
    return max(1, min(-(-SEGMENT_WARPS * sms // (channels * cb * ch * cw)), wb * wh))


class _Reduce:
    """The device buffers of one launch of the bias gradient's reduce: the
    format's add table (built by this launch where the device has none
    yet), the segments' maps, the first level's scratch, the CTA counter;
    a chain (a channel's first-level window) cut into segments so that
    chains x segments give each multiprocessor SEGMENT_WARPS warps."""

    def __init__(self, fmt: SmallFloat, dev: torch.device, levels, channels: int):
        self.key = (fmt.name, dev)
        n = _n_codes(fmt)
        self.table = _ADD_TABLES.get(self.key)
        self.build = self.table is None
        if self.build:
            self.table = torch.empty(n * n, dtype=torch.uint8, device=dev)
        self.counter = _COUNTERS.get(dev)
        if self.counter is None:
            self.counter = _COUNTERS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
        (_, cb, _), (_, ch, _), (_, cw, _) = levels[0]
        chains = channels * cb * ch * cw
        if dev not in _SMS:
            _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        self.segments = reduce_segments(levels, channels, _SMS[dev])
        self.maps = torch.empty(chains * self.segments * n, dtype=torch.uint8, device=dev)
        self.scratch = torch.empty(2 * chains, dtype=torch.int32, device=dev)

    def args(self) -> tuple:
        return (self.table.data_ptr(), int(self.build), self.maps.data_ptr(), self.segments,
                self.scratch.data_ptr(), self.counter.data_ptr())

    def done(self) -> None:
        _ADD_TABLES[self.key] = self.table


def round_grad(g: torch.Tensor, fmt: SmallFloat, out: torch.dtype | None = None
               ) -> torch.Tensor:
    """A convolution's raw gradient (dgrad or wgrad, float32 or float16)
    rounded as XLA rounds it, fmt(h(g)), with no bias, as `out` (float32
    or fmt's carrier): the backward's no-bias mode (one launch for a CUDA
    tensor), its plain version on the CPU; g (B, C, H, W), a dgrad's or a
    kernel's (HWIO) layout alike."""
    return conv_epilogue_backward([g], None, fmt, False, out, bias=False)[0]


def backward_against_plain(grads, saved, fmt: SmallFloat, relu: bool,
                           out: torch.dtype | None = None, bias: bool = True) -> tuple:
    """The backward on CUDA tensors (one launch) and its plain version on
    their CPU copies -> (the kernel's cotangent and bias gradient on the
    CPU, the plain version's, both bit for bit)."""
    got = conv_epilogue_backward(grads, saved, fmt, relu, out, bias)
    want = conv_epilogue_backward_reference([g.cpu() for g in grads],
                                            None if saved is None else saved.cpu(), fmt, relu,
                                            out, bias)
    got = tuple(None if t is None else t.cpu() for t in got)
    same = all(w is None if g is None else same_bits(g, w) for g, w in zip(got, want))
    return got, want, same


class _Cast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt, out, conv_grad):
        ctx.fmt, ctx.in_dtype, ctx.conv_grad = fmt, x.dtype, conv_grad
        return _cast(x, fmt, out)

    @staticmethod
    def backward(ctx, g):
        if ctx.conv_grad:
            return round_grad(g, ctx.fmt, ctx.in_dtype), None, None, None
        return _cast(g, ctx.fmt, ctx.in_dtype), None, None, None


def cast(x: torch.Tensor, fmt: SmallFloat, out: torch.dtype | None = None) -> torch.Tensor:
    """fmt(x) of a float32 or float16 tensor as `out`: float32, float16
    (fmt's carrier, the default) or uint8 (the codes). The plain version
    on the CPU, one launch of the kernel's direct mode for CUDA tensors.
    Values are differentiable: the backward is XLA's transposed convert,
    fmt(g) in x's dtype (the direct mode again)."""
    out = _out_dtype(fmt, out)
    if out != torch.uint8 and torch.is_grad_enabled() and x.requires_grad:
        return _Cast.apply(x, fmt, out, False)
    return _cast(x, fmt, out)


def cast_for_conv(x: torch.Tensor, fmt: SmallFloat, out: torch.dtype | None = None
                  ) -> torch.Tensor:
    """`cast` of a convolution's operand (the input, a kernel): its
    backward takes the convolution's raw gradient and rounds it as XLA
    rounds the dgrad and the wgrad, fmt(h(g)), into x's dtype
    (`round_grad`), which the transposed convert then keeps."""
    out = _out_dtype(fmt, out)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Cast.apply(x, fmt, out, True)
    return _cast(x, fmt, out)
