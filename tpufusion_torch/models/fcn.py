"""Fully convolutional segmentation + regression network (counterpart of
`tpufusion/models/fcn.py::FCN`).

  input (B, H, W, C) NHWC
    -> feature-wise BatchNorm (eps 1e-3; running stats, or with
       train=True the batch's, which also move the running stats), or
       the per-pixel-position SampleWiseBN
    -> zero-pad width (0, 3)
    -> conv1/2/3 5x5, strides (vs, 4)/(vs, 2)/(vs, 2), relu
    -> deconv4 (vs, 2) relu, concat conv2
    -> cls: deconv5a (vs, 2) relu, crop left crop5, concat conv1,
            deconv6a (vs, 4), crop to W, softmax, clip(1e-7, 1)
    -> reg: deconv5b/6b mirror (linear, or relu for a relu corner head)
  output (B, H, W, 2 + reg) NHWC, float32
  features(x): the pre-softmax deconv6a map, NHWC, compute dtype

vs = 1 for the lidar range view (32 x 1801 x 3) and the BEV (180 x 1197
x 3), vs = 2 without the regression branch for the camera (512 x 1368 x 1).

dtype "bfloat16" (or "float16") computes as flax does with dtype=bf16
(float16) and float32 params: each conv casts its input, kernel and bias
to the compute dtype and adds the bias after the convolution,
activations stay in it between layers, the BatchNorm runs on the float32
input, the softmax on d6a cast to float32, and the regression output is
cast to float32. Parameters stay float32, so the same npz loads for any
dtype. Dtype names resolve as `jnp.dtype` reads them (`compute_dtype`):
"half" is float16, "float64" computes in float32 with a warning (JAX
without x64), a name that is not inexact raises (the float6 names among
them, as JAX raises at its first call).

The small floats (the eight "float8_*" names and "float4_e2m1fn", see
`ops/small_float.py`) compute as XLA computes flax's convolution in
them: the normalised, padded input and each kernel are cast to the
format once (the kernel's direct mode), the convolution runs on torch's
ops on the format's values, and one epilogue launch a layer rounds its
output twice (through float16, as XLA does), adds the layer's bias in
the format, rounds again and applies the layer's relu
(`small_float.conv_epilogue`). Between layers the values travel in
SMALL_FLOAT_CONV (float32 for float8_e8m0fnu, which float16 cannot
hold); the output is float32, and `features` comes back in torch's dtype
of the format's name where torch has one, else float16 holding the
values. "complex64" computes the float32 net (JAX's complex net has a
zero imaginary part throughout) and returns complex64 features;
"complex128" does the same after JAX's x64 warning; both train as the
float32 net (JAX's gradients of its complex net are float32's).

Training a small float follows XLA's gradient of the same net: each
layer's epilogue is an autograd Function whose backward
(`small_float.conv_epilogue_backward`, one launch) takes the cotangents
of the layer's output one consumer apart (c1, c2 and d4 feed several:
`uses` aliases, summed in the order JAX's backward pass meets them, each
sum rounded to the format), applies relu's select and reduces the bias
gradient in XLA's order; the dgrad and wgrad run in float32 with TF32
off (`_GradConv`) and come back through
float16 and the format (`small_float.cast_for_conv`'s backward for the
input and the kernels); the outputs' float32 casts take the format's
rounding of their cotangent back (`small_float.cast`). Parameters and
their gradients stay float32.

On a mesh a small float's gradient follows XLA's partitioned program
(its HLO for JAX's sharded step): each layer's dgrad is the whole float32
sum for the columns a rank owns before any rounding (the halo exchange
sums its neighbours' partial dgrads in float32: each consumer fetches its
own float32 window), the fan-outs' cotangents are summed in the format as
off the mesh, a transposed convolution's wgrad is summed over the spatial
axis in float32 before its rounding (XLA gathers the width for it), and
each bias gradient reduces a rank's block of XLA's layout of the layer's
whole output (`gradient_blocks`: ceil(W / k) columns, zeros past the
width and in the cropped columns). The ranks' gradients are then combined
in the format (`gradient_plan`, `parallel.mesh.reduce_gradients`).

Weights keep flax's layouts (kernels HWIO) in the state dict so the npz
keys and arrays load as they are; the forward maps them to torch's:
flax "SAME" pads more at the end for strided convs, so padding is an
explicit `F.pad`; flax `ConvTranspose(transpose_kernel=False)` is a conv
over the stride-dilated input with the unflipped kernel and padding
(k + s - 2) split as jax's `_conv_transpose_padding`.
Convolutions go to torch's own conv ops (cuDNN on the card) and their
gradients to autograd, as the reference leaves both to XLA.

Training: `forward(x, train=True)` normalises with the batch's statistics
as flax does. `torch.nn.BatchNorm2d` is not used: it keeps the unbiased
variance in its running stats and another momentum convention; flax keeps
the biased one, `ra = 0.99 ra + 0.01 batch`, and computes the variance as
E[x^2] - E[x]^2 in float32. In bf16 the parameters and their gradients
stay float32 (each conv casts its kernel, and the cast is differentiable).

On a mesh (`forward(x, train=True, mesh=...)`, see `parallel/mesh.py`)
the batch statistics are the global batch's, as XLA's SPMD computes
flax's over a sharded array: BatchNorm takes E[x] and E[x^2] over the
whole mesh (on a spatial mesh each rank's sums over its data row's global
count, summed), SampleWiseBN the mean and then the centred second moment
(jnp.var's two passes) of each position over the data axis, each through
a differentiable all-reduce. `torch.nn.SyncBatchNorm` is not used: it
keeps the unbiased variance and torch's momentum. Every rank's running
statistics move alike. On a mesh of one, BatchNorm runs the plain path's
ops bit for bit.

On a spatial mesh (`forward(x, mesh=..., width=W)`, x this rank's columns
of a global width W) every layer computes the columns it owns of its own
global output, in `column_blocks` of that output's width, from a window
of its input fetched with its neighbours' edge columns
(`parallel/halo.py`): 1801 -> 1804 -> 451 -> 226 -> 113 -> 226 -> 452 ->
451 -> 1804 -> 1801 at full width, every level's blocks uneven. The output
holds this rank's columns of the global output.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpufusion_torch._precision import full_f32_convs
from tpufusion_torch.config import ModelConfig
from tpufusion_torch.ops import small_float as sf
from tpufusion_torch.geometry.encoding import (  # noqa: F401  (re-exported)
    DIRECT_CHANNELS,
    DIRECT_CHANNELS_DUAL,
)
from tpufusion_torch.parallel.halo import block_columns, fetch_columns
from tpufusion_torch.parallel.mesh import (
    all_gather_columns,
    all_reduce_mean,
    column_blocks,
    image_sharding,
)

_KERAS_EPSILON = 1e-7
_K = 5
_NOT_INEXACT = ("float6_e2m3fn", "float6_e3m2fn")  # ml_dtypes' names JAX's FCN refuses
# The dtype of a small-float net's convolutions and of the values between
# its layers, where the format fits float16: float16 with float32
# accumulation, whose rounded output is XLA's first rounding (an H100
# gave every raw output of the asset's eight layers at 64 frames equal,
# bit for bit, to its float32 convolution's rounded to float16:
# chip_smoke.py phase 1g, PERF.md)
SMALL_FLOAT_CONV = torch.float16
COMPLEX_CAST_WARNING = ("Casting from complex to real dtypes: the FCN's complex64 output is "
                        "cast to float32 (its imaginary part is zero), as JAX warns")


def compute_dtype(name: str) -> torch.dtype | sf.SmallFloat:
    """What the convolutions compute in for ModelConfig.dtype `name`, as
    `jnp.dtype(name)` resolves it and flax computes with it: float16
    names ("float16", "half", "f2", "e") are float16, float32 names
    float32, "bfloat16" bf16; the small-float names their
    `small_float.SmallFloat`; float64 names compute in float32, as JAX
    does with x64 off, and warn; complex64 computes in float32 (the
    complex net's imaginary part is zero) and complex128 does too, after
    JAX's x64 warning. A name that is no inexact dtype (the float6
    names among them) raises ValueError, as JAX does."""
    if name == "bfloat16":
        return torch.bfloat16
    fmt = sf.FORMATS.get(name)
    if fmt is not None:
        return fmt
    if name in _NOT_INEXACT:
        raise ValueError(f"FCN dtype must be inexact, got {name!r}")
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown FCN dtype {name!r}") from None
    if dt.kind == "c" and dt.itemsize in (8, 16):
        if dt.itemsize == 16:
            warnings.warn(f"FCN dtype {name!r}: complex128 is not available (JAX without "
                          "x64) and is truncated to complex64", UserWarning, stacklevel=2)
        return torch.float32
    if dt.kind != "f":
        raise ValueError(f"FCN dtype must be inexact, got {name!r}")
    if dt.itemsize == 2:
        return torch.float16
    if dt.itemsize == 4:
        return torch.float32
    if dt.itemsize == 8:
        warnings.warn(f"FCN dtype {name!r}: float64 is not enabled (JAX without x64), "
                      "computing in float32", UserWarning, stacklevel=2)
        return torch.float32
    raise ValueError(f"unknown FCN dtype {name!r}")


def _is_complex(name: str) -> bool:
    try:
        return np.dtype(name).kind == "c"
    except TypeError:
        return False


def _same_pad(n: int, s: int, k: int = _K) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pad(s: int, k: int = _K, padding: str = "SAME") -> tuple[int, int]:
    """jax's _conv_transpose_padding(k, s, padding)."""
    if padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        return k - 1, pad_len - (k - 1)
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


def _check_padding(padding: str) -> str:
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return padding


def _bias(bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """flax's `y += bias` after the convolution, in the compute dtype."""
    return bias.to(x.dtype).view(-1, 1, 1)


def uniform_init_(model: nn.Module, seed: int | torch.Generator) -> None:
    """Draws every `kernel` of `model` from U(-0.05, 0.05) (keras's
    random_uniform, the reference FCN's initializer) with a CPU generator
    made from `seed` (or the generator itself); biases and the BatchNorm
    stay as built (zeros, the identity). The distribution is the
    reference's; the values are not its values for the same seed."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith("kernel"):
                param.copy_(torch.rand(param.shape, generator=gen) * 0.1 - 0.05)


class _Layer(nn.Module):
    """What Conv and ConvTranspose share: the kernel and bias, and the
    small-float format the FCN sets (`fmt`, None otherwise)."""

    def __init__(self, cin: int, cout: int, strides: tuple[int, int], padding: str):
        super().__init__()
        self.strides = strides
        self.padding = _check_padding(padding)
        self.kernel = nn.Parameter(torch.zeros(_K, _K, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.fmt: sf.SmallFloat | None = None
        self._cast: tuple | None = None  # (the kernel's state, its cast to fmt)

    def _weight(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel OIHW in x's dtype; in a small float its cast to the
        format in the dtype the FCN's values travel in (`FCN.act_dtype`;
        one launch, kept while the kernel's storage and version and the
        inference mode stay: inference casts it once; where its gradient
        is taken, cast each call, differentiably)."""
        if self.fmt is None:
            return self.kernel.to(x.dtype).permute(3, 2, 0, 1)
        k = self.kernel
        dtype = SMALL_FLOAT_CONV if self.fmt.via_f16 else torch.float32
        if torch.is_grad_enabled() and k.requires_grad:
            return sf.cast_for_conv(k, self.fmt, out=dtype).permute(3, 2, 0, 1)
        state = (k.data_ptr(), k._version, dtype, self.fmt, torch.is_inference_mode_enabled())
        if self._cast is None or self._cast[0] != state:
            self._cast = state, sf.cast(k, self.fmt, out=dtype).permute(3, 2, 0, 1)
        return self._cast[1]

    def _conv(self, x: torch.Tensor, w: torch.Tensor, stride=1, group=None, xs=None,
              dilated=None) -> torch.Tensor:
        """F.conv2d(x, w) in w's dtype; in a small float where a gradient
        flows, with the dgrad and wgrad in float32 (`_GradConv`; `group`
        sums the wgrad over it before its rounding; x dilated from xs as
        `dilated` says, the wgrad comes from xs)."""
        if self.fmt is not None and torch.is_grad_enabled() and (x.requires_grad
                                                                 or w.requires_grad):
            return _GradConv.apply(x, w, stride, group, xs, dilated)
        return F.conv2d(x.to(w.dtype), w, stride=stride)

    def _finish(self, y: torch.Tensor, relu: bool, uses: int = 1, bias_block=None):
        """flax's `y += bias` and the layer's relu: in y's dtype, or the
        small-float epilogue (one launch). With `uses` > 1 a tuple of
        that many aliases, one a consumer (`small_float.conv_epilogue`);
        `bias_block` is the epilogue's (a mesh's layout of the bias
        gradient's reduce)."""
        if self.fmt is not None:
            return sf.conv_epilogue(y, self.bias, self.fmt, relu, out=y.dtype, uses=uses,
                                    bias_block=bias_block)
        y = y + _bias(self.bias, y)
        y = F.relu(y) if relu else y
        return y if uses == 1 else (y,) * uses


class _GradConv(torch.autograd.Function):
    """F.conv2d(x, w, stride) in w's dtype whose dgrad and wgrad run in
    float32 with TF32 off, then come back in x's and w's dtype (float32
    -> float16: XLA's first rounding of its float32 results). Not in
    float16: XLA computes both in float32 and rounds once, and torch's
    CPU float16 dgrad and wgrad are not that rounding
    (tests/test_torch_small_float_train.py
    ::test_float16_backward_convolutions_are_not_one_rounding). A float32
    x holding the format's values (a window fetched on a spatial mesh)
    gets its dgrad in float32, unrounded; `group` given, the wgrad is
    summed over it in float32 before it is rounded.

    A transposed convolution (x dilated from xs: `dilated` is its strides
    and the offset of xs's first element in x) takes its backward from
    the strided convolution of the padded cotangent gp with the kernel
    flipped, w2: xs's dgrad is conv2d(gp, w2, stride), the kernel's wgrad
    that convolution's wgrad against xs, flipped back. The same products
    as the dilated form's, none with a zero, and no FFT: cuDNN takes FFT
    algorithms for stride-1 convolutions, whose results are not float32
    sums of the products (on an H100 at 2 frames a rank, 29 of
    deconv5a's 17,600 kernel gradient values landed 1-2 steps of
    float8_e4m3fn off JAX's). The FCN's other convolutions are strided."""

    @staticmethod
    def forward(ctx, x, w, stride, group, xs=None, dilated=None):
        ctx.save_for_backward(x if dilated is None else None, w, xs)  # a dilated x: not read
        ctx.stride, ctx.group, ctx.dilated = stride, group, dilated
        return F.conv2d(x.to(w.dtype), w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w, xs = ctx.saved_tensors
        gx = gw = gxs = None
        with full_f32_convs():
            if ctx.dilated is None:
                stride = list(ctx.stride) if isinstance(ctx.stride, tuple) else [ctx.stride] * 2
                gx, gw, _ = torch.ops.aten.convolution_backward(
                    g.float(), x.float(), w.float(), None, stride, [0, 0], [1, 1], False, [0, 0],
                    1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
            else:  # x[.., lead + s m] = xs[.., m], zeros elsewhere
                s, lead = ctx.dilated
                gp = F.pad(g.float(), [p for d in (1, 0) for p in (
                    _K - 1 - lead[d], s[d] * (xs.shape[2 + d] - 1) + lead[d] + 1 - g.shape[2 + d])])
                w2 = w.float().flip(2, 3).transpose(0, 1)
                if ctx.needs_input_grad[4]:
                    gxs = F.conv2d(gp, w2, stride=s)
                if ctx.needs_input_grad[1]:
                    gw = torch.ops.aten.convolution_backward(
                        xs.float(), gp, w2, None, list(s), [0, 0], [1, 1], False, [0, 0], 1,
                        [False, True, False])[1].flip(2, 3).transpose(0, 1)
        if gw is not None and ctx.group is not None:
            dist.all_reduce(gw, group=ctx.group)
        return (None if gx is None else gx.to(x.dtype),
                None if gw is None else gw.to(w.dtype), None, None,
                None if gxs is None else gxs.to(xs.dtype), None)


class Conv(_Layer):
    """flax nnx.Conv(k=5, padding="SAME" or "VALID"); `kernel` is HWIO."""

    def __init__(self, cin: int, cout: int, strides: tuple[int, int], padding: str = "SAME"):
        super().__init__(cin, cout, strides, padding)

    def pads(self, n: int, s: int) -> tuple[int, int]:
        return _same_pad(n, s) if self.padding == "SAME" else (0, 0)

    def raw(self, x: torch.Tensor, pw: tuple[int, int] | None = None) -> torch.Tensor:
        """The convolution alone, NCHW in x's dtype. `pw` given, the width
        is padded by it instead of the layer's own padding (a window cut
        from a wider input)."""
        (sh, sw), (h, w) = self.strides, x.shape[2:]
        ph, pw = self.pads(h, sh), self.pads(w, sw) if pw is None else pw
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return self._conv(x, self._weight(x), self.strides)

    def forward(self, x: torch.Tensor, pw: tuple[int, int] | None = None,
                relu: bool = False, uses: int = 1, bias_block=None):
        """NCHW in x's dtype: the convolution, the bias, relu if asked;
        `uses` and `bias_block` as `_finish`."""
        return self._finish(self.raw(x, pw), relu, uses, bias_block)

    def window(self, out: slice, width: int) -> tuple[int, int]:
        """The global input columns [a, b) that output columns `out` read,
        for an input `width` wide (negative or past the width: padding)."""
        s, pad_l = self.strides[1], self.pads(width, self.strides[1])[0]
        return out.start * s - pad_l, (out.stop - 1) * s - pad_l + _K


class ConvTranspose(_Layer):
    """flax nnx.ConvTranspose(k=5, padding="SAME" or "VALID"); `kernel` is
    HWIO.

    Written as flax computes it: insert stride-1 zeros between inputs,
    pad (pad_a, pad_b), correlate with the unflipped kernel. On the H100
    this is faster than `F.conv_transpose2d` (cuDNN's float32 dgrad path):
    17.8 vs 27.2 ms for the asset's FCN at batch 64, 1.5 vs 17.0 ms at
    batch 1 (H100 80GB HBM3, 700 W)."""

    def __init__(self, cin: int, cout: int, strides: tuple[int, int], padding: str = "SAME"):
        super().__init__(cin, cout, strides, padding)

    def pads(self, s: int) -> tuple[int, int]:
        return _transpose_pad(s, padding=self.padding)

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        """The transposed convolution alone, NCHW in x's dtype."""
        (sh, sw), (b, c, h, w) = self.strides, x.shape
        z = x.new_zeros(b, c, (h - 1) * sh + 1, (w - 1) * sw + 1)
        z[:, :, ::sh, ::sw] = x
        ph, pw = self.pads(sh), self.pads(sw)
        z = F.pad(z, (pw[0], pw[1], ph[0], ph[1]))
        return self._conv(z, self._weight(x), xs=x, dilated=((sh, sw), (ph[0], pw[0])))

    def forward(self, x: torch.Tensor, relu: bool = False, uses: int = 1):  # NCHW
        return self._finish(self.raw(x), relu, uses)

    def window(self, out: slice) -> tuple[int, int]:
        """The global input columns [a, b) that output columns `out` read:
        output column o reads the dilated, padded columns [o, o + 5), and
        input column i sits at i * s + pad_a there."""
        s = self.strides[1]
        pad_a = self.pads(s)[0]
        return -((pad_a - out.start) // s), (out.stop + _K - 2 - pad_a) // s + 1

    def forward_window(self, xw: torch.Tensor, out: slice, relu: bool = False,
                       uses: int = 1, bias_block=None, group=None) -> torch.Tensor:
        """Output columns `out` from xw, the input columns `window(out)`;
        `uses` and `bias_block` as `_finish`, `group` as `_conv`'s."""
        (sh, sw), (b, c, h, n) = self.strides, xw.shape
        lead = self.window(out)[0] * sw + self.pads(sw)[0] - out.start
        z = xw.new_zeros(b, c, (h - 1) * sh + 1, out.stop - out.start + _K - 1)
        z[:, :, ::sh, lead: lead + (n - 1) * sw + 1: sw] = xw
        ph = self.pads(sh)
        z = F.pad(z, (0, 0, ph[0], ph[1]))
        y = self._conv(z, self._weight(xw), group=group, xs=xw,
                       dilated=((sh, sw), (ph[0], lead)))
        return self._finish(y, relu, uses, bias_block)


def _move_running(stat: torch.Tensor, batch_stat: torch.Tensor, momentum: float) -> None:
    with torch.no_grad():
        stat.mul_(momentum).add_(batch_stat.detach(), alpha=1.0 - momentum)


class BatchNorm(nn.Module):
    """Feature-wise BatchNorm over the channel axis (NCHW), flax's
    nnx.BatchNorm(momentum=0.99, epsilon=1e-3)."""

    def __init__(self, channels: int, epsilon: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None, width: int | None = None) -> torch.Tensor:
        mean, var = self.mean, self.var
        if train:
            # flax's fast variance: E[x^2] - E[x]^2, clipped at 0, biased;
            # the same biased value moves the running variance
            if mesh is not None and mesh.n_spatial > 1:
                # this rank's sums over its data row's global count: the
                # global terms are their sum over the mesh / the data rows
                count = x.shape[0] * x.shape[2] * width
                terms = torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]) / count
                mean, ex2 = all_reduce_mean(terms, mesh).unbind(0)
            else:
                mean = x.mean(dim=(0, 2, 3))
                ex2 = (x * x).mean(dim=(0, 2, 3))
                if mesh is not None:  # the global batch's terms, equal row shards
                    mean, ex2 = all_reduce_mean(torch.stack([mean, ex2]), mesh).unbind(0)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            _move_running(self.mean, mean, self.momentum)
            _move_running(self.var, var, self.momentum)
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        c = (-1, 1, 1)
        return (x - mean.view(c)) * mul.view(c) + self.bias.view(c)


class SampleWiseBN(nn.Module):
    """Per-pixel-position batch norm: one statistic per pixel position,
    shared across channels (the reference's sample-wise flavour, whose
    normalize parameters are H*W long). Inference applies the stored
    moving statistics; training uses the batch's over the batch and
    channel axes and moves the stored ones."""

    def __init__(self, num_positions: int, epsilon: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(num_positions))
        self.bias = nn.Parameter(torch.zeros(num_positions))
        self.register_buffer("mean", torch.zeros(num_positions))
        self.register_buffer("var", torch.ones(num_positions))

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None, width: int | None = None) -> torch.Tensor:
        """NCHW. On a spatial mesh x holds this rank's columns of a global
        `width`: it takes its own positions' statistics, reduced over the
        data axis only, and its positions' scale and bias; the batch
        statistics of every position are gathered over the spatial axis
        before they move the running ones, so every rank keeps the whole
        buffers, equal to every other rank's."""
        b, c, h, w = x.shape
        cols = None
        if mesh is not None and mesh.n_spatial > 1:
            cols = image_sharding(mesh).columns(width)

        def own(t):  # this rank's positions of a (H * width) vector
            return t if cols is None else t.view(h, width)[:, cols].reshape(-1)

        flat = x.reshape(b, c, h * w)
        mean, var = own(self.mean), own(self.var)
        if train:
            # jnp.var's two passes: the mean, then the centred second
            # moment, each the global batch's on a mesh
            mean = flat.mean(dim=(0, 1))
            if mesh is not None:
                mean = all_reduce_mean(mean, mesh, axis="data")
            d = flat - mean
            var = (d * d).mean(dim=(0, 1))
            if mesh is not None:
                var = all_reduce_mean(var, mesh, axis="data")
            moved = torch.stack([mean, var]).detach()
            if cols is not None:
                moved = all_gather_columns(moved.view(2, h, w), mesh, width).reshape(2, -1)
            _move_running(self.mean, moved[0], self.momentum)
            _move_running(self.var, moved[1], self.momentum)
        y = (flat - mean) * torch.rsqrt(var + self.epsilon)
        return (y * own(self.scale) + own(self.bias)).reshape(b, c, h, w)


class FCN(nn.Module):
    def __init__(
        self,
        cfg: ModelConfig,
        in_channels: int = 3,
        image_hw: tuple[int, int] | None = None,
        seed: int | None = None,
    ):
        """`seed` given, the kernels are drawn as the reference draws them
        (`uniform_init_`); without it every kernel is zero until weights
        are loaded. `image_hw` is needed for `cfg.sample_wise_bn`."""
        super().__init__()
        self.compute_dtype = compute_dtype(cfg.dtype)
        self.cfg = cfg
        fmt = self.compute_dtype if isinstance(self.compute_dtype, sf.SmallFloat) else None
        self.fmt = fmt
        self.complex = _is_complex(cfg.dtype)
        vs = cfg.vertical_stride
        wm = cfg.width_multiplier
        if cfg.sample_wise_bn:
            if image_hw is None:
                raise ValueError("sample_wise_bn needs image_hw")
            self.norm = SampleWiseBN(image_hw[0] * image_hw[1])
        elif cfg.batch_norm:
            self.norm = BatchNorm(in_channels)
        self.conv1 = Conv(in_channels, 4 * wm, (vs, 4))
        self.conv2 = Conv(4 * wm, 6 * wm, (vs, 2))
        self.conv3 = Conv(6 * wm, 12 * wm, (vs, 2))
        self.deconv4 = ConvTranspose(12 * wm, 16 * wm, (vs, 2))
        self.deconv5a = ConvTranspose(22 * wm, 8 * wm, (vs, 2))
        self.deconv6a = ConvTranspose(12 * wm, 2, (vs, 4))
        if cfg.use_regression:
            nreg = self.num_reg_channels
            self.deconv5b = ConvTranspose(22 * wm, nreg, (vs, 2))
            self.deconv6b = ConvTranspose(4 * wm + nreg, nreg, (vs, 4))
        for layer in self.modules():
            if isinstance(layer, _Layer):
                layer.fmt = fmt
        if seed is not None:
            uniform_init_(self, seed)

    @property
    def num_reg_channels(self) -> int:
        if self.cfg.head == "corner":
            return self.cfg.num_corner_outputs
        if self.cfg.yaw_codec == "dual":
            return DIRECT_CHANNELS_DUAL
        return DIRECT_CHANNELS

    @property
    def act_dtype(self) -> torch.dtype:
        """The dtype of the values between layers: the compute dtype, or a
        small float's values in SMALL_FLOAT_CONV (float32 where float16
        cannot hold them)."""
        if self.fmt is None:
            return self.compute_dtype
        return SMALL_FLOAT_CONV if self.fmt.via_f16 else torch.float32

    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        """The normalised, padded float32 input in the compute dtype: flax's
        cast, for a small float the kernel's direct mode (one launch)."""
        if self.fmt is not None:
            return sf.cast_for_conv(x, self.fmt, out=self.act_dtype)
        return x.to(self.act_dtype)

    def _float(self, t: torch.Tensor) -> torch.Tensor:
        """An output map as float32; in a small float where a gradient
        flows, through `small_float.cast`, whose backward rounds the
        float32 cotangent to the format (XLA's transposed convert). A
        complex net warns, as JAX warns at each cast of its complex d6a
        and d6b to float32."""
        if self.complex:
            warnings.warn(COMPLEX_CAST_WARNING, DeprecationWarning, stacklevel=3)
        if self.fmt is not None and torch.is_grad_enabled() and t.requires_grad:
            return sf.cast(t, self.fmt, out=torch.float32)
        return t.float()

    def _trunk(self, x: torch.Tensor, train: bool = False, mesh=None):
        """Shared encoder and the deconv6a head, NCHW in the compute
        dtype. The crops follow the input width, so the lidar (1801,
        conv1 width 451, crop5 = 1), camera (1368, conv1 width 343,
        crop5 = 1, 1372 cropped to 1368) and BEV (1197, conv1 width 300,
        crop5 = 0) geometries all come out at the input's width."""
        cfg = self.cfg
        w = x.shape[2]
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        if cfg.batch_norm or cfg.sample_wise_bn:
            x = self.norm(x, train, mesh)
        x = self._cast_input(F.pad(x, (0, 3)))

        # c1, c2 and d4 feed several consumers: one alias each, in the
        # order JAX's backward pass meets their cotangents (the regression
        # branch's first, the classification head's, the trunk's), which
        # the small-float backward sums in
        reg = int(cfg.use_regression)
        *c1s, c1 = self._relu(self.conv1, x, uses=2 + reg)
        *c2s, c2 = self._relu(self.conv2, c1, uses=2 + reg)
        c3 = self._relu(self.conv3, c2)
        d4s = self._relu(self.deconv4, c3, uses=1 + reg)
        d4s = d4s if reg else (d4s,)
        cat4s = [torch.cat([a, b], dim=1) for a, b in zip(c2s, d4s)]
        crop5 = 2 * c2.shape[3] - c1.shape[3]  # 1 when conv1 width is odd

        d5a = self._relu(self.deconv5a, cat4s[-1])[:, :, :, crop5:]
        d6a = self.deconv6a(torch.cat([c1s[-1], d5a], dim=1))[:, :, :, :w]
        return d6a, (c1s[0], cat4s[0], crop5, w)

    def _sharded(self, x: torch.Tensor, train: bool, mesh, width: int | None):
        """(d6a, d6b or None) on a spatial mesh: x (B, H, w, C) holds this
        rank's columns (`column_blocks`) of a global `width`, and every
        layer computes the columns it owns of its own global output under
        the same rule, its input's halo fetched from its neighbours
        (`parallel/halo.py`). The zero pad (0, 3) is the zeros past the
        width that the halo already gives; the crops shift the global
        columns a layer computes, so the concatenated maps own the same
        columns. deconv5a and deconv5b read one fetch of cat4. A small
        float's training step (the module docstring) fetches a float32
        window for each consumer instead, c1, c2 and d4 giving one alias
        a consumer as off the mesh."""
        if width is None:
            raise ValueError("on a spatial mesh the FCN needs the input's global width")
        cfg, k, s = self.cfg, mesh.n_spatial, mesh.spatial_index
        w1, w2, w3, crop5 = self._widths(width)
        if w3 * self.deconv4.strides[1] != w2:  # the unsharded torch.cat raises too
            raise ValueError(f"a width of {width} does not round-trip the FCN ({w2} vs "
                             f"{w3 * self.deconv4.strides[1]} columns)")
        grad = self.fmt is not None and torch.is_grad_enabled()
        reg = int(cfg.use_regression)
        group = mesh.spatial_group if grad else None
        blocks = self.gradient_blocks(width) if grad else {}

        def window(t, w_in, windows):
            return fetch_columns(t.float() if grad else t, mesh, w_in, windows)

        def bias_block(name):
            if name not in blocks:
                return None
            w_map, offset, w_whole = blocks[name]
            per = -(-w_whole // k)  # XLA's block of the layer's whole output
            windows = [(r * per - offset, (r + 1) * per - offset) for r in range(k)]
            return lambda g: block_columns(g, mesh, w_map, windows)

        def conv(name, t, w_in, w_pad, w_out, uses):
            layer, outs = getattr(self, name), column_blocks(w_out, k)
            res = self._relu(layer, window(t, w_in, [layer.window(o, w_pad) for o in outs]),
                             pw=(0, 0), uses=uses if grad else 1, bias_block=bias_block(name))
            return list(res) if grad and uses > 1 else [res] * uses

        def fetch(name, t, w_in, outs):
            layer = getattr(self, name)
            return window(t, w_in, [layer.window(o) for o in outs])

        def up(name, xw, outs, uses=1, relu=True):
            res = self._relu(getattr(self, name).forward_window, xw, outs[s], relu=relu,
                             uses=uses if grad else 1, bias_block=bias_block(name), group=group)
            return list(res) if grad and uses > 1 else [res] * uses

        x = x.to(torch.float32).permute(0, 3, 1, 2)
        if cfg.batch_norm or cfg.sample_wise_bn:
            x = self.norm(x, train, mesh, width)
        x = self._cast_input(x)
        # the consumers of c1 and c2 in the order JAX's backward meets their
        # cotangents: the regression branch's, the classification head's,
        # the trunk's (d4: the first two)
        *c1s, c1 = conv("conv1", x, width, width + 3, w1, 2 + reg)
        *c2s, c2 = conv("conv2", c1, w1, w1, w2, 2 + reg)
        (c3,) = conv("conv3", c2, w2, w2, w3, 1)
        outs4 = column_blocks(w2, k)
        d4s = up("deconv4", fetch("deconv4", c3, w3, outs4), outs4, 1 + reg)
        outs5 = [slice(o.start + crop5, o.stop + crop5) for o in column_blocks(w1, k)]
        outs6 = column_blocks(width, k)
        cat4s = [fetch("deconv5a", torch.cat([a, b], dim=1), w2, outs5)
                 for a, b in (zip(c2s, d4s) if grad else [(c2, d4s[0])])]  # one fetch serves both

        def head(up5, up6, cat4, c1_alias, relu=False):
            (d5,) = up(up5, cat4, outs5)
            (d6,) = up(up6, fetch(up6, torch.cat([c1_alias, d5], dim=1), w1, outs6), outs6,
                       relu=relu)
            return d6

        d6a = head("deconv5a", "deconv6a", cat4s[-1], c1s[-1])
        d6b = (head("deconv5b", "deconv6b", cat4s[0], c1s[0], self._reg_relu)
               if cfg.use_regression else None)
        return d6a, d6b

    def _widths(self, width: int) -> tuple[int, int, int, int]:
        """(w1, w2, w3, crop5): conv1-3's output widths and the columns
        deconv5's crop drops, for an input `width` wide."""
        w1 = -(-(width + 3) // self.conv1.strides[1])
        w2 = -(-w1 // self.conv2.strides[1])
        w3 = -(-w2 // self.conv3.strides[1])
        return w1, w2, w3, w2 * self.deconv5a.strides[1] - w1

    def gradient_blocks(self, width: int) -> dict:
        """{layer: (the width of the map its epilogue writes, the map's
        first column's place in the layer's whole output, that output's
        width)} for an input `width` wide: deconv5 writes 2 w2 - crop5
        columns of its 2 w2, deconv6 the input's width of its 4 w1."""
        w1, w2, w3, crop5 = self._widths(width)
        out = {"conv1": (w1, 0, w1), "conv2": (w2, 0, w2), "conv3": (w3, 0, w3),
               "deconv4": (w2, 0, w2), "deconv5a": (w1, crop5, w1 + crop5),
               "deconv6a": (width, 0, w1 * self.deconv6a.strides[1])}
        if self.cfg.use_regression:
            out.update(deconv5b=out["deconv5a"], deconv6b=out["deconv6a"])
        return out

    def gradient_plan(self) -> list:
        """How a small float's gradients are combined over a mesh, as XLA's
        partitioned program combines them (`parallel.mesh.reduce_gradients`):
        (parameter, the mesh axes its rank values are summed over, in
        order), the axes None for a float32 parameter (the input norm's).
        Biases: spatial, then data; conv1-3's kernels (each rank's wgrad of
        its own columns): data, then spatial; a transposed convolution's
        kernel: data (its spatial sum ran in float32, `_GradConv`)."""
        plan = []
        for name, p in self.named_parameters():
            layer = name.rsplit(".", 1)[0]
            if not isinstance(getattr(self, layer, None), _Layer):
                plan.append((p, None))
            elif name.endswith(".bias"):
                plan.append((p, ("spatial", "data")))
            elif isinstance(getattr(self, layer), ConvTranspose):
                plan.append((p, ("data",)))
            else:
                plan.append((p, ("data", "spatial")))
        return plan

    def _relu(self, layer, *args, relu: bool = True, uses: int = 1, **kw):
        """layer(*args), relu'd where `relu`: torch's relu after it, as flax
        applies it, or in a small-float layer's epilogue (jax.nn.relu in
        the format: a NaN in float8_e8m0fnu, where 0 is one). With `uses`
        > 1 a tuple of that many aliases (`_Layer._finish`)."""
        if self.fmt is not None:
            return layer(*args, relu=relu, uses=uses, **kw)
        y = layer(*args, **kw)
        y = F.relu(y) if relu else y
        return y if uses == 1 else (y,) * uses

    @property
    def _reg_relu(self) -> bool:
        """deconv6b's relu: a corner head's reference-compat option (the
        direct head's targets are signed)."""
        return self.cfg.head == "corner" and self.cfg.reg_output_activation == "relu"

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None, width: int | None = None) -> torch.Tensor:
        """(B, H, W, C) float32 -> (B, H, W, 2 [+ reg]) float32. With
        train=True the input norm uses the batch's statistics and moves
        its running ones; on a data-parallel `mesh` (this rank's rows) the
        global batch's statistics. On a spatial mesh x and the output hold
        this rank's columns (`parallel.mesh.constrain_spatial`) of a global
        `width`, which the caller passes."""
        cfg = self.cfg
        if mesh is not None and mesh.n_spatial > 1:
            d6a, d6b = self._sharded(x, train, mesh, width)
        else:
            d6a, (c1, cat4, crop5, w) = self._trunk(x, train, mesh)
            if cfg.use_regression:
                d5b = self._relu(self.deconv5b, cat4)[:, :, :, crop5:]
                d6b = self._relu(self.deconv6b, torch.cat([c1, d5b], dim=1),
                                 relu=self._reg_relu)[:, :, :, :w]
        probs = torch.softmax(self._float(d6a), dim=1).clamp(_KERAS_EPSILON, 1.0)
        if not cfg.use_regression:
            return probs.permute(0, 2, 3, 1).contiguous()
        return torch.cat([probs, self._float(d6b)], dim=1).permute(0, 2, 3, 1).contiguous()

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) -> the pre-softmax deconv6a map (B, H', W, 2) in
        the compute dtype, NHWC: the tap the fusion net consumes. H' is H
        for vertical_stride 1 and for heights the three vertical strides
        divide (the camera's 512 at stride 2). A small float comes back in
        torch's dtype of its name (its codes, one launch of the kernel's
        direct mode), or as float16 values where torch has no such dtype;
        complex as complex64 with a zero imaginary part."""
        d6a = self._trunk(x, train)[0].permute(0, 2, 3, 1)
        fmt = self.fmt
        if fmt is not None:
            if fmt.torch_dtype is not None:
                return sf.cast(d6a, fmt, out=torch.uint8).view(fmt.torch_dtype)
            return d6a.to(fmt.carrier)
        return d6a.to(torch.complex64) if self.complex else d6a
