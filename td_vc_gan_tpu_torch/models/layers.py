"""Conv building blocks of the generator, in PyTorch.

Counterparts of ``td_vc_gan_tpu/models/layers.py``. Modules run torch's
``(B, C, T)`` layout. Parameter names and roles follow the JAX package's flax
modules (``v``/``g`` for weight norm, ``kernel``, ``bias``), so
``weights.py`` maps a flax tree onto a module by name; the tensors themselves
use torch's layouts: a conv ``v`` is ``(out, in, k)`` with ``g`` per output
channel, a transposed conv ``v`` is ``(in, out, k)`` with ``g`` per input
channel, a Linear ``kernel`` is ``(out, in)``.

Weights are made from a seed by :func:`init_weights`, with the JAX package's
distributions: U(+-1/sqrt(fan_in)) for kernels and biases, and ``g`` set to
the norm of ``v`` so that the initial weight equals ``v``.

Mixed precision (``train.compute_dtype: bfloat16``) is the JAX package's
policy, with explicit casts: inside :class:`compute_dtype_scope` every
:class:`WNConv1d` / :class:`WNConvTranspose1d` casts its input, its effective
(f32) kernel and its bias to the scope's dtype, so the convs run in bf16 and
the activations between layers stay bf16; parameters stay f32 (the cast's
backward brings each gradient back to f32), and the top-level modules cast
their outputs back with :func:`finalize_dtype`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch.ops.activation import leaky_relu
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cond_chain_op
from td_vc_gan_tpu_torch.ops.dsp import reflect_pad


# the compute dtype of the innermost active scope; None: no scope (f32)
_COMPUTE_DTYPE: list = [None]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None, "none": None}


def get_compute_dtype() -> torch.dtype | None:
    return _COMPUTE_DTYPE[0]


class compute_dtype_scope:
    """``with compute_dtype_scope("bfloat16"): ...``: the convs inside run in
    that dtype. ``None``, ``"float32"`` and ``"none"`` are no-ops (f32); any
    other string raises KeyError, as the JAX package's scope does."""

    def __init__(self, dtype):
        if isinstance(dtype, str):
            dtype = _DTYPES[dtype.lower()]
        self.dtype = dtype

    def __enter__(self):
        self._prev = _COMPUTE_DTYPE[0]
        _COMPUTE_DTYPE[0] = self.dtype
        return self

    def __exit__(self, *exc):
        _COMPUTE_DTYPE[0] = self._prev
        return False


def finalize_dtype(x):
    """A model output cast back to f32 when a compute scope is active."""
    if _COMPUTE_DTYPE[0] is not None and x is not None and x.dtype != torch.float32:
        return x.float()
    return x


def conv1d(x, w, b=None, **kw):
    """``F.conv1d``; a bf16 conv on the CPU runs as an f32 conv of the bf16
    values, rounded to bf16 once: the products are exact either way and the
    sum is f32, as on the card, where torch's CPU bf16 convs give wrong sums
    at some shapes (k=8 stride 4; grouped k=16)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv1d(x.float(), w.float(), None if b is None else b.float(),
                        **kw).to(x.dtype)
    return F.conv1d(x, w, b, **kw)


def conv_transpose1d(x, w, b=None, **kw):
    """``F.conv_transpose1d``, bf16 on the CPU as :func:`conv1d`."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.conv_transpose1d(x.float(), w.float(), None if b is None else b.float(),
                                  **kw).to(x.dtype)
    return F.conv_transpose1d(x, w, b, **kw)


def _in_scope(x, w, b):
    """(x, w, b) cast to the scope's compute dtype (unchanged outside a scope)."""
    dt = _COMPUTE_DTYPE[0]
    if dt is None:
        return x, w, b
    return x.to(dt), w.to(dt), None if b is None else b.to(dt)


def _wn(v: torch.Tensor, g: torch.Tensor, dim: int) -> torch.Tensor:
    """g * v / max(||v||, 1e-12), the norm taken over every axis but ``dim``."""
    axes = tuple(i for i in range(v.dim()) if i != dim)
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    shape = [1] * v.dim()
    shape[dim] = -1
    return v * (g.reshape(shape) / torch.clamp_min(norm, 1e-12))


def _uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def _reset_conv(m: nn.Module, gen: torch.Generator) -> None:
    """U(+-1/sqrt(fan_in)) kernel and bias; g = ||v|| (dim 0 of v is the
    weight-norm axis for both conv kinds)."""
    if m.use_weight_norm:
        _uniform_(m.v, m.fan_in, gen)
        with torch.no_grad():
            m.g.copy_(m.v.flatten(1).norm(dim=1))
    else:
        _uniform_(m.kernel, m.fan_in, gen)
    if m.bias is not None:
        _uniform_(m.bias, m.fan_in, gen)


class WNConv1d(nn.Module):
    """1-D convolution with optional weight norm.

    padding: int (symmetric), (left, right), or 'same'; pad_mode 'zeros' or
    'reflect' (:func:`reflect_pad`, which reflects repeatedly where the pad
    is not shorter than T, as the JAX package does).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 padding: int | tuple[int, int] | str = 0, pad_mode: str = "zeros",
                 use_bias: bool = True, use_weight_norm: bool = True):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.pad_mode = pad_mode
        if padding == "same":
            total = dilation * (kernel_size - 1)
            self.pads = (total // 2, total - total // 2)
        elif isinstance(padding, int):
            self.pads = (padding, padding)
        else:
            self.pads = tuple(padding)
        self.fan_in = (in_channels // groups) * kernel_size
        shape = (out_channels, in_channels // groups, kernel_size)
        self.use_weight_norm = use_weight_norm
        if use_weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(out_channels))
        else:
            self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _reset_conv(self, gen)

    def weight(self) -> torch.Tensor:
        """The effective (out, in/groups, k) kernel."""
        return _wn(self.v, self.g, 0) if self.use_weight_norm else self.kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left, right = self.pads
        if self.pad_mode == "reflect" and (left or right):
            x = reflect_pad(x, left, right)
            padding = 0
        elif left == right:
            padding = left
        else:
            x = F.pad(x, (left, right))
            padding = 0
        x, w, b = _in_scope(x, self.weight(), self.bias)
        return conv1d(x, w, b, stride=self.stride, padding=padding, dilation=self.dilation,
                      groups=self.groups)


class WNConvTranspose1d(nn.Module):
    """Transposed 1-D convolution with weight norm per input channel, as
    torch's ``ConvTranspose1d(kernel, stride, padding, output_padding)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, output_padding: int = 0,
                 use_bias: bool = True, use_weight_norm: bool = True):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.fan_in = in_channels * kernel_size
        shape = (in_channels, out_channels, kernel_size)
        self.use_weight_norm = use_weight_norm
        if use_weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(in_channels))
        else:
            self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _reset_conv(self, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _wn(self.v, self.g, 0) if self.use_weight_norm else self.kernel
        x, w, b = _in_scope(x, w, self.bias)
        return conv_transpose1d(x, w, b, stride=self.stride, padding=self.padding,
                                output_padding=self.output_padding)


class Linear(nn.Module):
    """Dense layer, ``kernel`` (out, in)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.fan_in = in_features
        self.kernel = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _uniform_(self.kernel, self.fan_in, gen)
        if self.bias is not None:
            _uniform_(self.bias, self.fan_in, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel, self.bias)


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    """Gradient reversal: the identity forward, -1 times the gradient
    backward (the JAX package's ``grad_reverse``, scale fixed at 1)."""
    return _GradReverse.apply(x)


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Fill every layer of ``module`` from one seeded CPU generator, in
    module order (so the weights do not depend on the device)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return module


def _norm_stats(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Non-affine instance norm of x (B, C, T) over T, in f32: population
    variance, ``(x - mean) * rsqrt(var + eps)``. The JAX package reduces in
    f32 and, allowed excess precision by XLA, rounds a bf16 input's result
    once, at the end; its callers round as it does."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + epsilon)


class InstanceNorm(nn.Module):
    """Non-affine InstanceNorm1d over time (eps 1e-5): statistics per (batch,
    channel) over T. No parameters."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_stats(x, self.epsilon).to(x.dtype)


class ConditionalInstanceNorm(nn.Module):
    """(1 + gamma) * IN(x) + beta, (gamma, beta) predicted from the cond: a
    2-D cond (B, Cc) through a Linear, a per-frame cond (B, Cc, T) through a
    k=5 'same' conv without weight norm (``per_frame``). The submodules keep
    flax's automatic names, ``Linear_0`` and ``WNConv1d_0``. A 2-D cond's
    Linear does not cast to the compute scope's dtype, so under a bf16 scope
    the output is f32, as in the JAX package."""

    def __init__(self, features: int, cond_channels: int, per_frame: bool = False):
        super().__init__()
        self.per_frame = per_frame
        if per_frame:
            self.WNConv1d_0 = WNConv1d(cond_channels, 2 * features, 5, padding="same",
                                       use_weight_norm=False)
        else:
            self.Linear_0 = Linear(cond_channels, 2 * features)

    def forward(self, x: torch.Tensor, c: torch.Tensor | None) -> torch.Tensor:
        if c is None or c.dim() != (3 if self.per_frame else 2):
            raise ValueError("conditional instance norm needs a "
                             + ("per-frame (B, Cc, T)" if self.per_frame else "2-D (B, Cc)")
                             + f" cond, got {None if c is None else tuple(c.shape)}")
        h = self.WNConv1d_0(c) if self.per_frame else self.Linear_0(c)[..., None]
        gamma, beta = h.float().chunk(2, dim=1)
        out = (1 + gamma) * _norm_stats(x, 1e-5) + beta
        return out.to(torch.promote_types(x.dtype, h.dtype))


def make_norm(norm: str | None, features: int, cond_channels: int = 0,
              per_frame: bool = False) -> nn.Module | None:
    """The module of a norm slot (None: the slot is the identity)."""
    if norm is None:
        return None
    if norm == "instance_norm":
        return InstanceNorm()
    if norm == "conditional_instance_norm":
        return ConditionalInstanceNorm(features, cond_channels, per_frame)
    raise ValueError(f"unknown norm {norm!r}")


def _chain_weights(blocks) -> tuple:
    """The FiLM blocks' cond_0 and cond_1 weights concatenated in the JAX
    package's WIO layout: w0 (3, Cc, n*Cc), b0 (n*Cc,), w1 (3, Cc, n*2C),
    b1 (n*2C,)."""
    w0 = torch.cat([blk.cond_0.weight() for blk in blocks], 0).permute(2, 1, 0)
    b0 = torch.cat([blk.cond_0.bias for blk in blocks])
    w1 = torch.cat([blk.cond_1.weight() for blk in blocks], 0).permute(2, 1, 0)
    b1 = torch.cat([blk.cond_1.bias for blk in blocks])
    return w0, b0, w1, b1


def _split_films(gb: torch.Tensor, n: int, c: int) -> list[tuple]:
    """(B, n*2C, T) -> n blocks' (gamma, beta), (B, C, T) each."""
    return [(gb[:, i * 2 * c:i * 2 * c + c], gb[:, i * 2 * c + c:(i + 1) * 2 * c])
            for i in range(n)]


def concat_films(blocks, cond: torch.Tensor, t: int) -> list[tuple]:
    """Every block's (gamma, beta), (B, C, T) each, from one call of the
    cond-chain op's concat form (``film_cond_chain``): ``cond`` is per-frame
    (B, Cc, T), or 2-D (B, Cc) and broadcast over the t frames. In a compute
    scope the chain's operands are cast first, as the JAX package's
    ``_batched_film`` casts them."""
    w0, b0, w1, b1 = _chain_weights(blocks)
    if cond.dim() == 2:
        c = cond[:, None, :].expand(-1, t, -1)
    else:
        c = cond.transpose(1, 2)
    if (dt := get_compute_dtype()) is not None:
        c, w0, b0, w1, b1 = (a.to(dt) for a in (c, w0, b0, w1, b1))
    gb = cond_chain_op.film_cond_chain(c.contiguous(), w0.contiguous(), b0,
                                       w1.contiguous(), b1).transpose(1, 2)
    return _split_films(gb, len(blocks), blocks[0].channels)


class FiLMResnetBlock(nn.Module):
    """lrelu -> reflect dilated conv -> FiLM (h * (1 + gamma) + beta) ->
    lrelu -> 1x1 conv, plus the identity. (gamma, beta) come precomputed
    (``film``, from an MRF stage's cond chain) or from the block's own
    ``cond_0`` -> lrelu -> ``cond_1`` chain on a cond ``c``, 2-D (B, Cc) and
    broadcast over time, or per-frame (B, Cc, T); that chain runs through the
    cond-chain op's concat form with n = 1."""

    def __init__(self, channels: int, cond_channels: int = 0, dilation: int = 1,
                 kernel_size: int = 3, use_weight_norm: bool = True):
        super().__init__()
        self.channels = channels
        self.conv = WNConv1d(channels, channels, kernel_size, dilation=dilation,
                             padding=(kernel_size * dilation - dilation) // 2,
                             pad_mode="reflect", use_weight_norm=use_weight_norm)
        self.posconv = WNConv1d(channels, channels, 1, use_weight_norm=use_weight_norm)
        if cond_channels:
            self.cond_0 = WNConv1d(cond_channels, cond_channels, 3, padding="same",
                                   use_weight_norm=use_weight_norm)
            self.cond_1 = WNConv1d(cond_channels, 2 * channels, 3, padding="same",
                                   use_weight_norm=use_weight_norm)

    def forward(self, x: torch.Tensor, film: tuple | None = None,
                c: torch.Tensor | None = None) -> torch.Tensor:
        if film is None and c is not None:
            film = concat_films([self], c, x.shape[-1])[0]
        h = self.conv(leaky_relu(x))
        if film is not None:
            gamma, beta = film
            h = h * (1 + gamma) + beta
        return self.posconv(leaky_relu(h)) + x


class MRFBlock(nn.Module):
    """HiFi-GAN multi-receptive-field fusion: per kernel size a chain of FiLM
    blocks over the dilations, outputs averaged. With conditioning, every
    block's (gamma, beta) comes from one call of the cond-chain op: the split
    form for a ``(spk, exc)`` tuple, the concat form for a per-frame
    (B, Cc, T) or a 2-D (B, Cc) cond, broadcast over time."""

    def __init__(self, channels: int, cond_channels: int = 0,
                 dilations: tuple[int, ...] = (1, 3, 5),
                 kernel_sizes: tuple[int, ...] = (3, 7, 11),
                 use_weight_norm: bool = True):
        super().__init__()
        self.channels = channels
        self.cond_channels = cond_channels
        self.nd = len(dilations)
        self.n_kernels = len(kernel_sizes)
        self.block_names = []
        for k, ks in enumerate(kernel_sizes):
            for j, d in enumerate(dilations):
                name = f"block_{k}_{j}"
                self.add_module(name, FiLMResnetBlock(
                    channels, cond_channels, dilation=d, kernel_size=ks,
                    use_weight_norm=use_weight_norm))
                self.block_names.append(name)

    def blocks(self) -> list[FiLMResnetBlock]:
        return [getattr(self, name) for name in self.block_names]

    def films(self, spk: torch.Tensor, exc: torch.Tensor) -> list[tuple]:
        """Every block's (gamma, beta), (B, C, T) each, from the split cond:
        spk (B, S) and exc (B, E, T) with S + E = cond_channels. In a
        compute scope the chain's operands are cast first, as the JAX
        package's ``_batched_film`` casts them, so its bias and edge terms
        are computed in that dtype too."""
        blocks = self.blocks()
        s = spk.shape[-1]
        w0, b0, w1, b1 = _chain_weights(blocks)
        if (dt := get_compute_dtype()) is not None:
            spk, exc, w0, b0, w1, b1 = (a.to(dt) for a in (spk, exc, w0, b0, w1, b1))
        w0_spk, w0_exc = w0[:, :s], w0[:, s:]
        hbias = spk @ (w0_spk[0] + w0_spk[1] + w0_spk[2]) + b0
        edge0 = spk @ w0_spk[0]   # the tap reading t-1 is the zero pad at t = 0
        edge_t = spk @ w0_spk[2]  # the tap reading t+1 is the zero pad at t = T-1
        gb = cond_chain_op.cond_chain(
            exc.transpose(1, 2).contiguous(), w0_exc.contiguous(), hbias,
            w1.contiguous(), b1, edge0, edge_t).transpose(1, 2)
        return _split_films(gb, len(blocks), self.channels)

    def forward(self, x: torch.Tensor, cond=None) -> torch.Tensor:
        films = None
        if self.cond_channels and cond is not None:
            films = (self.films(*cond) if isinstance(cond, tuple)
                     else concat_films(self.blocks(), cond, x.shape[-1]))
        y = 0.0
        blocks = self.blocks()
        for k in range(self.n_kernels):
            xs = x
            for j in range(self.nd):
                i = k * self.nd + j
                xs = blocks[i](xs, films[i] if films is not None else None)
            y = y + xs
        return y / self.n_kernels


class ResnetBlock(nn.Module):
    """norm -> lrelu -> dilated reflect conv (pad = dilation) -> norm ->
    lrelu -> 1x1 conv, plus the identity; the norm is instance norm when
    ``norm == 'instance_norm'``, else the identity. Dead code in the
    reference, kept for its inventory; flax's names ``WNConv1d_0/1``."""

    def __init__(self, channels: int, dilation: int = 1, kernel_size: int = 3,
                 norm: str | None = None, use_weight_norm: bool = True):
        super().__init__()
        self.norm = InstanceNorm() if norm == "instance_norm" else nn.Identity()
        self.WNConv1d_0 = WNConv1d(channels, channels, kernel_size, dilation=dilation,
                                   padding=dilation, pad_mode="reflect",
                                   use_weight_norm=use_weight_norm)
        self.WNConv1d_1 = WNConv1d(channels, channels, 1, use_weight_norm=use_weight_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.WNConv1d_0(leaky_relu(self.norm(x)))
        return self.WNConv1d_1(leaky_relu(self.norm(h))) + x


class DecoderResnetBlock(nn.Module):
    """lrelu -> weight-normed dilated reflect conv (pad = dilation) -> lrelu
    -> weight-normed 1x1 conv, plus a weight-normed 1x1 shortcut. Dead code
    in the reference, kept for its inventory."""

    def __init__(self, channels: int, dilation: int = 1, kernel_size: int = 3,
                 in_channels: int | None = None):
        super().__init__()
        cin = in_channels or channels
        self.conv = WNConv1d(cin, channels, kernel_size, dilation=dilation, padding=dilation,
                             pad_mode="reflect")
        self.posconv = WNConv1d(channels, channels, 1)
        self.shortcut = WNConv1d(cin, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.posconv(leaky_relu(self.conv(leaky_relu(x))))
        return h + self.shortcut(x)


class TranformResnetBlock(nn.Module):
    """lrelu -> dilated reflect conv -> IN -> lrelu -> 1x1 conv -> IN, plus a
    1x1 shortcut, all convs plain. Dead code in the reference (its spelling
    kept), kept for its inventory."""

    def __init__(self, channels: int, dilation: int = 1, kernel_size: int = 3,
                 in_channels: int | None = None):
        super().__init__()
        cin = in_channels or channels
        self.conv = WNConv1d(cin, channels, kernel_size, dilation=dilation, padding=dilation,
                             pad_mode="reflect", use_weight_norm=False)
        self.posconv = WNConv1d(channels, channels, 1, use_weight_norm=False)
        self.shortcut = WNConv1d(cin, channels, 1, use_weight_norm=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(leaky_relu(x))
        h = _norm_stats(h, 1e-5).to(h.dtype)
        h = self.posconv(leaky_relu(h))
        return _norm_stats(h, 1e-5).to(h.dtype) + self.shortcut(x)


class CINResnetBlock(nn.Module):
    """CIN -> lrelu -> dilated reflect 'same' conv -> CIN -> lrelu -> 1x1
    conv, plus a 1x1 shortcut, convs plain; the cond is 2-D, or per-frame
    with ``per_frame``. Dead code in the reference, kept for its inventory."""

    def __init__(self, channels: int, cond_channels: int, dilation: int = 1,
                 kernel_size: int = 3, per_frame: bool = False):
        super().__init__()
        self.cin0 = ConditionalInstanceNorm(channels, cond_channels, per_frame)
        self.conv = WNConv1d(channels, channels, kernel_size, dilation=dilation,
                             padding=(kernel_size * dilation - dilation) // 2,
                             pad_mode="reflect", use_weight_norm=False)
        self.cin1 = ConditionalInstanceNorm(channels, cond_channels, per_frame)
        self.posconv = WNConv1d(channels, channels, 1, use_weight_norm=False)
        self.shortcut = WNConv1d(channels, channels, 1, use_weight_norm=False)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.conv(leaky_relu(self.cin0(x, c)))
        h = self.posconv(leaky_relu(self.cin1(h, c)))
        return h + self.shortcut(x)
