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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch.ops.activation import leaky_relu
from td_vc_gan_tpu_torch.ops.cuda import cond_chain as cond_chain_op
from td_vc_gan_tpu_torch.ops.dsp import reflect_pad


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
        return F.conv1d(x, self.weight(), self.bias, self.stride, padding,
                        self.dilation, self.groups)


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
        return F.conv_transpose1d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding)


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


class FiLMResnetBlock(nn.Module):
    """lrelu -> reflect dilated conv -> FiLM (h * (1 + gamma) + beta) ->
    lrelu -> 1x1 conv, plus the identity. (gamma, beta) come precomputed from
    the stage's cond chain; ``cond_0``/``cond_1`` hold that chain's weights."""

    def __init__(self, channels: int, cond_channels: int = 0, dilation: int = 1,
                 kernel_size: int = 3, use_weight_norm: bool = True):
        super().__init__()
        self.conv = WNConv1d(channels, channels, kernel_size, dilation=dilation,
                             padding=(kernel_size * dilation - dilation) // 2,
                             pad_mode="reflect", use_weight_norm=use_weight_norm)
        self.posconv = WNConv1d(channels, channels, 1, use_weight_norm=use_weight_norm)
        if cond_channels:
            self.cond_0 = WNConv1d(cond_channels, cond_channels, 3, padding="same",
                                   use_weight_norm=use_weight_norm)
            self.cond_1 = WNConv1d(cond_channels, 2 * channels, 3, padding="same",
                                   use_weight_norm=use_weight_norm)

    def forward(self, x: torch.Tensor, film: tuple | None = None) -> torch.Tensor:
        h = self.conv(leaky_relu(x))
        if film is not None:
            gamma, beta = film
            h = h * (1 + gamma) + beta
        return self.posconv(leaky_relu(h)) + x


class MRFBlock(nn.Module):
    """HiFi-GAN multi-receptive-field fusion: per kernel size a chain of FiLM
    blocks over the dilations, outputs averaged. With conditioning, every
    block's (gamma, beta) comes from one call of the cond-chain op."""

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
        spk (B, S) and exc (B, E, T) with S + E = cond_channels."""
        blocks = self.blocks()
        s = spk.shape[-1]
        # (3, Cc, n*Cc) and (3, Cc, n*2C): the JAX package's WIO layout
        w0 = torch.cat([blk.cond_0.weight() for blk in blocks], 0).permute(2, 1, 0)
        b0 = torch.cat([blk.cond_0.bias for blk in blocks])
        w1 = torch.cat([blk.cond_1.weight() for blk in blocks], 0).permute(2, 1, 0)
        b1 = torch.cat([blk.cond_1.bias for blk in blocks])
        w0_spk, w0_exc = w0[:, :s], w0[:, s:]
        hbias = spk @ (w0_spk[0] + w0_spk[1] + w0_spk[2]) + b0
        edge0 = spk @ w0_spk[0]   # the tap reading t-1 is the zero pad at t = 0
        edge_t = spk @ w0_spk[2]  # the tap reading t+1 is the zero pad at t = T-1
        gb = cond_chain_op.cond_chain(
            exc.transpose(1, 2).contiguous(), w0_exc.contiguous(), hbias,
            w1.contiguous(), b1, edge0, edge_t).transpose(1, 2)
        c = self.channels
        return [(gb[:, i * 2 * c:i * 2 * c + c], gb[:, i * 2 * c + c:(i + 1) * 2 * c])
                for i in range(len(blocks))]

    def forward(self, x: torch.Tensor, cond: tuple | None = None) -> torch.Tensor:
        films = self.films(*cond) if self.cond_channels and cond is not None else None
        y = 0.0
        blocks = self.blocks()
        for k in range(self.n_kernels):
            xs = x
            for j in range(self.nd):
                i = k * self.nd + j
                xs = blocks[i](xs, films[i] if films is not None else None)
            y = y + xs
        return y / self.n_kernels
