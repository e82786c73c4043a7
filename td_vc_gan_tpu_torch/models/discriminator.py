"""Waveform discriminators with per-speaker output heads, in PyTorch.

Counterpart of ``td_vc_gan_tpu/models/discriminator.py``: MelGAN-style conv
stacks whose last conv emits one logit map per speaker, of which the target
label selects one; the multiband discriminator scores a Kaiser-decimated
cascade of the input plus the generator's subsample taps with shared
per-band weights. Submodule names follow the flax names
(``disc_0.down_1.v`` ...), which ``weights.py`` relies on. Inputs and logits
are channels-last, ``(B, T, 1)``, as in the JAX package; the feature maps are
in torch's ``(B, C, T)`` layout (the losses only take means over them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.models.layers import WNConv1d, finalize_dtype, init_weights, leaky_relu
from td_vc_gan_tpu_torch.ops.dsp import kaiser_filter_fc

KAISER_TAPS = 129


class Discriminator(nn.Module):
    """Single-band discriminator: a k15 reflect input conv, ``num_layers``
    grouped strided convs (k = 10*ds + 1), a k5 conv and a k3 per-speaker
    head. Returns (selected logits (B, T', 1), feature maps), in f32 under a
    compute scope (the adversarial and feature losses run in f32)."""

    def __init__(self, num_classes: int, num_layers: int = 4, num_channels_base: int = 16,
                 num_channel_mult: int = 4, downsampling_factor: int = 4,
                 num_channel_max: int = 1024, use_weight_norm: bool = True):
        super().__init__()
        wn = use_weight_norm
        self.num_layers = num_layers
        self.input = WNConv1d(1, num_channels_base, 15, padding=7, pad_mode="reflect",
                              use_weight_norm=wn)
        nf = num_channels_base
        ds = downsampling_factor
        for i in range(num_layers):
            nf_prev = nf
            nf = min(nf * num_channel_mult, num_channel_max)
            self.add_module(f"down_{i}", WNConv1d(
                nf_prev, nf, ds * 10 + 1, stride=ds, padding=ds * 5,
                groups=nf_prev // num_channel_mult, use_weight_norm=wn))
        self.pre_out = WNConv1d(nf, nf, 5, padding=2, use_weight_norm=wn)
        self.output = WNConv1d(nf, num_classes, 3, padding=1, use_bias=False,
                               use_weight_norm=wn)

    def forward(self, x: torch.Tensor, label_tgt: torch.Tensor):
        x = leaky_relu(self.input(x.transpose(1, 2)))
        features = [x]
        for i in range(self.num_layers):
            x = leaky_relu(getattr(self, f"down_{i}")(x))
            features.append(x)
        x = leaky_relu(self.pre_out(x))
        features.append(x)
        logits = self.output(x)
        idx = label_tgt.to(torch.int64)[:, None, None].expand(-1, 1, logits.shape[-1])
        return (finalize_dtype(torch.gather(logits, 1, idx).transpose(1, 2)),
                [finalize_dtype(f) for f in features])


class MultiscaleDiscriminator(nn.Module):
    """Average-pool cascade of single-band discriminators (the reference's
    discriminator.py:55-75; imported but unused by its trainer). Scale i
    scores the input pooled i times (k=4, stride 2, pad 1, padding not
    counted). Returns (per-scale logits (B, T_i, 1), per-scale feature maps)."""

    def __init__(self, num_disc: int, num_classes: int, num_layers: int = 4,
                 num_channels_base: int = 16, num_channel_mult: int = 4,
                 downsampling_factor: int = 4, use_weight_norm: bool = True):
        super().__init__()
        self.num_disc = num_disc
        for i in range(num_disc):
            self.add_module(f"disc_{i}", Discriminator(
                num_classes, num_layers, num_channels_base, num_channel_mult,
                downsampling_factor, use_weight_norm=use_weight_norm))

    def forward(self, x: torch.Tensor, label_tgt: torch.Tensor):
        outs, feats = [], []
        for i in range(self.num_disc):
            o, f = getattr(self, f"disc_{i}")(x, label_tgt)
            outs.append(o)
            feats.append(f)
            x = F.avg_pool1d(x.transpose(1, 2), 4, 2, 1,
                             count_include_pad=False).transpose(1, 2)
        return outs, feats


def kaiser_downsample(x: torch.Tensor) -> torch.Tensor:
    """The fixed 129-tap Kaiser low-pass (beta 10, fc 0.5) with stride-2
    decimation: (B, T, 1) -> (B, T/2, 1), zero padding of 64 on each side."""
    f = torch.from_numpy(kaiser_filter_fc(KAISER_TAPS, 0.5, 10.0)).to(x.device, x.dtype)
    y = F.conv1d(x.transpose(1, 2), f.reshape(1, 1, -1), stride=2,
                 padding=(KAISER_TAPS - 1) // 2)
    return y.transpose(1, 2)


class CollaborativeMultibandDiscriminator(nn.Module):
    """``num_disc`` discriminators: disc_i scores the input decimated i times;
    the given ``subscales`` (generator taps, coarsest first) go to the
    discriminators in reverse order. Returns (logits list, features list)."""

    def __init__(self, num_disc: int, num_classes: int, num_layers: int = 4,
                 num_channels_base: int = 16, num_channel_mult: int = 4,
                 downsampling_factor: int = 4, use_weight_norm: bool = True):
        super().__init__()
        self.num_disc = num_disc
        for i in range(num_disc):
            self.add_module(f"disc_{i}", Discriminator(
                num_classes, num_layers, num_channels_base, num_channel_mult,
                downsampling_factor, use_weight_norm=use_weight_norm))

    def discs(self) -> list[Discriminator]:
        return [getattr(self, f"disc_{i}") for i in range(self.num_disc)]

    def forward(self, x: torch.Tensor, label_tgt: torch.Tensor, subscales=()):
        discs = self.discs()
        outs, feats = [], []
        for disc in discs:
            o, f = disc(x, label_tgt)
            outs.append(o)
            feats.append(f)
            x = kaiser_downsample(x)
        for x_sub, disc in zip(subscales, reversed(discs)):
            o, f = disc(x_sub, label_tgt)
            outs.append(o)
            feats.append(f)
        return outs, feats

    @staticmethod
    def get_subsamples(x: torch.Tensor, num_disc: int = 3) -> list[torch.Tensor]:
        """The low-passed pyramid of a real signal that matches the
        generator's taps: [x / 2^(num_disc-1), ..., x / 2]."""
        ret = []
        for _ in range(num_disc - 1):
            x = kaiser_downsample(x)
            ret.append(x)
        return ret[::-1]


def discriminator_from_config(cfg, num_classes: int, device=None,
                              seed: int = 0) -> CollaborativeMultibandDiscriminator:
    """The trainer's discriminator for a ``Config`` (``model.discriminator``),
    its weights made from ``seed``, on ``device`` (default: the CUDA card)."""
    dc = cfg.model.discriminator
    d = CollaborativeMultibandDiscriminator(
        dc.num_disc, num_classes, dc.num_layers, dc.num_channels_base,
        dc.num_channel_mult, dc.downsampling_factor)
    return init_weights(d, seed).to(resolve_device(device))
