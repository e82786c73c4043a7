"""Generator: conv content encoder -> excitation-conditioned decoder.

Counterpart of ``td_vc_gan_tpu/models/generator.py`` for the conv encoder
without bottleneck or norm layers, the configuration every shipped
conversion config uses. Submodule names follow the flax module names
(``encoder.stage_0_mrf.block_0_0.conv`` ...), which ``weights.py`` relies on.
Modules run ``(B, C, T)``; :meth:`Generator.forward` keeps the JAX package's
channels-last ``(B, T, C)`` at its boundary.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.models.layers import (
    Linear,
    MRFBlock,
    WNConv1d,
    WNConvTranspose1d,
    init_weights,
    leaky_relu,
)
from td_vc_gan_tpu_torch.ops.dsp import kaiser_filter

EXCITE_CHANNELS = (8, 8, 8, 8, 8)
SUBSAMPLE_OUT = (False, True, True, False)


class ExciteDownsampleBlock(nn.Module):
    """Strided conv stack plus an anti-aliased shortcut (1x1 conv, then a
    fixed depthwise Kaiser low-pass decimating by ``r``, padded 8r), the two
    branches trimmed to the shorter."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int,
                 n_layers: int = 2, kernel_size: int = 5, use_weight_norm: bool = True):
        super().__init__()
        r = self.r = scale_factor
        self.down_conv = WNConv1d(in_channels, out_channels, 2 * r, stride=r,
                                  padding=r // 2, use_weight_norm=use_weight_norm)
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", WNConv1d(
                out_channels, out_channels, kernel_size, padding="same",
                use_weight_norm=use_weight_norm))
        self.shortcut = WNConv1d(in_channels, out_channels, 1, use_weight_norm=False)
        f = torch.from_numpy(kaiser_filter(16 * r, 1.0 / r))
        self.register_buffer("lowpass", f.reshape(1, 1, -1).repeat(out_channels, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.down_conv(x)
        for i in range(self.n_layers):
            h = getattr(self, f"conv_{i}")(leaky_relu(h))
        sh = F.conv1d(self.shortcut(x), self.lowpass, stride=self.r, padding=8 * self.r,
                      groups=self.lowpass.shape[0])
        n = min(h.shape[-1], sh.shape[-1])
        return h[..., :n] + sh[..., :n]


class Encoder(nn.Module):
    """k7 reflect input conv, per stage [lrelu, strided conv k=2r, MRF], a
    final k7 conv and a projection to ``embedding_dim``; the output is
    L2-normalised over channels (eps 1e-12)."""

    def __init__(self, downsample_ratios, channel_sizes, embedding_dim: int | None,
                 use_weight_norm: bool = True, kernel_sizes=(3, 7, 11),
                 dilations=(1, 3, 5)):
        super().__init__()
        wn = use_weight_norm
        self.ratios = tuple(downsample_ratios)
        self.input_conv = WNConv1d(1, channel_sizes[0], 7, padding=3, pad_mode="reflect",
                                   use_weight_norm=wn)
        for i, r in enumerate(self.ratios):
            cin, ch = channel_sizes[i], channel_sizes[i + 1]
            self.add_module(f"stage_{i}_down", WNConv1d(
                cin, ch, 2 * r, stride=r, padding=r // 2 + r % 2, use_weight_norm=wn))
            self.add_module(f"stage_{i}_mrf", MRFBlock(
                ch, 0, dilations=tuple(dilations), kernel_sizes=tuple(kernel_sizes),
                use_weight_norm=wn))
        self.final_conv = WNConv1d(channel_sizes[-1], channel_sizes[-1], 7, padding=3,
                                   use_weight_norm=wn)
        self.proj = (WNConv1d(channel_sizes[-1], embedding_dim, 7, padding=3,
                              use_bias=False, use_weight_norm=wn)
                     if embedding_dim else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_conv(x)
        for i in range(len(self.ratios)):
            x = getattr(self, f"stage_{i}_down")(leaky_relu(x))
            x = getattr(self, f"stage_{i}_mrf")(x)
        x = self.final_conv(leaky_relu(x))
        if self.proj is not None:
            x = self.proj(leaky_relu(x))
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.clamp_min(norm, 1e-12)


class Decoder(nn.Module):
    """Upsampling decoder: per stage [lrelu, ConvT x r], a tap at the stages
    flagged in SUBSAMPLE_OUT, then an MRF block FiLM-conditioned on the
    speaker embedding and the excitation at that scale (the split cond)."""

    def __init__(self, upsample_ratios, channel_sizes, conditional_dim: int,
                 embedding_dim: int | None, use_weight_norm: bool = True,
                 kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
        super().__init__()
        wn = use_weight_norm
        self.ratios = tuple(upsample_ratios)
        n = len(self.ratios)
        # the excitation pyramid is built per ratio in forward order and
        # applied reversed, from the full-rate input conv down
        self.add_module(f"excite_down_{n}", WNConv1d(
            1, EXCITE_CHANNELS[0], 7, padding=3, pad_mode="reflect", use_weight_norm=wn))
        cin = EXCITE_CHANNELS[0]
        for j in range(n - 1, -1, -1):
            self.add_module(f"excite_down_{j}", ExciteDownsampleBlock(
                cin, EXCITE_CHANNELS[j + 1], self.ratios[j], use_weight_norm=wn))
            cin = EXCITE_CHANNELS[j + 1]
        self.proj = (WNConv1d(embedding_dim, channel_sizes[0], 7, padding=3,
                              use_bias=False, use_weight_norm=wn)
                     if embedding_dim else None)
        self.input_conv = WNConv1d(channel_sizes[0], channel_sizes[0], 7, padding=3,
                                   use_weight_norm=wn)
        for i, r in enumerate(self.ratios):
            cin, ch = channel_sizes[i], channel_sizes[i + 1]
            self.add_module(f"stage_{i}_up", WNConvTranspose1d(
                cin, ch, 2 * r, stride=r, padding=r // 2 + r % 2, output_padding=r % 2,
                use_weight_norm=wn))
            if i < len(SUBSAMPLE_OUT) and SUBSAMPLE_OUT[i]:
                self.add_module(f"subsample_out_{i}", WNConv1d(
                    ch, 1, 7, padding=3, pad_mode="reflect", use_weight_norm=wn))
            self.add_module(f"stage_{i}_mrf", MRFBlock(
                ch, conditional_dim + EXCITE_CHANNELS[i + 1], dilations=tuple(dilations),
                kernel_sizes=tuple(kernel_sizes), use_weight_norm=wn))
        self.output_conv = WNConv1d(channel_sizes[-1], 1, 7, padding=3, pad_mode="reflect",
                                    use_weight_norm=wn)

    def excite_pyramid(self, c_var: torch.Tensor) -> list[torch.Tensor]:
        """Excitation at every scale: [full rate, /r_n, ..., /prod(r)]."""
        n = len(self.ratios)
        c = getattr(self, f"excite_down_{n}")(c_var)
        scaled = [c]
        for j in range(n - 1, -1, -1):
            c = getattr(self, f"excite_down_{j}")(c)
            scaled.append(c)
        return scaled

    def forward(self, x: torch.Tensor, spk: torch.Tensor, c_var: torch.Tensor):
        """x (B, content_dim, T'), spk (B, S), c_var (B, 1, T) ->
        (wav (B, 1, T), subsamples)."""
        c_scales = self.excite_pyramid(c_var)
        if self.proj is not None:
            x = self.proj(leaky_relu(x))
        x = self.input_conv(leaky_relu(x))
        subsamples = []
        for i in range(len(self.ratios)):
            x = getattr(self, f"stage_{i}_up")(leaky_relu(x))
            if i < len(SUBSAMPLE_OUT) and SUBSAMPLE_OUT[i]:
                tap = getattr(self, f"subsample_out_{i}")(leaky_relu(x))
                subsamples.append(torch.tanh(tap))
            x = getattr(self, f"stage_{i}_mrf")(x, (spk, c_scales[-2 - i]))
        x = self.output_conv(leaky_relu(x))
        return torch.tanh(x), subsamples


class Generator(nn.Module):
    """Conv-encoder generator. ``forward(x, c_tgt, c_var)`` takes x (B, T, 1),
    a one-hot target speaker (B, num_classes) and the excitation (B, T, 1)
    (None: zeros) and returns (wav (B, T, 1), subsamples [(B, T_i, 1)],
    content (B, T', content_dim)), channels-last as in the JAX package. The
    excitation comes third, before the JAX signature's ``c_src``, which is a
    keyword here."""

    def __init__(self, decoder_ratios, decoder_channels, num_classes: int,
                 conditional_dim: int, content_dim: int | None = None,
                 use_weight_norm: tuple[bool, bool] = (True, True),
                 kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
        super().__init__()
        enc_wn, dec_wn = use_weight_norm
        self.num_classes = num_classes
        self.decoder_ratios = tuple(decoder_ratios)
        self.embedding = Linear(num_classes, conditional_dim)
        self.encoder = Encoder(tuple(reversed(decoder_ratios)),
                               tuple(reversed(decoder_channels)), content_dim,
                               use_weight_norm=enc_wn, kernel_sizes=kernel_sizes,
                               dilations=dilations)
        self.decoder = Decoder(decoder_ratios, decoder_channels, conditional_dim,
                               content_dim, use_weight_norm=dec_wn,
                               kernel_sizes=kernel_sizes, dilations=dilations)

    def forward(self, x: torch.Tensor | None, c_tgt: torch.Tensor | None,
                c_var: torch.Tensor | None = None, c_src: torch.Tensor | None = None,
                encode_only: bool = False, content: torch.Tensor | None = None):
        """The JAX Generator's call, channels-last.

        ``encode_only`` returns the content (B, T', content_dim) alone.
        ``content`` is a precomputed content embedding: the encoder is
        skipped and ``x`` is not read (the train step encodes once and decodes
        the conversion and identity passes from it). ``c_src`` is the
        source speaker's one-hot: the JAX package reads it only for the
        encoder and bottleneck conditioning, which the configurations this
        port supports do not have, so it is accepted and not read.
        """
        if content is None:
            content = self.encoder(x.transpose(1, 2))
        else:
            content = content.transpose(1, 2)
        if encode_only:
            return content.transpose(1, 2)
        spk = self.embedding(c_tgt)
        if c_var is None:
            total = math.prod(self.decoder_ratios)
            c_var = torch.zeros((content.shape[0], content.shape[-1] * total, 1),
                                dtype=content.dtype, device=content.device)
        wav, subsamples = self.decoder(content, spk, c_var.transpose(1, 2))
        return (wav.transpose(1, 2), [s.transpose(1, 2) for s in subsamples],
                content.transpose(1, 2))


def generator_from_config(gen_cfg, num_classes: int, device=None, seed: int = 0) -> Generator:
    """A Generator for a GeneratorConfig (conv encoder, no bottleneck, no
    norm layers, decoder conditioned on the target speaker), its weights made
    from ``seed``, on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    nl, cond = gen_cfg.norm_layer, gen_cfg.conditioning
    unsupported = []
    if gen_cfg.encoder_model != "conv":
        unsupported.append(f"encoder_model={gen_cfg.encoder_model!r}")
    if gen_cfg.num_bottleneck_layers:
        unsupported.append("bottleneck layers")
    if nl.encoder or nl.decoder:
        unsupported.append("norm layers")
    if cond.encoder is not None or cond.decoder != "target":
        unsupported.append("conditioning other than decoder='target'")
    if unsupported:
        raise NotImplementedError("the port's generator has no " + ", ".join(unsupported))
    wn = gen_cfg.weight_norm
    g = Generator(gen_cfg.decoder_ratios, gen_cfg.decoder_channels, num_classes,
                  gen_cfg.conditional_dim, gen_cfg.content_dim,
                  use_weight_norm=(wn.encoder == "weight_norm", wn.decoder == "weight_norm"),
                  kernel_sizes=tuple(gen_cfg.mrf_kernel_sizes),
                  dilations=tuple(gen_cfg.mrf_dilations))
    return init_weights(g, seed).to(dev)
