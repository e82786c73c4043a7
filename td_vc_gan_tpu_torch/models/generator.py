"""Generator: content encoder -> bottleneck -> excitation-conditioned decoder.

Counterpart of ``td_vc_gan_tpu/models/generator.py`` with either content
encoder, the conv encoder or the SSL encoder (frozen WavLM and a posterior
encoder, ``encoder_model='wavlm'``), and every option of the JAX package's
Generator: the norm slots (instance norm, conditional instance norm), the
encoder's speaker conditioning, and the bottleneck of FiLM blocks on the
target speaker or on source and target. Submodule names follow
the flax module names (``encoder.stage_0_mrf.block_0_0.conv``,
``encoder.wavlm.encoder.layer_0.self_attn.q_kernel`` ...), which
``weights.py`` relies on.
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
    FiLMResnetBlock,
    Linear,
    MRFBlock,
    WNConv1d,
    WNConvTranspose1d,
    conv1d,
    finalize_dtype,
    init_weights,
    leaky_relu,
    make_norm,
)
from td_vc_gan_tpu_torch.models.ssl_encoder import SSLEncoder
from td_vc_gan_tpu_torch.models.wavlm import WavLMConfig
from td_vc_gan_tpu_torch.ops.dsp import kaiser_filter

EXCITE_CHANNELS = (8, 8, 8, 8, 8)
SUBSAMPLE_OUT = (False, True, True, False)
CIN = "conditional_instance_norm"


def _apply_norm(module: nn.Module, name: str, x: torch.Tensor, c) -> torch.Tensor:
    """The norm slot ``name`` of ``module`` applied to x (absent: identity)."""
    norm = getattr(module, name, None)
    if norm is None:
        return x
    return norm(x, c) if module.norm == CIN else norm(x)


def _over_time(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """c (B, S) broadcast over x's T: (B, S, T). ``torch.cat`` of it with a
    bf16 x gives f32, as ``jnp.concatenate`` does."""
    return c[:, :, None].expand(-1, -1, x.shape[-1])


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
        sh = self.shortcut(x)
        sh = conv1d(sh, self.lowpass.to(sh.dtype), stride=self.r, padding=8 * self.r,
                    groups=self.lowpass.shape[0])
        n = min(h.shape[-1], sh.shape[-1])
        return h[..., :n] + sh[..., :n]


class Encoder(nn.Module):
    """k7 reflect input conv, per stage [norm slot, lrelu, strided conv k=2r,
    MRF], a final k7 conv and a projection to ``embedding_dim``; the output is
    L2-normalised over channels (eps 1e-12), in f32 under a compute scope.

    With ``conditional_dim`` and no conditional instance norm, the speaker
    embedding ``c`` (B, conditional_dim) is concatenated after the input conv
    (so stage 0 takes ``channel_sizes[0] + conditional_dim`` channels); under
    ``norm='conditional_instance_norm'`` the norm slots read ``c`` instead,
    through a Linear of ``conditional_dim`` inputs."""

    def __init__(self, downsample_ratios, channel_sizes, embedding_dim: int | None,
                 use_weight_norm: bool = True, kernel_sizes=(3, 7, 11),
                 dilations=(1, 3, 5), conditional_dim: int = 0, norm: str | None = None):
        super().__init__()
        wn = use_weight_norm
        self.ratios = tuple(downsample_ratios)
        self.norm = norm
        self.concat_dim = conditional_dim if norm != CIN else 0
        self.input_conv = WNConv1d(1, channel_sizes[0], 7, padding=3, pad_mode="reflect",
                                   use_weight_norm=wn)
        cin = channel_sizes[0] + self.concat_dim
        for i, r in enumerate(self.ratios):
            ch = channel_sizes[i + 1]
            if norm is not None:
                self.add_module(f"stage_{i}_norm", make_norm(norm, cin, conditional_dim))
            self.add_module(f"stage_{i}_down", WNConv1d(
                cin, ch, 2 * r, stride=r, padding=r // 2 + r % 2, use_weight_norm=wn))
            self.add_module(f"stage_{i}_mrf", MRFBlock(
                ch, 0, dilations=tuple(dilations), kernel_sizes=tuple(kernel_sizes),
                use_weight_norm=wn))
            cin = ch
        self.final_conv = WNConv1d(channel_sizes[-1], channel_sizes[-1], 7, padding=3,
                                   use_weight_norm=wn)
        self.proj = (WNConv1d(channel_sizes[-1], embedding_dim, 7, padding=3,
                              use_bias=False, use_weight_norm=wn)
                     if embedding_dim else None)

    def forward(self, x: torch.Tensor, c: torch.Tensor | None = None) -> torch.Tensor:
        x = self.input_conv(x)
        if self.concat_dim:
            if c is None:
                raise ValueError("the encoder's speaker conditioning needs the source "
                                 "speaker (c_src): its stage 0 is sized for the concat")
            x = torch.cat([x, _over_time(c, x)], 1)
        for i in range(len(self.ratios)):
            x = _apply_norm(self, f"stage_{i}_norm", x, c)
            x = getattr(self, f"stage_{i}_down")(leaky_relu(x))
            x = getattr(self, f"stage_{i}_mrf")(x)
        x = self.final_conv(leaky_relu(x))
        if self.proj is not None:
            x = self.proj(leaky_relu(x))
        x = finalize_dtype(x)
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.clamp_min(norm, 1e-12)


class Decoder(nn.Module):
    """Upsampling decoder: per stage [norm slot, lrelu, ConvT x r], a tap at
    the stages flagged in SUBSAMPLE_OUT, then an MRF block FiLM-conditioned on
    the speaker embedding and the excitation at that scale (the split cond);
    a last norm slot before the output conv. Under conditional instance norm
    the slots read concat(speaker broadcast over time, excitation at that
    scale), refreshed after each ConvT."""

    def __init__(self, upsample_ratios, channel_sizes, conditional_dim: int,
                 embedding_dim: int | None, use_weight_norm: bool = True,
                 kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), norm: str | None = None):
        super().__init__()
        wn = use_weight_norm
        self.ratios = tuple(upsample_ratios)
        self.norm = norm
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
        # a CIN's cond: the speaker and the pyramid's excitation (8 channels at
        # every scale)
        norm_cond = conditional_dim + EXCITE_CHANNELS[0]
        for i, r in enumerate(self.ratios):
            cin, ch = channel_sizes[i], channel_sizes[i + 1]
            if norm is not None:
                self.add_module(f"stage_{i}_norm", make_norm(norm, cin, norm_cond, True))
            self.add_module(f"stage_{i}_up", WNConvTranspose1d(
                cin, ch, 2 * r, stride=r, padding=r // 2 + r % 2, output_padding=r % 2,
                use_weight_norm=wn))
            if i < len(SUBSAMPLE_OUT) and SUBSAMPLE_OUT[i]:
                self.add_module(f"subsample_out_{i}", WNConv1d(
                    ch, 1, 7, padding=3, pad_mode="reflect", use_weight_norm=wn))
            self.add_module(f"stage_{i}_mrf", MRFBlock(
                ch, conditional_dim + EXCITE_CHANNELS[i + 1], dilations=tuple(dilations),
                kernel_sizes=tuple(kernel_sizes), use_weight_norm=wn))
        if norm is not None:
            self.final_norm = make_norm(norm, channel_sizes[-1], norm_cond, True)
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
        if c_var is None:
            # the JAX Decoder raises here too: its 2-D MRF form is sized
            # conditional_dim + 8 but gets a conditional_dim-wide cond
            raise ValueError("the decoder needs an excitation c_var (the Generator passes "
                             "zeros when it has none)")
        c_scales = self.excite_pyramid(c_var)
        cin = self.norm == CIN
        cond = torch.cat([_over_time(spk, c_scales[-1]), c_scales[-1]], 1) if cin else None
        if self.proj is not None:
            x = self.proj(leaky_relu(x))
        x = self.input_conv(leaky_relu(x))
        subsamples = []
        for i in range(len(self.ratios)):
            x = _apply_norm(self, f"stage_{i}_norm", x, cond)
            x = getattr(self, f"stage_{i}_up")(leaky_relu(x))
            if i < len(SUBSAMPLE_OUT) and SUBSAMPLE_OUT[i]:
                tap = getattr(self, f"subsample_out_{i}")(leaky_relu(x))
                subsamples.append(torch.tanh(tap))
            exc = c_scales[-2 - i]
            if cin:
                cond = torch.cat([_over_time(spk, exc), exc], 1)
            x = getattr(self, f"stage_{i}_mrf")(x, (spk, exc))
        x = _apply_norm(self, "final_norm", x, cond)
        x = self.output_conv(leaky_relu(x))
        return torch.tanh(x), subsamples


class Generator(nn.Module):
    """The generator. ``forward(x, c_tgt, c_var)`` takes x (B, T, 1),
    a one-hot target speaker (B, num_classes) and the excitation (B, T, 1)
    (None: zeros) and returns (wav (B, T, 1), subsamples [(B, T_i, 1)],
    content (B, T', content_dim)), channels-last as in the JAX package. The
    excitation comes third, before the JAX signature's ``c_src``, which is a
    keyword here.

    ``encoder_model='wavlm'`` takes the SSL encoder (``num_enc_layers`` WN
    layers, ``content_dim`` wide, over a frozen WavLM of ``wavlm_cfg``, None:
    WavLM-Large) in place of the conv encoder; its frames are 320 samples,
    so the decoder's ratios must multiply to 320.

    The options, as the JAX Generator's: ``norm_layer`` (bottleneck, encoder,
    decoder) names each stack's norm slots (None, ``'instance_norm'`` or
    ``'conditional_instance_norm'``; the bottleneck's is never applied, as in
    the JAX package); ``use_weight_norm`` is (bottleneck, encoder, decoder);
    ``enc_cond`` (any value but None) conditions the conv encoder on the
    source speaker; ``num_bottleneck_layers`` FiLM blocks between encoder and
    decoder condition on the target speaker, or on source ⊕ target under
    ``bot_cond='both'``."""

    def __init__(self, decoder_ratios, decoder_channels, num_classes: int,
                 conditional_dim: int, content_dim: int | None = None,
                 use_weight_norm: tuple[bool, bool, bool] = (True, True, True),
                 kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                 encoder_model: str = "conv", num_enc_layers: int = 16,
                 wavlm_cfg: WavLMConfig | None = None, num_bottleneck_layers: int = 0,
                 norm_layer: tuple = (None, None, None), bot_cond: str = "target",
                 enc_cond: str | None = None):
        super().__init__()
        bot_wn, enc_wn, dec_wn = use_weight_norm
        _, enc_norm, dec_norm = norm_layer
        self.num_classes = num_classes
        self.decoder_ratios = tuple(decoder_ratios)
        self.bot_cond, self.enc_cond = bot_cond, enc_cond
        self.num_bottleneck_layers = num_bottleneck_layers
        self.embedding = Linear(num_classes, conditional_dim)
        self.wavlm = encoder_model == "wavlm"
        if self.wavlm:
            self.encoder = SSLEncoder(num_enc_layers, content_dim, wavlm_cfg=wavlm_cfg)
        else:
            self.encoder = Encoder(
                tuple(reversed(decoder_ratios)), tuple(reversed(decoder_channels)),
                content_dim, use_weight_norm=enc_wn, kernel_sizes=kernel_sizes,
                dilations=dilations, norm=enc_norm,
                conditional_dim=conditional_dim if enc_cond is not None or enc_norm == CIN
                else 0)
        width = content_dim or decoder_channels[0]
        bot_c = 2 * conditional_dim if bot_cond == "both" else conditional_dim
        for i in range(num_bottleneck_layers):
            self.add_module(f"bottleneck_{i}", FiLMResnetBlock(
                width, bot_c, dilation=1, use_weight_norm=bot_wn))
        self.decoder = Decoder(decoder_ratios, decoder_channels, conditional_dim,
                               content_dim, use_weight_norm=dec_wn,
                               kernel_sizes=kernel_sizes, dilations=dilations, norm=dec_norm)

    def forward(self, x: torch.Tensor | None, c_tgt: torch.Tensor | None,
                c_var: torch.Tensor | None = None, c_src: torch.Tensor | None = None,
                encode_only: bool = False, content: torch.Tensor | None = None):
        """The JAX Generator's call, channels-last.

        ``encode_only`` returns the content (B, T', content_dim) alone.
        ``content`` is a precomputed content embedding: the encoder is
        skipped and ``x`` is not read (the train step encodes once and decodes
        the conversion and identity passes from it); the bottleneck still
        runs. Under a compute scope the outputs are cast back to f32.
        ``c_src`` is the source speaker's one-hot: the encoder's conditioning
        and ``bot_cond='both'`` read it and raise without it, as the JAX
        package does; the train step and the Converter never pass it.
        """
        spk = self.embedding(c_tgt) if c_tgt is not None else None
        src = self.embedding(c_src) if c_src is not None else None
        if content is None:
            xt = x.transpose(1, 2)
            content = (self.encoder(xt) if self.wavlm else
                       self.encoder(xt, src if self.enc_cond is not None else None))
        else:
            content = content.transpose(1, 2)
        if encode_only:
            return finalize_dtype(content.transpose(1, 2))
        h = content
        if self.num_bottleneck_layers:
            bot_c = spk
            if self.bot_cond == "both":
                if src is None:
                    raise ValueError("bot_cond='both' needs the source speaker (c_src), "
                                     "which the train step and the Converter never pass")
                bot_c = torch.cat([src, spk], -1)
            for i in range(self.num_bottleneck_layers):
                h = getattr(self, f"bottleneck_{i}")(h, c=bot_c)
        if c_var is None:
            total = math.prod(self.decoder_ratios)
            c_var = torch.zeros((h.shape[0], h.shape[-1] * total, 1),
                                dtype=h.dtype, device=h.device)
        wav, subsamples = self.decoder(h, spk, c_var.transpose(1, 2))
        return (finalize_dtype(wav.transpose(1, 2)),
                [finalize_dtype(s.transpose(1, 2)) for s in subsamples],
                finalize_dtype(content.transpose(1, 2)))


def generator_from_config(gen_cfg, num_classes: int, device=None, seed: int = 0,
                          wavlm_cfg: WavLMConfig | None = None,
                          compute_dtype: str | None = None) -> Generator:
    """A Generator for a GeneratorConfig, its weights made from ``seed``, on
    ``device`` (default: the CUDA card). ``wavlm_cfg`` sizes the WavLM
    backbone (None: WavLM-Large, in ``compute_dtype``, as the JAX package's:
    the conv stacks take theirs from the compute scope instead).

    Every option of the JAX package's ``generator_from_config`` builds.
    ``norm_layer.bottleneck`` is accepted and never applied, as in the JAX
    package. Refused here, because the JAX Generator cannot run them: an
    ``encoder_model`` other than conv or wavlm (the JAX ``validate`` refuses
    it), and ``conditioning.decoder=None`` (the JAX decoder then sizes its
    MRF cond for the excitation alone, 8 channels, yet still feeds it the
    speaker, and its first cond conv raises).
    """
    dev = resolve_device(device)
    nl, cond = gen_cfg.norm_layer, gen_cfg.conditioning
    if gen_cfg.encoder_model not in ("conv", "wavlm"):
        raise ValueError(f"unknown encoder_model {gen_cfg.encoder_model!r}")
    if cond.decoder is None:
        raise ValueError(
            "conditioning.decoder=None: the JAX package's decoder sizes its MRF cond for "
            "the excitation alone (8 channels) yet still feeds it the speaker embedding, "
            "and raises; the port refuses it")
    if (wavlm_cfg is None and gen_cfg.encoder_model == "wavlm"
            and compute_dtype not in (None, "float32")):
        wavlm_cfg = WavLMConfig(compute_dtype=compute_dtype)
    wn = gen_cfg.weight_norm
    g = Generator(gen_cfg.decoder_ratios, gen_cfg.decoder_channels, num_classes,
                  gen_cfg.conditional_dim, gen_cfg.content_dim,
                  use_weight_norm=tuple(w == "weight_norm" for w in
                                        (wn.bottleneck, wn.encoder, wn.decoder)),
                  kernel_sizes=tuple(gen_cfg.mrf_kernel_sizes),
                  dilations=tuple(gen_cfg.mrf_dilations),
                  encoder_model=gen_cfg.encoder_model, num_enc_layers=gen_cfg.num_enc_layers,
                  wavlm_cfg=wavlm_cfg, num_bottleneck_layers=gen_cfg.num_bottleneck_layers,
                  norm_layer=(nl.bottleneck, nl.encoder, nl.decoder),
                  bot_cond=cond.bottleneck or "target", enc_cond=cond.encoder)
    return init_weights(g, seed).to(dev)
