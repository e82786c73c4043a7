"""SSL content encoder: frozen WavLM features -> WaveNet posterior encoder.

Counterpart of ``td_vc_gan_tpu/models/ssl_encoder.py``. The WavLM backbone
is frozen: its parameters have ``requires_grad=False`` and it runs under
``torch.no_grad()`` (the JAX package's ``stop_gradient``), so it keeps no
activations for autograd; the train state leaves it out of the optimizer
(the frozen prefix ``encoder/wavlm``). The trainable part is the posterior
encoder, whose mean is the content embedding. Modules run ``(B, C, T)``;
the backbone's channels-last features are transposed once, into the
posterior.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch.models.layers import WNConv1d
from td_vc_gan_tpu_torch.models.wavlm import WavLM, WavLMConfig


class WN(nn.Module):
    """WaveNet stack: per layer a dilated weight-normed conv to 2h, the gated
    tanh * sigmoid, then a 1x1 conv to residual and skip halves (the last
    layer's is h wide: skip only)."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int):
        super().__init__()
        h = self.hidden = hidden_channels
        self.n_layers = n_layers
        for i in range(n_layers):
            dilation = dilation_rate ** i
            pad = (kernel_size * dilation - dilation) // 2
            self.add_module(f"in_{i}", WNConv1d(h, 2 * h, kernel_size, dilation=dilation,
                                                padding=pad))
            self.add_module(f"res_skip_{i}", WNConv1d(h, 2 * h if i < n_layers - 1 else h, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.hidden
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_{i}")(x)
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = x + res_skip[:, :h]
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output


class PosteriorEncoder(nn.Module):
    """pre 1x1 -> WN -> proj 1x1 to 2 * out; returns the mean half ``m``,
    the only part read downstream (no sampling path)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16):
        super().__init__()
        self.out_channels = out_channels
        self.pre = WNConv1d(in_channels, hidden_channels, 1, use_weight_norm=False)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers)
        self.proj = WNConv1d(hidden_channels, 2 * out_channels, 1, use_weight_norm=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.enc(self.pre(x)))[:, :self.out_channels]


class SSLEncoder(nn.Module):
    """Frozen WavLM -> trainable posterior encoder -> content mean.

    ``forward(x)``: x (B, 1, T) or (B, T), left-padded by 160 zeros, gives
    (B, emb_dim, T / 320) for T a multiple of 320. ``features`` (B, T', D),
    channels-last as WavLM gives them, skips the backbone."""

    def __init__(self, num_layers: int = 16, emb_dim: int = 128, kernel_size: int = 5,
                 dilation_rate: int = 1, wavlm_cfg: WavLMConfig | None = None):
        super().__init__()
        cfg = wavlm_cfg if wavlm_cfg is not None else WavLMConfig()
        self.wavlm = WavLM(cfg).requires_grad_(False)
        self.posterior = PosteriorEncoder(cfg.encoder_embed_dim, emb_dim, emb_dim,
                                          kernel_size, dilation_rate, num_layers)

    def forward(self, x: torch.Tensor | None, features: torch.Tensor | None = None):
        if features is None:
            wav = x[:, 0] if x.dim() == 3 else x
            with torch.no_grad():
                features = self.wavlm(F.pad(wav, (160, 0)))
        return self.posterior(features.transpose(1, 2))
