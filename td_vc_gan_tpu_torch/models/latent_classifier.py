"""Adversarial speaker probe on the content embedding, in PyTorch.

Counterpart of ``td_vc_gan_tpu/models/latent_classifier.py``: gradient
reversal at the input, a strided weight-normed conv stack, per-class logits
averaged over time. The reversal makes the encoder remove speaker identity
while the probe learns to find it.
"""

from __future__ import annotations

import torch
from torch import nn

from td_vc_gan_tpu_torch.models.layers import WNConv1d, grad_reverse, leaky_relu


class LatentClassifier(nn.Module):
    """(B, T, C) content embedding -> (B, num_classes) logits."""

    def __init__(self, in_channels: int, num_classes: int, num_layers: int = 3,
                 num_channel_mult: int = 2, downsampling_factor: int = 2):
        super().__init__()
        self.num_layers = num_layers
        nf = in_channels
        ds = downsampling_factor
        for i in range(num_layers):
            self.add_module(f"down_{i}", WNConv1d(nf, nf * num_channel_mult, ds * 10 + 1,
                                                  stride=ds, padding=ds * 5))
            nf *= num_channel_mult
        self.pre_out = WNConv1d(nf, nf, 5, padding=2)
        self.output = WNConv1d(nf, num_classes, 3, padding=1, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = grad_reverse(x).transpose(1, 2)
        for i in range(self.num_layers):
            x = leaky_relu(getattr(self, f"down_{i}")(x))
        x = leaky_relu(self.pre_out(x))
        return torch.mean(self.output(x), dim=-1)
