"""Small conv F0 and voicing predictor, in PyTorch.

Counterpart of ``td_vc_gan_tpu/models/f0_estimator.py``: a reflect k=15
input conv, grouped strided convs (groups = input width, k = 10s+1, pad 5s)
that double the width, ``pre_out``, then a sigmoid voicing head and an f0
head. Dead code in the reference trainer (CREPE gives the pitch), kept for
its inventory.
"""

from __future__ import annotations

import torch
from torch import nn

from td_vc_gan_tpu_torch.models.layers import WNConv1d, leaky_relu


class F0Estimator(nn.Module):
    """(B, T, 1) waveform -> (f0 (B, T', 1), voiced (B, T', 1)),
    T' = T / stride**num_layers, channels-last as in the JAX package."""

    def __init__(self, num_layers: int = 3, stride: int = 4, base_channels: int = 32):
        super().__init__()
        self.num_layers = num_layers
        nf = base_channels
        self.input = WNConv1d(1, nf, 15, padding=7, pad_mode="reflect")
        for i in range(num_layers):
            self.add_module(f"down_{i}", WNConv1d(nf, 2 * nf, stride * 10 + 1, stride=stride,
                                                  padding=stride * 5, groups=nf))
            nf *= 2
        self.pre_out = WNConv1d(nf, nf, 5, padding=2)
        self.out_voiced = WNConv1d(nf, 1, 3, padding=1, use_bias=False)
        self.out_f0 = WNConv1d(nf, 1, 3, padding=1, use_bias=False)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = leaky_relu(self.input(x.transpose(1, 2)))
        for i in range(self.num_layers):
            x = leaky_relu(getattr(self, f"down_{i}")(x))
        x = leaky_relu(self.pre_out(x))
        voiced = torch.sigmoid(self.out_voiced(x))
        return self.out_f0(x).transpose(1, 2), voiced.transpose(1, 2)
