"""leaky_relu with the JAX package's gradient at 0.

``td_vc_gan_tpu/models/layers.py`` differentiates leaky_relu through a custom
VJP that reads the output: the gradient is ``where(y >= 0, g, slope * g)``,
so it is ``g`` where the input is exactly 0. ``torch.nn.functional.leaky_relu``
takes the slope there. :func:`leaky_relu` runs torch's forward (one kernel,
as before) and the JAX package's backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEAKY_RELU_SLOPE = 0.2


class _LeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        y = F.leaky_relu(x, slope)
        ctx.save_for_backward(y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # slope > 0 keeps the sign, so the output decides the branch
        return torch.where(y >= 0, g, g * ctx.slope), None


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_RELU_SLOPE) -> torch.Tensor:
    """leaky_relu(x) whose gradient is 1 where x >= 0 (0 included) and
    ``slope`` elsewhere, as the JAX package's."""
    return _LeakyReLU.apply(x, slope)
