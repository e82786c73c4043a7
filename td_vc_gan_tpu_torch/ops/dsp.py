"""Waveform DSP of the conversion path: the Kaiser low-pass of the excitation
pyramid and sinusoid+noise excitation synthesis.

Counterparts of ``td_vc_gan_tpu/ops/dsp.py``. The JAX package draws the
excitation's start phase and noise from a JAX PRNG, which torch cannot
reproduce; :func:`f0_to_excitation` therefore takes them as optional
arguments and otherwise draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy.signal.windows import kaiser as _kaiser_window


@functools.lru_cache(maxsize=None)
def kaiser_filter(L: int, w: float) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (beta 2.5), L+1 taps, unit sum, float32.
    ``n = arange(-L//2, L//2+1)``, sinc(w*n) with a 1e-8-regularised
    denominator and the centre tap set to w."""
    n = np.arange(-(L // 2), L // 2 + 1, dtype=np.float64)
    f = np.sin(math.pi * w * n) / (math.pi * n + 1e-8)
    f[len(n) // 2] = w
    f = f * _kaiser_window(L + 1, 2.5, sym=True)
    f = f / f.sum()
    return f.astype(np.float32)


def _linear_upsample(x: torch.Tensor, scale: int):
    """Linear interpolation along the last axis as torch's
    ``F.interpolate(mode='linear', align_corners=False)``; returns (values,
    left index, right index) so callers can tell which frames contributed."""
    n = x.shape[-1]
    t = torch.arange(n * scale, dtype=torch.float32, device=x.device)
    src = torch.clamp((t + 0.5) / scale - 0.5, 0.0, n - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp_max(lo + 1, n - 1)
    frac = src - lo
    return x[..., lo] * (1.0 - frac) + x[..., hi] * frac, lo, hi


def f0_to_excitation(f0: torch.Tensor, step_size: int, sampling_rate: int = 16000,
                     start_phase: torch.Tensor | float | None = None,
                     noise: torch.Tensor | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """F0 frames (B, F) in Hz (0 = unvoiced) -> (B, (F-1)*step_size)
    excitation: 0.1*sin(phase + start_phase) + 0.003*noise, linear frequency
    interpolation where both neighbouring frames are voiced and nearest
    elsewhere, pure noise at gain 0.1/(3*0.003) where unvoiced.

    ``start_phase`` (a scalar in radians, shared by the batch) and ``noise``
    (standard normal, the output's shape) are drawn from ``generator`` when
    not given.
    """
    sin_gain = 0.1
    noise_std = 0.003
    noise_gain = sin_gain / (3 * noise_std)

    ang = 2.0 * math.pi * f0[..., :-1] / sampling_rate
    up_nearest = torch.repeat_interleave(ang, step_size, dim=-1)
    up_lin, lo, hi = _linear_upsample(ang, step_size)
    voiced = ang > 0
    freq = torch.where(voiced[..., lo] & voiced[..., hi], up_lin, up_nearest)

    phase = torch.cumsum(freq, dim=-1)
    if start_phase is None:
        start_phase = torch.rand((), generator=generator, device=f0.device) * 2.0 * math.pi
    if noise is None:
        noise = torch.randn(phase.shape, generator=generator, device=f0.device)
    excitation = sin_gain * torch.sin(phase + start_phase) + noise * noise_std
    return torch.where(freq == 0, noise * noise_std * noise_gain, excitation)
