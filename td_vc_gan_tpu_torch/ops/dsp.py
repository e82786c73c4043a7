"""Waveform DSP: the Kaiser low-passes of the excitation pyramid and the
discriminator, sinusoid+noise excitation synthesis, per-row circular shifts
and jitter.

Counterparts of ``td_vc_gan_tpu/ops/dsp.py``. The JAX package draws its
random numbers (the excitation's start phase and noise, the jitter shifts)
from a JAX PRNG, which torch cannot reproduce; the functions here therefore
take them as optional arguments and otherwise draw them from a
``torch.Generator``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal.windows import kaiser as _kaiser_window


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis as ``jnp.pad(mode="reflect")``: ``F.pad``
    where every pad is shorter than the axis, else by index, reflecting as
    often as the pad needs (period 2*(T-1)); needs T >= 2 then."""
    t = x.shape[-1]
    if max(left, right) < t:
        return F.pad(x, (left, right), mode="reflect")
    if t < 2:
        raise ValueError(f"reflect padding of {max(left, right)} needs at least 2 samples, "
                         f"got {t}")
    period = 2 * (t - 1)
    idx = torch.remainder(torch.arange(-left, t + right, device=x.device), period)
    idx = torch.where(idx < t, idx, period - idx)
    return x.index_select(-1, idx)


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


@functools.lru_cache(maxsize=None)
def kaiser_filter_fc(L: int, fc: float, beta: float = 2.5) -> np.ndarray:
    """Kaiser low-pass with an explicit cutoff and beta, L taps (L odd), unit
    sum, float32: the discriminator's 129-tap band split (fc 0.5, beta 10)."""
    if L % 2 == 0:
        raise ValueError("even-length filter not supported")
    n = np.arange(-((L - 1) // 2), (L - 1) // 2 + 1, dtype=np.float64)
    f = np.sin(math.pi * fc * n) / (math.pi * n + 1e-8)
    f[len(n) // 2] = fc
    f = f * _kaiser_window(L, beta, sym=True)
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


def roll_batches(x: torch.Tensor, shifts: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-row circular shift along ``axis``: out[b, ..., j, ...] =
    x[b, ..., (j - shifts[b]) mod n, ...], so a positive shift moves content
    to higher indices. ``shifts`` (B,) indexes axis 0 of ``x``."""
    axis = axis % x.dim()
    n = x.shape[axis]
    j = torch.arange(n, device=x.device)
    idx = torch.remainder(j[None, :] - shifts.to(x.device, torch.int64)[:, None], n)  # (B, n)
    shape = [1] * x.dim()
    shape[0], shape[axis] = x.shape[0], n
    return torch.gather(x, axis, idx.reshape(shape).expand(x.shape))


def add_jitter(x: torch.Tensor, jitter_amp: int, shifts: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Circular time shift of each row by a draw from [-amp, amp] (time is
    the last axis); ``shifts`` (B,) injects the draws."""
    if shifts is None:
        shifts = torch.randint(-jitter_amp, jitter_amp + 1, (x.shape[0],),
                               generator=generator, device=x.device)
    return roll_batches(x, shifts, x.dim() - 1)


# Host-side (numpy) RMS helpers of the input pipeline, as the JAX package's
# ops/dsp.py:188-205.


def eq_rms_gain(signal: np.ndarray, target_rms_db: float) -> float:
    """The scalar ``eq_rms`` multiplies by, so that the input pipeline can
    cache it per file and scale crop slices (a scalar multiply commutes
    bitwise with slicing)."""
    rms = np.sqrt((signal**2).mean())
    return 10 ** (target_rms_db / 20) / rms


def eq_rms(signal: np.ndarray, target_rms_db: float) -> np.ndarray:
    """Scale a waveform to a target RMS in dBFS (util/__init__.py:53-56)."""
    return signal * eq_rms_gain(signal, target_rms_db)


def eq_rms_signals(signal_eq: np.ndarray, signal_tgt: np.ndarray) -> np.ndarray:
    """Match the RMS of ``signal_eq`` to ``signal_tgt`` (util/__init__.py:58-62)."""
    rms_eq = np.sqrt((signal_eq**2).mean())
    rms_tgt = np.sqrt((signal_tgt**2).mean())
    return signal_eq * rms_tgt / (rms_eq + 1e-8)
