"""YIN pitch estimation in torch, batched over leading axes.

Counterpart of ``td_vc_gan_tpu/ops/yin.py`` (the reference's util/yin.py,
de Cheveigné & Kawahara 2002): the FFT-autocorrelation difference function,
its cumulative-mean normalisation, then the threshold search (hard) or a
softmax-weighted search over lags (soft, differentiable).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _next_fft_size(n: int) -> int:
    """2^(ceil(log2 n) + 1), matching util/yin.py:98."""
    return 2 ** (-int(-np.log(n) // np.log(2)) + 1)


def _frame(signal: torch.Tensor, frame_length: int, frame_stride: int) -> torch.Tensor:
    if signal.shape[-1] < frame_length:
        signal = F.pad(signal, (0, frame_length - signal.shape[-1]))
    signal = F.pad(signal, (frame_length // 2, frame_length // 2 - 1))
    return signal.unfold(-1, frame_length, frame_stride)


def _diff(frames: torch.Tensor, tau_max: int) -> torch.Tensor:
    """Cumulative-mean-normalized difference function (eqs. 6 & 8)."""
    fft_size = _next_fft_size(frames.shape[-1])
    fft = torch.fft.rfft(frames, fft_size, dim=-1)
    corr = torch.fft.irfft(fft * torch.conj(fft), dim=-1)[..., :tau_max]
    sqrcs = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    corr_0 = sqrcs[..., -1:]
    corr_tau = torch.flip(sqrcs, (-1,))[..., :tau_max] - sqrcs[..., :tau_max]
    diff = corr_0 + corr_tau - 2 * corr
    lags = torch.arange(1, diff.shape[-1], device=diff.device, dtype=diff.dtype)
    return diff[..., 1:] * lags / torch.clamp(torch.cumsum(diff[..., 1:], dim=-1), min=1e-5)


def _search(cmdf: torch.Tensor, tau_max: int, threshold: float) -> torch.Tensor:
    # argmax takes the first of equal maxima, as jnp.argmax
    first_below = torch.argmax((cmdf < threshold).to(torch.int32), dim=-1, keepdim=True)
    first_below = torch.where(first_below > 0, first_below, tau_max)
    beyond_threshold = torch.arange(cmdf.shape[-1], device=cmdf.device) >= first_below
    increasing_slope = F.pad((torch.diff(cmdf, dim=-1) >= 0.0).to(torch.int32), (0, 1),
                             value=1).bool()
    return torch.argmax((beyond_threshold & increasing_slope).to(torch.int32), dim=-1)


def _softsearch(cmdf: torch.Tensor, threshold: float) -> torch.Tensor:
    """Differentiable soft-argmin over lags (util/yin.py:129-140)."""
    threshold_mask = torch.any(cmdf < threshold, dim=-1).to(cmdf.dtype)
    alpha = torch.exp(-cmdf * 100.0)
    alpha = alpha / torch.sum(alpha, dim=-1, keepdim=True)
    idx = torch.arange(cmdf.shape[-1], device=cmdf.device, dtype=cmdf.dtype)
    return torch.sum(alpha * idx, dim=-1) * threshold_mask


def estimate(signal: torch.Tensor, sample_rate: float, pitch_min: float = 20,
             pitch_max: float = 20000, frame_stride: float = 0.01, threshold: float = 0.1,
             soft: bool = False) -> torch.Tensor:
    """F0 per frame of ``signal`` (..., T); 0 marks non-periodic frames.
    Arguments and semantics as util/yin.py:24-85."""
    tau_min = int(sample_rate / pitch_max)
    tau_max = int(sample_rate / pitch_min)
    frames = _frame(signal, 2 * tau_max, int(frame_stride * sample_rate))
    cmdf = _diff(frames, tau_max)[..., tau_min:]
    tau = _softsearch(cmdf, threshold) if soft else _search(cmdf, tau_max, threshold)
    f0 = sample_rate / (tau + tau_min + 1).to(signal.dtype)
    return torch.where(tau > 0, f0, torch.zeros((), dtype=signal.dtype, device=signal.device))
