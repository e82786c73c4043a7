"""STFT and mel spectrogram for the spectral losses.

Counterpart of ``td_vc_gan_tpu/ops/stft.py``, with the same semantics as
``torchaudio.transforms.MelSpectrogram(sample_rate, n_fft, hop_length=n_fft//4,
n_mels, norm='slaney')``: frames centred by reflect padding, a periodic Hann
window, the power spectrum, and HTK mel filters with Slaney area
normalisation. The windows and filterbanks are the port's own numpy copies;
the FFT is ``torch.fft.rfft``. Layouts are channels-last as in the JAX
package: spectrograms are ``(B, frames, bins)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from td_vc_gan_tpu_torch.ops.dsp import reflect_pad


@functools.lru_cache(maxsize=None)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / (200.0 / 3.0))


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    min_log_mel = 1000.0 / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)),
                    m * (200.0 / 3.0))


def _triangles(f_pts: np.ndarray, sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_freqs, n_mels) triangles through the mel points, Slaney area norm."""
    all_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """(n_freqs, n_mels) filterbank on the HTK mel scale, Slaney-normalised
    (``torchaudio.functional.melscale_fbanks(norm='slaney', mel_scale='htk')``)."""
    f_max = sr / 2.0 if f_max is None else f_max
    m_pts = np.linspace(_hz_to_mel_htk(np.array(f_min)), _hz_to_mel_htk(np.array(f_max)),
                        n_mels + 2)
    return _triangles(_mel_to_hz_htk(m_pts), sr, n_fft, n_mels)


@functools.lru_cache(maxsize=None)
def mel_filterbank_slaney(sr: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                          f_max: float | None = None) -> np.ndarray:
    """(n_freqs, n_mels) filterbank on the Slaney mel scale, Slaney-normalised
    (``librosa.filters.mel``'s default)."""
    f_max = sr / 2.0 if f_max is None else f_max
    m_pts = np.linspace(_hz_to_mel_slaney(np.array(f_min)),
                        _hz_to_mel_slaney(np.array(f_max)), n_mels + 2)
    return _triangles(_mel_to_hz_slaney(m_pts), sr, n_fft, n_mels)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int, center: bool = True):
    """(B, T) -> (B, n_frames, frame_length) overlapping frames; with
    ``center`` the signal is first reflect-padded by frame_length//2 on both
    sides (``torch.stft``'s centring)."""
    if center:
        p = frame_length // 2
        x = reflect_pad(x, p, p)
    return x.unfold(-1, frame_length, hop)


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.from_numpy(hann_window(n_fft)).to(device)


def stft_power(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT|^2 with a Hann window: (B, T) -> (B, n_frames, n_fft//2+1)."""
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * _window(n_fft, x.device), n=n_fft)
    return spec.real ** 2 + spec.imag ** 2


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann"):
    """|STFT|: (B, T) -> (B, n_frames, n_fft//2+1); ``window="rect"`` is a
    bare ``torch.stft`` call without a window argument (all ones)."""
    frames = frame_signal(x, n_fft, hop)
    if window == "hann":
        frames = frames * _window(n_fft, x.device)
    elif window != "rect":
        raise ValueError(f"unknown window {window!r}")
    spec = torch.fft.rfft(frames, n=n_fft)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2)


def melspectrogram(x: torch.Tensor, sr: int = 16000, n_fft: int = 2048, n_mels: int = 80,
                   hop: int | None = None) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_mels) power mel spectrogram."""
    hop = n_fft // 4 if hop is None else hop
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(x.device)
    return stft_power(x, n_fft, hop) @ fb

