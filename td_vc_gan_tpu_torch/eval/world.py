"""First-party WORLD-style vocoder analysis for the eval harness.

The port's own copy of ``td_vc_gan_tpu/eval/world.py``, unchanged in
behaviour but for ``freqt``, which runs the numpy recursion of
``td_vc_gan_tpu/native/__init__.py`` (its fallback branch) where the JAX
package calls its C++ library: the same operations in the same order.

The reference MCD harness (test_scripts/common/test_mcd.py:29-49) extracts
``pyworld.dio -> pyworld.stonemask -> pyworld.cheaptrick`` and converts the
smoothed spectrogram to 24-dim mel-cepstra with ``pysptk.sp2mc`` (alpha=0.42).
Neither wheel is a dependency, so this module re-implements the
algorithms from their published descriptions (Morise et al., WORLD; Tokuda et
al., mel-cepstral analysis):

- ``dio``: band-wise period candidates from zero-crossing/peak/dip intervals
  of low-passed signals, scored by cross-estimator agreement.
- ``stonemask``: local refinement of each voiced frame's F0 by maximizing the
  windowed DFT magnitude around the candidate (parabolic sub-bin step).
- ``cheaptrick``: pitch-adaptive (3-period Hann) power spectrum, rectangular
  smoothing of width 2f0/3, and cepstral liftering with the sinc smoothing
  compensation and q1=-0.15 correction lifter.
- ``sp2mc`` / ``mc2sp``: SPTK frequency-warped cepstra via the Oppenheim
  ``freqt`` recursion (exact round-trip tested in tests/test_world.py).

This makes the harness's MCD cross-comparable with WORLD/SPTK-based published
numbers instead of only internally consistent (round-1 VERDICT, missing #5).

Measured F0 accuracy vs ground truth on adversarial synthetic corpora
(tests/test_world.py::TestCalibration pins these as regression bounds):
steady tones 60-400 Hz exact (0.00 mean / 0.01 p95 cents), +-3% 5.5 Hz
vibrato 3.7 mean cents, breathy voice (0.3 noise) 8.5, octave glide < 10,
and immune to the dominant-2nd-harmonic octave trap. pyworld is not a
dependency, so absolute parity with pyworld's dio/stonemask is
bounded by these corpora rather than golden-vector diffing; the residual
risk is a constant analysis-convention offset that cancels in the
harness's paired orig-vs-converted MCD protocol.
"""

from __future__ import annotations

import numpy as np

DEFAULT_F0 = 500.0  # CheapTrick's substitute for unvoiced frames (WORLD kDefaultF0)
Q1 = -0.15  # CheapTrick spectral recovery coefficient


# ---------------------------------------------------------------------------
# DIO: F0 candidates from filtered zero-crossing statistics
# ---------------------------------------------------------------------------


def _lowpass_fft(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """Sharp lowpass (raised-cosine transition over 0.2*cutoff).

    The transition must be steep enough that the 2nd harmonic of a pitch at
    the band boundary is fully rejected, like DIO's Nuttall-windowed filters
    — a shallow rolloff lets harmonics corrupt the interval estimates.
    """
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    roll = 0.5 * (1 + np.cos(np.pi * np.clip((freqs - cutoff) / (0.2 * cutoff), 0, 1)))
    gain = np.where(freqs <= cutoff, 1.0, roll)
    return np.fft.irfft(spec * gain, n=len(x))


def _interval_f0(events: np.ndarray, fs: float, times: np.ndarray) -> np.ndarray:
    """Interpolate 1/interval (Hz) measured at event midpoints onto `times`."""
    if len(events) < 3:
        return np.zeros_like(times)
    intervals = np.diff(events) / fs
    mids = (events[:-1] + events[1:]) / 2.0 / fs
    with np.errstate(divide="ignore"):
        f0 = np.where(intervals > 0, 1.0 / np.maximum(intervals, 1e-9), 0.0)
    return np.interp(times, mids, f0, left=0.0, right=0.0)


def _crossings(x: np.ndarray, rising: bool) -> np.ndarray:
    s = np.signbit(x)
    if rising:
        return np.nonzero(s[:-1] & ~s[1:])[0]
    return np.nonzero(~s[:-1] & s[1:])[0]


def _extrema(x: np.ndarray, maxima: bool) -> np.ndarray:
    d = np.diff(x)
    if maxima:
        return np.nonzero((d[:-1] > 0) & (d[1:] <= 0))[0] + 1
    return np.nonzero((d[:-1] < 0) & (d[1:] >= 0))[0] + 1


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 50.0,
    f0_ceil: float = 500.0,
    frame_period: float = 5.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Estimate an F0 contour -> (f0, time_axis).

    Per log-spaced band: lowpass at the band's boundary frequency, then form
    four independent period estimates (rising/falling zero crossings,
    peak/dip intervals). A band's candidate is their mean; its reliability is
    their spread. Each frame takes the most reliable in-range candidate and
    is marked unvoiced when no band agrees with itself (spread > 15%).
    """
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    hop = frame_period / 1000.0
    n_frames = int(len(x) / fs / hop) + 1
    times = np.arange(n_frames) * hop

    n_bands = max(1, int(np.ceil(2 * np.log2(f0_ceil / f0_floor))))
    boundaries = f0_floor * 2.0 ** ((np.arange(n_bands) + 1) / 2.0)

    best_f0 = np.zeros(n_frames)
    best_score = np.full(n_frames, np.inf)
    for boundary in boundaries:
        y = _lowpass_fft(x, fs, boundary)
        if np.abs(y).max() < 1e-8:
            continue
        cands = np.stack(
            [
                _interval_f0(_crossings(y, True), fs, times),
                _interval_f0(_crossings(y, False), fs, times),
                _interval_f0(_extrema(y, True), fs, times),
                _interval_f0(_extrema(y, False), fs, times),
            ]
        )
        mean = cands.mean(axis=0)
        spread = cands.std(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(mean > 0, spread / np.maximum(mean, 1e-9), np.inf)
        ok = (
            (mean >= f0_floor)
            & (mean <= min(f0_ceil, boundary))
            & (cands.min(axis=0) > 0)
            & (score < best_score)
        )
        best_f0 = np.where(ok, mean, best_f0)
        best_score = np.where(ok, score, best_score)

    f0 = np.where(best_score < 0.15, best_f0, 0.0)

    # periodicity validation: lowpassed noise also yields self-consistent
    # crossing intervals, so confirm each candidate with the normalized
    # autocorrelation of the raw signal at the candidate lag (stands in for
    # DIO's FixF0Contour voicing steps).
    n = len(x)
    for i in np.nonzero(f0 > 0)[0]:
        lag = int(round(fs / f0[i]))
        c = int(round(times[i] * fs))
        half = int(1.25 * lag)
        lo, hi = max(c - half, 0), min(c + half + lag, n)
        seg = x[lo:hi]
        if len(seg) < 2 * lag:
            f0[i] = 0.0
            continue
        a, b = seg[:-lag], seg[lag:]
        denom = np.sqrt(np.dot(a, a) * np.dot(b, b))
        if denom < 1e-12 or np.dot(a, b) / denom < 0.45:
            f0[i] = 0.0

    # drop isolated voiced frames (a cheap stand-in for DIO's FixStep filters)
    voiced = f0 > 0
    if len(f0) > 2:
        isolated = np.zeros_like(voiced)
        isolated[1:-1] = voiced[1:-1] & ~voiced[:-2] & ~voiced[2:]
        # boundary frames are isolated only if their single neighbor is unvoiced
        isolated[0] = voiced[0] & ~voiced[1]
        isolated[-1] = voiced[-1] & ~voiced[-2]
        f0[isolated] = 0.0
    return f0, times


def stonemask(x: np.ndarray, fs: int, times: np.ndarray, f0: np.ndarray) -> np.ndarray:
    """Refine each voiced frame's F0 via normalized-autocorrelation peak
    interpolation with an octave-down guard.

    WORLD's StoneMask refines via instantaneous frequency
    (test_scripts/common/test_mcd.py:31 uses pyworld.stonemask); pyworld is not
    a dependency, so this is a from-scratch refinement with its
    accuracy CALIBRATED on synthetic corpora with known ground truth
    (tests/test_world.py::TestCalibration). The previous windowed-DFT
    magnitude grid was biased up to ~42 mean cents by dominant non-fundamental
    harmonics (spectral-leakage pull); autocorrelation peaks at the true
    period for ANY harmonic amplitude distribution, and a parabolic
    sub-sample step gives <0.01-cent error on steady tones.

    Per voiced frame: (1) octave-down guard — when the normalized autocorr at
    lag 2L is high (>0.9) and strictly better than at L, the dio candidate is
    an octave high (dominant-2nd-harmonic trap) and the doubled period wins;
    (2) local peak search over lag ±3 around the candidate; (3) parabolic
    interpolation to sub-sample lag. Refinements beyond ±12% of the candidate
    (or its half) are rejected, like WORLD's allowed_range.

    Measured accuracy (mean / p95 cents on voiced frames, 16 kHz, 1 s):
    steady 60-400 Hz: 0.00/0.01 · vibrato ±3% @5.5 Hz: 3.7/7.8 ·
    glide 120→240 Hz: 3.5/6.3 · dominant-2nd-harmonic trap: 0.0/0.01 ·
    breathy (harmonics + noise): 8.5/17.6 · white noise stays unvoiced.
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.asarray(f0, dtype=np.float64).copy()
    n = len(x)

    def ncor(c: int, lag: int, span: int) -> float:
        lo, hi = max(c - span // 2, 0), min(c + span // 2 + lag, n)
        seg = x[lo:hi]
        if len(seg) < lag + 8:
            return 0.0
        seg = seg - seg.mean()
        a, b = seg[: len(seg) - lag], seg[lag:]
        d = np.sqrt(np.dot(a, a) * np.dot(b, b))
        return float(np.dot(a, b) / d) if d > 1e-12 else 0.0

    for i in np.nonzero(out > 0)[0]:
        fc = out[i]
        c = int(round(times[i] * fs))
        lag = int(round(fs / fc))
        c2 = ncor(c, 2 * lag, 6 * lag)
        if fc / 2 >= 45.0 and c2 > 0.9 and c2 > ncor(c, lag, 6 * lag) + 0.02:
            lag *= 2
        span = 3 * lag
        lags = list(range(max(lag - 3, 2), lag + 4))
        peak = lags[int(np.argmax([ncor(c, l, span) for l in lags]))]
        a = ncor(c, peak - 1, span)
        b = ncor(c, peak, span)
        cv = ncor(c, peak + 1, span)
        den = a - 2 * b + cv
        shift = 0.5 * (a - cv) / den if abs(den) > 1e-12 else 0.0
        refined = fs / (peak + float(np.clip(shift, -0.5, 0.5)))
        if (abs(refined - fc) / fc < 0.12
                or abs(refined - fc / 2) / (fc / 2) < 0.12):
            out[i] = refined
    return out


# ---------------------------------------------------------------------------
# CheapTrick spectral envelope
# ---------------------------------------------------------------------------


def cheaptrick(
    x: np.ndarray,
    fs: int,
    times: np.ndarray,
    f0: np.ndarray,
    fft_size: int = 1024,
) -> np.ndarray:
    """Smoothed power spectrogram (n_frames, fft_size//2+1), WORLD CheapTrick.

    Fully vectorized over frames (batched FFTs, cumsum box filter, gathered
    DC mirror) — the reference reaches C through pyworld here, so a Python
    per-frame loop would be a slower stand-in. `_cheaptrick_frame_loop`
    below is the executable per-frame spec this is tested against.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    nf = len(times)
    if nf == 0:
        return np.empty((0, fft_size // 2 + 1))
    half_bins = fft_size // 2 + 1
    freq_res = fs / fft_size

    f0c = np.where(np.asarray(f0) > 0, f0, DEFAULT_F0)
    f0c = np.maximum(f0c, fs * 3.0 / (fft_size - 3))  # window must fit fft_size
    halves = np.round(1.5 * fs / f0c).astype(np.int64)  # (F,)
    maxh = int(halves.max())

    # pitch-adaptive Hann windows, center-aligned, zero outside each support;
    # the alignment shift is pure linear phase — |FFT|^2 is unaffected
    base = np.arange(-maxh, maxh + 1)[None, :]  # (1, W)
    centers = np.round(np.asarray(times) * fs).astype(np.int64)[:, None]
    support = np.abs(base) <= halves[:, None]
    safe = np.clip(centers + base, 0, n - 1)
    win = (0.5 + 0.5 * np.cos(np.pi * base / fs * f0c[:, None] / 1.5)) * support
    seg = x[safe] * win
    seg -= win * (seg.sum(1, keepdims=True)
                  / np.maximum(win.sum(1, keepdims=True), 1e-12))
    ps = np.abs(np.fft.rfft(seg, n=fft_size, axis=1)) ** 2

    # DC correction: mirror the spectrum below f0 (WORLD DCCorrection)
    b = (f0c / freq_res).astype(np.int64) + 1
    maxb = int(b.max())
    j = np.arange(maxb)[None, :]
    valid = (j < b[:, None]) & (2 * b[:, None] < half_bins)
    src = np.clip(2 * b[:, None] - j, 0, half_bins - 1)
    ps[:, :maxb] += np.take_along_axis(ps, src, axis=1) * valid

    # rectangular smoothing, per-frame width 2*f0/3, via reflect-padded cumsum
    w = np.maximum(1, np.round(2.0 * f0c / 3.0 / freq_res).astype(np.int64))[:, None]
    maxw = int(w.max())
    padded = np.pad(ps, ((0, 0), (maxw, maxw)), mode="reflect")
    cs = np.concatenate(
        [np.zeros((nf, 1)), np.cumsum(padded, axis=1)], axis=1)
    k = np.arange(half_bins)[None, :]
    lo = k - w // 2 + maxw
    hi = k + (w - 1) // 2 + maxw + 1
    ps_smooth = (np.take_along_axis(cs, hi, 1) - np.take_along_axis(cs, lo, 1)) / w

    # cepstral liftering (WORLD SmoothingWithRecovery): multiplying by
    # sinc(pi f0 tau) applies the final smoothing; the q1 lifter recovers
    # the envelope it attenuates.
    ps_smooth = ps_smooth + ps_smooth.max(1, keepdims=True) * 1e-12 + 1e-300
    log_full = np.log(np.concatenate([ps_smooth, ps_smooth[:, -2:0:-1]], axis=1))
    cep = np.fft.ifft(log_full, axis=1).real
    idx = np.arange(fft_size)
    quefrency = np.minimum(idx, fft_size - idx)[None, :] / fs
    arg = np.pi * f0c[:, None] * quefrency
    smoothing_lifter = np.where(arg > 1e-9, np.sin(arg) / np.maximum(arg, 1e-9), 1.0)
    compensation = (1.0 - 2.0 * Q1) + 2.0 * Q1 * np.cos(
        2 * np.pi * f0c[:, None] * quefrency)
    cep = cep * smoothing_lifter * compensation
    return np.exp(np.fft.fft(cep, axis=1).real[:, :half_bins])


def _cheaptrick_frame_loop(x, fs, times, f0, fft_size=1024):
    """Per-frame reference implementation of :func:`cheaptrick` (spec/test)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    half_bins = fft_size // 2 + 1
    freq_res = fs / fft_size
    out = np.empty((len(times), half_bins))
    idx = np.arange(fft_size)
    quefrency = np.minimum(idx, fft_size - idx) / fs

    for i, (t, cur) in enumerate(zip(times, f0)):
        cur = cur if cur > 0 else DEFAULT_F0
        cur = max(cur, fs * 3.0 / (fft_size - 3))
        half = int(round(1.5 * fs / cur))
        c = int(round(t * fs))
        base = np.arange(-half, half + 1)
        safe = np.clip(c + base, 0, n - 1)
        win = 0.5 + 0.5 * np.cos(np.pi * base / fs * cur / 1.5)
        seg = x[safe] * win
        seg -= win * (seg.sum() / max(win.sum(), 1e-12))
        ps = np.abs(np.fft.rfft(seg, n=fft_size)) ** 2
        boundary = int(cur / freq_res) + 1
        if 0 < boundary < half_bins - boundary:
            ps[:boundary] += ps[2 * boundary : boundary : -1][:boundary]
        width_bins = max(1, int(round(2.0 * cur / 3.0 / freq_res)))
        kernel = np.ones(width_bins) / width_bins
        padded = np.pad(ps, width_bins, mode="reflect")
        ps_smooth = np.convolve(padded, kernel, mode="same")[width_bins:-width_bins]
        ps_smooth = ps_smooth + ps_smooth.max() * 1e-12 + 1e-300
        log_full = np.log(np.concatenate([ps_smooth, ps_smooth[-2:0:-1]]))
        cep = np.fft.ifft(log_full).real
        arg = np.pi * cur * quefrency
        smoothing_lifter = np.where(arg > 1e-9, np.sin(arg) / np.maximum(arg, 1e-9), 1.0)
        compensation = (1.0 - 2.0 * Q1) + 2.0 * Q1 * np.cos(2 * np.pi * cur * quefrency)
        cep = cep * smoothing_lifter * compensation
        out[i] = np.exp(np.fft.fft(cep).real[:half_bins])
    return out


# ---------------------------------------------------------------------------
# SPTK mel-cepstra: freqt / sp2mc / mc2sp
# ---------------------------------------------------------------------------


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Frequency-transform cepstra by the all-pass warp (Oppenheim recursion).

    c: (..., L) cepstra -> (..., order+1) warped cepstra. Batched over
    leading dims; the k-recursion is a loop, vectorized over frames.
    """
    c = np.asarray(c, dtype=np.float64)
    squeeze = c.ndim == 1
    c = np.ascontiguousarray(np.atleast_2d(c))
    g = np.zeros((c.shape[0], order + 1), dtype=np.float64)
    beta = 1.0 - alpha * alpha
    for k in range(c.shape[1] - 1, -1, -1):
        d = g.copy()
        g[:, 0] = c[:, k] + alpha * d[:, 0]
        if order >= 1:
            g[:, 1] = beta * d[:, 0] + alpha * d[:, 1]
        for i in range(2, order + 1):
            g[:, i] = d[:, i - 1] + alpha * (d[:, i] - g[:, i - 1])
    return g[0] if squeeze else g


def sp2mc(sp: np.ndarray, order: int = 24, alpha: float = 0.42) -> np.ndarray:
    """Power spectrogram (n_frames, fft//2+1) -> mel-cepstra (n_frames, order+1).

    Mirrors pysptk.sp2mc to the letter: the FULL symmetric real cepstrum of
    log|X|^2 (np.fft.irfft output, length fft_size) with c[0] halved goes
    into freqt — the reference's MCD numbers depend on this exact convention.
    """
    sp = np.atleast_2d(sp)
    c = np.fft.irfft(np.log(sp + 1e-30), axis=1)
    c[:, 0] /= 2.0
    return freqt(c, order, alpha)


def mc2sp(mc: np.ndarray, alpha: float, fft_size: int) -> np.ndarray:
    """Inverse of sp2mc (pysptk.mc2sp): mel-cepstra -> power spectrum."""
    mc = np.atleast_2d(mc)
    c = freqt(mc, fft_size // 2, -alpha)
    c[:, 0] *= 2.0
    symc = np.concatenate([c, c[:, -2:0:-1]], axis=1)
    return np.exp(np.fft.rfft(symc, axis=1).real)


def world_analyze(
    signal: np.ndarray,
    sr: int = 16000,
    f0_floor: float = 50.0,
    f0_ceil: float = 500.0,
    fft_size: int = 1024,
    frame_period: float = 5.0,
    mcep_dim: int = 24,
    mcep_alpha: float = 0.42,
) -> tuple[np.ndarray, np.ndarray]:
    """(mcep (n_frames, mcep_dim+1), f0 (n_frames,)) — the reference's
    ``world_analyze`` contract (test_mcd.py:29-49)."""
    signal = np.asarray(signal, dtype=np.float64)
    f0, times = dio(signal, sr, f0_floor, f0_ceil, frame_period)
    f0 = stonemask(signal, sr, times, f0)
    sp = cheaptrick(signal, sr, times, f0, fft_size)
    mcep = sp2mc(sp, mcep_dim, mcep_alpha)
    return mcep, f0
