"""Batch conversion: CREPE pitch, log-F0 mean shift, excitation, generator.

Counterpart of ``td_vc_gan_tpu/inference.py``. Utterances are padded to
multiples of the decoder's x320 ratio; :meth:`Converter.convert_batch` runs
the shift -> excitation -> generator chain as one call on the device
(:meth:`Converter.convert_tensors`). This is the conversion path that the
JAX package measured as "conversion RTF".
"""

from __future__ import annotations

import numpy as np
import torch

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.models import crepe as crepe_mod
from td_vc_gan_tpu_torch.ops import dsp


class Converter:
    """Holds a generator and a CREPE net on one device (default: the CUDA
    card; ``device="cpu"`` runs on the CPU)."""

    def __init__(self, cfg, G, crepe, bucket_multiple: int = 320,
                 decoder: str = "viterbi", device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.G = G.to(self.device).eval()
        self.crepe = crepe.to(self.device).eval()
        self.bucket = bucket_multiple
        self.decoder = decoder
        self.num_classes = G.num_classes

    def pad_to_bucket(self, signal: np.ndarray) -> tuple[np.ndarray, int]:
        n = signal.shape[-1]
        m = -(-n // self.bucket) * self.bucket
        return np.pad(signal, (0, m - n)), n

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.inference_mode()
    def pitch_tensors(self, signals: torch.Tensor):
        """(B, T) on the device -> (f0 (B, F), voiced log-F0 mean (B, 1))."""
        f0, _ = crepe_mod.filtered_pitch(self.crepe, signals, self.decoder)
        return f0, crepe_mod.log_f0_mean(f0)

    @torch.inference_mode()
    def convert_tensors(self, signals, f0_src, mu_src, mu_tgt, labels_tgt,
                        seed: int = 0, start_phase=None, noise=None) -> torch.Tensor:
        """One call on the device: shift the voiced F0 to the target's
        log-mean, synthesise the excitation, run G. (B, T) -> (B, T).

        ``start_phase`` and ``noise`` inject the excitation's random draws;
        otherwise they come from a ``torch.Generator`` seeded with ``seed``.
        """
        f0_conv = torch.where(
            f0_src > 0, torch.exp(torch.log(f0_src + 1e-6) + mu_tgt - mu_src), 0.0)
        gen = None
        if start_phase is None or noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        exc = dsp.f0_to_excitation(f0_conv, 64, self.cfg.model.sample_rate,
                                   start_phase=start_phase, noise=noise, generator=gen)
        onehot = torch.nn.functional.one_hot(labels_tgt.to(torch.int64),
                                             self.num_classes).to(torch.float32)
        wav, _, _ = self.G(signals[..., None], onehot, exc[..., None])
        return wav[..., 0]

    def pitch(self, signal: np.ndarray):
        """signal (T,) -> (f0 (1, F), mu (1, 1)) numpy, with padding applied."""
        padded, _ = self.pad_to_bucket(signal)
        return self.pitch_batch(padded[None])

    def pitch_batch(self, signals: np.ndarray):
        f0, mu = self.pitch_tensors(self._tensor(signals))
        return f0.cpu().numpy(), mu.cpu().numpy()

    def convert(self, signal: np.ndarray, label_tgt: int, f0_src: np.ndarray,
                mu_src: np.ndarray, mu_tgt: np.ndarray, seed: int = 0,
                start_phase=None, noise=None) -> np.ndarray:
        """Convert one utterance to the target speaker with pitch matching;
        ``start_phase`` and ``noise`` ((1, padded length)) may inject the
        excitation draws."""
        padded, n = self.pad_to_bucket(signal)
        wav = self.convert_batch(padded[None], np.asarray([label_tgt]), f0_src,
                                 mu_src, mu_tgt, seed, start_phase, noise)
        return wav[0, :n]

    def convert_batch(self, signals: np.ndarray, labels_tgt: np.ndarray,
                      f0_src: np.ndarray, mu_src: np.ndarray, mu_tgt: np.ndarray,
                      seed: int = 0, start_phase=None, noise=None) -> np.ndarray:
        """Convert a whole (B, T) batch in one device call; ``start_phase``
        (scalar) and ``noise`` ((B, T)) may inject the excitation draws."""
        wav = self.convert_tensors(
            self._tensor(signals), self._tensor(f0_src), self._tensor(mu_src),
            self._tensor(mu_tgt), self._tensor(labels_tgt, torch.int64), seed,
            None if start_phase is None else self._tensor(start_phase),
            None if noise is None else self._tensor(noise))
        return wav.cpu().numpy()

    def convert_with_ratio(self, signal: np.ndarray, label_tgt: int,
                           f0_ratio: float = 1.0, seed: int = 0, start_phase=None,
                           noise=None) -> np.ndarray:
        """Convert with an explicit pitch ratio instead of a target utterance;
        the draws as :meth:`convert`."""
        f0, mu = self.pitch(signal)
        shift = np.log(np.asarray(f0_ratio, dtype=np.float32))
        return self.convert(signal, label_tgt, f0, mu, mu + shift, seed, start_phase, noise)

    def convert_long(self, signal: np.ndarray, label_tgt: int, mu_tgt: np.ndarray | float,
                     chunk: int = 71680, overlap: int = 12800, seed: int = 0,
                     draws=None) -> np.ndarray:
        """Unbounded-length conversion: fixed-size chunks cross-faded over
        ``overlap`` samples with a raised cosine; the source pitch statistic
        is averaged over disjoint chunks of the whole utterance. Chunk i
        draws its excitation from ``seed + i``, or takes ``draws[i]``, a
        (start_phase, noise (1, chunk)) pair, when ``draws`` is given."""
        def chunk_draws(i):
            return draws[i] if draws is not None else (None, None)

        if len(signal) <= chunk:
            f0, mu = self.pitch(signal)
            mu_t = np.full_like(mu, float(mu_tgt)) if np.isscalar(mu_tgt) else mu_tgt
            return self.convert(signal, label_tgt, f0, mu, mu_t, seed, *chunk_draws(0))

        hop = chunk - overlap
        mus = []
        for start in range(0, len(signal), chunk):
            seg = signal[start:start + chunk]
            if len(seg) < self.bucket:
                break
            _, mu = self.pitch(seg)
            mus.append(mu)
        mu_src = np.mean(mus, axis=0)
        mu_t = np.full_like(mu_src, float(mu_tgt)) if np.isscalar(mu_tgt) else mu_tgt

        out = np.zeros(len(signal), dtype=np.float32)
        weight = np.zeros(len(signal), dtype=np.float32)
        fade = 0.5 - 0.5 * np.cos(np.pi * np.arange(overlap) / overlap)
        for n_chunks, start in enumerate(range(0, max(len(signal) - overlap, 1), hop)):
            seg = signal[start:start + chunk]
            if len(seg) < chunk:
                seg = np.pad(seg, (0, chunk - len(seg)))
            f0, _ = self.pitch(seg)
            y = self.convert(seg, label_tgt, f0, mu_src, mu_t, seed + n_chunks,
                             *chunk_draws(n_chunks))
            w = np.ones(chunk, dtype=np.float32)
            if start > 0:
                w[:overlap] = fade
            if start + chunk < len(signal):
                w[-overlap:] = fade[::-1]
            end = min(start + chunk, len(signal))
            out[start:end] += (y * w)[:end - start]
            weight[start:end] += w[:end - start]
        return out / np.maximum(weight, 1e-6)
