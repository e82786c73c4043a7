"""Batch conversion: CREPE pitch, log-F0 mean shift, excitation, generator.

Counterpart of ``td_vc_gan_tpu/inference.py``. Utterances are padded to
multiples of the decoder's x320 ratio; :meth:`Converter.convert_batch` runs
the shift -> excitation -> generator chain as one call on the device
(:meth:`Converter.convert_tensors`). This is the conversion path that the
JAX package measured as "conversion RTF".
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.models import crepe as crepe_mod
from td_vc_gan_tpu_torch.models.layers import compute_dtype_scope
from td_vc_gan_tpu_torch.ops import dsp


class Converter:
    """Holds a generator and a CREPE net on one device (default: the CUDA
    card; ``device="cpu"`` runs on the CPU). ``compute_dtype`` is G's
    compute scope: None takes ``cfg.train.compute_dtype``, ``"float32"``
    forces f32. Pitch runs outside the scope, in f32."""

    def __init__(self, cfg, G, crepe, bucket_multiple: int = 320,
                 decoder: str = "viterbi", device=None, compute_dtype: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.G = G.to(self.device).eval()
        self.crepe = crepe.to(self.device).eval()
        self.bucket = bucket_multiple
        self.decoder = decoder
        self.num_classes = G.num_classes
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else cfg.train.compute_dtype)
        # (G, CREPE) on each device of convert_long_sharded, made once
        self._replicas = {next(self.G.parameters()).device: (self.G, self.crepe)}

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
                        seed: int = 0, start_phase=None, noise=None, G=None) -> torch.Tensor:
        """One call on the device: shift the voiced F0 to the target's
        log-mean, synthesise the excitation, run G (default: this
        Converter's; a replica of it on the inputs' device). (B, T) -> (B, T).

        ``start_phase`` (a scalar, or (B, 1) for a phase per row) and
        ``noise`` inject the excitation's random draws; otherwise they come
        from a ``torch.Generator`` seeded with ``seed``.
        """
        f0_conv = torch.where(
            f0_src > 0, torch.exp(torch.log(f0_src + 1e-6) + mu_tgt - mu_src), 0.0)
        gen = None
        if start_phase is None or noise is None:
            gen = torch.Generator(device=signals.device).manual_seed(seed)
        exc = dsp.f0_to_excitation(f0_conv, 64, self.cfg.model.sample_rate,
                                   start_phase=start_phase, noise=noise, generator=gen)
        onehot = torch.nn.functional.one_hot(labels_tgt.to(torch.int64),
                                             self.num_classes).to(torch.float32)
        with compute_dtype_scope(self.compute_dtype):
            wav, _, _ = (G or self.G)(signals[..., None], onehot, exc[..., None])
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

        starts = range(0, max(len(signal) - overlap, 1), hop)
        ys = []
        for n_chunks, start in enumerate(starts):
            seg = signal[start:start + chunk]
            if len(seg) < chunk:
                seg = np.pad(seg, (0, chunk - len(seg)))
            f0, _ = self.pitch(seg)
            ys.append(self.convert(seg, label_tgt, f0, mu_src, mu_t, seed + n_chunks,
                                   *chunk_draws(n_chunks)))
        return _overlap_add(ys, starts, len(signal), overlap)

    def _replica(self, device) -> tuple:
        """(G, CREPE) on ``device``: this Converter's own on its device, else a
        copy made at the first call and kept."""
        device = torch.device(device)
        if device not in self._replicas:
            self._replicas[device] = (copy.deepcopy(self.G).to(device),
                                      copy.deepcopy(self.crepe).to(device))
        return self._replicas[device]

    def convert_long_sharded(self, signal: np.ndarray, label_tgt: int,
                             mu_tgt: np.ndarray | float, devices, chunk: int = 71680,
                             overlap: int = 12800, seed: int = 0, draws=None) -> np.ndarray:
        """Device-parallel unbounded-length conversion, the counterpart of the
        JAX package's: every overlap-add chunk of the utterance is stacked
        into one (n_pad, chunk) batch, its count padded to a multiple of
        ``len(devices)``, and shard k of n_pad / len(devices) chunks runs on
        ``devices[k]`` with that device's replica of G and CREPE: pitch, then
        one convert call per shard; the overlap-add is on the host. The
        source pitch statistic is the voiced-weighted mean over the real
        chunks (not :meth:`convert_long`'s disjoint re-segmentation).

        Chunk i draws its excitation from ``seed + i`` (as
        :meth:`convert_long` does), or takes ``draws[i]``, a (start_phase,
        noise (1, chunk)) pair, so that the output does not depend on the
        number of devices. Inputs no longer than one chunk go to
        :meth:`convert_long`.
        """
        chunk = -(-chunk // self.bucket) * self.bucket  # a multiple of the model's stride
        if len(signal) <= chunk:
            return self.convert_long(signal, label_tgt, mu_tgt, chunk, overlap, seed, draws)
        hop = chunk - overlap
        starts = list(range(0, max(len(signal) - overlap, 1), hop))
        n = len(starts)
        devices = [torch.device(d) for d in devices]
        n_pad = -(-n // len(devices)) * len(devices)
        per = n_pad // len(devices)
        segs = np.zeros((n_pad, chunk), dtype=np.float32)
        for i, start in enumerate(starts):
            seg = signal[start:start + chunk]
            segs[i, :len(seg)] = seg

        shards = []
        for k, dev in enumerate(devices):
            G, crepe = self._replica(dev)
            x = torch.tensor(segs[k * per:(k + 1) * per], device=dev)
            with torch.inference_mode():
                f0, _ = crepe_mod.filtered_pitch(crepe, x, self.decoder)
            shards.append((dev, G, x, f0))
        f0_all = np.concatenate([f0.cpu().numpy() for *_, f0 in shards])
        mu = crepe_mod.log_f0_mean(torch.from_numpy(f0_all)).numpy()
        voiced = (f0_all[:n] > 0).sum(axis=1)
        mu_src = float((mu[:n, 0] * voiced).sum() / max(voiced.sum(), 1))
        mu_t = float(mu_tgt) if np.isscalar(mu_tgt) else float(np.asarray(mu_tgt).reshape(()))

        ys = []
        for k, (dev, G, x, f0) in enumerate(shards):
            starts_k, noise_k = [], []
            for i in range(k * per, (k + 1) * per):
                if draws is not None and i < len(draws):
                    start, noise = draws[i]
                    start = torch.tensor(float(start), device=dev)
                    noise = torch.tensor(np.asarray(noise, np.float32), device=dev)
                else:
                    gen = torch.Generator(device=dev).manual_seed(seed + i)
                    start = torch.rand((), generator=gen, device=dev) * 2.0 * math.pi
                    noise = torch.randn((1, chunk), generator=gen, device=dev)
                starts_k.append(start)
                noise_k.append(noise.reshape(1, chunk))
            ys.append(self.convert_tensors(
                x, f0, torch.full((per, 1), mu_src, device=dev),
                torch.full((per, 1), mu_t, device=dev),
                torch.full((per,), label_tgt, dtype=torch.int64, device=dev),
                start_phase=torch.stack(starts_k)[:, None], noise=torch.cat(noise_k), G=G))
        return _overlap_add(np.concatenate([y.cpu().numpy() for y in ys]), starts,
                            len(signal), overlap)


def _overlap_add(ys, starts, n: int, overlap: int) -> np.ndarray:
    """The n samples of chunks ``ys[i]`` (each of one length) placed at
    ``starts[i]`` and cross-faded over ``overlap`` samples with a raised
    cosine."""
    out = np.zeros(n, dtype=np.float32)
    weight = np.zeros(n, dtype=np.float32)
    fade = 0.5 - 0.5 * np.cos(np.pi * np.arange(overlap) / overlap)
    for y, start in zip(ys, starts):
        chunk = len(y)
        w = np.ones(chunk, dtype=np.float32)
        if start > 0:
            w[:overlap] = fade
        if start + chunk < n:
            w[-overlap:] = fade[::-1]
        end = min(start + chunk, n)
        out[start:end] += (y * w)[:end - start]
        weight[start:end] += w[:end - start]
    return out / np.maximum(weight, 1e-6)
