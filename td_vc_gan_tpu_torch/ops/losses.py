"""The VC-GAN's losses.

Counterparts of ``td_vc_gan_tpu/ops/losses.py``: LSGAN adversarial losses,
the log-mel and Parallel-WaveGAN spectral losses, discriminator feature
matching, waveform L1, the bidirectional InfoNCE content loss and cross
entropy. Waveforms are ``(B, T)``; embeddings ``(B, T, C)`` channels-last, as
in the JAX package. The JAX package draws the contrastive negatives from a
JAX key; here their indices are injected (``idx``) or drawn from a
``torch.Generator``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from td_vc_gan_tpu_torch.ops.stft import melspectrogram, stft_magnitude


def lsgan_d_loss(real_logits: Sequence[torch.Tensor], fake_logits: Sequence[torch.Tensor]):
    """Per-scale LSGAN D losses, real -> 1 and fake -> 0: (real total, fake
    total, per-scale real, per-scale fake)."""
    reals = [torch.mean((r - 1.0) ** 2) for r in real_logits]
    fakes = [torch.mean(f ** 2) for f in fake_logits]
    return sum(reals), sum(fakes), reals, fakes


def lsgan_g_loss(fake_logits: Sequence[torch.Tensor]):
    """Per-scale LSGAN G loss, fake -> 1: (total, per-scale)."""
    per_scale = [torch.mean((f - 1.0) ** 2) for f in fake_logits]
    return sum(per_scale), per_scale


def multiscale_spec_loss(signal: torch.Tensor, ref: torch.Tensor,
                         fft_sizes: Sequence[int] = (2048,), sr: int = 16000,
                         n_mels: int = 80) -> torch.Tensor:
    """Log-mel L1 summed over FFT sizes (80 mels, hop fft//4, clamp 1e-5),
    against the detached reference."""
    total = 0.0
    ref = ref.detach()
    for n_fft in fft_sizes:
        s = torch.log(torch.clamp_min(melspectrogram(signal, sr, n_fft, n_mels), 1e-5))
        r = torch.log(torch.clamp_min(melspectrogram(ref, sr, n_fft, n_mels), 1e-5))
        total = total + torch.mean(torch.abs(s - r))
    return total


def multiscale_spec_loss_pwg(signal: torch.Tensor, ref: torch.Tensor,
                             fft_sizes: Sequence[int], return_separated: bool = False):
    """The Parallel-WaveGAN-style linear-STFT loss as the JAX package builds
    it (rectangular window; per size mean((|S| - |R|)^2) / mean(|S|^2) plus
    mean|log|S| - log|R|| / (frames * bins)), per batch row, summed over
    sizes."""
    per_size = []
    for n_fft in fft_sizes:
        s = stft_magnitude(signal, n_fft, n_fft // 4, window="rect")
        r = stft_magnitude(ref, n_fft, n_fft // 4, window="rect").detach()
        lin = torch.mean((s - r) ** 2, dim=(-1, -2)) / torch.mean(s ** 2, dim=(-1, -2))
        log = torch.mean(torch.abs(torch.log(s) - torch.log(r)), dim=(-1, -2)) / (
            s.shape[-1] * s.shape[-2])
        per_size.append(lin + log)
    total = sum(per_size)
    return (total, per_size) if return_separated else total


def multiscale_feat_loss(feat_sig, feat_ref) -> torch.Tensor:
    """Discriminator feature matching: per scale, the sum over layers of the
    mean L1 against the detached reference features, summed over scales."""
    total = 0.0
    for maps_sig, maps_ref in zip(feat_sig, feat_ref):
        for m_sig, m_ref in zip(maps_sig, maps_ref):
            total = total + torch.mean(torch.abs(m_sig - m_ref.detach()))
    return total


def wave_l1_loss(signal: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(ref - signal))


def _sample_negatives(x: torch.Tensor, n_neg: int, idx: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-frame negatives from the same utterance, never the frame itself:
    x (B, T, C) -> detached (B, T, N, C). ``idx`` (B, T, N) are draws from
    [0, T-1), shifted past the frame's own index as the JAX package does."""
    b, t, c = x.shape
    if idx is None:
        idx = torch.randint(0, t - 1, (b, t, n_neg), generator=generator, device=x.device)
    idx = idx.to(x.device, torch.int64)
    self_idx = torch.arange(t, device=x.device)[None, :, None]
    idx = torch.where(idx >= self_idx, idx + 1, idx)
    negs = torch.gather(x.detach(), 1, idx.reshape(b, t * n_neg, 1).expand(b, t * n_neg, c))
    return negs.reshape(b, t, n_neg, c)


def _cosine_logits(x, y, negs, temp: float) -> torch.Tensor:
    """x, y (B, T, C), negs (B, T, N, C) -> (B, T, N+1) cosine logits over
    temp, the positive first (torch's 1e-8 floor on the norm product)."""
    targets = torch.cat([y[:, :, None, :], negs], dim=2)
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    tn = torch.linalg.vector_norm(targets, dim=-1)
    dots = torch.einsum("btc,btnc->btn", x, targets)
    return dots / torch.clamp_min(xn * tn, 1e-8) / temp


def contrastive_loss(sig_x: torch.Tensor, sig_y: torch.Tensor, num_negatives: int = 100,
                     temp: float = 0.1, idx: tuple | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Bidirectional InfoNCE over time frames of two (B, T, C) embeddings;
    ``idx`` = (idx_x, idx_y) injects both directions' negative draws."""
    idx_x, idx_y = idx if idx is not None else (None, None)
    negs_x = _sample_negatives(sig_x, num_negatives, idx_x, generator)
    negs_y = _sample_negatives(sig_y, num_negatives, idx_y, generator)
    logits = torch.cat([_cosine_logits(sig_x, sig_y, negs_x, temp),
                        _cosine_logits(sig_y, sig_x, negs_y, temp)], dim=0)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[..., 0])


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(log_probs, -1, labels.to(torch.int64)[:, None]))
