"""CREPE pitch tracker ('tiny') and its decoders, in PyTorch.

Counterpart of ``td_vc_gan_tpu/models/crepe.py``: 1024-sample frames at hop
64, per-frame normalisation (unbiased std, 1e-10 floor), six blocks of conv ->
relu -> eval-mode batch norm -> 2x max-pool, a sigmoid 360-bin head (20 cents
a bin from 1997.38 cents), and argmax / weighted-argmax / Viterbi decoding
with periodicity gating. Parameter names follow the flax module
(``conv{i}_kernel``, ``bn{i}.scale`` ...); conv kernels are stored
``(out, in, k)`` and the classifier ``(360, 256)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch.models.layers import conv1d, get_compute_dtype

PITCH_BINS = 360
WINDOW_SIZE = 1024
HOP = 64
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
FMIN = 50.0
FMAX = 550.0
PERIODICITY_THRESHOLD = 0.21

_CAPACITY = {"tiny": 4, "full": 32}
_BASE_CHANNELS = (32, 4, 4, 4, 8, 16)
_KERNELS = (512, 64, 64, 64, 64, 64)
_STRIDES = (4, 1, 1, 1, 1, 1)
_PADS = ((254, 256), (31, 32), (31, 32), (31, 32), (31, 32), (31, 32))


def cents_to_frequency(cents):
    return 10.0 * 2.0 ** (cents / 1200.0)


def bins_to_cents(bins):
    return CENTS_PER_BIN * bins + CENTS_OFFSET


def bins_to_frequency(bins):
    return cents_to_frequency(bins_to_cents(bins))


def frequency_to_bins(freq: torch.Tensor) -> torch.Tensor:
    cents = 1200.0 * torch.log2(freq / 10.0)
    return torch.floor((cents - CENTS_OFFSET) / CENTS_PER_BIN).to(torch.int32)


def get_shift(pitch_source: torch.Tensor, pitch_target: torch.Tensor) -> torch.Tensor:
    """Bin shift between two pitches, for rolling activation maps."""
    return frequency_to_bins(pitch_target) - frequency_to_bins(pitch_source)


def log_f0_mean(f0: torch.Tensor) -> torch.Tensor:
    """Mean log-F0 over the voiced frames (f0 > 0): (B, F) -> (B, 1)."""
    voiced = (f0 > 0).to(f0.dtype)
    return torch.sum(voiced * torch.log(f0 + 1e-6), -1, keepdim=True) / (
        torch.sum(voiced, -1, keepdim=True) + 1e-6)


class EvalBatchNorm(nn.Module):
    """Inference batch norm folded to one multiply-add (eps 1e-5), in the
    input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale * torch.rsqrt(self.var + 1e-5)
        return x * s.to(x.dtype)[:, None] + (self.bias - self.mean * s).to(x.dtype)[:, None]


class Crepe(nn.Module):
    """(N, 1024) normalised frames -> (N, 360) sigmoid activations, f32.
    Inside a compute scope (the train step's) the convs and the classifier
    take bf16 inputs and weights, as the JAX package's CREPE; conversion
    calls it outside any scope, in f32."""

    def __init__(self, model: str = "tiny"):
        super().__init__()
        cap = _CAPACITY[model]
        cin = 1
        for i, (base, k) in enumerate(zip(_BASE_CHANNELS, _KERNELS)):
            ch = base * cap
            self.register_parameter(f"conv{i}_kernel", nn.Parameter(torch.empty(ch, cin, k)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(torch.zeros(ch)))
            self.add_module(f"bn{i}", EvalBatchNorm(ch))
            cin = ch
        self.classifier_kernel = nn.Parameter(torch.empty(PITCH_BINS, 4 * cin))
        self.classifier_bias = nn.Parameter(torch.zeros(PITCH_BINS))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """He-normal kernels (truncated at 2 std, as flax's he_normal), zero
        biases, identity batch norm."""
        for name, p in self.named_parameters():
            if name.endswith("kernel"):
                fan_in = p[0].numel()
                std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                with torch.no_grad():
                    z = torch.randn(p.shape, generator=gen)
                    while (bad := z.abs() > 2).any():
                        z[bad] = torch.randn(int(bad.sum()), generator=gen)
                    p.copy_(z * std)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        dt = get_compute_dtype() or frames.dtype
        x = frames[:, None, :].to(dt)
        for i, (s, pad) in enumerate(zip(_STRIDES, _PADS)):
            x = F.pad(x, pad)
            x = conv1d(x, getattr(self, f"conv{i}_kernel").to(dt),
                       getattr(self, f"conv{i}_bias").to(dt), stride=s)
            x = getattr(self, f"bn{i}")(F.relu(x))
            x = F.max_pool1d(x, 2)
        # flatten time-major, as the flax (N, T, C) reshape does
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(F.linear(x, self.classifier_kernel.to(dt)).float()
                             + self.classifier_bias)


def crepe_from_seed(seed: int, model: str = "tiny") -> Crepe:
    """A randomly initialised CREPE on the CPU (no checkpoint ships here)."""
    net = Crepe(model)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net


def preprocess(signal: torch.Tensor, hop_length: int = HOP) -> torch.Tensor:
    """(B, T) waveform -> (B, T//hop + 1, 1024) frames, centre-padded by 512,
    mean-removed and divided by the unbiased std floored at 1e-10."""
    x = F.pad(signal, (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    frames = x.unfold(-1, WINDOW_SIZE, hop_length)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    std = torch.std(frames, dim=-1, keepdim=True)
    return frames / torch.clamp_min(std, 1e-10)


def _mask_range(act: torch.Tensor, fmin: float = FMIN, fmax: float = FMAX) -> torch.Tensor:
    lo = int(np.floor((1200 * np.log2(fmin / 10) - CENTS_OFFSET) / CENTS_PER_BIN))
    hi = int(np.ceil((1200 * np.log2(fmax / 10) - CENTS_OFFSET) / CENTS_PER_BIN))
    bins = torch.arange(PITCH_BINS, device=act.device)
    return torch.where((bins >= lo) & (bins < hi), act, -torch.inf)


def decode_argmax(act: torch.Tensor):
    """act (B, F, 360) -> (bins, frequency)."""
    bins = torch.argmax(act, dim=-1)
    return bins, bins_to_frequency(bins.to(torch.float32))


def decode_weighted_argmax(act: torch.Tensor, window: int = 4):
    """Cents averaged over the argmax bin's neighbourhood, weighted by the
    activations."""
    bins = torch.argmax(act, dim=-1)
    offs = torch.arange(-window, window + 1, device=act.device)
    idx = torch.clamp(bins[..., None] + offs, 0, PITCH_BINS - 1)
    w = torch.gather(act, -1, idx)
    w = torch.where(torch.isfinite(w), torch.clamp_min(w, 0.0), 0.0)
    cents = bins_to_cents(idx.to(torch.float32))
    avg = torch.sum(w * cents, -1) / torch.clamp_min(torch.sum(w, -1), 1e-12)
    return bins, cents_to_frequency(avg)


@functools.lru_cache(maxsize=None)
def _viterbi_log_transition() -> np.ndarray:
    """Band-limited transition matrix max(12-|i-j|, 0), row-normalised, log."""
    xx, yy = np.meshgrid(np.arange(PITCH_BINS), np.arange(PITCH_BINS))
    t = np.maximum(12 - np.abs(xx - yy), 0).astype(np.float64)
    t = t / t.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        return np.log(t).astype(np.float32)


def decode_viterbi(act: torch.Tensor):
    """Viterbi decoding over log-softmaxed activations with the banded
    transition prior, frame for frame as the JAX package's scan (ties go to
    the first index; see the note on the path's alignment below)."""
    log_obs = torch.log_softmax(act, dim=-1)
    log_trans = torch.from_numpy(_viterbi_log_transition()).to(act.device)  # (from, to)
    delta = -math.log(PITCH_BINS) + log_obs[:, 0]
    backptrs = []
    for t in range(1, log_obs.shape[1]):
        scores = delta[:, :, None] + log_trans[None]
        best, ptr = torch.max(scores, dim=1)
        backptrs.append(ptr)
        delta = best + log_obs[:, t]
    state = torch.argmax(delta, dim=-1)
    path = [state]
    for ptr in reversed(backptrs[1:]):
        state = torch.gather(ptr, 1, state[:, None])[:, 0]
        path.append(state)
    # The JAX package's backtracking scan emits the state *before* each
    # pointer lookup, so its frame t holds the best state of frame t+1 and
    # the last frame repeats: kept as is, the reference being the contract.
    bins = torch.stack(path[::-1] + [path[0]] if backptrs else path, dim=1)
    return bins, bins_to_frequency(bins.to(torch.float32))


_DECODERS = {
    "argmax": decode_argmax,
    "weighted_argmax": decode_weighted_argmax,
    "viterbi": decode_viterbi,
}


def postprocess(act: torch.Tensor, decoder: str = "argmax"):
    """Masked decode -> (pitch, periodicity at the decoded bin)."""
    bins, pitch = _DECODERS[decoder](_mask_range(act))
    periodicity = torch.gather(act, -1, bins[..., None])[..., 0]
    return pitch, periodicity


def filtered_pitch(net: Crepe, signal: torch.Tensor, decoder: str = "argmax"):
    """(B, T) -> (pitch (B, F), activations (B, F, 360)), F = T//64 + 1;
    pitch is zeroed where the periodicity is below 0.21."""
    b = signal.shape[0]
    frames = preprocess(signal)
    act = net(frames.reshape(-1, WINDOW_SIZE)).reshape(b, -1, PITCH_BINS)
    pitch, periodicity = postprocess(act.detach(), decoder)
    return torch.where(periodicity < PERIODICITY_THRESHOLD, 0.0, pitch), act
