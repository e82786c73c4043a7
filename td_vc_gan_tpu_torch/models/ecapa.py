"""ECAPA-TDNN speaker embedder and its speechbrain checkpoint loader.

Counterpart of ``td_vc_gan_tpu/models/ecapa.py``: the speechbrain ECAPA-TDNN
of the reference's speaker-verification harness (input 80 fbanks, channels
1024,1024,1024,1024,3072, kernels 5,3,3,3,1, dilations 1,2,3,4,1, Res2Net
scale 8, SE 128, attention 128, 192-d embeddings) in inference mode, as an
``nn.Module`` in the channels-first layout, (B, C, T):

- TDNN block = reflect-"same" dilated conv -> ReLU -> BatchNorm with running
  statistics (eps 1e-5);
- SE-Res2Net block = 1x1 TDNN -> Res2Net (chunk 0 passes through, chunk i > 1
  adds the previous chunk's output before its TDNN) -> 1x1 TDNN -> SE, + res;
- the three SE blocks' outputs concatenated -> 1x1 TDNN -> attentive
  statistics pooling (global context; statistics clipped at 1e-12 before the
  sqrt, softmax over time) -> BN -> 1x1 conv to 192.

The modules are named so that the state dict's keys are speechbrain's
(``blocks.0.conv.conv.weight``, ...) and its layouts torch's, so a
speechbrain ``embedding_model.ckpt`` loads with no transpose.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch import resolve_device
from td_vc_gan_tpu_torch.ops.dsp import reflect_pad
from td_vc_gan_tpu_torch.ops.stft import mel_filterbank

CHANNELS = (1024, 1024, 1024, 1024, 3072)
KERNELS = (5, 3, 3, 3, 1)
DILATIONS = (1, 2, 3, 4, 1)
ATTENTION_CHANNELS = 128
LIN_NEURONS = 192
RES2NET_SCALE = 8
SE_CHANNELS = 128
BN_EPS = 1e-5


class _Conv(nn.Module):
    """speechbrain's Conv1d: a reflect-"same" dilated conv (``.conv``)."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.conv.dilation[0] * (self.conv.kernel_size[0] - 1) // 2
        return self.conv(reflect_pad(x, pad, pad) if pad else x)


class _BatchNorm(nn.Module):
    """Inference BatchNorm over channels: weight, bias and running
    statistics, as speechbrain's ``BatchNorm1d.norm`` stores them."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


class _BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = _BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class _TDNN(nn.Module):
    """conv -> ReLU -> BN."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.conv = _Conv(cin, cout, k, dilation)
        self.norm = _BN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.relu(self.conv(x)))


class _Res2Net(nn.Module):
    def __init__(self, c: int, k: int, dilation: int, scale: int):
        super().__init__()
        self.scale = scale
        self.blocks = nn.ModuleList(
            _TDNN(c // scale, c // scale, k, dilation) for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=1)
        ys, y = [chunks[0]], None
        for i, block in enumerate(self.blocks, 1):
            y = block(chunks[i] if i == 1 else chunks[i] + y)
            ys.append(y)
        return torch.cat(ys, dim=1)


class _SE(nn.Module):
    def __init__(self, c: int, se: int):
        super().__init__()
        self.conv1 = _Conv(c, se, 1)
        self.conv2 = _Conv(se, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.conv1(x.mean(dim=2, keepdim=True)))
        return torch.sigmoid(self.conv2(s)) * x


class _SERes2Net(nn.Module):
    def __init__(self, cin: int, c: int, k: int, dilation: int, scale: int, se: int):
        super().__init__()
        self.tdnn1 = _TDNN(cin, c, 1)
        self.res2net_block = _Res2Net(c, k, dilation, scale)
        self.tdnn2 = _TDNN(c, c, 1)
        self.se_block = _SE(c, se)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(y) + x


class _ASP(nn.Module):
    """Attentive statistics pooling with global context: (B, C, T) -> (B, 2C)."""

    def __init__(self, c: int, attention: int):
        super().__init__()
        self.tdnn = _TDNN(3 * c, attention, 1)
        self.conv = _Conv(attention, c, 1)

    def forward(self, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp((x ** 2).mean(dim=2, keepdim=True) - mean ** 2, min=eps))
        attn = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        attn = torch.softmax(self.conv(torch.tanh(self.tdnn(attn))), dim=2)
        mean_w = torch.sum(attn * x, dim=2)
        std_w = torch.sqrt(torch.clamp(torch.sum(attn * x ** 2, dim=2) - mean_w ** 2, min=eps))
        return torch.cat([mean_w, std_w], dim=1)


class ECAPA(nn.Module):
    """feats (B, n_mels, T) -> unnormalized embeddings (B, lin_neurons);
    ``classify`` gives the cosine logits against the AAM class weights when
    a classifier was loaded."""

    def __init__(self, input_size=80, channels=CHANNELS, kernels=KERNELS,
                 dilations=DILATIONS, attention_channels=ATTENTION_CHANNELS,
                 lin_neurons=LIN_NEURONS, scale=RES2NET_SCALE, se_channels=SE_CHANNELS):
        super().__init__()
        self.blocks = nn.ModuleList([_TDNN(input_size, channels[0], kernels[0], dilations[0])])
        for i in range(1, len(channels) - 1):
            self.blocks.append(_SERes2Net(channels[i - 1], channels[i], kernels[i],
                                          dilations[i], scale, se_channels))
        self.mfa = _TDNN(channels[-2] * (len(channels) - 2), channels[-1], kernels[-1],
                         dilations[-1])
        self.asp = _ASP(channels[-1], attention_channels)
        self.asp_bn = _BN(channels[-1] * 2)
        self.fc = _Conv(channels[-1] * 2, lin_neurons, 1)
        # the AAM class weights (n_classes, lin_neurons) of classifier.ckpt
        self.register_buffer("classifier_weight", None, persistent=False)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.blocks[0](feats)
        taps = []
        for block in self.blocks[1:]:
            x = block(x)
            taps.append(x)
        x = self.asp(self.mfa(torch.cat(taps, dim=1)))
        return self.fc(self.asp_bn(x[:, :, None]))[:, :, 0]

    def classify(self, emb: torch.Tensor) -> torch.Tensor:
        """Cosine-similarity logits (speechbrain ``Classifier.forward``)."""
        if self.classifier_weight is None:
            raise RuntimeError("no classifier loaded (pass classifier.ckpt)")
        w = self.classifier_weight
        e = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-12)
        wn = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-12)
        return e @ wn.T


def _torch_key_shapes(input_size=80, channels=CHANNELS, kernels=KERNELS,
                      attention_channels=ATTENTION_CHANNELS,
                      lin_neurons=LIN_NEURONS, scale=RES2NET_SCALE,
                      se_channels=SE_CHANNELS) -> dict:
    """speechbrain embedding-model state-dict layout: key -> torch shape."""
    with torch.device("meta"):
        model = ECAPA(input_size, channels, kernels, DILATIONS, attention_channels,
                      lin_neurons, scale, se_channels)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def from_torch_state_dict(model: ECAPA, state_dict, classifier_state_dict=None) -> ECAPA:
    """Fill ``model`` from a speechbrain ``embedding_model.ckpt`` state dict
    (and the AAM weight of ``classifier.ckpt``). Keys outside the model are
    ignored (``num_batches_tracked``); a missing key or a wrong shape raises."""
    targets = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for key, t in targets.items():
            if key not in state_dict:
                raise KeyError(f"ECAPA checkpoint missing '{key}'")
            src = torch.from_numpy(np.array(state_dict[key], dtype=np.float32))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"'{key}': expected {tuple(t.shape)}, got {tuple(src.shape)}")
            t.copy_(src)
        if classifier_state_dict is not None:
            w = classifier_state_dict.get("weight")
            if w is None:  # speechbrain saves the AAM weight as 'weight'
                raise KeyError("classifier checkpoint missing 'weight'")
            model.classifier_weight = torch.as_tensor(np.asarray(w, dtype=np.float32)).to(
                model.fc.conv.weight.device)
    return model


def init_ecapa_params(rng: np.random.Generator | int = 0, **kwargs) -> dict:
    """Random torch-layout state dict (for tests and weightless smoke runs),
    drawn as the JAX package's ``init_ecapa_params``."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    sd = {}
    for key, shape in _torch_key_shapes(**kwargs).items():
        if key.endswith("running_var"):
            sd[key] = np.ones(shape, np.float32)
        elif key.endswith("running_mean") or key.endswith(".bias"):
            sd[key] = np.zeros(shape, np.float32)
        elif key.endswith("norm.weight") and len(shape) == 1:
            sd[key] = np.ones(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            sd[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    return sd


def fbank(wav: np.ndarray, sr: int = 16000, n_mels: int = 80,
          n_fft: int = 400, hop: int = 160) -> np.ndarray:
    """80-dim log-mel features (T, n_mels), speechbrain Fbank conventions
    (25 ms Hamming window, 10 ms hop, power spectrum, HTK mel scale, 10*log10
    with amin), in numpy as in the JAX package."""
    wav = np.asarray(wav, dtype=np.float32)
    n = max(0, (len(wav) - n_fft) // hop + 1)
    if n == 0:
        wav = np.pad(wav, (0, n_fft - len(wav)))
        n = 1
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = wav[idx] * np.hamming(n_fft).astype(np.float32)
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    mel = power @ mel_filterbank(sr, n_fft, n_mels)
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)


class EcapaEmbedder:
    """wav -> 192-d speaker embedding, one utterance per call, with the
    per-sentence feature mean subtracted (speechbrain InputNormalization
    norm_type=sentence, std_norm=False) and the features repeat-padded to a
    multiple of 200 frames, as the JAX package's embedder."""

    BUCKET = 200

    def __init__(self, model: ECAPA, sr: int = 16000, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.sr = sr

    @classmethod
    def from_speechbrain(cls, checkpoint: str, classifier: str | None = None,
                         sr: int = 16000, device=None, **cfg) -> EcapaEmbedder:
        """From speechbrain's ``embedding_model.ckpt`` (and ``classifier.ckpt``);
        ``cfg`` are ``ECAPA``'s width knobs (the published ones by default)."""
        dev = resolve_device(device)
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        csd = torch.load(classifier, map_location="cpu", weights_only=True) if classifier \
            else None
        return cls(from_torch_state_dict(ECAPA(**cfg), sd, csd), sr, dev)

    def features(self, wav: np.ndarray) -> np.ndarray:
        """(T', n_mels) mean-normalized, repeat-padded features."""
        feats = fbank(wav, self.sr)
        feats = feats - feats.mean(axis=0, keepdims=True)
        n = feats.shape[0]
        padded = -(-n // self.BUCKET) * self.BUCKET
        if padded != n:  # repeat-pad so statistics pooling sees real frames
            feats = np.tile(feats, (-(-padded // n), 1))[:padded]
        return feats

    @torch.no_grad()
    def embed(self, wav: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(self.features(wav).T[None])).to(self.device)
        return self.model(x)[0].cpu().numpy()
