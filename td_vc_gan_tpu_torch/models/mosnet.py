"""MOSNet (CNN-BLSTM) predicted-MOS model and its weight loaders.

Counterpart of ``td_vc_gan_tpu/models/mosnet.py`` (MOSNet, Lo et al.,
Interspeech 2019) as an ``nn.Module`` in the NCHW layout:

- input: magnitude spectrogram (T, 257), 16 kHz, FFT 512, hop 256, Hann,
  centred by reflect padding (numpy, as the JAX package);
- 4 conv blocks, channels 16, 32, 64, 128: each is 3 x (3x3 conv, TF "SAME"
  padding, ReLU), the last one striding (1, 3) over frequency
  (257 -> 86 -> 29 -> 10 -> 4). SAME with stride 3 pads asymmetrically (0
  before and 1 after at 257 -> 86), so every conv pads explicitly, as TF
  does, and then runs unpadded;
- (B, 128, T, 4) -> (B, T, 4, 128) -> (B, T, 512), frequency-major as the
  JAX package's channels-last reshape -> BLSTM(128, concat) -> per-frame
  Dense(128, ReLU) -> Dense(1) frame scores -> mean over time.

The LSTM is ``nn.LSTM`` (cuDNN on the card). Its gates ``[i, f, g, o]`` are
Keras's ``[i, f, c, o]``; its weights are the Keras kernels transposed, with
``b_ih`` the Keras bias and ``b_hh`` zero. The recurrent activation is the
sigmoid, as in the JAX package.

The weights' interchange form is the JAX package's flat slot dict (Keras
order and layouts: conv kernels HWIO, LSTM kernels (in, 4u)): ``.npz``
files hold it, ``.h5`` files are read into it, and ``load_slots`` fills the
module from it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from td_vc_gan_tpu_torch import resolve_device

SR = 16000
FFT_SIZE = 512
HOP = 256
N_BINS = FFT_SIZE // 2 + 1  # 257
BLOCK_CHANNELS = (16, 32, 64, 128)
LSTM_UNITS = 128
DENSE_UNITS = 128


def spectrogram(wav: np.ndarray, sr: int = SR) -> np.ndarray:
    """Magnitude STFT (T, 257): periodic Hann, centre reflect padding
    (librosa.stft(n_fft=512, hop=256, win=512), as upstream MOSNet)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if sr != SR:
        from td_vc_gan_tpu_torch.data.audio_io import resample

        wav = resample(wav, sr, SR)
    pad = FFT_SIZE // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - FFT_SIZE) // HOP
    idx = np.arange(FFT_SIZE)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FFT_SIZE) / FFT_SIZE)
    mag = np.abs(np.fft.rfft(frames * win[None, :], axis=1))
    return mag.astype(np.float32)


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding of an axis of n: (before, after)."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class MOSNet(nn.Module):
    """mag (B, T, 257) -> (utterance scores (B,), frame scores (B, T))."""

    def __init__(self):
        super().__init__()
        cin = 1
        for i, ch in enumerate(BLOCK_CHANNELS):
            for j in range(3):
                setattr(self, f"conv{i}_{j}", nn.Conv2d(cin if j == 0 else ch, ch, 3,
                                                        stride=(1, 3) if j == 2 else 1))
            cin = ch
        self.lstm = nn.LSTM(4 * BLOCK_CHANNELS[-1], LSTM_UNITS, batch_first=True,
                            bidirectional=True)
        self.dense1 = nn.Linear(2 * LSTM_UNITS, DENSE_UNITS)
        self.frame = nn.Linear(DENSE_UNITS, 1)

    def forward(self, mag: torch.Tensor):
        x = mag[:, None]  # (B, 1, T, F)
        for i in range(len(BLOCK_CHANNELS)):
            for j in range(3):
                conv = getattr(self, f"conv{i}_{j}")
                t_pad = _same_pad(x.shape[2], 3, conv.stride[0])
                f_pad = _same_pad(x.shape[3], 3, conv.stride[1])
                x = torch.relu(conv(F.pad(x, (*f_pad, *t_pad))))
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        h, _ = self.lstm(x)
        frame = self.frame(torch.relu(self.dense1(h)))[..., 0]
        return frame.mean(dim=1), frame


def _param_slots() -> list[tuple[str, tuple]]:
    """(name, shape) in Keras model order: the weights' interchange form."""
    slots: list[tuple[str, tuple]] = []
    cin = 1
    for i, ch in enumerate(BLOCK_CHANNELS):
        for j in range(3):
            slots.append((f"conv{i}_{j}.kernel", (3, 3, cin if j == 0 else ch, ch)))
            slots.append((f"conv{i}_{j}.bias", (ch,)))
        cin = ch
    feat = 4 * BLOCK_CHANNELS[-1]
    for d in ("fwd", "bwd"):
        slots.append((f"lstm_{d}.kernel", (feat, 4 * LSTM_UNITS)))
        slots.append((f"lstm_{d}.recurrent", (LSTM_UNITS, 4 * LSTM_UNITS)))
        slots.append((f"lstm_{d}.bias", (4 * LSTM_UNITS,)))
    slots.append(("dense1.kernel", (2 * LSTM_UNITS, DENSE_UNITS)))
    slots.append(("dense1.bias", (DENSE_UNITS,)))
    slots.append(("frame.kernel", (DENSE_UNITS, 1)))
    slots.append(("frame.bias", (1,)))
    return slots


def init_mosnet_params(rng: np.random.Generator | int = 0) -> dict:
    """Random slot dict, drawn as the JAX package's ``init_mosnet_params``."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    params = {}
    for name, shape in _param_slots():
        if name.endswith(".bias"):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            params[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    return params


def load_slots(model: MOSNet, params) -> MOSNet:
    """Fill ``model`` from a slot dict (numpy arrays): conv kernels HWIO ->
    OIHW, Dense kernels transposed, each LSTM direction's Keras packing ->
    ``weight_ih`` = kernel.T, ``weight_hh`` = recurrent.T, ``bias_ih`` =
    bias, ``bias_hh`` = 0. Every slot must be there, at its shape."""
    slots = dict(_param_slots())
    missing = sorted(set(slots) - set(params))
    extra = sorted(set(params) - set(slots))
    if missing or extra:
        raise KeyError(f"MOSNet weights: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, shape in slots.items():
        if tuple(np.shape(params[name])) != shape:
            raise ValueError(f"MOSNet slot {name}: got {np.shape(params[name])}, "
                             f"expected {shape}")

    def t(name, perm=None):
        a = np.asarray(params[name], np.float32)
        return torch.from_numpy(np.ascontiguousarray(a.transpose(perm) if perm else a))

    with torch.no_grad():
        for i in range(len(BLOCK_CHANNELS)):
            for j in range(3):
                conv = getattr(model, f"conv{i}_{j}")
                conv.weight.copy_(t(f"conv{i}_{j}.kernel", (3, 2, 0, 1)))
                conv.bias.copy_(t(f"conv{i}_{j}.bias"))
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            getattr(model.lstm, f"weight_ih_l0{suffix}").copy_(t(f"lstm_{d}.kernel", (1, 0)))
            getattr(model.lstm, f"weight_hh_l0{suffix}").copy_(t(f"lstm_{d}.recurrent", (1, 0)))
            getattr(model.lstm, f"bias_ih_l0{suffix}").copy_(t(f"lstm_{d}.bias"))
            getattr(model.lstm, f"bias_hh_l0{suffix}").zero_()
        for name in ("dense1", "frame"):
            getattr(model, name).weight.copy_(t(f"{name}.kernel", (1, 0)))
            getattr(model, name).bias.copy_(t(f"{name}.bias"))
    return model


def _h5_weight_arrays(path: str) -> list[np.ndarray]:
    """All weight arrays of a Keras save_weights ``.h5``, in model order.

    Needs the ``layer_names``/``weight_names`` attributes the Keras HDF5
    format writes. There is no visit-order fallback: h5 visit order is
    alphabetical, and the fwd/bwd LSTM (and same-channel conv) weights share
    shapes, so a misordered file would pass the shape check and give a wrong
    predictor."""
    import h5py

    arrays: list[np.ndarray] = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = root.attrs.get("layer_names")
        if layer_names is None:
            raise ValueError(
                "MOSNet .h5 lacks the Keras 'layer_names' attribute; weight "
                "order would be ambiguous. Re-save with Keras save_weights "
                "or convert to .npz with the flat slot names of "
                "mosnet._param_slots().")
        for lname in layer_names:
            lname = lname.decode() if isinstance(lname, bytes) else lname
            g = root[lname]
            for wn in g.attrs.get("weight_names", []):
                wn = wn.decode() if isinstance(wn, bytes) else wn
                arrays.append(np.asarray(g[wn]))
    return arrays


def from_keras_h5(path: str) -> dict:
    """A Keras MOSNet ``.h5`` -> the slot dict, shape-checked."""
    arrays = [a for a in _h5_weight_arrays(path) if a.dtype.kind == "f"]
    slots = _param_slots()
    if len(arrays) != len(slots):
        raise ValueError(f"MOSNet h5 has {len(arrays)} float arrays, expected {len(slots)}")
    params = {}
    for (name, shape), arr in zip(slots, arrays):
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"MOSNet h5 slot {name}: got {arr.shape}, expected {shape}")
        params[name] = arr.astype(np.float32)
    return params


def load_mosnet(path: str) -> dict:
    """The slot dict of a ``.h5`` (Keras) or ``.npz`` (slot names) file."""
    if str(path).endswith(".npz"):
        data = np.load(path)
        return {k: np.asarray(data[k], np.float32) for k in data.files}
    return from_keras_h5(path)


class MOSPredictor:
    """Utterance MOS prediction at the exact frame count, unpadded, as
    upstream: padding would leak into the backward LSTM's state and the
    convs' SAME receptive field."""

    def __init__(self, params, device=None):
        self.device = resolve_device(device)
        self.model = load_slots(MOSNet(), params).to(self.device).eval()

    @torch.no_grad()
    def score(self, wav: np.ndarray, sr: int = SR) -> float:
        mag = torch.from_numpy(spectrogram(wav, sr)[None]).to(self.device)
        return float(self.model(mag)[0][0])
