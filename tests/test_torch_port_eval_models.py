"""The port's evaluation models against the JAX package's, on the CPU, with
seeded weights and inputs: ECAPA-TDNN (``models/ecapa.py``), MOSNet
(``models/mosnet.py``) and YIN (``ops/yin.py``).

Tolerances: ECAPA's embeddings and logits within 1e-4 of max|ref| (the
forward at a small width set by the knobs of ``_torch_key_shapes``; sums in
another order); MOSNet's spectrogram equal (the same numpy), its frame and
utterance scores within 1e-5 of max|ref| at the published width; YIN's F0
equal where the hard search picks a lag, within 1e-5 relative for the soft
search.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_mosnet import _write_keras_h5

from td_vc_gan_tpu.models import ecapa as jecapa
from td_vc_gan_tpu.models import mosnet as jmosnet
from td_vc_gan_tpu.ops import stft as jstft
from td_vc_gan_tpu.ops import yin as jyin
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models import ecapa, mosnet
from td_vc_gan_tpu_torch.ops import stft
from td_vc_gan_tpu_torch.ops import yin

torch.set_num_threads(1)

SR = 16000
ECAPA_RTOL = 1e-4
MOS_RTOL = 1e-5
YIN_SOFT_RTOL = 1e-5
# a small ECAPA: 80 fbanks in (the embedder's features), Res2Net scale 8
CFG = dict(input_size=80, channels=(16, 16, 16, 16, 48), kernels=(5, 3, 3, 3, 1),
           attention_channels=8, lin_neurons=12, scale=8, se_channels=8)


def voice(f0, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = sum((0.2 + np.exp(-0.5 * ((h * f0 - 700) / 400) ** 2)) * np.sin(2 * np.pi * h * f0 * t)
            for h in range(1, 8))
    return (0.1 * x + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.fixture(scope="module")
def ecapa_sd():
    """A small ECAPA's speechbrain-layout state dict with nontrivial BN
    statistics and biases, and an AAM weight of 5 classes."""
    rng = np.random.default_rng(1)
    sd = jecapa.init_ecapa_params(3, **CFG)
    for k in sd:
        if k.endswith("running_mean") or k.endswith(".bias"):
            sd[k] = (0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
        if k.endswith("running_var"):
            sd[k] = (0.5 + rng.random(sd[k].shape)).astype(np.float32)
    return sd, rng.standard_normal((5, CFG["lin_neurons"])).astype(np.float32)


def port_ecapa(sd, w):
    return ecapa.from_torch_state_dict(ecapa.ECAPA(**CFG), sd, {"weight": w})


def test_mel_filterbank_matches_jax():
    for n_fft, n_mels in ((400, 80), (1024, 40)):
        np.testing.assert_allclose(stft.mel_filterbank(SR, n_fft, n_mels),
                                   np.asarray(jstft.mel_filterbank(SR, n_fft, n_mels)),
                                   rtol=1e-6, atol=1e-9)


def test_ecapa_forward_and_classify(ecapa_sd):
    sd, w = ecapa_sd
    feats = np.random.default_rng(2).standard_normal((2, 57, 80)).astype(np.float32)
    params = jecapa.from_torch_state_dict(sd, **CFG)
    params["classifier.weight"] = jnp.asarray(w)
    want = np.asarray(jecapa.ecapa_forward(params, feats))
    model = port_ecapa(sd, w)
    with torch.no_grad():
        got = model(torch.from_numpy(feats.transpose(0, 2, 1).copy()))
        logits = model.classify(got).numpy()
    close(got.numpy(), want, ECAPA_RTOL)
    close(logits, np.asarray(jecapa.classify(params, jnp.asarray(want))), ECAPA_RTOL)
    assert not np.allclose(want[0], want[1])


def test_ecapa_embed_path_from_speechbrain_files(ecapa_sd, tmp_path):
    """fbank, the sentence mean, the repeat-pad to 200 frames (1.3 s: 128
    frames) and a whole bucket (2.01 s: 200 frames), from .ckpt files the
    test writes; and the same embedder filled by ``ecapa_from_jax``."""
    sd, w = ecapa_sd
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "emb.ckpt")
    torch.save({"weight": torch.from_numpy(w)}, tmp_path / "cls.ckpt")
    port = ecapa.EcapaEmbedder.from_speechbrain(str(tmp_path / "emb.ckpt"),
                                                str(tmp_path / "cls.ckpt"), device="cpu", **CFG)
    params = jecapa.from_torch_state_dict(sd, **CFG)
    ref = jecapa.EcapaEmbedder(params)
    from_jax = ecapa.EcapaEmbedder(weights.ecapa_from_jax(
        ecapa.ECAPA(**CFG), {k: np.asarray(v) for k, v in params.items()}), device="cpu")
    for seconds, seed in ((1.3, 0), (2.01, 1)):
        wav = voice(120 + 60 * seed, seconds, seed)
        feats = port.features(wav)
        assert feats.shape == (200, 80)
        np.testing.assert_allclose(ecapa.fbank(wav), jecapa.fbank(wav), rtol=1e-5, atol=1e-4)
        want = ref.embed(wav)
        close(port.embed(wav), want, ECAPA_RTOL)
        close(from_jax.embed(wav), want, ECAPA_RTOL)
    assert port.model.classifier_weight.shape == (5, CFG["lin_neurons"])


def test_ecapa_loader_rejects_wrong_size_and_layout(ecapa_sd, tmp_path):
    sd, _ = ecapa_sd
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "small.ckpt")
    with pytest.raises((KeyError, ValueError)):  # a small checkpoint at the published width
        ecapa.EcapaEmbedder.from_speechbrain(str(tmp_path / "small.ckpt"), device="cpu")
    torch.save({"not_a_real_key": torch.zeros(3)}, tmp_path / "bad.ckpt")
    with pytest.raises(KeyError):
        ecapa.EcapaEmbedder.from_speechbrain(str(tmp_path / "bad.ckpt"), device="cpu")
    wrong = {k: torch.from_numpy(v) for k, v in sd.items()}
    wrong["fc.conv.weight"] = wrong["fc.conv.weight"][:, :, 0]  # (out, in): not torch's conv
    torch.save(wrong, tmp_path / "wrong.ckpt")
    with pytest.raises(ValueError, match="fc.conv.weight"):
        ecapa.EcapaEmbedder.from_speechbrain(str(tmp_path / "wrong.ckpt"), device="cpu", **CFG)


def test_ecapa_published_width():
    """The published ECAPA's state dict: speechbrain's keys and shapes, and
    20,805,952 tensor elements with the BN statistics."""
    shapes = ecapa._torch_key_shapes()
    assert shapes == jecapa._torch_key_shapes()
    assert sum(int(np.prod(s)) for s in shapes.values()) == 20_805_952
    model = ecapa.ECAPA()
    assert sum(t.numel() for t in model.state_dict().values()) == 20_805_952
    assert model.fc.conv.out_channels == 192


@pytest.fixture(scope="module")
def mos_params():
    rng = np.random.default_rng(6)
    p = jmosnet.init_mosnet_params(5)
    for k in p:
        if k.endswith(".bias"):
            p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def test_mosnet_forward_and_score(mos_params):
    wav = voice(130.0, 0.5, 3)
    mag = mosnet.spectrogram(wav)
    np.testing.assert_array_equal(mag, jmosnet.spectrogram(wav))
    assert mag.shape == (32, 257)
    want_avg, want_frames = jmosnet.mosnet_forward(mos_params, jnp.asarray(mag[None]))
    model = weights.mosnet_from_jax(mosnet.MOSNet(), mos_params)
    with torch.no_grad():
        avg, frames = model(torch.from_numpy(mag[None]))
    close(frames.numpy(), want_frames, MOS_RTOL)
    close(avg.numpy(), want_avg, MOS_RTOL)
    n = sum(int(np.prod(s)) for _, s in mosnet._param_slots())
    assert n == 1_178_721
    assert sum(p.numel() for p in model.parameters()) == n + 2 * 4 * mosnet.LSTM_UNITS  # b_hh
    noise = 0.1 * np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    port, ref = mosnet.MOSPredictor(mos_params, "cpu"), jmosnet.MOSPredictor(mos_params)
    for x, sr in ((wav, SR), (noise, SR), (voice(150.0, 0.6, 4), 22050)):
        want = ref.score(x, sr)
        assert abs(port.score(x, sr) - want) <= MOS_RTOL * max(abs(want), 1e-3)


def test_mosnet_npz_and_h5_loaders(mos_params, tmp_path):
    pytest.importorskip("h5py")
    np.savez(tmp_path / "w.npz", **mos_params)
    _write_keras_h5(tmp_path / "w.h5", mos_params)
    for name in ("w.npz", "w.h5"):
        got, want = mosnet.load_mosnet(str(tmp_path / name)), jmosnet.load_mosnet(
            str(tmp_path / name))
        assert list(got) == list(want) if name.endswith("h5") else set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    import h5py

    with h5py.File(tmp_path / "bare.h5", "w") as f:
        for i, (name, _) in enumerate(mosnet._param_slots()):
            f.create_dataset(f"w{i:02d}_{name.replace('.', '_')}", data=mos_params[name])
    for mod in (mosnet, jmosnet):
        with pytest.raises(ValueError, match="layer_names"):
            mod.load_mosnet(str(tmp_path / "bare.h5"))
    bad = dict(mos_params)
    bad["frame.bias"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="frame.bias"):
        mosnet.load_slots(mosnet.MOSNet(), bad)
    with pytest.raises(KeyError):
        mosnet.load_slots(mosnet.MOSNet(), {k: v for k, v in mos_params.items()
                                            if k != "lstm_bwd.bias"})


def yin_both(sig, **kw):
    want = np.asarray(jyin.estimate(jnp.asarray(sig), SR, **kw))
    got = yin.estimate(torch.from_numpy(sig), SR, **kw).numpy()
    return got, want


@pytest.mark.parametrize("f", [110.0, 220.0, 330.0])
def test_yin_hard_on_sines(f):
    """tests/test_dsp.py's settings: half a second, 60-500 Hz, a 64-sample
    stride; and a batch of two with leading axes."""
    t = np.arange(SR // 2) / SR
    sig = np.sin(2 * np.pi * f * t).astype(np.float32)[None]
    got, want = yin_both(sig, pitch_min=60, pitch_max=500, frame_stride=64 / SR)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.8 and abs(np.median(got[got > 0]) - f) < 0.03 * f
    batch = np.stack([sig, 0.5 * sig])[:, None]  # (2, 1, 1, T)
    got, want = yin_both(batch, pitch_min=60, pitch_max=500, frame_stride=64 / SR)
    assert got.shape == want.shape == (2, 1, 1, got.shape[-1])
    np.testing.assert_array_equal(got, want)


def test_yin_hard_on_noise():
    sig = np.random.default_rng(1234).standard_normal((1, 8000)).astype(np.float32)
    got, want = yin_both(sig, pitch_min=60, pitch_max=500, frame_stride=0.004)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() > 0.5


def test_yin_soft_and_its_gradient():
    t = np.arange(4000) / SR
    sig = np.stack([np.sin(2 * np.pi * 200 * t), 0.3 * np.sin(2 * np.pi * 90 * t)]).astype(
        np.float32)
    got, want = yin_both(sig, pitch_min=60, pitch_max=500, soft=True)
    close(got, want, YIN_SOFT_RTOL)
    x = torch.from_numpy(sig[:1]).requires_grad_()
    yin.estimate(x, SR, pitch_min=60, pitch_max=500, soft=True).mean().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
