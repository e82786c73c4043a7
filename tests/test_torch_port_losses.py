"""The port's losses, STFT and DSP helpers against the JAX package's.

Inputs are made with numpy from a seed. Random draws of the JAX functions
(the contrastive negatives, the jitter shifts) are taken from the JAX key
exactly as the JAX function draws them and injected into the port.
Tolerances: losses and spectra 1e-5 relative (f32, FFTs and sums in another
order; the spectra relative to their max); filterbanks, windows, Kaiser taps
and the shifts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.ops import dsp as jdsp
from td_vc_gan_tpu.ops import losses as jl
from td_vc_gan_tpu.ops import stft as js
from td_vc_gan_tpu_torch.ops import dsp, losses, stft

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)


def arrays(*shapes, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def t(a):
    return torch.from_numpy(np.array(a))


def close_to_max(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


# ---- STFT ----

@pytest.mark.parametrize("name", ["mel_filterbank", "mel_filterbank_slaney"])
def test_mel_filterbanks(name):
    np.testing.assert_array_equal(getattr(stft, name)(16000, 512, 80),
                                  getattr(js, name)(16000, 512, 80))
    np.testing.assert_array_equal(getattr(stft, name)(22050, 1024, 40, 30.0, 8000.0),
                                  getattr(js, name)(22050, 1024, 40, 30.0, 8000.0))


def test_hann_window_and_frames():
    np.testing.assert_array_equal(stft.hann_window(512), js.hann_window(512))
    (x,) = arrays((2, 1000), seed=1)
    for center in (True, False):
        np.testing.assert_array_equal(stft.frame_signal(t(x), 256, 64, center).numpy(),
                                      np.asarray(js.frame_signal(jnp.asarray(x), 256, 64, center)))


@pytest.mark.parametrize("fn,kw", [("stft_power", {}), ("stft_magnitude", {}),
                                   ("stft_magnitude", {"window": "rect"})])
def test_stft(fn, kw):
    (x,) = arrays((2, 3000), seed=2)
    close_to_max(getattr(stft, fn)(t(x), 512, 128, **kw).numpy(),
                 np.asarray(getattr(js, fn)(jnp.asarray(x), 512, 128, **kw)))


def test_melspectrogram():
    (x,) = arrays((2, 3000), seed=3)
    close_to_max(stft.melspectrogram(t(x), 16000, 512, 80).numpy(),
                 np.asarray(js.melspectrogram(jnp.asarray(x), 16000, 512, 80)))


# ---- losses ----

def test_lsgan_losses():
    real = arrays((2, 30, 1), (2, 15, 1), seed=5)
    fake = arrays((2, 30, 1), (2, 15, 1), seed=6)
    want_d = jl.lsgan_d_loss([jnp.asarray(a) for a in real], [jnp.asarray(a) for a in fake])
    got_d = losses.lsgan_d_loss([t(a) for a in real], [t(a) for a in fake])
    for g, w in zip(got_d[:2] + tuple(got_d[2]) + tuple(got_d[3]),
                    want_d[:2] + tuple(want_d[2]) + tuple(want_d[3])):
        np.testing.assert_allclose(float(g), float(w), **TOL)
    want_g, per_w = jl.lsgan_g_loss([jnp.asarray(a) for a in fake])
    got_g, per_g = losses.lsgan_g_loss([t(a) for a in fake])
    np.testing.assert_allclose(float(got_g), float(want_g), **TOL)
    np.testing.assert_allclose([float(v) for v in per_g], [float(v) for v in per_w], **TOL)


def test_spec_losses():
    x, y = arrays((2, 3000), (2, 3000), seed=7)
    np.testing.assert_allclose(
        float(losses.multiscale_spec_loss(t(x), t(y), (512, 256))),
        float(jl.multiscale_spec_loss(jnp.asarray(x), jnp.asarray(y), (512, 256))), **TOL)
    total, per = losses.multiscale_spec_loss_pwg(t(x), t(y), (512, 256), return_separated=True)
    wtotal, wper = jl.multiscale_spec_loss_pwg(jnp.asarray(x), jnp.asarray(y), (512, 256),
                                               return_separated=True)
    np.testing.assert_allclose(total.numpy(), np.asarray(wtotal), **TOL)
    for a, b in zip(per, wper):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_feat_and_wave_losses():
    sig = [arrays((2, 20, 4), (2, 5, 16), seed=8), arrays((2, 10, 4), seed=9)]
    ref = [arrays((2, 20, 4), (2, 5, 16), seed=10), arrays((2, 10, 4), seed=11)]
    np.testing.assert_allclose(
        float(losses.multiscale_feat_loss([[t(a) for a in s] for s in sig],
                                          [[t(a) for a in s] for s in ref])),
        float(jl.multiscale_feat_loss([[jnp.asarray(a) for a in s] for s in sig],
                                      [[jnp.asarray(a) for a in s] for s in ref])), **TOL)
    x, y = arrays((3, 100), (3, 100), seed=12)
    np.testing.assert_allclose(float(losses.wave_l1_loss(t(x), t(y))),
                               float(jl.wave_l1_loss(jnp.asarray(x), jnp.asarray(y))), **TOL)


def negative_draws(key, b, frames, n_neg=100):
    """The raw draws ``contrastive_loss`` makes from ``key`` (both directions)."""
    return tuple(np.asarray(jax.random.randint(k, (b, frames, n_neg), 0, frames - 1))
                 for k in jax.random.split(key))


def test_sample_negatives_with_injected_indices():
    (x,) = arrays((2, 9, 5), seed=13)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jl._sample_negatives(jnp.asarray(x), 7, key))
    idx = np.asarray(jax.random.randint(key, (2, 9, 7), 0, 8))
    got = losses._sample_negatives(t(x), 7, t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    own = np.arange(9)[None, :, None]
    assert not np.any(np.where(idx >= own, idx + 1, idx) == own)  # never the frame itself


def test_contrastive_loss_with_injected_negatives():
    x, y = arrays((3, 12, 8), (3, 12, 8), seed=14)
    key = jax.random.PRNGKey(4)
    want = float(jl.contrastive_loss(jnp.asarray(x), jnp.asarray(y), key, 100, 0.1))
    idx = negative_draws(key, 3, 12)
    got = float(losses.contrastive_loss(t(x), t(y), 100, 0.1, tuple(t(i) for i in idx)))
    np.testing.assert_allclose(got, want, **TOL)


def test_cross_entropy_loss():
    (logits,) = arrays((5, 7), seed=15, scale=2.0)
    labels = np.array([0, 6, 3, 3, 1], np.int32)
    np.testing.assert_allclose(
        float(losses.cross_entropy_loss(t(logits), t(labels))),
        float(jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))), **TOL)


# ---- DSP helpers ----

def test_kaiser_filter_fc():
    np.testing.assert_array_equal(dsp.kaiser_filter_fc(129, 0.5, 10.0),
                                  jdsp.kaiser_filter_fc(129, 0.5, 10.0))
    np.testing.assert_array_equal(dsp.kaiser_filter_fc(31, 0.25), jdsp.kaiser_filter_fc(31, 0.25))
    with pytest.raises(ValueError):
        dsp.kaiser_filter_fc(128, 0.5)


@pytest.mark.parametrize("shape,axis", [((3, 4, 360), 2), ((3, 700), 1), ((3, 600, 2), -2)])
def test_roll_batches(shape, axis):
    """Both of the JAX function's paths (one-hot matmul for n <= 512, scan
    over dynamic slices above), shifts negative, zero and past n."""
    (x,) = arrays(shape, seed=16)
    shifts = np.array([-5, 0, shape[axis] + 7], np.int32)
    want = np.asarray(jdsp.roll_batches(jnp.asarray(x), jnp.asarray(shifts), axis))
    np.testing.assert_array_equal(dsp.roll_batches(t(x), t(shifts), axis).numpy(), want)


def test_add_jitter_with_injected_shifts():
    (x,) = arrays((4, 900), seed=17)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jdsp.add_jitter(jnp.asarray(x), 40, key))
    shifts = np.asarray(jax.random.randint(key, (4,), -40, 41))
    np.testing.assert_array_equal(dsp.add_jitter(t(x), 40, t(shifts)).numpy(), want)
    drawn = dsp.add_jitter(t(x), 40, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x.shape
