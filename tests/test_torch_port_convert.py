"""The port's conversion path against the JAX package's Converter.

The small configuration of tests/test_inference.py; generator parameters
made with numpy from a seed in the flax tree's shapes, CREPE from the JAX
package's seeded init, both carried by ``weights.py``. The excitation's
random draws (start phase, noise) are taken from the JAX PRNG exactly as the
JAX Converter draws them and injected into the port. Tolerances: excitation
atol 1e-5 (f32 phase accumulated over 2560 samples in another order);
converted audio atol 1e-4, with the conv encoder and with the WavLM encoder
(the tiny backbone of tests/test_torch_port_wavlm.py).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.inference import Converter as JaxConverter
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models.generator import Generator as JaxGenerator
from td_vc_gan_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from td_vc_gan_tpu.ops import dsp as jdsp
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import Crepe
from td_vc_gan_tpu_torch.models.generator import Generator
from td_vc_gan_tpu_torch.models.wavlm import WavLMConfig
from td_vc_gan_tpu_torch.ops import dsp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RATIOS = (10, 4, 2, 2)
CHANNELS = (16, 16, 8, 8, 4)


def random_params(module, *args, seed=0):
    """A flax parameter tree for ``module`` filled from numpy: weight-norm
    gains in [0.5, 1.5], biases ~ 0.1 N(0, 1), other kernels ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "'g'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.1 if "bias" in name else 0.3
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_draws(seed: int, shape):
    """The start phase and noise the JAX Converter draws for ``seed``."""
    k_phase, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    start = float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi)
    return start, np.array(jax.random.normal(k_noise, shape))


@pytest.fixture(scope="module")
def converters():
    g = JaxGenerator(decoder_ratios=RATIOS, decoder_channels=CHANNELS,
                     num_bottleneck_layers=0, num_classes=4, conditional_dim=8,
                     content_dim=8, kernel_sizes=(3,), dilations=(1,))
    x = jnp.zeros((1, 1280, 1))
    params = random_params(g, x, jnp.zeros((1, 4)), None, x, seed=1)
    crepe_params = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    cfg = jcfg.Config()
    jconv = JaxConverter(cfg, g, params, crepe_params, decoder="viterbi")

    pcfg = Config()
    port_g = weights.generator_from_jax(
        Generator(RATIOS, CHANNELS, 4, 8, 8, kernel_sizes=(3,), dilations=(1,)), params)
    port_crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray,
                                                                             crepe_params))
    return jconv, Converter(pcfg, port_g, port_crepe, decoder="viterbi", device="cpu")


def _signals():
    t = np.arange(2560) / 16000
    return np.stack([0.3 * np.sin(2 * np.pi * (150 + 400 * t) * t),
                     0.2 * np.sin(2 * np.pi * 220 * t)]).astype(np.float32)


def test_f0_to_excitation_with_injected_draws():
    rng = np.random.default_rng(2)
    f0 = rng.uniform(80, 400, (2, 41)).astype(np.float32)
    f0[0, 5:12] = 0.0   # unvoiced span: noise only, nearest-frame edges
    f0[1, -3:] = 0.0
    want = np.asarray(jdsp.f0_to_excitation(jnp.asarray(f0), 64, jax.random.PRNGKey(3)))
    start, noise = jax_draws(3, want.shape)
    got = dsp.f0_to_excitation(torch.from_numpy(f0), 64, start_phase=start,
                               noise=torch.from_numpy(noise))
    assert got.shape == (2, 40 * 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_pitch_batch_matches(converters):
    jconv, conv = converters
    sigs = _signals()
    jf0, jmu = jconv.pitch_batch(sigs)
    f0, mu = conv.pitch_batch(sigs)
    assert f0.shape == (2, 41) and mu.shape == (2, 1)
    np.testing.assert_allclose(f0, jf0, rtol=1e-5)
    np.testing.assert_allclose(mu, jmu, rtol=1e-5, atol=1e-6)


def test_convert_batch_end_to_end(converters):
    jconv, conv = converters
    sigs = _signals()
    labels = np.array([2, 1], np.int32)
    f0, mu = jconv.pitch_batch(sigs)
    mu_tgt = mu + np.log(1.3).astype(np.float32)
    want = jconv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=7)
    start, noise = jax_draws(7, sigs.shape)
    got = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, start_phase=start, noise=noise)
    assert got.shape == sigs.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_seeded_draws_are_deterministic(converters):
    _, conv = converters
    sigs = _signals()
    f0, mu = conv.pitch_batch(sigs)
    a = conv.convert_batch(sigs, np.array([0, 3]), f0, mu, mu, seed=5)
    b = conv.convert_batch(sigs, np.array([0, 3]), f0, mu, mu, seed=5)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a).max() <= 1.0


def test_pad_to_bucket_and_convert_lengths(converters):
    _, conv = converters
    padded, n = conv.pad_to_bucket(np.zeros(1000, np.float32))
    assert n == 1000 and padded.shape == (1280,)
    sig = (0.2 * np.sin(2 * np.pi * 180 * np.arange(2000) / 16000)).astype(np.float32)
    assert conv.convert_with_ratio(sig, 0, 1.5).shape == (2000,)


def test_convert_long_overlap_add(converters):
    _, conv = converters
    sig = (0.2 * np.sin(2 * np.pi * 160 * np.arange(9000) / 16000)).astype(np.float32)
    out = conv.convert_long(sig, 1, mu_tgt=np.log(200.0), chunk=3840, overlap=1280)
    assert out.shape == sig.shape and np.isfinite(out).all()


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from td_vc_gan_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


ISOLATION = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["td_vc_gan_tpu"] = None
sys.modules["yaml"] = None  # the card's machine has no PyYAML
import td_vc_gan_tpu_torch
for m in pkgutil.walk_packages(td_vc_gan_tpu_torch.__path__, "td_vc_gan_tpu_torch."):
    importlib.import_module(m.name)
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import crepe_from_seed
from td_vc_gan_tpu_torch.models.generator import generator_from_config
cfg = Config()
g = cfg.model.generator
g.decoder_ratios, g.decoder_channels = [10, 4, 2, 2], [16, 16, 8, 8, 4]
g.content_dim = g.conditional_dim = 8
g.mrf_kernel_sizes, g.mrf_dilations = [3], [1]
conv = Converter(cfg, generator_from_config(g, 4, device="cpu"), crepe_from_seed(0),
                 device="cpu")
import tempfile
from pathlib import Path
from td_vc_gan_tpu_torch.config import load_config, parse_overrides
with tempfile.TemporaryDirectory() as d:
    cfg.save(Path(d) / "config.yaml")
    back = load_config(Path(d) / "config.yaml", parse_overrides(["train.num_epoch=2"]))
assert back.model.generator.decoder_ratios == [10, 4, 2, 2] and back.train.num_epoch == 2
import torch
from td_vc_gan_tpu_torch.models.wavlm import WavLMConfig
g.decoder_ratios, g.encoder_model, g.num_enc_layers = [10, 8, 2, 2], "wavlm", 2
tiny = WavLMConfig(encoder_layers=1, encoder_embed_dim=16, encoder_ffn_embed_dim=16,
                   encoder_attention_heads=2, conv_pos=4, conv_pos_groups=2,
                   conv_feature_layers=((8, 10, 5),) + ((8, 3, 2),) * 4 + ((8, 2, 2),) * 2)
wavlm_g = generator_from_config(g, 4, device="cpu", wavlm_cfg=tiny)
assert wavlm_g(torch.zeros(1, 640, 1), torch.eye(4)[:1])[0].shape == (1, 640, 1)
print("ok", conv.device)
"""


def test_port_imports_nothing_of_jax():
    proc = subprocess.run([sys.executable, "-c", ISOLATION], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok cpu"
    import re

    banned = re.compile(r"^\s*(import|from)\s+(jax|flax)\b|td_vc_gan_tpu\.", re.M)
    sources = sorted((REPO / "td_vc_gan_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        assert not banned.search(path.read_text()), path


@pytest.fixture(scope="module")
def full_mrf_converters():
    """The JAX Converter and the port's on the full MRF (kernels 3, 7, 11 x
    dilations 1, 3, 5) at narrow widths."""
    g = JaxGenerator(decoder_ratios=RATIOS, decoder_channels=CHANNELS,
                     num_bottleneck_layers=0, num_classes=4, conditional_dim=8,
                     content_dim=8)
    x = jnp.zeros((1, 1280, 1))
    params = random_params(g, x, jnp.zeros((1, 4)), None, x, seed=2)
    crepe_params = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    jconv = JaxConverter(jcfg.Config(), g, params, crepe_params, decoder="viterbi")
    port_g = weights.generator_from_jax(Generator(RATIOS, CHANNELS, 4, 8, 8), params)
    port_crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray,
                                                                             crepe_params))
    return jconv, Converter(Config(), port_g, port_crepe, decoder="viterbi", device="cpu")


def test_convert_short_utterance_with_full_mrf(full_mrf_converters):
    """1000 samples (padded to 1280): the encoder's last stage has 8 frames,
    under the widest MRF conv's reflect pad of 25, which the JAX layer pads
    by repeated reflection."""
    jconv, conv = full_mrf_converters
    sig = (0.2 * np.sin(2 * np.pi * 170 * np.arange(1000) / 16000)).astype(np.float32)
    f0, mu = jconv.pitch(sig)
    want = jconv.convert(sig, 3, f0, mu, mu + np.float32(0.1), seed=4)
    start, noise = jax_draws(4, (1, 1280))
    got = conv.convert(sig, 3, f0, mu, mu + np.float32(0.1), start_phase=start, noise=noise)
    assert got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_convert_with_ratio_with_injected_draws(full_mrf_converters):
    jconv, conv = full_mrf_converters
    sig = (0.2 * np.sin(2 * np.pi * 140 * np.arange(2300) / 16000)).astype(np.float32)
    want = jconv.convert_with_ratio(sig, 1, 1.25, seed=6)
    start, noise = jax_draws(6, (1, 2560))
    got = conv.convert_with_ratio(sig, 1, 1.25, start_phase=start, noise=noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_convert_long_matches_jax(full_mrf_converters):
    """Three overlapping chunks; chunk i takes the draws JAX makes from
    seed + i."""
    jconv, conv = full_mrf_converters
    t = np.arange(5000) / 16000
    sig = (0.2 * np.sin(2 * np.pi * (130 + 60 * t) * t)).astype(np.float32)
    want = jconv.convert_long(sig, 2, mu_tgt=np.log(190.0), chunk=2560, overlap=640, seed=9)
    draws = [jax_draws(9 + i, (1, 2560)) for i in range(3)]
    got = conv.convert_long(sig, 2, mu_tgt=np.log(190.0), chunk=2560, overlap=640,
                            draws=draws)
    assert got.shape == sig.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


WAVLM = dict(
    extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=32,
    encoder_ffn_embed_dim=64, encoder_attention_heads=4, layer_norm_first=True,
    conv_feature_layers=((16, 10, 5),) + ((16, 3, 2),) * 4 + ((16, 2, 2),) * 2,
    conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=80,
)


@pytest.fixture(scope="module")
def wavlm_converters():
    """The JAX Converter and the port's with the WavLM-encoder generator
    (ratios 10, 8, 2, 2: WavLM's 320) at narrow widths."""
    ratios = (10, 8, 2, 2)
    kw = dict(kernel_sizes=(3,), dilations=(1,))
    g = JaxGenerator(decoder_ratios=ratios, decoder_channels=CHANNELS,
                     num_bottleneck_layers=0, num_classes=4, conditional_dim=8,
                     content_dim=8, encoder_model="wavlm", num_enc_layers=2,
                     wavlm_cfg=JaxWavLMConfig(**WAVLM), **kw)
    x = jnp.zeros((1, 1280, 1))
    params = random_params(g, x, jnp.zeros((1, 4)), None, x, seed=3)
    crepe_params = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    jconv = JaxConverter(jcfg.Config(), g, params, crepe_params, decoder="viterbi")
    port_g = weights.generator_from_jax(
        Generator(ratios, CHANNELS, 4, 8, 8, encoder_model="wavlm", num_enc_layers=2,
                  wavlm_cfg=WavLMConfig(**WAVLM), **kw), params)
    port_crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray,
                                                                             crepe_params))
    return jconv, Converter(Config(), port_g, port_crepe, decoder="viterbi", device="cpu")


def test_wavlm_convert_batch(wavlm_converters):
    jconv, conv = wavlm_converters
    sigs = _signals()
    labels = np.array([3, 0], np.int32)
    f0, mu = jconv.pitch_batch(sigs)
    mu_tgt = mu + np.log(0.8).astype(np.float32)
    want = jconv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=8)
    start, noise = jax_draws(8, sigs.shape)
    got = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, start_phase=start, noise=noise)
    assert got.shape == sigs.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_wavlm_convert_long(wavlm_converters):
    """Three chunks of 2560 samples (8 WavLM frames each), cross-faded."""
    jconv, conv = wavlm_converters
    t = np.arange(5000) / 16000
    sig = (0.2 * np.sin(2 * np.pi * (150 + 50 * t) * t)).astype(np.float32)
    want = jconv.convert_long(sig, 1, mu_tgt=np.log(170.0), chunk=2560, overlap=640, seed=2)
    draws = [jax_draws(2 + i, (1, 2560)) for i in range(3)]
    got = conv.convert_long(sig, 1, mu_tgt=np.log(170.0), chunk=2560, overlap=640,
                            draws=draws)
    assert got.shape == sig.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
