"""The port's conversion path against the JAX package's Converter.

The small configuration of tests/test_inference.py; generator parameters
made with numpy from a seed in the flax tree's shapes, CREPE from the JAX
package's seeded init, both carried by ``weights.py``. The excitation's
random draws (start phase, noise) are taken from the JAX PRNG exactly as the
JAX Converter draws them and injected into the port. Tolerances: excitation
atol 1e-5 (f32 phase accumulated over 2560 samples in another order);
converted audio atol 1e-4.
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
from td_vc_gan_tpu.ops import dsp as jdsp
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models.crepe import Crepe
from td_vc_gan_tpu_torch.models.generator import Generator
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
