"""The port's generator modules against the JAX package's, at small width.

Parameters are made with numpy from a seed in the flax tree's shapes and
carried into the port by ``weights.generator_from_jax``; inputs and the
excitation come from the same seed. Tolerance: atol = 1e-4, rtol = 1e-4
(f32 on both sides; the decoder stacks ~20 convs, so rounding from sums in
another order compounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.models import generator as jg
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.config import GeneratorConfig, load_config
from td_vc_gan_tpu_torch.models import generator as tg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
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


def ncw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def nwc(t):
    return t.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("r", [2, 10])
def test_excite_downsample_block(r):
    x = np.random.default_rng(1).standard_normal((2, 40 * r, 8)).astype(np.float32)
    mod = jg.ExciteDownsampleBlock(out_channels=8, scale_factor=r)
    params = random_params(mod, x)
    want = np.asarray(mod.apply(params, x))
    port = weights.generator_from_jax(tg.ExciteDownsampleBlock(8, 8, r), params)
    np.testing.assert_allclose(nwc(port(ncw(x))), want, **TOL)


def test_encoder():
    x = np.random.default_rng(2).standard_normal((2, 1280, 1)).astype(np.float32)
    kw = dict(kernel_sizes=(3, 5), dilations=(1, 2))
    mod = jg.Encoder(tuple(reversed(RATIOS)), tuple(reversed(CHANNELS)), embedding_dim=8, **kw)
    params = random_params(mod, x)
    want = np.asarray(mod.apply(params, x))
    port = weights.generator_from_jax(
        tg.Encoder(tuple(reversed(RATIOS)), tuple(reversed(CHANNELS)), 8, **kw), params)
    got = nwc(port(ncw(x)))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, **TOL)


def test_decoder():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    spk = rng.standard_normal((2, 8)).astype(np.float32)
    c_var = 0.1 * rng.standard_normal((2, 1280, 1)).astype(np.float32)
    kw = dict(kernel_sizes=(3,), dilations=(1,))
    mod = jg.Decoder(RATIOS, CHANNELS, conditional_dim=8, embedding_dim=8, **kw)
    params = random_params(mod, x, spk, c_var)
    wav, subs = mod.apply(params, x, spk, c_var, out_subsample=True)
    port = weights.generator_from_jax(tg.Decoder(RATIOS, CHANNELS, 8, 8, **kw), params)
    pwav, psubs = port(ncw(x), torch.from_numpy(spk), ncw(c_var))
    np.testing.assert_allclose(nwc(pwav), np.asarray(wav), **TOL)
    assert len(psubs) == len(subs) == 2
    for a, b in zip(psubs, subs):
        np.testing.assert_allclose(nwc(a), np.asarray(b), **TOL)


@pytest.fixture(scope="module")
def generators():
    kw = dict(kernel_sizes=(3, 5), dilations=(1, 2))
    jax_g = jg.Generator(decoder_ratios=RATIOS, decoder_channels=CHANNELS,
                         num_bottleneck_layers=0, num_classes=4, conditional_dim=8,
                         content_dim=8, **kw)
    x = jnp.zeros((1, 1280, 1))
    params = random_params(jax_g, x, jnp.zeros((1, 4)), None, x, seed=4)
    port = tg.Generator(RATIOS, CHANNELS, 4, 8, 8, **kw)
    return jax_g, params, weights.generator_from_jax(port, params)


@pytest.mark.parametrize("with_excitation", [True, False])
def test_generator(generators, with_excitation):
    jax_g, params, port = generators
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[1, 3]]
    c_var = (0.1 * rng.standard_normal((2, 1280, 1))).astype(np.float32) \
        if with_excitation else None
    wav, subs, content = jax.jit(jax_g.apply)(params, x, onehot, None, c_var)
    with torch.no_grad():
        pwav, psubs, pcontent = port(torch.from_numpy(x), torch.from_numpy(onehot),
                                     None if c_var is None else torch.from_numpy(c_var))
    assert pwav.shape == (2, 1280, 1) and pcontent.shape == (2, 8, 8)
    np.testing.assert_allclose(pcontent.numpy(), np.asarray(content), **TOL)
    np.testing.assert_allclose(pwav.numpy(), np.asarray(wav), **TOL)
    for a, b in zip(psubs, subs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_generator_from_config_full_width_shapes():
    """The slice's configuration builds at full width with the parameter
    shapes the JAX package gives it (no forward: that is the card's job)."""
    cfg = GeneratorConfig()
    port = tg.generator_from_config(cfg, num_classes=100, device="cpu", seed=0)
    jax_g = jg.Generator(decoder_ratios=tuple(cfg.decoder_ratios),
                         decoder_channels=tuple(cfg.decoder_channels),
                         num_bottleneck_layers=0, num_classes=100,
                         conditional_dim=128, content_dim=128)
    x = jnp.zeros((1, 8960, 1))
    shapes = jax.eval_shape(jax_g.init, jax.random.PRNGKey(0), x, jnp.zeros((1, 100)), None, x)
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    sd = port.state_dict()
    assert len(flat) == len(sd)
    n_jax = sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    assert n_jax == sum(t.numel() for t in sd.values())


def test_unsupported_configs_raise():
    """The port refuses what the JAX package cannot run: a decoder without
    speaker conditioning (the JAX decoder sizes its MRF cond for the
    excitation alone, then raises in a conv) and an unknown encoder_model
    (which the JAX validate refuses); the options it runs build."""
    cfg = GeneratorConfig()
    for bad, match in ((dict(conditioning=dataclasses.replace(cfg.conditioning, decoder=None)),
                        "decoder=None"), (dict(encoder_model="hubert"), "encoder_model")):
        with pytest.raises(ValueError, match=match):
            tg.generator_from_config(dataclasses.replace(cfg, **bad), 4, device="cpu")
    small = dict(decoder_channels=[16, 16, 8, 8, 4], content_dim=8, conditional_dim=8)
    tg.generator_from_config(dataclasses.replace(cfg, num_bottleneck_layers=2, **small), 4,
                             device="cpu")


def test_load_config_matches_jax(tmp_path):
    """A reference-style two-document YAML with keys outside the slice loads
    to the same generator and train fields as in the JAX package."""
    path = tmp_path / "stage.yaml"
    path.write_text(
        "model:\n  sample_rate: 16000\n  generator:\n    decoder_ratios: [10, 4, 2, 2]\n"
        "    decoder_channels: [16, 16, 8, 8, 4]\n    content_dim: 8\n"
        "    conditioning: {decoder: target}\n  discriminator: {num_disc: 3}\n"
        "---\ntrain:\n  max_segment: 1280\n  lr_g: 0.0002\n")
    port, ref = load_config(path), jcfg.load_config(path)
    gp, gr = port.model.generator, ref.model.generator
    for f in ("decoder_ratios", "decoder_channels", "content_dim", "conditional_dim",
              "mrf_kernel_sizes", "mrf_dilations", "encoder_model", "num_bottleneck_layers"):
        assert getattr(gp, f) == getattr(gr, f), f
    assert gp.content_dim == 8 and port.train.max_segment == ref.train.max_segment == 1280
    assert port.train.compute_dtype == ref.train.compute_dtype
    # scalars are coerced to the declared type (the JAX loader keeps '8')
    assert load_config(overrides={"model": {"generator": {"content_dim": "8"}}}
                       ).model.generator.content_dim == 8
    with pytest.raises(ValueError, match="multiple"):
        load_config(overrides={"train": {"max_segment": 1000}})


def test_generator_encode_only_content_and_c_src(generators):
    """The train step's calls: encode_only, decoding from a given content,
    and a source speaker (which this configuration does not read) all as in the
    JAX Generator."""
    jax_g, params, port = generators
    rng = np.random.default_rng(6)
    x = (0.3 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    c_tgt, c_src = np.eye(4, dtype=np.float32)[[2, 0]], np.eye(4, dtype=np.float32)[[1, 1]]
    c_var = (0.1 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    cont = jax.jit(lambda p, x: jax_g.apply(p, x, None, encode_only=True))(params, x)
    with torch.no_grad():
        pcont = port(torch.from_numpy(x), None, encode_only=True)
        np.testing.assert_allclose(pcont.numpy(), np.asarray(cont), **TOL)
        content = np.asarray(cont)[::-1].copy()  # any content, not x's own
        wav, subs, out_cont = jax.jit(
            lambda p, c, v, k: jax_g.apply(p, None, c, None, v, content=k))(
            params, c_tgt, c_var, content)
        pwav, psubs, pout_cont = port(None, torch.from_numpy(c_tgt), torch.from_numpy(c_var),
                                      content=torch.from_numpy(content))
        np.testing.assert_allclose(pwav.numpy(), np.asarray(wav), **TOL)
        for a, b in zip(psubs, subs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        np.testing.assert_array_equal(pout_cont.numpy(), content)
        want = jax.jit(jax_g.apply)(params, x, c_tgt, c_src, c_var)[0]
        got = port(torch.from_numpy(x), torch.from_numpy(c_tgt), torch.from_numpy(c_var),
                   c_src=torch.from_numpy(c_src))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
