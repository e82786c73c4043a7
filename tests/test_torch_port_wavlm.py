"""The port's WavLM backbone, its checkpoint loader and the SSL content
encoder against the JAX package's, at the tiny widths of
tests/test_train_step_wavlm.py (2 layers, width 32, 4 heads, stride 320).

Parameters are made with numpy from a seed in the flax trees' shapes and
carried into the port by ``weights.generator_from_jax``; inputs come from the
same seed. Tolerances, of max|ref|: 1e-5 for the norms, the extractor, one
attention block or layer and the posterior encoder (f32 on both sides, sums
in another order); 2e-5 for the whole backbone and what runs on it; the
bucket map is exact. A Microsoft-format checkpoint is written by the test
(``testing.microsoft_wavlm_checkpoint``) and read by both packages' loaders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.models import generator as jg
from td_vc_gan_tpu.models import ssl_encoder as jssl
from td_vc_gan_tpu.models import wavlm as jw
from td_vc_gan_tpu_torch import testing, weights
from td_vc_gan_tpu_torch.config import GeneratorConfig
from td_vc_gan_tpu_torch.models import generator as tg
from td_vc_gan_tpu_torch.models import ssl_encoder as tssl
from td_vc_gan_tpu_torch.models import wavlm as tw
from td_vc_gan_tpu_torch.models.layers import init_weights

torch.set_num_threads(1)

RTOL = 1e-5       # one block, of max|ref|
STACK_RTOL = 2e-5  # the whole backbone and what runs on it, of max|ref|

TINY = dict(
    extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=32,
    encoder_ffn_embed_dim=64, encoder_attention_heads=4, layer_norm_first=True,
    conv_feature_layers=((16, 10, 5),) + ((16, 3, 2),) * 4 + ((16, 2, 2),) * 2,
    conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=80,
)


def cfgs(**kw):
    """The JAX and the port's WavLMConfig for TINY with ``kw``."""
    return jw.WavLMConfig(**{**TINY, **kw}), tw.WavLMConfig(**{**TINY, **kw})


def random_params(module, *args, seed=0):
    """A flax parameter tree for ``module`` filled from numpy: weight-norm
    gains and norm scales in [0.5, 1.5], biases ~ 0.1 N(0, 1), other
    kernels ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if any(k in name for k in ("'g'", "'scale'", "pos_conv_g", "grep_a")):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.1 if "bias" in name else 0.3
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


def wav(b=2, n=3200, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal((b, n))).astype(np.float32)


def channels_last(b=2, t=12, c=32, seed=2):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


def test_tiny_config_has_the_large_stride():
    assert tw.WavLMConfig(**TINY).total_stride == tw.WavLMConfig().total_stride == 320
    assert tw.wavlm_base_config() == tw.WavLMConfig(**{
        f.name: getattr(jw.wavlm_base_config(), f.name) for f in dataclasses.fields(tw.WavLMConfig)})


@pytest.mark.parametrize("n,num_buckets,max_distance", [(1, 32, 80), (37, 32, 80),
                                                        (300, 320, 800), (1100, 320, 800)])
def test_relative_position_buckets_equal_jax(n, num_buckets, max_distance):
    np.testing.assert_array_equal(tw._relative_position_buckets(n, num_buckets, max_distance),
                                  jw._relative_position_buckets(n, num_buckets, max_distance))


@pytest.mark.parametrize("norm", ["layer", "group"])
def test_norms(norm):
    x = 3 + 2 * channels_last(c=16)
    mod = jw._LayerNorm() if norm == "layer" else jw._GroupNorm()
    params = random_params(mod, x)
    want = mod.apply(params, x)
    if norm == "layer":
        port = weights.generator_from_jax(tw._LayerNorm(16), params)
        got = port(torch.from_numpy(x))
    else:  # (B, C, T) in the port
        port = weights.generator_from_jax(tw._GroupNorm(16), params)
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert_close(got, want)


@pytest.mark.parametrize("mode,conv_bias", [("layer_norm", False), ("default", False),
                                            ("layer_norm", True)])
def test_feature_extractor(mode, conv_bias):
    jc, tc = cfgs(extractor_mode=mode, conv_bias=conv_bias)
    x = wav()
    mod = jw.ConvFeatureExtractor(jc)
    params = random_params(mod, x)
    want = mod.apply(params, x)
    port = weights.generator_from_jax(tw.ConvFeatureExtractor(tc), params)
    assert_close(port(torch.from_numpy(x)).transpose(1, 2), want)


@pytest.mark.parametrize("rel,gru", [(True, True), (True, False), (False, True)])
def test_attention(rel, gru):
    """Layer 0 makes the position bias (gated from the unscaled queries, or
    not); a later layer gets one; without relative attention, none."""
    jc, tc = cfgs(gru_rel_pos=gru, relative_position_embedding=rel)
    x = channels_last()
    mod = jw.MultiheadAttention(jc, has_relative_attention_bias=rel)
    params = random_params(mod, x)
    want, want_bias = mod.apply(params, x)
    port = weights.generator_from_jax(tw.MultiheadAttention(tc, rel), params)
    got, got_bias = port(torch.from_numpy(x))
    assert_close(got, want)
    if rel:
        assert_close(got_bias, want_bias)
        later = jw.MultiheadAttention(jc)
        p2 = random_params(later, x, want_bias, seed=3)
        want2, _ = later.apply(p2, x, want_bias)
        got2, _ = weights.generator_from_jax(tw.MultiheadAttention(tc), p2)(
            torch.from_numpy(x), got_bias)
        assert_close(got2, want2)
    else:
        assert got_bias is None and want_bias is None


@pytest.mark.parametrize("layer_norm_first", [True, False])
def test_encoder_layer(layer_norm_first):
    jc, tc = cfgs(layer_norm_first=layer_norm_first)
    x = channels_last()
    mod = jw.EncoderLayer(jc, has_relative_attention_bias=True)
    params = random_params(mod, x)
    want, _ = mod.apply(params, x)
    got, _ = weights.generator_from_jax(tw.EncoderLayer(tc, True), params)(torch.from_numpy(x))
    assert_close(got, want)


@pytest.mark.parametrize("conv_pos,layer_norm_first", [(16, True), (15, True), (16, False)])
def test_transformer_encoder(conv_pos, layer_norm_first):
    """pos_conv normed per tap, the last frame dropped for even k; the
    final LayerNorm before or after the stack."""
    jc, tc = cfgs(conv_pos=conv_pos, layer_norm_first=layer_norm_first)
    x = channels_last(t=20)
    mod = jw.TransformerEncoder(jc)
    params = random_params(mod, x)
    want = mod.apply(params, x)
    port = weights.generator_from_jax(tw.TransformerEncoder(tc), params)
    assert_close(port(torch.from_numpy(x)), want, STACK_RTOL)


@pytest.fixture(scope="module")
def backbone():
    """The JAX WavLM at TINY, numpy parameters, and the port's twin."""
    jc, tc = cfgs()
    mod = jw.WavLM(jc)
    params = random_params(mod, np.zeros((1, 3200), np.float32), seed=4)
    return mod, params, weights.generator_from_jax(tw.WavLM(tc), params)


def test_wavlm_features(backbone):
    mod, params, port = backbone
    x = wav(n=3360)
    want = jax.jit(mod.apply)(params, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 10, 32)
    assert_close(got, want, STACK_RTOL)


def test_load_wavlm_checkpoint_through_both_loaders(backbone, tmp_path):
    """A Microsoft-format .pt (cfg string with + and *, weight_g (1, 1, k),
    mask_emb) read by the JAX loader and by the port's: the JAX tree it
    gives is the one the weights came from, the port's state equals the
    weights, and the features agree."""
    mod, params, port = backbone
    path = tmp_path / "wavlm.pt"
    blob = testing.microsoft_wavlm_checkpoint(port)
    assert "+" in blob["cfg"]["conv_feature_layers"] and "*" in blob["cfg"]["conv_feature_layers"]
    torch.save(blob, path)
    jcfg_, jparams = jw.load_wavlm_checkpoint(path)
    assert jcfg_ == jw.WavLMConfig(**TINY)
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                               jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(kp))
    cfg, state = tw.load_wavlm_checkpoint(path)
    assert cfg == tw.WavLMConfig(**TINY)
    loaded = tw.WavLM(cfg)
    loaded.load_state_dict(state)
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    file_digest = tw.backbone_digest(blob["model"][ms] for ms, _ in tw.key_table(cfg))
    assert tw.wavlm_digest(loaded) == file_digest
    x = wav(n=1920, seed=5)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x))
    assert_close(got, jax.jit(jw.WavLM(jcfg_).apply)(jparams, x), STACK_RTOL)


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_load_wavlm_checkpoint_refuses_other_keys(backbone, tmp_path, change):
    blob = testing.microsoft_wavlm_checkpoint(backbone[2])
    if change == "missing":
        del blob["model"]["encoder.layers.1.fc2.bias"]
    else:
        blob["model"]["encoder.layers.2.fc1.weight"] = torch.zeros(64, 32)
    torch.save(blob, tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="fc2.bias" if change == "missing" else "layers.2"):
        tw.load_wavlm_checkpoint(tmp_path / "bad.pt")


@pytest.mark.parametrize("text,ok", [("[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2", True),
                                     ("[(16, 10, 5), (16, 4, 4)]", True),
                                     ("[(512,10,5)] * 2.0", False),
                                     ("__import__('os').getcwd()", False)])
def test_conv_layers_parse_without_eval(text, ok):
    if ok:
        assert tw._conv_layers(text) == tuple(tuple(t) for t in eval(text))  # noqa: S307
    else:
        with pytest.raises(ValueError):
            tw._conv_layers(text)


def test_wn_posterior_encoder():
    """WN's last res_skip is h wide; only the posterior's mean is read."""
    x = channels_last(t=9, c=32)
    mod = jssl.PosteriorEncoder(out_channels=8, hidden_channels=8, n_layers=3)
    params = random_params(mod, x)
    _, want, _ = mod.apply(params, x)
    port = weights.generator_from_jax(tssl.PosteriorEncoder(32, 8, 8, n_layers=3), params)
    assert port.enc.res_skip_2.weight().shape[0] == 8
    assert port.enc.res_skip_1.weight().shape[0] == 16
    assert_close(port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2), want)


@pytest.fixture(scope="module")
def ssl_encoders():
    jc, tc = cfgs()
    mod = jssl.SSLEncoder(num_layers=2, emb_dim=8, wavlm_cfg=jc)
    params = random_params(mod, np.zeros((1, 1280, 1), np.float32), seed=6)
    port = weights.generator_from_jax(tssl.SSLEncoder(2, 8, wavlm_cfg=tc), params)
    return mod, params, port


def test_ssl_encoder(ssl_encoders):
    """The 160-sample left pad gives T / 320 frames; ``features`` skips the
    backbone."""
    mod, params, port = ssl_encoders
    x = wav(n=2560, seed=7)[..., None]
    want = jax.jit(mod.apply)(params, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2))
    assert got.shape == (2, 8, 8)
    assert_close(got.transpose(1, 2), want, STACK_RTOL)
    feats = channels_last(t=8, seed=8)
    want_f = jax.jit(mod.apply)(params, x, features=feats)
    got_f = port(None, features=torch.from_numpy(feats))
    assert_close(got_f.transpose(1, 2), want_f)


def test_ssl_encoder_gradients_reach_only_the_posterior(ssl_encoders):
    """A scalar loss on the content: the posterior's gradients match
    jax.grad through the JAX SSLEncoder (whose backbone gradients are zeros,
    under stop_gradient); the port's backbone gets none and keeps no graph."""
    mod, params, port = ssl_encoders
    x = wav(n=2560, seed=9)[..., None]
    w = np.random.default_rng(10).standard_normal((2, 8, 8)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(mod.apply(p, x) * w)))(params)
    assert all(not np.any(np.asarray(g)) for g in
               jax.tree_util.tree_leaves(grads["params"]["wavlm"]))
    port.zero_grad(set_to_none=True)
    content = port(torch.from_numpy(x).transpose(1, 2))
    (content.transpose(1, 2) * torch.from_numpy(w)).sum().backward()
    assert all(p.grad is None and not p.requires_grad for p in port.wavlm.parameters())
    want = weights.generator_from_jax(
        tssl.SSLEncoder(2, 8, wavlm_cfg=tw.WavLMConfig(**TINY)),
        jax.tree_util.tree_map(np.asarray, grads))
    want_grads = dict(want.posterior.named_parameters())
    for name, p in port.posterior.named_parameters():
        assert_close(p.grad, want_grads[name].detach().numpy(), STACK_RTOL)


@pytest.fixture(scope="module")
def generators():
    """The JAX wavlm Generator (ratios 10, 8, 2, 2 multiply to WavLM's 320)
    at narrow widths, numpy parameters, and the port's twin."""
    jc, tc = cfgs()
    kw = dict(kernel_sizes=(3,), dilations=(1,))
    ratios, channels = (10, 8, 2, 2), (16, 16, 8, 8, 4)
    jax_g = jg.Generator(decoder_ratios=ratios, decoder_channels=channels,
                         num_bottleneck_layers=0, num_classes=4, conditional_dim=8,
                         content_dim=8, encoder_model="wavlm", num_enc_layers=2,
                         wavlm_cfg=jc, **kw)
    x = jnp.zeros((1, 1280, 1))
    params = random_params(jax_g, x, jnp.zeros((1, 4)), None, x, seed=11)
    port = tg.Generator(ratios, channels, 4, 8, 8, encoder_model="wavlm", num_enc_layers=2,
                        wavlm_cfg=tc, **kw)
    return jax_g, params, weights.generator_from_jax(port, params)


def test_wavlm_generator(generators):
    """wav, subsamples and content; ``encode_only``; ``content=``."""
    jax_g, params, port = generators
    rng = np.random.default_rng(12)
    x = (0.3 * rng.standard_normal((2, 2560, 1))).astype(np.float32)
    exc = (0.1 * rng.standard_normal((2, 2560, 1))).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[2, 0]]
    wav_, subs, content = jax.jit(jax_g.apply)(params, x, onehot, None, exc)
    with torch.no_grad():
        pwav, psubs, pcontent = port(torch.from_numpy(x), torch.from_numpy(onehot),
                                     torch.from_numpy(exc))
        penc = port(torch.from_numpy(x), None, encode_only=True)
        pwav2, _, _ = port(None, torch.from_numpy(onehot), torch.from_numpy(exc),
                           content=penc)
    assert pcontent.shape == (2, 8, 8) and pwav.shape == (2, 2560, 1)
    assert_close(pcontent, content, STACK_RTOL)
    assert_close(penc, content, STACK_RTOL)  # the JAX encode_only gives the same
    assert_close(pwav, wav_, STACK_RTOL)
    for a, b in zip(psubs, subs, strict=True):
        assert_close(a, b, STACK_RTOL)
    assert torch.equal(pwav2, pwav)


def test_wavlm_generator_from_config_full_width():
    """wavlm-stage2_2 at full width: WavLM-Large (24 x 1024, 16 heads, FFN
    4096) and 16 WN layers, 128 wide; the parameter shapes the JAX package
    gives it, the backbone frozen and from the seed, and the configs the JAX
    package cannot run refused."""
    cfg = GeneratorConfig(encoder_model="wavlm")
    port = tg.generator_from_config(cfg, num_classes=4, device="cpu", seed=0)
    jax_g = jg.generator_from_config(cfg, 4)
    x = jnp.zeros((1, 1280, 1))
    shapes = jax.eval_shape(jax_g.init, jax.random.PRNGKey(0), x, jnp.zeros((1, 4)), None, x)
    flat = {".".join(str(k.key) for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    sd = port.state_dict()
    assert sorted(flat) == sorted(sd)
    for name, shape in flat.items():
        assert int(np.prod(shape)) == sd[name].numel(), name
    n_backbone = sum(p.numel() for p in port.encoder.wavlm.parameters())
    assert 3.1e8 < n_backbone < 3.2e8
    assert not any(p.requires_grad for p in port.encoder.wavlm.parameters())
    assert port.encoder.posterior.enc.n_layers == 16
    for bad in (dict(encoder_model="hubert"), dict(conditioning=dataclasses.replace(
            cfg.conditioning, decoder=None))):
        with pytest.raises(ValueError):
            tg.generator_from_config(dataclasses.replace(cfg, **bad), 4, device="cpu")


def test_seeded_backbone_is_deterministic():
    a = init_weights(tw.WavLM(tw.WavLMConfig(**TINY)), 3)
    b = init_weights(tw.WavLM(tw.WavLMConfig(**TINY)), 3)
    assert tw.wavlm_digest(a) == tw.wavlm_digest(b)
    assert tw.wavlm_digest(a) != tw.wavlm_digest(init_weights(tw.WavLM(tw.WavLMConfig(**TINY)), 4))
