"""The generator's options in the port against the JAX package, at small width.

The options: instance norm and conditional instance norm, the FiLM block's
own cond chain on a 2-D or a per-frame cond, the MRF's concat and broadcast
cond forms, the reference's spare blocks, the encoder's speaker
conditioning, the decoder's norm slots, the bottleneck of FiLM blocks on the
target speaker or on source and target, and F0Estimator; the refusals that
mirror what the JAX package cannot run; the options config's ``.pt`` tables,
full train state and train step.

Parameters are made with numpy from a seed in the flax trees' shapes
(``jax.eval_shape``) and carried into the port by ``weights.py``; inputs come
from the same seed. Tolerances (f32 on both sides, sums in another order):
a module's outputs and gradients within 1e-5 of max|ref| (GRAD_RTOL), a
whole encoder, decoder or generator within 1e-4 (G_RTOL), ~20 convs deep. In
the bf16 scope the port's error against the f32 reference is held to the
JAX package's own bf16 error (``assert_bf16_error``): at most twice it in
RMS, and at most four times the larger of its maximum and one bf16 ulp of
max|ref| at any element. The two round in other places: XLA on the CPU
keeps excess precision across fused elementwise ops, where the port rounds
each op's output as torch and cuDNN do on the card; and the cond-chain op
rounds lrelu(h) once before cond_1 and its output once, where the JAX FiLM
block rounds each of its two convs' outputs. Through a decoder whose CIN
normalises over 8 frames at its first stage, one element of the output may
move by twice the JAX package's largest error while the port's RMS error
stays below the JAX package's (test_options_generator_paths[bfloat16]). Every FiLM chain of the port,
the bottleneck's included, runs through the cond-chain op (its plain
version on the CPU), where the JAX FiLM block runs two convs: the same
function.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.models import f0_estimator as jf0
from td_vc_gan_tpu.models import generator as jg
from td_vc_gan_tpu.models import layers as jl
from td_vc_gan_tpu.training import torch_interop as jti
from td_vc_gan_tpu_torch import testing, weights
from td_vc_gan_tpu_torch.config import GeneratorConfig, load_config
from td_vc_gan_tpu_torch.models import f0_estimator as tf0
from td_vc_gan_tpu_torch.models import generator as tg
from td_vc_gan_tpu_torch.models import layers as tl
from td_vc_gan_tpu_torch.training import checkpoint as pckpt
from td_vc_gan_tpu_torch.training import loop as ploop
from td_vc_gan_tpu_torch.training import torch_interop as pti
from td_vc_gan_tpu_torch.training.state import create_train_state
from td_vc_gan_tpu_torch.training.step import build_train_step

torch.set_num_threads(1)

GRAD_RTOL = 1e-5
G_RTOL = 1e-4
VANISHING_ATOL = 1e-5
RATIOS = (10, 4, 2, 2)
CHANNELS = (16, 16, 8, 8, 4)
MRF = dict(kernel_sizes=(3, 5), dilations=(1, 2))
MRF_G = dict(kernel_sizes=(3,), dilations=(1,))  # whole generators: 1 block a stage
CIN = "conditional_instance_norm"
NUM_SPK = 4
SEG = 1280
# the options config: a 2-layer bottleneck on the target speaker, instance
# norm in the encoder, conditional instance norm in the decoder
OPTIONS = {"num_bottleneck_layers": 2,
           "norm_layer": {"encoder": "instance_norm", "decoder": CIN}}
TINY = {"model": {"generator": {"decoder_ratios": list(RATIOS),
                                "decoder_channels": list(CHANNELS),
                                "content_dim": 8, "conditional_dim": 8,
                                "mrf_kernel_sizes": [3], "mrf_dilations": [1, 3], **OPTIONS},
                  "discriminator": {"num_channels_base": 4, "num_layers": 2}},
        "train": {"max_segment": SEG, "mel_fft_sizes": [512], "batch_size": 2}}


def random_params(module, *args, seed=0, **kw):
    """A flax parameter tree for ``module`` filled from numpy: weight-norm
    gains in [0.5, 1.5], biases ~ 0.1 N(0, 1), other kernels ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "'g'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.1 if "bias" in name else 0.3
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def ncw(a):
    """channels-last numpy -> (B, C, T) torch"""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def nwc(t):
    return t.detach().float().numpy().transpose(0, 2, 1)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_rel(got, want, rtol, name=""):
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    d = float(np.abs(g - w).max())
    assert d <= rtol * float(np.abs(w).max()) + 1e-9, (name, d, float(np.abs(w).max()))


def assert_bf16_error(port, jax_bf16, jax_f32, name=""):
    """The port's bf16 error against the f32 reference: in RMS at most twice
    the JAX package's own, and at any element at most four times the larger
    of the JAX package's largest error and one bf16 ulp of max|ref|."""
    p, b, f = np32(port), np32(jax_bf16), np32(jax_f32)
    assert p.shape == b.shape == f.shape, name
    rms = lambda d: float(np.sqrt(np.mean(d * d)))  # noqa: E731
    assert rms(p - f) <= 2 * rms(b - f), (name, rms(p - f), rms(b - f))
    ulp = np.ldexp(1.0, np.frexp(np.abs(f).max())[1] - 8)
    bound = 4 * max(np.abs(b - f).max(), ulp)
    assert np.abs(p - f).max() <= bound, (name, np.abs(p - f).max(), bound)


def jax_in(dtype, fn, *args):
    """``fn(*args)`` traced and run under the JAX package's compute scope."""
    with jl.compute_dtype_scope(dtype):
        return jax.jit(lambda *a: fn(*a))(*args)


def assert_param_grads(port, jax_grads, rtol, names=None):
    """The port's parameter gradients against a JAX gradient tree, carried
    into the port's layouts by ``weights.py``, per tensor within rtol of its
    max|ref|; every one of ``names`` (prefixes) nonzero. The tensors whose
    gradient a norm slot cancels (``testing.norm_invariant``: true gradient
    0 but for the norm's eps, so rounding noise in both) are held to
    VANISHING_ATOL of the largest gradient instead."""
    want = weights.generator_from_jax(copy.deepcopy(port), jax_grads).state_dict()
    top = max(float(w.abs().max()) for w in want.values())
    invariant = testing.norm_invariant(port) if isinstance(port, tg.Generator) else set()
    for n, p in port.named_parameters():
        assert p.grad is not None, n
        if n in invariant:
            assert float((p.grad - want[n]).abs().max()) <= VANISHING_ATOL * top, n
        else:
            assert_rel(p.grad, want[n], rtol, n)
        if names and n.startswith(names):
            assert float(want[n].abs().max()) > 0, n


# --- the norms ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind", ["instance", "cin_2d", "cin_3d"])
def test_norms(kind, dtype):
    """InstanceNorm (population variance over T, eps 1e-5) and
    ConditionalInstanceNorm on a 2-D cond (a Linear, which keeps f32 under
    the bf16 scope, so the output is f32) and on a per-frame cond (a k=5
    conv, bf16 in the scope); in f32 and in the bf16 scope, x in that
    dtype."""
    rng = np.random.default_rng(1)
    x = (2.0 + rng.standard_normal((2, 40, 6))).astype(np.float32)
    c = rng.standard_normal((2, 5) if kind == "cin_2d" else (2, 40, 5)).astype(np.float32)
    if kind == "instance":
        mod, port, args = jl.InstanceNorm(), tl.InstanceNorm(), (x,)
    else:
        mod, args = jl.ConditionalInstanceNorm(6), (x, c)
        port = tl.ConditionalInstanceNorm(6, 5, per_frame=kind == "cin_3d")
    params = random_params(mod, *args, seed=2)
    if kind != "instance":
        weights.generator_from_jax(port, params)
        assert sorted(port.state_dict()) == sorted(
            ".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params["params"])[0])
    jdt = jnp.bfloat16 if dtype else jnp.float32
    jargs = (jnp.asarray(x, jdt),) + tuple(jnp.asarray(a) for a in args[1:])
    want = jax_in(dtype, lambda *a: mod.apply(params, *a), *jargs)
    targs = (ncw(x).to(torch.bfloat16 if dtype else torch.float32),) + (
        () if kind == "instance" else
        (torch.from_numpy(c) if kind == "cin_2d" else ncw(c),))
    with torch.no_grad(), tl.compute_dtype_scope(dtype):
        got = port(*targs)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    if dtype is None:
        assert_rel(nwc(got), want, GRAD_RTOL)
    else:
        ref = jax_in(None, lambda *a: mod.apply(params, *a), x, *jargs[1:])
        assert_bf16_error(nwc(got), want, ref)


# --- the FiLM block's own chain, and the MRF's concat forms ----------------------


@pytest.mark.parametrize("per_frame", [False, True])
def test_film_block_on_a_cond(per_frame):
    """FiLMResnetBlock on a 2-D cond (broadcast over T) and on a per-frame
    cond: the output, and the gradients of x, of the cond and of every
    parameter (the chain's cond_0 and cond_1 among them) against jax.grad."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    c = rng.standard_normal((2, 30, 5) if per_frame else (2, 5)).astype(np.float32)
    cot = rng.standard_normal((2, 30, 6)).astype(np.float32)
    mod = jl.FiLMResnetBlock(channels=6, cond_channels=5, dilation=3, kernel_size=5)
    params = random_params(mod, x, c, seed=4)
    out, (gp, gx, gc) = jax.jit(lambda p, a, b: (lambda o, f: (o, f(cot)))(
        *jax.vjp(mod.apply, p, a, b)))(params, x, c)
    port = weights.generator_from_jax(tl.FiLMResnetBlock(6, 5, dilation=3, kernel_size=5), params)
    xt = ncw(x).requires_grad_()
    ct = (ncw(c) if per_frame else torch.from_numpy(c)).requires_grad_()
    got = port(xt, c=ct)
    assert_rel(nwc(got), out, GRAD_RTOL, "out")
    got.backward(ncw(cot))
    assert_rel(nwc(xt.grad), gx, GRAD_RTOL, "x")
    assert_rel(nwc(ct.grad) if per_frame else ct.grad, gc, GRAD_RTOL, "cond")
    assert_param_grads(port, gp, GRAD_RTOL, names=("cond_0", "cond_1"))


@pytest.mark.parametrize("per_frame", [False, True])
def test_mrf_concat_and_broadcast_forms(per_frame):
    """MRFBlock on a per-frame cond (the concat form) and on a 2-D cond
    broadcast over T: every block's chain in one call of the op, as the
    JAX package's ``_batched_film``; the output and every weight gradient."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 4)).astype(np.float32)
    c = rng.standard_normal((2, 32, 8) if per_frame else (2, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 32, 4)).astype(np.float32)
    kw = dict(dilations=(1, 3), kernel_sizes=(3, 5))
    mod = jl.MRFBlock(channels=4, cond_channels=8, **kw)
    params = random_params(mod, x, c, seed=6)
    out, (gp,) = jax.jit(lambda p: (lambda o, f: (o, f(cot)))(
        *jax.vjp(lambda q: mod.apply(q, x, c), p)))(params)
    port = weights.generator_from_jax(tl.MRFBlock(4, 8, **kw), params)
    got = port(ncw(x), ncw(c) if per_frame else torch.from_numpy(c))
    assert_rel(nwc(got), out, GRAD_RTOL, "out")
    got.backward(ncw(cot))
    assert_param_grads(port, gp, GRAD_RTOL, names=("block",))


# --- the reference's spare blocks -------------------------------------------------


SPARE = {
    "resnet": (lambda: jl.ResnetBlock(6, dilation=2, norm="instance_norm"),
               lambda: tl.ResnetBlock(6, dilation=2, norm="instance_norm"), None),
    "decoder_resnet": (lambda: jl.DecoderResnetBlock(6, dilation=3),
                       lambda: tl.DecoderResnetBlock(6, dilation=3, in_channels=4), None),
    # k = 3 only: the reference pads by the dilation, so other widths change T
    "tranform_resnet": (lambda: jl.TranformResnetBlock(6, dilation=2),
                        lambda: tl.TranformResnetBlock(6, 2, in_channels=4), None),
    "cin_resnet": (lambda: jl.CINResnetBlock(6, dilation=2),
                   lambda: tl.CINResnetBlock(6, 5, dilation=2), (2, 5)),
    "cin_resnet_per_frame": (lambda: jl.CINResnetBlock(6, kernel_size=5),
                             lambda: tl.CINResnetBlock(6, 5, kernel_size=5, per_frame=True),
                             (2, 5, 24)),
}


@pytest.mark.parametrize("name", sorted(SPARE))
def test_spare_blocks(name):
    """ResnetBlock, DecoderResnetBlock, TranformResnetBlock and
    CINResnetBlock (2-D and per-frame cond), dead code in the reference,
    against the JAX package's with its parameter names."""
    make_jax, make_port, cshape = SPARE[name]
    rng = np.random.default_rng(7)
    width = 4 if name in ("decoder_resnet", "tranform_resnet") else 6
    x = rng.standard_normal((2, 24, width)).astype(np.float32)
    args = (x,)
    if cshape is not None:
        c = rng.standard_normal(cshape).astype(np.float32)
        args = (x, c if len(cshape) == 2 else c.transpose(0, 2, 1))
    mod = make_jax()
    params = random_params(mod, *args, seed=8)
    want = jax.jit(mod.apply)(params, *args)
    port = weights.generator_from_jax(make_port(), params)
    targs = (ncw(x),) if cshape is None else (ncw(x), torch.from_numpy(c))
    with torch.no_grad():
        assert_rel(nwc(port(*targs)), want, GRAD_RTOL)


# --- encoder, decoder, generator ----------------------------------------------------


@pytest.mark.parametrize("option", ["instance_norm", "concat", "cin"])
def test_encoder_options(option):
    """The conv encoder with instance norm, with the speaker concatenated
    after its input conv (stage 0 is 8 channels wider), and with CIN on the
    2-D speaker embedding."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1280, 1)).astype(np.float32)
    c = rng.standard_normal((2, 8)).astype(np.float32)
    norm = {"instance_norm": "instance_norm", "concat": None, "cin": CIN}[option]
    cdim = 0 if option == "instance_norm" else 8
    rr, rc = tuple(reversed(RATIOS)), tuple(reversed(CHANNELS))
    mod = jg.Encoder(rr, rc, conditional_dim=cdim, embedding_dim=8, norm=norm, **MRF_G)
    args = (x, c if cdim else None)
    params = random_params(mod, *args, seed=10)
    want = jax.jit(mod.apply)(params, *args)
    port = weights.generator_from_jax(
        tg.Encoder(rr, rc, 8, conditional_dim=cdim, norm=norm, **MRF_G), params)
    with torch.no_grad():
        got = port(ncw(x), torch.from_numpy(c) if cdim else None)
    assert_rel(nwc(got), want, G_RTOL)
    if option == "concat":
        assert port.stage_0_down.v.shape[1] == CHANNELS[-1] + 8


@pytest.mark.parametrize("norm", ["instance_norm", CIN])
def test_decoder_options(norm):
    """The decoder's norm slots (stage_i_norm, final_norm); under CIN their
    cond is concat(speaker broadcast, excitation at that scale), refreshed
    after each ConvT."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    spk = rng.standard_normal((2, 8)).astype(np.float32)
    c_var = 0.1 * rng.standard_normal((2, 1280, 1)).astype(np.float32)
    mod = jg.Decoder(RATIOS, CHANNELS, conditional_dim=8, embedding_dim=8, norm=norm, **MRF_G)
    params = random_params(mod, x, spk, c_var, seed=12)
    wav, subs = jax.jit(lambda p, *a: mod.apply(p, *a, out_subsample=True))(
        params, x, spk, c_var)
    port = weights.generator_from_jax(tg.Decoder(RATIOS, CHANNELS, 8, 8, norm=norm, **MRF_G),
                                      params)
    with torch.no_grad():
        pwav, psubs = port(ncw(x), torch.from_numpy(spk), ncw(c_var))
    assert_rel(nwc(pwav), wav, G_RTOL, "wav")
    for i, (a, b) in enumerate(zip(psubs, subs)):
        assert_rel(nwc(a), b, G_RTOL, f"sub{i}")


def jax_generator(**kw):
    return jg.Generator(decoder_ratios=RATIOS, decoder_channels=CHANNELS, num_classes=NUM_SPK,
                        conditional_dim=8, content_dim=8, **MRF_G, **kw)


def port_generator(**kw):
    return tg.Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF_G, **kw)


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((2, SEG, 1))).astype(np.float32)
    c_var = (0.1 * rng.standard_normal((2, SEG, 1))).astype(np.float32)
    return x, np.eye(NUM_SPK, dtype=np.float32)[[1, 3]], \
        np.eye(NUM_SPK, dtype=np.float32)[[2, 0]], c_var


@pytest.mark.parametrize("bot_cond", ["target", "both"])
def test_generator_bottleneck(bot_cond):
    """Two bottleneck FiLM blocks on c_tgt, or on c_src ⊕ c_tgt (cond 16
    wide), with c_src given; wav, subsamples and content."""
    x, c_tgt, c_src, c_var = inputs(13)
    jax_g = jax_generator(num_bottleneck_layers=2, bot_cond=bot_cond)
    params = random_params(jax_g, x, c_tgt, c_src, c_var, seed=14)
    want = jax.jit(jax_g.apply)(params, x, c_tgt, c_src, c_var)
    port = weights.generator_from_jax(port_generator(num_bottleneck_layers=2,
                                                     bot_cond=bot_cond), params)
    assert port.bottleneck_0.cond_0.v.shape[0] == (16 if bot_cond == "both" else 8)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(c_tgt), torch.from_numpy(c_var),
                   c_src=torch.from_numpy(c_src))
    assert_rel(got[0], want[0], G_RTOL, "wav")
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert_rel(a, b, G_RTOL, f"sub{i}")
    assert_rel(got[2], want[2], G_RTOL, "content")


OPTIONS_KW = dict(num_bottleneck_layers=2, norm_layer=(None, "instance_norm", CIN))


@pytest.fixture(scope="module")
def options_paths():
    """The tiny options G's JAX parameters, inputs, the calls of the train
    step (the encoder on x; the decoder on another content) and their f32
    JAX outputs."""
    x, c_tgt, _, c_var = inputs(15)
    jax_g = jax_generator(**OPTIONS_KW)
    params = random_params(jax_g, x, c_tgt, None, c_var, seed=16)
    content = (0.3 * np.random.default_rng(24).standard_normal((2, 8, 8))).astype(np.float32)

    def both(p, x, c, v, k):
        return (jax_g.apply(p, x, None, encode_only=True),
                jax_g.apply(p, None, c, None, v, content=k))

    args = (x, c_tgt, c_var, content)
    return params, both, args, jax_in(None, both, params, *args)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_options_generator_paths(options_paths, dtype):
    """The options config (bottleneck on c_tgt, instance norm in the
    encoder, CIN in the decoder) through the train step's calls:
    ``encode_only``, then decoding from a given content (the bottleneck
    runs on it), in f32 and in the bf16 scope (outputs in f32)."""
    params, both, (x, c_tgt, c_var, content), (ref_cont, ref) = options_paths
    port = weights.generator_from_jax(port_generator(**OPTIONS_KW), params)
    with torch.no_grad(), tl.compute_dtype_scope(dtype):
        pcont = port(torch.from_numpy(x), None, encode_only=True)
        got = port(None, torch.from_numpy(c_tgt), torch.from_numpy(c_var),
                   content=torch.from_numpy(content))
    outs = [("content", pcont, ref_cont), ("wav", got[0], ref[0])] + [
        (f"sub{i}", a, b) for i, (a, b) in enumerate(zip(got[1], ref[1]))]
    assert len(outs) == 4
    if dtype is None:
        for name, a, b in outs:
            assert_rel(a, b, G_RTOL, name)
        return
    cont, want = jax_in(dtype, both, params, x, c_tgt, c_var, content)
    for (name, a, r), b in zip(outs, [cont, want[0], *want[1]]):
        assert a.dtype == torch.float32, name
        assert_bf16_error(a, b, r, name)


@pytest.mark.parametrize("case", ["dec_cond_none", "both_without_c_src",
                                  "encoder_cin_without_c_src"])
def test_refusals_mirror_jax(case):
    """What the JAX package cannot run, the port refuses: a decoder without
    speaker conditioning (the JAX decoder sizes its MRF cond for the
    excitation alone and raises in a conv), the bottleneck on source ⊕
    target and an encoder CIN without c_src (as the train step and the
    Converter call G)."""
    x, c_tgt, _, c_var = inputs(17)
    kw = {"dec_cond_none": dict(dec_cond=None),
          "both_without_c_src": dict(num_bottleneck_layers=1, bot_cond="both"),
          "encoder_cin_without_c_src": dict(norm_layer=(None, CIN, None),
                                            enc_cond="target")}[case]
    with pytest.raises(Exception):
        jax.eval_shape(lambda k: jax_generator(**kw).init(k, x, c_tgt, None, c_var),
                       jax.random.PRNGKey(0))
    if case == "dec_cond_none":
        cfg = GeneratorConfig(conditioning=dataclasses.replace(
            GeneratorConfig().conditioning, decoder=None))
        with pytest.raises(ValueError, match="decoder=None"):
            tg.generator_from_config(cfg, NUM_SPK, device="cpu")
        return
    port = tl.init_weights(port_generator(**kw), 0)
    with torch.no_grad(), pytest.raises(ValueError, match="c_src|2-D"):
        port(torch.from_numpy(x), torch.from_numpy(c_tgt), torch.from_numpy(c_var))


def test_full_width_options_config_names_and_counts():
    """The options config at full width (the config defaults plus the
    options): the port's parameter names and element counts equal those of
    jax.eval_shape on the JAX Generator's init."""
    jc = jcfg.load_config(None, {"model": {"generator": OPTIONS}})
    cfg = load_config(None, {"model": {"generator": OPTIONS}})
    port = tg.generator_from_config(cfg.model.generator, 100, device="cpu")
    jax_g = jg.generator_from_config(jc.model.generator, 100)
    x = jnp.zeros((1, 8960, 1))
    shapes = jax.eval_shape(jax_g.init, jax.random.PRNGKey(0), x, jnp.zeros((1, 100)), None, x)
    flat = {".".join(str(k.key) for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    sd = port.state_dict()
    assert sorted(flat) == sorted(sd)
    for name, shape in flat.items():
        assert int(np.prod(shape)) == sd[name].numel(), name
    assert any(k.startswith("bottleneck_1.cond_1") for k in sd)
    assert "decoder.final_norm.WNConv1d_0.kernel" in sd


def test_f0_estimator():
    """F0Estimator (reflect input conv, grouped strided convs, the voicing
    and f0 heads) against the JAX module at a small width."""
    x = (0.3 * np.random.default_rng(18).standard_normal((2, 1024, 1))).astype(np.float32)
    mod = jf0.F0Estimator(num_layers=2, stride=4, base_channels=4)
    params = random_params(mod, x, seed=19)
    f0, voiced = mod.apply(params, x)
    port = weights.f0_estimator_from_jax(tf0.F0Estimator(2, 4, 4), params)
    with torch.no_grad():
        pf0, pvoiced = port(torch.from_numpy(x))
    assert pf0.shape == (2, 64, 1)
    assert_rel(pf0, f0, GRAD_RTOL, "f0")
    assert_rel(pvoiced, voiced, GRAD_RTOL, "voiced")


# --- checkpoints and the train step ---------------------------------------------------


def options_tiny(bot_wn=True):
    tiny = copy.deepcopy(TINY)
    if not bot_wn:
        tiny["model"]["generator"]["weight_norm"] = {"bottleneck": None}
    return jcfg.load_config(None, tiny), load_config(None, tiny)


@pytest.mark.parametrize("bot_wn", [True, False])
def test_reference_pt_of_the_options_config(bot_wn, tmp_path):
    """``step{E}-G.pt`` of the options config as the JAX package writes it
    for the same weights, key for key and bit for bit (the bottleneck's
    entries, weight-normed or plain); neither table has rows for the norm
    layers, so the CIN parameters are in neither file. The file imported
    back into a port G gives every tensor but the CIN's."""
    jc, pc = options_tiny(bot_wn)
    jax_g = jg.generator_from_config(jc.model.generator, NUM_SPK)
    x = jnp.zeros((1, SEG, 1))
    params = random_params(jax_g, x, jnp.zeros((1, NUM_SPK)), None, x, seed=20)
    port = weights.generator_from_jax(
        tg.generator_from_config(pc.model.generator, NUM_SPK, "cpu"), params)
    entries = pti.generator_entries_from_config(pc.model.generator)
    assert [e.torch_prefix for e in entries] == [
        e.torch_prefix for e in jti.generator_entries_from_config(jc.model.generator)]
    path = tmp_path / "step0-G.pt"
    jti.save_torch_file(jti.flax_to_torch(params, jti.generator_entries_from_config(
        jc.model.generator)), path)
    a = torch.load(path, weights_only=False)
    b = pti.port_to_torch(port.state_dict(), entries)
    assert list(a) == list(b)
    assert ("bottleneck.1.cond_var.2.weight_v" in a) == bot_wn
    assert ("bottleneck.1.cond_var.2.weight" in a) == (not bot_wn)
    assert not any("norm" in k for k in a)
    for k in a:
        assert np.array_equal(a[k].numpy(), b[k]), k
    fresh = tg.generator_from_config(pc.model.generator, NUM_SPK, "cpu", seed=5)
    msg = pckpt.import_torch_generator(pc, path, fresh)
    assert sorted(msg["missing_keys"]) == sorted(
        "params/" + k.replace(".", "/") for k in fresh.state_dict() if "_norm." in k)
    for k, v in fresh.state_dict().items():
        if "_norm." not in k:
            assert torch.equal(v, port.state_dict()[k]), k


def tiny_batch(seed):
    rng = np.random.default_rng(seed)
    sig = (0.2 * rng.standard_normal((2, SEG))).astype(np.float32)
    return {"signal": torch.from_numpy(sig),
            "corrupted": torch.from_numpy(sig + 0.05 * rng.standard_normal(sig.shape)
                                          .astype(np.float32)),
            "label": torch.tensor([0, 2])}


def tiny_state(cfg, seed):
    G, D, C = ploop.build_models(cfg, NUM_SPK, "cpu", seed=seed)
    return create_train_state(cfg, G, D, C, ploop.build_crepe(cfg, device="cpu"))


def test_options_train_step_save_restore(tmp_path):
    """One port train step of the tiny options config on the CPU: finite
    losses, every bottleneck and CIN parameter with a nonzero gradient and
    moved; the full train state saved and restored into a state from other
    seeds, bit for bit, and the next step the same on both."""
    _, cfg = options_tiny()
    a = tiny_state(cfg, seed=1)
    before = {n: p.detach().clone() for n, p in a.G.named_parameters()}
    metrics = build_train_step(cfg, a)(tiny_batch(1), torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())
    opts = [(n, p) for n, p in a.G.named_parameters()
            if n.startswith("bottleneck_") or "_norm." in n]
    assert len(opts) == 2 * 12 + 5 * 2
    for n, p in opts:
        assert p.grad is not None and float(p.grad.abs().max()) > 0, n
        assert not torch.equal(p.detach(), before[n]), n
    pckpt.save_state(a, tmp_path, 0)
    b = tiny_state(cfg, seed=2)
    assert ploop.state_digest(b) != ploop.state_digest(a)
    pckpt.restore_state(b, tmp_path)
    assert ploop.state_digest(b) == ploop.state_digest(a)
    ma = build_train_step(cfg, a)(tiny_batch(2), torch.Generator().manual_seed(5))
    mb = build_train_step(cfg, b)(tiny_batch(2), torch.Generator().manual_seed(5))
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_options_generator_gradients_against_jax():
    """G's forward and backward on the tiny options config against
    jax.grad of the same loss (a fixed cotangent on wav, subsamples and
    content): every parameter's gradient per tensor within G_RTOL of its
    max|ref|, the bottleneck's and the CIN's nonzero. (The whole step is not
    compiled again in JAX: the step's other pieces are held against it in
    tests/test_torch_port_train_step.py.)"""
    x, c_tgt, _, c_var = inputs(21)
    jax_g = jax_generator(**OPTIONS_KW)
    params = random_params(jax_g, x, c_tgt, None, c_var, seed=22)
    rng = np.random.default_rng(23)
    outs = jax.eval_shape(jax_g.apply, params, x, c_tgt, None, c_var)
    cots = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), outs)

    def loss(p):
        got = jax_g.apply(p, x, c_tgt, None, c_var)
        return sum(jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                                  jax.tree_util.tree_leaves(cots)))

    grads = jax.jit(jax.grad(loss))(params)
    port = weights.generator_from_jax(port_generator(**OPTIONS_KW), params)
    got = port(torch.from_numpy(x), torch.from_numpy(c_tgt), torch.from_numpy(c_var))
    flat = [got[0], *got[1], got[2]]
    want = [cots[0], *cots[1], cots[2]]
    sum((a * torch.from_numpy(np.asarray(b))).sum() for a, b in zip(flat, want)).backward()
    assert_param_grads(port, grads, G_RTOL, names=("bottleneck_", "decoder.stage_0_norm"))


@pytest.mark.parametrize("field,value", [("norm_layer", "batch_norm"),
                                         ("weight_norm", "spectral_norm")])
@pytest.mark.parametrize("sub", ["encoder", "decoder", "bottleneck"])
def test_validate_refuses_what_jax_refuses(field, value, sub):
    """Both loaders refuse an unknown norm_layer.* or weight_norm.* value
    with the same message."""
    over = {"model": {"generator": {field: {sub: value}}}}
    with pytest.raises(ValueError) as jax_err:
        jcfg.load_config(None, over)
    with pytest.raises(ValueError) as port_err:
        load_config(None, over)
    assert str(port_err.value) == str(jax_err.value) == f"unknown {field}.{sub}={value!r}"
    ok = {"model": {"generator": {field: {sub: "instance_norm" if field == "norm_layer"
                                          else None}}}}
    jcfg.load_config(None, ok)
    load_config(None, ok)
