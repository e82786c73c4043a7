"""bf16 mixed precision (``train.compute_dtype: bfloat16``) in the port,
against the JAX package's bf16 compute scope.

Parameters are made with numpy from a seed in the flax trees' shapes and
carried into the port by ``weights.py``; inputs are numpy arrays from a seed.
bf16 rounds at other points in the two frameworks (a fused conv bias here, a
separate bf16 add there), so a model's output is held to the size of bf16's
own error: for each output,

    max|port_bf16 - jax_bf16| <= max(2 * max|jax_bf16 - jax_f32|, ulp) + 1e-6,

with every output in f32, where ulp is one bf16 ulp at max|jax_bf16|: two
correctly rounded bf16 results of one sum taken in two orders may differ by
one ulp where the sum lies near a rounding boundary, while the JAX package's
own error at its largest element may be under half an ulp (a single conv).
The cond chain's plain bf16 version rounds at exactly the Pallas kernel's
points, so against the kernel (interpret mode) and against an emulation of
K1-bf16's arithmetic it is held to one bf16 ulp
(all but ``ULP_SHARE`` of the elements) and max|d| <= 2^-7 of max|ref|, on
dyadic operands whose cond_0 sums are exact in any order.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.inference import Converter as JaxConverter
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models import discriminator as jd
from td_vc_gan_tpu.models import generator as jg
from td_vc_gan_tpu.models import latent_classifier as jlc
from td_vc_gan_tpu.models import layers as jl
from td_vc_gan_tpu.models import wavlm as jw
from td_vc_gan_tpu.ops.pallas import cond_chain as jcc
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.cli import train as train_cli
from td_vc_gan_tpu_torch.config import Config, load_config
from td_vc_gan_tpu_torch.inference import Converter
from td_vc_gan_tpu_torch.models import discriminator as td
from td_vc_gan_tpu_torch.models import generator as tg
from td_vc_gan_tpu_torch.models import latent_classifier as tlc
from td_vc_gan_tpu_torch.models import layers as tl
from td_vc_gan_tpu_torch.models import wavlm as tw
from td_vc_gan_tpu_torch.models.crepe import Crepe
from td_vc_gan_tpu_torch.ops.cuda import cond_chain

torch.set_num_threads(1)

BF = torch.bfloat16
ULP_SHARE = 1e-2        # elements allowed beyond one bf16 ulp of the reference
MAX_REL = 2.0 ** -7     # max|d| of max|ref|
RATIOS, CHANNELS = (10, 4, 2, 2), (16, 16, 8, 8, 4)
WAVLM_RATIOS = (10, 8, 2, 2)
TINY_WAVLM = dict(
    extractor_mode="layer_norm", encoder_layers=2, encoder_embed_dim=32,
    encoder_ffn_embed_dim=64, encoder_attention_heads=4, layer_norm_first=True,
    conv_feature_layers=((16, 10, 5),) + ((16, 3, 2),) * 4 + ((16, 2, 2),) * 2,
    conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=80,
)


def random_params(module, *args, seed=0):
    """A flax parameter tree for ``module`` filled from numpy: weight-norm
    gains and norm scales in [0.5, 1.5], biases ~ 0.1 N(0, 1), other kernels
    ~ 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if any(k in name for k in ("'g'", "'scale'", "pos_conv_g", "grep_a")):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.1 if "bias" in name else 0.3
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_in(dtype, fn, *args):
    """``fn(*args)`` traced and run under the JAX package's compute scope (a
    fresh jit, so no trace of another dtype is reused)."""
    with jl.compute_dtype_scope(dtype):
        return jax.jit(lambda *a: fn(*a))(*args)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_bf16_error(port, jax_bf16, jax_f32, name=""):
    """The module-level tolerance: 2x bf16's own error (at least one bf16
    ulp of the largest element), outputs in f32."""
    p, b, f = np32(port), np32(jax_bf16), np32(jax_f32)
    assert p.shape == b.shape == f.shape, name
    ulp = np.ldexp(1.0, np.frexp(np.abs(b).max())[1] - 8)
    bound = max(2 * np.abs(b - f).max(), ulp) + 1e-6
    assert np.abs(p - b).max() <= bound, (name, np.abs(p - b).max(), bound)


def assert_ulp(got, want, name=""):
    """Within one bf16 ulp of ``want`` for all but ULP_SHARE of the
    elements, and max|d| <= MAX_REL of max|want|."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, name
    d = np.abs(g - w)
    _, e = np.frexp(w)
    ulp = np.where(w == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))
    assert np.mean(d > ulp) <= ULP_SHARE, (name, np.mean(d > ulp))
    assert d.max() <= MAX_REL * np.abs(w).max(), (name, d.max(), np.abs(w).max())


# --- 1. the scope ------------------------------------------------------------


def test_scope_nests_restores_and_rejects_unknown_dtypes():
    """As the JAX package's scope (tests/test_layers.py): bf16 inside, None
    and 'float32' no-ops, the previous dtype back on exit, KeyError for a
    dtype the policy does not have; finalize_dtype casts to f32 only inside
    a scope."""
    assert tl.get_compute_dtype() is None
    x = torch.ones(3, dtype=BF)
    assert tl.finalize_dtype(x) is x
    with tl.compute_dtype_scope("bfloat16"):
        assert tl.get_compute_dtype() == BF
        with tl.compute_dtype_scope(None):
            assert tl.get_compute_dtype() is None
        with tl.compute_dtype_scope("float32"):
            assert tl.get_compute_dtype() is None
        assert tl.get_compute_dtype() == BF
        assert tl.finalize_dtype(x).dtype == torch.float32
        assert tl.finalize_dtype(None) is None
    assert tl.get_compute_dtype() is None
    for scope in (tl.compute_dtype_scope, jl.compute_dtype_scope):
        with pytest.raises(KeyError):
            scope("float16")


# --- 2. the conv layers --------------------------------------------------------

CONV_CASES = {
    "reflect": dict(cin=4, cout=6, k=7, padding=3, pad_mode="reflect"),
    "dilated": dict(cin=6, cout=6, k=3, dilation=5, padding=5, pad_mode="reflect"),
    "grouped_strided": dict(cin=8, cout=16, k=41, stride=4, groups=2, padding=20),
    "strided": dict(cin=1, cout=8, k=20, stride=10, padding=5),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_wnconv1d_bf16(case):
    kw = dict(CONV_CASES[case])
    cin, cout, k = kw.pop("cin"), kw.pop("cout"), kw.pop("k")
    x = np.random.default_rng(1).standard_normal((2, 120, cin)).astype(np.float32)
    mod = jl.WNConv1d(cout, k, **kw)
    params = random_params(mod, x)
    want = jax_in("bfloat16", mod.apply, params, x)
    ref = jax_in(None, mod.apply, params, x)
    port = weights.generator_from_jax(tl.WNConv1d(cin, cout, k, **kw), params)
    with torch.no_grad(), tl.compute_dtype_scope("bfloat16"):
        got = port(torch.from_numpy(x).transpose(1, 2))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_bf16_error(got.transpose(1, 2), want, ref, case)


@pytest.mark.parametrize("stride,k,pad,out_pad", [(4, 8, 2, 0), (5, 10, 3, 1)])
def test_wnconv_transpose1d_bf16(stride, k, pad, out_pad):
    x = np.random.default_rng(2).standard_normal((2, 30, 6)).astype(np.float32)
    mod = jl.WNConvTranspose1d(4, k, stride, padding=pad, output_padding=out_pad)
    params = random_params(mod, x)
    want = jax_in("bfloat16", mod.apply, params, x)
    ref = jax_in(None, mod.apply, params, x)
    port = weights.generator_from_jax(
        tl.WNConvTranspose1d(6, 4, k, stride, padding=pad, output_padding=out_pad), params)
    with torch.no_grad(), tl.compute_dtype_scope("bfloat16"):
        got = port(torch.from_numpy(x).transpose(1, 2))
    assert got.dtype == BF
    assert_bf16_error(got.transpose(1, 2), want, ref)


# --- 3. the plain bf16 chain -------------------------------------------------------


def dyadic_chain(b, t, cc, n, two_c, seed):
    """Concat-form operands whose values bf16 holds exactly and whose cond_0
    sums are exact in f32 in any order: c in 1/8 steps, w0 and b0 in 1/256
    steps (b0 offset by 1/4096), so every element takes the same leaky_relu
    slope in the kernel and in the plain version."""
    rng = np.random.default_rng(seed)

    def steps(shape, step, scale):
        return (np.round(scale * rng.standard_normal(shape) / step) * step).astype(np.float32)

    c = steps((b, t, cc), 1 / 8, 0.5)
    w0 = steps((3, cc, n * cc), 1 / 256, 0.1)
    b0 = steps((n * cc,), 1 / 256, 0.05) + np.float32(1 / 4096)
    w1 = (0.2 * rng.standard_normal((3, cc, n * two_c))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((n * two_c,))).astype(np.float32)
    return [torch.from_numpy(a).to(BF) for a in (c, w0, b0, w1, b1)]


def test_plain_bf16_chain_against_the_pallas_kernel():
    """The plain bf16 chain (concat form) and every gradient against
    ``film_cond_chain(..., interpret=True)``, the Pallas kernel on bf16
    operands (f32 accumulation, lrelu(h) and the output rounded once; the
    weight grads summed in f32 and cast once). The grads come back in bf16."""
    n, two_c = 3, 8
    ops = dyadic_chain(2, 64, 12, n, two_c, seed=3)
    jops = [jnp.asarray(np32(a), jnp.bfloat16) for a in ops]
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 64, n * two_c)).astype(np.float32)).to(BF)

    def kernel(*a):
        return jcc.film_cond_chain(*a, interpret=True)[..., :n * two_c]

    want, vjp = jax.vjp(kernel, *jops)
    got = cond_chain.film_cond_chain(*ops)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert_ulp(got, want, "out")
    jgrads = vjp(jnp.asarray(np32(g), jnp.bfloat16))
    grads = cond_chain.cond_chain_bwd_plain(ops[0], ops[1], ops[2], ops[3], g)
    for name, jgrad in zip(("exc", "w0", "hbias", "w1", "b1"), jgrads):
        assert grads[name].dtype == BF and jgrad.dtype == jnp.bfloat16, name
        assert_ulp(grads[name], jgrad, name)


def test_mrf_split_chain_bf16_against_jax():
    """The port's MRFBlock under the bf16 scope (its films through the split
    chain's plain bf16 version on the CPU, gradients through
    ``cond_chain_bwd_plain``) against the JAX MRFBlock's split path under the
    scope: the block's output and the gradients of x, spk and exc at the
    module tolerance, every cond weight's gradient as stated below."""
    rng = np.random.default_rng(5)
    c, s, e, t = 6, 6, 4, 40
    x = (0.5 * rng.standard_normal((2, t, c))).astype(np.float32)
    spk = rng.standard_normal((2, s)).astype(np.float32)
    exc = rng.standard_normal((2, t, e)).astype(np.float32)
    cot = rng.standard_normal((2, t, c)).astype(np.float32)
    kw = dict(dilations=(1, 2), kernel_sizes=(3, 5))
    mod = jl.MRFBlock(c, s + e, **kw)
    params = random_params(mod, x, (spk, exc), seed=6)

    def jax_grads(dtype):
        def loss(p, x, spk, exc):
            return jnp.sum(mod.apply(p, x, (spk, exc)).astype(jnp.float32) * cot)

        with jl.compute_dtype_scope(dtype):
            out = jax.jit(lambda *a: mod.apply(*a))(params, x, (spk, exc))
            grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(params, x, spk, exc)
        return out, grads

    want, jgrads = jax_grads("bfloat16")
    ref, rgrads = jax_grads(None)
    port = weights.generator_from_jax(tl.MRFBlock(c, s + e, **kw), params)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, spk, exc)]
    with tl.compute_dtype_scope("bfloat16"):
        out = port(leaves[0].transpose(1, 2), (leaves[1], leaves[2].transpose(1, 2)))
    # an f32 input keeps the residual sum f32 in both packages
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    assert_bf16_error(out.transpose(1, 2), want, ref, "out")
    (out.transpose(1, 2).float() * torch.from_numpy(cot)).sum().backward()
    for name, leaf, wg, rg in zip(("x", "spk", "exc"), leaves, jgrads[1:], rgrads[1:]):
        assert leaf.grad.dtype == torch.float32
        assert_bf16_error(leaf.grad, wg, rg, name)
    layout = weights._conv_layout(port)
    jflat = {k: layout(k, v) for k, v in weights._params(
        jax.tree_util.tree_map(np.asarray, jgrads[0])).items()}
    rflat = {k: layout(k, v) for k, v in weights._params(
        jax.tree_util.tree_map(np.asarray, rgrads[0])).items()}
    # a weight's gradient sums B*T terms of both signs, so its bf16 error
    # varies from tensor to tensor in either package (1% to 20% of max|ref|
    # here): each is held to twice the largest relative bf16 error of the
    # JAX cond-weight gradients
    cond = [(k, p) for k, p in port.named_parameters() if ".cond_" in k]
    assert len(cond) == 2 * 3 * 4
    bf16_err = max(np.abs(jflat[k] - rflat[k]).max() / np.abs(rflat[k]).max() for k, _ in cond)
    for k, p in cond:
        assert p.grad.dtype == torch.float32
        err = np.abs(np32(p.grad) - jflat[k]).max() / np.abs(rflat[k]).max()
        assert err <= 2 * bf16_err + 1e-6, (k, err, bf16_err)


# --- 4. K1-bf16's arithmetic, emulated ---------------------------------------------


def bf16_round(x):
    """f32 -> the nearest bf16 (ties to even), as f32 (finite x)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def k1_bf16_emulated(exc, w0, hbias, w1, b1, edge0, edge_t):
    """K1-bf16's arithmetic in numpy as its first version took it: bf16
    operands, products summed in f32 one m16n8k16 depth (16 terms) at a
    time, tap by tap, the bias and edges added in f32, lrelu(h) rounded to
    bf16 once, the output b1 + sum rounded once. (The Hopper kernels' tiling
    and order: tests/test_torch_port_bf16_tiles.py.)"""
    b, t, e = exc.shape
    cc = w1.shape[1]
    n = w0.shape[2] // cc

    def conv3(x, w):  # x (B, T, K) f32, w (3, K, N): K-chunks of 16, tap by tap
        xp = np.pad(x, ((0, 0), (1, 1), (0, 0)))
        acc = np.zeros((b, t, w.shape[2]), np.float32)
        for j in range(3):
            for k0 in range(0, x.shape[2], 16):
                acc = acc + xp[:, j:j + t, k0:k0 + 16] @ w[j, k0:k0 + 16]
        return acc

    h = conv3(exc, w0) + hbias[:, None, :]
    h[:, 0] -= edge0
    h[:, t - 1] -= edge_t
    a = bf16_round(np.where(h >= 0, h, np.float32(0.2) * h))
    two_c = w1.shape[2] // n
    out = np.concatenate([conv3(a[..., i * cc:(i + 1) * cc], w1[..., i * two_c:(i + 1) * two_c])
                          for i in range(n)], -1)
    return bf16_round(b1 + out)


@pytest.mark.parametrize("e,cc", [(8, 20), (16, 36)])
def test_k1_bf16_arithmetic_emulated(e, cc):
    """The plain bf16 version (split form) against a numpy emulation of
    K1-bf16's arithmetic on the same bf16 operands: within one bf16 ulp, the
    premise that holds the kernel to the plain version on the card."""
    rng = np.random.default_rng(e + cc)
    b, t, n, two_c = 2, 50, 3, 8

    def r(*shape, scale=0.3):
        return bf16_round((scale * rng.standard_normal(shape)).astype(np.float32))

    ops = dict(exc=r(b, t, e), w0=r(3, e, n * cc), hbias=r(b, n * cc), w1=r(3, cc, n * two_c),
               b1=r(n * two_c, scale=0.1), edge0=r(b, n * cc), edge_t=r(b, n * cc))
    want = k1_bf16_emulated(**ops)
    got = cond_chain.cond_chain_plain(**{k: torch.from_numpy(v).to(BF) for k, v in ops.items()})
    assert got.dtype == BF
    assert_ulp(got, want)


# --- 5. the dispatch ----------------------------------------------------------------


class FakeLib:
    """A kernel library stand-in that records which entry point ran."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((self.name, entry))
            if entry.endswith("_tile") or entry.endswith("_rows"):
                return 128
            if entry.endswith("_workspace"):
                return 64
            return 0

        return fn


@pytest.fixture
def mocked_kernels(monkeypatch):
    """CPU tensors routed to the kernel path, the libraries replaced by
    recorders and the plain versions made to fail if called."""
    calls = []
    libs = {name: FakeLib(name, calls) for name in ("fwd", "bwd", "fwd_bf16", "bwd_bf16")}
    monkeypatch.setattr(cond_chain, "_library", lambda: libs)
    monkeypatch.setattr(cond_chain, "_use_kernels", lambda exc: True)
    monkeypatch.setattr(cond_chain, "_stream", lambda dev: 0)

    def never(*a, **k):
        raise AssertionError("the plain version ran on the kernel route")

    monkeypatch.setattr(cond_chain, "cond_chain_plain", never)
    monkeypatch.setattr(cond_chain, "cond_chain_bwd_plain", never)
    return calls


def split_ops(dtype):
    ops = dyadic_chain(2, 24, 8, 2, 8, seed=7)
    c, w0, b0, w1, b1 = (a.to(dtype) for a in ops)
    return dict(exc=c, w0=w0, hbias=torch.zeros(2, 16, dtype=dtype), w1=w1, b1=b1,
                edge0=torch.zeros(2, 16, dtype=dtype), edge_t=torch.zeros(2, 16, dtype=dtype))


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, ""), (BF, "_bf16")])
def test_dispatch_takes_the_instance_of_the_dtype(mocked_kernels, dtype, suffix):
    calls = mocked_kernels
    before = cond_chain.kernel_launches("bfloat16" if dtype == BF else "float32")
    ops = {k: v.requires_grad_() for k, v in split_ops(dtype).items()}
    out = cond_chain.cond_chain(**ops)
    assert out.dtype == dtype
    out.float().sum().backward()
    entries = [entry for lib, entry in calls if entry.startswith("cond_chain_fwd")
               and not entry.endswith(("_tile", "_workspace"))] + [
        entry for lib, entry in calls if entry.startswith("cond_chain_bwd")
        and not entry.endswith(("_rows", "_workspace"))]
    want = ["cond_chain_fwd_bf16", "cond_chain_bwd_bf16"] if suffix else [
        "cond_chain_fwd_f32", "cond_chain_bwd_f32"]
    assert entries == want
    assert {lib for lib, _ in calls} == ({"fwd_bf16", "bwd_bf16"} if suffix else {"fwd", "bwd"})
    after = cond_chain.kernel_launches("bfloat16" if dtype == BF else "float32")
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for k, v in ops.items():
        assert v.grad.dtype == dtype, k


def test_dispatch_rejects_mixed_and_other_dtypes(mocked_kernels):
    ops = split_ops(BF)
    for name in ("w0", "hbias", "w1", "b1", "edge0"):
        mixed = dict(ops, **{name: ops[name].float()})
        with pytest.raises(TypeError, match="one dtype"):
            cond_chain.cond_chain(**mixed)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cond_chain.cond_chain(**{k: v.half() for k, v in ops.items()})
    assert mocked_kernels == []


def test_bf16_libraries_are_keyed_on_their_headers(tmp_path):
    """The bf16 instances' libraries hash their sources and headers: editing
    their shared header rebuilds both of them and neither f32 library; K2-bf16
    no longer includes tf32x3.cuh (its weight grads left cp.async), so
    editing that header rebuilds neither bf16 library."""
    import shutil

    for src in (*cond_chain.SOURCES, *cond_chain.BF16_SOURCES,
                *cond_chain.SOURCES[0].parent.glob("*.cuh")):
        shutil.copy(src, tmp_path / src.name)
    fwd, bwd = (tmp_path / s.name for s in cond_chain.BF16_SOURCES)
    assert {p.name for p in cond_chain._sources_of(fwd)} == {
        "cond_chain_bf16.cu", "cond_chain_bf16.cuh", "hopper_bf16.cuh"}
    assert {p.name for p in cond_chain._sources_of(bwd)} == {
        "cond_chain_bwd_bf16.cu", "cond_chain_bf16.cuh", "hopper_bf16.cuh"}
    f32 = [tmp_path / s.name for s in cond_chain.SOURCES]
    before = [cond_chain._lib_path(x) for x in (fwd, bwd, *f32)]
    (tmp_path / "cond_chain_bf16.cuh").write_text(
        (tmp_path / "cond_chain_bf16.cuh").read_text() + "\n")
    after = [cond_chain._lib_path(x) for x in (fwd, bwd, *f32)]
    assert after[0] != before[0] and after[1] != before[1] and after[2:] == before[2:]
    (tmp_path / "tf32x3.cuh").write_text((tmp_path / "tf32x3.cuh").read_text() + "\n")
    again = [cond_chain._lib_path(x) for x in (fwd, bwd, *f32)]
    assert again[:2] == after[:2] and all(x != y for x, y in zip(again[2:], after[2:]))


# --- 6. the models in bf16 -----------------------------------------------------------


def jax_generator(encoder="conv", **kw):
    common = dict(num_bottleneck_layers=0, num_classes=4, conditional_dim=8, content_dim=8,
                  kernel_sizes=(3, 5), dilations=(1, 2))
    if encoder == "wavlm":
        return jg.Generator(decoder_ratios=WAVLM_RATIOS, decoder_channels=CHANNELS,
                            encoder_model="wavlm", num_enc_layers=2,
                            wavlm_cfg=jw.WavLMConfig(**TINY_WAVLM, **kw), **common)
    return jg.Generator(decoder_ratios=RATIOS, decoder_channels=CHANNELS, **common)


def port_generator(encoder="conv", compute_dtype=None):
    kw = dict(kernel_sizes=(3, 5), dilations=(1, 2))
    if encoder == "wavlm":
        return tg.Generator(WAVLM_RATIOS, CHANNELS, 4, 8, 8, encoder_model="wavlm",
                            num_enc_layers=2, wavlm_cfg=tw.WavLMConfig(
                                **TINY_WAVLM, compute_dtype=compute_dtype), **kw)
    return tg.Generator(RATIOS, CHANNELS, 4, 8, 8, **kw)


@pytest.mark.parametrize("encoder", ["conv", "wavlm"])
def test_generator_bf16(encoder):
    """The whole generator in bf16 (a WavLM encoder's backbone with
    ``compute_dtype="bfloat16"``, as generator_from_config gives it) against
    the JAX Generator in bf16; wav, subsamples and content in f32."""
    rng = np.random.default_rng(8)
    x = (0.3 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[[1, 3]]
    c_var = (0.1 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    g32, g16 = jax_generator(encoder), jax_generator(encoder, compute_dtype="bfloat16")
    params = random_params(g32, x, onehot, None, x, seed=9)
    want = jax_in("bfloat16", g16.apply, params, x, onehot, None, c_var)
    ref = jax_in(None, g32.apply, params, x, onehot, None, c_var)
    port = weights.generator_from_jax(port_generator(encoder, "bfloat16"), params)
    with torch.no_grad(), tl.compute_dtype_scope("bfloat16"):
        got = port(torch.from_numpy(x), torch.from_numpy(onehot), torch.from_numpy(c_var))
    for name, a, w, r in (("wav", got[0], want[0], ref[0]),
                          ("content", got[2], want[2], ref[2])) + tuple(
            (f"sub{i}", a, w, r) for i, (a, w, r) in enumerate(zip(got[1], want[1], ref[1]))):
        assert a.dtype == torch.float32 and w.dtype == jnp.float32, name
        assert_bf16_error(a, w, r, name)


def test_wavlm_backbone_bf16():
    """WavLM alone with ``compute_dtype="bfloat16"`` (bf16 convs and dense
    layers, f32 norms and softmax) against the JAX backbone's, f32 output."""
    wav = (0.3 * np.random.default_rng(10).standard_normal((2, 1600))).astype(np.float32)
    j32, j16 = jw.WavLM(jw.WavLMConfig(**TINY_WAVLM)), jw.WavLM(
        jw.WavLMConfig(**TINY_WAVLM, compute_dtype="bfloat16"))
    params = random_params(j32, wav, seed=11)
    want, ref = jax.jit(j16.apply)(params, wav), jax.jit(j32.apply)(params, wav)
    port = weights.generator_from_jax(
        tw.WavLM(tw.WavLMConfig(**TINY_WAVLM, compute_dtype="bfloat16")), params)
    f32 = weights.generator_from_jax(tw.WavLM(tw.WavLMConfig(**TINY_WAVLM)), params)
    with torch.no_grad():
        got = port(torch.from_numpy(wav))
    assert got.dtype == torch.float32
    assert_bf16_error(got, want, ref)
    assert tw.wavlm_digest(port) == tw.wavlm_digest(f32)  # f32 weights either way


def test_discriminator_and_classifier_bf16():
    """The 3-band discriminator (logits and every feature map) and the
    latent classifier in bf16 against the JAX modules in bf16, in f32."""
    rng = np.random.default_rng(12)
    x = (0.3 * rng.standard_normal((2, 1280, 1))).astype(np.float32)
    labels = np.array([1, 3], np.int32)
    mod = jd.CollaborativeMultibandDiscriminator(num_disc=3, num_classes=4, num_channels_base=4)
    subs = [(0.3 * rng.standard_normal((2, 1280 // d, 1))).astype(np.float32) for d in (4, 2)]
    params = random_params(mod, x, labels, subs, seed=13)
    want = jax_in("bfloat16", mod.apply, params, x, labels, subs)
    ref = jax_in(None, mod.apply, params, x, labels, subs)
    port = weights.discriminator_from_jax(
        td.CollaborativeMultibandDiscriminator(3, 4, num_channels_base=4), params)
    with torch.no_grad(), tl.compute_dtype_scope("bfloat16"):
        outs, feats = port(torch.from_numpy(x), torch.from_numpy(labels),
                           [torch.from_numpy(s) for s in subs])
    for i, (a, w, r) in enumerate(zip(outs, want[0], ref[0])):
        assert a.dtype == torch.float32
        assert_bf16_error(a, w, r, f"logits {i}")
    for i, (fa, fw, fr) in enumerate(zip(feats, want[1], ref[1])):
        for j, (a, w, r) in enumerate(zip(fa, fw, fr)):
            assert a.dtype == torch.float32
            assert_bf16_error(a.transpose(1, 2), w, r, f"features {i}.{j}")

    cont = (0.3 * rng.standard_normal((2, 8, 8))).astype(np.float32)
    cmod = jlc.LatentClassifier(num_classes=4)
    cparams = random_params(cmod, cont, seed=14)
    want = jax_in("bfloat16", cmod.apply, cparams, cont)
    ref = jax_in(None, cmod.apply, cparams, cont)
    cport = weights.classifier_from_jax(tlc.LatentClassifier(8, 4), cparams)
    with torch.no_grad(), tl.compute_dtype_scope("bfloat16"):
        got = cport(torch.from_numpy(cont))
    assert got.dtype == torch.float32
    assert_bf16_error(got, want, ref, "classifier")


# --- 7. the slice: conversion --------------------------------------------------------


def jax_draws(seed: int, shape):
    """The start phase and noise the JAX Converter draws for ``seed``."""
    k_phase, k_noise = jax.random.split(jax.random.PRNGKey(seed))
    start = float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi)
    return start, np.array(jax.random.normal(k_noise, shape))


def signals():
    t = np.arange(2560) / 16000
    return np.stack([0.3 * np.sin(2 * np.pi * (150 + 400 * t) * t),
                     0.2 * np.sin(2 * np.pi * 220 * t)]).astype(np.float32)


@pytest.mark.parametrize("encoder", ["conv", "wavlm"])
def test_converter_bf16_against_jax(encoder):
    """``Converter(..., compute_dtype="bfloat16")`` against the JAX
    Converter's bf16 conversion with the same weights and draws; bf16's error
    is sized by the port's f32 conversion, which
    tests/test_torch_port_convert.py holds within 1e-4 of the JAX f32 one.
    ``compute_dtype="float32"`` on a bf16 config is bit for bit the f32
    path."""
    x = jnp.zeros((1, 1280, 1))
    g16 = jax_generator(encoder, compute_dtype="bfloat16")
    params = random_params(g16, x, jnp.zeros((1, 4)), None, x, seed=15)
    crepe_params = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    cfg16 = jcfg.Config()
    cfg16.train.compute_dtype = "bfloat16"
    jconv = JaxConverter(cfg16, g16, params, crepe_params, decoder="viterbi")
    pcfg = Config()
    pcfg.train.compute_dtype = "bfloat16"
    crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray,
                                                                         crepe_params))
    port = weights.generator_from_jax(port_generator(encoder, "bfloat16"), params)
    conv = Converter(pcfg, port, crepe, decoder="viterbi", device="cpu")
    assert conv.compute_dtype == "bfloat16"
    sigs = signals()
    labels = np.array([2, 1], np.int32)
    f0, mu = jconv.pitch_batch(sigs)
    mu_tgt = mu + np.log(1.3).astype(np.float32)
    want = jconv.convert_batch(sigs, labels, f0, mu, mu_tgt, seed=7)
    start, noise = jax_draws(7, sigs.shape)
    got = conv.convert_batch(sigs, labels, f0, mu, mu_tgt, start_phase=start, noise=noise)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    port32 = weights.generator_from_jax(port_generator(encoder), params)
    f32_path = Converter(Config(), port32, crepe, device="cpu").convert_batch(
        sigs, labels, f0, mu, mu_tgt, start_phase=start, noise=noise)
    assert_bf16_error(got, want, f32_path)
    if encoder == "conv":
        forced = Converter(pcfg, port, crepe, device="cpu", compute_dtype="float32")
        np.testing.assert_array_equal(
            forced.convert_batch(sigs, labels, f0, mu, mu_tgt, start_phase=start, noise=noise),
            f32_path)


def test_bf16_config_runs_bf16_inside_g():
    """The repair of the silently ignored compute_dtype: a bf16 config gives
    bf16 activations inside G, in conversion and in the train step (a hook
    on one conv of the decoder and one of the discriminator)."""
    from td_vc_gan_tpu_torch.models.crepe import crepe_from_seed
    from td_vc_gan_tpu_torch.models.discriminator import discriminator_from_config
    from td_vc_gan_tpu_torch.training.state import create_train_state
    from td_vc_gan_tpu_torch.training.step import build_train_step

    cfg = Config()
    cfg.train.compute_dtype = "bfloat16"
    g = cfg.model.generator
    g.decoder_ratios, g.decoder_channels = [10, 4, 2, 2], [16, 16, 8, 8, 4]
    g.content_dim = g.conditional_dim = 8
    g.mrf_kernel_sizes, g.mrf_dilations = [3], [1]
    cfg.model.discriminator.num_channels_base = 4
    cfg.train.max_segment = 1280
    cfg.train.mel_fft_sizes = [512]
    G = tg.generator_from_config(g, 4, device="cpu", compute_dtype="bfloat16")
    seen = []
    G.decoder.output_conv.register_forward_hook(lambda m, i, o: seen.append(("G", o.dtype)))
    conv = Converter(cfg, G, crepe_from_seed(0), device="cpu")
    sig = signals()
    f0, mu = conv.pitch_batch(sig)
    conv.convert_batch(sig, np.array([0, 1]), f0, mu, mu, seed=0)
    assert seen == [("G", BF)]
    D = discriminator_from_config(cfg, 4, device="cpu", seed=1)
    D.disc_0.input.register_forward_hook(lambda m, i, o: seen.append(("D", o.dtype)))
    state = create_train_state(cfg, G, D, None, crepe_from_seed(2))
    step = build_train_step(cfg, state)
    seen.clear()
    rng = np.random.default_rng(0)
    batch = {"signal": torch.from_numpy((0.2 * rng.standard_normal((2, 1280))).astype(np.float32)),
             "corrupted": torch.from_numpy(
                 (0.2 * rng.standard_normal((2, 1280))).astype(np.float32)),
             "label": torch.tensor([0, 3])}
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert seen and set(seen) == {("G", BF), ("D", BF)}
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in metrics.values())
    for p in list(G.parameters()) + list(D.parameters()):
        assert p.dtype == torch.float32
        if p.grad is not None:
            assert p.grad.dtype == torch.float32


# --- 9. the CLIs ---------------------------------------------------------------------


def test_validate_takes_float32_and_bfloat16_only():
    assert load_config(overrides={"train": {"compute_dtype": "bfloat16"}}
                       ).train.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        load_config(overrides={"train": {"compute_dtype": "float16"}})


def test_train_cli_bf16_one_step_then_resume(tmp_path):
    """``--override train.compute_dtype=bfloat16`` through the train CLI on
    the CPU: one step (with bf16 activations in G), the config and the train
    state saved with bf16; a resume without the override runs in bf16 again
    and says so, and its saved config keeps bf16."""
    from td_vc_gan_tpu_torch.data.audio_io import write_audio
    import pickle

    entries = []
    for spk in range(2):
        for j in range(2):
            t = np.arange(6400) / 16000
            path = tmp_path / f"p{spk}_{j:03d}.wav"
            write_audio(path, 0.25 * np.sin(2 * np.pi * (120 + 60 * spk + 15 * j) * t), 16000)
            entries.append(f"{path}|p{spk}")
    (tmp_path / "train_files").write_text("\n".join(entries) + "\n")
    (tmp_path / "test_files").write_text(f"{entries[1]}\n")
    with open(tmp_path / "speakers", "wb") as f:
        pickle.dump([("p0", 0), ("p1", 1)], f)
    run = tmp_path / "run"
    argv = ["--save_path", str(run), "--data_path", str(tmp_path), "--device", "cpu"]
    for o in ("model.generator.decoder_ratios=[10,4,2,2]",
              "model.generator.decoder_channels=[16,16,8,8,4]",
              "model.generator.content_dim=8", "model.generator.conditional_dim=8",
              "model.generator.mrf_kernel_sizes=[3]", "model.generator.mrf_dilations=[1]",
              "model.discriminator.num_channels_base=4", "train.batch_size=4",
              "train.num_epoch=0", "train.max_segment=2560", "train.mel_fft_sizes=[512]",
              "train.num_workers=1", "test.max_segment=2560", "test.num_tests=1",
              "log.save_interval=1", "log.gen_interval=100", "log.val_interval=100",
              "log.log_interval=1"):
        argv += ["--override", o]

    def main(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train_cli.main(argv + extra)
        return out.getvalue().splitlines()

    seen = []
    hook = tl.WNConv1d.forward

    def spy(self, x):  # the convs that run in a compute scope (not the f32 sample dumps)
        y = hook(self, x)
        if tl.get_compute_dtype() is not None:
            seen.append(y.dtype)
        return y

    tl.WNConv1d.forward = spy
    try:
        first = main(["--override", "train.compute_dtype=bfloat16"])
    finally:
        tl.WNConv1d.forward = hook
    assert seen and set(seen) == {BF}
    assert load_config(run / "config.yaml").train.compute_dtype == "bfloat16"
    blob = torch.load(run / "torch_state" / "epoch_0.pt", weights_only=False)
    assert blob["compute_dtype"] == "bfloat16"
    assert all(v.dtype == torch.float32 for v in blob["G"].values())
    steps = [ln for ln in first if ln.startswith("Epoch ")]
    assert len(steps) == 1 and all(np.isfinite(float(v)) for v in re.findall(
        r"G_loss: (\S+?),", steps[0]))
    second = main(["--load_path", str(run), "--override", "train.num_epoch=1"])
    assert any(ln.startswith("train.compute_dtype bfloat16 from the train state of epoch 0")
               for ln in second)
    assert load_config(run / "config.yaml").train.compute_dtype == "bfloat16"
    assert [re.search(r"Itt (\d+)", s).group(1) for s in second
            if s.startswith("Epoch ")] == ["1"]
