"""The port's conv layers against the JAX package's flax modules.

Parameters are made with numpy from a seed in the flax tree's shapes
(``jax.eval_shape`` of ``init``) and carried into the port by
``weights.generator_from_jax``. Inputs come from the same seed. Tolerance:
atol = rtol = 1e-5 (f32 on both sides).
"""

import jax
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.models import layers as jl
from td_vc_gan_tpu.ops.pallas import cond_chain as jax_cond_chain
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models import layers as tl
from td_vc_gan_tpu_torch.ops.cuda import cond_chain
from td_vc_gan_tpu_torch.ops.dsp import reflect_pad

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


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
    """channels-last numpy -> (B, C, T) torch"""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def nwc(t):
    return t.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding=2, dilation=2),                        # zeros, dilated
    dict(kernel_size=4, padding="same"),                               # asymmetric 'same'
    dict(kernel_size=7, padding=9, dilation=3, pad_mode="reflect"),    # reflect, dilated
    dict(kernel_size=8, stride=4, padding=2),                          # strided
    dict(kernel_size=5, padding="same", groups=2, use_weight_norm=False),
    dict(kernel_size=7, padding=3, use_bias=False),
])
def test_wn_conv1d(kw):
    x = np.random.default_rng(1).standard_normal((2, 40, 6)).astype(np.float32)
    mod = jl.WNConv1d(features=4, **kw)
    params = random_params(mod, x)
    want = np.asarray(mod.apply(params, x))
    port = tl.WNConv1d(6, 4, **kw)
    weights.generator_from_jax(port, params)
    np.testing.assert_allclose(nwc(port(ncw(x))), want, **TOL)


@pytest.mark.parametrize("r", [2, 8, 10])
def test_wn_conv_transpose1d(r):
    x = np.random.default_rng(2).standard_normal((2, 9, 6)).astype(np.float32)
    kw = dict(kernel_size=2 * r, stride=r, padding=r // 2 + r % 2, output_padding=r % 2)
    mod = jl.WNConvTranspose1d(features=5, **kw)
    params = random_params(mod, x)
    want = np.asarray(mod.apply(params, x))
    port = tl.WNConvTranspose1d(6, 5, **kw)
    weights.generator_from_jax(port, params)
    got = nwc(port(ncw(x)))
    assert got.shape == (2, 9 * r, 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_linear():
    x = np.random.default_rng(3).standard_normal((3, 7)).astype(np.float32)
    mod = jl.Linear(features=5)
    params = random_params(mod, x)
    port = weights.generator_from_jax(tl.Linear(7, 5), params)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(mod.apply(params, x)), **TOL)


def test_film_resnet_block():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    gamma, beta = (0.3 * rng.standard_normal((2, 2, 30, 6))).astype(np.float32)
    mod = jl.FiLMResnetBlock(channels=6, dilation=3, kernel_size=5)
    params = random_params(mod, x, None, (gamma, beta))
    want = np.asarray(mod.apply(params, x, film=(gamma, beta)))
    port = weights.generator_from_jax(tl.FiLMResnetBlock(6, dilation=3, kernel_size=5), params)
    got = port(ncw(x), (ncw(gamma), ncw(beta)))
    np.testing.assert_allclose(nwc(got), want, **TOL)


@pytest.mark.parametrize("cond", [False, True])
def test_mrf_block(cond):
    """With cond: the (spk, exc) split form the decoder feeds, through the
    cond-chain op; without: the encoder's unconditioned MRF."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 4)).astype(np.float32)
    spk = rng.standard_normal((2, 6)).astype(np.float32)
    exc = rng.standard_normal((2, 32, 3)).astype(np.float32)
    cc = 9 if cond else 0
    kw = dict(dilations=(1, 3), kernel_sizes=(3, 5))
    mod = jl.MRFBlock(channels=4, cond_channels=cc, **kw)
    c = (spk, exc) if cond else None
    params = random_params(mod, x, c)
    want = np.asarray(mod.apply(params, x, c))
    port = weights.generator_from_jax(tl.MRFBlock(4, cc, **kw), params)
    got = port(ncw(x), (torch.from_numpy(spk), ncw(exc)) if cond else None)
    np.testing.assert_allclose(nwc(got), want, **TOL)


def test_init_weights_is_seeded_and_normalised():
    a = tl.init_weights(tl.WNConv1d(3, 4, 5), seed=7)
    b = tl.init_weights(tl.WNConv1d(3, 4, 5), seed=7)
    torch.testing.assert_close(a.v, b.v, rtol=0, atol=0)
    # g = ||v|| at init, so the effective weight is v
    torch.testing.assert_close(a.weight(), a.v, rtol=1e-6, atol=1e-6)
    assert float(a.v.detach().abs().max()) <= 1 / np.sqrt(15)


@pytest.mark.parametrize("t,kw", [
    (8, dict(kernel_size=11, dilation=5, padding=25)),   # the MRF's widest conv, pad >= T
    (2, dict(kernel_size=7, padding=3)),                 # the k7 input convs at T = 2
    (5, dict(kernel_size=15, padding=7)),                # the discriminator's input conv
    (6, dict(kernel_size=3, padding=(9, 2))),            # uneven, one side past T
])
def test_wn_conv1d_reflect_pad_not_shorter_than_t(t, kw):
    """Reflect padding of at least T reflects repeatedly, as the JAX layer's
    jnp.pad(mode='reflect') does."""
    x = np.random.default_rng(2).standard_normal((2, t, 3)).astype(np.float32)
    mod = jl.WNConv1d(features=4, pad_mode="reflect", **kw)
    params = random_params(mod, x, seed=3)
    want = np.asarray(mod.apply(params, x))
    port = tl.WNConv1d(3, 4, kw["kernel_size"], dilation=kw.get("dilation", 1),
                       padding=kw["padding"], pad_mode="reflect")
    port = weights.generator_from_jax(port, params)
    np.testing.assert_allclose(nwc(port(ncw(x))), want, **TOL)


def test_reflect_pad_matches_numpy_at_every_length():
    for t in range(2, 9):
        x = np.arange(2 * t, dtype=np.float32).reshape(2, 1, t)
        for left, right in ((0, 0), (1, 0), (t - 1, t - 1), (t, 3 * t + 1), (25, 25)):
            want = np.pad(x, ((0, 0), (0, 0), (left, right)), mode="reflect")
            np.testing.assert_array_equal(reflect_pad(torch.from_numpy(x), left, right).numpy(),
                                          want, err_msg=f"T={t} pads=({left}, {right})")
    with pytest.raises(ValueError, match="at least 2"):
        reflect_pad(torch.zeros(1, 1, 1), 1, 1)


def test_leaky_relu_gradient_matches_jax_at_exact_zeros():
    """The port's leaky_relu takes the slope 1 where its input is exactly 0
    (+0 and -0), as the JAX package's output-reading VJP does; torch's own
    leaky_relu takes 0.2 there. Compared exactly."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    x[:, ::7] = 0.0
    x[0, 3] = -0.0
    g = rng.standard_normal(x.shape).astype(np.float32)
    y_jax, vjp = jax.vjp(jl.leaky_relu, jax.numpy.asarray(x))
    (want,) = vjp(jax.numpy.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = tl.leaky_relu(xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zeros = x == 0
    np.testing.assert_array_equal(got.numpy()[zeros], g[zeros])
    (old,) = torch.autograd.grad(torch.nn.functional.leaky_relu(xt, 0.2), xt,
                                 torch.from_numpy(g))
    assert not np.array_equal(old.numpy()[zeros], g[zeros])


def test_film_resnet_block_gradients_match_jax_at_exact_zeros():
    """Gradients of one FiLMResnetBlock with exact zeros planted in both of
    its leaky_relu inputs: in x, and in h wherever gamma = -1 and beta = 0
    (h * (1 + gamma) + beta = 0). Tolerance as the module's."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    x[:, ::4, :] = 0.0
    gamma, beta = (0.3 * rng.standard_normal((2, 2, 30, 6))).astype(np.float32)
    gamma[:, 1::5, :] = -1.0
    beta[:, 1::5, :] = 0.0
    mod = jl.FiLMResnetBlock(channels=6, dilation=3, kernel_size=5)
    params = random_params(mod, x, None, (gamma, beta), seed=22)
    cot = rng.standard_normal((2, 30, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, gm, bt: mod.apply(params, a, film=(gm, bt)), x, gamma, beta)
    want = [np.asarray(w) for w in vjp(cot)]
    port = weights.generator_from_jax(tl.FiLMResnetBlock(6, dilation=3, kernel_size=5), params)
    leaves = [ncw(a).requires_grad_() for a in (x, gamma, beta)]
    out = port(leaves[0], (leaves[1], leaves[2]))
    got = torch.autograd.grad(out, leaves, ncw(cot))
    for name, a, w in zip(("x", "gamma", "beta"), got, want):
        np.testing.assert_allclose(nwc(a), w, err_msg=name, **TOL)
    # the planted zeros are where torch's own leaky_relu would have differed
    assert float(np.abs(want[0][:, ::4, :]).max()) > 0


def test_plain_cond_chain_gradients_match_jax_at_exact_zeros():
    """Autograd through cond_chain_plain (concat form) against the JAX
    package's custom VJP (the Pallas backward in interpret mode), with h
    exactly 0 planted: c is zero over t = 10..15, so h = b0 at t = 11..14,
    and a third of b0's columns are 0. Tolerance 1e-5 of max|ref| per
    gradient (f32, sums in another order)."""
    rng = np.random.default_rng(23)
    b, t, cc, n, two_c = 2, 40, 8, 3, 4
    c = rng.standard_normal((b, t, cc)).astype(np.float32)
    c[:, 10:16] = 0.0
    w0 = (0.3 * rng.standard_normal((3, cc, n * cc))).astype(np.float32)
    b0 = (0.3 * rng.standard_normal(n * cc)).astype(np.float32)
    b0[::3] = 0.0
    w1 = (0.3 * rng.standard_normal((3, cc, n * two_c))).astype(np.float32)
    b1 = (0.3 * rng.standard_normal(n * two_c)).astype(np.float32)
    g = rng.standard_normal((b, t, n * two_c)).astype(np.float32)
    ops = (c, w0, b0, w1, b1)
    out, vjp = jax.vjp(lambda *a: jax_cond_chain.film_cond_chain(*a, interpret=True),
                       *(jax.numpy.asarray(a) for a in ops))
    gp = np.zeros(out.shape, np.float32)
    gp[..., :n * two_c] = g
    want = [np.asarray(w) for w in vjp(gp)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops]
    got = torch.autograd.grad(cond_chain.cond_chain_plain(*leaves), leaves, torch.from_numpy(g))
    for name, a, w in zip(("c", "w0", "b0", "w1", "b1"), got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
    h = cond_chain._h_plain(torch.from_numpy(c), torch.from_numpy(w0), torch.from_numpy(b0),
                            None, None, n, cc)
    assert int((h == 0).sum()) >= b * 4 * (n * cc // 3)
