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
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models import layers as tl

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
