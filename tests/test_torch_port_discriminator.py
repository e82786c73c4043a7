"""The port's discriminator, latent classifier and gradient reversal against
the JAX package's, at small width.

Parameters are made with numpy from a seed in the flax trees' shapes and
carried into the port by ``weights.py``. Tolerance: atol = rtol = 1e-5 (f32 on
both sides, sums in another order); ``get_subsamples`` and gradient reversal
are compared exactly up to rounding of one conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.models import discriminator as jd
from td_vc_gan_tpu.models.latent_classifier import LatentClassifier as JaxClassifier
from td_vc_gan_tpu.models.layers import grad_reverse as jax_grad_reverse
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.models import discriminator as td
from td_vc_gan_tpu_torch.models.latent_classifier import LatentClassifier
from td_vc_gan_tpu_torch.models.layers import grad_reverse

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SEG = 1280


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


def _signal(b=2, t=SEG, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal((b, t, 1))).astype(np.float32)


def test_get_subsamples():
    x = _signal()
    want = jd.CollaborativeMultibandDiscriminator.get_subsamples(jnp.asarray(x), 3)
    got = td.CollaborativeMultibandDiscriminator.get_subsamples(torch.from_numpy(x), 3)
    assert [tuple(g.shape) for g in got] == [(2, SEG // 4, 1), (2, SEG // 2, 1)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("t", [SEG, 6])
def test_discriminator(t):
    """One band, also at T = 6, under the input conv's reflect pad of 7
    (reflected repeatedly, as jnp.pad does)."""
    x = _signal(t=t, seed=2)
    labels = np.array([1, 3], np.int32)
    mod = jd.Discriminator(num_classes=4, num_channels_base=4)
    params = random_params(mod, x, labels, seed=3)
    out, feats = mod.apply(params, x, labels)
    port = weights.discriminator_from_jax(td.Discriminator(4, num_channels_base=4), params)
    pout, pfeats = port(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(out), **TOL)
    assert len(pfeats) == len(feats) == 6
    for a, b in zip(pfeats, feats):
        np.testing.assert_allclose(a.detach().numpy().transpose(0, 2, 1), np.asarray(b), **TOL)


def test_multiband_discriminator_with_taps():
    x = _signal(seed=4)
    labels = np.array([0, 2], np.int32)
    rng = np.random.default_rng(5)
    taps = [(0.3 * rng.standard_normal((2, SEG // d, 1))).astype(np.float32) for d in (4, 2)]
    mod = jd.CollaborativeMultibandDiscriminator(num_disc=3, num_classes=4,
                                                 num_channels_base=4)
    params = random_params(mod, x, labels, taps, seed=6)
    outs, feats = mod.apply(params, x, labels, taps)
    port = weights.discriminator_from_jax(
        td.CollaborativeMultibandDiscriminator(3, 4, num_channels_base=4), params)
    pouts, pfeats = port(torch.from_numpy(x), torch.from_numpy(labels),
                         [torch.from_numpy(a) for a in taps])
    assert len(pouts) == len(outs) == 5
    for a, b in zip(pouts, outs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for fa, fb in zip(pfeats, feats):
        for a, b in zip(fa, fb):
            np.testing.assert_allclose(a.detach().numpy().transpose(0, 2, 1), np.asarray(b),
                                       **TOL)


def test_discriminator_from_config_full_width_shapes():
    cfg = Config()
    port = td.discriminator_from_config(cfg, 100, device="cpu")
    mod = jd.CollaborativeMultibandDiscriminator(num_disc=3, num_classes=100)
    x = jnp.zeros((1, 8960, 1))
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                            mod.get_subsamples(x, 3))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    assert len(flat) == len(port.state_dict())
    assert sum(int(np.prod(leaf.shape)) for _, leaf in flat) == sum(
        p.numel() for p in port.parameters())


def test_latent_classifier():
    x = (0.3 * np.random.default_rng(7).standard_normal((2, 16, 8))).astype(np.float32)
    mod = JaxClassifier(num_classes=4)
    params = random_params(mod, x, seed=8)
    want = np.asarray(mod.apply(params, x))
    port = weights.classifier_from_jax(LatentClassifier(8, 4), params)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_grad_reverse():
    x = np.random.default_rng(9).standard_normal((3, 5)).astype(np.float32)
    w = np.random.default_rng(10).standard_normal((3, 5)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jax_grad_reverse(a) ** 2 * w))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = grad_reverse(tx)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (y ** 2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), -2 * x * w, rtol=1e-6)
