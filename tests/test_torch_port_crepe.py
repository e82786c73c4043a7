"""The port's CREPE and pitch decoders against the JAX package's.

Weights: the JAX package's seeded init, carried by ``weights.crepe_from_jax``
with its batch-norm statistics replaced by numpy draws so that the folded
batch norm is exercised. Tolerances: activations atol = rtol = 1e-4 (a
six-layer f32 CNN whose sums run in another order); decoded bins exact, the
frequencies they map to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.models import crepe as jc
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models import crepe as tc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def crepe_params():
    params = jax.tree_util.tree_map(np.asarray, jc.init_crepe(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    p = params["params"]
    for i in range(6):
        bn = p[f"bn{i}"]
        n = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        bn["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return params


def test_preprocess():
    sig = np.random.default_rng(1).standard_normal((2, 1000)).astype(np.float32)
    sig[1, :600] = 0.0  # all-zero frames hit the 1e-10 std floor
    want = np.asarray(jc.preprocess(jnp.asarray(sig)))
    got = tc.preprocess(torch.from_numpy(sig)).numpy()
    assert got.shape == want.shape == (2, 1000 // 64 + 1, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_activations(crepe_params):
    frames = np.random.default_rng(2).standard_normal((6, 1024)).astype(np.float32)
    want = np.asarray(jc.Crepe("tiny").apply(crepe_params, jnp.asarray(frames)))
    net = weights.crepe_from_jax(tc.Crepe("tiny"), crepe_params)
    with torch.no_grad():
        got = net(torch.from_numpy(frames)).numpy()
    assert got.shape == (6, 360)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _activations(seed=3, b=2, f=40):
    """Smooth peaked maps: a random pitch track plus noise, sigmoid range."""
    rng = np.random.default_rng(seed)
    centre = 150 + np.cumsum(rng.normal(0, 3, (b, f)), axis=1)
    bins = np.arange(360)
    act = np.exp(-0.5 * ((bins - centre[..., None]) / 6.0) ** 2)
    return (0.9 * act + 0.05 * rng.random((b, f, 360))).astype(np.float32)


@pytest.mark.parametrize("decoder", ["argmax", "weighted_argmax", "viterbi"])
def test_decoders(decoder):
    act = _activations()
    jb, jf = jc._DECODERS[decoder](jc._mask_range(jnp.asarray(act)))
    tb, tf = tc._DECODERS[decoder](tc._mask_range(torch.from_numpy(act)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)


def test_filtered_pitch(crepe_params):
    t = np.arange(2560) / 16000
    sig = np.stack([0.3 * np.sin(2 * np.pi * 180 * t),
                    np.random.default_rng(4).standard_normal(2560) * 0.1]).astype(np.float32)
    want, _ = jc.filtered_pitch(crepe_params, jnp.asarray(sig), "viterbi")
    net = weights.crepe_from_jax(tc.Crepe("tiny"), crepe_params)
    with torch.no_grad():
        got, act = tc.filtered_pitch(net, torch.from_numpy(sig), "viterbi")
    assert act.shape == (2, 41, 360)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_get_shift():
    src = np.array([100.0, 220.0, 330.0], np.float32)
    tgt = np.array([200.0, 110.0, 330.0], np.float32)
    want = np.asarray(jc.get_shift(jnp.asarray(src), jnp.asarray(tgt)))
    np.testing.assert_array_equal(tc.get_shift(torch.from_numpy(src), torch.from_numpy(tgt)).numpy(),
                                  want)


def test_seeded_init_is_deterministic():
    a, b = tc.crepe_from_seed(3), tc.crepe_from_seed(3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
    k = a.conv1_kernel.detach()
    assert float(k.abs().max()) <= 2 * np.sqrt(2 / k[0].numel()) / 0.87962566103423978 + 1e-6
