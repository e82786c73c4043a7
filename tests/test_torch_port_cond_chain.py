"""The port's FiLM cond chain against the JAX package's.

The CUDA kernel itself needs the card and is held against
``cond_chain_plain`` by chip_smoke.py; here the CPU dispatch (the plain
version) is compared with the Pallas kernel in interpret mode (concat form)
and with MRFBlock's split path (split form). Tolerance: atol = rtol = 1e-5
(f32 on both sides, sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.models.layers import MRFBlock as JaxMRFBlock
from td_vc_gan_tpu.ops.pallas import cond_chain as jax_cond_chain
from td_vc_gan_tpu_torch.models.layers import MRFBlock
from td_vc_gan_tpu_torch.ops.cuda import cond_chain

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _make_inputs(b=2, t=96, cc=12, n=3, two_c=8, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return (r(b, t, cc), r(3, cc, n * cc), r(n * cc), r(3, cc, n * two_c), r(n * two_c))


def _split_inputs(b=2, t=40, s=10, e=4, n=3, two_c=8, seed=1):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    cc = s + e
    return r(b, s), r(b, t, e), r(3, cc, n * cc), r(n * cc), r(3, cc, n * two_c), r(n * two_c)


@pytest.mark.parametrize("n,cc,two_c", [(3, 12, 8), (1, 16, 4)])
def test_concat_form_matches_pallas_interpret(n, cc, two_c):
    c, w0, b0, w1, b1 = _make_inputs(cc=cc, n=n, two_c=two_c)
    want = np.asarray(jax_cond_chain.film_cond_chain(
        *(jnp.asarray(a) for a in (c, w0, b0, w1, b1)), interpret=True))
    got = cond_chain.film_cond_chain(*(torch.from_numpy(a) for a in (c, w0, b0, w1, b1)))
    assert got.shape == (2, 96, n * two_c)
    np.testing.assert_allclose(got.numpy(), want[..., :n * two_c], **TOL)
    # the TPU kernel's 128-lane padding carries zeros only
    assert not np.any(want[..., n * two_c:])


def test_split_form_matches_mrf_split_path():
    spk, exc, w0, b0, w1, b1 = _split_inputs()
    s = spk.shape[1]
    mrf = JaxMRFBlock(channels=4, cond_channels=w0.shape[1])
    films = JaxMRFBlock._split_film(
        mrf, (jnp.asarray(spk), jnp.asarray(exc)), jnp.asarray(w0), jnp.asarray(b0),
        jnp.asarray(w1), jnp.asarray(b1), jnp.float32)
    want = np.concatenate([np.concatenate([np.asarray(g), np.asarray(bt)], -1)
                           for g, bt in films], -1)

    tw0 = torch.from_numpy(w0)
    tspk = torch.from_numpy(spk)
    w0_spk = tw0[:, :s]
    got = cond_chain.cond_chain(
        torch.from_numpy(exc), tw0[:, s:].contiguous(),
        tspk @ (w0_spk[0] + w0_spk[1] + w0_spk[2]) + torch.from_numpy(b0),
        torch.from_numpy(w1), torch.from_numpy(b1), tspk @ w0_spk[0], tspk @ w0_spk[2])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the edge rows are where the split form differs from a plain conv
    np.testing.assert_allclose(got.numpy()[:, [0, -1]], want[:, [0, -1]], **TOL)


def test_split_with_no_speaker_equals_concat_form():
    c, w0, b0, w1, b1 = (torch.from_numpy(a) for a in _make_inputs(seed=2))
    two_c = w1.shape[2] // 3
    mrf = MRFBlock(two_c // 2, c.shape[2], dilations=(1,), kernel_sizes=(3, 5, 7))
    blocks = mrf.blocks()
    cc = c.shape[2]
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            # weight norm off the path: g = ||v|| makes the weight equal v
            blk.cond_0.v.copy_(w0[..., i * cc:(i + 1) * cc].permute(2, 1, 0))
            blk.cond_0.g.copy_(blk.cond_0.v.flatten(1).norm(dim=1))
            blk.cond_0.bias.copy_(b0[i * cc:(i + 1) * cc])
            blk.cond_1.v.copy_(w1[..., i * two_c:(i + 1) * two_c].permute(2, 1, 0))
            blk.cond_1.g.copy_(blk.cond_1.v.flatten(1).norm(dim=1))
            blk.cond_1.bias.copy_(b1[i * two_c:(i + 1) * two_c])
        films = mrf.films(torch.zeros(c.shape[0], 0), c.transpose(1, 2))
    split = torch.cat([torch.cat(f, 1) for f in films], 1).transpose(1, 2)
    np.testing.assert_allclose(split.numpy(), cond_chain.film_cond_chain(c, w0, b0, w1, b1).numpy(),
                               **TOL)


def test_dispatch_rejects_other_devices_and_half_edges():
    c, w0, b0, w1, b1 = (torch.from_numpy(a) for a in _make_inputs(seed=3))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        cond_chain.cond_chain(c.to("meta"), w0, b0, w1, b1)
    edge = torch.zeros(c.shape[0], w0.shape[2])
    with pytest.raises(ValueError, match="both edge corrections"):
        cond_chain.cond_chain(c, w0, b0, w1, b1, edge0=edge)


def test_plain_version_never_counts_as_a_launch():
    before = cond_chain.launches
    cond_chain.film_cond_chain(*(torch.from_numpy(a) for a in _make_inputs(seed=4)))
    assert cond_chain.launches == before
