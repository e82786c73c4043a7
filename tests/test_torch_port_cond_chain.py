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


# --- the kernels' 3xTF32 products, emulated with numpy ---------------------
#
# K1 and K2 run every product on the tensor cores as 3xTF32 (csrc/tf32x3.cuh):
# x = hi + lo with hi = tf32(x), lo = tf32(x - hi), rounded to nearest with
# ties away from zero (cvt.rna.tf32.f32), and a.b ~ a.lo b.hi + a.hi b.lo +
# a.hi b.hi in f32. These tests hold that premise on the CPU: the split
# products of the chain agree with the plain version within the card's
# tolerance (testing.PARITY_RTOL = 1e-4 of max|ref|) at the smoke's parity
# shapes, and the smoke's dyadic inputs split with lo == 0.

from td_vc_gan_tpu_torch import testing  # noqa: E402
from td_vc_gan_tpu_torch.config import Config  # noqa: E402


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), nearest, ties away from
    zero, as cvt.rna.tf32.f32; inf and nan pass through."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    r = np.where(finite, (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000), u)
    return r.astype(np.uint32).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b (f32) as the kernels take it: three TF32 products, small terms
    first (the products on torch's CPU matmul, in this worker's one thread)."""
    ah, al = (torch.from_numpy(x) for x in split(a))
    bh, bl = (torch.from_numpy(x) for x in split(b))
    return ((al @ bh + ah @ bl) + ah @ bh).numpy()


def lrelu(x):
    return np.where(x >= 0, x, np.float32(0.2) * x)


def shifted(x, j):
    """x[:, t + j - 1] for every t, zero outside [0, T): tap j of a k=3 'same'
    conv over x (B, T, C)."""
    t = x.shape[1]
    return np.pad(x, ((0, 0), (1, 1), (0, 0)))[:, j:j + t]


def h_split(exc, w0, hbias, edge0, edge_t):
    """cond_0's pre-activation (B, T, n*Cc) from 3xTF32 products."""
    h = sum(mm3(shifted(exc, j), w0[j]) for j in range(3))
    h = h + (hbias[:, None, :] if hbias.ndim == 2 else hbias)
    if edge0 is not None:
        h[:, 0] -= edge0
        h[:, -1] -= edge_t
    return h.astype(np.float32)


def chain_split(exc, w0, hbias, w1, b1, edge0=None, edge_t=None):
    """The chain's forward as K1 takes it."""
    cc = w1.shape[1]
    n = w0.shape[2] // cc
    two_c = w1.shape[2] // n
    a = lrelu(h_split(exc, w0, hbias, edge0, edge_t))
    return np.concatenate([
        sum(mm3(shifted(a[..., i * cc:(i + 1) * cc], j), w1[j][:, i * two_c:(i + 1) * two_c])
            for j in range(3)) + b1[i * two_c:(i + 1) * two_c]
        for i in range(n)], -1)


def test_tf32_rounding():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                  2.0 ** -100, np.inf, 3.0], np.float32)
    want = np.array([one + ulp, one, one + 2 * ulp, -(one + ulp), 2.0 ** -100, np.inf, 3.0],
                    np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    r = np.random.default_rng(30).standard_normal(1000).astype(np.float32)
    hi, lo = split(r)
    assert not np.any(hi.view(np.uint32) & 0x1FFF) and not np.any(lo.view(np.uint32) & 0x1FFF)
    np.testing.assert_allclose(hi.astype(np.float64) + lo, r, rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("stage", range(4))
def test_split_products_forward_match_plain_at_parity_shapes(stage):
    cfg = Config()
    t, c = testing.stage_shapes(cfg.train.max_segment, cfg)[stage]
    split_ops, concat, n, cc = testing.chain_inputs(2, t, c, cfg, seed=100 + stage,
                                                    device="cpu")
    want = cond_chain.cond_chain_plain(**split_ops).numpy()
    got = chain_split(**{k: v.numpy() for k, v in split_ops.items()})
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= testing.PARITY_RTOL * scale
    if stage < 2:  # the concat form (E = Cc = 136) at the two shorter stages
        ops = [concat[k] for k in ("c", "w0", "b0", "w1", "b1")]
        wantc = cond_chain.cond_chain_plain(*ops).numpy()
        gotc = chain_split(*(x.numpy() for x in ops))
        assert float(np.abs(gotc - wantc).max()) <= (testing.PARITY_RTOL *
                                                     float(np.abs(wantc).max()))


@pytest.mark.parametrize("stage", [0, 3])
def test_dyadic_inputs_split_exactly(stage):
    """chain_inputs(exact_h=True) gives cond_0 operands that split with lo == 0,
    so the kernels' h is exact: the split products equal h in float64."""
    cfg = Config()
    t, c = testing.stage_shapes(cfg.train.max_segment, cfg)[stage]
    split_ops, concat, n, cc = testing.chain_inputs(2, t, c, cfg, seed=300 + stage,
                                                    exact_h=True, device="cpu")
    ops = {k: v.numpy() for k, v in split_ops.items()}
    for x in (ops["exc"], ops["w0"], concat["c"].numpy(), concat["w0"].numpy()):
        hi, lo = split(x)
        assert not np.any(lo)
        np.testing.assert_array_equal(hi, x)
    h = h_split(ops["exc"], ops["w0"], ops["hbias"], ops["edge0"], ops["edge_t"])
    x64 = np.pad(ops["exc"].astype(np.float64), ((0, 0), (1, 1), (0, 0)))
    h64 = sum(x64[:, j:j + t] @ ops["w0"][j].astype(np.float64) for j in range(3))
    h64 = h64 + ops["hbias"][:, None, :]
    h64[:, 0] -= ops["edge0"]
    h64[:, -1] -= ops["edge_t"]
    np.testing.assert_array_equal(h, h64)
    assert not np.any(h == 0)


def test_library_is_keyed_on_its_headers(tmp_path):
    """Each kernel library's name hashes its source and every header the
    source includes (recursively), so editing a shared header rebuilds both."""
    import shutil
    for src in (*cond_chain.SOURCES, *cond_chain.SOURCES[0].parent.glob("*.cuh")):
        shutil.copy(src, tmp_path / src.name)
    fwd, bwd = (tmp_path / s.name for s in cond_chain.SOURCES)
    headers = {"cond_chain_f32.cuh", "hopper_bf16.cuh", "tf32x3.cuh"}
    assert {p.name for p in cond_chain._sources_of(fwd)} == {"cond_chain.cu", *headers}
    assert {p.name for p in cond_chain._sources_of(bwd)} == {"cond_chain_bwd.cu", *headers}
    before = cond_chain._lib_path(fwd), cond_chain._lib_path(bwd)
    assert before == tuple(cond_chain._lib_path(s) for s in cond_chain.SOURCES)
    (tmp_path / "tf32x3.cuh").write_text((tmp_path / "tf32x3.cuh").read_text() + "\n")
    after = cond_chain._lib_path(fwd), cond_chain._lib_path(bwd)
    assert after[0] != before[0] and after[1] != before[1]
