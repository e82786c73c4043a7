"""The cond chain's backward: the plain version beside K2, the autograd
Function, and the dispatch that keeps a CUDA forward differentiable.

``cond_chain_bwd_plain`` is held against torch.autograd through
``cond_chain_plain`` (split and concat forms, several batch rows and lengths,
T not a multiple of any tile) and against the JAX package's ``_chain_bwd``
(the Pallas backward in interpret mode, concat form, 3 time tiles). K2 itself
needs the card and is held against ``cond_chain_bwd_plain`` by chip_smoke.py;
here the CUDA dispatch is exercised with the launches mocked by the plain
versions. Tolerance: 1e-5 of max|ref| (f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from td_vc_gan_tpu.ops.pallas import cond_chain as jax_cond_chain
from td_vc_gan_tpu_torch.models.layers import MRFBlock, init_weights
from td_vc_gan_tpu_torch.ops.cuda import cond_chain

torch.set_num_threads(1)

RTOL = 1e-5


def assert_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=name)


def operands(split, b=2, t=40, s=10, e=4, n=3, cc=None, two_c=8, seed=0):
    """Chain operands as float32 tensors: split form (per-batch bias, edges)
    or concat form (shared bias, no edges)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32))

    cc = cc or s + e
    ein = e if split else cc
    ops = dict(exc=r(b, t, ein), w0=r(3, ein, n * cc), hbias=r(b, n * cc) if split else r(n * cc),
               w1=r(3, cc, n * two_c), b1=r(n * two_c))
    if split:
        ops.update(edge0=r(b, n * cc), edge_t=r(b, n * cc))
    return ops


@pytest.mark.parametrize("split", [True, False], ids=["split", "concat"])
@pytest.mark.parametrize("b,t", [(1, 1), (2, 13), (3, 40), (2, 130)])
def test_plain_backward_matches_autograd(split, b, t):
    ops = {k: v.requires_grad_() for k, v in operands(split, b=b, t=t, seed=t).items()}
    out = cond_chain.cond_chain_plain(**ops)
    g = torch.from_numpy(np.random.default_rng(t + 1).standard_normal(out.shape)
                         .astype(np.float32))
    want = torch.autograd.grad(out, list(ops.values()), g)
    args = {k: v.detach() for k, v in ops.items() if k != "b1"}
    got = cond_chain.cond_chain_bwd_plain(g=g, **args)
    assert set(got) == set(ops)
    for name, w in zip(ops, want):
        assert got[name].shape == w.shape, name
        assert_close(got[name].numpy(), w.numpy(), name)


def test_plain_backward_matches_pallas_interpret():
    """Concat form against the JAX custom_vjp's backward (the Pallas kernel in
    interpret mode), T = 96 in 3 tiles of 32; the TPU kernel's 128-column
    padding gets a zero cotangent."""
    ops = operands(False, b=2, t=96, n=3, cc=12, two_c=8, seed=5)
    c, w0, b0, w1, b1 = (jnp.asarray(ops[k].numpy()) for k in ("exc", "w0", "hbias", "w1", "b1"))
    n2 = w1.shape[2]
    g = np.random.default_rng(6).standard_normal((2, 96, n2)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_cond_chain.film_cond_chain(*a, interpret=True),
                       c, w0, b0, w1, b1)
    gp = np.zeros(out.shape, np.float32)
    gp[..., :n2] = g
    want = dict(zip(("exc", "w0", "hbias", "w1", "b1"), (np.asarray(a) for a in vjp(gp))))
    got = cond_chain.cond_chain_bwd_plain(
        g=torch.from_numpy(g), **{k: ops[k] for k in ("exc", "w0", "hbias", "w1")})
    for name in want:
        assert_close(got[name].numpy(), want[name], name)


def test_autograd_function_on_the_cpu():
    """CondChain differentiates every operand on CPU tensors, as the plain
    chain under autograd does, and launches nothing."""
    ops = {k: v.requires_grad_() for k, v in operands(True, b=2, t=17, seed=7).items()}
    before = (cond_chain.launches, cond_chain.bwd_launches)
    out = cond_chain.cond_chain(**ops)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
    got = torch.autograd.grad(out, list(ops.values()), g)
    want = torch.autograd.grad(cond_chain.cond_chain_plain(**ops), list(ops.values()), g)
    for name, a, w in zip(ops, got, want):
        assert_close(a.numpy(), w.numpy(), name)
    assert (cond_chain.launches, cond_chain.bwd_launches) == before


def test_cuda_request_under_grad_keeps_its_gradients(monkeypatch):
    """With the dispatch taking the kernel route (mocked on the CPU by launches
    that, like the kernels, return tensors without a graph), the output still
    has a grad_fn, its backward goes through the backward launch, and every
    operand's gradient equals the plain chain's."""
    calls = []

    def fake_launch(*args):
        with torch.no_grad():
            calls.append("fwd")
            return cond_chain.cond_chain_plain(*args)

    def fake_launch_bwd(*args):
        calls.append("bwd")
        return cond_chain.cond_chain_bwd_plain(*args)

    monkeypatch.setattr(cond_chain, "_use_kernels", lambda exc: True)
    monkeypatch.setattr(cond_chain, "_launch", fake_launch)
    monkeypatch.setattr(cond_chain, "_launch_bwd", fake_launch_bwd)
    for split in (True, False):
        calls.clear()
        ops = {k: v.requires_grad_() for k, v in operands(split, t=21, seed=9).items()}
        out = cond_chain.cond_chain(**ops)
        assert out.grad_fn is not None
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(10))
        got = torch.autograd.grad(out, list(ops.values()), g)
        assert calls == ["fwd", "bwd"]
        want = torch.autograd.grad(cond_chain.cond_chain_plain(**ops), list(ops.values()), g)
        for name, a, w in zip(ops, got, want):
            assert_close(a.numpy(), w.numpy(), name)


def test_mrf_films_gradients_reach_speaker_excitation_and_weights(monkeypatch):
    """Through MRFBlock.films on the (mocked) kernel route, the speaker
    embedding, the excitation and every cond weight get the plain chain's
    gradient."""
    monkeypatch.setattr(cond_chain, "_use_kernels", lambda exc: True)
    monkeypatch.setattr(cond_chain, "_launch",
                        lambda *a: cond_chain.cond_chain_plain(*a).detach())
    monkeypatch.setattr(cond_chain, "_launch_bwd", cond_chain.cond_chain_bwd_plain)
    mrf = init_weights(MRFBlock(4, 6 + 4, dilations=(1, 2), kernel_sizes=(3, 5)), seed=11)
    gen = torch.Generator().manual_seed(12)
    spk = torch.randn((2, 6), generator=gen).requires_grad_()
    exc = torch.randn((2, 4, 19), generator=gen).requires_grad_()
    leaves = [spk, exc] + [p for name, p in mrf.named_parameters() if ".cond_" in name]

    def grads():
        out = torch.cat([torch.cat(f, 1) for f in mrf.films(spk, exc)], 1)
        return torch.autograd.grad(out, leaves, torch.ones_like(out))

    got = grads()
    monkeypatch.setattr(cond_chain, "_use_kernels", lambda exc: False)
    want = grads()
    assert len(got) == 2 + 4 * 6
    for a, w in zip(got, want):
        assert_close(a.numpy(), w.numpy(), "films")
        assert float(w.abs().max()) > 0


def test_kernel_route_checks_operands():
    """The kernel route raises on what K1/K2 do not take (checked before any
    build): float64, non-contiguous. Every width passes: Cc = 11 is padded to
    12 for the kernels that take Cc in multiples of 4 (K1 takes it as it is);
    Cc past one pass of 136 channels (148) and E not a multiple of 4 (6)
    pass."""
    ops = operands(True, s=9, e=2)  # Cc = 11
    assert cond_chain._check_operands(**ops)[4] == 11
    assert cond_chain._padded_widths("fwd", 11, 8) == (11, 8)
    for kind in ("bwd", "fwd_bf16", "bwd_bf16"):
        assert cond_chain._padded_widths(kind, 11, 8) == (12, 8)
    for kw, cc in ((dict(s=144, e=4), 148), (dict(s=10, e=6), 16)):
        assert cond_chain._check_operands(**operands(True, **kw))[4] == cc
    ops = operands(True, s=12)  # Cc = 16
    with pytest.raises(TypeError, match="float32"):
        cond_chain._check_operands(**{**ops, "w0": ops["w0"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        cond_chain._check_operands(**{**ops, "exc": ops["exc"].transpose(0, 1)})


@pytest.mark.parametrize("split,cc,two_c", [
    (True, 136, 256),    # the decoder's widths
    (True, 136, 32),
    (True, 392, 128),    # conditional_dim 384: both kernels' 64-row tiles
    (False, 184, 128),
    (False, 344, 128),   # 32-row tiles
    (True, 1204, 32),
], ids=["decoder", "decoder-2C32", "split392", "concat184", "concat344", "split1204"])
def test_kernel_tiles_take_any_cc_up_to_shared_memory(split, cc, two_c):
    """The operand check lets every width through: the kernels take Cc in
    passes of 136 channels, so their shared memory does not grow with it (on
    the card, chip_smoke.py holds these widths against the plain version)."""
    ops = {"edge0": None, "edge_t": None,
           **operands(split, t=6, s=cc - 8 if split else 8, e=8, cc=cc, two_c=two_c)}
    assert cond_chain._check_operands(**ops)[4] == cc


# --- K2's 3xTF32 products, emulated with numpy (see test_torch_port_cond_chain)

from td_vc_gan_tpu_torch import testing  # noqa: E402
from td_vc_gan_tpu_torch.config import Config  # noqa: E402
from test_torch_port_cond_chain import h_split, lrelu, mm3, shifted  # noqa: E402


def chain_bwd_split(exc, w0, hbias, w1, g, edge0=None, edge_t=None):
    """The chain's backward as K2 takes it: every product 3xTF32, the slope
    from the recomputed h (1 at h >= 0)."""
    b, t, e = exc.shape
    cc = w1.shape[1]
    n = w0.shape[2] // cc
    two_c = w1.shape[2] // n
    h = h_split(exc, w0, hbias, edge0, edge_t)
    a = lrelu(h)
    blk = [(slice(i * cc, (i + 1) * cc), slice(i * two_c, (i + 1) * two_c)) for i in range(n)]
    # g_i[t - j + 1] is tap 2 - j of the 'same' window
    da = np.concatenate([sum(mm3(shifted(g[..., o], 2 - j), w1[j][:, o].T) for j in range(3))
                         for _, o in blk], -1)
    dh = np.where(a >= 0, da, np.float32(0.2) * da).astype(np.float32)
    out = dict(
        exc=sum(mm3(shifted(dh, 2 - j), w0[j].T) for j in range(3)),
        w0=np.stack([mm3(shifted(exc, j).reshape(-1, e).T, dh.reshape(-1, n * cc))
                     for j in range(3)]),
        w1=np.stack([np.concatenate([
            mm3(shifted(a[..., c], j).reshape(-1, cc).T, g[..., o].reshape(-1, two_c))
            for c, o in blk], -1) for j in range(3)]),
        hbias=dh.sum(1) if hbias.ndim == 2 else dh.sum((0, 1)), b1=g.sum((0, 1)))
    if edge0 is not None:
        out.update(edge0=-dh[:, 0], edge_t=-dh[:, -1])
    return out


@pytest.mark.parametrize("stage", range(4))
def test_split_products_backward_match_plain_at_parity_shapes(stage):
    """At the smoke's K2 parity shapes and inputs (dyadic cond_0 operands),
    every output of the 3xTF32 backward is within testing.PARITY_RTOL of
    max|ref| of cond_chain_bwd_plain's: the split form at every stage, the
    concat form (E = Cc = 136, ~17x the cond_0 work) at the two shorter ones."""
    cfg = Config()
    t, c = testing.stage_shapes(cfg.train.max_segment, cfg)[stage]
    split_ops, concat, n, cc = testing.chain_inputs(2, t, c, cfg, seed=300 + stage,
                                                    exact_h=True, device="cpu")
    g = torch.from_numpy(np.random.default_rng(400 + stage).standard_normal(
        (2, t, split_ops["w1"].shape[2])).astype(np.float32))
    forms = [{k: v for k, v in split_ops.items() if k != "b1"}]
    if stage < 2:
        forms.append(dict(exc=concat["c"], w0=concat["w0"], hbias=concat["b0"], w1=concat["w1"]))
    for args in forms:
        want = cond_chain.cond_chain_bwd_plain(g=g, **args)
        got = chain_bwd_split(g=g.numpy(), **{k: v.numpy() for k, v in args.items()})
        assert set(got) == set(want)
        for k in want:
            w = want[k].numpy()
            assert got[k].shape == w.shape, k
            err = float(np.abs(got[k] - w).max())
            assert err <= testing.PARITY_RTOL * float(np.abs(w).max()), (k, err)
