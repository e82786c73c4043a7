"""One train step of the port against ``td_vc_gan_tpu.training.step``.

The tiny configuration of tests/test_train_step.py (SEG 1280, batch 4) with
the stage-2 loss weights (the config defaults: no latent classifier). The C
update and the eval step are compared through their pieces (the classifier's
forward, cross entropy, reversed gradient and Adam update; the modules
``build_eval_step`` applies), so that the whole JAX step compiles only once. The
JAX parameters are made with numpy from a seed in the flax trees' shapes
(``jax.eval_shape``), carried into the port by ``weights.py``, and the JAX
step's random draws (permutation, both excitations, the contrastive
negatives) are derived from its key exactly as ``build_train_step`` derives
them, and injected into the port. The JAX step is compiled once per module.

Compared after one step: every metric (rtol 1e-4, atol 1e-6: f32 losses
over ~40 layers in another summation order); the AdamW first moments, which
after one step are (1 - beta1) * grad, so the gradients (atol 1e-4 of the
tensor's max|mu| plus 1e-9); and the updated parameters (atol 1e-6, 1% of
the learning rate). The first Adam step moves a weight by
lr * g / (|g| + 1e-8), nearly lr * sign(g), so where |g| lies inside the
gradients' tolerance band its sign, and the update, may differ: there the
weights are held to 2 lr and the gradients themselves to the moments'
tolerance.

The same step on two ranks of a gloo process group (two processes on the
CPU, two items each, the JAX draws given at the global batch's shape) is
held to the same tolerances against the JAX step on the whole batch: the
ranks' mean of per-rank gradients differs from the one-rank gradient by the
order of its sums only. A second step from a seeded generator is held
against the same step on one rank (metrics, METRIC_TOL), and the two ranks
end with bit-identical replicas and generator states.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from td_vc_gan_tpu import config as jcfg
from td_vc_gan_tpu.models import CollaborativeMultibandDiscriminator as JaxD
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models.generator import Generator as JaxG
from td_vc_gan_tpu.models.latent_classifier import LatentClassifier as JaxC
from td_vc_gan_tpu.ops import dsp as jdsp
from td_vc_gan_tpu.ops import losses as jl
from td_vc_gan_tpu.training import state as jstate
from td_vc_gan_tpu.training import step as jstep
from td_vc_gan_tpu_torch import testing, weights
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.models.crepe import Crepe, crepe_from_seed
from td_vc_gan_tpu_torch.models.discriminator import CollaborativeMultibandDiscriminator
from td_vc_gan_tpu_torch.models.generator import Generator, generator_from_config
from td_vc_gan_tpu_torch.models.latent_classifier import LatentClassifier
from td_vc_gan_tpu_torch.models.layers import init_weights
from td_vc_gan_tpu_torch.models.wavlm import WavLMConfig
from td_vc_gan_tpu_torch.ops import losses as tlosses
from td_vc_gan_tpu_torch.training import state as tstate
from td_vc_gan_tpu_torch.training import step as tstep

torch.set_num_threads(1)

SEG = 1280
B = 4
NUM_SPK = 4
RATIOS, CHANNELS = (10, 4, 2, 2), (16, 16, 8, 8, 4)
MRF = dict(kernel_sizes=(3,), dilations=(1, 3))
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 1e-6


def configs():
    """The JAX tiny config (tests/test_train_step.py) and the port's twin."""
    out = []
    for mod in (jcfg, None):
        cfg = mod.Config() if mod else Config()
        g = cfg.model.generator
        g.decoder_ratios, g.decoder_channels = list(RATIOS), list(CHANNELS)
        g.content_dim = g.conditional_dim = 8
        g.mrf_kernel_sizes, g.mrf_dilations = list(MRF["kernel_sizes"]), list(MRF["dilations"])
        cfg.model.discriminator.num_channels_base = 4
        cfg.train.max_segment = SEG
        cfg.train.mel_fft_sizes = [512]
        out.append(cfg)
    return out


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


def make_batch():
    rng = np.random.default_rng(11)
    t = np.arange(SEG) / 16000
    sig = np.stack([0.2 * np.sin(2 * np.pi * (120 + 40 * i) * t) for i in range(B)])
    sig = (sig + 0.01 * rng.standard_normal((B, SEG))).astype(np.float32)
    # the corrupted batch: the signal plus seeded noise
    corrupted = (sig + 0.05 * rng.standard_normal((B, SEG))).astype(np.float32)
    return dict(signal=sig, corrupted=corrupted, label=np.arange(B, dtype=np.int32) % NUM_SPK)


def jax_draws(rng, b, t_content):
    """The draws of ``build_train_step`` for key ``rng`` (step.py:194-214 and
    the helpers it calls), as numpy."""
    keys = jax.random.split(rng, 8)
    k_perm, k_pitch, _, k_cont1, _ = keys[:5]

    def excitation(key):
        k_phase, k_noise = jax.random.split(key)
        start = float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi)
        return start, np.asarray(jax.random.normal(k_noise, (b, SEG)))

    def negatives(key):
        return tuple(np.asarray(jax.random.randint(k, (b, t_content, 100), 0, t_content - 1))
                     for k in jax.random.split(key))

    k1, k2 = jax.random.split(k_pitch)
    return dict(perm=np.asarray(jax.random.permutation(k_perm, b)), exc_conv=excitation(k1),
                exc_src=excitation(k2), neg_corrupted=negatives(k_cont1))


def adam_mu(opt_state):
    """The first-moment tree of an optax (masked/chained) Adam state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return found[0].mu


def torch_layout(module, tree):
    """A flax tree as numpy arrays in ``module``'s names and layouts."""
    layout = weights._conv_layout(module)
    return {k: layout(k, v) for k, v in weights._params(tree).items()}


@pytest.fixture(scope="module")
def stepped():
    jax_cfg, cfg = configs()
    G = JaxG(decoder_ratios=RATIOS, decoder_channels=CHANNELS, num_bottleneck_layers=0,
             num_classes=NUM_SPK, conditional_dim=8, content_dim=8, **MRF)
    D = JaxD(num_disc=3, num_classes=NUM_SPK, num_channels_base=4)
    x = jnp.zeros((1, SEG, 1))
    pg = random_params(G, x, jnp.zeros((1, NUM_SPK)), None, x, seed=1)
    pd = random_params(D, x, jnp.zeros((1,), jnp.int32), D.get_subsamples(x, 3), seed=2)
    cp = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    st, opts = jstate.create_train_state(jax_cfg, pg, pd, None, cp)
    batch = make_batch()
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jstep.build_train_step(jax_cfg, G, D, None, opts))
    st2, jmetrics = step(st, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    tG = weights.generator_from_jax(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), pg)
    tD = weights.discriminator_from_jax(
        CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), pd)
    crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray, cp))
    initial = copy.deepcopy(dict(G=tG, D=tD, crepe=crepe))
    state = tstate.create_train_state(cfg, tG, tD, None, crepe)
    train_step = tstep.build_train_step(cfg, state)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = jax_draws(rng, B, SEG // int(np.prod(RATIOS)))
    metrics = train_step(tbatch, draws=draws)
    return dict(jmetrics={k: float(v) for k, v in jmetrics.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                jax_state=st2, state=state, cfg=cfg, initial=initial, batch=batch, draws=draws)


def test_metrics_match(stepped):
    jm, m = stepped["jmetrics"], stepped["metrics"]
    assert set(m) == set(jm)
    for k in sorted(jm):
        np.testing.assert_allclose(m[k], jm[k], err_msg=k, **METRIC_TOL)
    assert all(np.isfinite(v) for v in m.values())
    assert stepped["state"].step == 1


def _nets(stepped, net):
    st, jst = stepped["state"], stepped["jax_state"]
    module, opt = (st.G, st.opt_g) if net == "G" else (st.D, st.opt_d)
    params, opt_state = ((jst.params_g, jst.opt_g) if net == "G"
                         else (jst.params_d, jst.opt_d))
    return module, opt, params, opt_state


def check_first_moments(module, exp_avg: dict, opt_state):
    """exp_avg ({name: array}) = (1 - beta1) * grad after one step: the
    gradients agree with the JAX step's."""
    want = torch_layout(module, {"params": adam_mu(opt_state)["params"]})
    assert set(exp_avg) == set(want)
    for name, got in exp_avg.items():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-4 * scale + 1e-9,
                                   err_msg=name)


def check_updated_parameters(module, got_params: dict, lr: float, params, opt_state):
    """``got_params`` ({name: array}) within PARAM_ATOL of the JAX step's
    where the gradient's sign is settled, else within 2 lr (see
    test_updated_parameters_match)."""
    want = torch_layout(module, params)
    mu = torch_layout(module, {"params": adam_mu(opt_state)["params"]})
    assert set(want) == set(got_params) == {name for name, _ in module.named_parameters()}
    for name, got in got_params.items():
        settled = np.abs(mu[name]) > 1e-4 * np.abs(mu[name]).max() + 1e-9
        np.testing.assert_allclose(got[settled], want[name][settled], rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got, want[name], rtol=0, atol=2 * lr + PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("net", ["G", "D"])
def test_first_moments_match(stepped, net):
    """exp_avg = (1 - beta1) * grad after one step: the gradients agree."""
    module, opt, _, opt_state = _nets(stepped, net)
    state = opt.optimizer.state
    check_first_moments(module, {name: state[p]["exp_avg"].numpy()
                                 for name, p in module.named_parameters()}, opt_state)


@pytest.mark.parametrize("net", ["G", "D"])
def test_updated_parameters_match(stepped, net):
    """Within PARAM_ATOL wherever the gradient's sign is settled (|mu| above
    the moments' tolerance band); elsewhere the first Adam step's
    lr * g / (|g| + eps) may take either sign, and the weights agree within
    that step, 2 lr."""
    module, opt, params, opt_state = _nets(stepped, net)
    check_updated_parameters(module, {name: p.detach().numpy()
                                      for name, p in module.named_parameters()},
                             opt.optimizer.param_groups[0]["lr"], params, opt_state)


@pytest.fixture(scope="module")
def two_ranks(stepped, tmp_path_factory):
    """The step of ``stepped`` on two gloo ranks (two processes, 2 items
    each, from the same weights and the JAX draws), then a second step
    drawn from a generator seeded 7; and that second step on one rank,
    without a group, from the one-rank state of ``stepped``."""
    out = tmp_path_factory.mktemp("ranks")
    torch.save(dict(cfg=stepped["cfg"], C=None, batch=stepped["batch"], draws=stepped["draws"],
                    seed=7, steps=2, **stepped["initial"]), out / "payload.pt")
    testing.run_ranks(2, testing.call("td_vc_gan_tpu_torch.testing:step_rank",
                                      str(out / "payload.pt"), str(out)))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    one = copy.deepcopy(stepped["state"])
    gen = torch.Generator().manual_seed(7)
    second = tstep.build_train_step(stepped["cfg"], one)(
        {k: torch.from_numpy(v) for k, v in stepped["batch"].items()}, gen)
    return dict(ranks=ranks, second={k: float(v) for k, v in second.items()},
                generator=gen.get_state())


def test_two_ranks_metrics_match(stepped, two_ranks):
    """Each rank reports the metrics of the global batch: the JAX step's."""
    jm = stepped["jmetrics"]
    for result in two_ranks["ranks"]:
        m = result["metrics"][0]
        assert set(m) == set(jm)
        for k in sorted(jm):
            np.testing.assert_allclose(m[k], jm[k], err_msg=k, **METRIC_TOL)
    assert [r["launches"] for r in two_ranks["ranks"]] == [[(0, 0), (0, 0)]] * 2  # CPU


@pytest.mark.parametrize("net", ["G", "D"])
def test_two_ranks_first_moments_match(stepped, two_ranks, net):
    module, _, _, opt_state = _nets(stepped, net)
    got = two_ranks["ranks"][0]["state"][net]["exp_avg"]
    check_first_moments(module, {n: v.numpy() for n, v in got.items()}, opt_state)


@pytest.mark.parametrize("net", ["G", "D"])
def test_two_ranks_updated_parameters_match(stepped, two_ranks, net):
    module, opt, params, opt_state = _nets(stepped, net)
    got = two_ranks["ranks"][0]["state"][net]["params"]
    check_updated_parameters(module, {n: v.numpy() for n, v in got.items()},
                             opt.optimizer.param_groups[0]["lr"], params, opt_state)


def test_two_ranks_stay_replicas(two_ranks):
    """Both ranks hold bit-identical parameters, moments and generator
    states; their second step (global draws from the generator) gives the
    one-rank step's metrics, and leaves the generator where one rank's
    does."""
    r0, r1 = two_ranks["ranks"]
    for net in r0["state"]:
        for kind in ("params", "exp_avg"):
            for name, v in r0["state"][net][kind].items():
                assert torch.equal(v, r1["state"][net][kind][name]), (net, kind, name)
    assert r0["metrics"] == r1["metrics"]
    assert torch.equal(r0["generator"], r1["generator"])
    assert torch.equal(r0["generator"], two_ranks["generator"])
    want = two_ranks["second"]
    assert set(r0["metrics"][1]) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(r0["metrics"][1][k], want[k], err_msg=k, **METRIC_TOL)


def test_g_loss_leaves_no_gradient_in_d(stepped):
    """D's .grad after the step is its own loss's gradient: exp_avg/(1-beta1)."""
    st = stepped["state"]
    b1 = st.opt_d.optimizer.param_groups[0]["betas"][0]
    for p in st.D.parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   st.opt_d.optimizer.state[p]["exp_avg"].numpy() / (1 - b1),
                                   rtol=1e-6, atol=1e-12)


@pytest.fixture(scope="module")
def classifier():
    """A JAX LatentClassifier, its numpy parameters and a content batch."""
    C = JaxC(num_classes=NUM_SPK)
    cont = (0.3 * np.random.default_rng(12).standard_normal((B, 8, 8))).astype(np.float32)
    return C, random_params(C, cont, seed=3), cont


def port_classifier(pc):
    return weights.classifier_from_jax(LatentClassifier(8, NUM_SPK), pc)


def test_classifier_update_pieces(classifier):
    """The C update of the step, piece by piece: C's forward and cross
    entropy, the gradient reversed at C's input, and the Adam update (lr_d,
    betas (0.8, 0.99)) against optax's."""
    C, pc, cont = classifier
    port = port_classifier(pc)
    jax_cfg, cfg = configs()
    labels = np.array([1, 3, 0, 3], np.int32)

    def loss_fn(p, x):
        return jl.cross_entropy_loss(C.apply(p, x), jnp.asarray(labels))

    loss, (g_params, g_cont) = jax.value_and_grad(loss_fn, argnums=(0, 1))(pc, cont)
    _, _, c_opt = jstate.make_optimizers(jax_cfg, pc, pc, pc)
    updates, opt_state = c_opt.update(g_params, c_opt.init(pc), pc)
    want_params = optax.apply_updates(pc, updates)

    x = torch.from_numpy(cont).requires_grad_()
    tloss = tlosses.cross_entropy_loss(port(x), torch.from_numpy(labels))
    _, _, updater = tstate.make_optimizers(cfg, port, port, port)
    updater.zero_grad()
    tloss.backward()
    updater.step()
    np.testing.assert_allclose(tloss.item(), float(loss), **METRIC_TOL)
    # the encoder sees the reversed gradient
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_cont), rtol=1e-5, atol=1e-7)
    assert float(np.abs(np.asarray(g_cont)).max()) > 0
    mu = torch_layout(port, {"params": adam_mu(opt_state)["params"]})
    want = torch_layout(port, want_params)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(updater.optimizer.state[p]["exp_avg"].numpy(), mu[name],
                                   rtol=0, atol=1e-4 * np.abs(mu[name]).max() + 1e-9)
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2 * cfg.train.lr_d + PARAM_ATOL)


def test_train_step_with_latent_classifier(classifier):
    """With lambda_latcls != 0 the step runs the C update and the G loss's
    latent-classification term; C is updated and every loss is finite."""
    _, pc, _ = classifier
    _, cfg = configs()
    cfg.train.lambda_latcls = 1.0
    G = weights.generator_from_jax(
        Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF),
        random_params(JaxG(decoder_ratios=RATIOS, decoder_channels=CHANNELS,
                           num_bottleneck_layers=0, num_classes=NUM_SPK, conditional_dim=8,
                           content_dim=8, **MRF),
                      jnp.zeros((1, SEG, 1)), jnp.zeros((1, NUM_SPK)), None,
                      jnp.zeros((1, SEG, 1)), seed=1))
    D = CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4)
    init_weights(D, 4)
    C = port_classifier(pc)
    before = [p.detach().clone() for p in C.parameters()]
    crepe = crepe_from_seed(5)
    state = tstate.create_train_state(cfg, G, D, C, crepe)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    metrics = tstep.build_train_step(cfg, state)(batch, torch.Generator().manual_seed(0))
    for key in ("C_loss", "C_acc", "G_loss_lat_cls"):
        assert key in metrics
    assert all(torch.isfinite(v) for v in metrics.values())
    assert float(metrics["G_loss_lat_cls"]) > 0
    assert all(not torch.equal(a, p) for a, p in zip(before, C.parameters()))


def test_eval_step_pieces(classifier):
    """build_eval_step's metrics against the JAX modules applied piece by
    piece as ``build_eval_step`` applies them, with its draws (the target
    labels and the excitation of key k) injected."""
    C, pc, _ = classifier
    jax_cfg, cfg = configs()
    G = JaxG(decoder_ratios=RATIOS, decoder_channels=CHANNELS, num_bottleneck_layers=0,
             num_classes=NUM_SPK, conditional_dim=8, content_dim=8, **MRF)
    D = JaxD(num_disc=3, num_classes=NUM_SPK, num_channels_base=4)
    x0 = jnp.zeros((1, SEG, 1))
    pg = random_params(G, x0, jnp.zeros((1, NUM_SPK)), None, x0, seed=6)
    pd = random_params(D, x0, jnp.zeros((1,), jnp.int32), (), seed=7)
    cp = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    batch = make_batch()
    x = batch["signal"][..., None]
    k_tgt, k_exc = jax.random.split(jax.random.PRNGKey(8))
    label_tgt = np.asarray(jax.random.randint(k_tgt, (B,), 0, NUM_SPK))
    f0, _ = jax.jit(jcrepe.filtered_pitch)(cp, batch["signal"])
    exc = jdsp.f0_to_excitation(f0, 64, k_exc)[..., None]
    fake, _, cont = jax.jit(G.apply)(pg, x, jax.nn.one_hot(label_tgt, NUM_SPK), None, exc)
    d_apply = jax.jit(lambda p, x, lab: D.apply(p, x, lab, ())[0])
    out_real, out_fake = d_apply(pd, x, batch["label"]), d_apply(pd, fake, label_tgt)
    l_real, l_fake, _, _ = jl.lsgan_d_loss(out_real, out_fake)
    logits = C.apply(pc, cont)
    want = {"val_loss_adv_real": l_real, "val_loss_adv_fake": l_fake,
            "val_D_loss": l_real + l_fake, "val_G_loss": jl.lsgan_g_loss(out_fake)[0],
            "val_loss_lat_cls": jl.cross_entropy_loss(logits, jnp.asarray(batch["label"])),
            "val_C_acc": jnp.mean(jnp.argmax(logits, -1) == batch["label"])}

    tG = weights.generator_from_jax(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), pg)
    tD = weights.discriminator_from_jax(
        CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), pd)
    crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray, cp))
    state = tstate.create_train_state(cfg, tG, tD, port_classifier(pc), crepe)
    k_phase, k_noise = jax.random.split(k_exc)
    draws = dict(label_tgt=label_tgt,
                 exc=(float(jax.random.uniform(k_phase, ()) * 2.0 * jnp.pi),
                      np.asarray(jax.random.normal(k_noise, (B, SEG)))))
    got = tstep.build_eval_step(cfg, state)({k: torch.from_numpy(v) for k, v in batch.items()},
                                            draws=draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **METRIC_TOL)


def test_optimizers_clip_and_freeze_as_optax():
    """make_optimizers: global-norm clipping (grad_max_norm_G) and AdamW as
    optax's chain(clip_by_global_norm, adamw); a frozen prefix gets no update
    and is not in the optimizer."""
    jax_cfg, cfg = configs()
    for c in (jax_cfg, cfg):
        c.train.grad_max_norm_G = 0.5
    cfg.train.freeze_subnets = ["encoder"]
    G = Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF)
    init_weights(G, 13)
    opt_g, _, _ = tstate.make_optimizers(cfg, G, G)
    names = {id(p): n for n, p in G.named_parameters()}
    assert all(not names[id(p)].startswith("encoder.") for p in opt_g.params)
    frozen = {n: p.detach().clone() for n, p in G.named_parameters() if n.startswith("encoder.")}
    rng = np.random.default_rng(14)
    grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in G.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in G.named_parameters()}
    for n, p in G.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    opt_g.step()
    trained = [n for n in params if not n.startswith("encoder.")]
    opt = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.adamw(1e-4, b1=0.8, b2=0.99, weight_decay=0.01))
    sub = {n: jnp.asarray(params[n]) for n in trained}
    updates, _ = opt.update({n: jnp.asarray(grads[n]) for n in trained}, opt.init(sub), sub)
    want = optax.apply_updates(sub, updates)
    state = dict(G.named_parameters())
    for n in trained:
        np.testing.assert_allclose(state[n].detach().numpy(), np.asarray(want[n]), rtol=0,
                                   atol=1e-7, err_msg=n)
    for n, before in frozen.items():
        assert torch.equal(state[n].detach(), before), n


def test_interval_gating_skips_updates():
    """With D_step_interval = G_step_interval = 2 the second step (step 1)
    updates neither network and reports zero losses, as the JAX step's noop
    branches do."""
    _, cfg = configs()
    cfg.train.D_step_interval = cfg.train.G_step_interval = 2
    G = init_weights(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), 15)
    D = init_weights(CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), 16)
    state = tstate.create_train_state(cfg, G, D, None, crepe_from_seed(5))
    step = tstep.build_train_step(cfg, state)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    gen = torch.Generator().manual_seed(1)
    first = step(batch, gen)
    assert float(first["G_loss"]) > 0 and float(first["D_loss"]) > 0
    before = [p.detach().clone() for p in list(G.parameters()) + list(D.parameters())]
    second = step(batch, gen)
    assert set(second) == set(first) and state.step == 2
    assert all(float(v) == 0.0 for v in second.values())
    assert all(torch.equal(a, p) for a, p in zip(before, list(G.parameters())
                                                  + list(D.parameters())))


def test_wavlm_step_freezes_the_backbone():
    """The port's step with the WavLM encoder (the tiny backbone of
    tests/test_torch_port_wavlm.py; the corrupted batch through encode_only,
    clipping on): the backbone bit-identical after two steps, with no
    gradient and no optimizer state, while every posterior-encoder tensor
    moves and the losses stay finite. The posterior's gradients are held
    against jax.grad in tests/test_torch_port_wavlm.py."""
    _, cfg = configs()
    g = cfg.model.generator
    g.decoder_ratios, g.encoder_model, g.num_enc_layers = [10, 8, 2, 2], "wavlm", 2
    cfg.train.grad_max_norm_G = 1.0
    wavlm = WavLMConfig(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                        encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
                        num_buckets=32, max_distance=80,
                        conv_feature_layers=((16, 10, 5),) + ((16, 3, 2),) * 4
                        + ((16, 2, 2),) * 2)
    G = generator_from_config(g, NUM_SPK, "cpu", seed=3, wavlm_cfg=wavlm)
    D = init_weights(CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), 4)
    state = tstate.create_train_state(cfg, G, D, None, crepe_from_seed(5))
    backbone = {k: v.clone() for k, v in G.encoder.wavlm.state_dict().items()}
    posterior = {k: v.clone() for k, v in G.encoder.posterior.state_dict().items()}
    step = tstep.build_train_step(cfg, state)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    for i in range(2):
        metrics = step(batch, torch.Generator().manual_seed(i))
    assert all(torch.isfinite(v) for v in metrics.values())
    assert float(metrics["G_loss_cont_emb"]) > 0
    for k, v in G.encoder.wavlm.state_dict().items():
        assert torch.equal(v, backbone[k]), k
    frozen = list(G.encoder.wavlm.parameters())
    assert all(p.grad is None and not p.requires_grad for p in frozen)
    in_opt = {id(p) for p in state.opt_g.params}
    assert not any(id(p) in in_opt or p in state.opt_g.optimizer.state for p in frozen)
    assert len(in_opt) == sum(1 for p in G.parameters()) - len(frozen)
    for k, v in G.encoder.posterior.state_dict().items():
        assert not torch.equal(v, posterior[k]), k
