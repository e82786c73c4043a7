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
"""

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
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.config import Config
from td_vc_gan_tpu_torch.models.crepe import Crepe, crepe_from_seed
from td_vc_gan_tpu_torch.models.discriminator import CollaborativeMultibandDiscriminator
from td_vc_gan_tpu_torch.models.generator import Generator
from td_vc_gan_tpu_torch.models.latent_classifier import LatentClassifier
from td_vc_gan_tpu_torch.models.layers import init_weights
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
    state = tstate.create_train_state(cfg, tG, tD, None, crepe)
    train_step = tstep.build_train_step(cfg, state)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = train_step(tbatch, draws=jax_draws(rng, B, SEG // int(np.prod(RATIOS))))
    return dict(jmetrics={k: float(v) for k, v in jmetrics.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                jax_state=st2, state=state)


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


@pytest.mark.parametrize("net", ["G", "D"])
def test_first_moments_match(stepped, net):
    """exp_avg = (1 - beta1) * grad after one step: the gradients agree."""
    module, opt, _, opt_state = _nets(stepped, net)
    want = torch_layout(module, {"params": adam_mu(opt_state)["params"]})
    state = opt.optimizer.state
    for name, p in module.named_parameters():
        got = state[p]["exp_avg"].numpy()
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-4 * scale + 1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("net", ["G", "D"])
def test_updated_parameters_match(stepped, net):
    """Within PARAM_ATOL wherever the gradient's sign is settled (|mu| above
    the moments' tolerance band); elsewhere the first Adam step's
    lr * g / (|g| + eps) may take either sign, and the weights agree within
    that step, 2 lr."""
    module, opt, params, opt_state = _nets(stepped, net)
    want = torch_layout(module, params)
    mu = torch_layout(module, {"params": adam_mu(opt_state)["params"]})
    lr = opt.optimizer.param_groups[0]["lr"]
    assert set(want) == {name for name, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        got = p.detach().numpy()
        settled = np.abs(mu[name]) > 1e-4 * np.abs(mu[name]).max() + 1e-9
        np.testing.assert_allclose(got[settled], want[name][settled], rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got, want[name], rtol=0, atol=2 * lr + PARAM_ATOL,
                                   err_msg=name)


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
