"""One train step of the port against the JAX package's at stage 1 of the
curriculum, conv_enc-stage1 (S1), and the hand-off from stage 1 to stage 2-1.

S1 takes the stage-1 weights of tests/test_train_step.py
(``TestTrainStepStage1``: no_conv False, lambda_rec 0, lambda_idt 5,
lambda_f0 10, lambda_cont_emb 1, lambda_latcls 1) and adds
lambda_converted 0.5. With lambda_rec 0 there is no cycle pass, so the
contrastive loss encodes ``fake`` itself (the JAX step's ``reuse_rec_emb``
has nothing to reuse), beside the corrupted batch, in one encode call; the
latent classifier C is updated and its term enters the G loss.

The tiny configuration, parameters, batch and tolerances are those of
tests/test_torch_port_train_step.py: metrics rtol 1e-4, atol 1e-6; AdamW's
first moments within 1e-4 of the tensor's max|mu|; updated parameters within
1e-6 wherever the gradient's sign is settled, else within 2 lr. The JAX
step's draws (permutation, excitations, the negatives of both contrastive
terms, the jitter shifts) come from its key as ``build_train_step`` derives
them (step.py:194-206 and the helpers it calls), injected into the port. The
whole JAX step is compiled once, in this file of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import B, CHANNELS, MRF, NUM_SPK, PARAM_ATOL, RATIOS, SEG, \
    adam_mu, configs, jax_draws, make_batch, port_classifier, random_params, torch_layout

from td_vc_gan_tpu.models import CollaborativeMultibandDiscriminator as JaxD
from td_vc_gan_tpu.models import crepe as jcrepe
from td_vc_gan_tpu.models.generator import Generator as JaxG
from td_vc_gan_tpu.models.latent_classifier import LatentClassifier as JaxC
from td_vc_gan_tpu.training import state as jstate
from td_vc_gan_tpu.training import step as jstep
from td_vc_gan_tpu_torch import weights
from td_vc_gan_tpu_torch.models.crepe import Crepe, crepe_from_seed
from td_vc_gan_tpu_torch.models.discriminator import CollaborativeMultibandDiscriminator
from td_vc_gan_tpu_torch.models.generator import Generator
from td_vc_gan_tpu_torch.models.latent_classifier import LatentClassifier
from td_vc_gan_tpu_torch.models.layers import init_weights
from td_vc_gan_tpu_torch.training import checkpoint as ckpt
from td_vc_gan_tpu_torch.training import state as tstate
from td_vc_gan_tpu_torch.training import step as tstep

torch.set_num_threads(1)

METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
# conv_enc-stage1 (tests/test_train_step.py:87-88) with the converted
# contrastive term on
S1 = dict(no_conv=False, lambda_rec=0.0, lambda_idt=5.0, lambda_f0=10.0,
          lambda_cont_emb=1.0, lambda_latcls=1.0, lambda_converted=0.5)
# stage 2-1: the defaults with lambda_rec 0 and the latent classifier on
S21 = dict(lambda_rec=0.0, lambda_latcls=1.0)


def stage_draws(rng, b, t_content, jitter_amp=0):
    """Every draw of ``build_train_step`` for key ``rng``: those of
    tests/test_torch_port_train_step.py plus the converted term's negatives
    (k_cont2) and the jitter shifts (k_jit)."""
    keys = jax.random.split(rng, 8)
    k_jit, k_cont2 = keys[2], keys[4]
    draws = jax_draws(rng, b, t_content)
    draws["neg_converted"] = tuple(
        np.asarray(jax.random.randint(k, (b, t_content, 100), 0, t_content - 1))
        for k in jax.random.split(k_cont2))
    if jitter_amp:
        draws["jitter"] = np.asarray(
            jax.random.randint(k_jit, (b,), -jitter_amp, jitter_amp + 1))
    return draws


def step_both(train: dict) -> dict:
    """One JAX step and one port step at the tiny configuration with the
    ``train`` settings, from the same parameters, batch and draws; C (the
    latent classifier) when lambda_latcls is set."""
    jax_cfg, cfg = configs()
    for c in (jax_cfg, cfg):
        for k, v in train.items():
            setattr(c.train, k, v)
    G = JaxG(decoder_ratios=RATIOS, decoder_channels=CHANNELS, num_bottleneck_layers=0,
             num_classes=NUM_SPK, conditional_dim=8, content_dim=8, **MRF)
    D = JaxD(num_disc=3, num_classes=NUM_SPK, num_channels_base=4)
    C = JaxC(num_classes=NUM_SPK) if train.get("lambda_latcls") else None
    x = jnp.zeros((1, SEG, 1))
    pg = random_params(G, x, jnp.zeros((1, NUM_SPK)), None, x, seed=1)
    pd = random_params(D, x, jnp.zeros((1,), jnp.int32), D.get_subsamples(x, 3), seed=2)
    t_content = SEG // int(np.prod(RATIOS))
    pc = None if C is None else random_params(C, jnp.zeros((1, t_content, 8)), seed=3)
    cp = jax.jit(jcrepe.init_crepe)(jax.random.PRNGKey(1))
    st, opts = jstate.create_train_state(jax_cfg, pg, pd, pc, cp)
    batch = make_batch()
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jstep.build_train_step(jax_cfg, G, D, C, opts))
    st2, jmetrics = step(st, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    tG = weights.generator_from_jax(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), pg)
    tD = weights.discriminator_from_jax(
        CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4), pd)
    tC = None if pc is None else port_classifier(pc)
    crepe = weights.crepe_from_jax(Crepe("tiny"), jax.tree_util.tree_map(np.asarray, cp))
    state = tstate.create_train_state(cfg, tG, tD, tC, crepe)
    metrics = tstep.build_train_step(cfg, state)(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=stage_draws(rng, B, t_content, cfg.train.jitter_amp))
    return dict(jmetrics={k: float(v) for k, v in jmetrics.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                jax_state=st2, state=state)


def nets(stepped) -> dict:
    """name -> (port module, its optimizer, JAX params, JAX opt state)."""
    st, jst = stepped["state"], stepped["jax_state"]
    out = {"G": (st.G, st.opt_g, jst.params_g, jst.opt_g),
           "D": (st.D, st.opt_d, jst.params_d, jst.opt_d)}
    if st.C is not None:
        out["C"] = (st.C, st.opt_c, jst.params_c, jst.opt_c)
    return out


def check_metrics(stepped):
    jm, m = stepped["jmetrics"], stepped["metrics"]
    assert set(m) == set(jm)
    for k in sorted(jm):
        np.testing.assert_allclose(m[k], jm[k], err_msg=k, **METRIC_TOL)
    assert all(np.isfinite(v) for v in m.values())
    assert stepped["state"].step == 1


def check_first_moments(stepped, net):
    """exp_avg = (1 - beta1) * grad after one step: the gradients agree."""
    module, opt, _, opt_state = nets(stepped)[net]
    want = torch_layout(module, {"params": adam_mu(opt_state)["params"]})
    for name, p in module.named_parameters():
        got = opt.optimizer.state[p]["exp_avg"].numpy()
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-4 * scale + 1e-9,
                                   err_msg=name)


def check_parameters(stepped, net):
    """Within PARAM_ATOL where the gradient's sign is settled, else within
    the first Adam step's 2 lr (tests/test_torch_port_train_step.py)."""
    module, opt, params, opt_state = nets(stepped)[net]
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


@pytest.fixture(scope="module")
def stepped():
    return step_both(S1)


def test_s1_metrics_match(stepped):
    check_metrics(stepped)
    m = stepped["metrics"]
    # the branches of S1: no cycle pass, the identity and the converted
    # contrastive terms, the classifier's update and its G term
    assert "G_loss_rec_spec" not in m and m["G_loss_rec"] == 0.0
    for key in ("G_loss_idt_spec", "G_loss_idt_feat", "C_loss", "C_acc"):
        assert key in m, key
    for key in ("G_loss_cont_emb", "G_loss_lat_cls", "g_loss_f0"):
        assert m[key] > 0, key


@pytest.mark.parametrize("net", ["G", "D", "C"])
def test_s1_first_moments_match(stepped, net):
    check_first_moments(stepped, net)


@pytest.mark.parametrize("net", ["G", "D", "C"])
def test_s1_updated_parameters_match(stepped, net):
    check_parameters(stepped, net)


def test_s1_converted_term_encodes_fake(monkeypatch):
    """With lambda_rec 0 the G loss's encode call takes the corrupted batch
    and the detached fake together (2B), where stage 2-2 reuses the cycle
    pass's content and encodes the corrupted batch alone (B)."""
    sizes = {}
    for name, train in (("S1", S1), ("2-2", dict(lambda_converted=0.5))):
        _, cfg = configs()
        for k, v in train.items():
            setattr(cfg.train, k, v)
        G = init_weights(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), 20)
        D = init_weights(CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4),
                         21)
        C = init_weights(LatentClassifier(8, NUM_SPK), 22) if cfg.train.lambda_latcls else None
        state = tstate.create_train_state(cfg, G, D, C, crepe_from_seed(5))
        calls = []
        forward = Generator.forward

        def spy(self, x, *args, encode_only=False, **kw):
            if encode_only:
                calls.append(x.shape[0])
            return forward(self, x, *args, encode_only=encode_only, **kw)

        monkeypatch.setattr(Generator, "forward", spy)
        batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
        tstep.build_train_step(cfg, state)(batch, torch.Generator().manual_seed(0))
        monkeypatch.setattr(Generator, "forward", forward)
        sizes[name] = calls
    # the source's encode, then the G loss's
    assert sizes == {"S1": [B, 2 * B], "2-2": [B, B]}


def stage_state(train: dict, seed: int):
    """A port train state at the tiny configuration with ``train``'s
    settings, its models built from ``seed``."""
    _, cfg = configs()
    for k, v in train.items():
        setattr(cfg.train, k, v)
    G = init_weights(Generator(RATIOS, CHANNELS, NUM_SPK, 8, 8, **MRF), seed)
    D = init_weights(CollaborativeMultibandDiscriminator(3, NUM_SPK, num_channels_base=4),
                     seed + 1)
    C = (init_weights(LatentClassifier(8, NUM_SPK), seed + 2)
         if cfg.train.lambda_latcls else None)
    return cfg, tstate.create_train_state(cfg, G, D, C, crepe_from_seed(5))


def test_handoff_stage1_to_stage21(tmp_path):
    """The curriculum's hand-off: a stage-1 run without C (S1 with
    lambda_latcls 0) saves its state after two steps; a stage-2-1 state
    with C restores it. G, D, their optimizers and the step come from the
    stage-1 state bit for bit, C and its optimizer stay as the seed made
    them, and the restored state trains on."""
    cfg1, st1 = stage_state(dict(S1, lambda_latcls=0.0), seed=30)
    assert st1.C is None
    step1 = tstep.build_train_step(cfg1, st1)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    for i in range(2):
        step1(batch, torch.Generator().manual_seed(i))
    ckpt.save_state(st1, tmp_path, 0)

    cfg2, st2 = stage_state(S21, seed=40)
    seed_c = {k: v.clone() for k, v in st2.C.state_dict().items()}
    _, fresh = stage_state(S21, seed=40)
    restored = ckpt.restore_state(st2, tmp_path, 0)
    assert restored == ["G", "D"]
    assert st2.step == 2
    for a, b in ((st1.G, st2.G), (st1.D, st2.D)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in ((st1.opt_g, st2.opt_g), (st1.opt_d, st2.opt_d)):
        for p, q in zip(a.params, b.params):
            for key, v in a.optimizer.state[p].items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(b.optimizer.state[q][key]))
    assert all(torch.equal(v, seed_c[k]) for k, v in st2.C.state_dict().items())
    assert all(torch.equal(v, fresh.C.state_dict()[k]) for k, v in seed_c.items())
    assert not st2.opt_c.optimizer.state  # C's optimizer untouched
    metrics = tstep.build_train_step(cfg2, st2)(batch, torch.Generator().manual_seed(3))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["G_loss_lat_cls"]) > 0 and "C_loss" in metrics
    assert st2.opt_c.optimizer.state and st2.step == 3
